// Segmented row sums over monotone segment ids, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pcl_tpu/ops/pallas_segsum.py:_segsum_kernel
// (called by segment_sum_sorted). Same function: for vals [n, w] and segment
// ids seg [n] that never decrease, output row s (0 <= s < n) is the sum of the
// rows with seg == s; rows whose id lies outside [0, n) (the invalid tail,
// which carries an id such as n or 2^28) are dropped, and an output row with
// no member is 0. The TPU kernel leaves such rows undefined; here every one of
// the n output rows is written exactly once, so nothing needs clearing.
//
// Design. The TPU kernel walks the sorted rows in order on one core, carrying
// the open segment's partial sum from chunk to chunk and letting each chunk
// overwrite its predecessor's provisional output rows. CUDA blocks run in no
// order, so that scheme would race. Instead every output element has one
// owner and no sum crosses threads:
//   1. segsum_bounds_kernel: one thread per id s in [0, n] finds
//      starts[s] = the first row with seg >= s by binary search, so segment s
//      occupies rows [starts[s], starts[s+1]).
//   2. segsum_rows_kernel: one thread per output element (s, c), neighbouring
//      threads on neighbouring columns (coalesced writes, and reads that walk
//      the same rows). It adds its segment's rows in ascending row order,
//      starting from 0.0f, with no reassociation (__fadd_rn).
// No atomics, so two launches on the same input are bitwise equal, and the
// order of the additions is that of the plain version in ops/segsum.py
// (index_put_ with accumulate=True on zeros), which therefore agrees bit for
// bit.
//
// Bound on this card: bytes. Each input row is read once and each output
// row written once, ~4 B/value at 3.35 TB/s: about 1 us at the voxel grid's
// 120k x 4, so a launch (a few us) dominates. Work per thread is the length
// of its segment: one voxel holding every point is summed by w threads alone
// (serial, latency-bound); a segment split over a warp with a fixed-order
// shuffle tree would fix that at the cost of the bitwise match with the plain
// version.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void segsum_bounds_kernel(const int32_t* __restrict__ seg, int n,
                                     int32_t* __restrict__ starts) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s > n) return;
  int lo = 0, hi = n;                      // first row with seg >= s
  while (lo < hi) {
    const int mid = lo + ((hi - lo) >> 1);
    if (seg[mid] < s) lo = mid + 1; else hi = mid;
  }
  starts[s] = lo;
}

__global__ void __launch_bounds__(kThreads)
segsum_rows_kernel(const float* __restrict__ vals, const int32_t* __restrict__ starts,
                   int n, int w, float* __restrict__ out) {
  const int64_t t = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (t >= static_cast<int64_t>(n) * w) return;
  const int s = static_cast<int>(t / w);
  const int c = static_cast<int>(t - static_cast<int64_t>(s) * w);
  const int lo = starts[s], hi = starts[s + 1];
  const float* p = vals + static_cast<int64_t>(lo) * w + c;
  float acc = 0.f;
#pragma unroll 4
  for (int r = lo; r < hi; ++r, p += w) acc = __fadd_rn(acc, *p);
  out[t] = acc;
}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers of
// contiguous tensors: vals [n, w] f32, seg [n] i32 (non-decreasing),
// starts [n + 1] i32 scratch, out [n, w] f32. Launches on `stream` and returns
// cudaGetLastError() (0 on success); never synchronises.
extern "C" int pcl_segsum(const void* vals, const void* seg, int n, int w,
                          void* starts, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  segsum_bounds_kernel<<<(n + 1 + kThreads - 1) / kThreads, kThreads, 0, st>>>(
      static_cast<const int32_t*>(seg), n, static_cast<int32_t*>(starts));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int64_t total = static_cast<int64_t>(n) * w;
  const unsigned blocks = static_cast<unsigned>((total + kThreads - 1) / kThreads);
  segsum_rows_kernel<<<blocks, kThreads, 0, st>>>(
      static_cast<const float*>(vals), static_cast<const int32_t*>(starts), n, w,
      static_cast<float*>(out));
  return static_cast<int>(cudaGetLastError());
}
