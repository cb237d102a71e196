// Segmented row sums over monotone segment ids, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pcl_tpu/ops/pallas_segsum.py:_segsum_kernel
// (called by segment_sum_sorted). Same function: for vals [n, w] and segment
// ids seg [n] that never decrease, output row s (0 <= s < n) is the sum of the
// rows with seg == s; rows whose id lies outside [0, n) (the invalid tail,
// which carries an id such as n or 2^28) are dropped, and an output row with
// no member is 0. The TPU kernel leaves such rows undefined; here every one of
// the n output rows is written exactly once, in one launch, so nothing needs
// clearing.
//
// What bounds it on this card: bytes in principle (each input row read once,
// each output row written once, ~4 B a value at 3.35 TB/s: about 1 us at the
// voxel grid's 120k x 4), in practice the launch and the chain of dependent
// loads inside it, which cost more than the traffic. So: one launch, no
// scratch, no search per row.
//
// Design. The TPU kernel walks the sorted rows in order on one core and
// carries the open segment from chunk to chunk; CUDA blocks run in no order,
// so here every output element has one owner and no sum crosses blocks:
//   * A thread per input row and per group of columns (float4 groups when
//     w % 4 == 0, as the voxel grid's w = 4; single columns otherwise). Row r
//     is the head of its segment iff its id lies in [0, n) and r == 0 or
//     seg[r] != seg[r-1]: a comparison of neighbours, not a search. A head
//     adds its run forward in ascending row order from 0.0f (__fadd_rn, no
//     reassociation) and writes output row seg[r]. Runs of up to kSeq rows
//     are summed this way, and agree bit for bit with the plain version in
//     ops/segsum.py.
//   * Long runs, shared in a fixed order. A head whose run passes kSeq rows
//     leaves it to its block: after a barrier the block's threads take the
//     run's rows in stride (lane j of J takes rows first + j, first + j + J,
//     ...; each lane adds its rows in ascending order), and the J partial
//     sums are added in a fixed binary tree in shared memory. Deterministic
//     (two launches are bitwise equal), but not the sequential order: beyond
//     kSeq rows the result agrees with the plain version to rounding
//     (1e-6 x sum|v|). This stays inside the one launch and needs no scratch
//     and no cross-block counter: the run belongs to the block of its head.
//   * Rows without members, zeroed in the same launch. Output row s has no
//     member iff no row carries id s. The kernel accepts gaps between ids
//     (valid ids need not step by 1), so there are two kinds. Rows past the
//     last valid id K: every warp finds the number of rows with an id < n by
//     a 32-ary search with ballots (one probe when the last row is valid, as
//     in a full scan; about log32(n) rounds otherwise), reads K there, and
//     the thread of input row r zeroes output row r when r > K. Rows in a
//     gap below K: the head that follows the gap zeroes them (its id and its
//     predecessor's bound the gap); no caller of the port makes such gaps.
// No atomics on floats anywhere.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kSeq = 64;        // rows a head adds alone; longer runs go to the block
constexpr int kBatch = 8;       // rows a lane has in flight in a long run
constexpr unsigned kFull = 0xffffffffu;

template <int VEC> struct Vec;
template <> struct Vec<1> {
  float v;
  __device__ static Vec zero() { return {0.f}; }
  __device__ void add(const Vec& o) { v = __fadd_rn(v, o.v); }
};
template <> struct Vec<4> {
  float4 v;
  __device__ static Vec zero() { return {make_float4(0.f, 0.f, 0.f, 0.f)}; }
  __device__ void add(const Vec& o) {
    v.x = __fadd_rn(v.x, o.v.x);
    v.y = __fadd_rn(v.y, o.v.y);
    v.z = __fadd_rn(v.z, o.v.z);
    v.w = __fadd_rn(v.w, o.v.w);
  }
};

// The number of leading rows whose id is < n (ids never decrease, so they are
// a prefix). Every lane of the warp calls it and gets the same answer.
__device__ int rows_below_n(const int32_t* __restrict__ seg, int n) {
  if (seg[n - 1] < n) return n;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n - 1;          // the answer lies in [lo, hi]; seg[hi] >= n
  while (lo < hi) {
    const int step = (hi - lo + 31) / 32;
    const int probe = lo + lane * step;
    const bool ge = probe >= hi || seg[probe] >= n;
    const int f = __ffs(__ballot_sync(kFull, ge)) - 1;    // first lane at or past the answer
    if (f < 0) {                   // not among the probes: past the last one
      lo = lo + 31 * step + 1;
    } else if (f == 0) {
      hi = lo;
    } else {
      hi = min(hi, lo + f * step);
      lo = lo + (f - 1) * step + 1;
    }
  }
  return lo;
}

// Thread (rl, gl) of block (bx, by): input row bx * rows_per_block + rl and
// column group by * groups_per_block + gl, where groups_per_block =
// min(groups, kThreads) and rows_per_block = kThreads / groups_per_block.
template <int VEC>
__global__ void __launch_bounds__(kThreads)
segsum_kernel(const float* __restrict__ vals_, const int32_t* __restrict__ seg, int n,
              int groups, int gpb, float* __restrict__ out_) {
  using V = Vec<VEC>;
  const V* __restrict__ vals = reinterpret_cast<const V*>(vals_);
  V* __restrict__ out = reinterpret_cast<V*>(out_);
  __shared__ V part[kThreads];
  __shared__ int long_id[kThreads], long_first[kThreads];
  __shared__ int n_long;

  const int rpb = kThreads / gpb;
  const int rl = threadIdx.x / gpb, gl = threadIdx.x - rl * gpb;
  const int r = blockIdx.x * rpb + rl;
  const int g = blockIdx.y * gpb + gl;
  const bool active = rl < rpb && r < n && g < groups;
  if (threadIdx.x == 0) n_long = 0;
  __syncthreads();

  // rows past the last valid id
  const int below = rows_below_n(seg, n);
  const int last_id = below > 0 ? seg[below - 1] : -1;      // < 0: no valid row
  if (active && r > last_id) out[static_cast<int64_t>(r) * groups + g] = V::zero();

  const int id = active ? seg[r] : -1;
  if (active && id >= 0 && id < n && (r == 0 || seg[r - 1] != id)) {
    // the gap below this id, if the ids skipped any
    const int prev = r == 0 ? -1 : max(seg[r - 1], -1);
    for (int s = prev + 1; s < id; ++s) out[static_cast<int64_t>(s) * groups + g] = V::zero();
    V acc = V::zero();
    int rr = r, cnt = 0;
    do {
      acc.add(vals[static_cast<int64_t>(rr) * groups + g]);
      ++rr;
      ++cnt;
    } while (cnt < kSeq && rr < n && seg[rr] == id);
    if (rr < n && seg[rr] == id) {          // longer than kSeq rows: the block's
      if (gl == 0) {
        const int slot = atomicAdd(&n_long, 1);
        long_id[slot] = id;
        long_first[slot] = r;
      }
    } else {
      out[static_cast<int64_t>(id) * groups + g] = acc;
    }
  }
  __syncthreads();

  const int lanes = rpb;
  int tree = 1;
  while (tree < lanes) tree <<= 1;
  for (int item = 0; item < n_long; ++item) {
    const int lid = long_id[item], first = long_first[item];
    V acc = V::zero();
    if (rl < lanes && g < groups) {
      bool more = true;
      for (int64_t row = first + rl; more; row += kBatch * lanes) {
        bool in[kBatch];
        V v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int64_t rb = row + b * lanes;
          in[b] = rb < n && seg[rb] == lid;
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
          const int64_t rb = row + b * lanes;
          v[b] = in[b] ? vals[rb * groups + g] : V::zero();
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b)
          if (in[b]) acc.add(v[b]);
        more = in[kBatch - 1];
      }
    }
    part[threadIdx.x] = acc;
    for (int s = tree >> 1; s > 0; s >>= 1) {
      __syncthreads();
      if (rl < s && rl + s < lanes) part[threadIdx.x].add(part[threadIdx.x + s * gpb]);
    }
    if (rl == 0 && g < groups) out[static_cast<int64_t>(lid) * groups + g] = part[threadIdx.x];
    __syncthreads();               // part is reused by the next run
  }
}

__global__ void segsum_noop_kernel() {}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers of
// contiguous tensors: vals [n, w] f32, seg [n] i32 (non-decreasing),
// out [n, w] f32. Launches on `stream` and returns cudaGetLastError() (0 on
// success); never synchronises.
extern "C" int pcl_segsum(const void* vals, const void* seg, int n, int w, void* out,
                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || w <= 0) return static_cast<int>(cudaGetLastError());
  const bool aligned = ((reinterpret_cast<uintptr_t>(vals) |
                         reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const bool vec4 = w % 4 == 0 && aligned;      // float4 rows on 16-byte addresses
  const int groups = vec4 ? w / 4 : w;
  const int gpb = groups < kThreads ? groups : kThreads;
  const int rpb = kThreads / gpb;
  const unsigned gy = static_cast<unsigned>((groups + gpb - 1) / gpb);
  if (gy > 65535u) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>((n + rpb - 1) / rpb), gy);
  if (vec4) {
    segsum_kernel<4><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(seg), n, groups, gpb,
        static_cast<float*>(out));
  } else {
    segsum_kernel<1><<<grid, kThreads, 0, st>>>(
        static_cast<const float*>(vals), static_cast<const int32_t*>(seg), n, groups, gpb,
        static_cast<float*>(out));
  }
  return static_cast<int>(cudaGetLastError());
}

// An empty kernel through the same interface: what a launch alone costs.
extern "C" int pcl_segsum_noop(void* stream) {
  segsum_noop_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}
