// Exact masked 1-nearest-neighbour search for 3-D points, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pcl_tpu/ops/pallas_nn.py:_nn1_kernel (called by
// nn1_pallas). Same function: for every query q, the index of the target t
// with the least score ||t||^2 - 2 q.t among targets whose mask is set, the
// lowest index winning a tie, and d2 = ||q - t_idx||^2 recomputed exactly for
// the winner (+inf where no target is valid, index 0).
//
// Design: one thread per query, 256 threads per block. Targets stream through
// shared memory in tiles of 2048 float4 (x, y, z, w) = 32 KB, where w is
// ||t||^2 for a valid target and 1e30 for a masked one (a masked target's
// x, y, z are packed as 0, so its score is exactly 1e30 and never beats the
// initial best of 1e30). Each thread keeps its running best in registers and
// scans the targets in ascending index order with a strict '<', so the lowest
// index wins a tie, as the TPU kernel's tile merge does. The score is three
// FP32 FMAs in a fixed order:
//     s = fma(qz, tz, fma(qy, ty, fma(qx, tx, w)))   with q pre-scaled by -2,
// which the plain PyTorch version in pcl_tpu_torch/ops/nn1.py reproduces bit
// for bit. No TF32: a 10-bit mantissa would break argmin on near-ties.
//
// Bound on this card: FP32 issue. Per (query, target) pair the scan issues
// about five FP32-pipe instructions (3 FMA, compare, select), against
// 132 SMs x 128 lanes x clock: ~2 ms for a 120k x 120k sweep. Bytes are
// negligible (each target tile is read from L2 once per block). This simple
// form also issues one shared-memory load and an index update per pair;
// register-blocking several queries per thread would amortise them.
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kTile = 2048;          // float4 targets per shared-memory tile
constexpr float kBig = 1e30f;        // masked-target score (as the TPU kernel's _BIG)

__global__ void nn1_pack_kernel(const float* __restrict__ t,
                                const uint8_t* __restrict__ tmask,
                                float4* __restrict__ packed, int m) {
  int j = blockIdx.x * blockDim.x + threadIdx.x;
  if (j >= m) return;
  float4 p;
  if (tmask[j]) {
    p.x = t[3 * j + 0];
    p.y = t[3 * j + 1];
    p.z = t[3 * j + 2];
    // ((x*x + y*y) + z*z) without contraction into FMAs
    p.w = __fadd_rn(__fadd_rn(__fmul_rn(p.x, p.x), __fmul_rn(p.y, p.y)),
                    __fmul_rn(p.z, p.z));
  } else {
    p = make_float4(0.f, 0.f, 0.f, kBig);
  }
  packed[j] = p;
}

__global__ void __launch_bounds__(kThreads)
nn1_search_kernel(const float* __restrict__ q, const float4* __restrict__ packed,
                  const float* __restrict__ t, const uint8_t* __restrict__ tmask,
                  int nq, int m, int32_t* __restrict__ idx_out,
                  float* __restrict__ d2_out) {
  __shared__ float4 tile[kTile];
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < nq;
  const float px = live ? q[3 * i + 0] : 0.f;
  const float py = live ? q[3 * i + 1] : 0.f;
  const float pz = live ? q[3 * i + 2] : 0.f;
  const float qx = -2.f * px, qy = -2.f * py, qz = -2.f * pz;

  float best = kBig;
  int best_j = 0;
  for (int base = 0; base < m; base += kTile) {
    const int n = min(kTile, m - base);
    __syncthreads();                 // the previous tile is no longer read
    for (int k = threadIdx.x; k < n; k += kThreads) tile[k] = packed[base + k];
    __syncthreads();
#pragma unroll 8
    for (int k = 0; k < n; ++k) {
      const float4 p = tile[k];
      const float s = fmaf(qz, p.z, fmaf(qy, p.y, fmaf(qx, p.x, p.w)));
      if (s < best) {
        best = s;
        best_j = base + k;
      }
    }
  }
  if (!live) return;
  float d2 = __int_as_float(0x7f800000);   // +inf
  if (m > 0 && tmask[best_j]) {
    const float dx = px - t[3 * best_j + 0];
    const float dy = py - t[3 * best_j + 1];
    const float dz = pz - t[3 * best_j + 2];
    d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
  idx_out[i] = best_j;
  d2_out[i] = d2;
}

}  // namespace

// C interface, loaded with ctypes. All pointers are device pointers of
// contiguous tensors: queries [nq,3] f32, target [m,3] f32, tmask [m] bool,
// packed [m,4] f32 scratch, idx [nq] i32, d2 [nq] f32. Launches on `stream`
// and returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int pcl_nn1(const void* queries, const void* target, const void* tmask,
                       int nq, int m, void* packed, void* idx, void* d2,
                       void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  if (m > 0) {
    nn1_pack_kernel<<<(m + kThreads - 1) / kThreads, kThreads, 0, s>>>(
        static_cast<const float*>(target), static_cast<const uint8_t*>(tmask),
        static_cast<float4*>(packed), m);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  nn1_search_kernel<<<(nq + kThreads - 1) / kThreads, kThreads, 0, s>>>(
      static_cast<const float*>(queries), static_cast<const float4*>(packed),
      static_cast<const float*>(target), static_cast<const uint8_t*>(tmask), nq, m,
      static_cast<int32_t*>(idx), static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
