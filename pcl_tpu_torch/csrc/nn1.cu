// Exact masked 1-nearest-neighbour search for 3-D points, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel pcl_tpu/ops/pallas_nn.py:_nn1_kernel (called by
// nn1_pallas). Same function: for every query q, the index of the target t
// with the least score ||t||^2 - 2 q.t among targets whose mask is set, the
// lowest index winning a tie, and d2 = ||q - t_idx||^2 recomputed exactly for
// the winner (+inf where no target is valid, index 0). The score is three
// FP32 FMAs in a fixed order:
//     s = fma(qz, tz, fma(qy, ty, fma(qx, tx, w)))   with q pre-scaled by -2,
// where w is ||t||^2 for a valid target and 1e30 for a masked one (a masked
// target's x, y, z are packed as 0, so its score is exactly 1e30 and never
// beats the initial best of 1e30). The plain PyTorch version in
// pcl_tpu_torch/ops/nn1.py reproduces it bit for bit. No TF32 and no tensor
// core: a 10-bit mantissa would break argmin on near-ties, and K = 3.
//
// What bounds it on this card: instruction throughput, not bytes. A 32 KB
// tile of targets feeds a whole block of queries, so memory traffic is small;
// every (query, target) pair needs three FFMA and one minimum, four
// instruction slots of the 132 SMs x 4 schedulers x clock. Everything else
// an inner loop executes is overhead against that bound.
//
// Design:
//   * Register blocking. A thread owns kR queries (a block of kThreads
//     threads owns kR * kThreads). One broadcast LDS.128 of a target then
//     serves kR pairs, and the kR running minima are independent chains.
//   * A min-only inner loop. Per pair: three fmaf and one fminf onto the
//     running minimum of the current sub-tile of kSub targets. No index is
//     tracked per pair. After a sub-tile, one strict '<' against the thread's
//     best so far records (minimum, first target of the sub-tile): strict, so
//     the earliest sub-tile keeps a tie. After the sweep the thread reads its
//     winning sub-tile again (from shared memory when the slice was one tile,
//     else from global memory, where other blocks' inner loops hide the loads)
//     and takes the lowest k whose score == the minimum: the same three fmaf
//     on the same operands give the same bits, and '==' holds across -0.0f
//     and +0.0f.
//   * Balance over the SMs whatever Q is. The targets are cut into S slices
//     as well: the grid is (query tiles, S), and the wrapper picks S from Q,
//     M and the number of blocks the card holds at once, so that the blocks
//     fill it in whole waves (2048 queries against 120k targets become some
//     hundreds of blocks, not 2). Every block writes (minimum, index)
//     per query to scratch [S, Q]; nn1_merge_kernel takes the lowest slice
//     that holds the least minimum (eight threads share a query's slices) and
//     recomputes d2 exactly for the winner.
//   * Ragged edges: the shared tile is padded to a whole sub-tile with
//     (0, 0, 0, 1e30), whose score is exactly 1e30, so the inner loop has no
//     bounds; the second reading of the winning sub-tile from global memory
//     stops at the end of the slice.
#include <cuda_runtime.h>
#include <stdint.h>

#ifndef NN1_R
#define NN1_R 8            // queries per thread
#endif
#ifndef NN1_SUB
#define NN1_SUB 32         // targets per sub-tile (one index update per sub-tile)
#endif
#ifndef NN1_UNROLL
#define NN1_UNROLL 32      // targets per unrolled step of the inner loop
#endif

namespace {

constexpr int kThreads = 128;
constexpr int kR = NN1_R;
constexpr int kSub = NN1_SUB;
constexpr int kUnroll = NN1_UNROLL;
constexpr int kQBlock = kThreads * kR;   // queries per block
constexpr int kTile = 2048;              // float4 targets per shared-memory tile
constexpr int kPackThreads = 256;
constexpr int kMergeLanes = 8;           // threads that share a query's slices in the merge
constexpr float kBig = 1e30f;            // masked-target score (as the TPU kernel's _BIG)

static_assert(kTile % kSub == 0 && (kSub & (kSub - 1)) == 0,
              "a tile holds whole sub-tiles of a power of two");

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

__device__ __forceinline__ float score(float qx, float qy, float qz, const float4 p) {
  return fmaf(qz, p.z, fmaf(qy, p.y, fmaf(qx, p.x, p.w)));
}

// Block (bx, by): queries [bx * kQBlock, +kQBlock) against the targets of
// slice by, [by * slice_len, +slice_len). Thread t owns queries
// bx * kQBlock + t + r * kThreads.
__global__ void __launch_bounds__(kThreads)
nn1_search_kernel(const float* __restrict__ q, const float4* __restrict__ packed,
                  int nq, int m, int slice_len, float* __restrict__ sbest,
                  int32_t* __restrict__ sidx) {
  __shared__ float4 tile[kTile];
  const int i0 = blockIdx.x * kQBlock + threadIdx.x;
  const int lo = blockIdx.y * slice_len;
  const int hi = min(m, lo + slice_len);

  float qx[kR], qy[kR], qz[kR], best[kR];
  int bj[kR];                  // the best's sub-tile, then its index
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r * kThreads;
    const bool live = i < nq;
    qx[r] = -2.f * (live ? q[3 * i + 0] : 0.f);
    qy[r] = -2.f * (live ? q[3 * i + 1] : 0.f);
    qz[r] = -2.f * (live ? q[3 * i + 2] : 0.f);
    best[r] = kBig;
    bj[r] = -1;
  }

  for (int base = lo; base < hi; base += kTile) {
    const int n = min(kTile, hi - base);
    const int npad = (n + kSub - 1) / kSub * kSub;
    __syncthreads();                 // the previous tile is no longer read
    for (int k = threadIdx.x; k < npad; k += kThreads)
      tile[k] = k < n ? packed[base + k] : make_float4(0.f, 0.f, 0.f, kBig);
    __syncthreads();
    for (int sb = 0; sb < npad; sb += kSub) {
      float mn[kR];
#pragma unroll
      for (int r = 0; r < kR; ++r) mn[r] = kBig;
#pragma unroll kUnroll
      for (int k = 0; k < kSub; ++k) {
        const float4 p = tile[sb + k];
#pragma unroll
        for (int r = 0; r < kR; ++r)
          mn[r] = fminf(mn[r], score(qx[r], qy[r], qz[r], p));
      }
#pragma unroll
      for (int r = 0; r < kR; ++r) {
        if (mn[r] < best[r]) {
          best[r] = mn[r];
          bj[r] = base + sb;
        }
      }
    }
  }

  // The winner's index: the first target of the winning sub-tile whose score
  // equals the minimum (bj stays -1 where every score was 1e30: index 0).
  if (hi - lo <= kTile) {
    // The slice was one tile and is still in shared memory. Lane l starts l
    // targets in, so the lanes of a quarter-warp read different banks even
    // when their sub-tiles differ, and the least matching k is kept. Padding
    // never matches: its score is 1e30, and a minimum that won is below it.
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (bj[r] < 0) continue;
      const int sb = bj[r] - lo;
      int first = kSub;
#pragma unroll 8
      for (int kk = 0; kk < kSub; ++kk) {
        const int k = (kk + threadIdx.x) & (kSub - 1);
        if (score(qx[r], qy[r], qz[r], tile[sb + k]) == best[r]) first = min(first, k);
      }
      bj[r] += first;
    }
  } else {
    // A long slice: read the sub-tile again from global memory (L2), up to
    // the first match and not past the end of the slice. The dependent loads
    // are slow, but a long slice means many blocks, whose inner loops hide
    // most of them. (Reading all kSub targets for the thread's kR queries
    // side by side, loads in flight together, measured 6% slower per sweep:
    // twice the divergent 16-byte loads.)
#pragma unroll
    for (int r = 0; r < kR; ++r) {
      if (bj[r] < 0) continue;
      const int e = min(kSub, hi - bj[r]);
      for (int k = 0; k < e; ++k) {
        if (score(qx[r], qy[r], qz[r], packed[bj[r] + k]) == best[r]) {
          bj[r] += k;
          break;
        }
      }
    }
  }
#pragma unroll
  for (int r = 0; r < kR; ++r) {
    const int i = i0 + r * kThreads;
    if (i >= nq) continue;
    const int64_t o = static_cast<int64_t>(blockIdx.y) * nq + i;
    sbest[o] = best[r];
    sidx[o] = max(bj[r], 0);
  }
}

// Thread (x, y) of a block: query bx * 32 + x, slices y, y + kMergeLanes, ...
// in ascending order with a strict '<'; then lane 0 takes the lanes' winners,
// the lower slice on a tie, so the lowest slice that holds the minimum wins.
__global__ void __launch_bounds__(32 * kMergeLanes)
nn1_merge_kernel(const float* __restrict__ q, const float* __restrict__ t,
                 const uint8_t* __restrict__ tmask, const float* __restrict__ sbest,
                 const int32_t* __restrict__ sidx, int nq, int m, int slices,
                 int32_t* __restrict__ idx_out, float* __restrict__ d2_out) {
  __shared__ float lane_best[kMergeLanes][32];
  __shared__ int lane_slice[kMergeLanes][32];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float best = kBig;
  int bs = -1;
  if (i < nq) {
    for (int s = threadIdx.y; s < slices; s += kMergeLanes) {
      const float b = sbest[static_cast<int64_t>(s) * nq + i];
      if (b < best) {
        best = b;
        bs = s;
      }
    }
  }
  lane_best[threadIdx.y][threadIdx.x] = best;
  lane_slice[threadIdx.y][threadIdx.x] = bs;
  __syncthreads();
  if (threadIdx.y != 0 || i >= nq) return;
  for (int l = 1; l < kMergeLanes; ++l) {
    const float b = lane_best[l][threadIdx.x];
    const int s = lane_slice[l][threadIdx.x];
    if (b < best || (b == best && s >= 0 && s < bs)) {
      best = b;
      bs = s;
    }
  }
  const int best_j = bs >= 0 ? sidx[static_cast<int64_t>(bs) * nq + i] : 0;
  float d2 = __int_as_float(0x7f800000);   // +inf
  if (m > 0 && tmask[best_j]) {
    const float dx = q[3 * i + 0] - t[3 * best_j + 0];
    const float dy = q[3 * i + 1] - t[3 * best_j + 1];
    const float dz = q[3 * i + 2] - t[3 * best_j + 2];
    d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
  }
  idx_out[i] = best_j;
  d2_out[i] = d2;
}

}  // namespace

// Queries per block, and the number of blocks of nn1_search_kernel that the
// current device holds at once (SMs x resident blocks per SM): what the
// wrapper needs to choose the number of target slices. <= 0 on an error.
extern "C" int pcl_nn1_query_block() { return kQBlock; }

extern "C" int pcl_nn1_slots() {
  int dev = 0, sms = 0, per_sm = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return -1;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
    return -1;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, nn1_search_kernel,
                                                    kThreads, 0) != cudaSuccess)
    return -1;
  return sms * per_sm;
}

// C interface, loaded with ctypes. All pointers are device pointers of
// contiguous tensors: queries [nq,3] f32, target [m,3] f32, tmask [m] bool,
// packed [m,4] f32 scratch, sbest [slices,nq] f32 and sidx [slices,nq] i32
// scratch, idx [nq] i32, d2 [nq] f32. The targets are searched in `slices`
// slices of `slice_len` (slices * slice_len >= m). Launches on `stream` and
// returns cudaGetLastError() (0 on success); never synchronises.
extern "C" int pcl_nn1(const void* queries, const void* target, const void* tmask,
                       int nq, int m, int slices, int slice_len, void* packed,
                       void* sbest, void* sidx, void* idx, void* d2, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (nq <= 0) return static_cast<int>(cudaGetLastError());
  if (m > 0) {
    if (slices < 1 || slices > 65535 || slice_len < 1 ||
        static_cast<int64_t>(slices) * slice_len < m)
      return static_cast<int>(cudaErrorInvalidValue);
    nn1_pack_kernel<<<(m + kPackThreads - 1) / kPackThreads, kPackThreads, 0, s>>>(
        static_cast<const float*>(target), static_cast<const uint8_t*>(tmask),
        static_cast<float4*>(packed), m);
    cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    const dim3 grid((nq + kQBlock - 1) / kQBlock, slices);
    nn1_search_kernel<<<grid, kThreads, 0, s>>>(
        static_cast<const float*>(queries), static_cast<const float4*>(packed), nq, m,
        slice_len, static_cast<float*>(sbest), static_cast<int32_t*>(sidx));
    e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
  } else {
    slices = 0;
  }
  nn1_merge_kernel<<<(nq + 31) / 32, dim3(32, kMergeLanes), 0, s>>>(
      static_cast<const float*>(queries), static_cast<const float*>(target),
      static_cast<const uint8_t*>(tmask), static_cast<const float*>(sbest),
      static_cast<const int32_t*>(sidx), nq, m, slices, static_cast<int32_t*>(idx),
      static_cast<float*>(d2));
  return static_cast<int>(cudaGetLastError());
}
