// Helpers shared by the port's CUDA kernels.
//
// Winners are (d2, id) pairs reduced by LEXICOGRAPHIC min: smaller d2, then
// smaller id. The order is total, associative and commutative, so the order
// in which threads, warps and blocks meet cannot change the answer. With
// id = reference index this is the brute-force family's lowest-index rule.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace nns {

constexpr int kWarp = 32;

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Butterfly reduce of one (d2, id) pair per lane; every lane ends with the
// warp's winner.
__device__ __forceinline__ void warp_argmin(float& d, int& i) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (lex_less(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// One squared-difference term, rounded exactly as the plain PyTorch
// versions round it: sub, mul and add each rounded to nearest, never fused
// into an FMA (the library is also built with -fmad=false).
__device__ __forceinline__ float add_sq_diff(float acc, float a, float b) {
  const float diff = __fsub_rn(a, b);
  return __fadd_rn(acc, __fmul_rn(diff, diff));
}

template <int kQT>
__device__ __forceinline__ void init_best(float (&best_d)[kQT], int (&best_i)[kQT]) {
#pragma unroll
  for (int qi = 0; qi < kQT; ++qi) {
    best_d[qi] = CUDART_INF_F;
    best_i[qi] = INT_MAX;
  }
}

// Stage kQT query rows q0.. of the (m, k) row-major queries in shared memory
// as (kQT, k), zero rows past m. The caller synchronizes.
template <int kQT, int kThreads>
__device__ __forceinline__ void stage_queries(const float* __restrict__ q, int q0,
                                              int m, int k, float* q_s) {
  for (int t = threadIdx.x; t < kQT * k; t += kThreads) {
    const int row = q0 + t / k;
    q_s[t] = row < m ? q[(long long)row * k + t % k] : 0.0f;
  }
}

// Scan columns lo + threadIdx.x, lo + threadIdx.x + kThreads, ... < hi of
// the dim-major refs (k, ld) against kQT queries, q_at(qi, d) giving query
// qi's coordinate d. Each column's k coordinates are read once (coalesced
// across the warp) and feed kQT register accumulators; the thread folds
// each column into its running (best_d, best_i) winners.
template <int kQT, int kThreads, typename QAt>
__device__ __forceinline__ void scan_dim_major(const float* __restrict__ r_dm,
                                               long long ld, int k, long long lo,
                                               long long hi, QAt q_at,
                                               float (&best_d)[kQT],
                                               int (&best_i)[kQT]) {
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    float acc[kQT];
#pragma unroll
    for (int qi = 0; qi < kQT; ++qi) acc[qi] = 0.0f;
    for (int d = 0; d < k; ++d) {
      const float rv = r_dm[(long long)d * ld + j];
#pragma unroll
      for (int qi = 0; qi < kQT; ++qi) acc[qi] = add_sq_diff(acc[qi], q_at(qi, d), rv);
    }
#pragma unroll
    for (int qi = 0; qi < kQT; ++qi) {
      if (lex_less(acc[qi], (int)j, best_d[qi], best_i[qi])) {
        best_d[qi] = acc[qi];
        best_i[qi] = (int)j;
      }
    }
  }
}

// Block-wide winner of each of the kQT queries: a warp butterfly, then
// thread qi < kQT folds the warps' winners of query qi into (d, i). Every
// thread of the block must call it; it synchronizes before returning, so it
// may be called again in a loop.
template <int kQT, int kThreads>
__device__ __forceinline__ void block_argmin(float (&best_d)[kQT], int (&best_i)[kQT],
                                             float& d, int& i) {
  constexpr int kWarps = kThreads / kWarp;
  __shared__ float red_d[kWarps][kQT];
  __shared__ int red_i[kWarps][kQT];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int qi = 0; qi < kQT; ++qi) {
    warp_argmin(best_d[qi], best_i[qi]);
    if (lane == 0) {
      red_d[warp][qi] = best_d[qi];
      red_i[warp][qi] = best_i[qi];
    }
  }
  __syncthreads();
  if (threadIdx.x < kQT) {
    const int qi = threadIdx.x;
    d = red_d[0][qi];
    i = red_i[0][qi];
    for (int w = 1; w < kWarps; ++w) {
      if (lex_less(red_d[w][qi], red_i[w][qi], d, i)) {
        d = red_d[w][qi];
        i = red_i[w][qi];
      }
    }
  }
  __syncthreads();
}

// One thread per query: lexicographic min over its S partial winners in the
// (S, m) scratch.
static __global__ void merge_partials_kernel(const float* __restrict__ part_d,
                                             const int* __restrict__ part_i, int m,
                                             int splits, float* __restrict__ out_d,
                                             int* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  float d = CUDART_INF_F;
  int i = INT_MAX;
  for (int s = 0; s < splits; ++s) {
    const float pd = part_d[(long long)s * m + row];
    const int pi = part_i[(long long)s * m + row];
    if (lex_less(pd, pi, d, i)) {
      d = pd;
      i = pi;
    }
  }
  out_d[row] = d;
  out_i[row] = i;
}

inline cudaError_t launch_merge(const float* part_d, const int* part_i, int m,
                                int splits, float* out_d, int* out_i,
                                cudaStream_t st) {
  merge_partials_kernel<<<(m + 255) / 256, 256, 0, st>>>(part_d, part_i, m, splits,
                                                         out_d, out_i);
  return cudaGetLastError();
}

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

}  // namespace nns
