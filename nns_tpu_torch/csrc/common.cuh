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

// Resident blocks of `kernel` per SM at kThreads threads and `smem` bytes of
// dynamic shared memory, times the SMs of the current device: the size of a
// persistent grid.
template <typename Kernel>
inline cudaError_t grid_slots(Kernel kernel, int threads, size_t smem, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(kernel, smem);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  *slots = per_sm * sms;
  return e;
}

// ---------------------------------------------------------------------------
// Bulk asynchronous copies (cp.async.bulk, no tensor map) completing on an
// mbarrier in shared memory. One thread arms a stage's barrier with the
// bytes it expects and issues the stage's copies; every thread waits on the
// barrier's phase parity. Source, destination and size must be multiples of
// 16 bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread initialises the barriers (one arrival each), then the block
// synchronizes before any thread uses them.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The arming thread's arrival, expecting `bytes` from the stage's copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Order the block's earlier generic-proxy reads of shared memory before the
// async proxy's next writes to it (a stage is refilled after it was read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

}  // namespace nns
