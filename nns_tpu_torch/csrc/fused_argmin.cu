// v4 fused distance + argmin over dim-major reference points.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_fused_kernel` (launched by
// `_fused_on_prepared`): a (TM, TN) direct-f32 distance tile per grid step,
// per-row min with the lowest index, strict-< carry over ref tiles.
//
// Bound on the H100: compute. Each (query, ref) pair costs k sub + k mul +
// k add + a compare in f32 on the CUDA cores (FMA is forbidden, so the
// 67 TFLOP/s FMA peak halves), while the reference set (12 MB at 1M x 3-D)
// sits in the 50 MB L2 and every block re-reads it from there. The exact
// fallback calls it with a bucket of 8-64 queries against 1M refs: with one
// block per query tile, 131 of 132 SMs would idle.
//
// Design: grid = (query tiles of kQT rows, S ref ranges). A block stages its
// kQT query rows in shared memory; each thread walks the columns j = lo +
// tid, lo + tid + 256, ... of its range, reads column j's k coordinates once
// (coalesced across the warp) and updates kQT register accumulators, so one
// global load feeds kQT distance terms. Each thread keeps a running (d2, j)
// winner per query; a warp butterfly and a shared-memory pass over the
// warps give the block's winner, written to an (S, m) scratch. A second
// kernel merges the S partials of each query. The wrapper picks S so that
// the grid has at least ~2 blocks per SM. Every reduction is the
// lexicographic (d2, index) min of common.cuh, so the split and the merge
// order cannot change the lowest-index answer. The scan stops at column n
// (the ragged edge is bounds-checked), so replica padding past n is never
// read.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / nns::kWarp;
constexpr int kQT = 16;  // query rows per block

__global__ void __launch_bounds__(kThreads)
fused_partial_kernel(const float* __restrict__ q, const float* __restrict__ r_dm,
                     int m, int k, int n, long long ld, int cols_per_split,
                     float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ float q_s[];  // (kQT, k), zero rows past m
  __shared__ float red_d[kWarps][kQT];
  __shared__ int red_i[kWarps][kQT];

  const int q0 = blockIdx.x * kQT;
  const int split = blockIdx.y;
  for (int t = threadIdx.x; t < kQT * k; t += kThreads) {
    const int row = q0 + t / k;
    q_s[t] = row < m ? q[(long long)row * k + t % k] : 0.0f;
  }
  __syncthreads();

  float best_d[kQT];
  int best_i[kQT];
#pragma unroll
  for (int qi = 0; qi < kQT; ++qi) {
    best_d[qi] = CUDART_INF_F;
    best_i[qi] = INT_MAX;
  }

  const long long lo = (long long)split * cols_per_split;
  const long long hi = min((long long)n, lo + cols_per_split);
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    float acc[kQT];
#pragma unroll
    for (int qi = 0; qi < kQT; ++qi) acc[qi] = 0.0f;
    for (int d = 0; d < k; ++d) {
      const float rv = r_dm[(long long)d * ld + j];
#pragma unroll
      for (int qi = 0; qi < kQT; ++qi) {
        acc[qi] = nns::add_sq_diff(acc[qi], q_s[qi * k + d], rv);
      }
    }
#pragma unroll
    for (int qi = 0; qi < kQT; ++qi) {
      if (nns::lex_less(acc[qi], (int)j, best_d[qi], best_i[qi])) {
        best_d[qi] = acc[qi];
        best_i[qi] = (int)j;
      }
    }
  }

  const int warp = threadIdx.x / nns::kWarp;
  const int lane = threadIdx.x % nns::kWarp;
#pragma unroll
  for (int qi = 0; qi < kQT; ++qi) {
    nns::warp_argmin(best_d[qi], best_i[qi]);
    if (lane == 0) {
      red_d[warp][qi] = best_d[qi];
      red_i[warp][qi] = best_i[qi];
    }
  }
  __syncthreads();
  if (threadIdx.x < kQT && q0 + (int)threadIdx.x < m) {
    const int qi = threadIdx.x;
    float d = red_d[0][qi];
    int i = red_i[0][qi];
    for (int w = 1; w < kWarps; ++w) {
      if (nns::lex_less(red_d[w][qi], red_i[w][qi], d, i)) {
        d = red_d[w][qi];
        i = red_i[w][qi];
      }
    }
    part_d[(long long)split * m + q0 + qi] = d;
    part_i[(long long)split * m + q0 + qi] = i;
  }
}

// One thread per query: lexicographic min over its S partial winners.
__global__ void fused_merge_kernel(const float* __restrict__ part_d,
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
    if (nns::lex_less(pd, pi, d, i)) {
      d = pd;
      i = pi;
    }
  }
  out_d[row] = d;
  out_i[row] = i;
}

}  // namespace

// q: (m, k) row-major; r_dm: (k, ld) dim-major, columns [0, n) scanned;
// part_d/part_i: (splits, m) scratch; out_d/out_i: (m,). Launches on
// `stream` and does not synchronize. Returns cudaGetLastError().
extern "C" int nns_fused_argmin(const float* q, const float* r_dm, int m,
                                int k, int n, long long ld, int splits,
                                float* part_d, int* part_i, float* out_d,
                                int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kQT * k * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        fused_partial_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols_per_split = (n + splits - 1) / splits;
  const dim3 grid((m + kQT - 1) / kQT, splits);
  fused_partial_kernel<<<grid, kThreads, smem, st>>>(
      q, r_dm, m, k, n, ld, cols_per_split, part_d, part_i);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  fused_merge_kernel<<<(m + 255) / 256, 256, 0, st>>>(part_d, part_i, m,
                                                      splits, out_d, out_i);
  return (int)cudaGetLastError();
}
