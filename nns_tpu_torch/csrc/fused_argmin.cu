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
// kernel merges the S partials of each query. The scan, the block
// reduction and the merge are the shared helpers of common.cuh. The wrapper picks S so that
// the grid has at least ~2 blocks per SM. Every reduction is the
// lexicographic (d2, index) min of common.cuh, so the split and the merge
// order cannot change the lowest-index answer. The scan stops at column n
// (the ragged edge is bounds-checked), so replica padding past n is never
// read.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;  // query rows per block

__global__ void __launch_bounds__(kThreads)
fused_partial_kernel(const float* __restrict__ q, const float* __restrict__ r_dm,
                     int m, int k, int n, long long ld, int cols_per_split,
                     float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ float q_s[];  // (kQT, k), zero rows past m
  const int q0 = blockIdx.x * kQT;
  const int split = blockIdx.y;
  nns::stage_queries<kQT, kThreads>(q, q0, m, k, q_s);
  __syncthreads();

  float best_d[kQT];
  int best_i[kQT];
  nns::init_best(best_d, best_i);
  const long long lo = (long long)split * cols_per_split;
  const long long hi = min((long long)n, lo + cols_per_split);
  nns::scan_dim_major<kQT, kThreads>(
      r_dm, ld, k, lo, hi, [&](int qi, int d) { return q_s[qi * k + d]; }, best_d,
      best_i);

  float d;
  int i;
  nns::block_argmin<kQT, kThreads>(best_d, best_i, d, i);
  if (threadIdx.x < kQT && q0 + (int)threadIdx.x < m) {
    part_d[(long long)split * m + q0 + threadIdx.x] = d;
    part_i[(long long)split * m + q0 + threadIdx.x] = i;
  }
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
  cudaError_t e = nns::allow_smem(fused_partial_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int cols_per_split = (n + splits - 1) / splits;
  const dim3 grid((m + kQT - 1) / kQT, splits);
  fused_partial_kernel<<<grid, kThreads, smem, st>>>(
      q, r_dm, m, k, n, ld, cols_per_split, part_d, part_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)nns::launch_merge(part_d, part_i, m, splits, out_d, out_i, st);
}
