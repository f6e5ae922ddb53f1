// v7 two-level argmin: per (query tile, ref tile) partial winners, no carry.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_partial_kernel` (launched by
// `_two_level_call`): every (query tile, ref tile) grid step writes its own
// (min, idx) block into an (n_tiles, m_pad) table, and a second, XLA-level
// reduce picks the lowest tile on ties (the reference's multi-block
// two-level reduction, core.cu:573-652).
//
// Bound on the H100: compute, as v4, plus the table: n_tiles * m * 8 bytes
// written and read once more by the second reduce (2 MB at 1024 x 1M with
// 4096-column tiles).
//
// Design: grid = (query tiles of kQT rows) x (ref tiles of tile_n columns),
// one block per table cell and nothing carried between blocks. A block
// stages its queries in shared memory, its threads scan the tile's columns
// (common.cuh scan_dim_major) and the block reduction writes the tile's
// lexicographic (d2, index) winner of each query to part[tile, row]. The
// scan stops at column n, so the last tile holds only real columns. The
// second level is the wrapper's torch argmin over the tile axis, which
// returns the first (lowest) tile on ties; with the lowest index inside
// each tile that is the global lowest-index rule.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;  // query rows per block

__global__ void __launch_bounds__(kThreads)
two_level_partial_kernel(const float* __restrict__ q, const float* __restrict__ r_dm,
                         int m, int k, int n, long long ld, int tile_n,
                         float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ float q_s[];  // (kQT, k), zero rows past m
  const int q0 = blockIdx.x * kQT;
  const int tile = blockIdx.y;
  nns::stage_queries<kQT, kThreads>(q, q0, m, k, q_s);
  __syncthreads();

  float best_d[kQT];
  int best_i[kQT];
  nns::init_best(best_d, best_i);
  const long long lo = (long long)tile * tile_n;
  const long long hi = min((long long)n, lo + tile_n);
  nns::scan_dim_major<kQT, kThreads>(
      r_dm, ld, k, lo, hi, [&](int qi, int d) { return q_s[qi * k + d]; }, best_d,
      best_i);

  float d;
  int i;
  nns::block_argmin<kQT, kThreads>(best_d, best_i, d, i);
  if (threadIdx.x < kQT && q0 + (int)threadIdx.x < m) {
    part_d[(long long)tile * m + q0 + threadIdx.x] = d;
    part_i[(long long)tile * m + q0 + threadIdx.x] = i;
  }
}

}  // namespace

// q: (m, k) row-major; r_dm: (k, ld) dim-major, columns [0, n) scanned;
// part_d/part_i: (ceil(n / tile_n), m) table. Launches on `stream` and does
// not synchronize. Returns cudaGetLastError().
extern "C" int nns_two_level(const float* q, const float* r_dm, int m, int k, int n,
                             long long ld, int tile_n, float* part_d, int* part_i,
                             void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kQT * k * sizeof(float);
  cudaError_t e = nns::allow_smem(two_level_partial_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + kQT - 1) / kQT, (n + tile_n - 1) / tile_n);
  two_level_partial_kernel<<<grid, kThreads, smem, st>>>(q, r_dm, m, k, n, ld, tile_n,
                                                        part_d, part_i);
  return (int)cudaGetLastError();
}
