// v3 fused distance + argmin over POINT-MAJOR reference points.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_fused_pm_kernel` (launched by
// `_fused_pm_call`): dim-major queries (k, TM) against point-major ref tiles
// (TN, k), a transposed (TN, TM) distance tile reduced per query, strict-<
// carry over ref tiles.
//
// Bound on the H100: memory access pattern, by design. The refs stay in the
// (n, k) layout the caller gave, and thread j reads its point's k
// coordinates at stride k (r[j * k + d]), so one warp-wide load touches 32
// addresses k * 4 bytes apart instead of 128 contiguous bytes. This is the
// uncoalesced pre-SoA layout of the reference's v3 (core.cu:66); v4
// (fused_argmin.cu) exists to remove it, and the pair measures what the
// transpose buys. At 1M x 3-D the 12 MB of refs sit in the 50 MB L2, so the
// cost is L2 sectors wasted per useful byte, not HBM bandwidth.
//
// Design: the grid and merge are fused_argmin.cu's (query tiles of kQT rows
// x S ref ranges, then one merge kernel over the (S, m) partials). The
// block stages its queries dim-major in shared memory, (k, kQT), as the TPU
// kernel takes them, so the kQT values of one dimension are contiguous. Each
// thread walks the columns of its range with kQT register accumulators and
// a running lexicographic (d2, index) winner per query. The scan stops at
// column n: nothing past the refs is read.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;  // query rows per block

__global__ void __launch_bounds__(kThreads)
point_major_partial_kernel(const float* __restrict__ q, const float* __restrict__ r_pm,
                           int m, int k, int n, int cols_per_split,
                           float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ float q_s[];  // (k, kQT) dim-major, zero columns past m
  const int q0 = blockIdx.x * kQT;
  const int split = blockIdx.y;
  for (int t = threadIdx.x; t < kQT * k; t += kThreads) {
    const int d = t / kQT, row = q0 + t % kQT;
    q_s[t] = row < m ? q[(long long)row * k + d] : 0.0f;
  }
  __syncthreads();

  float best_d[kQT];
  int best_i[kQT];
  nns::init_best(best_d, best_i);
  const long long lo = (long long)split * cols_per_split;
  const long long hi = min((long long)n, lo + cols_per_split);
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    const float* __restrict__ point = r_pm + j * k;
    float acc[kQT];
#pragma unroll
    for (int qi = 0; qi < kQT; ++qi) acc[qi] = 0.0f;
    for (int d = 0; d < k; ++d) {
      const float rv = point[d];
#pragma unroll
      for (int qi = 0; qi < kQT; ++qi) acc[qi] = nns::add_sq_diff(acc[qi], q_s[d * kQT + qi], rv);
    }
#pragma unroll
    for (int qi = 0; qi < kQT; ++qi) {
      if (nns::lex_less(acc[qi], (int)j, best_d[qi], best_i[qi])) {
        best_d[qi] = acc[qi];
        best_i[qi] = (int)j;
      }
    }
  }

  float d;
  int i;
  nns::block_argmin<kQT, kThreads>(best_d, best_i, d, i);
  if (threadIdx.x < kQT && q0 + (int)threadIdx.x < m) {
    part_d[(long long)split * m + q0 + threadIdx.x] = d;
    part_i[(long long)split * m + q0 + threadIdx.x] = i;
  }
}

}  // namespace

// q: (m, k) row-major; r_pm: (n, k) point-major; part_d/part_i: (splits, m)
// scratch; out_d/out_i: (m,). Launches on `stream` and does not
// synchronize. Returns cudaGetLastError().
extern "C" int nns_fused_point_major(const float* q, const float* r_pm, int m, int k,
                                     int n, int splits, float* part_d, int* part_i,
                                     float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (size_t)kQT * k * sizeof(float);
  cudaError_t e = nns::allow_smem(point_major_partial_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  const int cols_per_split = (n + splits - 1) / splits;
  const dim3 grid((m + kQT - 1) / kQT, splits);
  point_major_partial_kernel<<<grid, kThreads, smem, st>>>(q, r_pm, m, k, n, cols_per_split,
                                                          part_d, part_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)nns::launch_merge(part_d, part_i, m, splits, out_d, out_i, st);
}
