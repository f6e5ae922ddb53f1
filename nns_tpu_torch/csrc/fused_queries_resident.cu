// v6 fused distance + argmin with the whole query set RESIDENT in
// __constant__ memory and a grid over reference ranges only.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_fused_qres_kernel` (launched
// by `_fused_qres_call`): the padded (m, k) query block stays in VMEM for the
// whole grid, which runs over (k, tile_n) ref tiles only, with a (min, idx)
// carry per query.
//
// Bound on the H100: compute, as v4. The rung's memory idea is the
// reference's 64 KB __constant__ query buffer (core.cu:479-481): every
// thread of a warp reads the same query coordinate at the same time, which
// the constant cache serves as one broadcast, and the queries take no
// shared memory or registers beyond the kQT being scored.
//
// Design: the constant bank holds kConstFloats = 16384 floats (64 KB), so
// one launch holds cap = 16384 / k query rows (1024 at k = 16, 5461 at
// k = 3). The JAX budget is 4 MB, so a larger query set runs as several
// launches of this kernel, each after a stream-ordered copy of its chunk of
// rows into the bank; the wrapper applies the v4 fallback only above the 4
// MB budget, as the JAX package does. Grid = S ref ranges, one block each
// (no query axis: every block sees all resident rows). A block walks the
// resident rows kQT at a time; for each group its threads scan the range
// (common.cuh scan_dim_major, coalesced dim-major columns) and the block
// reduction writes that group's winners to the (S, m) partials. One merge
// per call folds the S ranges per query. Launches must stay on one stream:
// the bank is one per device, and the copy for the next chunk is ordered
// after the previous kernel only by the stream.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;               // resident rows scored per pass
constexpr int kConstFloats = 16384;   // 64 KB of __constant__ memory

__constant__ float c_queries[kConstFloats];

__global__ void __launch_bounds__(kThreads)
queries_resident_partial_kernel(const float* __restrict__ r_dm, int rows, int row0,
                                int m, int k, int n, long long ld, int cols_per_split,
                                float* __restrict__ part_d, int* __restrict__ part_i) {
  const int split = blockIdx.x;
  const long long lo = (long long)split * cols_per_split;
  const long long hi = min((long long)n, lo + cols_per_split);
  for (int q0 = 0; q0 < rows; q0 += kQT) {
    float best_d[kQT];
    int best_i[kQT];
    nns::init_best(best_d, best_i);
    // Rows past `rows` repeat the last resident row (never written out), so
    // no read leaves the bank's filled part.
    nns::scan_dim_major<kQT, kThreads>(
        r_dm, ld, k, lo, hi,
        [&](int qi, int d) { return c_queries[min(q0 + qi, rows - 1) * k + d]; },
        best_d, best_i);
    float d;
    int i;
    nns::block_argmin<kQT, kThreads>(best_d, best_i, d, i);
    if (threadIdx.x < kQT && q0 + (int)threadIdx.x < rows) {
      part_d[(long long)split * m + row0 + q0 + threadIdx.x] = d;
      part_i[(long long)split * m + row0 + q0 + threadIdx.x] = i;
    }
  }
}

}  // namespace

// q: (m, k) row-major on the device; r_dm: (k, ld) dim-major, columns [0, n)
// scanned; part_d/part_i: (splits, m) scratch; out_d/out_i: (m,). Launches
// ceil(m / (16384 / k)) scans and one merge on `stream` and does not
// synchronize. Returns cudaGetLastError().
extern "C" int nns_fused_queries_resident(const float* q, const float* r_dm, int m, int k,
                                          int n, long long ld, int splits, float* part_d,
                                          int* part_i, float* out_d, int* out_i,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (k > kConstFloats) return (int)cudaErrorInvalidValue;  // one row must fit
  const int cap = kConstFloats / k;
  const int cols_per_split = (n + splits - 1) / splits;
  for (int row0 = 0; row0 < m; row0 += cap) {
    const int rows = min(cap, m - row0);
    cudaError_t e = cudaMemcpyToSymbolAsync(c_queries, q + (long long)row0 * k,
                                            (size_t)rows * k * sizeof(float), 0,
                                            cudaMemcpyDeviceToDevice, st);
    if (e != cudaSuccess) return (int)e;
    queries_resident_partial_kernel<<<splits, kThreads, 0, st>>>(
        r_dm, rows, row0, m, k, n, ld, cols_per_split, part_d, part_i);
    e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return (int)nns::launch_merge(part_d, part_i, m, splits, out_d, out_i, st);
}
