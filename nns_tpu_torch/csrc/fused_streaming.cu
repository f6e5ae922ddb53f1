// v5 fused distance + argmin with reference tiles STREAMED through shared
// memory by asynchronous copies, double-buffered.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_fused_stream_kernel` (launched
// by `_fused_stream_call`): refs left in HBM, (k, tile_n) dim-major tiles
// copied into VMEM by manual DMA into two slots, a (min, idx) carry in a
// fori_loop over the tiles.
//
// Bound on the H100: compute, as v4. The point of the rung is the memory
// path: the TPU kernel exists to overlap the copy of tile t+1 with the
// distances of tile t (the reference's texture staging, core.cu:382). Here
// that is cp.async (global -> shared, bypassing registers, 16 bytes a
// copy) into two shared-memory stages: while the block computes on one
// stage, the copies of the next tile land in the other.
//
// Design: grid = (query tiles of kQT rows) x (S ref ranges), as
// fused_argmin.cu, with each range a whole number of kTile-column tiles. A
// block stages its queries (kQT, k) in shared memory once, then streams its
// range: tile t of (k, kTile) dim-major floats goes to stage t % 2 while
// tile t - 1 is computed. Each thread owns columns tid and tid + 256 of a
// tile and keeps the (min, idx) carry of every query in registers across all
// tiles; the block reduction and the merge of the S partials are
// common.cuh's. Every copy is 16 bytes and 16-byte aligned: the wrapper
// passes refs whose row pitch `ld` is a multiple of 4 floats on a 16-byte
// aligned base, tiles start at multiples of kTile, and only the 4-column
// chunks that start before the range end `hi` are copied. Since hi <= n <=
// ld and ld % 4 == 0, no copy reads past the padded width, and columns at or
// past hi are never computed. k is not padded (the JAX pad to 8 is a Mosaic
// alignment rule).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kQT = 16;     // query rows per block
constexpr int kTile = 512;  // columns per shared-memory stage
constexpr int kChunks = kTile / 4;  // 16-byte copies per dimension row

__device__ __forceinline__ void cp_async16(float* smem, const float* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Wait until at most one committed group of this thread is still in flight.
__device__ __forceinline__ void cp_async_wait_all_but_one() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Start the copies of the (k, kTile) tile at column col0 into `stage`.
__device__ __forceinline__ void load_tile(float* stage, const float* __restrict__ r_dm,
                                          long long ld, int k, long long col0,
                                          long long hi) {
  for (int c = threadIdx.x; c < k * kChunks; c += kThreads) {
    const int d = c / kChunks, col = (c % kChunks) * 4;
    if (col0 + col < hi) cp_async16(stage + d * kTile + col, r_dm + d * ld + col0 + col);
  }
}

__global__ void __launch_bounds__(kThreads)
streaming_partial_kernel(const float* __restrict__ q, const float* __restrict__ r_dm,
                         int m, int k, int n, long long ld, int cols_per_split,
                         float* __restrict__ part_d, int* __restrict__ part_i) {
  // Two (k, kTile) stages, then the (kQT, k) queries.
  extern __shared__ __align__(16) float smem[];
  float* q_s = smem + 2 * k * kTile;
  const int q0 = blockIdx.x * kQT;
  const int split = blockIdx.y;
  nns::stage_queries<kQT, kThreads>(q, q0, m, k, q_s);

  float best_d[kQT];
  int best_i[kQT];
  nns::init_best(best_d, best_i);
  const long long lo = (long long)split * cols_per_split;
  const long long hi = min((long long)n, lo + cols_per_split);
  const int n_tiles = hi > lo ? (int)((hi - lo + kTile - 1) / kTile) : 0;

  if (n_tiles > 0) load_tile(smem, r_dm, ld, k, lo, hi);
  cp_async_commit();
  for (int t = 0; t < n_tiles; ++t) {
    if (t + 1 < n_tiles) {
      load_tile(smem + ((t + 1) & 1) * k * kTile, r_dm, ld, k, lo + (long long)(t + 1) * kTile, hi);
    }
    cp_async_commit();  // possibly empty: keeps one group per iteration
    cp_async_wait_all_but_one();  // this thread's copies of tile t landed
    __syncthreads();              // ... and every other thread's
    const float* stage = smem + (t & 1) * k * kTile;
    const long long col0 = lo + (long long)t * kTile;
    for (int c = threadIdx.x; c < kTile && col0 + c < hi; c += kThreads) {
      float acc[kQT];
#pragma unroll
      for (int qi = 0; qi < kQT; ++qi) acc[qi] = 0.0f;
      for (int d = 0; d < k; ++d) {
        const float rv = stage[d * kTile + c];
#pragma unroll
        for (int qi = 0; qi < kQT; ++qi) acc[qi] = nns::add_sq_diff(acc[qi], q_s[qi * k + d], rv);
      }
      const int j = (int)(col0 + c);
#pragma unroll
      for (int qi = 0; qi < kQT; ++qi) {
        if (nns::lex_less(acc[qi], j, best_d[qi], best_i[qi])) {
          best_d[qi] = acc[qi];
          best_i[qi] = j;
        }
      }
    }
    __syncthreads();  // stage t % 2 is free before tile t + 2 overwrites it
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

// q: (m, k) row-major; r_dm: (k, ld) dim-major with ld % 4 == 0 and a
// 16-byte aligned base, columns [0, n) scanned; part_d/part_i: (splits, m)
// scratch; out_d/out_i: (m,). Launches on `stream` and does not
// synchronize. Returns cudaGetLastError().
extern "C" int nns_fused_streaming(const float* q, const float* r_dm, int m, int k, int n,
                                   long long ld, int splits, float* part_d, int* part_i,
                                   float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ld % 4 != 0 || reinterpret_cast<unsigned long long>(r_dm) % 16 != 0) {
    return (int)cudaErrorMisalignedAddress;
  }
  const size_t smem = (size_t)(2 * kTile + kQT) * k * sizeof(float);
  cudaError_t e = nns::allow_smem(streaming_partial_kernel, smem);
  if (e != cudaSuccess) return (int)e;
  // Ranges of whole tiles, so that every tile starts 16-byte aligned.
  const int per_split = (n + splits - 1) / splits;
  const int cols_per_split = (per_split + kTile - 1) / kTile * kTile;
  const dim3 grid((m + kQT - 1) / kQT, splits);
  streaming_partial_kernel<<<grid, kThreads, smem, st>>>(q, r_dm, m, k, n, ld, cols_per_split,
                                                        part_d, part_i);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)nns::launch_merge(part_d, part_i, m, splits, out_d, out_i, st);
}
