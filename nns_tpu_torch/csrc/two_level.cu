// v7 two-level argmin: an (n_tiles, m) table of per-tile winners, then a
// second reduce over the tiles.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_partial_kernel` (launched by
// `_two_level_call`): every (query tile, ref tile) grid step writes its own
// (min, idx) block into an (n_tiles, m_pad) table, and a second, XLA-level
// reduce picks the lowest tile on ties (the reference's multi-block
// two-level reduction, core.cu:573-652).
//
// Bound on the H100: operations, as v4: per pair k sub, k mul, k add and a
// compare, each rounded on its own (no FMA, so kernel and plain version stay
// bit-equal): about 35-45% of the f32 peak at most (utils/bounds.py). The
// table adds n_tiles * m * 8 bytes, written once and read once more by the
// second reduce (2 MB at 1024 x 1M with 4096-column tiles).
//
// Design: v5's producer/consumer ring (common.cuh StageRing), with v7's two
// levels kept.
// - Grid = (query tiles of 256 x q_rows / tpr rows) x (ranges of WHOLE
//   tile_n-column table tiles), as many blocks as fit at once. One producer
//   warp streams the range's dim-major columns through 4 stages, one
//   cp.async.bulk per dimension row of a stage on the stage's full mbarrier;
//   the 8 consumer warps release a stage on its empty mbarrier. No
//   block-wide barrier after the start. A pitch that is not a multiple of 4
//   floats, a misaligned base or a range that is not a multiple of 4
//   columns takes the plain-load path (the producer lanes load the stage).
// - Query rows in registers. At k = 3 and 16 (template parameters), and at
//   any other k up to 8 (run time, the rows zero-padded to 8 dims), each
//   consumer thread holds 4 (or 1) rows for the whole range, so 4 rows
//   share each column's shared-memory loads. Every other k runs one sliced
//   instance: a stage holds at most 16 of the k dimensions,
//   the thread's row slice waits in registers, and with several slices the
//   columns' sums (8 groups of four columns per thread, so a stage is at
//   most 32 columns per thread of a row) carry across the slices. Its shared
//   memory does not grow with k, so every k runs.
// - The walk. A thread visits its columns in ascending order from (inf, the
//   table tile's first column) and keeps winners with a strict <, so a
//   tile's winner is its lowest index among equal distances, and a row whose
//   every distance is +inf gets the tile's first column, as the plain
//   version gives. Stage widths are the plan's and tile_n the caller's, so a
//   tile boundary can fall inside a stage, even inside a group of four
//   columns: each stage is walked in segments that end at the boundaries,
//   and at each boundary the rows' winners go to part[tile, row] and restart
//   at (inf, the next tile's first column).
// - Below 256 rows, tpr (2-32) adjacent lanes share a row, each scoring
//   every tpr-th group of four columns. The segments are the same for every
//   thread of the block, so at each boundary the lanes of a row fold their
//   winners by shuffles and the first writes: no block-wide reduction per
//   table tile.
// - The second level is the wrapper's torch argmin over the tile axis
//   (fused_ladder._second_reduce), which returns the lowest tile on ties;
//   with the lowest index inside each tile that is the global lowest-index
//   rule. The JAX package computes it in XLA, outside its kernel.
//
// The plan (q_rows, tpr, stage columns, dims per stage, stages) has one
// home, `two_level_plan` in nns_tpu_torch/kernels/fused_ladder.py. This file
// refuses any plan it has no instance for; its shared-memory need is the
// ring's own (`nns_two_level_smem`).
#include "common.cuh"

namespace {

constexpr int kGroups = 8;  // sliced: four-column groups per thread and column block
constexpr int kMaxStages = 8;
constexpr int kRunKMax = 8;  // run-time k with whole-k stages and 4 rows per thread

using Kernel = void (*)(nns::RingArgs, int);

// A consumer thread's rows: thread t holds rows row0 + qi * stride + t /
// tpr, and the tpr adjacent lanes of a row each take part t % tpr of the
// columns, so that they fold by shuffles. An instance that never shares
// rows passes tpr as the constant 1.
struct Rows {
  int row0, stride, part, lane_row;
  __device__ Rows(int q_rows, int tpr) {
    stride = nns::kRingConsumers / tpr;
    row0 = blockIdx.x * stride * q_rows;
    part = tpr == 1 ? 0 : (int)threadIdx.x % tpr;
    lane_row = tpr == 1 ? (int)threadIdx.x : (int)threadIdx.x / tpr;
  }
  __device__ int row(int qi) const { return row0 + qi * stride + lane_row; }
};

// The thread's rows of the (m, k) queries (clamped to the last row), zero
// past k <= kK.
template <int kK, int kQ>
__device__ __forceinline__ void load_rows(const float* __restrict__ q, const Rows& rows, int m,
                                          int k, float (&qr)[kQ][kK]) {
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    const long long row = min(rows.row(qi), m - 1);
#pragma unroll
    for (int d = 0; d < kK; ++d) qr[qi][d] = d < k ? q[row * k + d] : 0.0f;
  }
}

// common.cuh score4 (dim-major) over the first k <= kK dimensions, k at
// run time: the same rounding, d2 = 0 + diff^2 + ... in ascending order.
template <int kK, int kQ>
__device__ __forceinline__ void score4_k(const float* g, int pitch, int k,
                                         const float (&qr)[kQ][kK], float (&acc)[kQ][4]) {
#pragma unroll
  for (int d = 0; d < kK; ++d) {
    if (d < k) {
      const float4 r = *reinterpret_cast<const float4*>(g + d * pitch);
      const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) {
          const float diff = __fsub_rn(qr[qi][d], rv[e]);
          acc[qi][e] = d == 0 ? __fmul_rn(diff, diff) : __fadd_rn(acc[qi][e], __fmul_rn(diff, diff));
        }
      }
    }
  }
}

// Where a block's walk stands in the table: the current tile, and the first
// column past it (the next boundary, or the range's end).
struct TileWalk {
  int tile;
  long long end;
};

// Fold the columns j0 + from .. j0 + to - 1 of 4 consecutive columns at j0
// (the window may reach past either side of the four) into each row's
// running winner, in ascending order, with a strict <.
template <int kQ>
__device__ __forceinline__ void fold_window(const float (&acc)[kQ][4], float (&best_d)[kQ],
                                            int (&best_i)[kQ], int j0, int from, int to) {
#pragma unroll
  for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      if (cc >= from && cc < to && acc[qi][cc] < best_d[qi]) {
        best_d[qi] = acc[qi][cc];
        best_i[qi] = j0 + cc;
      }
    }
  }
}

// The current table tile is done: the tpr lanes of each row fold their
// winners (lexicographically, so equal distances keep the lowest index),
// the first writes part[tile, row], and every lane restarts at (inf, the
// next tile's first column). Every consumer calls it at the same boundary.
template <int kQ>
__device__ __forceinline__ void end_tile(float (&best_d)[kQ], int (&best_i)[kQ], const Rows& rows,
                                         int tpr, const nns::RingArgs& a, int tile_n,
                                         long long hi, TileWalk& w) {
  for (int off = 1; off < tpr; off <<= 1) {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      const float od = __shfl_xor_sync(0xffffffffu, best_d[qi], off);
      const int oi = __shfl_xor_sync(0xffffffffu, best_i[qi], off);
      if (nns::lex_less(od, oi, best_d[qi], best_i[qi])) {
        best_d[qi] = od;
        best_i[qi] = oi;
      }
    }
  }
  if (rows.part == 0) {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      const int row = rows.row(qi);
      if (row < a.m) {
        a.part_d[(long long)w.tile * a.m + row] = best_d[qi];
        a.part_i[(long long)w.tile * a.m + row] = best_i[qi];
      }
    }
  }
  nns::init_best(best_d, best_i, (int)w.end);
  ++w.tile;
  w.end = min(w.end + tile_n, hi);
}

// k = kK (or, kRunK, any k <= kK at run time), kQ rows per consumer
// thread, all k dims in each stage.
template <int kK, int kQ, bool kRunK>
__global__ void __launch_bounds__(nns::kRingThreads, 2)
two_level_kernel(const nns::RingArgs a, int tile_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const nns::StageRing ring(smem, a.stages, (long long)(kRunK ? a.k : kK) * a.cols);
  const nns::RingRange range(a);
  ring.start(a.bulk);
  if (threadIdx.x >= nns::kRingConsumers) {
    nns::produce_dim_major(ring, a, range, 1);
    return;
  }
  const int tpr = kQ == 1 ? a.tpr : 1;
  const Rows rows(kQ, tpr);
  float qr[kQ][kK];
  load_rows(a.q, rows, a.m, kRunK ? a.k : kK, qr);
  float best_d[kQ];
  int best_i[kQ];
  nns::init_best(best_d, best_i, (int)range.lo);
  TileWalk w{(int)(range.lo / tile_n), min(range.lo + tile_n, range.hi)};
  nns::RingPos pos;
  for (int t = 0; t < range.n_tiles; ++t, pos.next(a.stages)) {
    long long col0;
    const int lim = range.tile(a, t, col0);
    const float* st = ring.acquire(pos);
    // Segments [s0, s1) of the stage, each inside one table tile.
    for (int s0 = 0; s0 < lim;) {
      const int s1 = (int)min((long long)lim, w.end - col0);
      const int g0 = s0 / 4;  // the group of four holding column s0
      for (int c = 4 * (g0 + ((rows.part - g0) & (tpr - 1))); c < s1; c += 4 * tpr) {
        float acc[kQ][4];
        if (kRunK) {
          score4_k(st + c, a.cols, a.k, qr, acc);
        } else {
          nns::score4<kK, kQ, false>(st + c, a.cols, qr, acc);
        }
        if (c >= s0) {
          nns::fold4(acc, best_d, best_i, (int)(col0 + c), s1 - c);
        } else {  // the group holding s0, where a boundary cuts a group
          fold_window(acc, best_d, best_i, (int)(col0 + c), s0 - c, s1 - c);
        }
      }
      s0 = s1;
      if (col0 + s1 == w.end) end_tile(best_d, best_i, rows, tpr, a, tile_n, range.hi, w);
    }
    ring.release(pos);
  }
}

// Any k at run time, one row per tpr consumer threads, the contraction in
// slices of `dims` dimensions (the row's slice in registers). Columns go in
// blocks of kGroups groups of four per thread; with one slice a block folds
// as soon as it is scored, with several the plan keeps a stage to one block,
// whose sums carry over the stage's slices. kShared: tpr > 1.
template <bool kShared>
__global__ void __launch_bounds__(nns::kRingThreads, 2)
two_level_sliced_kernel(const nns::RingArgs a, int tile_n) {
  extern __shared__ __align__(16) unsigned char smem[];
  const nns::StageRing ring(smem, a.stages, (long long)a.dims * a.cols);
  const nns::RingRange range(a);
  const int slices = (a.k + a.dims - 1) / a.dims;
  ring.start(a.bulk);
  if (threadIdx.x >= nns::kRingConsumers) {
    nns::produce_dim_major(ring, a, range, slices);
    return;
  }
  const int tpr = kShared ? a.tpr : 1;
  const Rows rows(1, tpr);
  const int step = 4 * tpr;         // between a thread's groups of four
  const int span = kGroups * step;  // the columns of one column block
  const float* q_row = a.q + (long long)min(rows.row(0), a.m - 1) * a.k;
  float qr[nns::kRingMaxDims];
  if (slices == 1) nns::load_slice(q_row, 0, a.dims, a.k, qr);
  float best_d[1];
  int best_i[1];
  nns::init_best(best_d, best_i, (int)range.lo);
  TileWalk w{(int)(range.lo / tile_n), min(range.lo + tile_n, range.hi)};
  nns::RingPos pos;
  for (int t = 0; t < range.n_tiles; ++t) {
    long long col0;
    const int lim = range.tile(a, t, col0);
    float acc[kGroups][1][4];
    for (int s = 0; s < slices; ++s, pos.next(a.stages)) {
      const int d0 = s * a.dims;
      const int nd = min(a.dims, a.k - d0);
      if (slices > 1) nns::load_slice(q_row, d0, a.dims, a.k, qr);
      const float* st = ring.acquire(pos);
      for (int b0 = 0; b0 < lim; b0 += span) {  // the same blocks for every thread
        const int cb = b0 + 4 * rows.part;
        if (s == 0) {
#pragma unroll
          for (int j = 0; j < kGroups; ++j) {
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) acc[j][0][cc] = 0.0f;
          }
        }
#pragma unroll
        for (int d = 0; d < nns::kRingMaxDims; ++d) {
          if (d < nd) {
#pragma unroll
            for (int j = 0; j < kGroups; ++j) {
              const int c = cb + step * j;
              if (c < lim) {
                const float4 r = *reinterpret_cast<const float4*>(st + d * a.cols + c);
                acc[j][0][0] = nns::add_sq_diff(acc[j][0][0], qr[d], r.x);
                acc[j][0][1] = nns::add_sq_diff(acc[j][0][1], qr[d], r.y);
                acc[j][0][2] = nns::add_sq_diff(acc[j][0][2], qr[d], r.z);
                acc[j][0][3] = nns::add_sq_diff(acc[j][0][3], qr[d], r.w);
              }
            }
          }
        }
        if (s == slices - 1) {
          // The block's sums are complete: fold them, segment by segment
          // where the block reaches the table tile's end.
          const int bend = min(lim, b0 + span);
          if (col0 + bend < w.end) {
#pragma unroll
            for (int j = 0; j < kGroups; ++j) {
              const int c = cb + step * j;
              nns::fold4(acc[j], best_d, best_i, (int)(col0 + c), lim - c);
            }
            continue;
          }
          for (int s0 = b0; s0 < bend;) {
            const int s1 = (int)min((long long)bend, w.end - col0);
#pragma unroll
            for (int j = 0; j < kGroups; ++j) {
              const int c = cb + step * j;
              fold_window(acc[j], best_d, best_i, (int)(col0 + c), s0 - c, s1 - c);
            }
            s0 = s1;
            if (col0 + s1 == w.end) end_tile(best_d, best_i, rows, tpr, a, tile_n, range.hi, w);
          }
        }
      }
      ring.release(pos);
    }
  }
}

template <int kK, bool kRunK = false>
Kernel templated(int q_rows) {
  if (q_rows == 4) return two_level_kernel<kK, 4, kRunK>;
  if (q_rows == 1) return two_level_kernel<kK, 1, kRunK>;
  return nullptr;
}

// The instance for the plan, or none: k = 3 and 16, and any other k up to
// kRunKMax at run time, with all k dims per stage and 4 or 1 rows per
// thread (several rows share each column's loads, as the template k's
// do); any k sliced, one row per thread, 1-16
// dims per stage and, with more than one slice, at most kGroups four-column
// groups per thread of a row and stage. Stage columns a multiple of 4, 2-8
// stages. `setup` checks the threads per row.
Kernel instance(int k, int q_rows, int tpr, int cols, int dims, int stages) {
  if (k < 1 || cols < 4 || cols % 4 || stages < 2 || stages > kMaxStages) return nullptr;
  if (dims == k && k == 3) return templated<3>(q_rows);
  if (dims == k && k == 16) return templated<16>(q_rows);
  if (dims == k && k <= kRunKMax) return templated<kRunKMax, true>(q_rows);
  if (q_rows != 1 || dims < 1 || dims > nns::kRingMaxDims || dims > k) return nullptr;
  if (dims < k && cols > kGroups * 4 * tpr) return nullptr;
  return tpr > 1 ? two_level_sliced_kernel<true> : two_level_sliced_kernel<false>;
}

cudaError_t setup(int k, int q_rows, int tpr, int cols, int dims, int stages, Kernel* kernel,
                  size_t* smem, int* slots) {
  *kernel = instance(k, q_rows, tpr, cols, dims, stages);
  *smem = nns::ring_smem_bytes(stages, (long long)dims * cols);
  if (!nns::ring_tpr_ok(q_rows, tpr, *smem, stages)) *kernel = nullptr;
  return nns::ring_setup((const void*)*kernel, *smem, slots);
}

}  // namespace

// The dynamic shared memory (bytes) and the grid slots (resident blocks per
// SM times SMs) of the plan (k, q_rows, tpr, cols, dims, stages), or the
// error `setup` refuses it with (cudaErrorInvalidValue: no instance, or
// more shared memory than a block gets).
extern "C" int nns_two_level_smem(int k, int q_rows, int tpr, int cols, int dims, int stages,
                                  long long* bytes, int* slots) {
  Kernel kernel;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, cols, dims, stages, &kernel, &smem, slots);
  *bytes = (long long)smem;
  return (int)e;
}

// q: (m, k) row-major; r_dm: (k, ld) dim-major, columns [0, n) scanned;
// part_d/part_i: the (ceil(n / tile_n), m) table, every cell written. The
// plan (q_rows, tpr, cols, dims, stages) is `two_level_plan`'s; the table
// tiles go in at most `splits` ranges of whole tiles. Launches on `stream`
// and does not synchronize. Returns cudaGetLastError(), or setup's refusal
// (cudaErrorInvalidValue also for a grid it cannot make).
extern "C" int nns_two_level(const float* q, const float* r_dm, int m, int k, int n,
                             long long ld, int tile_n, int splits, int q_rows, int tpr, int cols,
                             int dims, int stages, float* part_d, int* part_i, void* stream) {
  Kernel kernel;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, cols, dims, stages, &kernel, &smem, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (ld < n || m < 1 || n < 1 || tile_n < 1 || splits < 1 || splits > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n_tiles = ((long long)n + tile_n - 1) / tile_n;
  const long long per = (n_tiles + splits - 1) / splits;  // table tiles per range
  if (per * tile_n > INT_MAX) return (int)cudaErrorInvalidValue;
  const int cols_per_split = (int)(per * tile_n);
  const nns::RingArgs a{q, r_dm, m, k, n, ld, cols_per_split, cols, dims, stages, tpr,
                        ld % 4 == 0 && cols_per_split % 4 == 0 && nns::aligned16(r_dm),
                        part_d, part_i};
  const int rows = nns::kRingConsumers / tpr * q_rows;
  kernel<<<dim3((m + rows - 1) / rows, (unsigned)((n_tiles + per - 1) / per)), nns::kRingThreads,
           smem, static_cast<cudaStream_t>(stream)>>>(a, tile_n);
  return (int)cudaGetLastError();
}
