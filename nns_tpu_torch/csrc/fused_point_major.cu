// v3 fused distance + argmin over POINT-MAJOR reference points.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_fused_pm_kernel` (launched by
// `_fused_pm_call`): dim-major queries (k, TM) against point-major ref tiles
// (TN, k), a transposed (TN, TM) distance tile reduced per query, strict-<
// carry over ref tiles.
//
// Bound on the H100: operations, as v4 (per pair k sub, k mul, k add and a
// compare, each rounded on its own: about 35-45% of the f32 peak at most).
// The rung's point is that the refs stay in the caller's (n, k) layout: no
// transpose pass, no padding, nothing read past row n. On Hopper the copy
// engine takes most of that layout's cost away: a stage of T points is one
// contiguous span of T * k floats, so it arrives as a single bulk copy.
//
// Design (the grid, registers and ring of fused_streaming.cu, common.cuh):
// - Grid = (query tiles of 256 x q_rows rows) x (S ranges of whole stages
//   of points); an (S, m) table of winners and one merge kernel.
// - Query rows in registers; each consumer thread visits every point of the
//   block's range in ascending order and keeps its rows' winners with a
//   strict <. Every thread of a warp reads the same point's contiguous
//   coordinates (a broadcast): at k = 3 and 16 (template parameters) as
//   16-byte loads, 3 loads for 4 points at k = 3. Threads owning points
//   and reading them at stride k would meet bank conflicts at every even k
//   (16-way at k = 16).
// - Every other k runs a sliced instance: 4 rows per thread and 8-dim query
//   chunks at k <= 8 (1 row for a small m), else 1 row and 16-dim chunks, a
//   stage of T whole points (T from 256 down to 1 as k grows, so k up to
//   about 29000 fits), groups of points scored chunk by chunk, each chunk's
//   query slice in the thread's registers.
// - Below one tile of rows (m < 256), tpr threads share each row and split
//   the points, as in fused_streaming.cu.
// - One producer warp feeds the ring: for a stage of points [p0, p0 + cnt)
//   it copies the floats [a, (p0 + cnt) * k) with a = p0 * k rounded down to
//   a multiple of 4, so the bulk copy starts 16-byte aligned (the stage keeps
//   the offset p0 * k - a). THE TRAP: the allocation ends at n * k floats, and
//   n * k need not be a multiple of 4. A bulk copy moves 16-byte multiples,
//   so rounding the last stage's size up would read past the refs. The bulk
//   copy moves the span rounded DOWN to 16 bytes and lane 0 loads the last
//   0-3 floats itself, before it arms the stage. A misaligned base (a sliced
//   view) takes the plain-load path: all producer lanes load the stage.
//
// The plan (q_rows, points per stage, stages) has one home, `ring_plan` in
// nns_tpu_torch/kernels/fused_ladder.py; this file refuses a plan it has no
// instance for (`nns_fused_point_major_smem`).
#include "common.cuh"

namespace {

constexpr int kMaxStages = 8;

// A stage of `cols` points: its floats, with room for the 0-3 floats of
// alignment in front.
__host__ __device__ inline long long stage_floats(int cols, int k) {
  return ((long long)cols * k + 3 + 3) / 4 * 4;
}

// Point p0's first coordinate sits this many floats past a 16-byte boundary
// of the refs (0 for a template instance's stages).
__device__ __forceinline__ int stage_offset(const nns::RingArgs& a, long long p0) {
  return (int)((p0 * a.k) % 4);
}

__device__ __forceinline__ void produce_points(const nns::StageRing& ring, const nns::RingArgs& a,
                                               const nns::RingRange& range) {
  ring.produce(range.n_tiles, [&](long long it, float* st, unsigned long long* full, int lane) {
    long long p0;
    const int cnt = range.tile(a, (int)it, p0);
    const int offset = stage_offset(a, p0);
    const float* src = a.r + (p0 * a.k - offset);  // 16-byte aligned on the bulk path
    const int span = offset + cnt * a.k;              // floats up to the stage's last point
    if (a.bulk) {
      const int whole = span / 4 * 4;  // never rounded up: see THE TRAP above
      nns::fence_proxy_async();
      if (lane == 0) {
        for (int i = whole; i < span; ++i) st[i] = src[i];
        nns::mbar_expect_tx(full, 4u * whole);
        if (whole) nns::bulk_copy(st, src, 4u * whole, full);
      }
    } else {
      for (int i = offset + lane; i < span; i += nns::kWarp) st[i] = src[i];
      nns::mbar_arrive(full);
    }
  });
}

// k = kK, kQ rows per consumer thread; stages of whole groups of 4 points
// (cols % 4 == 0, so every stage starts 16-byte aligned, offset 0).
template <int kK, int kQ>
__global__ void __launch_bounds__(nns::kRingThreads, 2)
point_major_kernel(const nns::RingArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const nns::StageRing ring(smem, a.stages, stage_floats(a.cols, kK));
  const nns::RingRange range(a);
  ring.start(a.bulk);
  if (threadIdx.x >= nns::kRingConsumers) {
    produce_points(ring, a, range);
    return;
  }
  const int tpr = kQ == 1 ? a.tpr : 1;
  const nns::RingRows rows(kQ, tpr);
  float qr[kQ][kK];
  nns::load_rows(a.q, rows, a.m, qr);
  float best_d[kQ];
  int best_i[kQ];
  nns::init_best(best_d, best_i, (int)range.lo);
  nns::RingPos pos;
  for (int t = 0; t < range.n_tiles; ++t, pos.next(a.stages)) {
    long long p0;
    const int cnt = range.tile(a, t, p0);
    const float* st = ring.acquire(pos);
    for (int c = 4 * rows.part; c < cnt; c += 4 * tpr) {
      float acc[kQ][4];
      nns::score4<kK, kQ, true>(st + c * kK, 0, qr, acc);
      nns::fold4(acc, best_d, best_i, (int)(p0 + c), cnt - c);
    }
    ring.release(pos);
  }
  if (tpr > 1) nns::fold_parts(best_d[0], best_i[0], rows, tpr, ring.stage(0));
  nns::write_rows(best_d, best_i, rows, a.m, a.part_d, a.part_i);
}

// The row's dimensions d0 .. d0 + kChunk - 1 (zero past k) into registers.
template <int kChunk>
__device__ __forceinline__ void load_chunk(const float* __restrict__ q_row, int d0, int k,
                                           float (&qr)[kChunk]) {
#pragma unroll
  for (int d = 0; d < kChunk; ++d) qr[d] = d0 + d < k ? q_row[d0 + d] : 0.0f;
}

// Any k at run time, kQ rows per consumer thread: groups of kGroup points
// of the stage, each scored over chunks of kChunk dims whose query slice
// waits in registers (loaded once when k <= kChunk). A point's coordinates
// are read one at a time (a broadcast), each feeding kQ rows. Instances:
// <4, 8, 4> (the plan's choice at k <= 8) and <1, 16, 16>.
template <int kQ, int kChunk, int kGroup>
__global__ void __launch_bounds__(nns::kRingThreads, 2)
point_major_sliced_kernel(const nns::RingArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const nns::StageRing ring(smem, a.stages, stage_floats(a.cols, a.k));
  const nns::RingRange range(a);
  ring.start(a.bulk);
  if (threadIdx.x >= nns::kRingConsumers) {
    produce_points(ring, a, range);
    return;
  }
  const int tpr = kQ == 1 ? a.tpr : 1;
  const nns::RingRows rows(kQ, tpr);
  const float* q_row[kQ];
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) q_row[qi] = a.q + (long long)min(rows.row(qi), a.m - 1) * a.k;
  const int chunks = (a.k + kChunk - 1) / kChunk;
  float qr[kQ][kChunk];
  if (chunks == 1) {
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) load_chunk(q_row[qi], 0, a.k, qr[qi]);
  }
  float best_d[kQ];
  int best_i[kQ];
  nns::init_best(best_d, best_i, (int)range.lo);
  nns::RingPos pos;
  for (int t = 0; t < range.n_tiles; ++t, pos.next(a.stages)) {
    long long p0;
    const int cnt = range.tile(a, t, p0);
    const float* st = ring.acquire(pos) + stage_offset(a, p0);
    for (int pg = kGroup * rows.part; pg < cnt; pg += kGroup * tpr) {
      float acc[kQ][kGroup];
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
#pragma unroll
        for (int p = 0; p < kGroup; ++p) acc[qi][p] = 0.0f;
      }
      for (int ch = 0; ch < chunks; ++ch) {
        const int d0 = ch * kChunk;
        const int nd = min(kChunk, a.k - d0);
        if (chunks > 1) {
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi) load_chunk(q_row[qi], d0, a.k, qr[qi]);
        }
        const float* g = st + pg * a.k + d0;
#pragma unroll
        for (int d = 0; d < kChunk; ++d) {
          if (d < nd) {
#pragma unroll
            for (int p = 0; p < kGroup; ++p) {
              if (pg + p < cnt) {
                const float v = g[p * a.k + d];
#pragma unroll
                for (int qi = 0; qi < kQ; ++qi) {
                  acc[qi][p] = nns::add_sq_diff(acc[qi][p], qr[qi][d], v);
                }
              }
            }
          }
        }
      }
#pragma unroll
      for (int p = 0; p < kGroup; ++p) {
#pragma unroll
        for (int qi = 0; qi < kQ; ++qi) {
          if (pg + p < cnt && acc[qi][p] < best_d[qi]) {
            best_d[qi] = acc[qi][p];
            best_i[qi] = (int)(p0 + pg + p);
          }
        }
      }
    }
    ring.release(pos);
  }
  if (tpr > 1) nns::fold_parts(best_d[0], best_i[0], rows, tpr, ring.stage(0));
  nns::write_rows(best_d, best_i, rows, a.m, a.part_d, a.part_i);
}

template <int kK>
nns::RingKernel templated(int q_rows, int cols) {
  if (cols % 4) return nullptr;
  if (q_rows == 4) return point_major_kernel<kK, 4>;
  if (q_rows == 1) return point_major_kernel<kK, 1>;
  return nullptr;
}

// The instance for the plan, or none: k = 3 and 16 with 4 or 1 rows per
// thread and a multiple of 4 points per stage; any k sliced, 4 or 1 rows
// per thread, any points per stage. Whole points per stage (dims == k), 2-8
// stages. `setup` checks the threads per row.
nns::RingKernel instance(int k, int q_rows, int cols, int dims, int stages) {
  if (k < 1 || dims != k || cols < 1 || stages < 2 || stages > kMaxStages) return nullptr;
  if (k == 3) return templated<3>(q_rows, cols);
  if (k == 16) return templated<16>(q_rows, cols);
  if (q_rows == 4) return point_major_sliced_kernel<4, 8, 4>;
  if (q_rows == 1) return point_major_sliced_kernel<1, 16, 16>;
  return nullptr;
}

cudaError_t setup(int k, int q_rows, int tpr, int cols, int dims, int stages,
                  nns::RingKernel* kernel, size_t* smem, int* slots) {
  *kernel = instance(k, q_rows, cols, dims, stages);
  *smem = nns::ring_smem_bytes(stages, stage_floats(cols, k));
  if (!nns::ring_tpr_ok(q_rows, tpr, *smem, stages)) *kernel = nullptr;
  return nns::ring_setup((const void*)*kernel, *smem, slots);
}

}  // namespace

// The dynamic shared memory (bytes) and grid slots of the plan (k, q_rows,
// tpr, points per stage, dims per stage (= k), stages), or the error
// `setup` refuses it with.
extern "C" int nns_fused_point_major_smem(int k, int q_rows, int tpr, int cols, int dims,
                                          int stages, long long* bytes, int* slots) {
  nns::RingKernel kernel;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, cols, dims, stages, &kernel, &smem, slots);
  *bytes = (long long)smem;
  return (int)e;
}

// q: (m, k) row-major; r_pm: (n_rows >= n, k) point-major, rows [0, n)
// scanned and nothing past them read; part_d/part_i: (splits, m) scratch;
// out_d/out_i: (m,). The plan is `ring_plan`'s. Launches one scan
// and one merge on `stream` and does not synchronize. Returns
// cudaGetLastError(), or setup's refusal.
extern "C" int nns_fused_point_major(const float* q, const float* r_pm, int m, int k, int n,
                                     int splits, int q_rows, int tpr, int cols, int dims,
                                     int stages, float* part_d, int* part_i, float* out_d,
                                     int* out_i, void* stream) {
  nns::RingKernel kernel;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, cols, dims, stages, &kernel, &smem, nullptr);
  if (e != cudaSuccess) return (int)e;
  // Ranges of whole stages: with cols % 4 == 0 every template stage starts
  // 16-byte aligned.
  const nns::RingArgs a{q, r_pm, m, k, n, k, 0, cols, dims, stages, tpr, nns::aligned16(r_pm),
                        part_d, part_i};
  return (int)nns::ring_launch(kernel, smem, a, q_rows, splits, out_d, out_i,
                               static_cast<cudaStream_t>(stream));
}
