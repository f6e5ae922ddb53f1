// v9 phase 1: split-bf16 expansion products on the tensor cores, with the
// six per-row carries of the band certificate, at every kp the engine makes
// (a multiple of 8). kernels/mxu_expansion.py, phase1_plan, states which
// wgmma kernel instance runs; wgmma_setup below states the same rule.
//
// Replaces: nns_tpu/kernels/mxu_expansion.py:126 `_phase1_kernel` (launched by
// `_phase12`): per (query tile, ref tile) one bf16 product of the queries
// `[qh qh qm qh ql qm]` (m, 6 kp) against `[rh; rm; rh; rl; rh; rm]` built
// from the split stack rc = [rh; rm; rl] (3 kp, n_pad), f32 accumulation,
// e = r2h - cross, per-subtile minima, and the carries min1, tid (subtile
// id), m2x (runner-up outside the winning subtile) and the tile-level
// sorted top 3 (t2v, tid2, t3v) across the ref tiles in ascending order.
//
// Bound on the H100: operations. At m = 10,000, n = 10^6, kp = 16 the
// products are 2 m n 6 kp = 1.92 TFLOP of bf16 tensor-core work, 1.94 ms at
// 989 TFLOP/s; the rc stream is 96 MB per sweep, 0.03 ms at 3.35 TB/s if it
// were read once. rc does not fit the 50 MB L2, so every query tile reads
// it again from L2 or device memory.
//
// Grid = (query tiles of kBM = 128 rows, S ranges of whole ref tiles). A
// block walks the chunks of its range in ascending order. After each chunk
// the shared epilogue (chunk_min, end_chunk) forms e = r2h - cross and each
// row's chunk minimum (a shuffle over the 4 lanes that share a row), folds
// subtile minima into the tile's (tmin, lowest subtile, runner-up), and at
// each tile's end updates the six carries with exactly the JAX kernel's
// rules. Padded columns have r2h = +inf, so they never win; nothing is
// masked to 0.
//
// phase1_wgmma_kernel (the query tile resident): two warpgroups own 64
// query rows each, and each chunk is 6 kp / 16 wgmma.mma_async m64nNk16
// per warpgroup, both operands read from shared memory by descriptor: no
// fragment loads, and kp is a template parameter, so the contraction loop
// unrolls. Both operands are K-major in the canonical no-swizzle layout
// (core matrices of 8 rows x 16 bytes; LBO 128 bytes along K, SBO along M
// or N): the query tile (128, 6 kp) is staged once, and chunks of rc_t =
// rc^T (n_pad, 3 kp) go through a ring of kStages buffers, filled by
// cp.async from all 256 threads. Contraction block b reads split [h, m, h,
// l, h, m][b] by the B descriptor's start column, so the six-block partner
// is never stored; kp % 16 == 0 keeps every k16 step inside one block.
// Chunks are N = 128 columns where ts % 128 == 0 (else 64): per product, A
// is read from shared memory half as often, and the barrier, waits and
// copies happen once per 128 columns. The ring has two stages: chunk q + 1
// is copied while chunk q is multiplied, and chunk q's epilogue runs after
// its products (deeper rings and an epilogue overlapped with the next
// chunk's products measured no faster on the H100; PERF.md).
//
// Every kp. Where kp % 16 == 8 each of the six query blocks and the three
// rc splits is staged padded to kp16 = kp + 8 dims with zeros
// (stage_slice): zero columns add exact zeros to the products, so no k16
// step crosses a block, and qc and rc_t keep their global layouts. The
// instances for kp % 16 == 0 (kPad false) stage whole rows. The query tile
// stays resident up to kp16 = 96 (64-column chunks where 128 do not fit).
// Past that, phase1_wgmma_sliced_kernel makes each ring unit (chunk,
// dimension slice): the unit holds the rc slice (BN, 3 ds), ds = 16, 32 or
// 48, the accumulators carry across a chunk's slices, and the epilogue runs
// after the last. Where the (128, 6 kp16) query tile still fits beside two
// such units (kp16 = 112 and 128 on the H100) it stays resident and each
// unit reads its slice of it; otherwise each unit also holds the query
// slice (128, 6 ds), restaged from L2 once per chunk: per chunk 128 x 6 kp
// + BN x 3 kp bf16 for 2 x 128 x BN x 6 kp operations, about 85 operations
// per byte at BN = 128, against 256 with the query tile resident. Every
// slice runs all its k16 steps (the last one's padding is zeros), so the
// wgmma instruction stream has no branch.
//
// Blocks run in no order, so each range writes its six carries to an
// (S, m) scratch and a second kernel merges the ranges of each query in
// ascending order: the lexicographic (min1, subtile) minimum with the
// lower range winning a tie, m2x as the min of both m2x and the loser's
// min1, and a stable merge of the two sorted top-3 lists (the lower range
// first on ties). That is what the sequential scan over all tiles gives.
//
// The tensor cores sum in their own order and may truncate, so the result
// is not bit-equal to the plain version; the engine's delta bounds the
// difference (see kernels/mxu_expansion.py).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kBM = 128;              // query rows per block
constexpr int kWgThreads = 256;       // 2 warpgroups of 64 query rows
constexpr int kStages = 2;            // ring stages of the wgmma kernel

// The wgmma kernel's shared memory: the query tile (kBM, 6 kp) bf16, then
// kStages ring stages of (bn, 3 kp) rc_t rows and bn half-norms.
__host__ __device__ constexpr int wg_stage_bytes(int kp, int bn) {
  return bn * 3 * kp * 2 + bn * 4;
}
__host__ __device__ constexpr size_t wg_smem(int kp, int bn) {
  return (size_t)kBM * 6 * kp * 2 + (size_t)kStages * wg_stage_bytes(kp, bn);
}

// The sliced wgmma kernel's stage: a (kBM, 6 ds) query slice, a (bn, 3 ds)
// rc_t slice and bn half-norms; kStages of them.
__host__ __device__ constexpr int wg_slice_stage_bytes(int ds, int bn) {
  return kBM * 6 * ds * 2 + bn * 3 * ds * 2 + bn * 4;
}
__host__ __device__ constexpr size_t wg_sliced_smem(int ds, int bn) {
  return (size_t)kStages * wg_slice_stage_bytes(ds, bn);
}
// With the query tile resident: the (kBM, 6 kd) tile, kd = ds x slices,
// then kStages stages of a (bn, 3 ds) rc_t slice and bn half-norms.
__host__ __device__ constexpr size_t wg_qres_smem(int kd, int ds, int bn) {
  return (size_t)kBM * 6 * kd * 2 + (size_t)kStages * (bn * 3 * ds * 2 + bn * 4);
}

// The wgmma instances compiled: those whose shared memory fits an H100
// block's opt-in (a smaller card refuses the rest at run time). A resident
// query tile takes kp up to 16 kMaxResidentSteps; past that the
// contraction goes in slices of 16 ds16 dims, ds16 <= kMaxSliceSteps.
constexpr size_t kInstanceSmem = 232448;
constexpr int kMaxResidentSteps = 6;
constexpr int kMaxSliceSteps = 3;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem, or 16 zero bytes when !valid (gmem is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// ---------------------------------------------------------------------------
// The epilogue the wgmma kernels share
// ---------------------------------------------------------------------------

// The carries of one range for R query rows per thread, and the running
// state of the current tile (tmin, its lowest subtile sarg, the minimum
// smin2 over its other subtiles) and subtile (smin).
template <int R>
struct RowState {
  float min1[R], m2x[R], t2v[R], t3v[R];
  float tmin[R], smin2[R], smin[R];
  int tid[R], tid2[R], sarg[R];

  __device__ __forceinline__ void init() {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      min1[r] = m2x[r] = t2v[r] = t3v[r] = CUDART_INF_F;
      tmin[r] = smin2[r] = smin[r] = CUDART_INF_F;
      tid[r] = tid2[r] = sarg[r] = 0;
    }
  }

  // Subtile c done: the lowest subtile achieving the tile minimum, and the
  // minimum over the other subtiles.
  __device__ __forceinline__ void end_subtile(int c) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      if (smin[r] < tmin[r]) {
        smin2[r] = fminf(smin2[r], tmin[r]);
        tmin[r] = smin[r];
        sarg[r] = c;
      } else {
        smin2[r] = fminf(smin2[r], smin[r]);
      }
      smin[r] = CUDART_INF_F;
    }
  }

  // Tile j (of ns subtiles) done: the JAX kernel's carry update, term for
  // term.
  __device__ __forceinline__ void end_tile(int j, int ns) {
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const bool b1 = tmin[r] < min1[r];
      const bool b2 = !b1 && tmin[r] < t2v[r];
      const float n2v = b1 ? min1[r] : (b2 ? tmin[r] : t2v[r]);
      const int nid2 = b1 ? tid[r] / ns : (b2 ? j : tid2[r]);
      const float n3v = (b1 || b2) ? t2v[r] : fminf(t3v[r], tmin[r]);
      m2x[r] = b1 ? fminf(min1[r], smin2[r]) : fminf(m2x[r], tmin[r]);
      if (b1) {
        min1[r] = tmin[r];
        tid[r] = j * ns + sarg[r];
      }
      t2v[r] = n2v;
      tid2[r] = nid2;
      t3v[r] = n3v;
      tmin[r] = smin2[r] = CUDART_INF_F;
      sarg[r] = 0;
    }
  }

  // Row r's carries into range `split` of the (S, m) scratch planes.
  __device__ __forceinline__ void store(int r, int split, int splits, int m, int row,
                                        float* __restrict__ part_f,
                                        int* __restrict__ part_i) const {
    const long long at = (long long)split * m + row;
    const long long plane = (long long)splits * m;
    part_f[at] = min1[r];
    part_f[plane + at] = m2x[r];
    part_f[2 * plane + at] = t2v[r];
    part_f[3 * plane + at] = t3v[r];
    part_i[at] = tid[r];
    part_i[plane + at] = tid2[r];
  }
};

// e = r2h - cross over one 16-row fragment of a chunk: rows g and g + 8,
// columns 8 nt + 2 t + {0, 1}, as wgmma m64nNk16 hands out its accumulator
// fragment per warp and n8 tile. Each row's chunk minimum joins its
// subtile's in st.smin[r0 + h].
template <int NT, int R>
__device__ __forceinline__ void chunk_min(const float (&acc)[NT][4], const float* r2c, int t,
                                          RowState<R>& st, int r0) {
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float v = CUDART_INF_F;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        v = fminf(v, __fsub_rn(r2c[nt * 8 + 2 * t + e], acc[nt][2 * h + e]));
      }
    }
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 1));
    v = fminf(v, __shfl_xor_sync(0xffffffffu, v, 2));
    st.smin[r0 + h] = fminf(st.smin[r0 + h], v);
  }
}

// Where a block's walk over its chunks stands: tile j, subtile c of it, k
// chunks of that subtile done.
struct Walk {
  int j, c, k;
};

// After a chunk's chunk_min: close its subtile and tile where they end
// (cps chunks a subtile, ns subtiles a tile), stepping without dividing.
template <int R>
__device__ __forceinline__ void end_chunk(RowState<R>& st, Walk& w, int cps, int ns) {
  if (++w.k < cps) return;
  w.k = 0;
  st.end_subtile(w.c);
  if (++w.c < ns) return;
  w.c = 0;
  st.end_tile(w.j++, ns);
}

// ---------------------------------------------------------------------------
// phase1_wgmma_kernel: wgmma, kp % 16 == 0, the query tile resident
// ---------------------------------------------------------------------------

// Byte offset of element (row, col) of a K-major (rows, kc) bf16 tile in
// the canonical no-swizzle layout: core matrices of 8 rows x 16 bytes
// stored whole, 128 bytes apart along K (LBO) and 16 kc bytes apart along
// M or N (SBO).
__device__ __forceinline__ int core_offset(int row, int col, int kc) {
  return (row >> 3) * (kc >> 3) * 128 + (col >> 3) * 128 + (row & 7) * 16 + (col & 7) * 2;
}

// Descriptor of such a tile at shared address addr, SBO sbo bytes. Adding
// c to it moves the start c columns along K (c % 8 == 0: 16 c bytes, c in
// 16-byte units).
__device__ __forceinline__ uint64_t smem_desc(unsigned addr, int sbo) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)(128 >> 4) << 16) |
         ((uint64_t)((sbo >> 4) & 0x3FFF) << 32);
}

// Copy rows [0, rows) of a row-major (., kc) bf16 source into that layout
// at dst, zeros from row `valid` on. Warp w takes 8-row groups w, w + 8,
// ...; lane (r8 = lane % 8, s = lane / 8) copies 16-byte segments s, s + 4,
// ... of row r8: each instruction reads 8 rows x 64 contiguous bytes of
// the source and writes 8 distinct bank groups per 8 lanes.
__device__ __forceinline__ void stage_canonical(const uint16_t* __restrict__ src, int rows,
                                                int valid, int kc, unsigned char* dst) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r8 = lane & 7, s0 = lane >> 3;
  const int segs = kc >> 3;
  for (int grp = warp; grp < rows / 8; grp += kWgThreads / nns::kWarp) {
    const int row = grp * 8 + r8;
    const bool ok = row < valid;
    const uint16_t* s = ok ? src + (long long)row * kc : src;
    unsigned char* d = dst + grp * segs * 128 + r8 * 16;
    for (int seg = s0; seg < segs; seg += 4) cp_async16(d + seg * 128, ok ? s + seg * 8 : src, ok);
  }
}

// Copy dims [d0, d0 + dn) of the `blocks` blocks of rows [0, rows) of a
// row-major bf16 source (block b of a row at column b kp_src, rows `pitch`
// elements apart) into a K-major (rows, blocks ds) tile in the canonical
// layout at dst, block b at column b ds: zeros past dn (a block padded to
// whole k16 steps) and from row `valid` on. d0, dn, ds and kp_src are
// multiples of 8. The warps and lanes split the tile as in
// stage_canonical. Callers on the hot path pass ds and blocks as
// constants (stage_slice<kDS, kBlocks>), so the divisions fold.
__device__ __forceinline__ void stage_slice(const uint16_t* __restrict__ src, long long pitch,
                                            int kp_src, int d0, int dn, int ds, int blocks,
                                            int rows, int valid, unsigned char* dst) {
  const int kSegs = ds / 8;             // 16-byte segments of a block
  const int kRowSegs = blocks * kSegs;  // of a staged row
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int r8 = lane & 7, s0 = lane >> 3;
  for (int grp = warp; grp < rows / 8; grp += kWgThreads / nns::kWarp) {
    const int row = grp * 8 + r8;
    const bool ok = row < valid;
    const uint16_t* s = ok ? src + (long long)row * pitch + d0 : src;
    unsigned char* d = dst + grp * kRowSegs * 128 + r8 * 16;
    for (int seg = s0; seg < kRowSegs; seg += 4) {
      const int b = seg / kSegs, w = seg - b * kSegs;
      const bool real = ok && 8 * w < dn;
      cp_async16(d + seg * 128, real ? s + b * kp_src + 8 * w : src, real);
    }
  }
}

template <int kDS, int kBlocks>
__device__ __forceinline__ void stage_slice(const uint16_t* __restrict__ src, long long pitch,
                                            int kp_src, int d0, int dn, int rows, int valid,
                                            unsigned char* dst) {
  stage_slice(src, pitch, kp_src, d0, dn, kDS, kBlocks, rows, valid, dst);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin the accumulators in place across wgmma issue and wait: the compiler
// may not move their reads or writes past this point.
template <int NT>
__device__ __forceinline__ void fence_acc(float (&d)[NT][4]) {
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) asm volatile("" : "+f"(d[i][e])::"memory");
}

// d (+)= A B^T for the warpgroup's 64 rows x 8 NT columns x 16, A and B
// K-major in shared memory by descriptor; scale-d = accumulate (0: d = AB).
__device__ __forceinline__ void wgmma_ss(float (&d)[8][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

__device__ __forceinline__ void wgmma_ss(float (&d)[16][4], uint64_t da, uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0][0]), "+f"(d[0][1]), "+f"(d[0][2]), "+f"(d[0][3]),
        "+f"(d[1][0]), "+f"(d[1][1]), "+f"(d[1][2]), "+f"(d[1][3]),
        "+f"(d[2][0]), "+f"(d[2][1]), "+f"(d[2][2]), "+f"(d[2][3]),
        "+f"(d[3][0]), "+f"(d[3][1]), "+f"(d[3][2]), "+f"(d[3][3]),
        "+f"(d[4][0]), "+f"(d[4][1]), "+f"(d[4][2]), "+f"(d[4][3]),
        "+f"(d[5][0]), "+f"(d[5][1]), "+f"(d[5][2]), "+f"(d[5][3]),
        "+f"(d[6][0]), "+f"(d[6][1]), "+f"(d[6][2]), "+f"(d[6][3]),
        "+f"(d[7][0]), "+f"(d[7][1]), "+f"(d[7][2]), "+f"(d[7][3]),
        "+f"(d[8][0]), "+f"(d[8][1]), "+f"(d[8][2]), "+f"(d[8][3]),
        "+f"(d[9][0]), "+f"(d[9][1]), "+f"(d[9][2]), "+f"(d[9][3]),
        "+f"(d[10][0]), "+f"(d[10][1]), "+f"(d[10][2]), "+f"(d[10][3]),
        "+f"(d[11][0]), "+f"(d[11][1]), "+f"(d[11][2]), "+f"(d[11][3]),
        "+f"(d[12][0]), "+f"(d[12][1]), "+f"(d[12][2]), "+f"(d[12][3]),
        "+f"(d[13][0]), "+f"(d[13][1]), "+f"(d[13][2]), "+f"(d[13][3]),
        "+f"(d[14][0]), "+f"(d[14][1]), "+f"(d[14][2]), "+f"(d[14][3]),
        "+f"(d[15][0]), "+f"(d[15][1]), "+f"(d[15][2]), "+f"(d[15][3])
      : "l"(da), "l"(db), "r"(accumulate));
}

// Shared memory: the query tile (kBM, 6 kp16), then kStages ring stages,
// each [(BN, 3 kp16) rows of rc_t][BN half-norms]; both tiles in the
// canonical layout. KP16 = kp16 / 16, the k16 steps of a contraction
// block; BN ref columns a chunk. kPad: kp = kp16 - 8 (kp % 16 == 8), each
// block staged padded with 8 zero dims, which add exact zeros to the
// products; else kp = kp16. The run-time kp and nsl are the sliced
// kernel's (one launch signature for both): here kp is the template's and
// nsl 1.
template <int KP16, int BN, bool kPad>
__global__ void __launch_bounds__(kWgThreads, 2)
phase1_wgmma_kernel(const uint16_t* __restrict__ qc, const uint16_t* __restrict__ rc_t,
                    const float* __restrict__ r2h, int m, int, int, long long n_pad,
                    int tile_n, int ts, int tiles_per_split, int splits,
                    float* __restrict__ part_f, int* __restrict__ part_i) {
  constexpr int kp16 = 16 * KP16, kp = kPad ? kp16 - 8 : kp16;
  constexpr int kc_a = 6 * kp16, kc_b = 3 * kp16;
  constexpr int stage_bytes = wg_stage_bytes(kp16, BN);
  constexpr int NT = BN / 8;                       // n8 tiles of a chunk
  extern __shared__ __align__(128) unsigned char wsmem[];
  unsigned char* ring = wsmem + kBM * kc_a * 2;
  const int q0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int wg = threadIdx.x >> 7;                 // warpgroup: rows 64 wg ..
  const int warp = (threadIdx.x >> 5) & 3;         // warp in it: 16 rows
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int n_tiles = (int)(n_pad / tile_n);
  const int j0 = split * tiles_per_split;
  const int j1 = min(n_tiles, j0 + tiles_per_split);
  const int nq = max(0, (j1 - j0) * (tile_n / BN));
  const long long col_base = (long long)j0 * tile_n;

  // Chunk q into its ring stage, as one commit group (empty past nq, so
  // that the group count stays one per chunk).
  auto stage_chunk = [&](int q) {
    if (q < nq) {
      unsigned char* dst = ring + (q % kStages) * stage_bytes;
      const long long col0 = col_base + (long long)q * BN;
      if constexpr (kPad) {
        stage_slice<kp16, 3>(rc_t + col0 * 3 * kp, 3 * kp, kp, 0, kp, BN, BN, dst);
      } else {
        stage_canonical(rc_t + col0 * kc_b, BN, BN, kc_b, dst);
      }
      if (threadIdx.x < BN / 4)
        cp_async16(dst + BN * kc_b * 2 + threadIdx.x * 16, r2h + col0 + threadIdx.x * 4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if constexpr (kPad) {  // lands with chunk 0
    stage_slice<kp16, 6>(qc + (long long)q0 * 6 * kp, 6 * kp, kp, 0, kp, kBM, m - q0, wsmem);
  } else {
    stage_canonical(qc + (long long)q0 * kc_a, kBM, m - q0, kc_a, wsmem);
  }
  stage_chunk(0);

  const uint64_t da0 = smem_desc(smem_addr(wsmem) + wg * 64 * kc_a * 2, 16 * kc_a);
  const unsigned ring_addr = smem_addr(ring);
  RowState<2> st;  // rows 64 wg + 16 warp + 8 h + g, index h
  st.init();
  Walk walk{j0, 0, 0};
  const int cps = ts / BN, ns = tile_n / ts;
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  for (int q = 0; q < nq; ++q) {
    // Chunk q has landed. Each thread's copies become visible to wgmma's
    // async proxy, and the barrier makes them everyone's; no warp still
    // reads the stage that chunk q + 1 refills.
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    stage_chunk(q + 1);
    // Contraction block b, k16 step kk reads columns b kp16 + kk of the
    // query tile and split(b) kp16 + kk of the chunk.
    const int stage = (q % kStages) * stage_bytes;
    const uint64_t db0 = smem_desc(ring_addr + stage, 16 * kc_b);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < 6; ++b) {
#pragma unroll
      for (int kk = 0; kk < kp16; kk += 16) {
        wgmma_ss(acc, da0 + (b * kp16 + kk), db0 + ((b == 3 ? 2 : (b & 1)) * kp16 + kk),
                 b > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    chunk_min(acc, reinterpret_cast<const float*>(ring + stage + BN * kc_b * 2), t, st, 0);
    end_chunk(st, walk, cps, ns);
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (t != 0) return;  // the 4 lanes of a row group hold the same state
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wg * 64 + warp * 16 + h * 8 + g;
    if (row < m) st.store(h, split, splits, m, row, part_f, part_i);
  }
}

// ---------------------------------------------------------------------------
// phase1_wgmma_sliced_kernel: wgmma, kp past a resident query tile
// ---------------------------------------------------------------------------

// Each ring unit is (chunk, dimension slice): slice s holds dims [s ds, s ds
// + ds) of the three rc splits and (unless kQRes) of the six query blocks,
// padded with zeros past kp, and the accumulators carry across a chunk's
// nsl slices; the epilogue runs after the last. kQRes: the query tile stays
// resident, (kBM, 6 nsl ds) with each block padded to nsl ds dims, and a
// unit holds the rc slice alone, where that fits (kp16 = 112 or 128 on the
// H100); else the unit restages its query slice from L2. Shared memory:
// [the resident query tile (kQRes)] then kStages stages, each [(kBM, 6 ds)
// query slice (not kQRes)][(BN, 3 ds) rc_t slice][BN half-norms, staged
// with a chunk's last slice], all canonical. DS16 = ds / 16.
template <int DS16, int BN, bool kQRes>
__global__ void __launch_bounds__(kWgThreads, 1)
phase1_wgmma_sliced_kernel(const uint16_t* __restrict__ qc, const uint16_t* __restrict__ rc_t,
                           const float* __restrict__ r2h, int m, int kp, int nsl,
                           long long n_pad, int tile_n, int ts, int tiles_per_split, int splits,
                           float* __restrict__ part_f, int* __restrict__ part_i) {
  constexpr int ds = 16 * DS16, kc_b = 3 * ds;
  constexpr int a_bytes = kQRes ? 0 : kBM * 6 * ds * 2;  // a stage's query slice
  constexpr int b_bytes = BN * kc_b * 2;
  constexpr int stage_bytes = a_bytes + b_bytes + BN * 4;
  constexpr int NT = BN / 8;
  extern __shared__ __align__(128) unsigned char wsmem[];
  const int kd = kQRes ? nsl * ds : ds;  // dims per block of the query tile read
  const int kc_a = 6 * kd;
  unsigned char* ring = wsmem + (kQRes ? kBM * kc_a * 2 : 0);
  const int q0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int wg = threadIdx.x >> 7;
  const int warp = (threadIdx.x >> 5) & 3;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;

  const int n_tiles = (int)(n_pad / tile_n);
  const int j0 = split * tiles_per_split;
  const int j1 = min(n_tiles, j0 + tiles_per_split);
  const int nu = max(0, (j1 - j0) * (tile_n / BN)) * nsl;  // units, chunk-major
  const long long col_base = (long long)j0 * tile_n;
  const uint16_t* q_src = qc + (long long)q0 * 6 * kp;

  // Unit u into its ring stage, as one commit group (empty past nu).
  auto stage_unit = [&](int u) {
    if (u < nu) {
      const int q = u / nsl, s = u - q * nsl;
      unsigned char* dst = ring + (u % kStages) * stage_bytes;
      const long long col0 = col_base + (long long)q * BN;
      const int d0 = s * ds, dn = min(ds, kp - d0);
      if (!kQRes) stage_slice<ds, 6>(q_src, 6 * kp, kp, d0, dn, kBM, m - q0, dst);
      stage_slice<ds, 3>(rc_t + col0 * 3 * kp, 3 * kp, kp, d0, dn, BN, BN, dst + a_bytes);
      if (s == nsl - 1 && threadIdx.x < BN / 4)
        cp_async16(dst + a_bytes + b_bytes + threadIdx.x * 16, r2h + col0 + threadIdx.x * 4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (kQRes) stage_slice(q_src, 6 * kp, kp, 0, kp, kd, 6, kBM, m - q0, wsmem);  // with unit 0
  stage_unit(0);

  const unsigned ring_addr = smem_addr(ring);
  const uint64_t dq = smem_desc(smem_addr(wsmem) + wg * 64 * kc_a * 2, 16 * kc_a);
  RowState<2> st;  // rows 64 wg + 16 warp + 8 h + g, index h
  st.init();
  Walk walk{j0, 0, 0};
  const int cps = ts / BN, ns = tile_n / ts;
  float acc[NT][4];
#pragma unroll
  for (int i = 0; i < NT; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[i][e] = 0.0f;
  int s = 0;  // unit u's slice, stepped without dividing
  for (int u = 0; u < nu; ++u) {
    // As in phase1_wgmma_kernel: unit u has landed and is visible to the
    // async proxy, and no warp still reads the stage unit u + 1 refills.
    cp_async_wait<0>();
    asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
    __syncthreads();
    stage_unit(u + 1);
    const int stage = (u % kStages) * stage_bytes;
    // The query operand: slice s of the resident tile, or the stage's.
    const uint64_t da0 = kQRes ? dq + s * ds
                               : smem_desc(ring_addr + stage + wg * 64 * kc_a * 2, 16 * kc_a);
    const uint64_t db0 = smem_desc(ring_addr + stage + a_bytes, 16 * kc_b);
    // Every slice runs all DS16 steps: a last slice with fewer real dims
    // reads zeros past them (a conditional step made the compiler serialize
    // the wgmma instructions).
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < 6; ++b) {
#pragma unroll
      for (int kk = 0; kk < DS16; ++kk) {
        wgmma_ss(acc, da0 + (b * kd + 16 * kk), db0 + ((b == 3 ? 2 : (b & 1)) * ds + 16 * kk),
                 s > 0 || b > 0 || kk > 0);
      }
    }
    wgmma_commit();
    wgmma_wait<0>();
    fence_acc(acc);
    if (++s < nsl) continue;  // the chunk's cross terms are not complete
    s = 0;
    chunk_min(acc, reinterpret_cast<const float*>(ring + stage + a_bytes + b_bytes), t, st, 0);
    end_chunk(st, walk, cps, ns);
  }
  cp_async_wait<0>();  // no copy outlives the block

  if (t != 0) return;  // the 4 lanes of a row group hold the same state
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = q0 + wg * 64 + warp * 16 + h * 8 + g;
    if (row < m) st.store(h, split, splits, m, row, part_f, part_i);
  }
}

// ---------------------------------------------------------------------------
// The merge, and the host side
// ---------------------------------------------------------------------------

// One thread per query: fold its S range states in ascending order.
__global__ void phase1_merge_kernel(const float* __restrict__ part_f,
                                    const int* __restrict__ part_i, int m, int splits,
                                    int ns, float* __restrict__ out_f,
                                    int* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  const long long plane = (long long)splits * m;
  float min1 = part_f[row], m2x = part_f[plane + row];
  float t2v = part_f[2 * plane + row], t3v = part_f[3 * plane + row];
  int tid = part_i[row], tid2 = part_i[plane + row];
  for (int s = 1; s < splits; ++s) {
    const long long at = (long long)s * m + row;
    const float r1 = part_f[at], rm2 = part_f[plane + at];
    const float r2 = part_f[2 * plane + at], r3 = part_f[3 * plane + at];
    const int rt = part_i[at], rt2 = part_i[plane + at];
    // Stable merge of the sorted tile top-3 lists, the lower range first on
    // ties (only the third entry's value is kept).
    const float lv[3] = {min1, t2v, t3v}, rv[3] = {r1, r2, r3};
    const int li[2] = {tid / ns, tid2}, ri[2] = {rt / ns, rt2};
    float ov[3];
    int oi[2] = {0, 0};
    int a = 0, b = 0;
#pragma unroll
    for (int p = 0; p < 3; ++p) {
      if (lv[a] <= rv[b]) {
        ov[p] = lv[a];
        if (p < 2) oi[p] = li[a];
        ++a;
      } else {
        ov[p] = rv[b];
        if (p < 2) oi[p] = ri[b];
        ++b;
      }
    }
    if (r1 < min1) {  // strict: the lower range keeps an exact tie
      m2x = fminf(rm2, min1);
      min1 = r1;
      tid = rt;
    } else {
      m2x = fminf(m2x, r1);
    }
    t2v = ov[1];
    tid2 = oi[1];
    t3v = ov[2];
  }
  out_f[row] = min1;
  out_f[m + row] = m2x;
  out_f[2 * m + row] = t2v;
  out_f[3 * m + row] = t3v;
  out_i[row] = tid;
  out_i[m + row] = tid2;
}

cudaError_t smem_optin(int* bytes) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  return cudaDeviceGetAttribute(bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

// The wgmma plan for kp and ts: the kernel instance, its shared memory and
// the slices of the contraction (1: the query tile resident), requested
// from the card; or cudaErrorInvalidValue where there is none (kp % 8 !=
// 0, ts % 64 != 0, or nothing fits the card's opt-in shared memory). The
// rule, tried in order: chunks of bn = 128 columns where ts % 128 == 0,
// then 64; the query tile resident (kp16 = kp rounded up to 16, at most
// 16 kMaxResidentSteps) for the first bn whose tile and ring fit; else the
// query tile resident (padded to nsl ds dims a block) with the rc splits in
// slices of ds = 16 ds16 dims, ds16 the largest (at most kMaxSliceSteps)
// that fits, for the first bn that has one; else query and rc slices
// together, the widest whose ring fits, for the first bn that has one.
// mxu_expansion.phase1_plan
// states the same rule on the host (a GPU test holds the two together).
using WgmmaKernel = void (*)(const uint16_t*, const uint16_t*, const float*, int, int, int,
                             long long, int, int, int, int, float*, int*);

struct WgmmaPlan {
  WgmmaKernel kernel;
  size_t smem;
  int nsl;
};

template <int KP16, int BN, bool kPad>
WgmmaKernel resident_kernel() {
  if constexpr (wg_smem(16 * KP16, BN) <= kInstanceSmem) {
    return phase1_wgmma_kernel<KP16, BN, kPad>;
  } else {
    return nullptr;
  }
}

template <int BN, bool kPad>
WgmmaKernel resident_instance(int steps) {
  static_assert(kMaxResidentSteps == 6, "one case per resident step count");
  switch (steps) {
    case 1: return resident_kernel<1, BN, kPad>();
    case 2: return resident_kernel<2, BN, kPad>();
    case 3: return resident_kernel<3, BN, kPad>();
    case 4: return resident_kernel<4, BN, kPad>();
    case 5: return resident_kernel<5, BN, kPad>();
    case 6: return resident_kernel<6, BN, kPad>();
    default: return nullptr;
  }
}

template <int BN, bool kQRes>
WgmmaKernel sliced_instance(int ds16) {
  static_assert(kMaxSliceSteps == 3, "one case per slice width");
  switch (ds16) {
    case 1: return phase1_wgmma_sliced_kernel<1, BN, kQRes>;
    case 2: return phase1_wgmma_sliced_kernel<2, BN, kQRes>;
    case 3: return phase1_wgmma_sliced_kernel<3, BN, kQRes>;
    default: return nullptr;
  }
}

cudaError_t wgmma_setup(int kp, int ts, WgmmaPlan* plan) {
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return e;
  *plan = {nullptr, 0, 0};
  if (kp < 8 || kp % 8 || ts < 64 || ts % 64) return cudaErrorInvalidValue;
  const size_t cap = optin < (int)kInstanceSmem ? (size_t)optin : kInstanceSmem;
  const int steps = (kp + 15) / 16;
  const bool pad = kp % 16 != 0;
  const int bns[2] = {ts % 128 == 0 ? 128 : 64, 64};
  for (int bn : bns) {
    if (plan->kernel || steps > kMaxResidentSteps || wg_smem(16 * steps, bn) > cap) continue;
    const WgmmaKernel kernel =
        bn == 128 ? (pad ? resident_instance<128, true>(steps) : resident_instance<128, false>(steps))
                  : (pad ? resident_instance<64, true>(steps) : resident_instance<64, false>(steps));
    *plan = {kernel, wg_smem(16 * steps, bn), 1};
  }
  for (int bn : bns) {  // the query tile resident, the rc splits in slices
    for (int ds16 = kMaxSliceSteps; ds16 >= 1 && plan->kernel == nullptr; --ds16) {
      const int nsl = (steps + ds16 - 1) / ds16;
      const size_t smem = wg_qres_smem(16 * ds16 * nsl, 16 * ds16, bn);
      if (smem <= cap) {
        *plan = {bn == 128 ? sliced_instance<128, true>(ds16) : sliced_instance<64, true>(ds16),
                 smem, nsl};
      }
    }
  }
  for (int bn : bns) {  // both in slices
    for (int ds16 = kMaxSliceSteps; ds16 >= 1 && plan->kernel == nullptr; --ds16) {
      if (wg_sliced_smem(16 * ds16, bn) <= cap) {
        *plan = {bn == 128 ? sliced_instance<128, false>(ds16) : sliced_instance<64, false>(ds16),
                 wg_sliced_smem(16 * ds16, bn), (steps + ds16 - 1) / ds16};
      }
    }
  }
  if (plan->kernel == nullptr) return cudaErrorInvalidValue;
  return nns::allow_smem(plan->kernel, plan->smem);
}

cudaError_t launch_merge(const float* part_f, const int* part_i, int m, int splits, int ns,
                         float* out_f, int* out_i, cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  phase1_merge_kernel<<<(m + 255) / 256, 256, 0, st>>>(part_f, part_i, m, splits, ns, out_f,
                                                       out_i);
  return cudaGetLastError();
}

}  // namespace

// The card's opt-in shared memory per block, in bytes, into *bytes.
extern "C" int nns_smem_optin(int* bytes) { return (int)smem_optin(bytes); }

// Blocks of the wgmma kernel `wgmma_setup` plans for kp and ts that fit on
// one SM (registers and shared memory), into *blocks. Returns a CUDA error
// code (cudaErrorInvalidValue where there is no plan).
extern "C" int nns_expansion_phase1_wgmma_blocks_per_sm(int kp, int ts, int* blocks) {
  WgmmaPlan plan;
  cudaError_t e = wgmma_setup(kp, ts, &plan);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, plan.kernel, kWgThreads,
                                                            plan.smem);
}

// Phase 1 on the wgmma kernel `wgmma_setup` plans for kp and ts (the query
// tile resident, or the contraction in slices). qc: (m, 6 kp) bf16
// row-major; rc_t: (n_pad, 3 kp) bf16 row-major (rc transposed); r2h:
// (n_pad,) f32; all three on 16-byte aligned bases, kp % 8 == 0. Ranges of
// tiles_per_split tiles of tile_n columns, split into ts-column subtiles
// (ts % 64 == 0). part_f (4, splits, m) and part_i (2, splits, m) are
// scratch; out_f (4, m) = [min1, m2x, t2v, t3v] and out_i (2, m) =
// [tid, tid2]. Launches on `stream` and does not synchronize. Returns
// cudaGetLastError(), or cudaErrorInvalidValue where there is no plan
// (then it launches nothing).
extern "C" int nns_expansion_phase1_wgmma(const uint16_t* qc, const uint16_t* rc_t,
                                          const float* r2h, int m, int kp, long long n_pad,
                                          int tile_n, int ts, int tiles_per_split, int splits,
                                          float* part_f, int* part_i, float* out_f, int* out_i,
                                          void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  WgmmaPlan plan;
  cudaError_t e = wgmma_setup(kp, ts, &plan);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + kBM - 1) / kBM, splits);
  plan.kernel<<<grid, kWgThreads, plan.smem, st>>>(qc, rc_t, r2h, m, kp, plan.nsl, n_pad,
                                                    tile_n, ts, tiles_per_split, splits, part_f,
                                                    part_i);
  return (int)launch_merge(part_f, part_i, m, splits, tile_n / ts, out_f, out_i, st);
}
