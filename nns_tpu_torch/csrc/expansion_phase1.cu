// v9 phase 1: split-bf16 expansion products on the tensor cores, with the
// six per-row carries of the band certificate. Two kernels compute it; the
// host picks one by shape alone (kernels/mxu_expansion.py, phase1_route).
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
// it again from L2 or device memory (about 6 KB per 128 x 64 chunk).
//
// Both kernels: grid = (query tiles of kBM = 128 rows, S ranges of whole
// ref tiles). A block walks the 64-column chunks of its range in ascending
// order. After each chunk the shared epilogue (chunk_min, end_chunk) forms
// e = r2h - cross and each row's chunk minimum (a shuffle over the 4 lanes
// that share a row), folds subtile minima into the tile's (tmin, lowest
// subtile, runner-up), and at each tile's end updates the six carries with
// exactly the JAX kernel's rules. Padded columns have r2h = +inf, so they
// never win; nothing is masked to 0.
//
// phase1_kernel (any kp % 8 == 0): mma.sync m16n8k16. The contraction is
// cut into dimension slices: slice s holds dims [d0, d0 + dn) of all six
// blocks of qc, (128, 6 dn), and the same dims of the three splits of rc,
// (3 dn, 64) per chunk. When the whole query tile fits beside two rc
// buffers (kp <= 88 on the H100's 227 KB) there is one slice (dn = kp): the
// query tile is staged once and stays. Otherwise slices of 32 dims are
// staged per (chunk, slice) with their query slice, and the accumulators
// carry across the slices of a chunk, so any kp runs. Each unit (chunk,
// slice) is copied into one of two buffers by cp.async while the 4 warps
// compute on the other, one barrier per unit. Each warp runs mma.sync over
// its 32 rows x 64 columns; the A fragments are 32-bit loads from the query
// slice, the B fragments ldmatrix.trans loads whose row addresses pick
// split [h, m, h, l, h, m][b] of the staged rc slice for contraction block
// b (the 6-block partner is never stored).
//
// phase1_wgmma_kernel (kp % 16 == 0, the query tile resident; the host
// takes it where it fits): at kp = 16 a 128 x 64 chunk is only 6 k16 steps
// deep, and phase1_kernel spends it on instruction issue (A and B fragment
// loads, index arithmetic, the epilogue) and a barrier with one copy in
// flight: about 1,500 SM cycles a chunk against about 370 at the tensor
// peak, 24% of the bound. Here two warpgroups own 64 query rows each, and
// each chunk is 6 kp / 16 wgmma.mma_async m64nNk16 per warpgroup, both
// operands read from shared memory by descriptor: no fragment loads, and
// kp is a template parameter, so the contraction loop unrolls. Both
// operands are K-major in the canonical no-swizzle layout (core matrices
// of 8 rows x 16 bytes; LBO 128 bytes along K, SBO along M or N): the
// query tile (128, 6 kp) is staged once, and chunks of rc_t = rc^T
// (n_pad, 3 kp) go through a ring of kStages buffers, filled by cp.async
// from all 256 threads. Contraction block b reads split [h, m, h, l, h,
// m][b] by the B descriptor's start column, so the six-block partner is
// never stored; kp % 16 == 0 keeps every k16 step inside one block. Chunks
// are N = 128 columns where ts % 128 == 0 (else 64): per product, A is read
// from shared memory half as often, and the barrier, waits and copies
// happen once per 128 columns. The ring has two stages: chunk q + 1 is
// copied while chunk q is multiplied, and chunk q's epilogue runs after its
// products (deeper rings and an epilogue overlapped with the next chunk's
// products measured no faster on the H100; PERF.md). Instances exist for
// kp = 16 .. 80; larger kp take phase1_kernel. The accumulator fragment of
// m64nNk16 is, per warp, the C fragment of mma.sync m16n8 per n8 tile, so
// the epilogue is the one phase1_kernel calls.
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
constexpr int kBN = 64;               // ref columns per chunk
constexpr int kBNP = kBN + 8;         // staged row pitch in bf16 (144 bytes)
constexpr int kWarps = 4;             // each warp: 32 rows = 2 m16 tiles
constexpr int kThreads = kWarps * nns::kWarp;
constexpr int kMT = 2;                // m16 tiles per warp
constexpr int kNT = kBN / 8;          // n8 tiles per chunk
constexpr int kRows = 2 * kMT;        // rows each thread keeps state for
constexpr int kSliceDims = 32;        // dims per slice when the tile cannot stay

constexpr int kWgThreads = 256;       // 2 warpgroups of 64 query rows
constexpr int kStages = 2;            // ring stages of the wgmma kernel

// Smallest shared-memory row stride >= words with stride % 8 == 4: the 8
// rows one fragment load touches then fall on distinct banks.
__host__ __device__ constexpr int pad_stride(int words) {
  return words + (12 - words % 8) % 8;
}

// Bytes of one staged query slice of ds dims, (kBM, 6 ds) bf16 padded rows.
__host__ __device__ constexpr int a_bytes(int ds) {
  return kBM * pad_stride(3 * ds) * 4;
}

// Bytes of one staged rc slice of ds dims, (3 ds, kBN) bf16, and its kBN
// half-norms.
__host__ __device__ constexpr int b_bytes(int ds) {
  return 3 * ds * kBNP * 2 + kBN * 4;
}

// The wgmma kernel's shared memory: the query tile (kBM, 6 kp) bf16, then
// kStages ring stages of (bn, 3 kp) rc_t rows and bn half-norms.
__host__ __device__ constexpr int wg_stage_bytes(int kp, int bn) {
  return bn * 3 * kp * 2 + bn * 4;
}
__host__ __device__ constexpr size_t wg_smem(int kp, int bn) {
  return (size_t)kBM * 6 * kp * 2 + (size_t)kStages * wg_stage_bytes(kp, bn);
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem, or 16 zero bytes when !valid (gmem is then not read).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool valid = true) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(valid ? 16 : 0));
}

// B fragments of two n8 tiles: rows are the 16 contraction indices of the
// k16 step (lanes 0-15 address n tile 0, lanes 16-31 n tile 1), each 8
// bf16 columns wide; .trans hands out the "col" layout mma.sync wants.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&b)[4], const uint16_t* row) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(b[0]), "=r"(b[1]), "=r"(b[2]), "=r"(b[3])
               : "r"(smem_addr(row)));
}

__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// The epilogue both kernels share
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
// columns 8 nt + 2 t + {0, 1}, as mma.sync m16n8 hands out its C fragment
// per n8 tile and wgmma m64nNk16 per warp. Each row's chunk minimum joins
// its subtile's in st.smin[r0 + h].
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
// phase1_kernel: mma.sync, any kp % 8 == 0
// ---------------------------------------------------------------------------

// Copy dims [d0, d0 + dn) of the six blocks of query rows q0.. of qc into a
// (kBM, 6 dn) slice with row stride sA words, zeros past row m, 16 bytes
// per cp.async.
__device__ __forceinline__ void stage_queries(const uint16_t* __restrict__ qc, int m, int kp,
                                              int q0, int d0, int dn, int sA, uint32_t* as) {
  // One (row, block) pair per step (divisions by constants only); its dn
  // dims are contiguous in qc and in the slice.
  for (int i = threadIdx.x; i < kBM * 6; i += kThreads) {
    const int row = i / 6, b = i % 6;
    const bool valid = q0 + row < m;
    const uint16_t* src = valid ? qc + (long long)(q0 + row) * 6 * kp + b * kp + d0 : qc;
    uint16_t* dst = reinterpret_cast<uint16_t*>(as + row * sA) + b * dn;
    for (int seg = 0; seg < dn; seg += 8) cp_async16(dst + seg, valid ? src + seg : qc, valid);
  }
}

// Copy dims [d0, d0 + dn) of the three splits of chunk col0 of rc, as a
// (3 dn, kBN) slice, and the chunk's kBN half-norms, 16 bytes per cp.async.
// This runs once per unit, so it divides by constants only.
__device__ __forceinline__ void stage_refs(const uint16_t* __restrict__ rc,
                                           const float* __restrict__ r2h, long long n_pad,
                                           int kp, int d0, int dn, long long col0,
                                           uint16_t* bs, float* r2s) {
  constexpr int kSegs = kBN / 8;  // 16-byte segments of a staged row
  const int rows = 3 * dn;
  for (int i = threadIdx.x; i < rows * kSegs + kBN / 4; i += kThreads) {
    if (i < rows * kSegs) {
      const int row = i / kSegs, seg = i % kSegs;
      const int split = (row >= dn) + (row >= 2 * dn);
      const long long src_row = (long long)split * kp + d0 + row - split * dn;
      cp_async16(bs + row * kBNP + seg * 8, rc + src_row * n_pad + col0 + seg * 8);
    } else {
      const int seg = i - rows * kSegs;
      cp_async16(r2s + seg * 4, r2h + col0 + seg * 4);
    }
  }
}

// Shared memory: [resident query tile, when nsl == 1] then two unit
// buffers, each [query slice, when nsl > 1][rc slice][kBN half-norms].
__global__ void __launch_bounds__(kThreads)
phase1_kernel(const uint16_t* __restrict__ qc, const uint16_t* __restrict__ rc,
              const float* __restrict__ r2h, int m, int kp, int ds, int nsl,
              long long n_pad, int tile_n, int ts, int tiles_per_split, int splits,
              float* __restrict__ part_f, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int sA = pad_stride(3 * ds);
  const bool resident = nsl == 1;
  uint32_t* a_res = reinterpret_cast<uint32_t*>(smem);
  unsigned char* units = smem + (resident ? a_bytes(ds) : 0);
  const int unit_bytes = (resident ? 0 : a_bytes(ds)) + b_bytes(ds);

  const int q0 = blockIdx.x * kBM;
  const int split = blockIdx.y;
  const int warp = threadIdx.x / nns::kWarp;
  const int lane = threadIdx.x % nns::kWarp;
  const int g = lane >> 2;            // fragment row group
  const int t = lane & 3;             // thread in group

  const int n_tiles = (int)(n_pad / tile_n);
  const int j0 = split * tiles_per_split;
  const int j1 = min(n_tiles, j0 + tiles_per_split);
  const int cpt = tile_n / kBN;       // chunks per tile
  const int cps = ts / kBN;           // chunks per subtile
  const int nq = (j1 - j0) * cpt;
  const int nu = nq * nsl;            // units (chunk, slice), chunk-major
  const long long col_base = (long long)j0 * tile_n;

  auto unit_a = [&](int buf) {
    return resident ? a_res : reinterpret_cast<uint32_t*>(units + buf * unit_bytes);
  };
  auto unit_b = [&](int buf) {
    return reinterpret_cast<uint16_t*>(units + buf * unit_bytes + (resident ? 0 : a_bytes(ds)));
  };
  auto unit_r2 = [&](int buf) { return reinterpret_cast<float*>(unit_b(buf) + 3 * ds * kBNP); };
  // Stage unit (chunk q, slice s) into buffer buf.
  auto stage_unit = [&](int q, int s, int buf) {
    const int d0 = s * ds, dn = min(ds, kp - d0);
    if (!resident) stage_queries(qc, m, kp, q0, d0, dn, sA, unit_a(buf));
    stage_refs(rc, r2h, n_pad, kp, d0, dn, col_base + (long long)q * kBN, unit_b(buf),
               unit_r2(buf));
    asm volatile("cp.async.commit_group;\n" ::);
  };
  if (nu > 0) {
    if (resident) stage_queries(qc, m, kp, q0, 0, kp, sA, a_res);  // lands with unit 0
    stage_unit(0, 0, 0);
  }

  // Per-row state of rows warp*32 + mt*16 + h*8 + g, index mt*2 + h.
  RowState<kRows> st;
  st.init();
  Walk walk{j0, 0, 0};
  const int ns = tile_n / ts;
  float acc[kMT][kNT][4];
  int q_next = 0, s_next = 0;  // unit u + 1, stepped without dividing
  for (int u = 0; u < nu; ++u) {
    const int s = s_next;
    if (s + 1 < nsl) {
      s_next = s + 1;
    } else {
      s_next = 0;
      ++q_next;
    }
    // Unit u has landed for every thread, and every warp is done with the
    // buffer unit u + 1 is about to fill.
    asm volatile("cp.async.wait_group 0;\n" ::);
    __syncthreads();
    if (u + 1 < nu) stage_unit(q_next, s_next, (u + 1) & 1);
    const int dn = min(ds, kp - s * ds);
    const uint32_t* As = unit_a(u & 1);
    const uint16_t* bs = unit_b(u & 1);
    const float* r2c = unit_r2(u & 1);

    if (s == 0) {
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt)
#pragma unroll
        for (int nt = 0; nt < kNT; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.0f;
    }
    // This lane's ldmatrix row holds contraction index k0 + (lane & 15) of
    // the slice: dim kd of block kb (each 8-row group lies in one block, dn
    // being a multiple of 8). Stepping k0 by 16 moves kd past at most two
    // blocks of dn >= 8, so two conditional subtractions keep kd < dn.
    int kb = 0, kd = lane & 15;
    auto wrap = [&] {
      for (int i = 0; i < 2; ++i) {
        if (kd >= dn) {
          kd -= dn;
          ++kb;
        }
      }
    };
    wrap();
    const int ksteps = 6 * dn / 16;
    for (int ks = 0; ks < ksteps; ++ks, kd += 16, wrap()) {
      const int k0 = ks * 16;
      uint32_t a[kMT][4];
#pragma unroll
      for (int mt = 0; mt < kMT; ++mt) {
        const uint32_t* arow = As + (warp * 32 + mt * 16 + g) * sA + k0 / 2 + t;
        a[mt][0] = arow[0];
        a[mt][1] = arow[8 * sA];
        a[mt][2] = arow[4];
        a[mt][3] = arow[8 * sA + 4];
      }
      // Block kb reads split [h, m, h, l, h, m][kb] of the staged slice;
      // lanes 16-31 address the second n tile of each pair.
      const int split = kb == 3 ? 2 : (kb & 1);
      const uint16_t* brow = bs + (split * dn + kd) * kBNP + (lane >> 4) * 8;
#pragma unroll
      for (int nt = 0; nt < kNT; nt += 2) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, brow + nt * 8);
#pragma unroll
        for (int mt = 0; mt < kMT; ++mt) {
          mma_bf16(acc[mt][nt], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][nt + 1], a[mt], b[2], b[3]);
        }
      }
    }
    if (s + 1 < nsl) continue;  // the chunk's cross terms are not complete

#pragma unroll
    for (int mt = 0; mt < kMT; ++mt) chunk_min(acc[mt], r2c, t, st, mt * 2);
    end_chunk(st, walk, cps, ns);
  }

  if (t != 0) return;  // the 4 lanes of a row group hold the same state
#pragma unroll
  for (int mt = 0; mt < kMT; ++mt) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = q0 + warp * 32 + mt * 16 + h * 8 + g;
      if (row < m) st.store(mt * 2 + h, split, splits, m, row, part_f, part_i);
    }
  }
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

// Shared memory: the query tile (kBM, 6 kp), then kStages ring stages, each
// [(BN, 3 kp) rows of rc_t][BN half-norms]; both tiles in the canonical
// layout. KP16 = kp / 16; BN ref columns a chunk.
template <int KP16, int BN>
__global__ void __launch_bounds__(kWgThreads, 2)
phase1_wgmma_kernel(const uint16_t* __restrict__ qc, const uint16_t* __restrict__ rc_t,
                    const float* __restrict__ r2h, int m, long long n_pad, int tile_n, int ts,
                    int tiles_per_split, int splits, float* __restrict__ part_f,
                    int* __restrict__ part_i) {
  constexpr int kp = 16 * KP16, kc_a = 6 * kp, kc_b = 3 * kp;
  constexpr int stage_bytes = wg_stage_bytes(kp, BN);
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
      stage_canonical(rc_t + col0 * kc_b, BN, BN, kc_b, dst);
      if (threadIdx.x < BN / 4)
        cp_async16(dst + BN * kc_b * 2 + threadIdx.x * 16, r2h + col0 + threadIdx.x * 4);
    }
    asm volatile("cp.async.commit_group;\n" ::);
  };
  stage_canonical(qc + (long long)q0 * kc_a, kBM, m - q0, kc_a, wsmem);  // lands with chunk 0
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
    // Contraction block b, k16 step kk reads columns b kp + kk of the query
    // tile and split(b) kp + kk of the chunk.
    const int stage = (q % kStages) * stage_bytes;
    const uint64_t db0 = smem_desc(ring_addr + stage, 16 * kc_b);
    fence_acc(acc);
    wgmma_fence();
#pragma unroll
    for (int b = 0; b < 6; ++b) {
#pragma unroll
      for (int kk = 0; kk < kp; kk += 16) {
        wgmma_ss(acc, da0 + (b * kp + kk), db0 + ((b == 3 ? 2 : (b & 1)) * kp + kk),
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

// Slicing of the contraction for kp: one slice of all kp dims when the
// query tile fits beside two unit buffers in the card's shared memory,
// else slices of kSliceDims dims, each unit staging its query slice too.
struct Plan {
  int ds, nsl;
  size_t smem;
};

cudaError_t plan_for(int kp, Plan* plan) {
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return e;
  const size_t resident = (size_t)a_bytes(kp) + 2 * (size_t)b_bytes(kp);
  if (resident <= (size_t)optin) {
    *plan = {kp, 1, resident};
  } else {
    *plan = {kSliceDims, (kp + kSliceDims - 1) / kSliceDims,
             2 * ((size_t)a_bytes(kSliceDims) + b_bytes(kSliceDims))};
  }
  return nns::allow_smem(phase1_kernel, plan->smem);
}

// phase1_wgmma_kernel's instance for kp and ts, with its chunk width bn
// (128 columns where ts allows, else 64) and shared memory, requested from
// the card; or cudaErrorInvalidValue where the kernel does not take them:
// kp % 16 != 0 or past 80 (the instances), ts % 64 != 0, or the query
// tile and ring past the card's opt-in shared memory. mxu_expansion.phase1_route
// states the same rule on the host (a GPU test holds the two together).
using WgmmaKernel = void (*)(const uint16_t*, const uint16_t*, const float*, int, long long,
                             int, int, int, int, float*, int*);

struct WgmmaPlan {
  WgmmaKernel kernel;
  size_t smem;
};

template <int BN>
WgmmaKernel wgmma_instance(int kp16) {
  switch (kp16) {
    case 1: return phase1_wgmma_kernel<1, BN>;
    case 2: return phase1_wgmma_kernel<2, BN>;
    case 3: return phase1_wgmma_kernel<3, BN>;
    case 4: return phase1_wgmma_kernel<4, BN>;
    case 5: return phase1_wgmma_kernel<5, BN>;
    default: return nullptr;
  }
}

cudaError_t wgmma_setup(int kp, int ts, WgmmaPlan* plan) {
  int optin = 0;
  cudaError_t e = smem_optin(&optin);
  if (e != cudaSuccess) return e;
  const int bn = ts % 128 == 0 ? 128 : 64;
  plan->kernel = bn == 128 ? wgmma_instance<128>(kp / 16) : wgmma_instance<64>(kp / 16);
  plan->smem = wg_smem(kp, bn);
  if (kp % 16 || plan->kernel == nullptr || ts % bn || plan->smem > (size_t)optin)
    return cudaErrorInvalidValue;
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

// Blocks of phase1_kernel that fit on one SM at kp (registers and shared
// memory), into *blocks. Returns a CUDA error code.
extern "C" int nns_expansion_phase1_blocks_per_sm(int kp, int* blocks) {
  Plan plan;
  cudaError_t e = plan_for(kp, &plan);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, phase1_kernel,
                                                            kThreads, plan.smem);
}

// The same for phase1_wgmma_kernel at kp and ts (cudaErrorInvalidValue
// where it does not take them).
extern "C" int nns_expansion_phase1_wgmma_blocks_per_sm(int kp, int ts, int* blocks) {
  WgmmaPlan plan;
  cudaError_t e = wgmma_setup(kp, ts, &plan);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks, plan.kernel, kWgThreads,
                                                            plan.smem);
}

// qc: (m, 6 kp) bf16 row-major; rc: (3 kp, n_pad) bf16 row-major; r2h:
// (n_pad,) f32; all three on 16-byte aligned bases, kp % 8 == 0. Ranges of
// tiles_per_split tiles of tile_n columns, split into ts-column subtiles
// (ts % 64 == 0). part_f (4, splits, m) and part_i (2, splits, m) are
// scratch; out_f (4, m) = [min1, m2x, t2v, t3v] and out_i (2, m) =
// [tid, tid2]. Launches on `stream` and does not synchronize. Returns
// cudaGetLastError() (or the error of a shared-memory request the card
// refuses).
extern "C" int nns_expansion_phase1(const uint16_t* qc, const uint16_t* rc,
                                    const float* r2h, int m, int kp, long long n_pad,
                                    int tile_n, int ts, int tiles_per_split, int splits,
                                    float* part_f, int* part_i, float* out_f, int* out_i,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Plan plan;
  cudaError_t e = plan_for(kp, &plan);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((m + kBM - 1) / kBM, splits);
  phase1_kernel<<<grid, kThreads, plan.smem, st>>>(qc, rc, r2h, m, kp, plan.ds, plan.nsl,
                                                   n_pad, tile_n, ts, tiles_per_split,
                                                   splits, part_f, part_i);
  return (int)launch_merge(part_f, part_i, m, splits, tile_n / ts, out_f, out_i, st);
}

// As nns_expansion_phase1, on phase1_wgmma_kernel: rc_t is (n_pad, 3 kp)
// bf16 row-major (rc transposed), kp % 16 == 0, and the query tile plus
// the ring must fit the card's opt-in shared memory (else
// cudaErrorInvalidValue, and nothing is launched). Chunks are 128 columns
// where ts % 128 == 0, else 64.
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
  plan.kernel<<<grid, kWgThreads, plan.smem, st>>>(qc, rc_t, r2h, m, n_pad, tile_n, ts,
                                                    tiles_per_split, splits, part_f, part_i);
  return (int)launch_merge(part_f, part_i, m, splits, tile_n / ts, out_f, out_i, st);
}
