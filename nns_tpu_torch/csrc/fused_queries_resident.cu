// v6 fused distance + argmin with the query set RESIDENT on chip for the
// block's whole life and a grid over reference ranges only.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_fused_qres_kernel` (launched
// by `_fused_qres_call`): the padded (m, k) query block stays in VMEM for the
// whole grid, which runs over (k, tile_n) ref tiles only, with a (min, idx)
// carry per query.
//
// Bound on the H100: operations, as v4: per pair k sub, k mul, k add and a
// compare, each rounded on its own (no FMA, so kernel and plain version stay
// bit-equal). Against the f32 peak, which counts an FMA as two operations,
// such a kernel can reach about (3k + 1) / (2 x instructions per pair),
// 35-45% for k = 3 to 16.
//
// Design:
// - Grid = S ref ranges of whole ring tiles, as many blocks as fit on the
//   SMs (2 per SM or more where registers and shared memory allow), one
//   block each; no query axis.
// - Queries in registers. At k = 3 and 16 (template parameters, so the
//   contraction unrolls) each thread owns kQ rows: a block holds 256 kQ rows
//   (1024 at kQ = 4) for a pass over its range, with a (d2, idx) carry per
//   row. A thread visits its range's columns in ascending order, so a strict
//   `<` keeps the lowest index: no index compare and no block reduction per
//   column or pass. Each pass starts at (inf, the range's first column), so
//   a row whose every distance overflows to +inf still gets the range's
//   lowest index, as the plain version gives. A larger query set takes several passes, each re-reading
//   the range (from L2 at the ladder's shapes). Each query row is read from
//   memory once per block either way, so it goes straight to registers;
//   staging it in shared memory first would only copy it twice.
// - A small query set would leave most threads without a row, so there 1-32
//   neighbouring threads (tpr) share a row, each scanning its own columns,
//   and fold their winners by shuffles at the end of a pass.
// - Every other k runs one instance with k at run time and one row per tpr
//   threads. It streams the contraction: a ring stage holds `dims` (at most
//   16) of the k dimensions of a tile, and the pass's rows' same dims wait
//   in shared memory. At k <= 16 that is the whole contraction; past it, a
//   thread's column sums (at most 8 groups of four columns per tile) stay
//   in registers across the tile's slices. Its shared memory does not grow
//   with k, so every k the 4 MB query budget admits runs.
// - Refs through a two-stage shared-memory ring: a stage is `tile` columns of
//   `dims` dim-major rows, one 1-D bulk asynchronous copy (cp.async.bulk,
//   completing on the stage's mbarrier) per row, issued by one thread while
//   the block scores the other stage. Every thread reads each column as a
//   broadcast, four columns per 16-byte load. A bulk copy needs 16-byte rows:
//   a pitch that is not a multiple of 4 floats (or a misaligned base) takes
//   the plain-load path, every thread filling the stage.
// - Each block writes its winners to an (S, m) table; one merge kernel folds
//   the S ranges per query (common.cuh), as the TPU kernel's grid carry
//   becomes a second pass here.
//
// The plan (kQ, threads per row, tile, dims per stage) has one home,
// `qres_plan` in nns_tpu_torch/kernels/fused_ladder.py. This file refuses
// any plan it has no instance for, and its shared-memory need is the
// layout's own (`nns_fused_queries_resident_smem`).
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kStages = 2;
constexpr int kMaxDims = 16;  // run-time k: dimensions per ring stage
constexpr int kGroups = 8;    // run-time k: four-column groups per thread and tile

// Dynamic shared memory: kStages mbarriers (16 bytes), the ring and, for
// the sliced instance, the pass's rows' current slice as (dims, rows + 1).
size_t smem_bytes(int dims, int tile, int rows, bool sliced) {
  return 16 + (size_t)kStages * dims * tile * sizeof(float) +
         (sliced ? (size_t)dims * (rows + 1) * sizeof(float) : 0);
}

// A block's walk of its ref range: item `it` is (pass, tile, slice), in
// that order of nesting; its stage holds the slice's dims x the tile's
// columns of r_dm.
struct Ring {
  const float* __restrict__ r_dm;
  long long ld, lo, hi, items;
  int k, dims, slices, n_tiles, tile;
  unsigned long long* bars;
  float* base;

  __device__ Ring(unsigned char* smem, const float* r_dm_, long long ld_, int n, int k_,
                  int dims_, int tile_, int cols_per_split, int passes)
      : r_dm(r_dm_), ld(ld_), k(k_), dims(dims_), tile(tile_) {
    lo = (long long)blockIdx.x * cols_per_split;
    hi = min((long long)n, lo + cols_per_split);
    n_tiles = hi > lo ? (int)((hi - lo + tile - 1) / tile) : 0;
    slices = (k + dims - 1) / dims;
    items = (long long)passes * n_tiles * slices;
    bars = reinterpret_cast<unsigned long long*>(smem);
    base = reinterpret_cast<float*>(smem + 16);
  }
  __device__ float* stage(long long it) const { return base + (size_t)(it % kStages) * dims * tile; }
  // Tile t's first column and its column count.
  __device__ int tile_cols(int t, long long& col0) const {
    col0 = lo + (long long)t * tile;
    return (int)min((long long)tile, hi - col0);
  }
  // Slice s's first dimension and its dimension count.
  __device__ int slice_dims(int s, int& d0) const {
    d0 = s * dims;
    return min(dims, k - d0);
  }
  // Thread 0: arm item it's stage and copy its row slices.
  __device__ void issue(long long it) const {
    const long long ts = it / slices;
    long long col0;
    int d0;
    const unsigned bytes = (unsigned)((tile_cols((int)(ts % n_tiles), col0) + 3) / 4 * 16);
    const int nd = slice_dims((int)(it - ts * slices), d0);
    float* st = stage(it);
    unsigned long long* bar = bars + it % kStages;
    nns::fence_proxy_async();
    nns::mbar_expect_tx(bar, bytes * nd);
    for (int d = 0; d < nd; ++d) nns::bulk_copy(st + d * tile, r_dm + (d0 + d) * ld + col0, bytes, bar);
  }
  // Barriers and the first stages in flight; every thread calls it.
  __device__ void start(bool bulk) const {
    if (threadIdx.x == 0 && bulk) {
      for (int s = 0; s < kStages; ++s) nns::mbar_init(bars + s);
    }
    __syncthreads();
    if (threadIdx.x == 0 && bulk) {
      for (long long it = 0; it < kStages && it < items; ++it) issue(it);
    }
  }
  // Item it's stage (slice s of tile t), once it has landed (bulk) or every
  // thread filled it.
  __device__ const float* acquire(long long it, int t, int s, bool bulk) const {
    float* st = stage(it);
    if (bulk) {
      nns::mbar_wait(bars + it % kStages, (unsigned)((it / kStages) & 1));
    } else {
      long long col0;
      int d0;
      const int lim = tile_cols(t, col0);
      const int nd = slice_dims(s, d0);
      for (int e = threadIdx.x; e < nd * lim; e += kThreads) {
        st[(e / lim) * tile + e % lim] = r_dm[(d0 + e / lim) * ld + col0 + e % lim];
      }
      __syncthreads();
    }
    return st;
  }
  // The item's stage is consumed: refill it with item it + kStages.
  __device__ void release(long long it, bool bulk) const {
    __syncthreads();
    if (bulk && threadIdx.x == 0 && it + kStages < items) issue(it + kStages);
  }
};

// The tpr threads of a row are neighbouring lanes: fold their winners, and
// the first writes the row's to the (S, m) table.
template <int kQ>
__device__ __forceinline__ void write_winners(float (&best_d)[kQ], int (&best_i)[kQ], int row0,
                                              int row_step, int tpr, int m, float* part_d,
                                              int* part_i) {
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
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    const int row = row0 + qi * row_step + (int)threadIdx.x / tpr;
    if (row < m && threadIdx.x % tpr == 0) {
      part_d[(long long)blockIdx.x * m + row] = best_d[qi];
      part_i[(long long)blockIdx.x * m + row] = best_i[qi];
    }
  }
}

// k = kK, kQ rows per thread in registers (with kQ = 1, a row may be shared
// by tpr threads); one slice of all kK dims per stage.
template <int kK, int kQ>
__global__ void __launch_bounds__(kThreads, 2)
queries_resident_kernel(const float* __restrict__ q, const float* __restrict__ r_dm, int m,
                        int n, long long ld, int cols_per_split, int tile, int tpr, bool bulk,
                        float* __restrict__ part_d, int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = kThreads * kQ / tpr;  // query rows per pass
  const int passes = (m + rows - 1) / rows;
  const Ring ring(smem, r_dm, ld, n, kK, kK, tile, cols_per_split, passes);
  ring.start(bulk);

  // Thread t holds rows row0 + qi * (256 / tpr) + t / tpr and scans every
  // tpr-th group of four columns from (t % tpr) * 4.
  const int row_l = threadIdx.x / tpr;
  const int part = threadIdx.x % tpr;
  const int row_step = kThreads / tpr;
  long long it = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int row0 = pass * rows;
    float qr[kQ][kK];
#pragma unroll
    for (int qi = 0; qi < kQ; ++qi) {
      const long long row = min(row0 + qi * row_step + row_l, m - 1);
#pragma unroll
      for (int d = 0; d < kK; ++d) qr[qi][d] = q[row * kK + d];
    }
    float best_d[kQ];
    int best_i[kQ];
    nns::init_best(best_d, best_i, (int)ring.lo);

    for (int t = 0; t < ring.n_tiles; ++t, ++it) {
      long long col0;
      const int lim = ring.tile_cols(t, col0);
      const float* st = ring.acquire(it, t, 0, bulk);
      // Four columns c .. c + 3 per step, in ascending order per thread.
      for (int c = part * 4; c < lim; c += 4 * tpr) {
        float acc[kQ][4];
#pragma unroll
        for (int d = 0; d < kK; ++d) {
          const float4 r = *reinterpret_cast<const float4*>(st + d * tile + c);
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi) {
            const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
            for (int cc = 0; cc < 4; ++cc) {
              const float diff = __fsub_rn(qr[qi][d], rv[cc]);
              // d2 = 0 + diff^2 + ... as the plain version rounds it
              // (0 + diff^2 is diff^2 exactly).
              acc[qi][cc] = d == 0 ? __fmul_rn(diff, diff)
                                   : __fadd_rn(acc[qi][cc], __fmul_rn(diff, diff));
            }
          }
        }
        const int j0 = (int)(col0 + c);
        const int valid = min(4, lim - c);  // past the range end: never folded
#pragma unroll
        for (int cc = 0; cc < 4; ++cc) {
#pragma unroll
          for (int qi = 0; qi < kQ; ++qi) {
            if (cc < valid && acc[qi][cc] < best_d[qi]) {
              best_d[qi] = acc[qi][cc];
              best_i[qi] = j0 + cc;
            }
          }
        }
      }
      ring.release(it, bulk);
    }
    write_winners(best_d, best_i, row0, row_step, tpr, m, part_d, part_i);
  }
}

// Any k at run time, one row per tpr threads, the contraction in slices of
// `dims` dimensions; the pass's rows' current slice waits in shared memory,
// dim-major with a padded pitch so that a warp reads it without bank
// conflicts. Thread t scans columns cb + (t % tpr) * 4 + j * 4 tpr of each
// column block cb of a tile (j < kGroups). With one slice the blocks fold
// as they go; with several, the plan keeps a tile to one block, whose sums
// carry over the tile's slices.
__global__ void __launch_bounds__(kThreads, 2)
queries_resident_sliced_kernel(const float* __restrict__ q, const float* __restrict__ r_dm, int m,
                               int k, int n, long long ld, int cols_per_split, int tile, int tpr,
                               int dims, bool bulk, float* __restrict__ part_d,
                               int* __restrict__ part_i) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int rows = kThreads / tpr;
  const int pitch = rows + 1;
  const int passes = (m + rows - 1) / rows;
  const Ring ring(smem, r_dm, ld, n, k, dims, tile, cols_per_split, passes);
  float* q_s = ring.base + (size_t)kStages * dims * tile;
  ring.start(bulk);

  const int row_l = threadIdx.x / tpr;
  const int part = threadIdx.x % tpr;
  const int span = kGroups * 4 * tpr;  // the columns of one column block
  long long it = 0;
  for (int pass = 0; pass < passes; ++pass) {
    const int row0 = pass * rows;
    float best_d[1];
    int best_i[1];
    nns::init_best(best_d, best_i, (int)ring.lo);

    for (int t = 0; t < ring.n_tiles; ++t) {
      long long col0;
      const int lim = ring.tile_cols(t, col0);
      float acc[kGroups][4];
      for (int s = 0; s < ring.slices; ++s, ++it) {
        int d0;
        const int nd = ring.slice_dims(s, d0);
        if (t == 0 || ring.slices > 1) {
          // The slice's rows; the last item's release (or the start) has
          // ordered every read of the previous ones before this.
          for (int e = threadIdx.x; e < rows * nd; e += kThreads) {
            q_s[(e % nd) * pitch + e / nd] = q[(long long)min(row0 + e / nd, m - 1) * k + d0 + e % nd];
          }
          __syncthreads();
        }
        const float* st = ring.acquire(it, t, s, bulk);
        for (int cb = 0; cb < lim; cb += span) {
          if (s == 0) {
#pragma unroll
            for (int j = 0; j < kGroups; ++j) {
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) acc[j][cc] = 0.0f;
            }
          }
          for (int d = 0; d < nd; ++d) {
            const float qv = q_s[d * pitch + row_l];
#pragma unroll
            for (int j = 0; j < kGroups; ++j) {
              const int c = cb + part * 4 + j * 4 * tpr;
              if (c < lim) {
                const float4 r = *reinterpret_cast<const float4*>(st + d * tile + c);
                acc[j][0] = nns::add_sq_diff(acc[j][0], qv, r.x);
                acc[j][1] = nns::add_sq_diff(acc[j][1], qv, r.y);
                acc[j][2] = nns::add_sq_diff(acc[j][2], qv, r.z);
                acc[j][3] = nns::add_sq_diff(acc[j][3], qv, r.w);
              }
            }
          }
          if (s == ring.slices - 1) {
            // The block's sums are complete: fold its columns in ascending order.
#pragma unroll
            for (int j = 0; j < kGroups; ++j) {
              const int c = cb + part * 4 + j * 4 * tpr;
#pragma unroll
              for (int cc = 0; cc < 4; ++cc) {
                if (c + cc < lim && acc[j][cc] < best_d[0]) {
                  best_d[0] = acc[j][cc];
                  best_i[0] = (int)(col0 + c + cc);
                }
              }
            }
          }
        }
        ring.release(it, bulk);
      }
    }
    write_winners(best_d, best_i, row0, rows, tpr, m, part_d, part_i);
  }
}

using Kernel = void (*)(const float*, const float*, int, int, long long, int, int, int, bool,
                        float*, int*);

// The plan's instance: a k-templated kernel, or the sliced one.
struct Launch {
  Kernel kernel = nullptr;
  bool sliced = false;
  const void* fn() const {
    return sliced ? (const void*)queries_resident_sliced_kernel : (const void*)kernel;
  }
};

template <int kK>
Launch templated(int q_rows, int tpr) {
  if (q_rows == 4) return {tpr == 1 ? queries_resident_kernel<kK, 4> : nullptr};
  return {q_rows == 1 ? queries_resident_kernel<kK, 1> : nullptr};
}

// The instance for the plan, or no kernel: k = 3 and 16 with all k dims per
// stage, 4 rows per thread or one row per 1, 2, ..., 32 threads; any k
// sliced, one row per 1-32 threads, 1-16 dims per stage and, with more than
// one slice, at most kGroups four-column groups per thread and tile.
Launch instance(int k, int q_rows, int tpr, int tile, int dims) {
  if (k < 1 || tpr < 1 || tpr > nns::kWarp || (tpr & (tpr - 1)) || tile < 4 || tile % 4) return {};
  if (dims == k && k == 3) return templated<3>(q_rows, tpr);
  if (dims == k && k == 16) return templated<16>(q_rows, tpr);
  if (q_rows != 1 || dims < 1 || dims > kMaxDims || dims > k) return {};
  if (dims < k && tile > kGroups * 4 * tpr) return {};
  return {nullptr, true};
}

// The plan's kernel, its shared memory, and the grid slots it has on this
// device; cudaErrorInvalidValue for a plan without an instance or more
// shared memory than a block gets.
cudaError_t setup(int k, int q_rows, int tpr, int tile, int dims, Launch* launch, size_t* smem,
                  int* slots) {
  *launch = instance(k, q_rows, tpr, tile, dims);
  if (launch->fn() == nullptr) return cudaErrorInvalidValue;
  *smem = smem_bytes(dims, tile, kThreads * q_rows / tpr, launch->sliced);
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return e;
  if (*smem > (size_t)optin) return cudaErrorInvalidValue;
  return nns::grid_slots(launch->fn(), kThreads, *smem, slots);
}

}  // namespace

// The dynamic shared memory (bytes) and the grid slots (resident blocks per
// SM times SMs) of the plan (k, q_rows, tpr, tile, dims), or the error
// `setup` refuses it with.
extern "C" int nns_fused_queries_resident_smem(int k, int q_rows, int tpr, int tile, int dims,
                                               long long* bytes, int* slots) {
  Launch launch;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, tile, dims, &launch, &smem, slots);
  *bytes = (long long)smem;
  return (int)e;
}

// q: (m, k) row-major on the device; r_dm: (k, ld) dim-major, columns [0, n)
// scanned; part_d/part_i: (splits, m) scratch; out_d/out_i: (m,). The plan
// (q_rows, tpr, tile, dims) is `qres_plan`'s. Launches one scan over
// `splits` ref ranges and one merge on `stream` and does not synchronize.
// Returns cudaGetLastError(), or setup's refusal.
extern "C" int nns_fused_queries_resident(const float* q, const float* r_dm, int m, int k,
                                          int n, long long ld, int splits, int q_rows, int tpr,
                                          int tile, int dims, float* part_d, int* part_i,
                                          float* out_d, int* out_i, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  Launch launch;
  size_t smem = 0;
  int slots = 0;
  cudaError_t e = setup(k, q_rows, tpr, tile, dims, &launch, &smem, &slots);
  if (e != cudaSuccess) return (int)e;
  if (splits < 1 || m < 1 || n < 1) return (int)cudaErrorInvalidValue;
  // Ranges of whole tiles, so that every copy starts 16-byte aligned.
  const int per_split = (n + splits - 1) / splits;
  const int cols_per_split = (per_split + tile - 1) / tile * tile;
  const bool bulk = ld % 4 == 0 && nns::aligned16(r_dm);
  if (launch.sliced) {
    queries_resident_sliced_kernel<<<splits, kThreads, smem, st>>>(
        q, r_dm, m, k, n, ld, cols_per_split, tile, tpr, dims, bulk, part_d, part_i);
  } else {
    launch.kernel<<<splits, kThreads, smem, st>>>(
        q, r_dm, m, n, ld, cols_per_split, tile, tpr, bulk, part_d, part_i);
  }
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  return (int)nns::launch_merge(part_d, part_i, m, splits, out_d, out_i, st);
}
