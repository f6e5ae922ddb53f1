// Supercell halo scan: per supercell, exact 1-NN of its query slots over its
// precomputed halo point set, with the exactness certificate in the id's
// sign bit.
//
// Replaces: nns_tpu/kernels/cell_list.py `_cell_kernel` (launched by
// `_cell_scan`): direct f32 sum (q - h)^2 of a (QM, 3) query block against a
// (3, R_max) dim-major halo block, min carried across halo tiles, smallest
// global id among the minima, and id when min <= halo^2 else -id-1.
//
// Bound on the H100: memory. A batch reads every supercell's halo block
// once: at 1M uniform refs that is 2744 x 1280 slots x 16 bytes = 56 MB,
// more than the 50 MB L2, so each batch streams it from device memory
// (0.0170 ms at 3.35 TB/s). Tensor cores do not apply: a bit-exact 3-D
// distance (sub, mul, add each rounded, no FMA) has no matrix product to
// give them. The kernel runs at about half of its bound on the card; how
// much of the rest is the scoring (the rounded sub, mul and add of three
// dimensions and a lexicographic compare per (slot, point) pair) and how
// much the halo stream is not measured.
//
// Design:
// - Distinct slots only. The host scatter leaves most of a group's QM slots
//   at (0, 0, 0) (10,000 real queries in 2744 x 16 slots for one uniform
//   10K batch). Two slots with the same coordinates have the same answer, so
//   a block compacts its group's non-zero slots (in slot order, by warp
//   ballots and per-warp counts, with no atomic per slot) and scores them
//   plus one (0, 0, 0) representative, whose answer every zero slot (and a
//   real query at the origin, or at -0.0) takes. Halo
//   slots are never skipped: the sentinel tail can win for a group without
//   real halo points.
// - Each halo point is loaded from shared memory once per chunk of 2, 4 or
//   8 distinct slots (whichever wastes the fewest) and scored against all of
//   them, with one running (d2, id) per slot in registers (lex_less: halo
//   ids are not ascending). Warps split the tile's points when the group has
//   few chunks. A warp reduces each slot once per tile with two redux.sync
//   steps and lane 0 folds it into the slot's carry with a 64-bit shared
//   atomicMin on the key (d2 bits, id with its sign bit flipped): d2 >= +0,
//   so the key's unsigned order is the lexicographic (d2, id) order.
// - A persistent grid (as many blocks as fit on the SMs) walks the groups.
//   A two-stage shared-memory ring is fed by 1-D bulk asynchronous copies
//   (cp.async.bulk, completing on the stage's mbarrier): the halo's three
//   rows and ids, and with a group's first tile its (QM, 3) queries, so the
//   next group lands while the block scores the current one. A halo longer
//   than one stage is tiled inside its group. A bulk copy needs 16-byte
//   rows: an R_max or QM that is not a multiple of 4 (or a misaligned base)
//   takes the plain-load path, every thread filling the stage.
// - Consecutive groups alternate between two sets of slot buffers, so a
//   group takes two block barriers (after its compaction, after its
//   scoring). The ring and the buffers live in dynamic shared memory sized
//   from QM and the tile.
#include "common.cuh"

namespace {

constexpr int kStages = 2;
constexpr int kMaxTile = 2048;  // halo slots per ring stage
constexpr int kMaxWarps = 8;    // warps of the larger block
constexpr int kMaxQM = 2048;    // query slots per supercell
// Groups of at most kSmallQM slots run 128-thread blocks (more of them per
// SM, each group's few distinct slots spread over fewer warps); larger ones
// 256-thread blocks, whose 8 warps share a skewed group's many slots.
constexpr int kSmallQM = 64;

// Shared-memory layout, in bytes from the base: kStages mbarriers; the ring
// of kStages stages, each `tile` slots of x, y, z and id rows then the
// group's (QM, 3) queries (filled with the group's first tile); and, twice
// (groups alternate, so that one group's outputs and the next group's
// compaction need no barrier between them), the distinct slots as float4
// (entry 0 the (0, 0, 0) representative), their carry keys, the
// slot-to-entry map, and the per-warp counts of the compaction (two sets)
// plus the group's entry count.
struct Layout {
  int tile, qm, q_floats;
  size_t ring, stage_floats, slots, carry, map, counters, bytes;
  __host__ __device__ Layout(int qm_, int tile_) : tile(tile_), qm(qm_) {
    q_floats = (qm * 3 + 3) / 4 * 4;
    ring = 64;
    stage_floats = (size_t)4 * tile + q_floats;
    slots = ring + (size_t)kStages * stage_floats * sizeof(float);
    carry = slots + 2 * (size_t)(qm + 1) * sizeof(float4);
    map = carry + 2 * (size_t)(qm + 1) * sizeof(unsigned long long);
    counters = map + 2 * (size_t)qm * sizeof(int);
    bytes = counters + 2 * (2 * kMaxWarps + 1) * sizeof(int);
  }
};

struct Scan {
  const float* __restrict__ dense_q;
  const float* __restrict__ halo_dm;
  const int* __restrict__ halo_ids;
  int qm, r_max, n_tiles;
  long long items;  // this block's (group, tile) pairs
  Layout lay;
  unsigned char* smem;

  __device__ long long group_of(long long item) const {
    return blockIdx.x + (item / n_tiles) * gridDim.x;
  }
  __device__ float* stage(long long item) const {
    return reinterpret_cast<float*>(smem + lay.ring) + (item % kStages) * lay.stage_floats;
  }
  __device__ unsigned long long* bar(long long item) const {
    return reinterpret_cast<unsigned long long*>(smem) + item % kStages;
  }

  // Thread 0: arm the item's stage and copy its three halo rows, its ids
  // and, with a group's first tile, the group's queries.
  __device__ void issue(long long item) const {
    const long long g = group_of(item);
    const int base = (int)(item % n_tiles) * lay.tile;
    const unsigned bytes = (unsigned)min(lay.tile, r_max - base) * 4u;
    const unsigned q_bytes = base == 0 ? (unsigned)qm * 12u : 0u;
    float* st = stage(item);
    nns::fence_proxy_async();
    nns::mbar_expect_tx(bar(item), 4 * bytes + q_bytes);
    for (int d = 0; d < 3; ++d) {
      nns::bulk_copy(st + d * lay.tile, halo_dm + (g * 3 + d) * r_max + base, bytes, bar(item));
    }
    nns::bulk_copy(st + 3 * lay.tile, halo_ids + g * r_max + base, bytes, bar(item));
    if (q_bytes) nns::bulk_copy(st + 4 * lay.tile, dense_q + g * qm * 3, q_bytes, bar(item));
  }

  // Every thread: the plain-load path's fill of the item's stage.
  __device__ void fill(long long item) const {
    const long long g = group_of(item);
    const int base = (int)(item % n_tiles) * lay.tile;
    const int len = min(lay.tile, r_max - base);
    float* st = stage(item);
    for (int t = threadIdx.x; t < len; t += blockDim.x) {
      for (int d = 0; d < 3; ++d) st[d * lay.tile + t] = halo_dm[(g * 3 + d) * r_max + base + t];
      st[3 * lay.tile + t] = __int_as_float(halo_ids[g * r_max + base + t]);
    }
    if (base == 0) {
      for (int t = threadIdx.x; t < qm * 3; t += blockDim.x) st[4 * lay.tile + t] = dense_q[g * qm * 3 + t];
    }
  }
};

// Score one stage's `len` halo points against the distinct entries
// [first, n_ent): units of (chunk of kC entries, part of the points), each
// warp one unit at a time; each entry's winner is folded into its carry key
// once per tile.
template <int kWarps, int kC>
__device__ __forceinline__ void score_tile(const float* st, int tile, int len,
                                           const float4* slots, unsigned long long* carry,
                                           int first, int n_ent) {
  const int warp = threadIdx.x / nns::kWarp;
  const int lane = threadIdx.x % nns::kWarp;
  const int* hid = reinterpret_cast<const int*>(st + 3 * tile);
  const int n_chunks = (n_ent - first + kC - 1) / kC;
  const int wpc = max(1, kWarps / n_chunks);  // warps per chunk
  for (int u = warp; u < n_chunks * wpc; u += kWarps) {
    const int c0 = first + (u / wpc) * kC;
    float qx[kC], qy[kC], qz[kC], bd[kC];
    int bi[kC];
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      const float4 v = slots[min(c0 + j, n_ent - 1)];  // past n_ent: a copy, never folded
      qx[j] = v.x;
      qy[j] = v.y;
      qz[j] = v.z;
      bd[j] = CUDART_INF_F;
      bi[j] = INT_MAX;
    }
    for (int p = (u % wpc) * nns::kWarp + lane; p < len; p += wpc * nns::kWarp) {
      const float hx = st[p], hy = st[tile + p], hz = st[2 * tile + p];
      const int id = hid[p];
#pragma unroll
      for (int j = 0; j < kC; ++j) {
        // d2 = 0 + dx^2 + dy^2 + dz^2 as the plain version rounds it
        // (0 + dx^2 is dx^2 exactly).
        const float dx = __fsub_rn(qx[j], hx);
        float d2 = __fmul_rn(dx, dx);
        d2 = nns::add_sq_diff(d2, qy[j], hy);
        d2 = nns::add_sq_diff(d2, qz[j], hz);
        if (nns::lex_less(d2, id, bd[j], bi[j])) {
          bd[j] = d2;
          bi[j] = id;
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kC; ++j) {
      if (c0 + j < n_ent) {  // warp-uniform
        const unsigned db = __float_as_uint(bd[j]);
        const unsigned dmin = __reduce_min_sync(0xffffffffu, db);
        const unsigned ik = db == dmin ? ((unsigned)bi[j] ^ 0x80000000u) : 0xffffffffu;
        const unsigned imin = __reduce_min_sync(0xffffffffu, ik);
        if (lane == 0) atomicMin(&carry[c0 + j], ((unsigned long long)dmin << 32) | imin);
      }
    }
  }
}

template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
cell_scan_kernel(const float* __restrict__ dense_q, const float* __restrict__ halo_dm,
                 const int* __restrict__ halo_ids, int groups, int qm, int r_max, int tile,
                 bool bulk, float halo2, float* __restrict__ out_min,
                 int* __restrict__ out_sgid) {
  constexpr int kWarps = kThreads / nns::kWarp;
  extern __shared__ __align__(16) unsigned char smem[];
  const Layout lay(qm, tile);
  Scan sc{dense_q, halo_dm, halo_ids, qm, r_max, (r_max + tile - 1) / tile, 0, lay, smem};
  const int my_groups =
      (int)blockIdx.x < groups ? (groups - 1 - (int)blockIdx.x) / (int)gridDim.x + 1 : 0;
  sc.items = (long long)my_groups * sc.n_tiles;
  if (threadIdx.x == 0) {
    if (bulk) {
      for (int s = 0; s < kStages; ++s) nns::mbar_init(sc.bar(s));
    }
    for (int p = 0; p < 2; ++p) {
      reinterpret_cast<float4*>(smem + lay.slots)[p * (qm + 1)] = make_float4(0.f, 0.f, 0.f, 0.f);
    }
  }
  __syncthreads();
  if (threadIdx.x == 0 && bulk) {
    for (long long it = 0; it < kStages && it < sc.items; ++it) sc.issue(it);
  }

  int first = 0, n_ent = 0;  // this group's distinct entries: [first, n_ent)
  for (long long it = 0; it < sc.items; ++it) {
    const long long g = sc.group_of(it);
    const int par = (int)((it / sc.n_tiles) & 1);
    float4* slots = reinterpret_cast<float4*>(smem + lay.slots) + par * (qm + 1);
    unsigned long long* carry =
        reinterpret_cast<unsigned long long*>(smem + lay.carry) + par * (qm + 1);
    int* map = reinterpret_cast<int*>(smem + lay.map) + par * qm;
    int* counters = reinterpret_cast<int*>(smem + lay.counters) + par * (2 * kMaxWarps + 1);
    const int t_idx = (int)(it % sc.n_tiles);
    const int len = min(tile, r_max - t_idx * tile);
    const float* st = sc.stage(it);
    if (bulk) {
      nns::mbar_wait(sc.bar(it), (unsigned)((it / kStages) & 1));
    } else {
      sc.fill(it);
      __syncthreads();
    }
    if (t_idx == 0) {
      // Compact the group's slots in slot order, 256 at a time: the
      // non-zero ones become entries 1, 2, ... (warp ballots and per-warp
      // counts); zero slots map to entry 0.
      const float* q = st + 4 * tile;
      const int warp = threadIdx.x / nns::kWarp, lane = threadIdx.x % nns::kWarp;
      int run = 1, zero = 0;
      for (int s0 = 0, pass = 0; s0 < qm; s0 += kThreads, ++pass) {
        const int s = s0 + threadIdx.x;
        float x = 0.0f, y = 0.0f, z = 0.0f;
        if (s < qm) {
          x = q[s * 3];
          y = q[s * 3 + 1];
          z = q[s * 3 + 2];
        }
        const bool nz = s < qm && !(x == 0.0f && y == 0.0f && z == 0.0f);
        zero |= s < qm && !nz;
        const unsigned mask = __ballot_sync(0xffffffffu, nz);
        int base = run, total = __popc(mask);
        if (qm > nns::kWarp) {  // else warp 0 holds every slot
          int* cnt = counters + (pass & 1) * kWarps;  // alternate: no second barrier
          if (lane == 0) cnt[warp] = total;
          __syncthreads();
          total = 0;
          for (int w = 0; w < kWarps; ++w) {
            const int c = cnt[w];
            base += w < warp ? c : 0;
            total += c;
          }
        }
        if (s < qm) {
          const int e = base + __popc(mask & ((1u << lane) - 1));
          if (nz) slots[e] = make_float4(x, y, z, 0.0f);
          map[s] = nz ? e : 0;
        }
        run += total;
      }
      for (int s = threadIdx.x; s <= qm; s += kThreads) carry[s] = ~0ull;
      if (threadIdx.x == 0) counters[2 * kMaxWarps] = run;  // thread 0's run is the group's
      first = __syncthreads_or(zero) ? 0 : 1;
      n_ent = counters[2 * kMaxWarps];
    }
    const int nd = n_ent - first;

    // Chunks of 2, 4 or 8 entries, whichever wastes the fewest dummy
    // entries in the group's last chunk.
    if (nd <= 2) {
      score_tile<kWarps, 2>(st, tile, len, slots, carry, first, n_ent);
    } else if (nd <= 4) {
      score_tile<kWarps, 4>(st, tile, len, slots, carry, first, n_ent);
    } else {
      score_tile<kWarps, 8>(st, tile, len, slots, carry, first, n_ent);
    }
    __syncthreads();  // the stage is consumed; the carry is final for this tile
    if (bulk && threadIdx.x == 0 && it + kStages < sc.items) sc.issue(it + kStages);

    if (t_idx == sc.n_tiles - 1) {
      for (int s = threadIdx.x; s < qm; s += kThreads) {
        const unsigned long long key = carry[map[s]];
        const float d = __uint_as_float((unsigned)(key >> 32));
        const int i = (int)((unsigned)key ^ 0x80000000u);
        out_min[g * qm + s] = d;
        out_sgid[g * qm + s] = d <= halo2 ? i : -i - 1;
      }
    }
  }
}

// The halo split into the fewest equal tiles, of at most kMaxTile slots
// rounded up to 4, whose layout fits `optin` bytes; 0 if none does.
int tile_for(int r_max, int qm, int optin) {
  for (int n_tiles = (r_max + kMaxTile - 1) / kMaxTile;; ++n_tiles) {
    const int tile = ((r_max + n_tiles - 1) / n_tiles + 3) / 4 * 4;
    if (Layout(qm, tile).bytes <= (size_t)optin) return tile;
    if (tile <= 4) return 0;
  }
}

}  // namespace

// dense_q: (G, QM, 3); halo_dm: (G, 3, R_max); halo_ids: (G, R_max);
// out_min: (G, QM) f32; out_sgid: (G, QM) i32. Launches on `stream` and does
// not synchronize. Returns cudaGetLastError(), or cudaErrorInvalidValue for
// a QM outside 1..2048 or R_max < 1.
extern "C" int nns_cell_scan(const float* dense_q, const float* halo_dm,
                             const int* halo_ids, int groups, int qm,
                             int r_max, float halo2, float* out_min,
                             int* out_sgid, void* stream) {
  if (qm < 1 || qm > kMaxQM || r_max < 1 || groups < 0) return (int)cudaErrorInvalidValue;
  if (groups == 0) return (int)cudaSuccess;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const int tile = tile_for(r_max, qm, optin);
  if (tile == 0) return (int)cudaErrorInvalidValue;
  const size_t smem = Layout(qm, tile).bytes;
  const bool bulk = r_max % 4 == 0 && qm % 4 == 0 && nns::aligned16(halo_dm) &&
                    nns::aligned16(halo_ids) && nns::aligned16(dense_q);
  const bool small = qm <= kSmallQM;
  auto kernel = small ? cell_scan_kernel<128, 5> : cell_scan_kernel<256, 3>;
  const int threads = small ? 128 : 256;
  int slots = 0;
  e = nns::grid_slots(kernel, threads, smem, &slots);
  if (e != cudaSuccess) return (int)e;
  kernel<<<groups < slots ? groups : slots, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      dense_q, halo_dm, halo_ids, groups, qm, r_max, tile, bulk, halo2, out_min, out_sgid);
  return (int)cudaGetLastError();
}
