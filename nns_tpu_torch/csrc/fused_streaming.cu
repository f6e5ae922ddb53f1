// v5 fused distance + argmin with reference tiles STREAMED through a
// multi-stage shared-memory ring: the copy of the next tiles overlaps the
// distances of this one.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_fused_stream_kernel` (launched
// by `_fused_stream_call`): refs left in HBM, (k, tile_n) dim-major tiles
// copied into VMEM by manual DMA into two slots, a (min, idx) carry in a
// fori_loop over the tiles.
//
// Bound on the H100: operations, as v4: per pair k sub, k mul, k add and a
// compare, each rounded on its own (no FMA, so kernel and plain version stay
// bit-equal): about 35-45% of the f32 peak at most (utils/bounds.py). The
// rung's idea is the memory path, done here the Hopper way.
//
// Design:
// - Grid = (query tiles of 256 x q_rows rows) x (S ref ranges of whole
//   stages), as many blocks as fit at once; an (S, m) table of winners and
//   one merge kernel (common.cuh), as the TPU kernel's grid carry becomes a
//   second pass here. Each ref column is streamed m / 256 times at most
//   (m / 1024 at q_rows = 4), not m / 16 as with 16-row tiles.
// - Query rows in registers: consumer thread t holds rows row0 + qi * 256 + t
//   (qi < q_rows) for the block's whole range and visits every column of the
//   range in ascending order, so a strict < keeps the lowest index (from a
//   start of (inf, the range's first column)). A query set smaller than a
//   tile (m < 256) would leave most rows as duplicates scored for nothing,
//   so there tpr threads (a power of two up to 32) share each row of a
//   256 / tpr-row tile, each taking every tpr-th group of four columns, and
//   the block folds their winners once, at the end of its range (common.cuh
//   fold_parts). k = 3 and 16 are template parameters (the
//   contraction unrolls; 4 or 1 rows per thread). Every other k runs one
//   sliced instance: a stage holds `dims` (at most 16) of the k dimensions of
//   a tile, each thread loads its own row's same slice into registers (no
//   barrier among consumers), and with several slices a thread's column sums
//   (8 groups of four columns, so a tile is at most 32 columns) are carried
//   in registers across the tile's slices. Its shared memory does not grow
//   with k, so every k runs.
// - Refs through a producer/consumer ring (common.cuh StageRing): one
//   producer warp waits for a free stage and issues one cp.async.bulk per
//   dimension row of it (lane d copies row d), completing on the stage's full
//   mbarrier; each of the 8 consumer warps arrives on the stage's empty
//   mbarrier when done. No block-wide barrier in the loop. Every consumer
//   reads each column as a broadcast, four columns per 16-byte load, so there
//   are no bank conflicts. A pitch that is not a multiple of 4 floats or a
//   misaligned base takes the plain-load path: the producer lanes fill the
//   stage with loads and arrive.
//
// The plan (q_rows, stage columns, dims per stage, stages) has one home,
// `ring_plan` in nns_tpu_torch/kernels/fused_ladder.py. This file refuses
// any plan it has no instance for; its shared-memory need is the layout's
// own (`nns_fused_streaming_smem`).
#include "common.cuh"

namespace {

constexpr int kGroups = 8;    // sliced: four-column groups per thread and column block
constexpr int kMaxStages = 8;

// k = kK, kQ rows per consumer thread, all kK dims in each stage.
template <int kK, int kQ>
__global__ void __launch_bounds__(nns::kRingThreads, 2)
streaming_kernel(const nns::RingArgs a) {
  extern __shared__ __align__(16) unsigned char smem[];
  const nns::StageRing ring(smem, a.stages, (long long)kK * a.cols);
  const nns::RingRange range(a);
  ring.start(a.bulk);
  if (threadIdx.x >= nns::kRingConsumers) {
    nns::produce_dim_major(ring, a, range, 1);
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
    long long col0;
    const int lim = range.tile(a, t, col0);
    const float* st = ring.acquire(pos);
    for (int c = 4 * rows.part; c < lim; c += 4 * tpr) {
      float acc[kQ][4];
      nns::score4<kK, kQ, false>(st + c, a.cols, qr, acc);
      nns::fold4(acc, best_d, best_i, (int)(col0 + c), lim - c);
    }
    ring.release(pos);
  }
  if (tpr > 1) nns::fold_parts(best_d[0], best_i[0], rows, tpr, ring.stage(0));
  nns::write_rows(best_d, best_i, rows, a.m, a.part_d, a.part_i);
}

// Any k at run time, one row per consumer thread, the contraction in slices
// of `dims` dimensions (the row's slice in registers). Columns go in blocks
// of kGroups x 4; with one slice a block folds as soon as it is scored, with
// several the plan keeps a tile to one block, whose sums carry over the
// tile's slices. kShared: tpr > 1 threads share each row, a thread's groups
// tpr groups apart (a run-time stride); without, the groups are adjacent
// and their shared-memory offsets constants.
template <bool kShared>
__global__ void __launch_bounds__(nns::kRingThreads, 2)
streaming_sliced_kernel(const nns::RingArgs a) {
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
  const nns::RingRows rows(1, tpr);
  const int step = 4 * tpr;  // between a thread's four-column groups
  const float* q_row = a.q + (long long)min(rows.row(0), a.m - 1) * a.k;
  float qr[nns::kRingMaxDims];
  if (slices == 1) nns::load_slice(q_row, 0, a.dims, a.k, qr);
  float best_d[1];
  int best_i[1];
  nns::init_best(best_d, best_i, (int)range.lo);
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
      for (int cb = 4 * rows.part; cb < lim; cb += kGroups * step) {
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
#pragma unroll
          for (int j = 0; j < kGroups; ++j) {
            nns::fold4(acc[j], best_d, best_i, (int)(col0 + cb + step * j), lim - cb - step * j);
          }
        }
      }
      ring.release(pos);
    }
  }
  if (kShared) nns::fold_parts(best_d[0], best_i[0], rows, tpr, ring.stage(0));
  nns::write_rows(best_d, best_i, rows, a.m, a.part_d, a.part_i);
}

template <int kK>
nns::RingKernel templated(int q_rows) {
  if (q_rows == 4) return streaming_kernel<kK, 4>;
  if (q_rows == 1) return streaming_kernel<kK, 1>;
  return nullptr;
}

// The instance for the plan, or none: k = 3 and 16 with all k dims per
// stage and 4 or 1 rows per thread; any k sliced, one row per thread, 1-16
// dims per stage and, with more than one slice, at most kGroups four-column
// groups per thread and tile. Stage columns a multiple of 4, 2-8 stages.
// `setup` checks the threads per row.
nns::RingKernel instance(int k, int q_rows, int tpr, int cols, int dims, int stages) {
  if (k < 1 || cols < 4 || cols % 4 || stages < 2 || stages > kMaxStages) return nullptr;
  if (dims == k && k == 3) return templated<3>(q_rows);
  if (dims == k && k == 16) return templated<16>(q_rows);
  if (q_rows != 1 || dims < 1 || dims > nns::kRingMaxDims || dims > k) return nullptr;
  if (dims < k && cols > kGroups * 4 * tpr) return nullptr;
  return tpr > 1 ? streaming_sliced_kernel<true> : streaming_sliced_kernel<false>;
}

cudaError_t setup(int k, int q_rows, int tpr, int cols, int dims, int stages,
                  nns::RingKernel* kernel, size_t* smem, int* slots) {
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
extern "C" int nns_fused_streaming_smem(int k, int q_rows, int tpr, int cols, int dims,
                                        int stages, long long* bytes, int* slots) {
  nns::RingKernel kernel;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, cols, dims, stages, &kernel, &smem, slots);
  *bytes = (long long)smem;
  return (int)e;
}

// q: (m, k) row-major; r_dm: (k, ld) dim-major, columns [0, n) scanned;
// part_d/part_i: (splits, m) scratch; out_d/out_i: (m,). The plan
// (q_rows, tpr, cols, dims, stages) is `ring_plan`'s. Launches one scan over
// (query tiles) x `splits` ref ranges and one merge on `stream` and does not
// synchronize. Returns cudaGetLastError(), or setup's refusal.
extern "C" int nns_fused_streaming(const float* q, const float* r_dm, int m, int k, int n,
                                   long long ld, int splits, int q_rows, int tpr, int cols,
                                   int dims, int stages, float* part_d, int* part_i,
                                   float* out_d, int* out_i, void* stream) {
  nns::RingKernel kernel;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, cols, dims, stages, &kernel, &smem, nullptr);
  if (e != cudaSuccess) return (int)e;
  if (ld < n) return (int)cudaErrorInvalidValue;
  const nns::RingArgs a{q, r_dm, m, k, n, ld, 0, cols, dims, stages, tpr,
                        ld % 4 == 0 && nns::aligned16(r_dm), part_d, part_i};
  return (int)nns::ring_launch(kernel, smem, a, q_rows, splits, out_d, out_i,
                               static_cast<cudaStream_t>(stream));
}
