// Supercell binning of a whole query queue on the card, and the answers
// after its scans: the staging and the answering halves of the v14 queue
// drain (CellListEngine.query_queue).
//
// Replaces, for the drain: the host's counting sort `nns_cells_stage`
// (native/nns_cpu.cpp), which still stages single batches
// (CellListEngine.stage), and the host's per-batch decode and sentinel
// mask (CellListEngine._unstage, _sentinel_risk), which still answer
// single batches and the sharded drain. The JAX package stages and
// decodes on the host; there is no TPU kernel to port.
//
// A queue is B batches of rows, concatenated: batch b holds rows
// [offs[b], offs[b + 1]) of the (rows, 3) f32 queries.
//
// cell_bin_kernel: one thread per row. Its supercell id is the host's own
// double expression, floor(((double)q[d] - mn[d]) / w[d]) clamped to
// [0, D - 1], g = g * D + c, with the subtraction and the division each
// rounded to nearest (no reciprocal, no f32), so the ids equal the host's
// bit for bit. The clamp happens in double before the conversion: a NaN
// coordinate bins to 0 as on the host, and a coordinate so large that the
// quotient passes 2^63 bins to D - 1 where the host's conversion overflows
// to 0; such a row is uncertified in either supercell. An atomic add on the
// (batch, supercell) counter gives the row its slot, so the counters end as
// the per-supercell counts and a slot's order inside its supercell is the
// order in which the atomics land. Each warp folds the counts it saw into
// the batch's largest with one atomic max. The kernel also counts the rows
// with a NaN or an infinity in any coordinate into `nonfinite`, one int32
// right after the maxima, with one atomic add per warp that saw such a row:
// the drain downloads the count with the maxima and raises ValueError when
// it is above 0, before any table is placed or scanned.
//
// cell_place_kernel: once the host has read the maxima and chosen each
// batch's q_max and table offset (`plan`), one thread per row writes the
// row into a dense table at (offset, supercell, slot) and records that
// flat slot, the inverse map the gather reads. `offs` may be a run of the
// queue's offsets: the drain places a large queue part by part, each part
// in a table of its own, and rows index the whole queue either way. Rows
// of a batch with no table (plan q_max 0: too skewed for the scan) get
// `spare`, one past the last slot.
//
// cell_answer_kernel: once a part's scans have run, one thread per row of
// that part's batches answers the row in the caller's order, as the host
// tail (`_unstage`, `_sentinel_risk`) does for each batch. It reads the
// signed winner at the row's slot and decodes it, idx = sg ^ (sg >> 31),
// certified when sg >= 0; a certified row whose f64 distance to the
// PAD_SENTINEL corner, d2 = 0, d2 = d2 + t * t over x, y, z with t = q[d] -
// sentinel (each operation rounded to nearest, as numpy's pass rounds it),
// is <= lim = (2 halo)^2 is uncertified, since a padded halo slot could
// have won its scan. A row of a batch with no table (too skewed for the
// scan) reads no slot: idx 0, uncertified. Each warp folds its certified
// rows into a block count, added once per block and batch into that
// batch's counter; each uncertified row's queue position is appended to
// `bad` through one atomic cursor per warp, in no fixed order.
//
// The three kernels are memory bound and tiny beside the scans: 12 bytes
// read and 8 written per row to bin, 20 read and 20 written to place, 24
// read and 4 written to answer.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocksPerBatch = 1024;
constexpr int kMaxGridY = 65535;

struct Geometry {
  double mn[3];
  double w[3];
};

__global__ void cell_bin_kernel(const float* __restrict__ q, const int* __restrict__ offs,
                                int batches, int d_per_dim, Geometry geo,
                                int* __restrict__ sid, int* __restrict__ pos,
                                int* __restrict__ counts, int* __restrict__ maxima,
                                int* __restrict__ nonfinite) {
  const long long groups = (long long)d_per_dim * d_per_dim * d_per_dim;
  const double top = (double)(d_per_dim - 1);
  int bad = 0;
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    const int lo = offs[b], hi = offs[b + 1];
    int* cnt = counts + (long long)b * groups;
    int most = 0;
    for (int i = lo + blockIdx.x * blockDim.x + threadIdx.x; i < hi;
         i += gridDim.x * blockDim.x) {
      int g = 0;
      int special = 0;
#pragma unroll
      for (int d = 0; d < 3; ++d) {
        const float v = q[3 * (long long)i + d];
        // NaN and +-inf are the floats whose exponent bits are all ones.
        special |= (__float_as_uint(v) & 0x7f800000u) == 0x7f800000u;
        double c = floor(__ddiv_rn(__dsub_rn((double)v, geo.mn[d]), geo.w[d]));
        c = fmin(fmax(c, 0.0), top);
        g = g * d_per_dim + (int)c;
      }
      const int p = atomicAdd(cnt + g, 1);
      sid[i] = g;
      pos[i] = p;
      most = max(most, p + 1);
      bad += special;
    }
    most = __reduce_max_sync(0xffffffffu, most);
    if ((threadIdx.x & 31) == 0 && most > 0) atomicMax(maxima + b, most);
  }
  bad = __reduce_add_sync(0xffffffffu, bad);
  if ((threadIdx.x & 31) == 0 && bad > 0) atomicAdd(nonfinite, bad);
}

__global__ void cell_place_kernel(const float* __restrict__ q, const int* __restrict__ offs,
                                  int batches, const int* __restrict__ sid,
                                  const int* __restrict__ pos,
                                  const long long* __restrict__ plan, long long spare,
                                  float* __restrict__ table, long long* __restrict__ slots) {
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    const int lo = offs[b], hi = offs[b + 1];
    const long long base = plan[2 * b], qm = plan[2 * b + 1];
    for (int i = lo + blockIdx.x * blockDim.x + threadIdx.x; i < hi;
         i += gridDim.x * blockDim.x) {
      if (qm == 0) {
        slots[i] = spare;
        continue;
      }
      const long long s = base + (long long)sid[i] * qm + pos[i];
      const float* src = q + 3 * (long long)i;
      float* dst = table + 3 * s;
      dst[0] = src[0];
      dst[1] = src[1];
      dst[2] = src[2];
      slots[i] = s;
    }
  }
}

__global__ void cell_answer_kernel(const float* __restrict__ q, const int* __restrict__ offs,
                                   int batches, const long long* __restrict__ plan,
                                   const int* __restrict__ win,
                                   const long long* __restrict__ slots, double sentinel,
                                   double lim, int* __restrict__ idx,
                                   int* __restrict__ certified, int* __restrict__ bad,
                                   int* __restrict__ cursor) {
  __shared__ int block_certified;
  const int lane = threadIdx.x & 31;
  for (int b = blockIdx.y; b < batches; b += gridDim.y) {
    const int lo = offs[b], hi = offs[b + 1];
    const bool tabled = plan[2 * b + 1] > 0;
    if (threadIdx.x == 0) block_certified = 0;
    __syncthreads();
    int count = 0;
    // The block walks the batch in steps of whole blocks, so every lane of
    // a warp takes part in its ballot and its reduction.
    for (int start = lo + blockIdx.x * blockDim.x; start < hi;
         start += gridDim.x * blockDim.x) {
      const int i = start + threadIdx.x;
      bool ok = false;
      if (i < hi) {
        int id = 0;
        if (tabled) {
          const int sg = win[slots[i]];
          id = sg ^ (sg >> 31);
          ok = sg >= 0;
        }
        if (ok) {
          const float* r = q + 3 * (long long)i;
          double d2 = 0.0;
#pragma unroll
          for (int d = 0; d < 3; ++d) {
            const double t = __dsub_rn((double)r[d], sentinel);
            d2 = __dadd_rn(d2, __dmul_rn(t, t));
          }
          ok = !(d2 <= lim);
        }
        idx[i] = id;
      }
      const bool listed = i < hi && !ok;
      const unsigned ballot = __ballot_sync(0xffffffffu, listed);
      if (ballot) {
        int base = 0;
        if (lane == 0) base = atomicAdd(cursor, __popc(ballot));
        base = __shfl_sync(0xffffffffu, base, 0);
        if (listed) bad[base + __popc(ballot & ((1u << lane) - 1u))] = i;
      }
      count += ok;
    }
    count = __reduce_add_sync(0xffffffffu, count);
    if (lane == 0 && count > 0) atomicAdd(&block_certified, count);
    __syncthreads();
    if (threadIdx.x == 0 && block_certified > 0) atomicAdd(certified + b, block_certified);
    __syncthreads();  // the next batch resets the block's count
  }
}

dim3 queue_grid(int batches, int max_rows) {
  const int x = (max_rows + kThreads - 1) / kThreads;
  return dim3(x < kMaxBlocksPerBatch ? x : kMaxBlocksPerBatch,
              batches < kMaxGridY ? batches : kMaxGridY);
}

}  // namespace

// queries (rows, 3) f32 and offs (batches + 1) i32 on the card; geo the
// host's six doubles (mn[3], w[3]); counts (batches, D^3) and maxima
// (batches + 1) i32 zero-filled by the caller. Writes sid and pos (rows)
// i32, each batch's largest count at maxima[b] and the number of rows with
// a non-finite coordinate at maxima[batches].
extern "C" int nns_cell_bin(const float* queries, const int* offs, int batches, int max_rows,
                            int d_per_dim, const double* geo, int* sid, int* pos, int* counts,
                            int* maxima, void* stream) {
  if (batches < 0 || max_rows < 0 || d_per_dim < 1 || d_per_dim > 1290) {
    return (int)cudaErrorInvalidValue;
  }
  if (batches == 0 || max_rows == 0) return (int)cudaSuccess;
  Geometry g;
  for (int d = 0; d < 3; ++d) {
    g.mn[d] = geo[d];
    g.w[d] = geo[3 + d];
  }
  cell_bin_kernel<<<queue_grid(batches, max_rows), kThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(queries, offs, batches, d_per_dim, g,
                                                         sid, pos, counts, maxima,
                                                         maxima + batches);
  return (int)cudaGetLastError();
}

// plan (batches, 2) i64 on the card: each batch's first table slot and its
// q_max (0: no table). table (slots, 3) f32 zero-filled by the caller;
// writes slots (rows) i64.
extern "C" int nns_cell_place(const float* queries, const int* offs, int batches, int max_rows,
                              const int* sid, const int* pos, const long long* plan,
                              long long spare, float* table, long long* slots, void* stream) {
  if (batches < 0 || max_rows < 0) return (int)cudaErrorInvalidValue;
  if (batches == 0 || max_rows == 0) return (int)cudaSuccess;
  cell_place_kernel<<<queue_grid(batches, max_rows), kThreads, 0,
                      static_cast<cudaStream_t>(stream)>>>(queries, offs, batches, sid, pos,
                                                           plan, spare, table, slots);
  return (int)cudaGetLastError();
}

// After a part's scans: plan (batches, 2) i64 and offs the part's run (as
// for nns_cell_place), win the part's signed winner per slot, slots (rows)
// i64 as nns_cell_place wrote them, geo the host's two doubles (sentinel,
// lim). Writes idx at the run's rows; adds each batch's certified rows into
// certified (batches) i32 and appends the uncertified rows' positions to
// bad (rows) i32 at the i32 cursor (both zeroed by the caller once per
// queue).
extern "C" int nns_cell_answer(const float* queries, const int* offs, int batches, int max_rows,
                               const long long* plan, const int* win, const long long* slots,
                               const double* geo, int* idx, int* certified, int* bad,
                               int* cursor, void* stream) {
  if (batches < 0 || max_rows < 0) return (int)cudaErrorInvalidValue;
  if (batches == 0 || max_rows == 0) return (int)cudaSuccess;
  cell_answer_kernel<<<queue_grid(batches, max_rows), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(queries, offs, batches, plan, win,
                                                            slots, geo[0], geo[1], idx,
                                                            certified, bad, cursor);
  return (int)cudaGetLastError();
}
