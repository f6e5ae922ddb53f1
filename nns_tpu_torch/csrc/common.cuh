// Helpers shared by the port's CUDA kernels.
//
// Winners are (d2, id) pairs reduced by LEXICOGRAPHIC min: smaller d2, then
// smaller id. The order is total, associative and commutative, so the order
// in which threads, warps and blocks meet cannot change the answer. With
// id = reference index this is the brute-force family's lowest-index rule.
#pragma once

#include <climits>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace nns {

constexpr int kWarp = 32;

__device__ __forceinline__ bool lex_less(float da, int ia, float db, int ib) {
  return da < db || (da == db && ia < ib);
}

// Butterfly reduce of one (d2, id) pair per lane; every lane ends with the
// warp's winner.
__device__ __forceinline__ void warp_argmin(float& d, int& i) {
#pragma unroll
  for (int off = kWarp / 2; off > 0; off >>= 1) {
    const float od = __shfl_xor_sync(0xffffffffu, d, off);
    const int oi = __shfl_xor_sync(0xffffffffu, i, off);
    if (lex_less(od, oi, d, i)) {
      d = od;
      i = oi;
    }
  }
}

// One squared-difference term, rounded exactly as the plain PyTorch
// versions round it: sub, mul and add each rounded to nearest, never fused
// into an FMA (the library is also built with -fmad=false).
__device__ __forceinline__ float add_sq_diff(float acc, float a, float b) {
  const float diff = __fsub_rn(a, b);
  return __fadd_rn(acc, __fmul_rn(diff, diff));
}

// (inf, first) per row. A kernel whose threads keep winners with a strict <
// passes the lowest column of its range as `first`: where every distance of
// the range is +inf (coordinates whose squares overflow), nothing beats the
// start, and the range's answer must still be its lowest index.
template <int kQT>
__device__ __forceinline__ void init_best(float (&best_d)[kQT], int (&best_i)[kQT],
                                          int first = INT_MAX) {
#pragma unroll
  for (int qi = 0; qi < kQT; ++qi) {
    best_d[qi] = CUDART_INF_F;
    best_i[qi] = first;
  }
}

// Stage kQT query rows q0.. of the (m, k) row-major queries in shared memory
// as (kQT, k), zero rows past m. The caller synchronizes.
template <int kQT, int kThreads>
__device__ __forceinline__ void stage_queries(const float* __restrict__ q, int q0,
                                              int m, int k, float* q_s) {
  for (int t = threadIdx.x; t < kQT * k; t += kThreads) {
    const int row = q0 + t / k;
    q_s[t] = row < m ? q[(long long)row * k + t % k] : 0.0f;
  }
}

// Scan columns lo + threadIdx.x, lo + threadIdx.x + kThreads, ... < hi of
// the dim-major refs (k, ld) against kQT queries, q_at(qi, d) giving query
// qi's coordinate d. Each column's k coordinates are read once (coalesced
// across the warp) and feed kQT register accumulators; the thread folds
// each column into its running (best_d, best_i) winners.
template <int kQT, int kThreads, typename QAt>
__device__ __forceinline__ void scan_dim_major(const float* __restrict__ r_dm,
                                               long long ld, int k, long long lo,
                                               long long hi, QAt q_at,
                                               float (&best_d)[kQT],
                                               int (&best_i)[kQT]) {
  for (long long j = lo + threadIdx.x; j < hi; j += kThreads) {
    float acc[kQT];
#pragma unroll
    for (int qi = 0; qi < kQT; ++qi) acc[qi] = 0.0f;
    for (int d = 0; d < k; ++d) {
      const float rv = r_dm[(long long)d * ld + j];
#pragma unroll
      for (int qi = 0; qi < kQT; ++qi) acc[qi] = add_sq_diff(acc[qi], q_at(qi, d), rv);
    }
#pragma unroll
    for (int qi = 0; qi < kQT; ++qi) {
      if (lex_less(acc[qi], (int)j, best_d[qi], best_i[qi])) {
        best_d[qi] = acc[qi];
        best_i[qi] = (int)j;
      }
    }
  }
}

// Block-wide winner of each of the kQT queries: a warp butterfly, then
// thread qi < kQT folds the warps' winners of query qi into (d, i). Every
// thread of the block must call it; it synchronizes before returning, so it
// may be called again in a loop.
template <int kQT, int kThreads>
__device__ __forceinline__ void block_argmin(float (&best_d)[kQT], int (&best_i)[kQT],
                                             float& d, int& i) {
  constexpr int kWarps = kThreads / kWarp;
  __shared__ float red_d[kWarps][kQT];
  __shared__ int red_i[kWarps][kQT];
  const int warp = threadIdx.x / kWarp;
  const int lane = threadIdx.x % kWarp;
#pragma unroll
  for (int qi = 0; qi < kQT; ++qi) {
    warp_argmin(best_d[qi], best_i[qi]);
    if (lane == 0) {
      red_d[warp][qi] = best_d[qi];
      red_i[warp][qi] = best_i[qi];
    }
  }
  __syncthreads();
  if (threadIdx.x < kQT) {
    const int qi = threadIdx.x;
    d = red_d[0][qi];
    i = red_i[0][qi];
    for (int w = 1; w < kWarps; ++w) {
      if (lex_less(red_d[w][qi], red_i[w][qi], d, i)) {
        d = red_d[w][qi];
        i = red_i[w][qi];
      }
    }
  }
  __syncthreads();
}

// One thread per query: lexicographic min over its S partial winners in the
// (S, m) scratch.
static __global__ void merge_partials_kernel(const float* __restrict__ part_d,
                                             const int* __restrict__ part_i, int m,
                                             int splits, float* __restrict__ out_d,
                                             int* __restrict__ out_i) {
  const int row = blockIdx.x * blockDim.x + threadIdx.x;
  if (row >= m) return;
  float d = CUDART_INF_F;
  int i = INT_MAX;
  for (int s = 0; s < splits; ++s) {
    const float pd = part_d[(long long)s * m + row];
    const int pi = part_i[(long long)s * m + row];
    if (lex_less(pd, pi, d, i)) {
      d = pd;
      i = pi;
    }
  }
  out_d[row] = d;
  out_i[row] = i;
}

inline cudaError_t launch_merge(const float* part_d, const int* part_i, int m,
                                int splits, float* out_d, int* out_i,
                                cudaStream_t st) {
  merge_partials_kernel<<<(m + 255) / 256, 256, 0, st>>>(part_d, part_i, m, splits,
                                                         out_d, out_i);
  return cudaGetLastError();
}

// Opt a kernel in to more than the default 48 KB of dynamic shared memory.
template <typename Kernel>
inline cudaError_t allow_smem(Kernel kernel, size_t bytes) {
  if (bytes <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)bytes);
}

// Resident blocks of `kernel` per SM at kThreads threads and `smem` bytes of
// dynamic shared memory, times the SMs of the current device: the size of a
// persistent grid.
template <typename Kernel>
inline cudaError_t grid_slots(Kernel kernel, int threads, size_t smem, int* slots) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = allow_smem(kernel, smem);
  if (e == cudaSuccess) {
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, smem);
  }
  if (e == cudaSuccess && per_sm < 1) e = cudaErrorInvalidConfiguration;
  *slots = per_sm * sms;
  return e;
}

// ---------------------------------------------------------------------------
// Bulk asynchronous copies (cp.async.bulk, no tensor map) completing on an
// mbarrier in shared memory. One thread arms a stage's barrier with the
// bytes it expects and issues the stage's copies; every thread waits on the
// barrier's phase parity. Source, destination and size must be multiples of
// 16 bytes.
// ---------------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// One thread initialises the barriers (one arrival each), then the block
// synchronizes before any thread uses them.
__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// The arming thread's arrival, expecting `bytes` from the stage's copies.
__device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Spin until the barrier's phase of parity `parity` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar, unsigned parity) {
  asm volatile(
      "{\n"
      ".reg .pred P1;\n"
      "LAB_WAIT:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P1, [%0], %1;\n"
      "@P1 bra DONE;\n"
      "bra LAB_WAIT;\n"
      "DONE:\n"
      "}\n" ::"r"(smem_u32(bar)),
      "r"(parity)
      : "memory");
}

// Order the block's earlier generic-proxy reads of shared memory before the
// async proxy's next writes to it (a stage is refilled after it was read).
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(smem_u32(dst)), "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

inline bool aligned16(const void* p) {
  return reinterpret_cast<unsigned long long>(p) % 16 == 0;
}

// ---------------------------------------------------------------------------
// A producer/consumer ring (v3 and v5): one producer warp fills `stages`
// shared-memory stages, kRingConsumers threads (8 warps) read them. Each
// stage has a FULL mbarrier (completed by the producer: the bulk copies'
// transaction bytes after one arrival, or, on the plain-load path, the 32
// producer lanes' arrivals after their stores) and an EMPTY mbarrier (one
// arrival per consumer warp once the warp is done with the stage). No
// block-wide barrier after the start: the producer runs ahead by up to
// `stages` items.
// ---------------------------------------------------------------------------

constexpr int kRingConsumers = 256;
constexpr int kRingThreads = kRingConsumers + kWarp;  // + the producer warp

__device__ __forceinline__ void mbar_init_count(unsigned long long* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_u32(bar)), "r"(count)
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// A plain arrival (release: the arriving thread's earlier stores and loads
// are ordered before it).
__device__ __forceinline__ void mbar_arrive(unsigned long long* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_u32(bar)) : "memory");
}

// Dynamic shared memory of a ring: 2 x stages mbarriers, then the stages.
inline size_t ring_smem_bytes(int stages, long long stage_floats) {
  return 16 * (size_t)stages + 4 * (size_t)stages * (size_t)stage_floats;
}

// A ring's stage and the parity of its current phase, advanced in step by
// the producer and by every consumer.
struct RingPos {
  int s = 0;
  unsigned phase = 0;
  __device__ void next(int stages) {
    if (++s == stages) {
      s = 0;
      phase ^= 1;
    }
  }
};

struct StageRing {
  unsigned long long* full;
  unsigned long long* empty;
  float* base;
  int stages;
  long long stage_floats;

  __device__ StageRing(unsigned char* smem, int stages_, long long stage_floats_)
      : stages(stages_), stage_floats(stage_floats_) {
    full = reinterpret_cast<unsigned long long*>(smem);
    empty = full + stages_;
    base = reinterpret_cast<float*>(smem + 16 * stages_);
  }
  __device__ float* stage(int s) const { return base + (size_t)s * stage_floats; }
  // Every thread calls it once, before the roles split.
  __device__ void start(bool bulk) const {
    if (threadIdx.x == 0) {
      for (int s = 0; s < stages; ++s) {
        mbar_init_count(full + s, bulk ? 1 : kWarp);
        mbar_init_count(empty + s, kRingConsumers / kWarp);
      }
    }
    __syncthreads();
  }
  // Producer warp: for each of `items` items, wait until its stage is free,
  // then fill(it, stage, full barrier, lane). Every lane calls it.
  template <typename Fill>
  __device__ void produce(long long items, Fill fill) const {
    const int lane = threadIdx.x % kWarp;
    RingPos pos;
    for (long long it = 0; it < items; ++it, pos.next(stages)) {
      mbar_wait(empty + pos.s, pos.phase ^ 1);  // a fresh barrier passes parity 1
      fill(it, stage(pos.s), full + pos.s, lane);
    }
  }
  // Consumer: the stage at pos once it is full; then release it.
  __device__ const float* acquire(const RingPos& pos) const {
    mbar_wait(full + pos.s, pos.phase);
    return stage(pos.s);
  }
  __device__ void release(const RingPos& pos) const {
    __syncwarp();
    if (threadIdx.x % kWarp == 0) mbar_arrive(empty + pos.s);
  }
};

// Producer lanes: copy `floats` floats from src to the stage dst and complete
// `full` (16-byte bulk copies where `bulk`, one per row issued by lanes
// 0..rows-1, each row `bytes` long at dst + row * dst_pitch / src + row *
// src_pitch; else plain loads by all lanes and one arrival each).
__device__ __forceinline__ void fill_rows(float* dst, long long dst_pitch, const float* src,
                                          long long src_pitch, int rows, int row_floats,
                                          bool bulk, unsigned long long* full, int lane) {
  if (bulk) {
    const unsigned bytes = (unsigned)((row_floats + 3) / 4 * 16);
    fence_proxy_async();
    if (lane == 0) mbar_expect_tx(full, bytes * rows);
    __syncwarp();
    if (lane < rows) bulk_copy(dst + lane * dst_pitch, src + lane * src_pitch, bytes, full);
  } else {
    for (int e = lane; e < rows * row_floats; e += kWarp) {
      dst[(e / row_floats) * dst_pitch + e % row_floats] =
          src[(e / row_floats) * src_pitch + e % row_floats];
    }
    mbar_arrive(full);
  }
}

// The squared distances of kQ query rows (qr) to 4 ref columns at g, each
// sub, mul and add rounded on its own, in ascending dimension order:
// d2 = 0 + diff^2 + ... (0 + diff^2 is diff^2 exactly). Dim-major: the
// float4 at g + d * pitch holds dimension d of the 4 columns. Point-major:
// the 4 points' kK coordinates lie contiguous at g (one 16-byte load per 4
// coordinates: 3 loads for 4 points at k = 3). g is 16-byte aligned, and
// every thread of a warp reads the same addresses (a broadcast).
template <int kK, int kQ, bool kPointMajor>
__device__ __forceinline__ void score4(const float* g, int pitch, const float (&qr)[kQ][kK],
                                       float (&acc)[kQ][4]) {
#pragma unroll
  for (int i = 0; i < kK; ++i) {
    const float4 r = *reinterpret_cast<const float4*>(kPointMajor ? g + 4 * i : g + i * pitch);
    const float rv[4] = {r.x, r.y, r.z, r.w};
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int c = kPointMajor ? (4 * i + e) / kK : e;
      const int d = kPointMajor ? (4 * i + e) % kK : i;
#pragma unroll
      for (int qi = 0; qi < kQ; ++qi) {
        const float diff = __fsub_rn(qr[qi][d], rv[e]);
        acc[qi][c] = d == 0 ? __fmul_rn(diff, diff) : __fadd_rn(acc[qi][c], __fmul_rn(diff, diff));
      }
    }
  }
}

// Fold 4 consecutive columns j0.. (the first `valid` real) into each row's
// running winner. A thread visits its columns in ascending order, so a
// strict < keeps the lowest index among equal distances.
template <int kQ>
__device__ __forceinline__ void fold4(const float (&acc)[kQ][4], float (&best_d)[kQ],
                                      int (&best_i)[kQ], int j0, int valid) {
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

// A consumer thread's place in its block's query tile. `tpr` threads share
// each row (1 where a thread holds several rows), each scoring its own part
// of the columns: consumer t holds rows row0 + qi * stride + t % stride (qi
// < its rows per thread) and takes part t / stride, with stride =
// kRingConsumers / tpr rows. The threads of a warp hold distinct rows while
// stride >= 32, so they read the same columns (a broadcast). An instance
// that never shares rows passes tpr as the constant 1, so that part and
// stride fold away (a run-time 0 costs a register in instances held at 96).
struct RingRows {
  int row0, stride, part, lane_row;
  __device__ RingRows(int q_rows, int tpr) {
    stride = kRingConsumers / tpr;
    row0 = blockIdx.x * stride * q_rows;
    part = tpr == 1 ? 0 : (int)threadIdx.x / stride;
    lane_row = tpr == 1 ? (int)threadIdx.x : (int)threadIdx.x % stride;
  }
  __device__ int row(int qi) const { return row0 + qi * stride + lane_row; }
};

// The thread's rows of the (m, kK) queries (clamped to the last row) into
// registers.
template <int kK, int kQ>
__device__ __forceinline__ void load_rows(const float* __restrict__ q, const RingRows& rows, int m,
                                          float (&qr)[kQ][kK]) {
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    const long long row = min(rows.row(qi), m - 1);
#pragma unroll
    for (int d = 0; d < kK; ++d) qr[qi][d] = q[row * kK + d];
  }
}

// Where tpr threads share a row (one row per thread): fold their winners
// into part 0's, lexicographically, so the lowest index among equal
// distances wins. Goes through `scratch`, 2 x kRingConsumers words of the
// ring's stages, which are free once every consumer is done with the last
// stage; a named barrier (the producer warp has left) orders it. Every
// consumer calls it.
__device__ __forceinline__ void fold_parts(float& d, int& i, const RingRows& rows, int tpr,
                                           float* scratch) {
  int* scratch_i = reinterpret_cast<int*>(scratch + kRingConsumers);
  asm volatile("bar.sync 1, %0;\n" ::"n"(kRingConsumers) : "memory");
  scratch[threadIdx.x] = d;
  scratch_i[threadIdx.x] = i;
  asm volatile("bar.sync 1, %0;\n" ::"n"(kRingConsumers) : "memory");
  if (rows.part == 0) {
    for (int p = 1; p < tpr; ++p) {
      const int t = p * rows.stride + (int)threadIdx.x;
      if (lex_less(scratch[t], scratch_i[t], d, i)) {
        d = scratch[t];
        i = scratch_i[t];
      }
    }
  }
}

// Each row's winner (part 0's) to its split's row of the (S, m) table.
template <int kQ>
__device__ __forceinline__ void write_rows(const float (&best_d)[kQ], const int (&best_i)[kQ],
                                           const RingRows& rows, int m, float* part_d,
                                           int* part_i) {
  if (rows.part) return;
#pragma unroll
  for (int qi = 0; qi < kQ; ++qi) {
    const int row = rows.row(qi);
    if (row < m) {
      part_d[(long long)blockIdx.y * m + row] = best_d[qi];
      part_i[(long long)blockIdx.y * m + row] = best_i[qi];
    }
  }
}

// A ring kernel's arguments: (m, k) row-major queries q; refs r with n
// columns (v5: dim-major rows of pitch ld) or n points (v3: point-major, ld
// = k); the block's range of cols_per_split, in stages of `cols` columns or
// points and `dims` dimensions; `stages` stages; `tpr` threads per query row;
// bulk copies or plain loads; the (splits, m) winner tables.
struct RingArgs {
  const float* q;
  const float* r;
  int m, k, n;
  long long ld;
  int cols_per_split, cols, dims, stages, tpr;
  bool bulk;
  float* part_d;
  int* part_i;
};

using RingKernel = void (*)(RingArgs);

// The block's ref range [lo, hi) and its stages of `cols` columns or points.
struct RingRange {
  long long lo, hi;
  int n_tiles;
  __device__ explicit RingRange(const RingArgs& a) {
    lo = (long long)blockIdx.y * a.cols_per_split;
    hi = min((long long)a.n, lo + a.cols_per_split);
    n_tiles = hi > lo ? (int)((hi - lo + a.cols - 1) / a.cols) : 0;
  }
  // Stage t's first column c0 and its column count.
  __device__ int tile(const RingArgs& a, int t, long long& c0) const {
    c0 = lo + (long long)t * a.cols;
    return (int)min((long long)a.cols, hi - c0);
  }
};

// Threads per query row that a ring plan may take: a power of two up to a
// warp, and 1 where a thread holds several rows. Sharing rows needs stages
// of at least 2 x kRingConsumers words in all for `fold_parts`.
inline bool ring_tpr_ok(int q_rows, int tpr, size_t smem, int stages) {
  if (tpr < 1 || tpr > kWarp || (tpr & (tpr - 1)) || (q_rows > 1 && tpr > 1)) return false;
  return tpr == 1 || smem - 16 * (size_t)stages >= 8 * (size_t)kRingConsumers;
}

// Launch `kernel` (dynamic shared memory `smem`) over (query tiles of
// kRingConsumers x q_rows / tpr rows) x `splits` ref ranges of whole stages,
// so that every stage starts where a whole stage of a range would, then the
// merge of the (splits, m) table into out_d/out_i. Returns
// cudaGetLastError(), or cudaErrorInvalidValue for a grid it cannot make.
inline cudaError_t ring_launch(RingKernel kernel, size_t smem, RingArgs a, int q_rows, int splits,
                               float* out_d, int* out_i, cudaStream_t st) {
  if (splits < 1 || splits > 65535 || a.m < 1 || a.n < 1) return cudaErrorInvalidValue;
  const int per_split = (a.n + splits - 1) / splits;
  a.cols_per_split = (per_split + a.cols - 1) / a.cols * a.cols;
  const int rows = kRingConsumers / a.tpr * q_rows;
  kernel<<<dim3((a.m + rows - 1) / rows, splits), kRingThreads, smem, st>>>(a);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return launch_merge(a.part_d, a.part_i, a.m, splits, out_d, out_i, st);
}

// The checks every ring plan shares: the kernel, its dynamic shared memory
// within the device's opt-in, and its grid slots where `slots` is given (the
// host asks once per plan); a launch passes none and only opts the kernel
// in, as an occupancy query per launch costs host time that a launch of a
// few rows would notice.
inline cudaError_t ring_setup(const void* kernel, size_t smem, int* slots) {
  if (kernel == nullptr) return cudaErrorInvalidValue;
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) {
    e = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  }
  if (e != cudaSuccess) return e;
  if (smem > (size_t)optin) return cudaErrorInvalidValue;
  if (slots == nullptr) return allow_smem(kernel, smem);
  return grid_slots(kernel, kRingThreads, smem, slots);
}

}  // namespace nns
