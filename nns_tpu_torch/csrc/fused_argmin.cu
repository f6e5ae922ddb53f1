// v4 fused distance + argmin over dim-major reference points: every engine's
// exact fallback.
//
// Replaces: nns_tpu/kernels/pallas_fused.py `_fused_kernel` (launched by
// `_fused_on_prepared`): a (TM, TN) direct-f32 distance tile per grid step
// over auto-pipelined (k, tile_n) dim-major ref tiles, per-row min with the
// lowest index, strict-< carry over the ref tiles.
//
// Bound on the H100: operations. Each (query, ref) pair costs k sub, k mul,
// k add and a compare in f32, each rounded on its own (no FMA, so kernel and
// plain version stay bit-equal): about 35-45% of the f32 peak at most
// (utils/bounds.py). The exact fallback calls it with 8-64 queries against
// 1M refs, where a launch is a few microseconds of work: there launches,
// host time and the fold of the ranges' winners set the time.
//
// Design: the producer/consumer ring of common.cuh (StageRing), as v5 runs
// it, with v4's own producer and the fold inside the launch.
// - Grid = (query tiles of 256 x q_rows / tpr rows) x (S ref ranges of whole
//   stages), as many blocks as fit at once. Each consumer thread holds its
//   query rows in registers (k = 3 and 16 template parameters with 4 or 1
//   rows per thread; any other k one row, the contraction in slices of at
//   most 16 dims, so shared memory does not grow with k and every k runs).
//   Below 256 rows 2-32 threads share each row. The plan has one home,
//   `fused_plan` in nns_tpu_torch/kernels/fused.py (v5's `ring_plan` with
//   stages of at most 256 columns, a tensor-map box).
// - The producer warp copies each (dims x cols) box of the (k, ld) refs with
//   one cp.async.bulk.tensor.2d from a tensor map (a __grid_constant__
//   parameter, encoded on the host by `nns_fused_argmin_tensor_map`),
//   completing on the stage's full mbarrier: the Hopper form of the TPU
//   kernel's (k, tile_n) BlockSpec. The map is n columns wide, so a box past
//   n is zero-filled and those columns are never scored. A pitch that is not
//   a multiple of 4 floats or a misaligned base has no map: the producer
//   lanes load the stage themselves (v5's plain-load path).
// - One launch. Each thread starts at (inf, its range's first column) and
//   keeps winners with a strict <, so a row whose every distance is +inf
//   answers index 0. The ranges' winners meet in common.cuh `ticket_fold`: a
//   64-bit atomicMin per row on (d2 bits, index), then the last block of the
//   query tile (an atomic ticket after a __threadfence) writes the answers
//   and resets the tile's state. No second kernel.
#include <cstring>

#include "common.cuh"

namespace {

constexpr int kMaxStages = 8;
constexpr int kMaxBoxCols = 256;  // a tensor map's box: at most 256 per dimension

using Kernel = void (*)(nns::RingArgs, CUtensorMap, nns::TicketFold);

// k = kK, kQ rows per consumer thread, all kK dims in each stage.
template <int kK, int kQ>
__global__ void __launch_bounds__(nns::kRingThreads, 2)
fused_argmin_kernel(const nns::RingArgs a, const __grid_constant__ CUtensorMap map,
                    const nns::TicketFold f) {
  extern __shared__ __align__(128) unsigned char smem[];
  const nns::StageRing ring(smem + nns::ring_tma_pad(a.stages), a.stages,
                            (long long)kK * a.cols);
  const nns::RingRange range(a);
  ring.start(a.bulk);
  if (threadIdx.x >= nns::kRingConsumers) {
    if (a.bulk) {
      nns::produce_tensor_tiles(ring, a, range, 1, map);
    } else {
      nns::produce_dim_major(ring, a, range, 1);
    }
    return;
  }
  const int tpr = kQ == 1 ? a.tpr : 1;
  const nns::RingRows rows(kQ, tpr);
  float best_d[kQ];
  int best_i[kQ];
  nns::consume_dim_major<kK, kQ>(ring, a, range, rows, tpr, best_d, best_i);
  nns::ticket_fold(best_d, best_i, rows, a, f);
}

// Any k at run time, one row per consumer thread, the contraction in slices
// of `dims` dimensions. kShared: tpr > 1 threads share each row.
template <bool kShared>
__global__ void __launch_bounds__(nns::kRingThreads, 2)
fused_argmin_sliced_kernel(const nns::RingArgs a, const __grid_constant__ CUtensorMap map,
                           const nns::TicketFold f) {
  extern __shared__ __align__(128) unsigned char smem[];
  const nns::StageRing ring(smem + nns::ring_tma_pad(a.stages), a.stages,
                            (long long)a.dims * a.cols);
  const nns::RingRange range(a);
  const int slices = (a.k + a.dims - 1) / a.dims;
  ring.start(a.bulk);
  if (threadIdx.x >= nns::kRingConsumers) {
    if (a.bulk) {
      nns::produce_tensor_tiles(ring, a, range, slices, map);
    } else {
      nns::produce_dim_major(ring, a, range, slices);
    }
    return;
  }
  const nns::RingRows rows(1, kShared ? a.tpr : 1);
  float best_d[1];
  int best_i[1];
  nns::consume_dim_major_sliced<kShared>(ring, a, range, rows, slices, best_d, best_i);
  nns::ticket_fold(best_d, best_i, rows, a, f);
}

template <int kK>
Kernel templated(int q_rows) {
  if (q_rows == 4) return fused_argmin_kernel<kK, 4>;
  if (q_rows == 1) return fused_argmin_kernel<kK, 1>;
  return nullptr;
}

// The instance for the plan, or none: k = 3 and 16 with all k dims per
// stage and 4 or 1 rows per thread; any k sliced, one row per thread, 1-16
// dims per stage and, with more than one slice, at most kRingGroups
// four-column groups per thread and stage. Stage columns a multiple of 4 up
// to one box, stages of a multiple of 128 bytes (each 128-byte aligned for
// the tensor copies), 2-8 stages. `setup` checks the threads per row.
Kernel instance(int k, int q_rows, int tpr, int cols, int dims, int stages) {
  if (k < 1 || cols < 4 || cols % 4 || cols > kMaxBoxCols || dims * cols % 32 || stages < 2 ||
      stages > kMaxStages) {
    return nullptr;
  }
  if (dims == k && k == 3) return templated<3>(q_rows);
  if (dims == k && k == 16) return templated<16>(q_rows);
  if (q_rows != 1 || dims < 1 || dims > nns::kRingMaxDims || dims > k) return nullptr;
  if (dims < k && cols > nns::kRingGroups * 4 * tpr) return nullptr;
  return tpr > 1 ? fused_argmin_sliced_kernel<true> : fused_argmin_sliced_kernel<false>;
}

cudaError_t setup(int k, int q_rows, int tpr, int cols, int dims, int stages, Kernel* kernel,
                  size_t* smem, int* slots) {
  *kernel = instance(k, q_rows, tpr, cols, dims, stages);
  *smem = nns::ring_tma_pad(stages) + nns::ring_smem_bytes(stages, (long long)dims * cols);
  if (!nns::ring_tpr_ok(q_rows, tpr, *smem, stages)) *kernel = nullptr;
  return nns::ring_setup((const void*)*kernel, *smem, slots);
}

// cuTensorMapEncodeTiled, looked up through the CUDA runtime: the library
// does not link libcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

cudaError_t encode_tiled(EncodeTiled* fn) {
  static EncodeTiled cached = nullptr;
  if (cached == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess) return e;
    if (found != cudaDriverEntryPointSuccess || p == nullptr) return cudaErrorNotSupported;
    cached = reinterpret_cast<EncodeTiled>(p);
  }
  *fn = cached;
  return cudaSuccess;
}

cudaError_t launch(const float* q, const float* r_dm, const void* map, int m, int k, int n,
                   long long ld, int splits, int q_rows, int tpr, int cols, int dims, int stages,
                   unsigned long long* keys, unsigned* tickets, float* out_d, int* out_i,
                   cudaStream_t st) {
  Kernel kernel;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, cols, dims, stages, &kernel, &smem, nullptr);
  if (e != cudaSuccess) return e;
  if (ld < n || (splits > 1 && (keys == nullptr || tickets == nullptr))) {
    return cudaErrorInvalidValue;
  }
  CUtensorMap tm;
  if (map != nullptr) {
    std::memcpy(&tm, map, sizeof(tm));
  } else {
    std::memset(&tm, 0, sizeof(tm));
  }
  nns::RingArgs a{q, r_dm, m, k, n, ld, 0, cols, dims, stages, tpr, map != nullptr, out_d, out_i};
  dim3 grid;
  if (!nns::ring_grid(a, q_rows, splits, &grid)) return cudaErrorInvalidValue;
  kernel<<<grid, nns::kRingThreads, smem, st>>>(a, tm, nns::TicketFold{keys, tickets});
  return cudaGetLastError();
}

}  // namespace

// The dynamic shared memory (bytes) and the grid slots (resident blocks per
// SM times SMs) of the plan (k, q_rows, tpr, cols, dims, stages), or the
// error `setup` refuses it with (cudaErrorInvalidValue: no instance, or
// more shared memory than a block gets).
extern "C" int nns_fused_argmin_smem(int k, int q_rows, int tpr, int cols, int dims, int stages,
                                     long long* bytes, int* slots) {
  Kernel kernel;
  size_t smem = 0;
  const cudaError_t e = setup(k, q_rows, tpr, cols, dims, stages, &kernel, &smem, slots);
  *bytes = (long long)smem;
  return (int)e;
}

// Encode into `out` (sizeof(CUtensorMap) = 128 bytes) the tensor map of the
// dim-major refs r_dm (k, ld) over columns [0, n), with boxes of `cols`
// columns x `dims` dimensions: f32, no swizzle, zero fill past n and k.
// cudaErrorInvalidValue where a map cannot describe the view (base not
// 16-byte aligned, pitch not a multiple of 4 floats, a box past 256) or
// cuTensorMapEncodeTiled refuses it.
extern "C" int nns_fused_argmin_tensor_map(const float* r_dm, int k, int n, long long ld, int cols,
                                           int dims, void* out) {
  if (!nns::aligned16(r_dm) || ld % 4 || ld < n || n < 1 || k < 1 || cols < 4 || cols % 4 ||
      cols > kMaxBoxCols || dims < 1 || dims > kMaxBoxCols) {
    return (int)cudaErrorInvalidValue;
  }
  EncodeTiled encode;
  const cudaError_t e = encode_tiled(&encode);
  if (e != cudaSuccess) return (int)e;
  alignas(64) CUtensorMap map;
  const cuuint64_t size[2] = {(cuuint64_t)n, (cuuint64_t)k};
  const cuuint64_t stride[1] = {(cuuint64_t)ld * sizeof(float)};
  const cuuint32_t box[2] = {(cuuint32_t)cols, (cuuint32_t)dims};
  const cuuint32_t step[2] = {1, 1};
  const CUresult r = encode(&map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(r_dm),
                            size, stride, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
                            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (r != CUDA_SUCCESS) return (int)cudaErrorInvalidValue;
  std::memcpy(out, &map, sizeof(map));
  return (int)cudaSuccess;
}

// q: (m, k) row-major; r_dm: (k, ld) dim-major, columns [0, n) scanned;
// map: `nns_fused_argmin_tensor_map`'s for (r_dm, k, n, ld, cols, dims), or
// null for the plain-load producer; the plan (q_rows, tpr, cols, dims,
// stages) is `fused_plan`'s, over `splits` ref ranges; keys (>= m words,
// all ones) and tickets (>= one per query tile, zero) are the stream's fold
// state, returned as they came (unused with one range); out_d/out_i: (m,).
// Launches one kernel on `stream` on CUDA device `device` (the caller's
// current device is restored) and does not synchronize. Returns
// cudaGetLastError(), or setup's refusal.
extern "C" int nns_fused_argmin(const float* q, const float* r_dm, const void* map, int m, int k,
                                int n, long long ld, int splits, int q_rows, int tpr, int cols,
                                int dims, int stages, unsigned long long* keys, unsigned* tickets,
                                float* out_d, int* out_i, int device, void* stream) {
  int current = 0;
  cudaError_t e = cudaGetDevice(&current);
  if (e == cudaSuccess && current != device) e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  e = launch(q, r_dm, map, m, k, n, ld, splits, q_rows, tpr, cols, dims, stages, keys, tickets,
             out_d, out_i, static_cast<cudaStream_t>(stream));
  if (current != device) {
    const cudaError_t back = cudaSetDevice(current);
    if (e == cudaSuccess) e = back;
  }
  return (int)e;
}
