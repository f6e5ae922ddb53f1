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
// more than the 50 MB L2, so each batch streams it from device memory,
// while the distance work (2744 x 16 x 1280 pairs, 56M) is small for the
// CUDA cores.
//
// Design: one block per supercell, so each halo byte is read from device
// memory once per batch, coalesced, into a shared-memory tile of kTR slots
// (3 coordinate rows + ids); the block loops over tiles up to R_max (which
// may reach max_candidates = 200000). Warps own query slots (qi = warp,
// warp + 8, ...), lanes stride over the tile's slots, and a warp butterfly
// reduces the lanes' (d2, id) winners; lane 0 folds it into the slot's
// carry in shared memory (each slot has one owner warp, so no races). The
// winner is the lexicographic (d2, global id) min over all slots, which is
// the JAX kernel's rule whenever R_max fits one of its halo tiles. QM is at
// most kMaxQM = 2048 (CellListEngine.q_max_limit); the carry for that many
// slots lives in shared memory.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / nns::kWarp;
constexpr int kTR = 1024;     // halo slots per shared-memory tile
constexpr int kMaxQM = 2048;  // query slots per supercell

__global__ void __launch_bounds__(kThreads)
cell_scan_kernel(const float* __restrict__ dense_q,
                 const float* __restrict__ halo_dm,
                 const int* __restrict__ halo_ids, int qm, int r_max,
                 float halo2, float* __restrict__ out_min,
                 int* __restrict__ out_sgid) {
  __shared__ float hx[kTR], hy[kTR], hz[kTR];
  __shared__ int hid[kTR];
  __shared__ float carry_d[kMaxQM];
  __shared__ int carry_i[kMaxQM];

  const long long g = blockIdx.x;
  const float* q = dense_q + g * qm * 3;
  const float* h = halo_dm + g * 3 * r_max;
  const int* ids = halo_ids + g * r_max;
  const int warp = threadIdx.x / nns::kWarp;
  const int lane = threadIdx.x % nns::kWarp;

  for (int t = threadIdx.x; t < qm; t += kThreads) {
    carry_d[t] = CUDART_INF_F;
    carry_i[t] = INT_MAX;
  }
  for (int base = 0; base < r_max; base += kTR) {
    const int len = min(kTR, r_max - base);
    __syncthreads();  // the previous tile is consumed; carry init is visible
    for (int t = threadIdx.x; t < len; t += kThreads) {
      hx[t] = h[base + t];
      hy[t] = h[r_max + base + t];
      hz[t] = h[2 * r_max + base + t];
      hid[t] = ids[base + t];
    }
    __syncthreads();
    for (int qi = warp; qi < qm; qi += kWarps) {
      const float qx = q[qi * 3 + 0];
      const float qy = q[qi * 3 + 1];
      const float qz = q[qi * 3 + 2];
      float bd = CUDART_INF_F;
      int bi = INT_MAX;
      for (int t = lane; t < len; t += nns::kWarp) {
        float d2 = nns::add_sq_diff(0.0f, qx, hx[t]);
        d2 = nns::add_sq_diff(d2, qy, hy[t]);
        d2 = nns::add_sq_diff(d2, qz, hz[t]);
        if (nns::lex_less(d2, hid[t], bd, bi)) {
          bd = d2;
          bi = hid[t];
        }
      }
      nns::warp_argmin(bd, bi);
      if (lane == 0 && nns::lex_less(bd, bi, carry_d[qi], carry_i[qi])) {
        carry_d[qi] = bd;
        carry_i[qi] = bi;
      }
    }
  }
  __syncthreads();
  for (int t = threadIdx.x; t < qm; t += kThreads) {
    const float d = carry_d[t];
    const int i = carry_i[t];
    out_min[g * qm + t] = d;
    out_sgid[g * qm + t] = d <= halo2 ? i : -i - 1;
  }
}

}  // namespace

// dense_q: (G, QM, 3); halo_dm: (G, 3, R_max); halo_ids: (G, R_max);
// out_min: (G, QM) f32; out_sgid: (G, QM) i32. Launches on `stream` and does
// not synchronize. Returns cudaGetLastError().
extern "C" int nns_cell_scan(const float* dense_q, const float* halo_dm,
                             const int* halo_ids, int groups, int qm,
                             int r_max, float halo2, float* out_min,
                             int* out_sgid, void* stream) {
  if (qm < 1 || qm > kMaxQM || r_max < 1) return (int)cudaErrorInvalidValue;
  cell_scan_kernel<<<groups, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      dense_q, halo_dm, halo_ids, qm, r_max, halo2, out_min, out_sgid);
  return (int)cudaGetLastError();
}
