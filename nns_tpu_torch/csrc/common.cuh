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

}  // namespace nns
