// Halton draws shared by the port's CUDA kernels (sm_90a).
//
// One definition for every kernel that makes or regenerates a draw
// (draws_kernel, path_kernel, shade_bwd_kernel, silh_kernel,
// soft_bwd_kernel), so that a draw read from a plane and the same draw
// recomputed in another kernel are the same bits.
#pragma once

#include <stdint.h>

namespace grt {

// Radical inverse of i in base B, accumulated as f *= 1/B; r += f * digit with
// the product and the sum each rounded to float32 (never fused): the plain
// version and the JAX package's draws kernel round the same way, so the draws
// are bit-identical across all three.
template <uint32_t B>
__device__ __forceinline__ float radical_inverse(uint32_t i) {
  const float inv_b = (float)(1.0 / (double)B);
  float f = 1.0f;
  float r = 0.0f;
  while (i > 0u) {
    const uint32_t q = i / B;
    f = __fmul_rn(f, inv_b);
    r = __fadd_rn(r, __fmul_rn(f, (float)(i - q * B)));
    i = q;
  }
  return r;
}

// Halton dimension d uses the d-th prime as its base.
__device__ __forceinline__ float halton(uint32_t i, int d) {
  switch (d) {
    case 0: return radical_inverse<2>(i);
    case 1: return radical_inverse<3>(i);
    case 2: return radical_inverse<5>(i);
    case 3: return radical_inverse<7>(i);
    case 4: return radical_inverse<11>(i);
    case 5: return radical_inverse<13>(i);
    case 6: return radical_inverse<17>(i);
    case 7: return radical_inverse<19>(i);
    case 8: return radical_inverse<23>(i);
    case 9: return radical_inverse<29>(i);
    case 10: return radical_inverse<31>(i);
    case 11: return radical_inverse<37>(i);
    case 12: return radical_inverse<41>(i);
    case 13: return radical_inverse<43>(i);
    case 14: return radical_inverse<47>(i);
    case 15: return radical_inverse<53>(i);
    case 16: return radical_inverse<59>(i);
    case 17: return radical_inverse<61>(i);
    case 18: return radical_inverse<67>(i);
    case 19: return radical_inverse<71>(i);
    case 20: return radical_inverse<73>(i);
    case 21: return radical_inverse<79>(i);
    case 22: return radical_inverse<83>(i);
    default: return radical_inverse<89>(i);
  }
}

// Camera subpixel jitter of Halton index ih: dims 0-1, optionally placed in
// cell (ih % spp) of a k x k grid.
__device__ __forceinline__ void camera_jitter(uint32_t ih, int spp, int strat_k,
                                              float inv_k, float* jx, float* jy) {
  float x = radical_inverse<2>(ih);
  float y = radical_inverse<3>(ih);
  if (strat_k > 0) {
    const uint32_t cell = ih % (uint32_t)spp;
    const uint32_t cy = cell / (uint32_t)strat_k;
    const uint32_t cx = cell - cy * (uint32_t)strat_k;
    x = __fmul_rn(__fadd_rn((float)cx, x), inv_k);
    y = __fmul_rn(__fadd_rn((float)cy, y), inv_k);
  }
  *jx = x;
  *jy = y;
}

}  // namespace grt
