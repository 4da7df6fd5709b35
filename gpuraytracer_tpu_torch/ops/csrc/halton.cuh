// Halton draws shared by the port's CUDA kernels (sm_90a).
//
// One definition for every kernel that makes or regenerates a draw
// (draws_kernel, path_kernel, shade_bwd_kernel, silh_kernel,
// soft_bwd_kernel), so that a draw read from a plane and the same draw
// recomputed in another kernel are the same bits.
//
// The value is the sequence f_k = fl(f_{k-1} * fl(1/B)), r = fl(r + fl(f_k *
// d_k)) over the digits d_k of the index from the least significant up, each
// product and sum rounded to float32 on its own (never fused): the plain
// version and the JAX package's draws kernel round the same way, so the draws
// are bit-identical across all three.  Two forms compute it:
//
//   radical_inverse_loop   the digit loop, for any uint32 index: a divide by
//                          the base, the f chain and a loop that ends when
//                          the index is exhausted;
//   radical_inverse_short  the same roundings in the same order for an index
//                          below HALTON_SHORT, the indices a render makes
//                          (offsets in [0, 2^20), a sample adds less than
//                          2^16): a fixed, compile-time digit count that
//                          covers every such index, unrolled; each f_k a
//                          compile-time constant; the quotient one
//                          multiply-high with no correction; base 2 a bit
//                          reversal.
//
// A digit past the end of the index is 0 and adds exactly +0 (f_k * 0 = +0
// and r >= +0), so the fixed count gives the loop's bits.  radical_inverse
// takes the short form below HALTON_SHORT and the loop above; draws_kernel
// picks the form once per item (halton_at), path_kernel and shade_bwd_kernel
// take a bounce's four draws at once (bounce_draws), silh_kernel and
// soft_bwd_kernel call camera_jitter and halton.  Every one of them was
// faster on the short form than on the loop alone (PERF.md, PR 13).
#pragma once

#include <stdint.h>

namespace grt {

// The Halton dimensions' prime bases (sampling.PRIMES).
constexpr uint32_t HALTON_PRIMES[24] = {2,  3,  5,  7,  11, 13, 17, 19, 23, 29, 31, 37,
                                        41, 43, 47, 53, 59, 61, 67, 71, 73, 79, 83, 89};

__host__ __device__ constexpr uint32_t halton_prime(int d) { return HALTON_PRIMES[d]; }

// Indices below this take the short form.
constexpr uint32_t HALTON_SHORT = (1u << 20) + (1u << 16);

// The digits of base b that write every index below HALTON_SHORT: the least n
// with b^n >= HALTON_SHORT (21 for base 2, 13 for 3, 4 from 37 up).
__host__ __device__ constexpr int short_digits(uint32_t b) {
  int n = 1;
  for (uint64_t p = b; p < HALTON_SHORT; p *= b) ++n;
  return n;
}

// f_k, the weight of digit k: k float32 products of fl(1/B), from f_0 = 1.
template <uint32_t B>
__host__ __device__ constexpr float digit_weight(int k) {
  const float inv_b = (float)(1.0 / (double)B);
  float f = 1.0f;
  for (int j = 0; j < k; ++j) f = f * inv_b;
  return f;
}
static_assert(digit_weight<3>(13) == 0x1.50bd4p-21f, "f_13 of base 3");
static_assert(digit_weight<7>(8) == 0x1.748444p-23f, "f_8 of base 7");
static_assert(digit_weight<73>(4) == 0x1.2e7b3p-25f, "f_4 of base 73");

// ceil(2^32 / B): for i < HALTON_SHORT, __umulhi(i, M) is i / B exactly.  With
// i = qB + r and MB = 2^32 + e (0 <= e < B <= 89), i M / 2^32 = q + (r + i e /
// 2^32) / B, and i e < 2^21 * 2^7 < 2^32, so the fraction stays below 1.
template <uint32_t B>
__host__ __device__ constexpr uint32_t short_magic() {
  return (uint32_t)((0x100000000ull + B - 1) / B);
}

// Radical inverse of i in base B by the digit loop, any i.
template <uint32_t B>
__device__ __forceinline__ float radical_inverse_loop(uint32_t i) {
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

// Digits K..N of the short form; i holds the index divided by B^(K-1).  The
// first sum is fl(+0 + t) = t, and the last digit is i itself (i < B there).
template <uint32_t B, int K, int N>
__device__ __forceinline__ float short_digits_from(uint32_t i, float r) {
  constexpr float f = digit_weight<B>(K);
  const uint32_t q = K < N ? __umulhi(i, short_magic<B>()) : 0u;
  const float t = __fmul_rn(f, __uint2float_rn(i - q * B));
  r = K == 1 ? t : __fadd_rn(r, t);
  if constexpr (K < N) {
    return short_digits_from<B, K + 1, N>(q, r);
  } else {
    return r;
  }
}

// Radical inverse of i < HALTON_SHORT in base B.  Base 2: every partial sum of
// the loop is a sum of distinct powers of two from 2^-1 to 2^-24 (i < 2^24),
// exact in float32, so the value is brev(i) 2^-32 exactly; brev(i) is a
// multiple of 2^8, exact as a float, and the product by 2^-32 is exact.
template <uint32_t B>
__device__ __forceinline__ float radical_inverse_short(uint32_t i) {
  static_assert(HALTON_SHORT <= (1u << 24), "base 2's form needs i < 2^24");
  if constexpr (B == 2) {
    return __fmul_rn(__uint2float_rn(__brev(i)), 0x1p-32f);
  } else {
    return short_digits_from<B, 1, short_digits(B)>(i, 0.0f);
  }
}

template <uint32_t B>
__device__ __forceinline__ float radical_inverse(uint32_t i) {
  return i < HALTON_SHORT ? radical_inverse_short<B>(i) : radical_inverse_loop<B>(i);
}

// Halton dimension D at a compile-time dimension; SHORT: the caller knows that
// i < HALTON_SHORT.
template <int D, bool SHORT>
__device__ __forceinline__ float halton_at(uint32_t i) {
  constexpr uint32_t B = halton_prime(D);
  return SHORT ? radical_inverse_short<B>(i) : radical_inverse_loop<B>(i);
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

// The four draws of bounce b (dims 2 + 5b to 5 + 5b: the NEE pair, the cosine
// pair), each the bits halton(i, 2 + 5b + k) gives; b < 4, the most bounces a
// render takes.  One switch on the bounce for the four: a caller with a
// runtime bounce compiles the short forms of sixteen dimensions once.
template <bool SHORT>
__device__ __forceinline__ void bounce_draws_at(uint32_t i, int b, float* u) {
  switch (b) {
    case 0:
      u[0] = halton_at<2, SHORT>(i); u[1] = halton_at<3, SHORT>(i);
      u[2] = halton_at<4, SHORT>(i); u[3] = halton_at<5, SHORT>(i);
      break;
    case 1:
      u[0] = halton_at<7, SHORT>(i); u[1] = halton_at<8, SHORT>(i);
      u[2] = halton_at<9, SHORT>(i); u[3] = halton_at<10, SHORT>(i);
      break;
    case 2:
      u[0] = halton_at<12, SHORT>(i); u[1] = halton_at<13, SHORT>(i);
      u[2] = halton_at<14, SHORT>(i); u[3] = halton_at<15, SHORT>(i);
      break;
    default:
      u[0] = halton_at<17, SHORT>(i); u[1] = halton_at<18, SHORT>(i);
      u[2] = halton_at<19, SHORT>(i); u[3] = halton_at<20, SHORT>(i);
      break;
  }
}

__device__ __forceinline__ void bounce_draws(uint32_t i, int b, float* u) {
  if (i < HALTON_SHORT) {
    bounce_draws_at<true>(i, b, u);
  } else {
    bounce_draws_at<false>(i, b, u);
  }
}

// The stratified sampler's placement of a jitter pair (x, y) of Halton index
// ih in cell (ih % spp) of a k x k grid; nothing where strat_k is 0.
__device__ __forceinline__ void stratify(uint32_t ih, int spp, int strat_k, float inv_k,
                                         float* x, float* y) {
  if (strat_k > 0) {
    const uint32_t cell = ih % (uint32_t)spp;
    const uint32_t cy = cell / (uint32_t)strat_k;
    const uint32_t cx = cell - cy * (uint32_t)strat_k;
    *x = __fmul_rn(__fadd_rn((float)cx, *x), inv_k);
    *y = __fmul_rn(__fadd_rn((float)cy, *y), inv_k);
  }
}

// Camera subpixel jitter of Halton index ih: dims 0-1, optionally placed in
// cell (ih % spp) of a k x k grid.
__device__ __forceinline__ void camera_jitter(uint32_t ih, int spp, int strat_k,
                                              float inv_k, float* jx, float* jy) {
  float x = radical_inverse<2>(ih);
  float y = radical_inverse<3>(ih);
  stratify(ih, spp, strat_k, inv_k, &x, &y);
  *jx = x;
  *jy = y;
}

}  // namespace grt
