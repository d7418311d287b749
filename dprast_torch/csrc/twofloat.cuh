// Double-float32 arithmetic shared by the kernels that compute grid
// coordinates: B6 (coords.cu) and X1 (xla_path.cu).
//
// Every +, - and * is an `__f*_rn` intrinsic, which nvcc never contracts
// into an FMA and never re-associates, so each is rounded on its own as
// in the eager torch twin (`dprast_torch/ops/geometry.py`,
// `grid_coords_2f` and `reference_voxel_and_deltas_2f`), whose bits are
// the contract.  TwoProd is Dekker's, literally: its partial products
// underflow where an FMA's residual would not.

#pragma once

#include <cuda_runtime.h>

// floor(n / t) for 0 <= n < 2^32 / t, by the multiplier
// inv = floor(2^32 / t) + 1 (0 where t == 1).
__device__ __forceinline__ int tile_of(int n, unsigned inv) {
  return inv == 0u ? n : (int)__umulhi((unsigned)n, inv);
}

// Knuth TwoSum: s + e == a + b exactly, s = fl(a + b).
__device__ __forceinline__ void two_sum(float a, float b, float& s,
                                        float& e) {
  s = __fadd_rn(a, b);
  const float v = __fsub_rn(s, a);
  e = __fadd_rn(__fsub_rn(a, __fsub_rn(s, v)), __fsub_rn(b, v));
}

// Veltkamp split of an fp32 into 12 + 12 bit halves.
__device__ __forceinline__ void split(float a, float& hi, float& lo) {
  const float c = __fmul_rn(a, 4097.0f);  // 2^12 + 1
  hi = __fsub_rn(c, __fsub_rn(c, a));
  lo = __fsub_rn(a, hi);
}

// Dekker TwoProd on operands that are already split: p + e == a * b
// exactly, p = fl(a * b);
// e = (((ah bh - p) + ah bl) + al bh) + al bl.
__device__ __forceinline__ void two_prod(float a, float ah, float al, float b,
                                         float bh, float bl, float& p,
                                         float& e) {
  p = __fmul_rn(a, b);
  e = __fadd_rn(
      __fadd_rn(__fadd_rn(__fsub_rn(__fmul_rn(ah, bh), p), __fmul_rn(ah, bl)),
                __fmul_rn(al, bh)),
      __fmul_rn(al, bl));
}

// (hi, lo) += r x exactly up to the lo term's rounding, both factors
// split: a TwoProd, a TwoSum into hi, and lo += (pe + e).
__device__ __forceinline__ void add_product_2f(float& hi, float& lo, float r,
                                               float rh, float rl, float x,
                                               float xh, float xl) {
  float pr, pe, e;
  two_prod(r, rh, rl, x, xh, xl, pr, pe);
  two_sum(hi, pr, hi, e);
  lo = __fadd_rn(lo, __fadd_rn(pe, e));
}

// One output axis from q = R p + t as (h, l): u = (q + 1) * scale - 1/2,
// renormalised, with the scale split as (sc, sh, sl); then r0 = ceil(u) - 1
// and dl = u - r0 in (0, 1]: h - r0f is exact, and one fix-up step where
// the lo term pushed dl across a voxel boundary.  r0 saturates, as a
// tensor cast does.
__device__ __forceinline__ void voxel_and_delta_2f(float h, float l, float sc,
                                                   float sh, float sl,
                                                   int& r0, float& dl) {
  float e;
  two_sum(h, 1.0f, h, e);
  l = __fadd_rn(l, e);
  float hh, hl;
  split(h, hh, hl);
  two_prod(h, hh, hl, sc, sh, sl, h, e);
  l = __fadd_rn(__fmul_rn(l, sc), e);
  two_sum(h, -0.5f, h, e);
  l = __fadd_rn(l, e);
  two_sum(h, l, h, l);

  float r0f = __fsub_rn(ceilf(h), 1.0f);
  dl = __fadd_rn(__fsub_rn(h, r0f), l);
  const bool up = dl > 1.0f;
  const bool dn = dl <= 0.0f;
  r0f = __fsub_rn(__fadd_rn(r0f, up ? 1.0f : 0.0f), dn ? 1.0f : 0.0f);
  dl = up ? __fsub_rn(dl, 1.0f) : (dn ? __fadd_rn(dl, 1.0f) : dl);
  r0 = __float2int_rz(r0f);
}
