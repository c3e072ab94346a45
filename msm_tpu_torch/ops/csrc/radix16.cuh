// The radix-16 register DFTs shared by the lane kernels K14-K16
// (lane_radix.cuh) and the axis round trip K1, K3, K8, K13 (axis_radix.cuh):
// the plan of a length-N transform as N = P1 P2 P3 radix passes, the
// position of each frequency after them, and the P-point DFT (P <= 16) of a
// thread's registers with the w_16 constants folded in.

#pragma once

#include "plane_cluster.cuh"

namespace {

// N = P1 * P2 * P3.
template <int N>
struct LanePlan {
  static constexpr int P1 = 16;
  static constexpr int P2 = N >= 256 ? 16 : N / 16;
  static constexpr int P3 = N / (P1 * P2);
  static constexpr int L = N / P1;
};

// Where frequency f of a transform sits after the passes.
template <int N>
__host__ __device__ __forceinline__ int digit_position(int f) {
  using P = LanePlan<N>;
  return (f % P::P1) * P::L + ((f / P::P1) % P::P2) * P::P3 + f / (P::P1 * P::P2);
}

// d * w_16^e, e < 8 (conjugated for the inverse); e is a constant once the
// caller's loops unroll, so the branches fold away.
template <typename T, bool INV>
__device__ __forceinline__ typename Complex<T>::type mul_w16(typename Complex<T>::type d, int e) {
  using C = typename Complex<T>::type;
  constexpr T kC1 = T(0.92387953251128675613);  // cos(pi / 8)
  constexpr T kS1 = T(0.38268343236508977173);  // sin(pi / 8)
  constexpr T kR = T(0.70710678118654752440);   // sqrt(1 / 2)
  // w_16^e = cos(pi e / 8) + i sg sin(pi e / 8), sg = -1 forward
  const T sx = INV ? d.x : -d.x;  // sg * x
  const T sy = INV ? d.y : -d.y;  // sg * y
  C r;
  if (e == 0) {
    r = d;
  } else if (e == 4) {
    r.x = -sy;
    r.y = sx;
  } else if (e == 2) {
    r.x = kR * (d.x - sy);
    r.y = kR * (sx + d.y);
  } else if (e == 6) {
    r.x = -kR * (d.x + sy);
    r.y = kR * (sx - d.y);
  } else {
    const T c = e == 1 ? kC1 : (e == 3 ? kS1 : (e == 5 ? -kS1 : -kC1));
    const T s = (e == 1 || e == 7) ? kS1 : kC1;
    // (x + i y)(c + i sg s)
    r.x = d.x * c - sy * s;
    r.y = sx * s + d.y * c;
  }
  return r;
}

// v[k] = sum_j v[j] w_P^{j k} (P <= 16), natural order in and out: radix-2
// decimation in frequency over the registers, then the bit-reversal
// permutation, both resolved at compile time.
template <typename T, int P, bool INV>
__device__ __forceinline__ void dft_w16(typename Complex<T>::type (&v)[P]) {
#pragma unroll
  for (int h = P / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if ((i & h) == 0) {
        const auto a = v[i];
        const auto b = v[i + h];
        v[i] = cadd(a, b);
        // w_{2h}^k = w_16^{8 k / h}
        v[i + h] = mul_w16<T, INV>(csub(a, b), (i & (h - 1)) * (8 / h));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i) {
    int r = 0;
#pragma unroll
    for (int b = 1; b < P; b <<= 1) r = (r << 1) | ((i & b) ? 1 : 0);
    if (r > i) {
      const auto t = v[i];
      v[i] = v[r];
      v[r] = t;
    }
  }
}

}  // namespace
