// Hopper (sm_90a) threefry2x32 draws, JAX's counter scheme, bound to Python
// through a plain C interface (msm_tpu_torch/ops/build.py compiles this
// file with nvcc and loads it with ctypes).
//
//   msm_threefry : out[i] for the flat indices i in [0, n) of one key: the
//                  raw word, the uniform or the normal of
//                  threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))
//
// It replaces no TPU kernel. msm_tpu draws its quantum streams with
// jax.random (msm_tpu/models/sampling.py:68-83), which XLA compiles into
// its own elementwise code. The port draws the same numbers: its plain
// version (msm_tpu_torch/models/prng.py) carries the 32-bit words in int64
// tensors and makes about 150 full-size passes, with int64 temporaries, a
// draw; this kernel keeps the two words in registers through the 20 rounds
// and writes each output once.
//
// threefry_kernel<OUT, WIDTH>, OUT one of
//   kBits     WIDTH 32: x0 ^ x1;  WIDTH 64: (x0 << 32) | x1
//   kUniform  JAX's `_uniform`: the word's top mantissa bits under 1.0's
//             exponent, minus 1, times (hi - lo), plus lo, at least lo;
//             float32 from the 32-bit word, float64 from the 64-bit word
//   kNormal   JAX's `_normal_real`: sqrt(2) erf_inv(u), u the uniform on
//             [nextafter(-1, 0), 1), with XLA's erf_inv (Giles; ErfInv32 or
//             ErfInv64) and XLA's log1p (Cephes' rational below
//             |x| = sqrt(2) - 1, log(1 + x) above; in float32 XLA's own
//             log). The float32 arithmetic is the plain version's to the
//             bit: fmaf where XLA fuses a multiply-add (the plain version
//             rounds those once through float64), __fmul_rn / __fadd_rn
//             where it rounds apart, so nvcc contracts nothing. The float64
//             arithmetic rounds each product and sum apart, as the plain
//             version does, with the card's log in log1p's upper branch.
//
// Bound: bytes, each output written once (4 or 8 bytes a value), 1.2 GB
// for the two float32 normals of a (9, 256^3) Wigner batch, 0.36 ms at 3.35
// TB/s. The work is integer: threefry is about 80 32-bit integer
// operations a value (20 rounds of add, funnel shift and xor, and the key
// injections), the normal about 90 floating-point ones more. One value a
// thread, consecutive threads on consecutive indices (each warp writes 128
// or 256 contiguous bytes), in a grid-stride loop over about 32 blocks an
// SM. The entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>
#include <type_traits>

namespace {

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;

enum Out { kBits = 0, kUniform = 1, kNormal = 2 };

// a constant rounded as the plain version rounds a Python float: to double,
// then to float
__host__ __device__ constexpr float f32(double v) { return static_cast<float>(v); }

__device__ __forceinline__ uint32_t rotl(uint32_t x, int d) { return __funnelshift_l(x, x, d); }

// JAX's threefry2x32 (jax/_src/prng.py, _threefry2x32_lowering): 20 rounds
// in five groups of four, the key injected after each group.
__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1, uint32_t& x0,
                                             uint32_t& x1) {
  const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
  constexpr int kRot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  x0 += ks[0];
  x1 += ks[1];
#pragma unroll
  for (int g = 0; g < 5; ++g) {
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      x0 += x1;
      x1 = rotl(x1, kRot[g % 2][r]) ^ x0;
    }
    x0 += ks[(g + 1) % 3];
    x1 += ks[(g + 2) % 3] + static_cast<uint32_t>(g + 1);
  }
}

// ---------------------------------------------------------------------------
// float32: XLA's log (Cephes' logf), log1p and ErfInv32, fused as XLA fuses

__device__ __forceinline__ float log_f32(float x_in) {
  const float x_c = fmaxf(x_in, f32(1.17549435e-38));
  const int bits = __float_as_int(x_c);
  float e = __fadd_rn(static_cast<float>((bits >> 23) - 127), 1.0f);
  const float m = __int_as_float((bits & 0x807FFFFF) | 0x3F000000);
  const bool small = m < f32(0.707106781186547524);
  float x;
  if (small) {
    e = __fsub_rn(e, 1.0f);
    x = __fadd_rn(__fsub_rn(m, 1.0f), m);
  } else {
    x = __fsub_rn(m, 1.0f);
  }
  const float z = __fmul_rn(x, x);
  const float x3 = __fmul_rn(z, x);
  const float y1 = fmaf(fmaf(x, f32(7.0376836292e-2), f32(-1.1514610310e-1)), x, f32(1.1676998740e-1));
  const float y2 = fmaf(fmaf(x, f32(-1.2420140846e-1), f32(1.4249322787e-1)), x, f32(-1.6668057665e-1));
  const float y3 = fmaf(fmaf(x, f32(2.0000714765e-1), f32(-2.4999993993e-1)), x, f32(3.3333331174e-1));
  float y = fmaf(fmaf(y1, x3, y2), x3, y3);
  y = fmaf(y, x3, __fmul_rn(e, f32(-2.12194440e-4)));
  const float r = __fadd_rn(__fadd_rn(__fsub_rn(x, __fmul_rn(0.5f, z)), y),
                            __fmul_rn(e, 0.693359375f));
  // XLA's CPU code reads subnormals as zero
  if (fabsf(x_in) < f32(1.17549435e-38)) return -INFINITY;
  if (x_in == INFINITY) return INFINITY;
  if (!(x_in > 0.0f)) return NAN;
  return r;
}

// Cephes' log1p coefficients, as the plain version rounds them (double,
// then float)
__device__ __constant__ double kLog1pP[7] = {
    4.5270000862445199635e-5, 4.9854102823193375972e-1, 6.5787325942061044846e0,
    2.9911919328553073277e1,  6.0949667980987787057e1,  5.7112963590585538103e1,
    2.0039553499201281259e1};
__device__ __constant__ double kLog1pQ[6] = {
    1.5062909083469192043e1, 8.3047565967967209469e1, 2.2176239823732856465e2,
    3.0909872225312059774e2, 2.1642788614495947685e2, 6.0118660497603843919e1};
// sqrt(2) - 1 as XLA rounds it
constexpr double kLog1pSmall = 0.41421356237309503;

__device__ __forceinline__ float log1p_f32(float x) {
  float q = 1.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) q = fmaf(q, x, static_cast<float>(kLog1pQ[i]));
  float p = static_cast<float>(kLog1pP[0]);
#pragma unroll
  for (int i = 1; i < 7; ++i) p = fmaf(p, x, static_cast<float>(kLog1pP[i]));
  const float x2 = __fmul_rn(x, x);
  const float small =
      __fadd_rn(x, fmaf(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q))));
  return fabsf(x) < static_cast<float>(kLog1pSmall) ? small : log_f32(__fadd_rn(x, 1.0f));
}

__device__ __constant__ double kErfInv32Lt5[9] = {
    2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06, 0.00021858087,
    -0.00125372503, -0.00417768164, 0.246640727,    1.50140941};
__device__ __constant__ double kErfInv32Ge5[9] = {
    -0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844, 0.00573950773,
    -0.0076224613,   0.00943887047,  1.00167406,    2.83297682};

__device__ __forceinline__ float erf_inv_f32(float x) {
  float w = -log1p_f32(__fmul_rn(x, -x));
  const bool lt = w < 5.0f;
  w = lt ? __fsub_rn(w, 2.5f) : __fsub_rn(__fsqrt_rn(w), 3.0f);
  float p = static_cast<float>(lt ? kErfInv32Lt5[0] : kErfInv32Ge5[0]);
#pragma unroll
  for (int i = 1; i < 9; ++i) {
    p = fmaf(p, w, static_cast<float>(lt ? kErfInv32Lt5[i] : kErfInv32Ge5[i]));
  }
  return fabsf(x) == 1.0f ? x * INFINITY : __fmul_rn(p, x);
}

// ---------------------------------------------------------------------------
// float64: XLA's log1p and ErfInv64, each product and sum rounded apart

__device__ __forceinline__ double mad_rn(double a, double b, double c) {
  return __dadd_rn(__dmul_rn(a, b), c);
}

__device__ __forceinline__ double log1p_f64(double x) {
  double q = 1.0;
#pragma unroll
  for (int i = 0; i < 6; ++i) q = mad_rn(q, x, kLog1pQ[i]);
  double p = kLog1pP[0];
#pragma unroll
  for (int i = 1; i < 7; ++i) p = mad_rn(p, x, kLog1pP[i]);
  const double x2 = __dmul_rn(x, x);
  const double small =
      __dadd_rn(x, __dadd_rn(__dmul_rn(x2, -0.5), __dmul_rn(__dmul_rn(x, x2), __ddiv_rn(p, q))));
  return fabs(x) < kLog1pSmall ? small : log(__dadd_rn(x, 1.0));
}

__device__ __constant__ double kErfInv64Lt625[23] = {
    -3.6444120640178196996e-21, -1.685059138182016589e-19, 1.2858480715256400167e-18,
    1.115787767802518096e-17,   -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15,  -4.0545662729752068639e-14, -8.1519341976054721522e-14,
    2.6335093153082322977e-12,  -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09,   -4.1126339803469836976e-09, -2.9070369957882005086e-08,
    4.2347877827932403518e-07,  -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352,   -0.00074070253416626697512, -0.0060336708714301490533,
    0.24015818242558961693,     1.6536545626831027356};
__device__ __constant__ double kErfInv64Lt16[19] = {
    2.2137376921775787049e-09,  9.0756561938885390979e-08, -2.7517406297064545428e-07,
    1.8239629214389227755e-08,  1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06,  1.2475304481671778723e-05, -4.7318229009055733981e-05,
    6.8284851459573175448e-05,  2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703,  -0.0016882755560235047313, 0.0024914420961078508066,
    -0.0037512085075692412107,  0.005370914553590063617,   1.0052589676941592334,
    3.0838856104922207635};
__device__ __constant__ double kErfInv64Ge16[17] = {
    -2.7109920616438573243e-11, -2.5556418169965252055e-10, 1.5076572693500548083e-09,
    -3.7894654401267369937e-09, 7.6157012080783393804e-09,  -1.4960026627149240478e-08,
    2.9147953450901080826e-08,  -6.7711997758452339498e-08, 2.2900482228026654717e-07,
    -9.9298272942317002539e-07, 4.5260625972231537039e-06,  -1.9681778105531670567e-05,
    7.5995277030017761139e-05,  -0.00021503011930044477347, -0.00013871931833623122026,
    1.0103004648645343977,      4.8499064014085844221};

__device__ __forceinline__ double erf_inv_f64(double x) {
  double w = -log1p_f64(__dmul_rn(x, -x));
  const bool lt625 = w < 6.25;
  const bool lt16 = w < 16.0;
  w = lt625 ? __dsub_rn(w, 3.125) : __dsub_rn(__dsqrt_rn(w), lt16 ? 3.25 : 5.0);
  // the branch's coefficients, aligned at the highest degree as XLA's
  // selects align them: 23 below 6.25, 19 below 16, 17 above
  const double* c = lt625 ? kErfInv64Lt625 : (lt16 ? kErfInv64Lt16 : kErfInv64Ge16);
  const int terms = lt625 ? 23 : (lt16 ? 19 : 17);
  double p = c[0];
  for (int i = 1; i < terms; ++i) p = mad_rn(p, w, c[i]);
  return fabs(x) == 1.0 ? x * INFINITY : __dmul_rn(p, x);
}

// ---------------------------------------------------------------------------

template <int OUT, int WIDTH>
struct Value;

template <>
struct Value<kBits, 32> {
  using T = uint32_t;
  static __device__ __forceinline__ T of(uint32_t x0, uint32_t x1, float, float) {
    return x0 ^ x1;
  }
};

template <>
struct Value<kBits, 64> {
  using T = uint64_t;
  static __device__ __forceinline__ T of(uint32_t x0, uint32_t x1, double, double) {
    return (static_cast<uint64_t>(x0) << 32) | x1;
  }
};

__device__ __forceinline__ float unit_f32(uint32_t x0, uint32_t x1) {
  return __fsub_rn(__uint_as_float(((x0 ^ x1) >> 9) | 0x3F800000u), 1.0f);
}

__device__ __forceinline__ double unit_f64(uint32_t x0, uint32_t x1) {
  const uint64_t word = (static_cast<uint64_t>(x0) << 32) | x1;
  return __dsub_rn(__longlong_as_double(static_cast<long long>((word >> 12) |
                                                              0x3FF0000000000000ull)),
                   1.0);
}

template <>
struct Value<kUniform, 32> {
  using T = float;
  // lo and span as the plain version rounds them: lo to float, hi - lo in float
  static __device__ __forceinline__ T of(uint32_t x0, uint32_t x1, float lo, float span) {
    return fmaxf(lo, fmaf(unit_f32(x0, x1), span, lo));
  }
};

template <>
struct Value<kUniform, 64> {
  using T = double;
  static __device__ __forceinline__ T of(uint32_t x0, uint32_t x1, double lo, double span) {
    return fmax(lo, mad_rn(unit_f64(x0, x1), span, lo));
  }
};

template <>
struct Value<kNormal, 32> {
  using T = float;
  static __device__ __forceinline__ T of(uint32_t x0, uint32_t x1, float lo, float span) {
    const float u = Value<kUniform, 32>::of(x0, x1, lo, span);
    return __fmul_rn(static_cast<float>(1.4142135623730951), erf_inv_f32(u));
  }
};

template <>
struct Value<kNormal, 64> {
  using T = double;
  static __device__ __forceinline__ T of(uint32_t x0, uint32_t x1, double lo, double span) {
    const double u = Value<kUniform, 64>::of(x0, x1, lo, span);
    return __dmul_rn(1.4142135623730951, erf_inv_f64(u));
  }
};

template <int OUT, int WIDTH>
__global__ void __launch_bounds__(kThreads)
    threefry_kernel(typename Value<OUT, WIDTH>::T* __restrict__ out, uint32_t k0, uint32_t k1,
                    int64_t n,
                    typename std::conditional<WIDTH == 32, float, double>::type lo,
                    typename std::conditional<WIDTH == 32, float, double>::type span) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint64_t counter = static_cast<uint64_t>(i);
    uint32_t x0 = static_cast<uint32_t>(counter >> 32);
    uint32_t x1 = static_cast<uint32_t>(counter);
    threefry2x32(k0, k1, x0, x1);
    out[i] = Value<OUT, WIDTH>::of(x0, x1, lo, span);
  }
}

template <int OUT, int WIDTH>
void launch(void* out, uint32_t k0, uint32_t k1, int64_t n, double lo, double hi,
            cudaStream_t stream) {
  using T = typename Value<OUT, WIDTH>::T;
  using R = typename std::conditional<WIDTH == 32, float, double>::type;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  // the plain version's lo and hi - lo, in the output's precision
  const R lo_r = static_cast<R>(lo);
  const R span = static_cast<R>(hi) - lo_r;
  threefry_kernel<OUT, WIDTH><<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      static_cast<T*>(out), k0, k1, n, lo_r, span);
}

}  // namespace

extern "C" {

// out: n contiguous values (uint32 / uint64 words, float32 / float64),
// the flat indices 0 .. n - 1 of the key (k0, k1). kind: 0 the
// words, 1 the uniform on [lo, hi), 2 the normal (lo = nextafter(-1, 0),
// hi = 1). width: 32 or 64.
int msm_threefry(void* out, uint32_t k0, uint32_t k1, int64_t n, int kind, int width,
                 double lo, double hi, void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (width == 32) {
    if (kind == kBits) launch<kBits, 32>(out, k0, k1, n, lo, hi, s);
    else if (kind == kUniform) launch<kUniform, 32>(out, k0, k1, n, lo, hi, s);
    else if (kind == kNormal) launch<kNormal, 32>(out, k0, k1, n, lo, hi, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else if (width == 64) {
    if (kind == kBits) launch<kBits, 64>(out, k0, k1, n, lo, hi, s);
    else if (kind == kUniform) launch<kUniform, 64>(out, k0, k1, n, lo, hi, s);
    else if (kind == kNormal) launch<kNormal, 64>(out, k0, k1, n, lo, hi, s);
    else return static_cast<int>(cudaErrorInvalidValue);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
