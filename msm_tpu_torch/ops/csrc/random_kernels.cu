// Hopper (sm_90a) threefry2x32 draws, JAX's counter scheme, bound to Python
// through a plain C interface (msm_tpu_torch/ops/build.py compiles this
// file with nvcc and loads it with ctypes).
//
//   msm_threefry : out[i] for the flat indices i in [0, n) of one key: the
//                  raw word, the uniform or the normal of
//                  threefry2x32(key, (i >> 32, i & 0xFFFFFFFF))
//   msm_poisson  : JAX's Poisson counts of one key for n float32 lam, in
//                  two launches with no host read
//
// They replace no TPU kernel. msm_tpu draws its quantum streams with
// jax.random (msm_tpu/models/sampling.py:68-83), which XLA compiles into
// its own elementwise code and while loops. The port draws the same
// numbers: its plain version (msm_tpu_torch/ops/threefry_plain.py) carries
// the 32-bit words in int64 tensors and makes about 150 full-size passes a
// draw, and a Poisson round about 140 more and a host read; these kernels
// keep the words in registers and write each output once.
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
//             where it rounds apart, so nvcc contracts nothing. Its
//             coefficients are immediates (`horner` over f32() of each
//             literal, folded at compile time): read from __constant__
//             double arrays, each cost a float64-to-float32 conversion a
//             value at the card's slow conversion rate. The float64
//             arithmetic rounds each product and sum apart, as the plain
//             version does, with the card's log in log1p's upper branch.
//
// Bound: the integer work. threefry is about 80 32-bit integer operations
// a value (20 rounds of add, funnel shift and xor, and the key
// injections); the output's bytes (4 or 8 a value, 0.36 ms for the two
// float32 normals of a (9, 256^3) Wigner batch at 3.35 TB/s) take less.
// The words alone are the measured floor of every output; the normal adds
// about 60 floating-point operations. One value a thread, consecutive
// threads on consecutive indices (each warp writes 128 or 256 contiguous
// bytes), in a grid-stride loop over about 32 blocks an SM.
//
// The Poisson draw (jax/_src/random.py `_poisson`): Knuth where lam < 10
// or NaN, transformed rejection elsewhere (Knuth's cells at lam = 1e5,
// which count towards the stream's rounds), 0 where lam == 0. Both
// samplers draw round r's uniforms from the same key chain: rng_0 = key,
// rng_{r+1} = threefry(rng_r, (0, 0)); Knuth's uniform and the rejection
// sampler's u from sub_a = threefry(rng_r, (0, 1)), its v from sub_b =
// threefry(rng_r, (0, 2)), each at the cell's flat index. A Knuth cell
// never changes once finished, so a thread runs its cell's rounds to their
// end. A rejection round's count and acceptance depend on that round's
// keys and the cell alone, so rounds can be evaluated in any order:
//   poisson_first_kernel (launch A): Knuth's counts, and each cell's first
//     accepting round f; the block's max f goes to an integer atomicMax
//     (deterministic), so R - 1 = max f over the draw;
//   poisson_last_kernel (launch B): rounds R - 1, R - 2, ... down to the
//     first that accepts, whose k is JAX's (its select keeps a cell's k at
//     the LAST accepting round of the R the stream runs, not its first).
// Each launch evaluates about 1.16 rounds a cell where JAX's loop runs all
// R (9 on the main config's 256^3 lam). Both always run, as JAX runs both
// samplers; where every cell is Knuth's, launch B writes nothing. Round
// keys: each block derives the chain's first table_rounds rounds into
// shared memory once (thread 0 walks rng, the block then derives the
// subkeys); a cell that needs a later round walks the chain on from the
// table's last rng itself, so no count is ever cut. The arithmetic is
// threefry_plain.py's to the bit: its log_f32, log1p_f32, lgamma_f32 and
// rejection constants, fmaf where it calls fma32, __f*_rn everywhere else. Bound: the integer work
// of the words the rounds draw (one a Knuth round, two a rejection round);
// the bytes (lam read, counts written) take less. The blocks are as many
// as the card holds at once, so every table is built once a launch.
//
// The entry points launch on the stream they are given and return
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

// Horner's rule, highest degree first: p, then p * x + c for each c, each
// step one fmaf. Called with f32() of literals, the coefficients fold into
// immediates.
__device__ __forceinline__ float horner(float, float p) { return p; }

template <typename... Cs>
__device__ __forceinline__ float horner(float x, float p, float c, Cs... cs) {
  return horner(x, fmaf(p, x, c), cs...);
}

// sqrt(2) - 1 as XLA rounds it
constexpr double kLog1pSmall = 0.41421356237309503;

__device__ __forceinline__ float log1p_f32(float x) {
  // Cephes' log1p rational, as the plain version rounds its coefficients
  // (double, then float)
  const float q = horner(x, 1.0f, f32(1.5062909083469192043e1), f32(8.3047565967967209469e1),
                         f32(2.2176239823732856465e2), f32(3.0909872225312059774e2),
                         f32(2.1642788614495947685e2), f32(6.0118660497603843919e1));
  const float p = horner(x, f32(4.5270000862445199635e-5), f32(4.9854102823193375972e-1),
                         f32(6.5787325942061044846e0), f32(2.9911919328553073277e1),
                         f32(6.0949667980987787057e1), f32(5.7112963590585538103e1),
                         f32(2.0039553499201281259e1));
  const float x2 = __fmul_rn(x, x);
  const float small =
      __fadd_rn(x, fmaf(x2, -0.5f, __fmul_rn(__fmul_rn(x, x2), __fdiv_rn(p, q))));
  return fabsf(x) < f32(kLog1pSmall) ? small : log_f32(__fadd_rn(x, 1.0f));
}

// XLA's ErfInv32: a branch of 9 terms on each side of w = 5. Below 5 lie
// all but |x| > 0.9966, so a warp takes the second branch rarely.
__device__ __forceinline__ float erf_inv_f32(float x) {
  const float w = -log1p_f32(__fmul_rn(x, -x));
  float p;
  if (w < 5.0f) {
    p = horner(__fsub_rn(w, 2.5f), f32(2.81022636e-08), f32(3.43273939e-07),
               f32(-3.5233877e-06), f32(-4.39150654e-06), f32(0.00021858087),
               f32(-0.00125372503), f32(-0.00417768164), f32(0.246640727), f32(1.50140941));
  } else {
    p = horner(__fsub_rn(__fsqrt_rn(w), 3.0f), f32(-0.000200214257), f32(0.000100950558),
               f32(0.00134934322), f32(-0.00367342844), f32(0.00573950773),
               f32(-0.0076224613), f32(0.00943887047), f32(1.00167406), f32(2.83297682));
  }
  return fabsf(x) == 1.0f ? x * INFINITY : __fmul_rn(p, x);
}

// ---------------------------------------------------------------------------
// float64: XLA's log1p and ErfInv64, each product and sum rounded apart

__device__ __forceinline__ double mad_rn(double a, double b, double c) {
  return __dadd_rn(__dmul_rn(a, b), c);
}

__device__ __constant__ double kLog1pP[7] = {
    4.5270000862445199635e-5, 4.9854102823193375972e-1, 6.5787325942061044846e0,
    2.9911919328553073277e1,  6.0949667980987787057e1,  5.7112963590585538103e1,
    2.0039553499201281259e1};
__device__ __constant__ double kLog1pQ[6] = {
    1.5062909083469192043e1, 8.3047565967967209469e1, 2.2176239823732856465e2,
    3.0909872225312059774e2, 2.1642788614495947685e2, 6.0118660497603843919e1};

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
    return __fmul_rn(f32(1.4142135623730951), erf_inv_f32(u));
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


// ---------------------------------------------------------------------------
// Poisson: JAX's `_poisson` (threefry_plain.py `poisson`)

constexpr int kTableRounds = 32;  // ops/threefry.py TABLE_ROUNDS
// stats[]: the last round R - 1, and the rounds evaluated by launch A's
// rejection, by launch B and by Knuth (ops/threefry.py POISSON_STATS)
enum Stat { kLastRound = 0, kFirstRounds = 1, kLastRounds = 2, kKnuthRounds = 3 };

// JAX's float32 uniform on [0, 1) of key (k0, k1) at flat index i
__device__ __forceinline__ float uniform_at(uint2 key, uint64_t i) {
  uint32_t x0 = static_cast<uint32_t>(i >> 32), x1 = static_cast<uint32_t>(i);
  threefry2x32(key.x, key.y, x0, x1);
  return unit_f32(x0, x1);
}

// a round's two subkeys: sub_a = threefry(rng, (0, 1)) (Knuth's key, the
// rejection sampler's u), sub_b = threefry(rng, (0, 2)) (its v)
struct RoundKeys {
  uint2 a, b;
};

__device__ __forceinline__ RoundKeys round_keys(uint2 rng) {
  uint32_t a0 = 0, a1 = 1, b0 = 0, b1 = 2;
  threefry2x32(rng.x, rng.y, a0, a1);
  threefry2x32(rng.x, rng.y, b0, b1);
  return {make_uint2(a0, a1), make_uint2(b0, b1)};
}

__device__ __forceinline__ uint2 next_rng(uint2 rng) {
  uint32_t x0 = 0, x1 = 0;
  threefry2x32(rng.x, rng.y, x0, x1);
  return make_uint2(x0, x1);
}

// The block's key table: rng[r] for r <= rounds, the subkeys of rounds
// r < rounds. Thread 0 walks the chain (one threefry a round, in order);
// the block then derives the subkeys.
struct KeyTable {
  uint2 rng[kTableRounds + 1];
  RoundKeys sub[kTableRounds];
};

__device__ void build_table(KeyTable& t, uint2 key, int rounds) {
  if (threadIdx.x == 0) {
    uint2 rng = key;
    t.rng[0] = rng;
    for (int r = 0; r < rounds; ++r) {
      rng = next_rng(rng);
      t.rng[r + 1] = rng;
    }
  }
  __syncthreads();
  for (int r = threadIdx.x; r < rounds; r += blockDim.x) t.sub[r] = round_keys(t.rng[r]);
  __syncthreads();
}

// Round keys in increasing order: the table's, then the chain walked on
// from the table's last rng by this thread alone.
struct Rounds {
  const KeyTable& t;
  int rounds;
  uint2 walk;
  __device__ Rounds(const KeyTable& t_, int rounds_)
      : t(t_), rounds(rounds_), walk(t_.rng[rounds_]) {}
  __device__ __forceinline__ RoundKeys at(int r) {  // r = 0, 1, 2, ... in turn
    if (r < rounds) return t.sub[r];
    const RoundKeys k = round_keys(walk);
    walk = next_rng(walk);
    return k;
  }
};

// XLA's lgamma(k + 1) of a float32 count k >= 0 (threefry_plain.py
// lgamma_f32): Lanczos, g = 7, as its optimizer folds it
__device__ __forceinline__ float lgamma_f32(float k) {
  float acc = __fadd_rn(__fdiv_rn(f32(676.520386), __fadd_rn(k, 1.0f)), 1.0f);
  acc = __fadd_rn(acc, __fdiv_rn(f32(-1259.13916), __fadd_rn(k, 2.0f)));
  acc = __fadd_rn(acc, __fdiv_rn(f32(771.323425), __fadd_rn(k, 3.0f)));
  acc = __fadd_rn(acc, __fdiv_rn(f32(-176.615036), __fadd_rn(k, 4.0f)));
  acc = __fadd_rn(acc, __fdiv_rn(f32(12.5073433), __fadd_rn(k, 5.0f)));
  acc = __fadd_rn(acc, __fdiv_rn(f32(-0.138571098), __fadd_rn(k, 6.0f)));
  acc = __fadd_rn(acc, __fdiv_rn(f32(9.98436917e-06), __fadd_rn(k, 7.0f)));
  acc = __fadd_rn(acc, __fdiv_rn(f32(1.50563267e-07), __fadd_rn(k, 8.0f)));
  const float log_t = __fadd_rn(log1p_f32(__fmul_rn(k, f32(0.13333334))), f32(2.01490307));
  const float t_over_log_t = __fdiv_rn(__fadd_rn(k, 7.5f), log_t);
  return __fadd_rn(fmaf(__fsub_rn(__fadd_rn(k, 0.5f), t_over_log_t), log_t, f32(0.918938518)),
                   log_f32(acc));
}

// A cell's transformed rejection (threefry_plain.py rejection_constants,
// rejection_round)
struct Rejection {
  float lam, log_lam, a, b, inv_alpha, v_r;

  __device__ explicit Rejection(float lam_) : lam(lam_), log_lam(log_f32(lam_)) {
    const float root = __fsqrt_rn(lam);
    b = fmaf(root, f32(2.53), f32(0.931));
    a = fmaf(b, f32(0.02483), f32(-0.059));
    inv_alpha = __fadd_rn(__fdiv_rn(f32(1.1328), fmaf(root, f32(2.53), f32(-2.469))), f32(1.1239));
    v_r = __fsub_rn(f32(0.9277), __fdiv_rn(f32(3.6224), fmaf(root, f32(2.53), f32(-1.069))));
  }

  // whether the round of uniforms u01 (sub_a's) and v (sub_b's) accepts,
  // and its count kk
  __device__ __forceinline__ bool accepts(float u01, float v, float& kk) const {
    const float u = __fadd_rn(u01, -0.5f);
    const float u_shifted = __fsub_rn(0.5f, fabsf(u));
    kk = floorf(__fadd_rn(fmaf(__fadd_rn(__fdiv_rn(__fmul_rn(a, 2.0f), u_shifted), b), u, lam),
                          f32(0.43)));
    if (u_shifted >= f32(0.07) && v <= v_r) return true;
    if (kk < 0.0f || (u_shifted < f32(0.013) && v > u_shifted)) return false;
    const float t = __fsub_rn(fmaf(kk, log_lam, -lam), lgamma_f32(kk));
    const float s = log_f32(__fdiv_rn(__fmul_rn(v, inv_alpha),
                                      __fadd_rn(__fdiv_rn(a, __fmul_rn(u_shifted, u_shifted)), b)));
    return s <= t;
  }

  __device__ __forceinline__ bool accepts(const RoundKeys& k, uint64_t i, float& kk) const {
    return accepts(uniform_at(k.a, i), uniform_at(k.b, i), kk);
  }
};

__device__ __forceinline__ bool is_knuth(float lam) { return isnan(lam) || lam < 10.0f; }

// the block's sum (and max) of a per-thread value, added to stats[] by one
// integer atomic (the result does not depend on the blocks' order)
__device__ __forceinline__ void block_add(unsigned long long v, unsigned long long* dst,
                                          bool take_max = false) {
  __shared__ unsigned long long warp_v[kThreads / 32];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    const unsigned long long w = __shfl_down_sync(0xFFFFFFFFu, v, o);
    v = take_max ? (w > v ? w : v) : v + w;
  }
  if ((threadIdx.x & 31) == 0) warp_v[threadIdx.x >> 5] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    for (int w = 1; w < kThreads / 32; ++w) {
      v = take_max ? (warp_v[w] > v ? warp_v[w] : v) : v + warp_v[w];
    }
    if (take_max) atomicMax(dst, v);
    else atomicAdd(dst, v);
  }
  __syncthreads();
}

// Launch A: Knuth's counts (and 0 where lam == 0) into out, and each
// cell's first accepting rejection round (at lam = 1e5 for Knuth's cells)
// into the max R - 1.
__global__ void __launch_bounds__(kThreads)
    poisson_first_kernel(const float* __restrict__ lam, float* __restrict__ out, int64_t n,
                         uint2 key, int table_rounds, unsigned long long* __restrict__ stats) {
  __shared__ KeyTable table;
  build_table(table, key, table_rounds);
  unsigned long long last = 0, first_rounds = 0, knuth_rounds = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint64_t cell = static_cast<uint64_t>(i);
    const float l = lam[i];
    const bool knuth = is_knuth(l);
    if (knuth) {
      // JAX's _poisson_knuth: count the rounds while log_prod > -lam
      Rounds rounds(table, table_rounds);
      float count = 0.0f, log_prod = 0.0f;
      for (int r = 0; log_prod > -l; ++r) {
        count = __fadd_rn(count, 1.0f);
        log_prod = __fadd_rn(log_prod, log_f32(uniform_at(rounds.at(r).a, cell)));
      }
      knuth_rounds += static_cast<unsigned long long>(count);
      out[i] = l == 0.0f ? 0.0f : __fsub_rn(count, 1.0f);
    }
    const Rejection rej(knuth ? f32(1e5) : l);
    Rounds rounds(table, table_rounds);
    float kk;
    int r = 0;
    while (!rej.accepts(rounds.at(r), cell, kk)) ++r;
    first_rounds += r + 1;
    last = last > static_cast<unsigned long long>(r) ? last : r;
  }
  block_add(last, stats + kLastRound, true);
  block_add(first_rounds, stats + kFirstRounds);
  block_add(knuth_rounds, stats + kKnuthRounds);
}

// Launch B: each rejection cell's count at the last accepting round of the
// R the stream runs: rounds R - 1, R - 2, ... until one accepts (round f,
// its first accepting one, bounds the scan). Rounds past the table are
// walked forward first, keeping the last that accepts.
__global__ void __launch_bounds__(kThreads)
    poisson_last_kernel(const float* __restrict__ lam, float* __restrict__ out, int64_t n,
                        uint2 key, int table_rounds, unsigned long long* __restrict__ stats) {
  __shared__ KeyTable table;
  build_table(table, key, table_rounds);
  const int total = static_cast<int>(stats[kLastRound]) + 1;  // R
  const int in_table = total < table_rounds ? total : table_rounds;
  unsigned long long last_rounds = 0;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x; i < n;
       i += stride) {
    const uint64_t cell = static_cast<uint64_t>(i);
    const float l = lam[i];
    if (is_knuth(l)) continue;
    const Rejection rej(l);
    float k_out = -1.0f, kk;
    bool found = false;
    if (total > table_rounds) {
      Rounds rounds(table, table_rounds);
      for (int r = table_rounds; r < total; ++r) {
        if (rej.accepts(rounds.at(r), cell, kk)) {
          k_out = kk;
          found = true;
        }
      }
      last_rounds += total - table_rounds;
    }
    for (int r = in_table - 1; !found && r >= 0; --r) {
      ++last_rounds;
      if (rej.accepts(table.sub[r], cell, kk)) {
        k_out = kk;
        found = true;
      }
    }
    out[i] = k_out;
  }
  block_add(last_rounds, stats + kLastRounds);
}

// one block an SM slot: every block resident at once, so each launch builds
// each block's table once
template <typename Kernel>
unsigned resident_blocks(Kernel kernel, int64_t n) {
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, 0);
  const int64_t want = (n + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * (per_sm > 0 ? per_sm : 1);
  return static_cast<unsigned>(want < most ? want : most);
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

// lam: n contiguous float32 rates; out: n float32 counts; stats: four
// int64 (POISSON_STATS), zeroed by the caller; table_rounds in [1,
// kTableRounds]. Launch A, then launch B, on the stream.
int msm_poisson(const void* lam, void* out, void* stats, int64_t n, uint32_t k0, uint32_t k1,
                int table_rounds, void* stream) {
  if (table_rounds < 1 || table_rounds > kTableRounds) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(lam);
  float* o = static_cast<float*>(out);
  auto* st = static_cast<unsigned long long*>(stats);
  const uint2 key = make_uint2(k0, k1);
  poisson_first_kernel<<<resident_blocks(poisson_first_kernel, n), kThreads, 0, s>>>(
      l, o, n, key, table_rounds, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  poisson_last_kernel<<<resident_blocks(poisson_last_kernel, n), kThreads, 0, s>>>(
      l, o, n, key, table_rounds, st);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
