// The axis round trip K1 (msm_axis_roundtrip_kick), K3
// (msm_axis_roundtrip_poisson), K8 (msm_axis_roundtrip_map) and its forward
// half K13 (msm_axis_fwd_reduce) (fused_kernels.cu) as radix-16 register
// passes: the ortho DFT along axis 1 of (b1, N, lanes), N in {128, 256,
// 512, 1024}, an elementwise epilogue at each element's frequency and (K1,
// K3, K8) the ortho inverse. Replaces msm_tpu/ops/mxu_fft.py
// _sublane_kernel_roundtrip_kick_reduce_sep (K1),
// _sublane_kernel_roundtrip_poisson_sep (K3), _sublane_kernel_roundtrip_pmap
// (K8) and _sublane_kernel_fwd_reduce_sep (K13); one template,
// axis_roundtrip_radix_kernel<T, N, MODE>, serves all four. On the same tile
// and passes, the column pass: K5 (msm_fft_axis, either direction), K12
// (msm_axis_inv_kick: the kick on load, the inverse) and K18
// (msm_fft_axis_inv_map: a real map on load, the inverse), replacing
// _sublane_kernel (K5), _sublane_kernel_inv_kphase_sep (K12) and
// _sublane_kernel_inv_pmap (K18); one template, axis_pass_kernel<T, N, INV,
// PRO> (end of the file), serves all three.
//
// What bounds them: device memory. A round trip reads and writes the grid
// once: 0.72 ms at (9, 256^3) complex64 on 3.35 TB/s (K8 also reads the
// real (N, lanes) map; K1's tables are small). The radix-2 form before it
// (axis_roundtrip_kernel in fused_kernels.cu, kept as the wrappers' forced
// form="stages") runs log2 N stages a transform through shared memory with
// a barrier after each: about 270 bytes of shared-memory traffic per
// element and 2 log2 N + 2 barriers, some 1.2 ms of shared-memory time
// alone at that shape, and each block fills its own twiddles with sincospi.
// This design:
//   - Geometry: a block owns one column tile, W columns x N rows, W = 128
//     bytes of each row (16 complex64, 8 complex128), 64 bytes at N = 1024,
//     where 128 would take 1024 threads of 16 complex each; thread t takes
//     column t % W and the 16 elements of group l = t / W. At N = 256
//     complex64: 256 threads, 34 KB of shared memory.
//   - Passes (LanePlan, as the lane kernels): N = P1 P2 P3, 16 x 8, 16 x 16,
//     16 x 16 x 2, 16 x 16 x 4. The forward (decimation in frequency): pass
//     1 loads the 16 elements at stride L = N / 16 of group l straight from
//     device memory into registers (all 16 loads issued before the first is
//     used; a warp covers 32 / W rows of W columns each load), DFT16, times
//     w_N^{l k1}, into shared memory; pass 2 (and 3) as the lane kernels'.
//     The last pass leaves the 16 contiguous positions 16 l + i in
//     registers, at frequency freq_of_position(16 l + i) (the inverse of
//     digit_position), and the epilogue runs there, with no permutation
//     pass: K1 the sums and the kick f0[b, k] f12[b, lane], K3 -coeff /
//     (s0[k] + s12[lane]), K8 map[k, lane]; K13 stores y at its natural row
//     k from registers and stops. The inverse runs the passes backwards on
//     the same registers (decimation in time: the conjugate twiddles before
//     each pass's inverse DFT, the adjoint of the forward pass), the last
//     straight to device memory in natural order. Each pass reads and writes
//     the same positions, so one __syncthreads between passes is enough: 2 a
//     round trip at N <= 256 and 4 at 512, 1024, and 32 bytes of shared
//     traffic per element at N <= 256.
//   - Shared memory: the tile row-major, W elements a row, one row of
//     padding after every 16 (pad16 of the row): a warp's access covers 32 /
//     W rows of W contiguous elements, and with 64-byte rows the pad keeps
//     the two rows a half-warp (complex64) or quarter-warp (complex128)
//     reads in the last pass on different banks.
//   - Twiddles: the wrapper's (N,) table of w_N^m (mxu_fft._twiddles), read
//     through the read-only cache where a pass needs them; no sincospi in
//     the kernel, no fast math.
//   - Sums (K1, K13): each thread adds |y|^2 (y.x^2 + y.y^2 in the kernel's
//     precision, by explicit fma, so that every instantiation rounds it
//     alike) and its alias-band part in double over its registers in order;
//     the block reduces by warp shuffles and then the warps in order into
//     one (sum |y|^2, alias) partial a block, no atomics. K13 takes them in
//     the same code on the same registers, so its sums equal K1's bit for
//     bit on the same field.
//   - The column pass (K5, K12, K18) is one transform: the prologue on
//     pass 1's registers at their loaded rows, the forward's passes (for
//     the inverse the same decimation in frequency with every twiddle
//     conjugated, applied after each DFT: not the round trip's adjoint
//     passes, which start from the forward's digit order), then K13's
//     natural-order store from registers. It reads and writes the grid
//     once (K18 also reads the (N, lanes) map, K12 its two small tables):
//     0.72 ms at (9, 256^3) complex64 on 3.35 TB/s.
// Orders kept from the stages form: k^2 = s0[k] + s12[lane]; K3 divides
// param / k^2 once; the kick is y * (f0 * f12), and K12's x * (f0 * f12).
// In place: a block loads its whole tile into registers before its first
// barrier and writes only its own tile after it, so in == out is allowed.

#pragma once

#include "radix16.cuh"

namespace {

// kFwdReduce: the forward half and the sums only (K13), y stored at row k.
enum RoundTrip { kKickReduce, kPoisson, kMap, kFwdReduce };

template <typename T>
struct RoundTripArgs {
  using C = typename Complex<T>::type;
  const T* s0;       // (n,) k^2 along the transformed axis
  const T* s12;      // (lanes,) k^2 over the trailing axes
  const C* f0;       // (b1, n) exp(i c_b s0)
  const C* f12;      // (b1, lanes) exp(i c_b s12)
  const T* map;      // (n, lanes) real map
  T param;           // kKickReduce, kFwdReduce: alias cutoff; kPoisson: -coeff
  double* partials;  // kKickReduce (or null: no sums), kFwdReduce: (blocks, 2)
                     // sum |y|^2, alias-band sum
};

// Bytes of each row of a radix block's tile (must match mxu_fft._axis_tile).
template <int N>
__host__ __device__ constexpr int axis_tile_bytes() {
  return N == 1024 ? 64 : 128;
}

template <typename T, int N>
struct AxisGeom {
  using C = typename Complex<T>::type;
  static constexpr int W = axis_tile_bytes<N>() / static_cast<int>(sizeof(C));
  static constexpr int kThreads = W * (N / 16);
  static constexpr int kWarps = kThreads / 32;
  // the padded tile (all the column pass uses), then two doubles a warp for
  // the round trip's sums
  static constexpr size_t kTileSmem = static_cast<size_t>(pad16(N)) * W * sizeof(C);
  static constexpr size_t kSmem = kTileSmem + 2 * kWarps * sizeof(double);
  // resident blocks asked of the compiler (__launch_bounds__), from the
  // threads an SM should hold: at complex64 768 for K3 and K13 (three
  // 256-thread blocks at N = 256, a cap of 85 registers, which they meet
  // without spilling) and 512 for K1 and K8 (two blocks, 128 registers: at
  // 85, K1 spilled 24 bytes a thread and K8 240, and K8 took twice as long
  // on an H100 at (9, 256^3); scripts/torch_probe_axis_radix.py, PERF.md);
  // at complex128 256 (255 registers; 128 spilled 136-380 bytes).
  __host__ __device__ static constexpr int min_blocks(int mode) {
    const int per_sm = sizeof(T) == 8 ? 256 : (mode == kPoisson || mode == kFwdReduce ? 768 : 512);
    return per_sm / kThreads > 1 ? per_sm / kThreads : 1;
  }
};

// How far a block body runs (the stage probe times the cut ones).
enum AxisStop { kStopLoadStore, kStopForward, kStopEpilogue, kStopAll };

// The frequency at position p after the forward passes (digit_position's
// inverse).
template <int N>
__host__ __device__ __forceinline__ int freq_of_position(int p) {
  using P = LanePlan<N>;
  return p / P::L + P::P1 * ((p % P::L) / P::P3) + P::P1 * P::P2 * (p % P::P3);
}

// Position of element j of group g in a radix-P pass over sub-blocks of
// length LB: (g / ES) LB + g % ES + j ES, ES = LB / P.
template <int P, int LB>
__device__ __forceinline__ int group_position(int g, int j) {
  constexpr int ES = LB / P;
  return (g / ES) * LB + g % ES + j * ES;
}

// |y|^2 rounded alike wherever it is inlined.
__device__ __forceinline__ float sq_abs(float2 y) { return __fmaf_rn(y.x, y.x, __fmul_rn(y.y, y.y)); }
__device__ __forceinline__ double sq_abs(double2 y) { return __fma_rn(y.x, y.x, __dmul_rn(y.y, y.y)); }

// The DFTs of one pass on a thread's registers v: G = 16 / P groups of P,
// group G l + u in v[u P, u P + P), each group's DFT (inverse DFT when INV)
// and, when TW, output (or input) k times w_LB^{(g % ES) k} = tw[(N / LB)
// (g % ES) k], conjugated when INV. DIT places the twiddles: false (the
// decimation in frequency) after the DFT, on its outputs; true before it,
// on its inputs. The round trip's forward is INV = DIT = false and its
// inverse INV = DIT = true, the forward pass's adjoint (from the forward's
// digit-ordered registers); the column pass's standalone inverse from
// natural rows is INV = true, DIT = false: the forward with every twiddle
// conjugated.
template <typename T, int N, int P, int LB, bool INV, bool TW, bool DIT = INV>
__device__ __forceinline__ void axis_pass_regs(typename Complex<T>::type (&v)[16],
                                               const typename Complex<T>::type* __restrict__ tw,
                                               int l) {
  using C = typename Complex<T>::type;
  constexpr int ES = LB / P;
  constexpr int G = 16 / P;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int m = (N / LB) * ((G * l + u) % ES);
    C d[P];
#pragma unroll
    for (int j = 0; j < P; ++j) d[j] = v[u * P + j];
    if constexpr (TW && DIT) {
#pragma unroll
      for (int k = 1; k < P; ++k) {
        const C t = __ldg(tw + m * k);
        d[k] = cmul(d[k], INV ? cconj(t) : t);
      }
    }
    dft_w16<T, P, INV>(d);
    if constexpr (TW && !DIT) {
#pragma unroll
      for (int k = 1; k < P; ++k) {
        const C t = __ldg(tw + m * k);
        d[k] = cmul(d[k], INV ? cconj(t) : t);
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) v[u * P + j] = d[j];
  }
}

// A pass's registers to and from the tile (position p of column c at
// pad16(p) W + c).
template <typename C, int P, int LB, int W>
__device__ __forceinline__ void axis_regs_to_tile(C* s, const C (&v)[16], int l, int c) {
  constexpr int G = 16 / P;
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int j = 0; j < P; ++j) s[pad16(group_position<P, LB>(G * l + u, j)) * W + c] = v[u * P + j];
  }
}

template <typename C, int P, int LB, int W>
__device__ __forceinline__ void axis_tile_to_regs(const C* s, C (&v)[16], int l, int c) {
  constexpr int G = 16 / P;
#pragma unroll
  for (int u = 0; u < G; ++u) {
#pragma unroll
    for (int j = 0; j < P; ++j) v[u * P + j] = s[pad16(group_position<P, LB>(G * l + u, j)) * W + c];
  }
}

// The forward's passes on a thread's registers (decimation in frequency;
// INV: every twiddle conjugated, the standalone inverse), from pass 1's
// group at natural positions l + L j (loaded by the caller) to the last
// pass's positions 16 l + i, at frequency freq_of_position(16 l + i). s:
// the column tile (position p of column c at pad16(p) W + c) or, with W =
// 1 and c = 0, one row (position p at pad16(p)): split_radix.cuh's rows.
// One __syncthreads between passes; each thread reads and writes only its
// own groups' positions.
template <typename T, int N, bool INV, int W>
__device__ __forceinline__ void dif_passes(typename Complex<T>::type* s,
                                           typename Complex<T>::type (&v)[16],
                                           const typename Complex<T>::type* __restrict__ tw,
                                           int l, int c) {
  using C = typename Complex<T>::type;
  constexpr int L = LanePlan<N>::L;
  constexpr int P2 = LanePlan<N>::P2;
  constexpr int P3 = LanePlan<N>::P3;
  axis_pass_regs<T, N, 16, N, INV, true, false>(v, tw, l);
  axis_regs_to_tile<C, 16, N, W>(s, v, l, c);
  __syncthreads();
  axis_tile_to_regs<C, P2, L, W>(s, v, l, c);
  if constexpr (P3 > 1) {
    axis_pass_regs<T, N, P2, L, INV, true, false>(v, tw, l);
    axis_regs_to_tile<C, P2, L, W>(s, v, l, c);
    __syncthreads();
    axis_tile_to_regs<C, P3, P3, W>(s, v, l, c);
    axis_pass_regs<T, N, P3, P3, INV, false, false>(v, tw, l);
  } else {
    axis_pass_regs<T, N, P2, L, INV, false, false>(v, tw, l);
  }
}

// The same passes backwards, from the last pass's positions 16 l + i (the
// digit order dif_passes leaves) to natural positions l + L j in pass 1's
// registers: decimation in time, each twiddle before its DFT. That is the
// transpose of dif_passes<INV = false>: INV = false takes a spectrum's
// digit-ordered field to its forward transform (split_radix.cuh's forward
// after its inverse), INV = true (the adjoint) to its inverse (the round
// trip's inverse after its forward).
template <typename T, int N, bool INV, int W>
__device__ __forceinline__ void dit_passes(typename Complex<T>::type* s,
                                           typename Complex<T>::type (&v)[16],
                                           const typename Complex<T>::type* __restrict__ tw,
                                           int l, int c) {
  using C = typename Complex<T>::type;
  constexpr int L = LanePlan<N>::L;
  constexpr int P2 = LanePlan<N>::P2;
  constexpr int P3 = LanePlan<N>::P3;
  if constexpr (P3 > 1) {
    axis_pass_regs<T, N, P3, P3, INV, false, true>(v, tw, l);
    axis_regs_to_tile<C, P3, P3, W>(s, v, l, c);
    __syncthreads();
    axis_tile_to_regs<C, P2, L, W>(s, v, l, c);
    axis_pass_regs<T, N, P2, L, INV, true, true>(v, tw, l);
  } else {
    axis_pass_regs<T, N, P2, L, INV, false, true>(v, tw, l);
  }
  axis_regs_to_tile<C, P2, L, W>(s, v, l, c);
  __syncthreads();
  axis_tile_to_regs<C, 16, N, W>(s, v, l, c);
  axis_pass_regs<T, N, 16, N, INV, true, true>(v, tw, l);
}

// The work of one axis_roundtrip_radix_kernel block: the round trip (or
// K13's forward half) of column tile blockIdx.x of (b1, N, lanes); tw: (N,)
// w_N^m. STOP below kStopAll cuts the body for the stage probe
// (scripts/torch_axis_radix_stages.cu): kStopLoadStore stores the loaded
// registers back, kStopForward and kStopEpilogue store the forward's
// registers at their natural rows k as K13 does.
template <typename T, int N, int MODE, int STOP = kStopAll>
__device__ __forceinline__ void axis_roundtrip_tile(const typename Complex<T>::type* in,
                                                    typename Complex<T>::type* out, int64_t lanes,
                                                    int64_t tiles_per_batch, T scale,
                                                    const RoundTripArgs<T>& a,
                                                    const typename Complex<T>::type* __restrict__ tw) {
  using C = typename Complex<T>::type;
  using Geo = AxisGeom<T, N>;
  constexpr int W = Geo::W;
  constexpr int L = LanePlan<N>::L;
  extern __shared__ __align__(16) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  double* red = reinterpret_cast<double*>(s + pad16(N) * W);  // 2 per warp
  const int64_t b = blockIdx.x / tiles_per_batch;
  const int64_t lane = (blockIdx.x - b * tiles_per_batch) * W + threadIdx.x % W;
  const int c = threadIdx.x % W;
  const int l = threadIdx.x / W;
  const C* src = in + b * N * lanes + lane;
  C* dst = out + b * N * lanes + lane;

  // pass 1's group, rows l + L j, straight from device memory
  C v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = src[(l + L * j) * lanes];
  if constexpr (STOP == kStopLoadStore) {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[(l + L * j) * lanes] = v[j];
    return;
  }

  dif_passes<T, N, false, W>(s, v, tw, l, c);

  // the epilogue at register i's frequency k. The sums are taken where they
  // are asked for; a null K1 partials is the same for the whole launch, so
  // the block's __syncthreads below is reached by all threads or by none.
  constexpr bool kSums = MODE == kKickReduce || MODE == kFwdReduce;
  const bool reduce = kSums && STOP >= kStopEpilogue && a.partials != nullptr;
  double ns = 0.0;
  double am = 0.0;
  if constexpr (STOP >= kStopEpilogue) {
    const T s12 = MODE == kMap ? T(0) : a.s12[lane];
    C f12{};
    if constexpr (MODE == kKickReduce) f12 = a.f12[b * lanes + lane];
#pragma unroll
    for (int i = 0; i < 16; ++i) {
      const int k = freq_of_position<N>(16 * l + i);
      C y = cscale(v[i], scale);
      if constexpr (kSums) {
        if (reduce) {
          const T p2 = sq_abs(y);
          ns += p2;
          if (a.s0[k] + s12 > a.param) am += p2;
        }
      }
      if constexpr (MODE == kKickReduce) {
        y = cmul(y, cmul(a.f0[b * N + k], f12));
      } else if constexpr (MODE == kPoisson) {
        const T k2 = a.s0[k] + s12;
        y = cscale(y, k2 > T(0) ? a.param / k2 : T(0));
      } else if constexpr (MODE == kMap) {
        y = cscale(y, a.map[k * lanes + lane]);
      }
      v[i] = y;
    }
  }

  if constexpr (MODE == kFwdReduce || STOP < kStopAll) {
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[freq_of_position<N>(16 * l + i) * lanes] = v[i];
  } else {
    // the inverse: the passes backwards, the last to device memory
    dit_passes<T, N, true, W>(s, v, tw, l, c);
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[(l + L * j) * lanes] = cscale(v[j], scale);
  }

  if (reduce) {
    for (int off = 16; off > 0; off >>= 1) {
      ns += __shfl_down_sync(0xffffffffu, ns, off);
      am += __shfl_down_sync(0xffffffffu, am, off);
    }
    const int warp = threadIdx.x >> 5;
    if ((threadIdx.x & 31) == 0) {
      red[2 * warp] = ns;
      red[2 * warp + 1] = am;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      double sn = 0.0;
      double sa = 0.0;
      for (int q = 0; q < Geo::kWarps; ++q) {
        sn += red[2 * q];
        sa += red[2 * q + 1];
      }
      a.partials[2 * static_cast<int64_t>(blockIdx.x)] = sn;
      a.partials[2 * static_cast<int64_t>(blockIdx.x) + 1] = sa;
    }
  }
}

// K1, K3, K8, K13 (the whole body).
template <typename T, int N, int MODE, int MIN_BLOCKS = AxisGeom<T, N>::min_blocks(MODE)>
__global__ void __launch_bounds__(AxisGeom<T, N>::kThreads, MIN_BLOCKS)
    axis_roundtrip_radix_kernel(const typename Complex<T>::type* in,
                                typename Complex<T>::type* out, int64_t lanes,
                                int64_t tiles_per_batch, T scale, RoundTripArgs<T> a,
                                const typename Complex<T>::type* __restrict__ tw) {
  axis_roundtrip_tile<T, N, MODE>(in, out, lanes, tiles_per_batch, scale, a, tw);
}

// (b1, N, lanes): one block per column tile; lanes % W == 0. The shared
// memory limit is raised once per instantiation (above 48 KB at N = 512 and
// 1024).
template <typename T, int N, int MODE>
cudaError_t launch_roundtrip_radix_n(const void* in, void* out, int64_t b1, int64_t lanes,
                                     const RoundTripArgs<T>& a, const void* tw,
                                     cudaStream_t stream) {
  using C = typename Complex<T>::type;
  using Geo = AxisGeom<T, N>;
  static const cudaError_t err =
      cudaFuncSetAttribute(axis_roundtrip_radix_kernel<T, N, MODE>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(Geo::kSmem));
  if (err != cudaSuccess) return err;
  const int64_t tiles = lanes / Geo::W;
  axis_roundtrip_radix_kernel<T, N, MODE>
      <<<static_cast<unsigned>(b1 * tiles), Geo::kThreads, Geo::kSmem, stream>>>(
          static_cast<const C*>(in), static_cast<C*>(out), lanes, tiles,
          static_cast<T>(1.0 / std::sqrt(double(N))), a, static_cast<const C*>(tw));
  return cudaGetLastError();
}

// K1, K3, K8, K13 on columns of n = 2^log_n, n in {128, 256, 512, 1024};
// tw: (n,) w_n^m.
template <typename T, int MODE>
cudaError_t launch_roundtrip_radix(const void* in, void* out, int64_t b1, int log_n,
                                   int64_t lanes, const RoundTripArgs<T>& a, const void* tw,
                                   cudaStream_t stream) {
  switch (log_n) {
    case 7:
      return launch_roundtrip_radix_n<T, 128, MODE>(in, out, b1, lanes, a, tw, stream);
    case 8:
      return launch_roundtrip_radix_n<T, 256, MODE>(in, out, b1, lanes, a, tw, stream);
    case 9:
      return launch_roundtrip_radix_n<T, 512, MODE>(in, out, b1, lanes, a, tw, stream);
    case 10:
      return launch_roundtrip_radix_n<T, 1024, MODE>(in, out, b1, lanes, a, tw, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

// The work of one axis_pass_kernel block: one transform (the inverse when
// INV) along axis 1 of column tile blockIdx.x of (b1, N, lanes), with PRO's
// factor on each element as pass 1 loads it at its natural row r = l + L j
// (kKick: v (f0[b, r] f12[b, lane]), the product in the order the stages
// form and the TPU kernel take it; kMap: v map[r, lane]); the forward's
// passes (decimation in frequency; the inverse with conjugate twiddles, on
// each DFT's outputs), then the last pass's registers stored from
// registers at their natural rows freq_of_position(16 l + i), as K13
// stores. tw: (N,) w_N^m. STOP = kStopLoadStore stores the loaded (and
// multiplied) registers back at their rows (the stage probe,
// scripts/torch_axis_radix_stages.cu).
template <typename T, int N, bool INV, AxisPrologue PRO, int STOP = kStopAll>
__device__ __forceinline__ void axis_pass_tile(const typename Complex<T>::type* in,
                                               typename Complex<T>::type* out, int64_t lanes,
                                               int64_t tiles_per_batch, T scale,
                                               const AxisLoad<T>& pro,
                                               const typename Complex<T>::type* __restrict__ tw) {
  using C = typename Complex<T>::type;
  constexpr int W = AxisGeom<T, N>::W;
  constexpr int L = LanePlan<N>::L;
  extern __shared__ __align__(16) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  // K18's map is shared by the batch, so its blocks take the batch elements
  // of one column tile in turn (block tile b1 + b): the tile's map rows come
  // from device memory once and from L2 for the other elements. The other
  // prologues take the tiles of one element in turn (block b tiles + tile).
  constexpr bool kBatchFast = PRO == AxisPrologue::kMap;
  const int64_t b1 = gridDim.x / tiles_per_batch;
  const int64_t b = kBatchFast ? blockIdx.x % b1 : blockIdx.x / tiles_per_batch;
  const int64_t tile = kBatchFast ? blockIdx.x / b1 : blockIdx.x - b * tiles_per_batch;
  const int64_t lane = tile * W + threadIdx.x % W;
  const int c = threadIdx.x % W;
  const int l = threadIdx.x / W;
  const C* src = in + b * N * lanes + lane;
  C* dst = out + b * N * lanes + lane;

  C v[16];
#pragma unroll
  for (int j = 0; j < 16; ++j) v[j] = src[(l + L * j) * lanes];
  if constexpr (PRO == AxisPrologue::kKick) {
    const C f12 = pro.f12[b * lanes + lane];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = cmul(v[j], cmul(pro.f0[b * N + l + L * j], f12));
  } else if constexpr (PRO == AxisPrologue::kMap) {
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = cscale(v[j], pro.map[(l + L * j) * lanes + lane]);
  }
  if constexpr (STOP == kStopLoadStore) {
#pragma unroll
    for (int j = 0; j < 16; ++j) dst[(l + L * j) * lanes] = v[j];
    return;
  }

  dif_passes<T, N, INV, W>(s, v, tw, l, c);
#pragma unroll
  for (int i = 0; i < 16; ++i) dst[freq_of_position<N>(16 * l + i) * lanes] = cscale(v[i], scale);
}

// K5 (kNone, either direction), K12 (kKick, inverse) and K18 (kMap,
// inverse): the whole column pass. Resident blocks asked of the compiler:
// K13's (min_blocks(kFwdReduce)), whose passes and natural-order store it
// shares, for all three prologues: at complex64 three 256-thread blocks at
// N = 256 (80 registers, no spills). On an H100 at (9, 256^3) K12 took
// 0.868-0.899 ms at three blocks against 0.911-0.919 at two (128
// registers) and 1.25-1.26 at one; K5 and K18 were within 2 % between
// two and three (scripts/torch_probe_axis_radix.py, PERF.md). At
// complex128 142-160 registers, no spills.
template <typename T, int N, bool INV, AxisPrologue PRO,
          int MIN_BLOCKS = AxisGeom<T, N>::min_blocks(kFwdReduce)>
__global__ void __launch_bounds__(AxisGeom<T, N>::kThreads, MIN_BLOCKS)
    axis_pass_kernel(const typename Complex<T>::type* in, typename Complex<T>::type* out,
                     int64_t lanes, int64_t tiles_per_batch, T scale, AxisLoad<T> pro,
                     const typename Complex<T>::type* __restrict__ tw) {
  axis_pass_tile<T, N, INV, PRO>(in, out, lanes, tiles_per_batch, scale, pro, tw);
}

// (b1, N, lanes): one block per column tile; lanes % W == 0.
template <typename T, int N, bool INV, AxisPrologue PRO>
cudaError_t launch_axis_pass_radix_n(const void* in, void* out, int64_t b1, int64_t lanes,
                                     const AxisLoad<T>& pro, const void* tw,
                                     cudaStream_t stream) {
  using C = typename Complex<T>::type;
  using Geo = AxisGeom<T, N>;
  static const cudaError_t err =
      cudaFuncSetAttribute(axis_pass_kernel<T, N, INV, PRO>,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           static_cast<int>(Geo::kTileSmem));
  if (err != cudaSuccess) return err;
  const int64_t tiles = lanes / Geo::W;
  axis_pass_kernel<T, N, INV, PRO>
      <<<static_cast<unsigned>(b1 * tiles), Geo::kThreads, Geo::kTileSmem, stream>>>(
          static_cast<const C*>(in), static_cast<C*>(out), lanes, tiles,
          static_cast<T>(1.0 / std::sqrt(double(N))), pro, static_cast<const C*>(tw));
  return cudaGetLastError();
}

// K5, K12, K18 on columns of n = 2^log_n, n in {128, 256, 512, 1024}; tw:
// (n,) w_n^m.
template <typename T, bool INV, AxisPrologue PRO>
cudaError_t launch_axis_pass_radix(const void* in, void* out, int64_t b1, int log_n,
                                   int64_t lanes, const AxisLoad<T>& pro, const void* tw,
                                   cudaStream_t stream) {
  switch (log_n) {
    case 7:
      return launch_axis_pass_radix_n<T, 128, INV, PRO>(in, out, b1, lanes, pro, tw, stream);
    case 8:
      return launch_axis_pass_radix_n<T, 256, INV, PRO>(in, out, b1, lanes, pro, tw, stream);
    case 9:
      return launch_axis_pass_radix_n<T, 512, INV, PRO>(in, out, b1, lanes, pro, tw, stream);
    case 10:
      return launch_axis_pass_radix_n<T, 1024, INV, PRO>(in, out, b1, lanes, pro, tw, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
