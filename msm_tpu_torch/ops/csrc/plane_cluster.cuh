// The one-pass (N, N) plane on a thread-block cluster: the 2-axis DFT of K6
// (plane_pass), its real-input forward K17 (plane_pass_real_fwd) and its
// real-output inverse K9 (plane_pass_real_inv) (fft_kernels.cu), the
// inverse -> middle step -> forward of K4 (plane_potkick_fwd), K2
// (plane_inv_density) and K10 (plane_inv_density_rho_only), and the
// inverse's max |Re| of K11 (plane_real_inv_max) (fused_kernels.cu), for N
// = 128 and 256.
//
// What bounds them: device memory. Each reads its inputs once and writes its
// outputs once (K6 and K10: 2 grids, 0.72 ms at (9, 256^3) complex64 on 3.35
// TB/s; K17 and K9: a real and a complex grid, 1.5 grids, 0.54 ms; K4 and
// K2: 3 grids, 1.08 ms; K11: one grid and a maximum a block, 0.36 ms). The
// split form (a row pass and column passes with the intermediate in device
// memory) moves 4 (K6), 3.5 (K17, K9), 6 (K10), 7 (K4, K2) and 3 (K11)
// grids. A 256^2 complex64 plane is 512 KB, more than a
// block's 227 KB of shared memory, but it fits a cluster of C = 8 blocks (64
// KB each; complex128: 128 KB), and the blocks of a cluster read and write
// each other's shared memory (distributed shared memory,
// cooperative_groups::this_cluster().map_shared_rank). The design
// moves each element between blocks once per 2-axis transform (a transpose),
// not twice (a radix-C stage that reads from and writes to the peers).
//
// Layout. One plane per cluster, in shared memory, one complex of padding
// after every 16 (pad16), so that a thread walking 16 contiguous elements and
// its neighbours walking theirs hit different banks. Block `rank` first holds
// the R = N / C rows [R rank, R rank + R), row-major (its "row slab").
//
// Transforms. Each length-N transform is N = A * B (16 x 16 at N = 256,
// 16 x 8 at 128), two radix passes in registers with one __syncthreads each,
// in place in shared memory:
//   DIF (natural in): pass 1 takes the A elements at stride B of group g < B,
//     DFTs them and multiplies output k by w_N^{g k}; pass 2 DFTs the B
//     contiguous elements of group k1 < A. Position B k1 + k2 then holds
//     frequency k1 + A k2 ("transposed" order).
//   DIT (transposed in, natural out): the same two passes in reverse order,
//     the twiddle on the contiguous pass.
// The order is undone where data cross device memory, at no cost: a DIT row
// pass scatters each row into transposed positions as it loads it, and a
// DIF pass's output is gathered from them as it is stored.
//
// The columns: a transpose across the cluster. After the row pass the block
// slab's column chunk j (columns [W j, W j + W), W = N / C) belongs to block
// j. Tile (block r, chunk j) and tile (block j, chunk r) change places, row
// by row, by one thread that reads the remote element, reads the local one
// and writes each where the other was (the two blocks of a pair split the
// tile's rows). Afterwards block r holds every row of the columns [W r,
// W r + W): its chunk slot s holds rows [R s, R s + R) of them (its "column
// slab"), so column w's element of row y sits at slot y / R, slab row y % R.
// Each element crosses once; no thread of the cluster touches another's
// elements, so the swap needs no barrier between its reads and writes:
// cluster.sync() comes before it (every block's row pass done) and after it
// (every write visible, and no block leaves while a peer still reads it).
// The same swap takes a column slab back to a row slab.
//
//   K6: load (scatter) -> rows DIT -> swap -> columns DIF -> store (gather):
//     each warp stores a W-element run of one output row (256 bytes at
//     complex64, N = 256).
//   K17 and K9: K6's kernel with a real operand on one side
//     (plane_cluster_kernel's vector traits): K17 loads four floats (two
//     doubles) a 16-byte load and scatters them with imaginary part 0 where
//     K6's load puts a complex; K9 stores the scaled real part of the
//     column lines, runs of R reals of one output row (store_columns, the
//     epilogue after rows_to_columns).
//   K11: K9's load and rows_to_columns, whose columns' last pass takes the
//     maximum of |scale Re| of its outputs in registers in place of
//     storing them (last_pass_max); block_max leaves one partial a block,
//     in a fixed order (no atomics); the wrapper reduces them per plane.
//   K4, K2, K10: the input's rows DIT inverse -> swap -> columns DIF
//     inverse (rows_to_columns): the field at spatial (row y, column
//     W rank + w), column position transposed(y); the middle step in place
//     there; columns DIT forward (from the transposed order, no
//     permutation) -> swap -> rows DIF forward (columns_to_rows) -> store
//     (gather), the block's R contiguous rows. The middle step:
//     K4 (kick_columns): max|phi| of the block, psi's element read at
//       (y, W rank + w) in W-runs of one row, psi exp(i c phi);
//     K2 (density_columns<WRITE_PSI>): psi written at (y, W rank + w) in
//       W-runs of one row, the mirror of K4's read; rho = pref |psi|^2;
//     K10: K2 without the write.
//
// Keeping memory busy: 256 threads a block and, at complex64, about 70 KB of
// shared memory, so three blocks (3 x 256 threads, __launch_bounds__ min 3)
// are resident per SM: while one block transforms or swaps, the others'
// loads and stores are in flight. At complex128 a 256^2 plane needs 136 KB a
// block: one block per SM, nothing overlaps its compute (the main path is
// complex64). N = 128 takes C = 2 (complex64) and C = 4 (complex128), about
// 70 KB a block as well. Before the first launch of a configuration the
// launcher asks cudaOccupancyMaxActiveClusters and fails with
// cudaErrorLaunchOutOfResources if no cluster fits.
//
// Accuracy: FP32 (or FP64) CUDA-core arithmetic, no fast math. Twiddles
// come from a table of w_N^m = exp(-2 pi i m / N), m < N, that the wrapper
// computes once per (N, dtype) in double and rounds once (mxu_fft
// `_twiddles`); each block copies it into shared memory.

#pragma once

#include <cooperative_groups.h>

#include <type_traits>

#include "fft_common.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kClusterThreads = 256;

__host__ __device__ constexpr int pad16(int i) { return i + (i >> 4); }

// Radix A of a length-N transform, N = A * B.
__host__ __device__ constexpr int plan_a(int n) { return n <= 16 ? n : 16; }

// Blocks of a cluster per plane; must match mxu_fft._plane_form.
template <typename T, int N>
__host__ __device__ constexpr int cluster_size() {
  return N == 256 ? 8 : (sizeof(T) == 4 ? 2 : 4);
}

template <typename T, int N>
constexpr size_t cluster_smem() {
  using C = typename Complex<T>::type;
  constexpr int R = N / cluster_size<T, N>();
  // the padded slab, the twiddle table, 32 reals for a block reduction
  return (static_cast<size_t>(pad16(R * N)) + N) * sizeof(C) + 32 * sizeof(T);
}

// 16-byte vectors of device memory: two complex64 or one complex128.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  using elem = float2;
  static constexpr int kElems = 2;
  __device__ static void split(float4 v, float2 (&e)[2]) {
    e[0] = make_float2(v.x, v.y);
    e[1] = make_float2(v.z, v.w);
  }
  __device__ static float4 join(const float2 (&e)[2]) {
    return make_float4(e[0].x, e[0].y, e[1].x, e[1].y);
  }
};
template <>
struct Vec<double> {
  using type = double2;
  using elem = double2;
  static constexpr int kElems = 1;
  __device__ static void split(double2 v, double2 (&e)[1]) { e[0] = v; }
  __device__ static double2 join(const double2 (&e)[1]) { return e[0]; }
};

// Their real counterpart, for a real operand of a complex transform (K17's
// input, K9's output): four floats or two doubles, split into complex
// elements with imaginary part 0 and joined from their real parts.
template <typename T>
struct RealVec;
template <>
struct RealVec<float> {
  using type = float4;
  using elem = float;
  static constexpr int kElems = 4;
  __device__ static void split(float4 v, float2 (&e)[4]) {
    e[0] = make_float2(v.x, 0.0f);
    e[1] = make_float2(v.y, 0.0f);
    e[2] = make_float2(v.z, 0.0f);
    e[3] = make_float2(v.w, 0.0f);
  }
  __device__ static float4 join(const float2 (&e)[4]) {
    return make_float4(e[0].x, e[1].x, e[2].x, e[3].x);
  }
};
template <>
struct RealVec<double> {
  using type = double2;
  using elem = double;
  static constexpr int kElems = 2;
  __device__ static void split(double2 v, double2 (&e)[2]) {
    e[0] = make_double2(v.x, 0.0);
    e[1] = make_double2(v.y, 0.0);
  }
  __device__ static double2 join(const double2 (&e)[2]) { return make_double2(e[0].x, e[1].x); }
};

// K7's load: psi's 16-byte vectors (Vec<T>), each complex element
// scattered as rho = pref (re^2 + im^2) with imaginary part 0, in the plain
// version's order; pref is the kernel's argument. The other traits' split
// is static, called through the kernel's (empty) trait argument alike.
template <typename T>
struct DensityVec {
  using type = typename Vec<T>::type;
  using elem = typename Vec<T>::elem;
  static constexpr int kElems = Vec<T>::kElems;
  T pref;
  __device__ void split(type v, elem (&e)[kElems]) const {
    Vec<T>::split(v, e);
#pragma unroll
    for (int k = 0; k < kElems; ++k) {
      e[k].x = pref * (e[k].x * e[k].x + e[k].y * e[k].y);
      e[k].y = T(0);
    }
  }
};

// Vectors a thread of a block moves per batch of device-memory loads: all
// issued before any is used.
constexpr int kBatch = 8;

template <bool INV, typename C>
__device__ __forceinline__ C twiddle(const C* tw, int m) {
  const C t = tw[m];
  return INV ? cconj(t) : t;
}

// v[k] = sum_j v[j] w_P^{j k}, natural order in and out: radix-2 decimation
// in frequency over the registers, then the bit-reversal permutation (both
// resolved at compile time). w_P^m = tw[m * step] with step = N / P.
template <typename T, int P, bool INV>
__device__ __forceinline__ void dft_regs(typename Complex<T>::type (&v)[P],
                                         const typename Complex<T>::type* tw, int step) {
#pragma unroll
  for (int h = P / 2; h >= 1; h >>= 1) {
#pragma unroll
    for (int i = 0; i < P; ++i) {
      if ((i & h) == 0) {
        const int k = i & (h - 1);
        const auto a = v[i];
        const auto b = v[i + h];
        v[i] = cadd(a, b);
        const auto d = csub(a, b);
        v[i + h] = k == 0 ? d : cmul(d, twiddle<INV>(tw, k * (P / (2 * h)) * step));
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

// The lines of a slab: the R rows of a row slab (position p of row l at
// l * N + p) ...
template <int N>
struct RowLines {
  static constexpr bool kLinesFast = false;  // consecutive threads: groups
  __device__ static int at(int line, int p) { return pad16(line * N + p); }
};

// ... or the W columns of a column slab (row y of column w in slot y / R,
// slab row y % R).
template <int N, int R>
struct ColLines {
  static constexpr bool kLinesFast = true;  // consecutive threads: columns
  __device__ static int at(int line, int y) {
    return pad16((y % R) * N + (y / R) * R + line);
  }
};

// One radix-P pass over `lines` lines of a length-N transform in s: group g
// (< groups) of a line holds the P elements at positions g * gs + j * es,
// replaced in place by their DFT (output k at g * gs + k * es), times
// w_N^{g k} when TW.
template <typename T, int N, int P, bool INV, bool TW, typename Lines>
__device__ __forceinline__ void radix_pass(typename Complex<T>::type* s,
                                           const typename Complex<T>::type* tw, int lines,
                                           int groups, int gs, int es) {
  using C = typename Complex<T>::type;
  if constexpr (P > 1) {
    for (int t = threadIdx.x; t < lines * groups; t += kClusterThreads) {
      const int line = Lines::kLinesFast ? t % lines : t / groups;
      const int g = Lines::kLinesFast ? t / lines : t % groups;
      C v[P];
#pragma unroll
      for (int j = 0; j < P; ++j) v[j] = s[Lines::at(line, g * gs + j * es)];
      dft_regs<T, P, INV>(v, tw, N / P);
      if (TW && g != 0) {
#pragma unroll
        for (int k = 1; k < P; ++k) v[k] = cmul(v[k], twiddle<INV>(tw, g * k));
      }
#pragma unroll
      for (int j = 0; j < P; ++j) s[Lines::at(line, g * gs + j * es)] = v[j];
    }
  }
  __syncthreads();
}

// The length-N transform of every line of a slab.
template <typename T, int N, bool INV, bool DIT, typename Lines>
__device__ __forceinline__ void slab_fft(typename Complex<T>::type* s,
                                         const typename Complex<T>::type* tw, int lines) {
  constexpr int A = plan_a(N);
  constexpr int B = N / A;
  if constexpr (DIT) {
    radix_pass<T, N, B, INV, true, Lines>(s, tw, lines, A, B, 1);
    radix_pass<T, N, A, INV, false, Lines>(s, tw, lines, B, 1, B);
  } else {
    radix_pass<T, N, A, INV, true, Lines>(s, tw, lines, B, 1, B);
    radix_pass<T, N, B, INV, false, Lines>(s, tw, lines, A, B, 1);
  }
}

// Position of natural index i in a DIF-transposed line of length N.
template <int N>
__device__ __forceinline__ int transposed(int i) {
  constexpr int A = plan_a(N);
  constexpr int B = N / A;
  return B * (i % A) + i / A;
}

// Elements a thread of swap_tiles has in flight: 4 in K6, 2 in the kernels
// with two transforms (K4, K2, K10), where 4 spilled 56-88 bytes a thread
// at complex64 under the 3-blocks-per-SM bound and took 0.15-0.25 ms more
// on an H100 at (9, 256^3) (PERF.md); 8 spilled in K4 and was slower still.
constexpr int kSwapOnePass = 4;
constexpr int kSwapTwoPass = 2;

// The swap of tiles (block rank, chunk j) <-> (block j, chunk rank) for
// every j != rank (see the note): rows [0, R/2) of the pair's tiles by the
// lower rank, [R/2, R) by the higher. U elements a thread are read before
// any is written, so their remote reads are in flight together.
template <typename T, int N, int CL, int U>
__device__ __forceinline__ void swap_tiles(cg::cluster_group& cluster,
                                           typename Complex<T>::type* s, int rank) {
  using C = typename Complex<T>::type;
  constexpr int W = N / CL;
  constexpr int HALF = W / 2;  // R = W
  constexpr int ITEMS = (CL - 1) * HALF * W;
  for (int t0 = threadIdx.x; t0 < ITEMS; t0 += U * kClusterThreads) {
    C a[U];
    C* peer[U];
    int mine[U], theirs[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = t0 + u * kClusterThreads;
      if (t < ITEMS) {
        const int w = t % W;
        const int d = 1 + t / (HALF * W);
        const int j = (rank + d) % CL;
        const int row = (rank < j ? 0 : HALF) + (t / W) % HALF;
        mine[u] = pad16(row * N + j * W + w);
        theirs[u] = pad16(row * N + rank * W + w);
        peer[u] = cluster.map_shared_rank(s, j);
        a[u] = peer[u][theirs[u]];
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (t0 + u * kClusterThreads < ITEMS) {
        peer[u][theirs[u]] = s[mine[u]];
        s[mine[u]] = a[u];
      }
    }
  }
}

template <typename T, int N>
__device__ __forceinline__ void load_twiddles(typename Complex<T>::type* tw,
                                              const typename Complex<T>::type* twg) {
  for (int i = threadIdx.x; i < N; i += kClusterThreads) tw[i] = twg[i];
}

// R contiguous rows of src into a row slab, each row scattered into the
// transposed order a DIT row pass takes: 16-byte loads, kBatch in flight.
// VIN: Vec<T> (complex rows), RealVec<T> (real rows, imaginary part 0) or
// DensityVec<T> (complex rows, their density), split through `load`.
template <typename T, int N, int R, typename VIN = Vec<T>>
__device__ __forceinline__ void load_rows_transposed(typename Complex<T>::type* s,
                                                     const typename VIN::elem* src,
                                                     const VIN& load = VIN{}) {
  using C = typename Complex<T>::type;
  using V = typename VIN::type;
  constexpr int E = VIN::kElems;
  constexpr int ITERS = R * N / E / kClusterThreads;
  static_assert(ITERS % kBatch == 0, "whole batches");
  const V* vsrc = reinterpret_cast<const V*>(src);
  for (int b = 0; b < ITERS; b += kBatch) {
    V v[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) v[u] = vsrc[threadIdx.x + (b + u) * kClusterThreads];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      C e[E];
      load.split(v[u], e);
      const int x = (threadIdx.x + (b + u) * kClusterThreads) * E;
#pragma unroll
      for (int k = 0; k < E; ++k) s[pad16((x / N) * N + transposed<N>(x % N + k))] = e[k];
    }
  }
}

// The block's R rows from the DIF-transposed row slab into dst (contiguous),
// 16-byte stores.
template <typename T, int N, int R>
__device__ __forceinline__ void store_rows_transposed(typename Complex<T>::type* dst,
                                                      const typename Complex<T>::type* s,
                                                      T scale) {
  using C = typename Complex<T>::type;
  using V = typename Vec<T>::type;
  constexpr int E = Vec<T>::kElems;
  V* vdst = reinterpret_cast<V*>(dst);
#pragma unroll 4
  for (int i = threadIdx.x; i < R * N / E; i += kClusterThreads) {
    C e[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int x = i * E + k;
      e[k] = cscale(s[pad16((x / N) * N + transposed<N>(x % N))], scale);
    }
    vdst[i] = Vec<T>::join(e);
  }
}

// Rows DIT, the swap, columns DIF of the block's row slab (loaded in the
// transposed order): afterwards column line w of block rank holds the
// unscaled 2-axis transform at spatial (or frequency) column R rank + w,
// row y at position transposed(y). U: swap_tiles' elements in flight.
template <typename T, int N, bool INV, int U>
__device__ __forceinline__ void rows_to_columns(cg::cluster_group& cluster,
                                                typename Complex<T>::type* s,
                                                const typename Complex<T>::type* tw, int rank) {
  constexpr int CL = cluster_size<T, N>();
  constexpr int R = N / CL;
  slab_fft<T, N, INV, true, RowLines<N>>(s, tw, R);
  cluster.sync();
  swap_tiles<T, N, CL, U>(cluster, s, rank);
  cluster.sync();
  slab_fft<T, N, INV, false, ColLines<N, R>>(s, tw, R);
}

// Columns DIT (from the transposed order, no permutation), the swap, rows
// DIF: the row slab in the DIF-transposed order store_rows_transposed takes.
// The caller has synchronised the block after the last write to s.
template <typename T, int N, bool INV>
__device__ __forceinline__ void columns_to_rows(cg::cluster_group& cluster,
                                                typename Complex<T>::type* s,
                                                const typename Complex<T>::type* tw, int rank) {
  constexpr int CL = cluster_size<T, N>();
  constexpr int R = N / CL;
  slab_fft<T, N, INV, true, ColLines<N, R>>(s, tw, R);
  cluster.sync();
  swap_tiles<T, N, CL, kSwapTwoPass>(cluster, s, rank);
  cluster.sync();
  slab_fft<T, N, INV, false, RowLines<N>>(s, tw, R);
}

// The store of K6 and K9, the epilogue after rows_to_columns: row f of the
// block's output columns [R rank, R rank + R) is column position
// transposed(f) of the slab's lines, scaled; runs of R elements of one row,
// 16-byte stores. VOUT: Vec<T> (complex out) or RealVec<T> (the real part
// out). dst: the plane's column R rank.
template <typename T, int N, typename VOUT>
__device__ __forceinline__ void store_columns(typename VOUT::elem* dst,
                                              const typename Complex<T>::type* s, T scale) {
  using C = typename Complex<T>::type;
  using V = typename VOUT::type;
  constexpr int R = N / cluster_size<T, N>();
  constexpr int E = VOUT::kElems;
  V* vdst = reinterpret_cast<V*>(dst);
#pragma unroll 4
  for (int i = threadIdx.x; i < R * N / E; i += kClusterThreads) {
    const int f = i * E / R;
    const int w = i * E % R;
    C e[E];
#pragma unroll
    for (int k = 0; k < E; ++k) e[k] = cscale(s[ColLines<N, R>::at(w + k, transposed<N>(f))], scale);
    vdst[(f * N + w) / E] = VOUT::join(e);
  }
}

// K6, K17, K9 and K7: the ortho 2-axis DFT of plane blockIdx.x / CL, loaded
// through VIN (`load`) and stored through VOUT: K6 complex to complex
// (Vec<T>, both directions), K17 the forward of a real plane (RealVec<T> in,
// imaginary part 0), K9 the real part of the inverse (RealVec<T> out, half
// K6's write), K7 the forward of pref |psi|^2 (DensityVec<T> in: psi read
// once, K6's bytes).
template <typename T, int N, bool INV, typename VIN, typename VOUT>
__global__ void __launch_bounds__(kClusterThreads, sizeof(T) == 4 ? 3 : 1)
    plane_cluster_kernel(const typename VIN::elem* in, typename VOUT::elem* out,
                         const typename Complex<T>::type* twg, T scale, VIN load) {
  using C = typename Complex<T>::type;
  constexpr int CL = cluster_size<T, N>();
  constexpr int R = N / CL;
  extern __shared__ __align__(16) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  C* tw = s + pad16(R * N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / CL;

  load_twiddles<T, N>(tw, twg);
  load_rows_transposed<T, N, R, VIN>(s, in + (plane * N + rank * R) * N, load);
  __syncthreads();
  rows_to_columns<T, N, INV, kSwapOnePass>(cluster, s, tw, rank);
  store_columns<T, N, VOUT>(out + plane * N * N + rank * R, s, scale);
}

// K4's middle: phi = scale Re s at spatial (y, R rank + w), psi's element
// there read from psi_slab (its plane's columns [R rank, R rank + R)) in
// runs of R columns, 16-byte loads, kBatch / 2 in flight; s = psi exp(i c
// phi). Returns max|phi| over the thread's elements.
template <typename T, int N>
__device__ __forceinline__ T kick_columns(typename Complex<T>::type* s,
                                          const typename Complex<T>::type* psi_slab, T c,
                                          T scale) {
  using C = typename Complex<T>::type;
  using V = typename Vec<T>::type;
  constexpr int R = N / cluster_size<T, N>();
  constexpr int E = Vec<T>::kElems;
  constexpr int KB = kBatch / 2;
  constexpr int ITERS = R * N / E / kClusterThreads;
  static_assert(ITERS % KB == 0, "whole batches");
  const V* p_slab = reinterpret_cast<const V*>(psi_slab);
  T mx = T(0);
  for (int b = 0; b < ITERS; b += KB) {
    V pv[KB];
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int i = threadIdx.x + (b + u) * kClusterThreads;
      pv[u] = p_slab[(i * E / R * N + i * E % R) / E];
    }
#pragma unroll
    for (int u = 0; u < KB; ++u) {
      const int i = threadIdx.x + (b + u) * kClusterThreads;
      const int y = i * E / R;
      C p[E];
      Vec<T>::split(pv[u], p);
#pragma unroll
      for (int k = 0; k < E; ++k) {
        const int idx = ColLines<N, R>::at(i * E % R + k, transposed<N>(y));
        const T phi = s[idx].x * scale;
        mx = nan_max(mx, phi < T(0) ? -phi : phi);
        T sn, cs;
        sincos_acc(c * phi, &sn, &cs);
        C r;
        r.x = p[k].x * cs - p[k].y * sn;
        r.y = p[k].y * cs + p[k].x * sn;
        s[idx] = r;
      }
    }
  }
  return mx;
}

// K2's and K10's middle: psi = scale s at spatial (y, R rank + w), written
// (WRITE_PSI) to psi_slab, its plane's columns [R rank, R rank + R), in runs
// of R columns, 16-byte stores (stores do not wait, so no batching); s =
// pref |psi|^2, imaginary part 0. Each element is read and written by one
// thread.
template <typename T, int N, bool WRITE_PSI>
__device__ __forceinline__ void density_columns(typename Complex<T>::type* s,
                                                typename Complex<T>::type* psi_slab, T pref,
                                                T scale) {
  using C = typename Complex<T>::type;
  using V = typename Vec<T>::type;
  constexpr int R = N / cluster_size<T, N>();
  constexpr int E = Vec<T>::kElems;
#pragma unroll 4
  for (int i = threadIdx.x; i < R * N / E; i += kClusterThreads) {
    const int y = i * E / R;
    const int w = i * E % R;
    C e[E];
#pragma unroll
    for (int k = 0; k < E; ++k) {
      const int idx = ColLines<N, R>::at(w + k, transposed<N>(y));
      e[k] = cscale(s[idx], scale);
      C r;
      r.x = pref * (e[k].x * e[k].x + e[k].y * e[k].y);
      r.y = T(0);
      s[idx] = r;
    }
    if constexpr (WRITE_PSI) reinterpret_cast<V*>(psi_slab)[(y * N + w) / E] = Vec<T>::join(e);
  }
}

// The block's maximum of every thread's mx (NaN-keeping) into *dst, in a
// fixed order: warp shuffles, then the warps in turn (red: one real a
// warp of the block's THREADS). Ends in a __syncthreads.
template <typename T, int THREADS = kClusterThreads>
__device__ __forceinline__ void block_max(T mx, T* red, T* dst) {
  for (int off = 16; off > 0; off >>= 1) {
    mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
  }
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
  __syncthreads();
  if (threadIdx.x == 0) {
    T m = red[0];
    for (int w = 1; w < THREADS / 32; ++w) m = nan_max(m, red[w]);
    *dst = m;
  }
}

// The columns' last DIF pass (slab_fft's second radix_pass over ColLines,
// inverse) with max |scale Re| (NaN-keeping) of each output taken in
// registers in place of its store: every element of the block's column
// slab once. Returns the thread's maximum.
template <typename T, int N>
__device__ __forceinline__ T last_pass_max(const typename Complex<T>::type* s,
                                           const typename Complex<T>::type* tw, T scale) {
  using C = typename Complex<T>::type;
  constexpr int R = N / cluster_size<T, N>();
  using Lines = ColLines<N, R>;
  constexpr int A = plan_a(N);
  constexpr int B = N / A;
  T mx = T(0);
  for (int t = threadIdx.x; t < R * A; t += kClusterThreads) {
    const int line = t % R;
    const int g = t / R;
    C v[B];
#pragma unroll
    for (int j = 0; j < B; ++j) v[j] = s[Lines::at(line, g * B + j)];
    dft_regs<T, B, true>(v, tw, N / B);
#pragma unroll
    for (int k = 0; k < B; ++k) {
      const T re = v[k].x * scale;
      mx = nan_max(mx, re < T(0) ? -re : re);
    }
  }
  return mx;
}

// K11: max |Re| of the ortho 2-axis inverse of plane blockIdx.x / CL, one
// partial a block into maxes[blockIdx.x]; no plane is written. K9's load
// and rows_to_columns (the rows, the swap, the columns' first pass), with
// the columns' last pass taking the maximum in registers (last_pass_max)
// where K9 stores, and block_max leaving the block's partial (the
// reduction scratch of cluster_smem). After the swap no block touches a
// peer's shared memory, so the passes' and block_max's __syncthreads are
// the only barriers the epilogue needs.
template <typename T, int N>
__global__ void __launch_bounds__(kClusterThreads, sizeof(T) == 4 ? 3 : 1)
    plane_real_inv_max_cluster_kernel(const typename Complex<T>::type* in, T* maxes,
                                      const typename Complex<T>::type* twg, T scale) {
  using C = typename Complex<T>::type;
  constexpr int CL = cluster_size<T, N>();
  constexpr int R = N / CL;
  constexpr int A = plan_a(N);
  constexpr int B = N / A;
  extern __shared__ __align__(16) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  C* tw = s + pad16(R * N);
  T* red = reinterpret_cast<T*>(tw + N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / CL;

  load_twiddles<T, N>(tw, twg);
  load_rows_transposed<T, N, R>(s, in + (plane * N + rank * R) * N);
  __syncthreads();
  slab_fft<T, N, true, true, RowLines<N>>(s, tw, R);
  cluster.sync();
  swap_tiles<T, N, CL, kSwapOnePass>(cluster, s, rank);
  cluster.sync();
  radix_pass<T, N, A, true, true, ColLines<N, R>>(s, tw, R, B, 1, B);
  block_max(last_pass_max<T, N>(s, tw, scale), red, maxes + blockIdx.x);
}

// K4: phi = Re of the ortho 2-axis inverse of phik's plane, max|phi| of the
// block's part into maxes[blockIdx.x], psi exp(i c phi) with c the owning
// stream's coefficient, its ortho 2-axis forward into out.
template <typename T, int N>
__global__ void __launch_bounds__(kClusterThreads, sizeof(T) == 4 ? 3 : 1)
    plane_potkick_cluster_kernel(const typename Complex<T>::type* phik,
                                 const typename Complex<T>::type* psi,
                                 typename Complex<T>::type* out, T* maxes, const T* coeff,
                                 int64_t planes_per_batch, const typename Complex<T>::type* twg,
                                 T scale) {
  using C = typename Complex<T>::type;
  constexpr int CL = cluster_size<T, N>();
  constexpr int R = N / CL;
  extern __shared__ __align__(16) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  C* tw = s + pad16(R * N);
  T* red = reinterpret_cast<T*>(tw + N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / CL;

  load_twiddles<T, N>(tw, twg);
  load_rows_transposed<T, N, R>(s, phik + (plane * N + rank * R) * N);
  __syncthreads();
  rows_to_columns<T, N, true, kSwapTwoPass>(cluster, s, tw, rank);
  const T mx = kick_columns<T, N>(s, psi + plane * N * N + rank * R,
                                  coeff[plane / planes_per_batch], scale);
  block_max(mx, red, maxes + blockIdx.x);
  columns_to_rows<T, N, false>(cluster, s, tw, rank);
  store_rows_transposed<T, N, R>(out + (plane * N + rank * R) * N, s, scale);
}

// K2 (WRITE_PSI) and K10: psi = the ortho 2-axis inverse of in's plane,
// written to psi by K2 only; rho = pref |psi|^2 and its ortho 2-axis forward
// into rho. K4's skeleton with the middle changed (no sincos, no maximum:
// the reduction scratch of cluster_smem goes unused).
template <typename T, int N, bool WRITE_PSI>
__global__ void __launch_bounds__(kClusterThreads, sizeof(T) == 4 ? 3 : 1)
    plane_inv_density_cluster_kernel(const typename Complex<T>::type* in,
                                     typename Complex<T>::type* psi,
                                     typename Complex<T>::type* rho,
                                     const typename Complex<T>::type* twg, T pref, T scale) {
  using C = typename Complex<T>::type;
  constexpr int CL = cluster_size<T, N>();
  constexpr int R = N / CL;
  extern __shared__ __align__(16) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  C* tw = s + pad16(R * N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / CL;

  load_twiddles<T, N>(tw, twg);
  load_rows_transposed<T, N, R>(s, in + (plane * N + rank * R) * N);
  __syncthreads();
  rows_to_columns<T, N, true, kSwapTwoPass>(cluster, s, tw, rank);
  density_columns<T, N, WRITE_PSI>(s, WRITE_PSI ? psi + plane * N * N + rank * R : nullptr,
                                   pref, scale);
  __syncthreads();
  columns_to_rows<T, N, false>(cluster, s, tw, rank);
  store_rows_transposed<T, N, R>(rho + (plane * N + rank * R) * N, s, scale);
}

// Once per kernel (and so per size): raise its shared-memory limit and check
// that a cluster of cl blocks can be resident at all.
template <auto KERNEL>
cudaError_t prepare_cluster(int cl, size_t smem) {
  static const cudaError_t err = [cl, smem] {
    cudaError_t e = cudaFuncSetAttribute(KERNEL, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
    if (e != cudaSuccess) return e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeClusterDimension;
    attr.val.clusterDim.x = cl;
    attr.val.clusterDim.y = 1;
    attr.val.clusterDim.z = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cl);
    cfg.blockDim = dim3(kClusterThreads);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    int clusters = 0;
    e = cudaOccupancyMaxActiveClusters(&clusters, KERNEL, &cfg);
    if (e != cudaSuccess) return e;
    return clusters > 0 ? cudaSuccess : cudaErrorLaunchOutOfResources;
  }();
  return err;
}

// m planes, one cluster of cl blocks each.
template <auto KERNEL, typename... Args>
cudaError_t launch_cluster(int64_t m, int cl, size_t smem, cudaStream_t stream, Args... args) {
  cudaError_t err = prepare_cluster<KERNEL>(cl, smem);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = cl;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(m * cl));
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, KERNEL, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// f(std::integral_constant<int, N>{}) for n = 2^log_n in {128, 256} and cl
// its cluster size (cluster_size), else cudaErrorInvalidValue.
template <typename T, typename F>
cudaError_t by_plane_size(int log_n, int cl, F f) {
  if (log_n == 8 && cl == cluster_size<T, 256>()) return f(std::integral_constant<int, 256>{});
  if (log_n == 7 && cl == cluster_size<T, 128>()) return f(std::integral_constant<int, 128>{});
  return cudaErrorInvalidValue;
}

// K6 (Vec in and out), K17 (RealVec in) and K9 (RealVec out) in the cluster
// form, float or double (is_double).
template <bool INV, template <typename> class VIN, template <typename> class VOUT>
cudaError_t plane_cluster(const void* in, void* out, int64_t m, int log_n, int cl,
                          bool is_double, const void* tw, cudaStream_t stream) {
  auto launch = [=](auto real) {
    using T = decltype(real);
    using C = typename Complex<T>::type;
    return by_plane_size<T>(log_n, cl, [=](auto n) {
      constexpr int N = decltype(n)::value;
      return launch_cluster<plane_cluster_kernel<T, N, INV, VIN<T>, VOUT<T>>>(
          m, cl, cluster_smem<T, N>(), stream, static_cast<const typename VIN<T>::elem*>(in),
          static_cast<typename VOUT<T>::elem*>(out), static_cast<const C*>(tw),
          static_cast<T>(1.0 / N), VIN<T>{});
    });
  };
  return is_double ? launch(double{}) : launch(float{});
}

// K7 in the cluster form: K6's forward kernel with the density load.
template <typename T>
cudaError_t density_cluster(const void* psi, void* out, int64_t m, int log_n, int cl,
                            double pref, const void* tw, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  return by_plane_size<T>(log_n, cl, [=](auto n) {
    constexpr int N = decltype(n)::value;
    return launch_cluster<plane_cluster_kernel<T, N, false, DensityVec<T>, Vec<T>>>(
        m, cl, cluster_smem<T, N>(), stream, static_cast<const C*>(psi), static_cast<C*>(out),
        static_cast<const C*>(tw), static_cast<T>(1.0 / N), DensityVec<T>{static_cast<T>(pref)});
  });
}

// K4 in the cluster form; maxes: (m * cl,), one per block.
template <typename T>
cudaError_t potkick_cluster(const void* phik, const void* psi, void* out, void* maxes,
                            const void* coeff, int64_t m, int64_t planes_per_batch, int log_n,
                            int cl, const void* tw, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  return by_plane_size<T>(log_n, cl, [=](auto n) {
    constexpr int N = decltype(n)::value;
    return launch_cluster<plane_potkick_cluster_kernel<T, N>>(
        m, cl, cluster_smem<T, N>(), stream, static_cast<const C*>(phik),
        static_cast<const C*>(psi), static_cast<C*>(out), static_cast<T*>(maxes),
        static_cast<const T*>(coeff), planes_per_batch, static_cast<const C*>(tw),
        static_cast<T>(1.0 / N));
  });
}

// K11 in the cluster form; maxes: (m * cl,), one per block.
template <typename T>
cudaError_t real_inv_max_cluster(const void* in, void* maxes, int64_t m, int log_n, int cl,
                                 const void* tw, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  return by_plane_size<T>(log_n, cl, [=](auto n) {
    constexpr int N = decltype(n)::value;
    return launch_cluster<plane_real_inv_max_cluster_kernel<T, N>>(
        m, cl, cluster_smem<T, N>(), stream, static_cast<const C*>(in), static_cast<T*>(maxes),
        static_cast<const C*>(tw), static_cast<T>(1.0 / N));
  });
}

// K2 (psi given) and K10 (psi null) in the cluster form.
template <typename T>
cudaError_t inv_density_cluster(const void* in, void* psi, void* rho, int64_t m, int log_n,
                                int cl, double pref, const void* tw, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  return by_plane_size<T>(log_n, cl, [=](auto n) {
    constexpr int N = decltype(n)::value;
    const C* src = static_cast<const C*>(in);
    C* p = static_cast<C*>(psi);
    C* dst = static_cast<C*>(rho);
    const C* t = static_cast<const C*>(tw);
    const T pr = static_cast<T>(pref);
    const T scale = static_cast<T>(1.0 / N);
    return p ? launch_cluster<plane_inv_density_cluster_kernel<T, N, true>>(
                   m, cl, cluster_smem<T, N>(), stream, src, p, dst, t, pr, scale)
             : launch_cluster<plane_inv_density_cluster_kernel<T, N, false>>(
                   m, cl, cluster_smem<T, N>(), stream, src, p, dst, t, pr, scale);
  });
}

}  // namespace
