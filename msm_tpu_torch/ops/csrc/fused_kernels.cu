// Hopper (sm_90a) kernels of the fused, skewed MXU engine: the FFT passes of
// the step with the step's elementwise work fused into them, bound to Python
// through a plain C interface (msm_tpu_torch/ops/build.py).
//
//   msm_axis_roundtrip_kick    : forward DFT along axis 1, sum |y|^2 and the
//                                alias-band sum (k^2 > cutoff) per block
//                                (skipped when partials is null: the exact-dt
//                                prefix's with_reduce=False), y * exp(i c_b
//                                k^2), inverse DFT; replaces
//                                msm_tpu/ops/mxu_fft.py
//                                _axis_pass_sublane_roundtrip_kick_reduce_sep /
//                                _sublane_kernel_roundtrip_kick_reduce_sep (K1).
//   msm_plane_inv_density      : 2-axis inverse DFT -> psi (written); rho =
//                                pref |psi|^2; 2-axis forward DFT of rho;
//                                replaces _axis_pass_fused2_inv_density /
//                                _fused_kernel_inv_density (K2).
//   msm_axis_roundtrip_poisson : forward DFT along axis 1, y * (-coeff / k^2)
//                                (k^2 = 0 -> 0), inverse DFT; replaces
//                                _axis_pass_sublane_roundtrip_poisson_sep (K3).
//   msm_plane_potkick_fwd      : phi = Re 2-axis inverse DFT of phi_k, max|phi|
//                                per block, psi * exp(i c_b phi), 2-axis
//                                forward DFT; replaces
//                                _axis_pass_fused2_potkick_fwd /
//                                _fused_kernel_potkick_fwd (K4).
//   msm_plane_density_fwd      : rho = pref |psi|^2, 2-axis forward DFT;
//                                replaces _axis_pass_fused2_density (K7).
//   msm_axis_roundtrip_map     : forward DFT along axis 1, y * map[k, lane],
//                                inverse DFT; replaces
//                                _axis_pass_sublane_roundtrip_pmap (K8).
//   msm_plane_inv_density_rho_only : K2 without the psi write: only the
//                                2-axis forward of pref |psi|^2 leaves;
//                                replaces
//                                _axis_pass_fused2_inv_density_rho_only /
//                                _fused_kernel_inv_density_rho_only (K10).
//   msm_plane_real_inv_max     : max |Re 2-axis inverse DFT| per block, no
//                                plane written; replaces
//                                _axis_pass_fused2_real_inv_max /
//                                _fused_kernel_real_inv_max (K11).
//   msm_axis_inv_kick          : x exp(i c_b k^2) from the separable factor
//                                tables, then the inverse DFT along axis 1;
//                                replaces _axis_pass_sublane_inv_kphase_sep /
//                                _sublane_kernel_inv_kphase_sep (K12).
//   msm_axis_fwd_reduce        : forward DFT along axis 1, sum |y|^2 and the
//                                alias-band sum per block; replaces
//                                _axis_pass_sublane_fwd_reduce_sep /
//                                _sublane_kernel_fwd_reduce_sep (K13).
//
// k^2 along axis 1 is s0[k] and over the other two axes the pre-summed
// s12[lane], summed s0 + s12 as the TPU kernels sum them (membership in the
// alias band at the cutoff depends on the order). Data are interleaved
// complex, k in natural fftn order; "mixed space" is z spatial and (y, x) in
// k, the skewed loop's carrier.
//
// What bounds them: device memory. At (9, 256^3) complex64 one grid is
// 1.21 GB, 0.36 ms at 3.35 TB/s. A round trip (K1, K3, K8) reads and writes
// the grid once: 0.72 ms (K8 also reads a real N^3 map). The plane kernels
// must read and write 3 grids (K2: x in, psi and rhoT out; K4: phi_k and psi
// in, the next field out), 1.08 ms, and K7 2 grids, 0.72 ms. K12 and K13
// read and write the grid once, 0.72 ms; K10 reads one grid and writes one,
// 0.72 ms; K11 reads one and writes only its maxima, 0.36 ms.
//
// Design:
//   round trip (K1, K3, K8) and K13: the radix form, axis_radix.cuh
//     (axis_roundtrip_radix_kernel): one column tile a block, 16 elements
//     a thread in registers, radix-16 passes with one barrier between
//     them, the epilogue in registers at each element's frequency, one HBM
//     read and write. K1's and K13's sums are accumulated in double per
//     thread and reduced per block in a fixed order (warp shuffles, then
//     the warps in turn); the wrapper adds the per-block partials with
//     torch. No atomics, so runs are reproducible, and K13 (the same body
//     stopped after the epilogue, y stored at its natural row k) takes its
//     sums in the same code, so the unskewed step's sums are bit-identical
//     to the ones the skewed loop's K1 takes of the same field. The radix-2
//     form before it (axis_roundtrip_kernel below: the column tile of the
//     axis pass in shared memory, a decimation-in-frequency forward, the
//     epilogue at k = bitrev(row), a decimation-in-time inverse) stays as
//     the wrappers' forced form="stages", for tests and chip_smoke.py's
//     before/after; no path takes it. K12 is the radix form's column pass
//     (axis_radix.cuh axis_pass_kernel<T, N, true, kKick>: the kick
//     multiplied in on pass 1's load, one inverse, a natural-order store);
//     its stages form, the radix-2 column pass (axis_fft_kernel) with the
//     same kick on load, is its forced form="stages".
//   K4, K2, K10, K11 and K7 at n = 128 and 256: the one-pass cluster form
//     (plane_cluster.cuh): the input's plane in the shared memory of a
//     cluster of 2-8 blocks, its 2-axis inverse, the middle step (K4:
//     max|phi| per block and the kick on psi read once from device memory;
//     K2: psi written once, rho = pref |psi|^2; K10: rho alone), the 2-axis
//     forward, one write: 3 grids of traffic for K4 and K2, 2 for K10, phi
//     and rho never in device memory; K11 stops after the inverse with a
//     max |Re| a block (1 grid); K7 is K6's forward with pref |psi|^2 formed
//     on load (DensityVec, 2 grids). The wrapper picks the form by shape
//     (mxu_fft._plane_form); K4 and K11 leave one maximum per block.
//   the split form (the five at n = 512, 1024, where a plane exceeds a
//     portable cluster's 8 x 227 KB of shared memory): split_radix.cuh, a
//     radix-16 row kernel with the step's elementwise work between its
//     inverse and its forward, between radix column passes (K5's
//     axis_pass_kernel), the intermediate in device memory (7 grids of
//     traffic for K2 and K4, 6 for K10, 4 for K7, 3 for K11). K4 and K11
//     leave one maximum per row block (2048 elements, never straddling a
//     plane), which the wrapper reduces per plane with torch. The radix-2
//     split form before it stays as the wrappers' forced form="stages",
//     for tests and chip_smoke.py's before/after; no path takes it: a column
//     pass (axis_fft_kernel), row_fused_kernel (below: whole contiguous
//     rows, radix-2 Stockham between two shared buffers, sincospi twiddles
//     a block) and a column pass in place; K11 through a scratch grid.
//
// Accuracy: FP32 (or FP64) CUDA-core arithmetic, twiddles computed in double
// and rounded once (sincospi per block in the stages kernels, the wrapper's
// table in the cluster, radix and split forms), accurate sincos, no fast
// math. Offsets are 64-bit. Every entry point launches on the stream it is
// given and returns cudaGetLastError().

#include "split_radix.cuh"

namespace {

// ---------------------------------------------------------------------------
// Axis round trip (K1, K3, K8) and K13, radix-2 stages
// ---------------------------------------------------------------------------

// The stages form (form="stages"); RoundTrip and RoundTripArgs are
// axis_radix.cuh's.
template <typename T, int MODE>
__global__ void __launch_bounds__(1024)
    axis_roundtrip_kernel(const typename Complex<T>::type* in, typename Complex<T>::type* out,
                          int log_n, int64_t lanes, int64_t tiles_per_batch, T scale,
                          RoundTripArgs<T> a) {
  // in may equal out: the whole tile is read before any of it is written.
  using C = typename Complex<T>::type;
  constexpr int log_w = log_tile_width<T>();
  constexpr int w = 1 << log_w;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << log_n;
  C* tile = reinterpret_cast<C*>(smem);  // tile[row * w + col]
  C* tw = tile + (n << log_w);
  double* red = reinterpret_cast<double*>(tw + n / 2);  // 2 per warp
  const int64_t b = blockIdx.x / tiles_per_batch;
  const int64_t col0 = (blockIdx.x - b * tiles_per_batch) << log_w;
  const int64_t base = b * n * lanes + col0;
  const int total = n << log_w;

  fill_twiddles<T>(tw, n, false);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    tile[i] = in[base + (i >> log_w) * lanes + (i & (w - 1))];
  }
  __syncthreads();
  // forward, decimation in frequency: x[i0], x[i0 + h] -> a + b and
  // (a - b) exp(-2 pi i k / 2h) = (a - b) tw[k * n / 2h]
  for (int h = n >> 1, step = 1; h >= 1; h >>= 1, step <<= 1) {
    for (int i = threadIdx.x; i < total / 2; i += blockDim.x) {
      const int c = i & (w - 1);
      const int j = i >> log_w;
      const int k = j & (h - 1);
      const int i0 = ((j - k) << 1) + k;
      C* p0 = tile + (i0 << log_w) + c;
      C* p1 = p0 + (h << log_w);
      const C u = *p0;
      const C v = *p1;
      *p0 = cadd(u, v);
      *p1 = cmul(csub(u, v), tw[k * step]);
    }
    __syncthreads();
  }
  // epilogue: row r holds k = bitrev(r). The sums are taken where they are
  // asked for; a null K1 partials is the same for the whole launch, so the
  // block's __syncthreads below is reached by all threads or by none.
  constexpr bool kSums = MODE == kKickReduce || MODE == kFwdReduce;
  const bool reduce = kSums && a.partials != nullptr;
  double ns = 0.0;
  double am = 0.0;
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int r = i >> log_w;
    const int k = static_cast<int>(__brev(static_cast<unsigned>(r)) >> (32 - log_n));
    const int64_t lane = col0 + (i & (w - 1));
    C y = cscale(tile[i], scale);
    if constexpr (kSums) {
      if (reduce) {
        const T p2 = y.x * y.x + y.y * y.y;
        ns += p2;
        if (a.s0[k] + a.s12[lane] > a.param) am += p2;
      }
    }
    if constexpr (MODE == kKickReduce) {
      y = cmul(y, cmul(a.f0[b * n + k], a.f12[b * lanes + lane]));
    } else if constexpr (MODE == kPoisson) {
      const T k2 = a.s0[k] + a.s12[lane];
      y = cscale(y, k2 > T(0) ? a.param / k2 : T(0));
    } else if constexpr (MODE == kMap) {
      y = cscale(y, a.map[k * lanes + lane]);
    }
    if constexpr (MODE == kFwdReduce) {
      out[base + k * lanes + (i & (w - 1))] = y;
    } else {
      tile[i] = y;
    }
  }
  if constexpr (MODE != kFwdReduce) {
    __syncthreads();
    // inverse, decimation in time (as axis_fft_kernel, conjugate twiddles)
    for (int h = 1, step = n >> 1; h < n; h <<= 1, step >>= 1) {
      for (int i = threadIdx.x; i < total / 2; i += blockDim.x) {
        const int c = i & (w - 1);
        const int j = i >> log_w;
        const int k = j & (h - 1);
        const int i0 = ((j - k) << 1) + k;
        C* p0 = tile + (i0 << log_w) + c;
        C* p1 = p0 + (h << log_w);
        const C u = *p0;
        const C v = cmul(*p1, cconj(tw[k * step]));
        *p0 = cadd(u, v);
        *p1 = csub(u, v);
      }
      __syncthreads();
    }
    for (int i = threadIdx.x; i < total; i += blockDim.x) {
      out[base + (i >> log_w) * lanes + (i & (w - 1))] = cscale(tile[i], scale);
    }
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
      double s = 0.0;
      double t = 0.0;
      for (int q = 0; q < static_cast<int>(blockDim.x >> 5); ++q) {
        s += red[2 * q];
        t += red[2 * q + 1];
      }
      a.partials[2 * static_cast<int64_t>(blockIdx.x)] = s;
      a.partials[2 * static_cast<int64_t>(blockIdx.x) + 1] = t;
    }
  }
}

// (b1, n, lanes): round trip along the middle axis. lanes % W == 0.
template <typename T, int MODE>
cudaError_t launch_roundtrip(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                             const RoundTripArgs<T>& args, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  constexpr int log_w = log_tile_width<T>();
  const int n = 1 << log_n;
  const size_t smem =
      ((static_cast<size_t>(n) << log_w) + n / 2) * sizeof(C) + 64 * sizeof(double);
  static const cudaError_t err = cudaFuncSetAttribute(
      axis_roundtrip_kernel<T, MODE>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((((1 << kMaxLogN) << log_w) + (1 << kMaxLogN) / 2) * sizeof(C) +
                       64 * sizeof(double)));
  if (err != cudaSuccess) return err;
  const int64_t tiles = lanes >> log_w;
  axis_roundtrip_kernel<T, MODE>
      <<<static_cast<unsigned>(b1 * tiles), tile_threads<T>(log_n), smem, stream>>>(
          static_cast<const C*>(in), static_cast<C*>(out), log_n, lanes, tiles,
          ortho_scale<T>(log_n), args);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The stages form's fused row kernel (the row halves of K2, K4, K7, K10, K11;
// RowBody and RowArgs are split_radix.cuh's)
// ---------------------------------------------------------------------------

// Radix-2 Stockham (decimation in frequency, self-sorting) over every row of
// the block, x -> y -> x ...: at stride s = 2^log_s, y[q + s*2p] = a + b and
// y[q + s*(2p+1)] = (a - b) w^p with a = x[q + s*p], b = x[q + s*(p + n/2)],
// w = exp(-+2 pi i s / n). Returns the buffer holding the result.
template <typename T, bool INV>
__device__ typename Complex<T>::type* stockham_rows(typename Complex<T>::type* x,
                                                    typename Complex<T>::type* y,
                                                    const typename Complex<T>::type* tw,
                                                    int log_n, int count) {
  using C = typename Complex<T>::type;
  const int half = 1 << (log_n - 1);
  for (int log_s = 0; log_s < log_n; ++log_s) {
    const int s = 1 << log_s;
    for (int i = threadIdx.x; i < count / 2; i += blockDim.x) {
      const int row = i >> (log_n - 1);
      const int bf = i & (half - 1);
      const int q = bf & (s - 1);
      const int p = bf >> log_s;
      const C* xr = x + (row << log_n);
      C* yr = y + (row << log_n);
      const C u = xr[bf];
      const C v = xr[bf + half];
      const C t = tw[p << log_s];
      yr[q + ((2 * p) << log_s)] = cadd(u, v);
      yr[q + ((2 * p + 1) << log_s)] = cmul(csub(u, v), INV ? cconj(t) : t);
    }
    __syncthreads();
    C* swap = x;
    x = y;
    y = swap;
  }
  return x;
}

template <typename T, int BODY>
__global__ void __launch_bounds__(kRowThreads)
    row_fused_kernel(int log_n, int64_t rows, T scale, RowArgs<T> a) {
  // a.in may equal a.out: a block reads all of its rows before it writes any.
  using C = typename Complex<T>::type;
  constexpr bool kMax = BODY == kPotKick || BODY == kRealMax;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << log_n;
  C* x = reinterpret_cast<C*>(smem);
  C* y = x + kRowTile;
  C* tw = y + kRowTile;
  T* red = reinterpret_cast<T*>(tw + n / 2);  // one per warp
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowTile;
  const int64_t left = (rows << log_n) - first;
  const int count = left < kRowTile ? static_cast<int>(left) : kRowTile;

  fill_twiddles<T>(tw, n, false);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    if constexpr (BODY == kDensity) {
      const C p = a.psi_in[first + i];
      x[i].x = a.pref * (p.x * p.x + p.y * p.y);
      x[i].y = T(0);
    } else {
      x[i] = a.in[first + i];
    }
  }
  __syncthreads();
  C* r = x;
  C* o = y;
  if constexpr (BODY != kDensity) {
    r = stockham_rows<T, true>(x, y, tw, log_n, count);
    o = r == x ? y : x;
    T mx = T(0);
    T c = T(0);
    if constexpr (BODY == kPotKick) c = a.coeff[(first >> (2 * log_n)) / a.planes_per_batch];
    for (int i = threadIdx.x; i < count; i += blockDim.x) {
      const C v = cscale(r[i], scale);
      if constexpr (BODY == kInvDensity || BODY == kRhoOnly) {
        if constexpr (BODY == kInvDensity) a.psi_out[first + i] = v;
        r[i].x = a.pref * (v.x * v.x + v.y * v.y);
        r[i].y = T(0);
      } else {
        const T phi = v.x;
        mx = nan_max(mx, phi < T(0) ? -phi : phi);
        if constexpr (BODY == kPotKick) {
          T sn, cs;
          sincos_acc(c * phi, &sn, &cs);
          const C p = a.psi_in[first + i];
          r[i].x = p.x * cs - p.y * sn;
          r[i].y = p.y * cs + p.x * sn;
        }
      }
    }
    if constexpr (kMax) {
      for (int off = 16; off > 0; off >>= 1) {
        mx = nan_max(mx, __shfl_down_sync(0xffffffffu, mx, off));
      }
      if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = mx;
    }
    __syncthreads();
    if constexpr (kMax) {
      if (threadIdx.x == 0) {
        T m = red[0];
        for (int q = 1; q < kRowThreads / 32; ++q) m = nan_max(m, red[q]);
        a.maxes[blockIdx.x] = m;
      }
    }
    if constexpr (BODY == kRealMax) return;  // K11 writes no plane
  }
  r = stockham_rows<T, false>(r, o, tw, log_n, count);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    a.out[first + i] = cscale(r[i], scale);
  }
}

// (m, n, n) planes, row by row. The stages form of K7, K2, K4, K10 and K11
// below: the radix-2 column pass (axis_fft_kernel) around row_fused_kernel.
template <typename T, int BODY>
cudaError_t launch_row_fused(int64_t m, int log_n, const RowArgs<T>& args,
                             cudaStream_t stream) {
  using C = typename Complex<T>::type;
  const int n = 1 << log_n;
  const size_t smem =
      (2 * static_cast<size_t>(kRowTile) + n / 2) * sizeof(C) + (kRowThreads / 32) * sizeof(T);
  static const cudaError_t err = cudaFuncSetAttribute(
      row_fused_kernel<T, BODY>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((2 * kRowTile + (1 << kMaxLogN) / 2) * sizeof(C) +
                       (kRowThreads / 32) * sizeof(T)));
  if (err != cudaSuccess) return err;
  const int64_t rows = m << log_n;
  const int64_t blocks = ((rows << log_n) + kRowTile - 1) / kRowTile;
  row_fused_kernel<T, BODY><<<static_cast<unsigned>(blocks), kRowThreads, smem, stream>>>(
      log_n, rows, ortho_scale<T>(log_n), args);
  return cudaGetLastError();
}

// K7 (stages): rows of rho = pref |psi|^2 forward into out, then the columns in place.
template <typename T>
cudaError_t plane_density_fwd(const void* psi, void* out, int64_t m, int log_n, double pref,
                              cudaStream_t stream) {
  using C = typename Complex<T>::type;
  RowArgs<T> a{};
  a.psi_in = static_cast<const C*>(psi);
  a.out = static_cast<C*>(out);
  a.pref = static_cast<T>(pref);
  cudaError_t err = launch_row_fused<T, kDensity>(m, log_n, a, stream);
  if (err != cudaSuccess) return err;
  return axis<T>(out, out, m, log_n, int64_t(1) << log_n, false, stream);
}

// K2 (stages): columns inverse into rho (as scratch), the fused rows (psi written,
// rho's row forward in place), then rho's columns forward in place.
template <typename T>
cudaError_t plane_inv_density(const void* in, void* psi, void* rho, int64_t m, int log_n,
                              double pref, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  const int64_t n = int64_t(1) << log_n;
  cudaError_t err = axis<T>(in, rho, m, log_n, n, true, stream);
  if (err != cudaSuccess) return err;
  RowArgs<T> a{};
  a.in = static_cast<const C*>(rho);
  a.psi_out = static_cast<C*>(psi);
  a.out = static_cast<C*>(rho);
  a.pref = static_cast<T>(pref);
  err = launch_row_fused<T, kInvDensity>(m, log_n, a, stream);
  if (err != cudaSuccess) return err;
  return axis<T>(rho, rho, m, log_n, n, false, stream);
}

// K4 (stages): phi_k's columns inverse into out (as scratch), the fused rows (phi,
// max|phi|, the kick on psi, the row forward in place), then the columns
// forward in place.
template <typename T>
cudaError_t plane_potkick_fwd(const void* phik, const void* psi, void* out, void* maxes,
                              const void* coeff, int64_t m, int64_t planes_per_batch,
                              int log_n, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  const int64_t n = int64_t(1) << log_n;
  cudaError_t err = axis<T>(phik, out, m, log_n, n, true, stream);
  if (err != cudaSuccess) return err;
  RowArgs<T> a{};
  a.in = static_cast<const C*>(out);
  a.psi_in = static_cast<const C*>(psi);
  a.out = static_cast<C*>(out);
  a.maxes = static_cast<T*>(maxes);
  a.coeff = static_cast<const T*>(coeff);
  a.planes_per_batch = planes_per_batch;
  err = launch_row_fused<T, kPotKick>(m, log_n, a, stream);
  if (err != cudaSuccess) return err;
  return axis<T>(out, out, m, log_n, n, false, stream);
}

// K10 (stages): K2's launches with the kRhoOnly row body: columns inverse into rho
// (as scratch), the rows (rho's row forward in place, no psi), rho's
// columns forward in place.
template <typename T>
cudaError_t plane_inv_density_rho_only(const void* in, void* rho, int64_t m, int log_n,
                                       double pref, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  const int64_t n = int64_t(1) << log_n;
  cudaError_t err = axis<T>(in, rho, m, log_n, n, true, stream);
  if (err != cudaSuccess) return err;
  RowArgs<T> a{};
  a.in = static_cast<const C*>(rho);
  a.out = static_cast<C*>(rho);
  a.pref = static_cast<T>(pref);
  err = launch_row_fused<T, kRhoOnly>(m, log_n, a, stream);
  if (err != cudaSuccess) return err;
  return axis<T>(rho, rho, m, log_n, n, false, stream);
}

// K11 (stages): K9's column inverse into tmp, then the rows' inverse reduced to one
// max |Re| per row block.
template <typename T>
cudaError_t plane_real_inv_max(const void* in, void* tmp, void* maxes, int64_t m, int log_n,
                               cudaStream_t stream) {
  using C = typename Complex<T>::type;
  cudaError_t err = axis<T>(in, tmp, m, log_n, int64_t(1) << log_n, true, stream);
  if (err != cudaSuccess) return err;
  RowArgs<T> a{};
  a.in = static_cast<const C*>(tmp);
  a.maxes = static_cast<T*>(maxes);
  return launch_row_fused<T, kRealMax>(m, log_n, a, stream);
}

// The split form (split_radix.cuh) of K7, K2 / K10 (BODY), K4 and K11.
template <typename T>
cudaError_t density_split(const void* psi, void* out, int64_t m, int log_n, double pref,
                          const void* tw, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  RowArgs<T> a{};
  a.psi_in = static_cast<const C*>(psi);
  a.out = static_cast<C*>(out);
  a.pref = static_cast<T>(pref);
  return split_plane<T, kDensity>(nullptr, a, nullptr, m, log_n, tw, stream);
}

template <typename T, int BODY>
cudaError_t inv_density_split(const void* in, void* psi, void* rho, int64_t m, int log_n,
                              double pref, const void* tw, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  RowArgs<T> a{};
  a.psi_out = static_cast<C*>(psi);
  a.out = static_cast<C*>(rho);
  a.pref = static_cast<T>(pref);
  return split_plane<T, BODY>(in, a, nullptr, m, log_n, tw, stream);
}

template <typename T>
cudaError_t potkick_split(const void* phik, const void* psi, void* out, void* maxes,
                          const void* coeff, int64_t m, int64_t planes_per_batch, int log_n,
                          const void* tw, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  RowArgs<T> a{};
  a.psi_in = static_cast<const C*>(psi);
  a.out = static_cast<C*>(out);
  a.maxes = static_cast<T*>(maxes);
  a.coeff = static_cast<const T*>(coeff);
  a.planes_per_batch = planes_per_batch;
  return split_plane<T, kPotKick>(phik, a, nullptr, m, log_n, tw, stream);
}

template <typename T>
cudaError_t real_inv_max_split(const void* in, void* tmp, void* maxes, int64_t m, int log_n,
                               const void* tw, cudaStream_t stream) {
  RowArgs<T> a{};
  a.maxes = static_cast<T*>(maxes);
  return split_plane<T, kRealMax>(in, a, tmp, m, log_n, tw, stream);
}

// K12: the inverse column pass with the kick multiplied in on load, in the
// radix form (axis_radix.cuh, tw: (n,) w_n^m) or the stages form.
template <typename T>
cudaError_t axis_inv_kick(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                          const void* f0, const void* f12, int stages, const void* tw,
                          cudaStream_t stream) {
  using C = typename Complex<T>::type;
  const AxisLoad<T> pro{static_cast<const C*>(f0), static_cast<const C*>(f12), nullptr};
  return stages ? launch_axis<T, true, AxisPrologue::kKick>(in, out, b1, log_n, lanes, stream, pro)
                : launch_axis_pass_radix<T, true, AxisPrologue::kKick>(in, out, b1, log_n, lanes,
                                                                       pro, tw, stream);
}

template <typename T>
RoundTripArgs<T> roundtrip_args(const void* s0, const void* s12, const void* f0,
                                const void* f12, const void* map, double param,
                                void* partials) {
  using C = typename Complex<T>::type;
  RoundTripArgs<T> a{};
  a.s0 = static_cast<const T*>(s0);
  a.s12 = static_cast<const T*>(s12);
  a.f0 = static_cast<const C*>(f0);
  a.f12 = static_cast<const C*>(f12);
  a.map = static_cast<const T*>(map);
  a.param = static_cast<T>(param);
  a.partials = static_cast<double*>(partials);
  return a;
}

// K1, K3, K8, K13 in the radix form (tw: (n,) w_n^m), or the stages form.
template <typename T, int MODE>
cudaError_t roundtrip(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                      const RoundTripArgs<T>& a, int stages, const void* tw,
                      cudaStream_t stream) {
  return stages ? launch_roundtrip<T, MODE>(in, out, b1, log_n, lanes, a, stream)
                : launch_roundtrip_radix<T, MODE>(in, out, b1, log_n, lanes, a, tw, stream);
}

}  // namespace

extern "C" {

// K1. in, out: (b1, 2^log_n, lanes) interleaved complex (in == out allowed);
// s0: (n,) and s12: (lanes,) real; f0: (b1, n) and f12: (b1, lanes) complex
// phase factors; partials: (b1 * lanes / W, 2) double (W: the form's tile
// width), or null for no sums. stages 0: the radix form (axis_radix.cuh)
// with tw: (n,) interleaved complex w_n^m; 1: the stages form (tw unused).
int msm_axis_roundtrip_kick(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                            const void* s0, const void* s12, const void* f0, const void* f12,
                            double cutoff, void* partials, int is_double, int stages,
                            const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return static_cast<int>(roundtrip<double, kKickReduce>(
        in, out, b1, log_n, lanes,
        roundtrip_args<double>(s0, s12, f0, f12, nullptr, cutoff, partials), stages, tw, s));
  }
  return static_cast<int>(roundtrip<float, kKickReduce>(
      in, out, b1, log_n, lanes,
      roundtrip_args<float>(s0, s12, f0, f12, nullptr, cutoff, partials), stages, tw, s));
}

// K3. as K1, multiplying by -coeff / (s0 + s12), 0 where that is 0.
int msm_axis_roundtrip_poisson(const void* in, void* out, int64_t b1, int log_n,
                               int64_t lanes, const void* s0, const void* s12, double coeff,
                               int is_double, int stages, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return static_cast<int>(roundtrip<double, kPoisson>(
        in, out, b1, log_n, lanes,
        roundtrip_args<double>(s0, s12, nullptr, nullptr, nullptr, -coeff, nullptr), stages,
        tw, s));
  }
  return static_cast<int>(roundtrip<float, kPoisson>(
      in, out, b1, log_n, lanes,
      roundtrip_args<float>(s0, s12, nullptr, nullptr, nullptr, -coeff, nullptr), stages, tw,
      s));
}

// K8. as K1, multiplying by map: (n, lanes) real.
int msm_axis_roundtrip_map(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                           const void* map, int is_double, int stages, const void* tw,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return static_cast<int>(roundtrip<double, kMap>(
        in, out, b1, log_n, lanes,
        roundtrip_args<double>(nullptr, nullptr, nullptr, nullptr, map, 0.0, nullptr), stages,
        tw, s));
  }
  return static_cast<int>(roundtrip<float, kMap>(
      in, out, b1, log_n, lanes,
      roundtrip_args<float>(nullptr, nullptr, nullptr, nullptr, map, 0.0, nullptr), stages, tw,
      s));
}

// K2. in, psi, rho: (m, n, n) interleaved complex, three distinct buffers;
// tw: (n,) interleaved complex w_n^m. cluster > 0: the cluster form
// (plane_cluster.cuh) with that many blocks per plane; else stages 0: the
// split form (split_radix.cuh), 1: the stages form (tw unused).
int msm_plane_inv_density(const void* in, void* psi, void* rho, int64_t m, int log_n,
                          double pref, int is_double, int cluster, int stages, const void* tw,
                          void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster) {
    return static_cast<int>(
        is_double ? inv_density_cluster<double>(in, psi, rho, m, log_n, cluster, pref, tw, s)
                  : inv_density_cluster<float>(in, psi, rho, m, log_n, cluster, pref, tw, s));
  }
  if (stages) {
    return static_cast<int>(is_double
                                ? plane_inv_density<double>(in, psi, rho, m, log_n, pref, s)
                                : plane_inv_density<float>(in, psi, rho, m, log_n, pref, s));
  }
  return static_cast<int>(is_double ? inv_density_split<double, kInvDensity>(
                                          in, psi, rho, m, log_n, pref, tw, s)
                                    : inv_density_split<float, kInvDensity>(
                                          in, psi, rho, m, log_n, pref, tw, s));
}

// K4. phik, psi, out: (m, n, n) interleaved complex, three distinct buffers;
// coeff: (m / planes_per_batch,) real; tw: (n,) interleaved complex w_n^m.
// cluster > 0: the cluster form (plane_cluster.cuh) with that many blocks
// per plane, maxes (m * cluster,), one per block; else maxes (m * n * n /
// 2048,) real, one per row block, and stages 0: the split form
// (split_radix.cuh), 1: the stages form (tw unused).
int msm_plane_potkick_fwd(const void* phik, const void* psi, void* out, void* maxes,
                          const void* coeff, int64_t m, int64_t planes_per_batch, int log_n,
                          int is_double, int cluster, int stages, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster) {
    return static_cast<int>(
        is_double ? potkick_cluster<double>(phik, psi, out, maxes, coeff, m, planes_per_batch,
                                            log_n, cluster, tw, s)
                  : potkick_cluster<float>(phik, psi, out, maxes, coeff, m, planes_per_batch,
                                           log_n, cluster, tw, s));
  }
  if (stages) {
    return static_cast<int>(
        is_double ? plane_potkick_fwd<double>(phik, psi, out, maxes, coeff, m,
                                              planes_per_batch, log_n, s)
                  : plane_potkick_fwd<float>(phik, psi, out, maxes, coeff, m, planes_per_batch,
                                             log_n, s));
  }
  return static_cast<int>(
      is_double ? potkick_split<double>(phik, psi, out, maxes, coeff, m, planes_per_batch, log_n,
                                        tw, s)
                : potkick_split<float>(phik, psi, out, maxes, coeff, m, planes_per_batch, log_n,
                                       tw, s));
}

// K7. psi, out: (m, n, n) interleaved complex, distinct; tw: (n,)
// interleaved complex w_n^m; psi 16-byte aligned. cluster > 0: the cluster
// form (plane_cluster.cuh) with that many blocks per plane; else stages 0:
// the split form (split_radix.cuh), 1: the stages form (tw unused).
int msm_plane_density_fwd(const void* psi, void* out, int64_t m, int log_n, double pref,
                          int is_double, int cluster, int stages, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster) {
    return static_cast<int>(
        is_double ? density_cluster<double>(psi, out, m, log_n, cluster, pref, tw, s)
                  : density_cluster<float>(psi, out, m, log_n, cluster, pref, tw, s));
  }
  if (stages) {
    return static_cast<int>(is_double ? plane_density_fwd<double>(psi, out, m, log_n, pref, s)
                                      : plane_density_fwd<float>(psi, out, m, log_n, pref, s));
  }
  return static_cast<int>(is_double ? density_split<double>(psi, out, m, log_n, pref, tw, s)
                                    : density_split<float>(psi, out, m, log_n, pref, tw, s));
}

// K13. as K1 without the kick and the inverse: out is the forward DFT along
// axis 1 (in == out allowed); partials: (b1 * lanes / W, 2) double.
int msm_axis_fwd_reduce(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                        const void* s0, const void* s12, double cutoff, void* partials,
                        int is_double, int stages, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return static_cast<int>(roundtrip<double, kFwdReduce>(
        in, out, b1, log_n, lanes,
        roundtrip_args<double>(s0, s12, nullptr, nullptr, nullptr, cutoff, partials), stages,
        tw, s));
  }
  return static_cast<int>(roundtrip<float, kFwdReduce>(
      in, out, b1, log_n, lanes,
      roundtrip_args<float>(s0, s12, nullptr, nullptr, nullptr, cutoff, partials), stages, tw,
      s));
}

// K12. in, out: (b1, 2^log_n, lanes) interleaved complex (in == out allowed);
// f0: (b1, n), f12: (b1, lanes) complex phase factors. stages 0: the radix
// form (axis_radix.cuh axis_pass_kernel; lanes a multiple of its tile width)
// with tw: (n,) interleaved complex w_n^m; 1: the stages form
// (axis_fft_kernel; tw unused).
int msm_axis_inv_kick(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                      const void* f0, const void* f12, int is_double, int stages,
                      const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? axis_inv_kick<double>(in, out, b1, log_n, lanes, f0, f12, stages, tw, s)
                : axis_inv_kick<float>(in, out, b1, log_n, lanes, f0, f12, stages, tw, s));
}

// K10. in, rho: (m, n, n) interleaved complex, distinct; cluster, stages
// and tw as for K2.
int msm_plane_inv_density_rho_only(const void* in, void* rho, int64_t m, int log_n,
                                   double pref, int is_double, int cluster, int stages,
                                   const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster) {
    return static_cast<int>(
        is_double
            ? inv_density_cluster<double>(in, nullptr, rho, m, log_n, cluster, pref, tw, s)
            : inv_density_cluster<float>(in, nullptr, rho, m, log_n, cluster, pref, tw, s));
  }
  if (stages) {
    return static_cast<int>(
        is_double ? plane_inv_density_rho_only<double>(in, rho, m, log_n, pref, s)
                  : plane_inv_density_rho_only<float>(in, rho, m, log_n, pref, s));
  }
  return static_cast<int>(is_double ? inv_density_split<double, kRhoOnly>(
                                          in, nullptr, rho, m, log_n, pref, tw, s)
                                    : inv_density_split<float, kRhoOnly>(
                                          in, nullptr, rho, m, log_n, pref, tw, s));
}

// K11. in: (m, n, n) interleaved complex, 16-byte aligned; tw: (n,)
// interleaved complex w_n^m. cluster > 0: the cluster form
// (plane_cluster.cuh) with that many blocks per plane, no scratch (tmp
// null), maxes (m * cluster,), one per block; else tmp (m, n, n)
// interleaved complex scratch, maxes (m * n * n / 2048,) real, one max |Re|
// per row block, and stages 0: the split form (split_radix.cuh), 1: the
// stages form (tw unused).
int msm_plane_real_inv_max(const void* in, void* tmp, void* maxes, int64_t m, int log_n,
                           int is_double, int cluster, int stages, const void* tw,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster) {
    return static_cast<int>(
        is_double ? real_inv_max_cluster<double>(in, maxes, m, log_n, cluster, tw, s)
                  : real_inv_max_cluster<float>(in, maxes, m, log_n, cluster, tw, s));
  }
  if (stages) {
    return static_cast<int>(is_double
                                ? plane_real_inv_max<double>(in, tmp, maxes, m, log_n, s)
                                : plane_real_inv_max<float>(in, tmp, maxes, m, log_n, s));
  }
  return static_cast<int>(is_double
                              ? real_inv_max_split<double>(in, tmp, maxes, m, log_n, tw, s)
                              : real_inv_max_split<float>(in, tmp, maxes, m, log_n, tw, s));
}

}  // extern "C"
