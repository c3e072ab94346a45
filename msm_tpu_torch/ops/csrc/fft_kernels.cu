// Hopper (sm_90a) FFT kernels for the MXU engine's unfused transform path,
// bound to Python through a plain C interface (msm_tpu_torch/ops/build.py
// compiles this file with nvcc and loads it with ctypes).
//
//   msm_fft_axis           : ortho DFT along a non-last axis of a (b1, n, lanes)
//                            view; replaces msm_tpu/ops/mxu_fft.py
//                            _axis_pass_sublane / _sublane_kernel (K5).
//   msm_fft_plane          : ortho 2-axis DFT over the last two axes of
//                            (m, n, n); replaces _axis_pass_fused2 /
//                            _fused_kernel (K6).
//   msm_fft_plane_real_fwd : the same forward from a real input; replaces
//                            _axis_pass_fused2_real(inverse=False) /
//                            _fused_kernel_real_fwd (K17).
//   msm_fft_plane_real_inv : Re of the 2-axis inverse, real plane out;
//                            replaces _axis_pass_fused2_real(inverse=True) /
//                            _fused_kernel_real_inv (K9).
//   msm_fft_lane           : ortho DFT along the last axis of (rows, n);
//                            replaces _axis_pass_lane / _lane_kernel (K14).
//   msm_fft_lane_real_fwd  : the same forward from a real input, full
//                            spectrum out; replaces
//                            _axis_pass_lane_real(inverse=False) /
//                            _lane_kernel_real_fwd (K15).
//   msm_fft_lane_real_inv  : Re of the inverse along the last axis, real out;
//                            replaces _axis_pass_lane_real(inverse=True) /
//                            _lane_kernel_real_inv (K16).
//   msm_fft_axis_inv_map   : the inverse DFT along a non-last axis with a real
//                            (n, lanes) map multiplied in as the tile is
//                            loaded; replaces _axis_pass_sublane_inv_pmap /
//                            _sublane_kernel_inv_pmap (K18).
//
// K14-K16 (the 1-D engine and any last-axis transform) are one launch, one
// read and one write of the grid: lane_fft_kernel (lane_radix.cuh), radix-16
// register passes over whole rows with the wrapper's twiddle table. K5 and
// K18 are the radix form's column pass (axis_radix.cuh axis_pass_kernel: one
// column tile a block, radix-16 register passes, a natural-order store; K18
// with the map multiplied in on load, one extra read of n * lanes reals,
// which the batch shares). K6, K17 and K9 at n >= 512 are these two passes
// in turn (the split form below). The radix-2 kernels they replaced stay
// reachable only as forced forms, which chip_smoke.py and the `cuda` tests
// time and hold beside them; no path takes one: row_fft_kernel is K14-K16's
// `form="row"` (mxu_fft._lane_form), axis_fft_kernel (fft_common.cuh) K5's
// and K18's `form="stages"` (mxu_fft._axis_form), and the two together K6,
// K17 and K9's `form="stages"` (mxu_fft._plane_form).
//
// Data are interleaved complex (torch.view_as_real layout), k in natural
// fftn order. The TPU kernels' radix-R butterfly plus 128-point DFT matmul,
// their separate re/im planes and their residue-major k order exist only for
// the MXU, Pallas's lack of a complex type and a TPU that must never shuffle
// data; none of them is carried over.
//
// What bounds them: device memory. Every transform reads its input once and
// writes its output once (16 bytes per complex64 cell, 32 per complex128):
// at (9, 256^3) complex64 one grid is 1.21 GB, 0.36 ms at 3.35 TB/s, so a
// pass (K5, K14) or a 2-axis plane (K6) must move 2 grids, 0.72 ms, as long
// as the transform in shared memory keeps up. Three geometries:
//
//   axis pass (K5, K18: axis_pass_kernel, axis_radix.cuh): one column tile
//     of 128-byte row segments a block (64 at n = 1024), 16 elements of a
//     column a thread in registers, two or three radix-16 passes with one
//     barrier between them.
//   lanes (lane_fft_kernel, lane_radix.cuh): R whole rows a block, N / 16
//     threads a row, each length-N transform in two or three radix-16 (and
//     8, 4, 2) register passes in padded shared memory, the digit order
//     undone on the store; 16-byte loads and stores (K15's real load and
//     K16's real store four floats or two doubles a vector).
//   plane (K6, K17, K9): at n = 128 and 256 the one-pass cluster form
//     (plane_cluster.cuh): the plane in the shared memory of a cluster of 2-8
//     blocks, radix-16 register passes for rows and columns, one transpose
//     across the cluster between them, 2 grids of traffic (K17, K9: 1.5, a
//     real grid on one side). At n = 512 and 1024 a plane (2 MB and 8 MB at
//     complex64) exceeds a portable cluster's 8 x 227 KB, so they take the
//     split form: the lane pass over the plane's n rows and the axis pass
//     over its columns (the (m, n, n) view with lanes = n), the intermediate
//     in device memory (partly the 50 MB L2). K6: rows in -> out, then the
//     columns in place in out; K17: rows with K15's real load in -> out,
//     then the columns in place; K9: the inverse columns in -> tmp (the
//     wrapper's complex scratch), then rows with K16's real store tmp ->
//     out. 4 grids of traffic for K6, 3.5 for K17 and K9, against the
//     cluster form's 2 and 1.5. The wrapper picks the form by shape
//     (mxu_fft._plane_form).
//
// Accuracy: FP32 (or FP64) CUDA-core arithmetic only, no tensor cores.
// Twiddles are computed in double and rounded once to the kernel's precision:
// once per (n, dtype) by the wrapper (mxu_fft._twiddles) for every radix and
// cluster kernel, per block with sincospi in the radix-2 forced forms; the
// file is built without --use_fast_math.
// The ortho 1/sqrt(n) of each axis is applied as the pass writes.
// Offsets are 64-bit (batch * n^3 passes 2^31 at 1024^3). Every entry point
// launches on the stream it is given and returns cudaGetLastError().

#include "axis_radix.cuh"
#include "lane_radix.cuh"
#include "plane_cluster.cuh"

namespace {

template <typename T, bool INV, bool IN_REAL, bool OUT_REAL>
__global__ void __launch_bounds__(kRowThreads)
    row_fft_kernel(const void* in, void* out, int log_n, int64_t rows, T scale) {
  using C = typename Complex<T>::type;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  C* x = reinterpret_cast<C*>(smem);
  C* y = x + kRowTile;
  C* tw = y + kRowTile;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * kRowTile;
  const int64_t left = (rows << log_n) - first;
  const int count = left < kRowTile ? static_cast<int>(left) : kRowTile;

  fill_twiddles<T>(tw, n, INV);
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    if constexpr (IN_REAL) {
      x[i].x = static_cast<const T*>(in)[first + i];
      x[i].y = T(0);
    } else {
      x[i] = static_cast<const C*>(in)[first + i];
    }
  }
  __syncthreads();
  // Stockham radix-2 (decimation in frequency, self-sorting): at stride
  // s = 2^log_s, y[q + s*2p] = a + b and y[q + s*(2p+1)] = (a - b) w^p with
  // a = x[q + s*p], b = x[q + s*(p + n/2)] and w = exp(sign 2 pi i s / n).
  for (int log_s = 0; log_s < log_n; ++log_s) {
    const int s = 1 << log_s;
    for (int i = threadIdx.x; i < count / 2; i += blockDim.x) {
      const int row = i >> (log_n - 1);
      const int bf = i & (half - 1);
      const int q = bf & (s - 1);
      const int p = bf >> log_s;
      const C* xr = x + (row << log_n);
      C* yr = y + (row << log_n);
      const C a = xr[bf];
      const C b = xr[bf + half];
      yr[q + ((2 * p) << log_s)] = cadd(a, b);
      yr[q + ((2 * p + 1) << log_s)] = cmul(csub(a, b), tw[p << log_s]);
    }
    __syncthreads();
    C* t = x;
    x = y;
    y = t;
  }
  for (int i = threadIdx.x; i < count; i += blockDim.x) {
    if constexpr (OUT_REAL) {
      static_cast<T*>(out)[first + i] = x[i].x * scale;
    } else {
      static_cast<C*>(out)[first + i] = cscale(x[i], scale);
    }
  }
}

// rows of length n, contiguous.
template <typename T, bool INV, bool IN_REAL, bool OUT_REAL>
cudaError_t launch_rows(const void* in, void* out, int64_t rows, int log_n,
                        cudaStream_t stream) {
  using C = typename Complex<T>::type;
  const int n = 1 << log_n;
  const size_t smem = (2 * static_cast<size_t>(kRowTile) + n / 2) * sizeof(C);
  static const cudaError_t err = cudaFuncSetAttribute(
      row_fft_kernel<T, INV, IN_REAL, OUT_REAL>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((2 * kRowTile + (1 << kMaxLogN) / 2) * sizeof(C)));
  if (err != cudaSuccess) return err;
  const int64_t blocks = ((rows << log_n) + kRowTile - 1) / kRowTile;
  row_fft_kernel<T, INV, IN_REAL, OUT_REAL>
      <<<static_cast<unsigned>(blocks), kRowThreads, smem, stream>>>(
          in, out, log_n, rows, ortho_scale<T>(log_n));
  return cudaGetLastError();
}

// Contiguous rows of n = 2^log_n: the radix form (lane_fft_kernel, tw: (n,)
// w_n^m), or with row_form the radix-2 row pass (row_fft_kernel; tw
// unused). K14-K16, and the row half of K6, K17 and K9's split forms.
template <typename T, bool INV, bool IN_REAL, bool OUT_REAL>
cudaError_t rows_pass(const void* in, void* out, int64_t rows, int log_n, int row_form,
                      const void* tw, cudaStream_t stream) {
  return row_form ? launch_rows<T, INV, IN_REAL, OUT_REAL>(in, out, rows, log_n, stream)
                  : launch_lane<T, INV, IN_REAL, OUT_REAL>(in, out, rows, log_n, tw, stream);
}

// K5 in the radix form (axis_radix.cuh, tw: (n,) w_n^m) or the stages form.
template <typename T>
cudaError_t axis_pass(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                      bool inverse, int stages, const void* tw, cudaStream_t stream) {
  if (stages) return axis<T>(in, out, b1, log_n, lanes, inverse, stream);
  return inverse ? launch_axis_pass_radix<T, true, AxisPrologue::kNone>(in, out, b1, log_n, lanes,
                                                                        {}, tw, stream)
                 : launch_axis_pass_radix<T, false, AxisPrologue::kNone>(in, out, b1, log_n,
                                                                         lanes, {}, tw, stream);
}

// The split forms of K6, K17 and K9 on (m, n, n): the row pass and the
// column pass (the (m, n, n) view with lanes = n), both radix (stages 0)
// or both radix-2 (stages 1). K6 and K17: the rows into out, then the
// columns in place in out.
template <typename T>
cudaError_t plane(const void* in, void* out, int64_t m, int log_n, bool inverse, int stages,
                  const void* tw, cudaStream_t stream) {
  const int64_t n = int64_t(1) << log_n;
  cudaError_t err =
      inverse ? rows_pass<T, true, false, false>(in, out, m * n, log_n, stages, tw, stream)
              : rows_pass<T, false, false, false>(in, out, m * n, log_n, stages, tw, stream);
  if (err != cudaSuccess) return err;
  return axis_pass<T>(out, out, m, log_n, n, inverse, stages, tw, stream);
}

template <typename T>
cudaError_t plane_real_fwd(const void* in, void* out, int64_t m, int log_n, int stages,
                           const void* tw, cudaStream_t stream) {
  const int64_t n = int64_t(1) << log_n;
  cudaError_t err = rows_pass<T, false, true, false>(in, out, m * n, log_n, stages, tw, stream);
  if (err != cudaSuccess) return err;
  return axis_pass<T>(out, out, m, log_n, n, false, stages, tw, stream);
}

// K9: the columns into tmp (complex), then the rows into the real out.
template <typename T>
cudaError_t plane_real_inv(const void* in, void* tmp, void* out, int64_t m, int log_n,
                           int stages, const void* tw, cudaStream_t stream) {
  const int64_t n = int64_t(1) << log_n;
  cudaError_t err = axis_pass<T>(in, tmp, m, log_n, n, true, stages, tw, stream);
  if (err != cudaSuccess) return err;
  return rows_pass<T, true, false, true>(tmp, out, m * n, log_n, stages, tw, stream);
}

// K18 in either form.
template <typename T>
cudaError_t axis_inv_map(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                         const void* map, int stages, const void* tw, cudaStream_t stream) {
  const AxisLoad<T> pro{nullptr, nullptr, static_cast<const T*>(map)};
  return stages ? launch_axis<T, true, AxisPrologue::kMap>(in, out, b1, log_n, lanes, stream, pro)
                : launch_axis_pass_radix<T, true, AxisPrologue::kMap>(in, out, b1, log_n, lanes,
                                                                      pro, tw, stream);
}

}  // namespace

extern "C" {

// K5. in, out: (b1, 2^log_n, lanes) interleaved complex, lanes a multiple of
// the form's tile width (128 bytes of a row; 64 in the radix form at n =
// 1024); transform along the middle axis. in == out is allowed. stages 0:
// the radix form (axis_radix.cuh axis_pass_kernel) with tw: (n,)
// interleaved complex w_n^m; 1: the stages form (axis_fft_kernel; tw
// unused).
int msm_fft_axis(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                 int inverse, int is_double, int stages, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? axis_pass<double>(in, out, b1, log_n, lanes, inverse, stages, tw, s)
                : axis_pass<float>(in, out, b1, log_n, lanes, inverse, stages, tw, s));
}

// K6. in, out: (m, n, n) interleaved complex, n = 2^log_n, 16-byte
// aligned; in != out. cluster > 0: the cluster form (plane_cluster.cuh)
// with that many blocks per plane; 0: the split form, radix (stages 0) or
// radix-2 (stages 1). tw: (n,) interleaved complex w_n^m (unused by the
// stages form).
int msm_fft_plane(const void* in, void* out, int64_t m, int log_n, int inverse,
                  int is_double, int cluster, int stages, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster) {
    return static_cast<int>(
        inverse ? plane_cluster<true, Vec, Vec>(in, out, m, log_n, cluster, is_double, tw, s)
                : plane_cluster<false, Vec, Vec>(in, out, m, log_n, cluster, is_double, tw, s));
  }
  return static_cast<int>(is_double ? plane<double>(in, out, m, log_n, inverse, stages, tw, s)
                                    : plane<float>(in, out, m, log_n, inverse, stages, tw, s));
}

// K17. in: (m, n, n) real; out: (m, n, n) interleaved complex; both 16-byte
// aligned. cluster, stages and tw as for K6.
int msm_fft_plane_real_fwd(const void* in, void* out, int64_t m, int log_n, int is_double,
                           int cluster, int stages, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster) {
    return static_cast<int>(
        plane_cluster<false, RealVec, Vec>(in, out, m, log_n, cluster, is_double, tw, s));
  }
  return static_cast<int>(is_double ? plane_real_fwd<double>(in, out, m, log_n, stages, tw, s)
                                    : plane_real_fwd<float>(in, out, m, log_n, stages, tw, s));
}

// K9. in: (m, n, n) interleaved complex; out: (m, n, n) real, the real part
// of the inverse; both 16-byte aligned. tmp: (m, n, n) interleaved complex
// scratch of the split form (cluster 0), 16-byte aligned; the cluster form
// takes null. cluster, stages and tw as for K6.
int msm_fft_plane_real_inv(const void* in, void* tmp, void* out, int64_t m, int log_n,
                           int is_double, int cluster, int stages, const void* tw,
                           void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (cluster) {
    return static_cast<int>(
        plane_cluster<true, Vec, RealVec>(in, out, m, log_n, cluster, is_double, tw, s));
  }
  return static_cast<int>(
      is_double ? plane_real_inv<double>(in, tmp, out, m, log_n, stages, tw, s)
                : plane_real_inv<float>(in, tmp, out, m, log_n, stages, tw, s));
}

// K14. in, out: (rows, 2^log_n) interleaved complex, 16-byte aligned;
// transform along the last axis. row_form 0: lane_fft_kernel
// (lane_radix.cuh) with tw: (2^log_n,) interleaved complex w_n^m; 1: the
// row form (row_fft_kernel; tw unused). in == out is allowed.
int msm_fft_lane(const void* in, void* out, int64_t rows, int log_n, int inverse,
                 int is_double, int row_form, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    return static_cast<int>(
        inverse ? rows_pass<double, true, false, false>(in, out, rows, log_n, row_form, tw, s)
                : rows_pass<double, false, false, false>(in, out, rows, log_n, row_form, tw, s));
  }
  return static_cast<int>(
      inverse ? rows_pass<float, true, false, false>(in, out, rows, log_n, row_form, tw, s)
              : rows_pass<float, false, false, false>(in, out, rows, log_n, row_form, tw, s));
}

// K15. in: (rows, 2^log_n) real; out: (rows, 2^log_n) interleaved complex;
// row_form and tw as for K14.
int msm_fft_lane_real_fwd(const void* in, void* out, int64_t rows, int log_n, int is_double,
                          int row_form, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? rows_pass<double, false, true, false>(in, out, rows, log_n, row_form, tw, s)
                : rows_pass<float, false, true, false>(in, out, rows, log_n, row_form, tw, s));
}

// K16. in: (rows, 2^log_n) interleaved complex; out: (rows, 2^log_n) real, the
// real part of the inverse; row_form and tw as for K14.
int msm_fft_lane_real_inv(const void* in, void* out, int64_t rows, int log_n, int is_double,
                          int row_form, const void* tw, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? rows_pass<double, true, false, true>(in, out, rows, log_n, row_form, tw, s)
                : rows_pass<float, true, false, true>(in, out, rows, log_n, row_form, tw, s));
}

// K18. in, out: (b1, 2^log_n, lanes) interleaved complex as for K5; map:
// (2^log_n, lanes) real, shared by the b1 batch elements. in == out is
// allowed. stages and tw as for K5.
int msm_fft_axis_inv_map(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                         const void* map, int is_double, int stages, const void* tw,
                         void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  return static_cast<int>(
      is_double ? axis_inv_map<double>(in, out, b1, log_n, lanes, map, stages, tw, s)
                : axis_inv_map<float>(in, out, b1, log_n, lanes, map, stages, tw, s));
}

}  // extern "C"
