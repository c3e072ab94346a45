// Device helpers shared by the port's FFT kernels (fft_kernels.cu, the
// engine's plain transforms, and fused_kernels.cu, the fused step's
// transforms with elementwise prologues and epilogues): interleaved complex
// arithmetic, twiddle tables, and the column ("axis") pass.
//
//   axis pass (axis_fft_kernel; the stages form of K5, K12 and K18, whose
//     radix form is axis_radix.cuh's axis_pass_kernel, and the column half of
//     the plane kernels' stages forms): one block loads an n x W tile of W
//     contiguous columns (W * sizeof(complex) = 128 bytes of each row, so
//     every row segment is one coalesced 128-byte run), runs an in-place
//     radix-2 decimation-in-time FFT down each column in shared memory (the
//     bit-reversal permutation is applied while storing the tile: a row of W
//     elements lands in one bit-reversed row, so the stores stay free of bank
//     conflicts) and writes the tile back in natural order. At n = 1024 the
//     tile is 128 KB, above the 48 KB default, so it is dynamic shared memory
//     raised with cudaFuncSetAttribute. A load prologue may multiply each
//     element as it is read: kKick by the separable kinetic phase
//     f0[b, row] * f12[b, lane] (the unskewed fused step's first pass, K12),
//     kMap by a real k-space map[row, lane] shared by the batch (the Poisson
//     -coeff/k^2 on the inverse's read, K18).
//
// Twiddles are computed per block with double-precision sincospi and rounded
// once to the kernel's precision (the one-pass forms, plane_cluster.cuh and
// the lane kernels' lane_radix.cuh, read a table the wrapper builds once per
// size instead). Offsets are 64-bit. Everything here has internal linkage:
// each source that includes it gets its own copy.
//
// Launchers raise a kernel's dynamic shared-memory limit once per template
// instantiation (a function-local static), to the size its largest supported
// n (kMaxLogN) needs, not on every launch.

#pragma once

#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

template <typename T>
struct Complex;
template <>
struct Complex<float> {
  using type = float2;
};
template <>
struct Complex<double> {
  using type = double2;
};

template <typename C>
__device__ __forceinline__ C cadd(C a, C b) {
  C r;
  r.x = a.x + b.x;
  r.y = a.y + b.y;
  return r;
}

template <typename C>
__device__ __forceinline__ C csub(C a, C b) {
  C r;
  r.x = a.x - b.x;
  r.y = a.y - b.y;
  return r;
}

template <typename C>
__device__ __forceinline__ C cmul(C a, C b) {
  C r;
  r.x = a.x * b.x - a.y * b.y;
  r.y = a.x * b.y + a.y * b.x;
  return r;
}

template <typename C>
__device__ __forceinline__ C cconj(C a) {
  a.y = -a.y;
  return a;
}

template <typename C, typename T>
__device__ __forceinline__ C cscale(C a, T s) {
  C r;
  r.x = a.x * s;
  r.y = a.y * s;
  return r;
}

__device__ __forceinline__ void sincos_acc(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sincos_acc(double x, double* s, double* c) {
  sincos(x, s, c);
}

// max that keeps a NaN, as jnp.max and torch.amax do
template <typename T>
__device__ __forceinline__ T nan_max(T m, T v) {
  return (v > m || v != v) ? v : m;
}

// The engine's largest transform: n = 2^kMaxLogN = 1024.
constexpr int kMaxLogN = 10;

// tw[m] = exp(sign * 2 pi i m / n) for m < n/2, sign -1 forward, +1 inverse.
template <typename T>
__device__ void fill_twiddles(typename Complex<T>::type* tw, int n, bool inverse) {
  for (int m = threadIdx.x; m < n / 2; m += blockDim.x) {
    double s, c;
    sincospi(2.0 * m / n, &s, &c);
    tw[m].x = static_cast<T>(c);
    tw[m].y = static_cast<T>(inverse ? s : -s);
  }
}

// Columns per axis-pass tile: 128 bytes of a row (16 complex64, 8 complex128).
template <typename T>
__host__ __device__ constexpr int log_tile_width() {
  return sizeof(T) == 4 ? 4 : 3;
}

// Threads of a column-tile block: one per 8 butterflies of a stage, 256..1024.
template <typename T>
int tile_threads(int log_n) {
  int threads = (1 << (log_n + log_tile_width<T>())) / 16;
  if (threads < 256) threads = 256;
  if (threads > 1024) threads = 1024;
  return threads;
}

// What the column pass does to each element as it loads it.
enum class AxisPrologue { kNone, kKick, kMap };

// The prologue's tables. kKick: exp(i c_b s0[k]) (b1, n) and
// exp(i c_b s12[lane]) (b1, lanes), built outside the kernel; their product is
// the phase of exp(i c_b k^2) with k^2 = s0 + s12, multiplied in the order the
// TPU kernel multiplies it. kMap: a real (n, lanes) map, one for every batch
// element, read as the round trip's map is read (map[k * lanes + lane]).
template <typename T>
struct AxisLoad {
  const typename Complex<T>::type* f0;
  const typename Complex<T>::type* f12;
  const T* map;
};

template <typename T, bool INV, AxisPrologue P = AxisPrologue::kNone>
__global__ void __launch_bounds__(1024)
    axis_fft_kernel(const typename Complex<T>::type* in, typename Complex<T>::type* out,
                    int log_n, int64_t lanes, int64_t tiles_per_batch, T scale,
                    AxisLoad<T> pro) {
  // in may equal out: the whole tile is read before any of it is written.
  using C = typename Complex<T>::type;
  constexpr int log_w = log_tile_width<T>();
  constexpr int w = 1 << log_w;
  extern __shared__ __align__(16) unsigned char smem[];
  const int n = 1 << log_n;
  C* tile = reinterpret_cast<C*>(smem);  // tile[row * w + col]
  C* tw = tile + (n << log_w);
  const int64_t b = blockIdx.x / tiles_per_batch;
  const int64_t col0 = (blockIdx.x - b * tiles_per_batch) << log_w;
  const int64_t base = b * n * lanes + col0;
  const int total = n << log_w;

  fill_twiddles<T>(tw, n, INV);
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & (w - 1);
    const int r = i >> log_w;
    const int rr = static_cast<int>(__brev(static_cast<unsigned>(r)) >> (32 - log_n));
    C v = in[base + r * lanes + c];
    if constexpr (P == AxisPrologue::kKick) {
      v = cmul(v, cmul(pro.f0[b * n + r], pro.f12[b * lanes + col0 + c]));
    } else if constexpr (P == AxisPrologue::kMap) {
      v = cscale(v, pro.map[r * lanes + col0 + c]);
    }
    tile[(rr << log_w) + c] = v;
  }
  __syncthreads();
  // stage with butterfly half-width h: x[i0], x[i0 + h] with twiddle
  // exp(sign 2 pi i k / 2h) = tw[k * n / 2h]
  for (int h = 1, step = n >> 1; h < n; h <<= 1, step >>= 1) {
    for (int i = threadIdx.x; i < total / 2; i += blockDim.x) {
      const int c = i & (w - 1);
      const int j = i >> log_w;
      const int k = j & (h - 1);
      const int i0 = ((j - k) << 1) + k;
      C* p0 = tile + (i0 << log_w) + c;
      C* p1 = p0 + (h << log_w);
      const C a = *p0;
      const C bw = cmul(*p1, tw[k * step]);
      *p0 = cadd(a, bw);
      *p1 = csub(a, bw);
    }
    __syncthreads();
  }
  for (int i = threadIdx.x; i < total; i += blockDim.x) {
    const int c = i & (w - 1);
    const int r = i >> log_w;
    out[base + r * lanes + c] = cscale(tile[i], scale);
  }
}

// Elements per row-pass block (row_fft_kernel, the fused row kernels): whole
// rows, n <= 1024 divides it. K14-K16 and the split form of K6, K17 and K9
// run lane_fft_kernel (lane_radix.cuh).
constexpr int kRowTile = 2048;
constexpr int kRowThreads = 256;

template <typename T>
T ortho_scale(int log_n) {
  return static_cast<T>(1.0 / std::sqrt(static_cast<double>(1 << log_n)));
}

// (b1, n, lanes): transform the middle axis. lanes % W == 0.
template <typename T, bool INV, AxisPrologue P = AxisPrologue::kNone>
cudaError_t launch_axis(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                        cudaStream_t stream, AxisLoad<T> pro = {}) {
  using C = typename Complex<T>::type;
  constexpr int log_w = log_tile_width<T>();
  const int n = 1 << log_n;
  const size_t smem = ((static_cast<size_t>(n) << log_w) + n / 2) * sizeof(C);
  static const cudaError_t err = cudaFuncSetAttribute(
      axis_fft_kernel<T, INV, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>((((1 << kMaxLogN) << log_w) + (1 << kMaxLogN) / 2) * sizeof(C)));
  if (err != cudaSuccess) return err;
  const int64_t tiles = lanes >> log_w;
  axis_fft_kernel<T, INV, P>
      <<<static_cast<unsigned>(b1 * tiles), tile_threads<T>(log_n), smem, stream>>>(
          static_cast<const C*>(in), static_cast<C*>(out), log_n, lanes, tiles,
          ortho_scale<T>(log_n), pro);
  return cudaGetLastError();
}

template <typename T>
cudaError_t axis(const void* in, void* out, int64_t b1, int log_n, int64_t lanes,
                 bool inverse, cudaStream_t stream) {
  return inverse ? launch_axis<T, true>(in, out, b1, log_n, lanes, stream)
                 : launch_axis<T, false>(in, out, b1, log_n, lanes, stream);
}

}  // namespace
