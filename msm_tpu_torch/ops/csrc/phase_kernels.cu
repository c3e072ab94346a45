// Hopper (sm_90a) kernels for the elementwise passes of the KDK step, bound
// to Python through a plain C interface (msm_tpu_torch/ops/build.py compiles
// this file with nvcc and loads it with ctypes).
//
//   msm_kinetic_phase    : z * exp(i * scale_b * q^2), q^2 synthesized from
//                          the flat index; replaces
//                          msm_tpu/ops/pallas_kernels.py kinetic_phase /
//                          _kinetic_kernel (K19).
//   msm_poisson_multiply : z * scale_b / q^2, 0 where q^2 = 0, q^2 as for
//                          K19; replaces pallas_kernels.py poisson_multiply /
//                          _poisson_kernel (K20).
//   msm_phase_rotate     : z * exp(i * coeff_b * field); replaces
//                          msm_tpu/ops/pallas_kernels.py phase_rotate /
//                          _rotate_kernel (K21).
//
// All are single memory-bound passes: K19 and K20 read and write one complex
// grid (2 x 16 bytes per complex128 cell, 2 x 8 per complex64) and K21 also
// reads the real field. K20's factor scale_b / q^2 is one division in the
// kernel's precision, rounded once as the TPU kernel rounds it (not a
// multiply by a reciprocal). The TPU kernels' z-plane blocking and separate re/im planes
// exist only for VMEM and Pallas's lack of a complex type; here each thread
// loads one interleaved (re, im) pair as a float2/double2 (coalesced 8- or
// 16-byte accesses), so the pass runs at device-memory bandwidth without
// shared memory. K19 never reads a k^2 grid: q^2 is built in registers from
// the index, as the TPU kernel builds it from iota.
//
// Accuracy: theta reaches several radians, so the accurate sincos/sincosf
// are used (the file is built without --use_fast_math). q^2 is summed in
// integers in the order z, y, x and converted once, exact for N <= 1024.
//
// Launch: grid.y is the stream batch (scale/coeff loaded once per thread),
// grid.x strides over the cells of one grid. Every entry point launches on
// the stream it is given and returns cudaGetLastError().

#include <cuda_runtime.h>

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

__device__ __forceinline__ void sincos_acc(float x, float* s, float* c) {
  sincosf(x, s, c);
}
__device__ __forceinline__ void sincos_acc(double x, double* s, double* c) {
  sincos(x, s, c);
}

template <typename T>
__device__ __forceinline__ typename Complex<T>::type rotate(
    typename Complex<T>::type z, T theta) {
  T s, c;
  sincos_acc(theta, &s, &c);
  typename Complex<T>::type out;
  out.x = z.x * c - z.y * s;
  out.y = z.x * s + z.y * c;
  return out;
}

// Integer fftfreq numerator: q(i) = i for i < n/2, else i - n.
__device__ __forceinline__ int64_t freq_sq(int64_t i, int n) {
  const int64_t q = i < n / 2 ? i : i - n;
  return q * q;
}

// flat index -> q^2 = qz^2 + qy^2 + qx^2 over the last `dims` axes, x fastest,
// summed in the order z, y, x. The wrappers keep cells below 2^31, so the
// decode runs in 32 bits.
__device__ __forceinline__ int64_t index_q2(int64_t i, int n, int dims) {
  const unsigned ui = static_cast<unsigned>(i);
  const unsigned un = static_cast<unsigned>(n);
  const int64_t ix = ui % un;
  const unsigned rest = ui / un;
  int64_t q2 = 0;
  if (dims == 3) q2 += freq_sq(rest / un, n);
  if (dims >= 2) q2 += freq_sq(rest % un, n);
  q2 += freq_sq(ix, n);
  return q2;
}

template <typename T>
__global__ void kinetic_phase_kernel(const typename Complex<T>::type* __restrict__ z,
                                     typename Complex<T>::type* __restrict__ out,
                                     const T* __restrict__ scale, int64_t cells,
                                     int n, int dims) {
  const int64_t b = blockIdx.y;
  const T sc = scale[b];
  const typename Complex<T>::type* zb = z + b * cells;
  typename Complex<T>::type* ob = out + b * cells;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cells;
       i += (int64_t)gridDim.x * blockDim.x) {
    ob[i] = rotate<T>(zb[i], sc * static_cast<T>(index_q2(i, n, dims)));
  }
}

template <typename T>
__global__ void poisson_multiply_kernel(const typename Complex<T>::type* __restrict__ z,
                                        typename Complex<T>::type* __restrict__ out,
                                        const T* __restrict__ scale, int64_t cells, int n,
                                        int dims) {
  const int64_t b = blockIdx.y;
  const T sc = scale[b];
  const typename Complex<T>::type* zb = z + b * cells;
  typename Complex<T>::type* ob = out + b * cells;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cells;
       i += (int64_t)gridDim.x * blockDim.x) {
    const int64_t q2 = index_q2(i, n, dims);
    const T factor = q2 > 0 ? sc / static_cast<T>(q2) : T(0);
    typename Complex<T>::type v = zb[i];
    v.x *= factor;
    v.y *= factor;
    ob[i] = v;
  }
}

template <typename T>
__global__ void phase_rotate_kernel(const typename Complex<T>::type* __restrict__ z,
                                    const T* __restrict__ field,
                                    typename Complex<T>::type* __restrict__ out,
                                    const T* __restrict__ coeff, int64_t cells) {
  const int64_t b = blockIdx.y;
  const T cf = coeff[b];
  const int64_t off = b * cells;
  for (int64_t i = blockIdx.x * (int64_t)blockDim.x + threadIdx.x; i < cells;
       i += (int64_t)gridDim.x * blockDim.x) {
    out[off + i] = rotate<T>(z[off + i], cf * field[off + i]);
  }
}

constexpr int kThreads = 256;
// Enough blocks per stream to cover the 132 SMs several times over; the
// grid-stride loop takes the rest.
constexpr int64_t kMaxBlocksX = 132 * 8;

dim3 grid_for(int64_t cells, int64_t batch) {
  int64_t bx = (cells + kThreads - 1) / kThreads;
  if (bx > kMaxBlocksX) bx = kMaxBlocksX;
  if (bx < 1) bx = 1;
  return dim3(static_cast<unsigned>(bx), static_cast<unsigned>(batch));
}

}  // namespace

extern "C" {

// z, out: (batch, n^dims) interleaved complex; scale: (batch,) real.
int msm_kinetic_phase(const void* z, void* out, const void* scale,
                      int64_t batch, int n, int dims, int is_double,
                      void* stream) {
  int64_t cells = 1;
  for (int d = 0; d < dims; ++d) cells *= n;
  const dim3 grid = grid_for(cells, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    kinetic_phase_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double2*>(z), static_cast<double2*>(out),
        static_cast<const double*>(scale), cells, n, dims);
  } else {
    kinetic_phase_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float2*>(z), static_cast<float2*>(out),
        static_cast<const float*>(scale), cells, n, dims);
  }
  return static_cast<int>(cudaGetLastError());
}

// z, out: (batch, n^dims) interleaved complex; scale: (batch,) real.
int msm_poisson_multiply(const void* z, void* out, const void* scale, int64_t batch, int n,
                         int dims, int is_double, void* stream) {
  int64_t cells = 1;
  for (int d = 0; d < dims; ++d) cells *= n;
  const dim3 grid = grid_for(cells, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    poisson_multiply_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double2*>(z), static_cast<double2*>(out),
        static_cast<const double*>(scale), cells, n, dims);
  } else {
    poisson_multiply_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float2*>(z), static_cast<float2*>(out),
        static_cast<const float*>(scale), cells, n, dims);
  }
  return static_cast<int>(cudaGetLastError());
}

// z, out: (batch, cells) interleaved complex; field: (batch, cells) real;
// coeff: (batch,) real.
int msm_phase_rotate(const void* z, const void* field, void* out,
                     const void* coeff, int64_t batch, int64_t cells,
                     int is_double, void* stream) {
  const dim3 grid = grid_for(cells, batch);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_double) {
    phase_rotate_kernel<double><<<grid, kThreads, 0, s>>>(
        static_cast<const double2*>(z), static_cast<const double*>(field),
        static_cast<double2*>(out), static_cast<const double*>(coeff), cells);
  } else {
    phase_rotate_kernel<float><<<grid, kThreads, 0, s>>>(
        static_cast<const float2*>(z), static_cast<const float*>(field),
        static_cast<float2*>(out), static_cast<const float*>(coeff), cells);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
