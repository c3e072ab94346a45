// The split form of the fused engine's plane kernels (fused_kernels.cu): K7
// (msm_plane_density_fwd), K2 (msm_plane_inv_density), K10
// (msm_plane_inv_density_rho_only), K4 (msm_plane_potkick_fwd) and K11
// (msm_plane_real_inv_max), at N = 512 and 1024, where a plane exceeds a
// portable cluster's shared memory (and forced at any N). Replaces, with the
// cluster form of plane_cluster.cuh at N = 128 and 256,
// msm_tpu/ops/mxu_fft.py _fused_kernel_density_fwd (K7),
// _fused_kernel_inv_density (K2), _fused_kernel_inv_density_rho_only (K10),
// _fused_kernel_potkick_fwd (K4) and _fused_kernel_real_inv_max (K11); one
// row template, split_row_kernel<T, N, BODY>, serves all five.
//
// What bounds them: device memory. The split form takes a column pass and a
// row pass with the intermediate in device memory: K4 and K2 move 7 grids
// (the column inverse reads and writes one; the rows read it (and K4 psi)
// and write the next field (and K2 psi); the column forward reads and writes
// one), K10 6, K7 4 and K11 3. At (3, 512^3) complex64 a grid is 3.22 GB,
// 0.96 ms at 3.35 TB/s. The radix-2 form before it (row_fused_kernel
// between two axis_fft_kernel column passes, kept as the wrappers' forced
// form="stages") ran log2 N Stockham stages a row transform through shared
// memory with a barrier after each and filled each block's twiddles with
// sincospi. This design:
//   - Columns: the radix column pass of K5 (axis_radix.cuh
//     axis_pass_kernel<T, N, INV, kNone>), in place where the form keeps
//     its intermediate in the output.
//   - Rows: whole rows a block, R = 2048 / N rows of N / 16 threads, 16
//     elements a thread in registers (lane_radix.cuh's geometry and plan, N
//     = P1 P2 P3); the passes of the column pass on a row (dif_passes,
//     dit_passes with W = 1: position p of a row at pad16(p)), one
//     __syncthreads between passes. R divides N, so a block never straddles
//     a plane: K4 reads one stream's coefficient a block and K4 and K11
//     leave one maximum a block, N / R a plane.
//   - K7 (kDensity): pass 1's 16 elements at stride L = N / 16 loaded
//     straight from device memory with rho = pref (re^2 + im^2) formed on
//     load, the forward's decimation in frequency, each register stored at
//     its frequency freq_of_position(16 l + i).
//   - K2, K10, K4, K11: the inverse first (decimation in frequency with
//     conjugate twiddles, from natural columns of the row), which leaves
//     register i at spatial index x = freq_of_position(16 l + i); the
//     middle step there, in registers, with psi written (K2) or read (K4)
//     at its natural index x (a warp covers runs of 16 (N = 512) or 8
//     (1024) contiguous elements); then the forward as the transpose of the
//     decimation in frequency (dit_passes<INV = false>: from that digit
//     order to natural positions, no permutation pass), stored from pass
//     1's registers at positions l + L j. The round trip's adjoint order
//     (its inverse after a forward) would take the digit order to the
//     inverse, not the forward: tests/test_torch_split_radix.py models
//     both. 2 barriers a transform at N <= 256, 4 at 512 and 1024.
//   - Maxima (K4, K11): max |phi| (|Re|) over the thread's registers in
//     order, then block_max (warp shuffles, the warps in turn, no atomics).
//   - Twiddles: the wrapper's (N,) table of w_N^m, as the column pass reads
//     it; no sincospi in the kernel, no fast math.
// In place: a thread reads its row's elements l + L j before its first
// barrier and writes only those (and its block's rows) after its last, so
// the rows' input may be their output.

#pragma once

#include "axis_radix.cuh"

namespace {

// The row bodies: kDensity (K7) forward of pref |psi|^2; kInvDensity (K2)
// inverse, psi written, forward of pref |psi|^2; kRhoOnly (K10) the same
// without the psi write; kPotKick (K4) phi = Re inverse, max |phi|, psi exp(i
// c phi), forward; kRealMax (K11) inverse, max |Re|, nothing written. The
// stages form's row_fused_kernel (fused_kernels.cu) takes the same bodies.
enum RowBody { kInvDensity, kPotKick, kDensity, kRhoOnly, kRealMax };

template <typename T>
struct RowArgs {
  using C = typename Complex<T>::type;
  const C* in;               // kInvDensity, kRhoOnly, kPotKick, kRealMax: rows to inverse-transform
  const C* psi_in;           // kPotKick, kDensity: psi rows
  C* psi_out;                // kInvDensity: psi rows written
  C* out;                    // the forward transform's rows
  T* maxes;                  // kPotKick, kRealMax: (blocks,) max |phi|
  const T* coeff;            // kPotKick: (batch,) kick coefficient
  int64_t planes_per_batch;  // kPotKick: planes of one stream
  T pref;                    // kInvDensity, kDensity, kRhoOnly: density prefactor
};

// Threads of a split row block: 2048 elements, 16 a thread.
constexpr int kSplitThreads = 128;

template <typename T, int N>
struct SplitGeom {
  using C = typename Complex<T>::type;
  static constexpr int kThreadsPerRow = N / 16;
  static constexpr int kRows = kSplitThreads / kThreadsPerRow;
  // the block's rows, padded as pad16; then one real a warp for block_max
  static constexpr size_t kTileSmem = static_cast<size_t>(pad16(kRows * N)) * sizeof(C);
  static constexpr size_t kSmem = kTileSmem + (kSplitThreads / 32) * sizeof(T);
  static_assert(N % kRows == 0, "a block never straddles a plane");
};

// |psi|^2 times pref, in the plain version's order.
template <typename T, typename C>
__device__ __forceinline__ C density(C p, T pref) {
  C r;
  r.x = pref * (p.x * p.x + p.y * p.y);
  r.y = T(0);
  return r;
}

// One block: rows [blockIdx.x R, blockIdx.x R + R) of the (m N, N) rows,
// through BODY (see the note). Resident blocks asked of the compiler: 4 at
// complex64 (a cap of 128 registers), 2 at complex128.
template <typename T, int N, int BODY>
__global__ void __launch_bounds__(kSplitThreads, sizeof(T) == 4 ? 4 : 2)
    split_row_kernel(RowArgs<T> a, const typename Complex<T>::type* __restrict__ tw, T scale) {
  using C = typename Complex<T>::type;
  using Geo = SplitGeom<T, N>;
  constexpr int L = LanePlan<N>::L;
  extern __shared__ __align__(16) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  T* red = reinterpret_cast<T*>(smem + Geo::kTileSmem);
  const int r = threadIdx.x / Geo::kThreadsPerRow;
  const int l = threadIdx.x % Geo::kThreadsPerRow;
  const int64_t row = static_cast<int64_t>(blockIdx.x) * Geo::kRows + r;
  // row r at pad16(r N) = r N + r N / 16: pad16(r N + p) = that + pad16(p)
  C* srow = s + pad16(r * N);
  // register i's index after the decimation in frequency,
  // freq_of_position(16 l + i) = x0 + freq_of_position(i): the digits of
  // 16 l and of i do not mix (16 divides L or L divides 16, P3 divides 16),
  // so each access is a constant offset from x0
  const int x0 = freq_of_position<N>(16 * l);
  C v[16];

  if constexpr (BODY == kDensity) {
    const C* src = a.psi_in + row * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = src[l + L * j];
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = density(v[j], a.pref);
    dif_passes<T, N, false, 1>(srow, v, tw, l, 0);
    C* dst = a.out + row * N;
#pragma unroll
    for (int i = 0; i < 16; ++i) dst[x0 + freq_of_position<N>(i)] = cscale(v[i], scale);
  } else {
    const C* src = a.in + row * N;
#pragma unroll
    for (int j = 0; j < 16; ++j) v[j] = src[l + L * j];
    // the inverse: register i at spatial index x0 + freq_of_position(i)
    dif_passes<T, N, true, 1>(srow, v, tw, l, 0);
    T mx = T(0);
    if constexpr (BODY == kRealMax) {
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        const T re = v[i].x * scale;
        mx = nan_max(mx, re < T(0) ? -re : re);
      }
    } else {
      if constexpr (BODY == kPotKick) {
        const T c = a.coeff[(row / N) / a.planes_per_batch];
        const C* psi = a.psi_in + row * N;
        C p[16];
#pragma unroll
        for (int i = 0; i < 16; ++i) p[i] = psi[x0 + freq_of_position<N>(i)];
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const T phi = v[i].x * scale;
          mx = nan_max(mx, phi < T(0) ? -phi : phi);
          T sn, cs;
          sincos_acc(c * phi, &sn, &cs);
          v[i].x = p[i].x * cs - p[i].y * sn;
          v[i].y = p[i].y * cs + p[i].x * sn;
        }
      } else {
#pragma unroll
        for (int i = 0; i < 16; ++i) {
          const C e = cscale(v[i], scale);
          if constexpr (BODY == kInvDensity) a.psi_out[row * N + x0 + freq_of_position<N>(i)] = e;
          v[i] = density(e, a.pref);
        }
      }
      // the forward from the digit order to natural positions l + L j
      dit_passes<T, N, false, 1>(srow, v, tw, l, 0);
      C* dst = a.out + row * N;
#pragma unroll
      for (int j = 0; j < 16; ++j) dst[l + L * j] = cscale(v[j], scale);
    }
    if constexpr (BODY == kPotKick || BODY == kRealMax) {
      block_max<T, kSplitThreads>(mx, red, a.maxes + blockIdx.x);
    }
  }
}

// The rows of m (N, N) planes through BODY; tw: (N,) w_N^m. Under 48 KB of
// shared memory (at most pad16(2048) complex128), so no attribute to raise.
template <typename T, int BODY>
cudaError_t launch_split_rows(int64_t m, int log_n, const RowArgs<T>& a, const void* tw,
                              cudaStream_t stream) {
  using C = typename Complex<T>::type;
  auto launch = [&](auto n) {
    constexpr int N = decltype(n)::value;
    using Geo = SplitGeom<T, N>;
    split_row_kernel<T, N, BODY>
        <<<static_cast<unsigned>(m * (N / Geo::kRows)), kSplitThreads, Geo::kSmem, stream>>>(
            a, static_cast<const C*>(tw), static_cast<T>(1.0 / std::sqrt(double(N))));
    return cudaGetLastError();
  };
  switch (log_n) {
    case 7:
      return launch(std::integral_constant<int, 128>{});
    case 8:
      return launch(std::integral_constant<int, 256>{});
    case 9:
      return launch(std::integral_constant<int, 512>{});
    case 10:
      return launch(std::integral_constant<int, 1024>{});
    default:
      return cudaErrorInvalidValue;
  }
}

// K5's radix column pass over m (N, N) planes (in == out allowed).
template <typename T>
cudaError_t split_columns(const void* in, void* out, int64_t m, int log_n, bool inverse,
                          const void* tw, cudaStream_t stream) {
  const int64_t n = int64_t(1) << log_n;
  return inverse ? launch_axis_pass_radix<T, true, AxisPrologue::kNone>(in, out, m, log_n, n, {},
                                                                       tw, stream)
                 : launch_axis_pass_radix<T, false, AxisPrologue::kNone>(in, out, m, log_n, n,
                                                                        {}, tw, stream);
}

// The split form of one body over m planes: K7 the rows (psi_in -> out) and
// out's columns forward in place; K2, K10, K4 in's columns inverse into out,
// the rows in place on out, out's columns forward in place; K11 in's columns
// inverse into scratch (a.out's role) and the rows, which write only maxima.
template <typename T, int BODY>
cudaError_t split_plane(const void* in, RowArgs<T> a, void* scratch, int64_t m, int log_n,
                        const void* tw, cudaStream_t stream) {
  using C = typename Complex<T>::type;
  if constexpr (BODY != kDensity) {
    C* cols = BODY == kRealMax ? static_cast<C*>(scratch) : a.out;
    const cudaError_t err = split_columns<T>(in, cols, m, log_n, true, tw, stream);
    if (err != cudaSuccess) return err;
    a.in = cols;
  }
  const cudaError_t err = launch_split_rows<T, BODY>(m, log_n, a, tw, stream);
  if (err != cudaSuccess || BODY == kRealMax) return err;
  return split_columns<T>(a.out, a.out, m, log_n, false, tw, stream);
}

}  // namespace
