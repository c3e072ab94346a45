// The lane kernels K14-K16 (fft_kernels.cu msm_fft_lane, msm_fft_lane_real_fwd,
// msm_fft_lane_real_inv): the ortho DFT along the last axis of (rows, N),
// N in {128, 256, 512, 1024}, as radix-16 register passes over whole rows in
// shared memory. Replaces msm_tpu/ops/mxu_fft.py _lane_kernel (K14),
// _lane_kernel_real_fwd (K15) and _lane_kernel_real_inv (K16); one template,
// lane_fft_kernel<T, N, INV, IN_REAL, OUT_REAL>, serves all three, and is
// also the row half of K6, K17 and K9's split form at N = 512 and 1024
// (fft_kernels.cu `plane`, `plane_real_fwd`, `plane_real_inv`: K17 with
// K15's real load, K9 with K16's real store).
//
// What bounds them: device memory at many rows (at (9 * 256^2, 256)
// complex64 the grid is read once and written once, 0.72 ms at 3.35 TB/s),
// latency at few (the 1-D engine's (256, 1024) is 2 MB each way, 1.25 us:
// the launch, one load, the passes and one store are the whole kernel).
// The design keeps both short:
//   - Each row is a length-N transform in natural order, decimation in
//     frequency, N = P1 P2 P3 (LanePlan): 16 x 8 at 128, 16 x 16 at 256,
//     16 x 16 x 2 at 512, 16 x 16 x 4 at 1024. A pass holds 16 elements a
//     thread in registers (16 / P groups of P), runs their DFTs there
//     (radix-2 stages with the w_16 constants folded in: multiplications by
//     -i and w_8 cost adds) and writes them back in place in padded shared
//     memory (pad16). One __syncthreads between passes: 3 or 4 a row in
//     all, not log2 N.
//   - Pass 1 takes the P1 elements at stride N / P1 of group m (< N / P1)
//     and multiplies output k1 by w_N^{m k1}; pass 2 does the same within
//     each of the P1 contiguous sub-blocks of length L = N / P1 (stride P3,
//     w_L^{n3 k2}); pass 3 DFTs P3 contiguous elements. Frequency f = f1 +
//     P1 f2 + P1 P2 f3 then sits at f1 L + f2 P3 + f3 (digit_position): the
//     store gathers it from there, so no permutation pass is added.
//   - Twiddles: one table of w_N^m, m < N, built once per (N, dtype) by the
//     wrapper in double and rounded once (mxu_fft._twiddles, the cluster
//     form's table), read through the read-only cache; a thread fetches the
//     15 (pass 1) and 15 (pass 2) it needs before its first data load. No
//     sincospi in the kernel, no fast math.
//   - Loads and stores are 16-byte vectors of the block's contiguous rows
//     (two complex64, one complex128; four floats or two doubles for K15's
//     real load and K16's real store), all of a thread's loads issued
//     before the first is used: 16 elements a thread each way.
//   - Geometry: N / 16 threads a row, R rows a block (at most kLaneThreads
//     threads, 2048 elements). The launcher halves R while the grid would
//     give fewer than two blocks per SM: (256, 1024) runs 256 blocks of one
//     row (64 threads), (9 * 256^2, 256) 73728 blocks of 8 rows (128
//     threads, 17 KB of shared memory at complex64), several resident per
//     SM so that one block's loads overlap another's passes.
// A block reads all of its rows into shared memory before it writes any,
// and only its own rows: in == out is allowed.

#pragma once

#include "radix16.cuh"

namespace {

// Threads of a full lane block: 2048 elements, 16 a thread.
constexpr int kLaneThreads = 128;

// One radix-P pass over the sub-blocks of length LB of row `row` of s
// (position p at pad16(row N + p)): group g (< N / P) holds the P elements
// at (g / ES) LB + g % ES + j ES, ES = LB / P, replaced in place by their
// DFT, output k times w[k] = w_LB^{(g % ES) k} when TW. Thread l of the
// row takes the groups G l + u, u < G = 16 / P: the 16 elements of the
// last pass (ES = 1) are contiguous.
template <typename T, int N, int P, int LB, bool INV, bool TW>
__device__ __forceinline__ void lane_pass_regs(typename Complex<T>::type* s,
                                               const typename Complex<T>::type (&w)[16],
                                               int row, int l) {
  using C = typename Complex<T>::type;
  constexpr int ES = LB / P;
  constexpr int G = 16 / P;
#pragma unroll
  for (int u = 0; u < G; ++u) {
    const int g = G * l + u;
    const int base = row * N + (g / ES) * LB + g % ES;
    C v[P];
#pragma unroll
    for (int j = 0; j < P; ++j) v[j] = s[pad16(base + j * ES)];
    dft_w16<T, P, INV>(v);
    if constexpr (TW) {
#pragma unroll
      for (int k = 1; k < P; ++k) v[k] = cmul(v[k], w[k]);
    }
#pragma unroll
    for (int j = 0; j < P; ++j) s[pad16(base + j * ES)] = v[j];
  }
}

// 16-byte vectors of the lane kernels' device-memory side: complex
// (Vec<T>), or the reals of K15's load and K16's store (RealVec<T>).
template <typename T, bool REAL>
using LaneVec = std::conditional_t<REAL, RealVec<T>, Vec<T>>;

// The work of one lane_fft_kernel block: the ortho DFT of rows [blockIdx.x
// R, blockIdx.x R + R) (fewer in the last block) of (rows, N); tw: (N,)
// w_N^m. PASSES below the plan's count stops the transform after that many
// passes (scripts/torch_lane_radix_stages.cu times the stages).
template <typename T, int N, bool INV, bool IN_REAL, bool OUT_REAL, int PASSES = 3>
__device__ __forceinline__ void lane_fft_rows(const void* in, void* out,
                                              const typename Complex<T>::type* __restrict__ tw,
                                              int64_t rows, int rows_per_block, T scale) {
  using C = typename Complex<T>::type;
  using Plan = LanePlan<N>;
  constexpr int TPR = N / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  C* s = reinterpret_cast<C*>(smem);
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * rows_per_block;
  const int64_t left = rows - row0;
  const int nrows = left < rows_per_block ? static_cast<int>(left) : rows_per_block;
  const int row = threadIdx.x / TPR;
  const int l = threadIdx.x % TPR;

  // the twiddles of pass 1 (group l: w_N^{l k}) and pass 2 (group l: w_L^{(l
  // % P3) k} = w_N^{P1 (l % P3) k}); w[0] is never read
  C w1[16], w2[16];
#pragma unroll
  for (int k = 1; k < 16; ++k) w1[k] = twiddle<INV>(tw, l * k);
  if constexpr (Plan::P3 > 1) {
#pragma unroll
    for (int k = 1; k < 16; ++k) w2[k] = twiddle<INV>(tw, Plan::P1 * (l % Plan::P3) * k);
  }

  // the block's rows, contiguous in device memory, into natural positions
  {
    using LV = LaneVec<T, IN_REAL>;
    using V = typename LV::type;
    constexpr int E = LV::kElems;
    constexpr int NV = 16 / E;
    const V* src = reinterpret_cast<const V*>(in) + row0 * (N / E);
    const int count = nrows * (N / E);
    V v[NV];
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < count) v[u] = src[i];
    }
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < count) {
        C e[E];
        LV::split(v[u], e);
#pragma unroll
        for (int k = 0; k < E; ++k) s[pad16(i * E + k)] = e[k];
      }
    }
  }
  __syncthreads();
  const bool live = row < nrows;
  if constexpr (PASSES >= 1) {
    if (live) lane_pass_regs<T, N, Plan::P1, N, INV, true>(s, w1, row, l);
    __syncthreads();
  }
  if constexpr (PASSES >= 2) {
    if (live) lane_pass_regs<T, N, Plan::P2, Plan::L, INV, (Plan::P3 > 1)>(s, w2, row, l);
    __syncthreads();
  }
  if constexpr (PASSES >= 3 && Plan::P3 > 1) {
    if (live) lane_pass_regs<T, N, Plan::P3, Plan::P3, INV, false>(s, w2, row, l);
    __syncthreads();
  }

  // gathered from the digit order, scaled, 16-byte stores
  {
    using LV = LaneVec<T, OUT_REAL>;
    using V = typename LV::type;
    constexpr int E = LV::kElems;
    constexpr int NV = 16 / E;
    V* dst = reinterpret_cast<V*>(out) + row0 * (N / E);
    const int count = nrows * (N / E);
#pragma unroll
    for (int u = 0; u < NV; ++u) {
      const int i = threadIdx.x + u * blockDim.x;
      if (i < count) {
        const int r = i * E / N;
        const int f0 = i * E % N;
        C e[E];
#pragma unroll
        for (int k = 0; k < E; ++k) {
          e[k] = cscale(s[pad16(r * N + digit_position<N>(f0 + k))], scale);
        }
        dst[i] = LV::join(e);
      }
    }
  }
}

// K14-K16 (lane_fft_rows with every pass). The minimum of one block per SM
// is spelled out: without it, the same body compiled slower with a real
// load or store (scripts/torch_probe_lane_radix.py, "no minimum of blocks").
template <typename T, int N, bool INV, bool IN_REAL, bool OUT_REAL>
__global__ void __launch_bounds__(kLaneThreads, 1)
    lane_fft_kernel(const void* in, void* out, const typename Complex<T>::type* __restrict__ tw,
                    int64_t rows, int rows_per_block, T scale) {
  lane_fft_rows<T, N, INV, IN_REAL, OUT_REAL>(in, out, tw, rows, rows_per_block, scale);
}

// Rows a block: kLaneThreads / (N / 16), halved while the grid would give
// fewer than two blocks per SM (tests/test_torch_lane_radix.py models it).
template <int N>
int lane_rows_per_block(int64_t rows, int sms) {
  int r = kLaneThreads / (N / 16);
  while (r > 1 && (rows + r - 1) / r < 2 * static_cast<int64_t>(sms)) r >>= 1;
  return r;
}

template <typename T, int N, bool INV, bool IN_REAL, bool OUT_REAL>
cudaError_t launch_lane_n(const void* in, void* out, int64_t rows, const void* tw,
                          cudaStream_t stream) {
  using C = typename Complex<T>::type;
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  const int r = lane_rows_per_block<N>(rows, sms);
  const int64_t blocks = (rows + r - 1) / r;
  // at most pad16(2048) complex128: 34 KB, under the 48 KB default
  const size_t smem = static_cast<size_t>(pad16(r * N)) * sizeof(C);
  lane_fft_kernel<T, N, INV, IN_REAL, OUT_REAL>
      <<<static_cast<unsigned>(blocks), r * (N / 16), smem, stream>>>(
          in, out, static_cast<const C*>(tw), rows, r, static_cast<T>(1.0 / std::sqrt(double(N))));
  return cudaGetLastError();
}

// K14-K16 on rows of n = 2^log_n, n in {128, 256, 512, 1024}; tw: (n,) w_n^m.
template <typename T, bool INV, bool IN_REAL, bool OUT_REAL>
cudaError_t launch_lane(const void* in, void* out, int64_t rows, int log_n, const void* tw,
                        cudaStream_t stream) {
  switch (log_n) {
    case 7:
      return launch_lane_n<T, 128, INV, IN_REAL, OUT_REAL>(in, out, rows, tw, stream);
    case 8:
      return launch_lane_n<T, 256, INV, IN_REAL, OUT_REAL>(in, out, rows, tw, stream);
    case 9:
      return launch_lane_n<T, 512, INV, IN_REAL, OUT_REAL>(in, out, rows, tw, stream);
    case 10:
      return launch_lane_n<T, 1024, INV, IN_REAL, OUT_REAL>(in, out, rows, tw, stream);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace
