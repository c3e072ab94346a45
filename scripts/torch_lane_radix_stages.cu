// Stage-by-stage timing of the radix form of the lane kernels K14-K16
// (msm_tpu_torch/ops/csrc/lane_radix.cuh), built and run by
// scripts/torch_probe_lane_radix.py. Each variant is the production block
// body (lane_fft_rows), complex64 forward, stopped after a given number of
// passes (0: the load and the store alone), with a real load (K15's) or a
// real store (K16's), or under a higher minimum of resident blocks per SM
// (__launch_bounds__'s second argument: fewer registers a thread); besides
// them the shipped kernels built into this library, and the real-load body
// under lane_fft_kernel's other spellings (__restrict__ twiddles, no
// minimum of blocks). Every variant with the same load and store moves the
// same bytes in the same pattern, so the differences are the passes' own
// time.

#include "../msm_tpu_torch/ops/csrc/lane_radix.cuh"

namespace {

template <int N, int PASSES, bool IN_REAL, bool OUT_REAL, int MIN_BLOCKS>
__global__ void __launch_bounds__(kLaneThreads, MIN_BLOCKS)
    lane_stage_kernel(const void* in, void* out, const float2* tw, int64_t rows,
                      int rows_per_block, float scale) {
  lane_fft_rows<float, N, false, IN_REAL, OUT_REAL, PASSES>(in, out, tw, rows, rows_per_block,
                                                           scale);
}

// The real-load variant with lane_fft_kernel's parameter and bound
// spellings, one at a time: __restrict__ on tw; no minimum of blocks.
__global__ void __launch_bounds__(kLaneThreads, 1)
    lane_restrict_kernel(const void* in, void* out, const float2* __restrict__ tw, int64_t rows,
                         int rows_per_block, float scale) {
  lane_fft_rows<float, 256, false, true, false, 2>(in, out, tw, rows, rows_per_block, scale);
}
__global__ void __launch_bounds__(kLaneThreads)
    lane_nomin_kernel(const void* in, void* out, const float2* tw, int64_t rows,
                      int rows_per_block, float scale) {
  lane_fft_rows<float, 256, false, true, false, 2>(in, out, tw, rows, rows_per_block, scale);
}

template <auto KERNEL>
cudaError_t launch_real_load(const void* in, void* out, const void* tw, int64_t rows, int sms,
                             cudaStream_t stream) {
  constexpr int N = 256;
  const int r = lane_rows_per_block<N>(rows, sms);
  const size_t smem = static_cast<size_t>(pad16(r * N)) * sizeof(float2);
  KERNEL<<<static_cast<unsigned>((rows + r - 1) / r), r * (N / 16), smem, stream>>>(
      in, out, static_cast<const float2*>(tw), rows, r, 1.0f / std::sqrt(float(N)));
  return cudaGetLastError();
}

template <int N, int PASSES, bool IN_REAL, bool OUT_REAL, int MIN_BLOCKS>
cudaError_t launch_stage(const void* in, void* out, const void* tw, int64_t rows, int sms,
                         cudaStream_t stream, int* blocks_per_sm) {
  const int r = lane_rows_per_block<N>(rows, sms);
  const int threads = r * (N / 16);
  const size_t smem = static_cast<size_t>(pad16(r * N)) * sizeof(float2);
  if (blocks_per_sm) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        blocks_per_sm, lane_stage_kernel<N, PASSES, IN_REAL, OUT_REAL, MIN_BLOCKS>, threads, smem);
  }
  lane_stage_kernel<N, PASSES, IN_REAL, OUT_REAL, MIN_BLOCKS>
      <<<static_cast<unsigned>((rows + r - 1) / r), threads, smem, stream>>>(
      in, out, static_cast<const float2*>(tw), rows, r, 1.0f / std::sqrt(float(N)));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Variants (N, passes, real load, real store, min blocks per SM): 0-2 N =
// 256 with 0, 1, 2 passes; 3, 4 real load with 0, 2; 5, 6 real store with
// 0, 2; 7, 8 complex, all passes, min 6 and 8 blocks; 9, 10 the real load
// and store, all passes, min 8; 11-14 N = 1024 with 0-3 passes; 15-17 the
// shipped K14, K15, K16 at N = 256; 18, 19 the real load with __restrict__
// twiddles and with no minimum of blocks (15-19: no occupancy query).
// in: (rows, N) complex64 (float32 for a real load); out: the same
// (float32 for a real store); tw: (N,) w_N^m. blocks_per_sm non-null: the
// occupancy of the variant's launch at this row count instead of a launch.
int lane_stage(int variant, const void* in, void* out, const void* tw, int64_t rows, int sms,
               void* stream, int* blocks_per_sm) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  int* b = blocks_per_sm;
  switch (variant) {
    case 0: return static_cast<int>(launch_stage<256, 0, false, false, 1>(in, out, tw, rows, sms, s, b));
    case 1: return static_cast<int>(launch_stage<256, 1, false, false, 1>(in, out, tw, rows, sms, s, b));
    case 2: return static_cast<int>(launch_stage<256, 2, false, false, 1>(in, out, tw, rows, sms, s, b));
    case 3: return static_cast<int>(launch_stage<256, 0, true, false, 1>(in, out, tw, rows, sms, s, b));
    case 4: return static_cast<int>(launch_stage<256, 2, true, false, 1>(in, out, tw, rows, sms, s, b));
    case 5: return static_cast<int>(launch_stage<256, 0, false, true, 1>(in, out, tw, rows, sms, s, b));
    case 6: return static_cast<int>(launch_stage<256, 2, false, true, 1>(in, out, tw, rows, sms, s, b));
    case 7: return static_cast<int>(launch_stage<256, 2, false, false, 6>(in, out, tw, rows, sms, s, b));
    case 8: return static_cast<int>(launch_stage<256, 2, false, false, 8>(in, out, tw, rows, sms, s, b));
    case 9: return static_cast<int>(launch_stage<256, 2, true, false, 8>(in, out, tw, rows, sms, s, b));
    case 10: return static_cast<int>(launch_stage<256, 2, false, true, 8>(in, out, tw, rows, sms, s, b));
    case 11: return static_cast<int>(launch_stage<1024, 0, false, false, 1>(in, out, tw, rows, sms, s, b));
    case 12: return static_cast<int>(launch_stage<1024, 1, false, false, 1>(in, out, tw, rows, sms, s, b));
    case 13: return static_cast<int>(launch_stage<1024, 2, false, false, 1>(in, out, tw, rows, sms, s, b));
    case 14: return static_cast<int>(launch_stage<1024, 3, false, false, 1>(in, out, tw, rows, sms, s, b));
  }
  // 15-17: the shipped kernels K14 (forward), K15, K16 as lane_radix.cuh
  // launches them, built into this library
  if (b) return static_cast<int>(cudaErrorInvalidValue);
  switch (variant) {
    case 15: return static_cast<int>(launch_lane<float, false, false, false>(in, out, rows, 8, tw, s));
    case 16: return static_cast<int>(launch_lane<float, false, true, false>(in, out, rows, 8, tw, s));
    case 17: return static_cast<int>(launch_lane<float, true, false, true>(in, out, rows, 8, tw, s));
    case 18: return static_cast<int>(launch_real_load<lane_restrict_kernel>(in, out, tw, rows, sms, s));
    case 19: return static_cast<int>(launch_real_load<lane_nomin_kernel>(in, out, tw, rows, sms, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // extern "C"
