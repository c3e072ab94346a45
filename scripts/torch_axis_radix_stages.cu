// Stage-by-stage timing of the radix form of the axis round trip K1, K3,
// K8, K13 (msm_tpu_torch/ops/csrc/axis_radix.cuh), built and run by
// scripts/torch_probe_axis_radix.py. Each variant is the production block
// body (axis_roundtrip_tile) at N = 256, complex64: K1 (with its sums)
// stopped after the load (the registers stored back), after the forward
// (its registers stored at their natural rows k, as K13 stores them), after
// the epilogue, and whole; and the whole K1, K3, K13, K8 under minimums of
// 1-3 resident blocks per SM (__launch_bounds__'s second argument: a
// register cap of 255, 128 or 85). The variants up to the epilogue move
// the same bytes in the same pattern, so their differences are the
// stages' own time.

#include "../msm_tpu_torch/ops/csrc/axis_radix.cuh"

namespace {

constexpr int kN = 256;
using Geo = AxisGeom<float, kN>;

template <int MODE, int STOP, int MIN_BLOCKS>
__global__ void __launch_bounds__(Geo::kThreads, MIN_BLOCKS)
    axis_stage_kernel(const float2* in, float2* out, int64_t lanes, int64_t tiles, float scale,
                      RoundTripArgs<float> a, const float2* __restrict__ tw) {
  axis_roundtrip_tile<float, kN, MODE, STOP>(in, out, lanes, tiles, scale, a, tw);
}

template <int MODE, int STOP, int MIN_BLOCKS>
cudaError_t launch_stage(const void* in, void* out, int64_t b1, int64_t lanes,
                         const RoundTripArgs<float>& a, const void* tw, cudaStream_t stream,
                         int* blocks_per_sm) {
  auto kernel = axis_stage_kernel<MODE, STOP, MIN_BLOCKS>;
  if (blocks_per_sm) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, Geo::kThreads,
                                                         Geo::kSmem);
  }
  const int64_t tiles = lanes / Geo::W;
  kernel<<<static_cast<unsigned>(b1 * tiles), Geo::kThreads, Geo::kSmem, stream>>>(
      static_cast<const float2*>(in), static_cast<float2*>(out), lanes, tiles,
      1.0f / std::sqrt(float(kN)), a, static_cast<const float2*>(tw));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Variants (mode, stop, min blocks per SM): 0-3 K1 stopped after the load,
// the forward, the epilogue, and whole, at a minimum of 2; 4, 5 the whole
// K1 at 1 and 3; 6, 7 the whole K3 at 2 and 3; 8, 9 K13 at 2 and 3; 10, 11
// K8 at 2 and 3. in, out: (b1, 256, lanes) complex64 (distinct); s0 (256,),
// s12 (lanes,) float32; f0 (b1, 256), f12 (b1, lanes) complex64; partials
// (b1 lanes / 16, 2) double (K1, K13); map (256, lanes) float32 (K8);
// param: K1 and K13's cutoff, K3's -coeff; tw: (256,) w_256^m.
// blocks_per_sm non-null: the variant's occupancy instead of a launch.
int axis_stage(int variant, const void* in, void* out, int64_t b1, int64_t lanes, const void* s0,
               const void* s12, const void* f0, const void* f12, const void* map, double param,
               void* partials, const void* tw, void* stream, int* blocks_per_sm) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  RoundTripArgs<float> a{};
  a.s0 = static_cast<const float*>(s0);
  a.s12 = static_cast<const float*>(s12);
  a.f0 = static_cast<const float2*>(f0);
  a.f12 = static_cast<const float2*>(f12);
  a.map = static_cast<const float*>(map);
  a.param = static_cast<float>(param);
  a.partials = static_cast<double*>(partials);
  int* b = blocks_per_sm;
  switch (variant) {
    case 0: return static_cast<int>(launch_stage<kKickReduce, kStopLoadStore, 2>(in, out, b1, lanes, a, tw, s, b));
    case 1: return static_cast<int>(launch_stage<kKickReduce, kStopForward, 2>(in, out, b1, lanes, a, tw, s, b));
    case 2: return static_cast<int>(launch_stage<kKickReduce, kStopEpilogue, 2>(in, out, b1, lanes, a, tw, s, b));
    case 3: return static_cast<int>(launch_stage<kKickReduce, kStopAll, 2>(in, out, b1, lanes, a, tw, s, b));
    case 4: return static_cast<int>(launch_stage<kKickReduce, kStopAll, 1>(in, out, b1, lanes, a, tw, s, b));
    case 5: return static_cast<int>(launch_stage<kKickReduce, kStopAll, 3>(in, out, b1, lanes, a, tw, s, b));
    case 6: return static_cast<int>(launch_stage<kPoisson, kStopAll, 2>(in, out, b1, lanes, a, tw, s, b));
    case 7: return static_cast<int>(launch_stage<kPoisson, kStopAll, 3>(in, out, b1, lanes, a, tw, s, b));
    case 8: return static_cast<int>(launch_stage<kFwdReduce, kStopAll, 2>(in, out, b1, lanes, a, tw, s, b));
    case 9: return static_cast<int>(launch_stage<kFwdReduce, kStopAll, 3>(in, out, b1, lanes, a, tw, s, b));
    case 10: return static_cast<int>(launch_stage<kMap, kStopAll, 2>(in, out, b1, lanes, a, tw, s, b));
    case 11: return static_cast<int>(launch_stage<kMap, kStopAll, 3>(in, out, b1, lanes, a, tw, s, b));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The minimum of resident blocks the shipped kernel of `mode` asks for.
int axis_stage_shipped_min_blocks(int mode) {
  switch (mode) {
    case kKickReduce: return AxisGeom<float, kN>::min_blocks(kKickReduce);
    case kPoisson: return AxisGeom<float, kN>::min_blocks(kPoisson);
    case kMap: return AxisGeom<float, kN>::min_blocks(kMap);
    case kFwdReduce: return AxisGeom<float, kN>::min_blocks(kFwdReduce);
  }
  return -1;
}

}  // extern "C"
