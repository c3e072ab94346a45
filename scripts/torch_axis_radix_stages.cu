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
//
// The column pass (axis_pass_tile: K12, K5, K18) the same way
// (column_stage): K12's body with the load and the store alone, + the kick
// on load, whole; the whole K12, K5 (forward) and K18 under minimums of
// 1-3 resident blocks per SM.

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

template <bool INV, AxisPrologue PRO, int STOP, int MIN_BLOCKS>
__global__ void __launch_bounds__(Geo::kThreads, MIN_BLOCKS)
    column_stage_kernel(const float2* in, float2* out, int64_t lanes, int64_t tiles, float scale,
                        AxisLoad<float> pro, const float2* __restrict__ tw) {
  axis_pass_tile<float, kN, INV, PRO, STOP>(in, out, lanes, tiles, scale, pro, tw);
}

template <bool INV, AxisPrologue PRO, int STOP, int MIN_BLOCKS>
cudaError_t launch_column(const void* in, void* out, int64_t b1, int64_t lanes,
                          const AxisLoad<float>& pro, const void* tw, cudaStream_t stream,
                          int* blocks_per_sm) {
  auto kernel = column_stage_kernel<INV, PRO, STOP, MIN_BLOCKS>;
  if (blocks_per_sm) {
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(blocks_per_sm, kernel, Geo::kThreads,
                                                         Geo::kTileSmem);
  }
  const int64_t tiles = lanes / Geo::W;
  kernel<<<static_cast<unsigned>(b1 * tiles), Geo::kThreads, Geo::kTileSmem, stream>>>(
      static_cast<const float2*>(in), static_cast<float2*>(out), lanes, tiles,
      1.0f / std::sqrt(float(kN)), pro, static_cast<const float2*>(tw));
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Column-pass variants (inverse, prologue, stop, min blocks per SM): 0, 1
// K12's load and store alone without and with the kick, 2-4 the whole K12
// at 1, 2, 3; 5, 6 the whole K5 forward at 2, 3; 7, 8 the whole K18 at 2,
// 3. in, out: (b1, 256, lanes) complex64 (distinct); f0 (b1, 256), f12
// (b1, lanes) complex64; map (256, lanes) float32; tw: (256,) w_256^m.
// blocks_per_sm non-null: the variant's occupancy instead of a launch.
int column_stage(int variant, const void* in, void* out, int64_t b1, int64_t lanes,
                 const void* f0, const void* f12, const void* map, const void* tw, void* stream,
                 int* blocks_per_sm) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const AxisLoad<float> p{static_cast<const float2*>(f0), static_cast<const float2*>(f12),
                          static_cast<const float*>(map)};
  int* b = blocks_per_sm;
  constexpr auto kNone = AxisPrologue::kNone;
  constexpr auto kKick = AxisPrologue::kKick;
  constexpr auto kMapP = AxisPrologue::kMap;
  switch (variant) {
    case 0: return static_cast<int>(launch_column<true, kNone, kStopLoadStore, 3>(in, out, b1, lanes, p, tw, s, b));
    case 1: return static_cast<int>(launch_column<true, kKick, kStopLoadStore, 3>(in, out, b1, lanes, p, tw, s, b));
    case 2: return static_cast<int>(launch_column<true, kKick, kStopAll, 1>(in, out, b1, lanes, p, tw, s, b));
    case 3: return static_cast<int>(launch_column<true, kKick, kStopAll, 2>(in, out, b1, lanes, p, tw, s, b));
    case 4: return static_cast<int>(launch_column<true, kKick, kStopAll, 3>(in, out, b1, lanes, p, tw, s, b));
    case 5: return static_cast<int>(launch_column<false, kNone, kStopAll, 2>(in, out, b1, lanes, p, tw, s, b));
    case 6: return static_cast<int>(launch_column<false, kNone, kStopAll, 3>(in, out, b1, lanes, p, tw, s, b));
    case 7: return static_cast<int>(launch_column<true, kMapP, kStopAll, 2>(in, out, b1, lanes, p, tw, s, b));
    case 8: return static_cast<int>(launch_column<true, kMapP, kStopAll, 3>(in, out, b1, lanes, p, tw, s, b));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The minimum of resident blocks the shipped column pass asks for.
int column_stage_shipped_min_blocks() { return AxisGeom<float, kN>::min_blocks(kFwdReduce); }

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
