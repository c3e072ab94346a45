// Stage-by-stage timing of the cluster form of K6 (msm_tpu_torch/ops/csrc/
// plane_cluster.cuh), built and run by scripts/torch_probe_plane_cluster.py.
// One kernel with the production kernel's building blocks, stopped after a
// given stage: 0 the load and the store alone, 1 with the row transform,
// 2 with the swap across the cluster, 3 the whole 2-axis forward. Every
// variant moves the same bytes in the same pattern (the same load and the
// same column-chunk store), so the differences are the stages' own time.
// complex64, N = 256, 8 blocks a plane.

#include "../msm_tpu_torch/ops/csrc/plane_cluster.cuh"

namespace {

template <int STAGE>
__global__ void __launch_bounds__(kClusterThreads, 3)
    plane_stage_kernel(const float2* in, float2* out, const float2* twg) {
  constexpr int N = 256, CL = 8, R = N / CL;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s = reinterpret_cast<float2*>(smem);
  float2* tw = s + pad16(R * N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / CL;
  load_twiddles<float, N>(tw, twg);
  load_rows_transposed<float, N, R>(s, in + (plane * N + rank * R) * N);
  __syncthreads();
  if constexpr (STAGE >= 1) slab_fft<float, N, false, true, RowLines<N>>(s, tw, R);
  if constexpr (STAGE >= 2) {
    cluster.sync();
    swap_tiles<float, N, CL>(cluster, s, rank);
    cluster.sync();
  }
  if constexpr (STAGE >= 3) slab_fft<float, N, false, false, ColLines<N, R>>(s, tw, R);
  float4* dst = reinterpret_cast<float4*>(out + plane * N * N + rank * R);
  for (int i = threadIdx.x; i < R * N / 2; i += kClusterThreads) {
    const int f = i * 2 / R;
    const int w = i * 2 % R;
    const float2 a = cscale(s[ColLines<N, R>::at(w, transposed<N>(f))], 1.0f / N);
    const float2 b = cscale(s[ColLines<N, R>::at(w + 1, transposed<N>(f))], 1.0f / N);
    dst[(f * N + w) / 2] = make_float4(a.x, a.y, b.x, b.y);
  }
}

template <int STAGE>
cudaError_t launch_stage(const void* in, void* out, const void* tw, int64_t m,
                         cudaStream_t stream) {
  return launch_cluster<plane_stage_kernel<STAGE>>(
      m, 8, cluster_smem<float, 256>(), stream, static_cast<const float2*>(in),
      static_cast<float2*>(out), static_cast<const float2*>(tw));
}

}  // namespace

extern "C" {

// in, out: (m, 256, 256) complex64; tw: (256,) w_256^k; stage 0..3.
int plane_stage(int stage, const void* in, void* out, const void* tw, int64_t m,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return static_cast<int>(launch_stage<0>(in, out, tw, m, s));
    case 1: return static_cast<int>(launch_stage<1>(in, out, tw, m, s));
    case 2: return static_cast<int>(launch_stage<2>(in, out, tw, m, s));
    case 3: return static_cast<int>(launch_stage<3>(in, out, tw, m, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// Clusters of 8 blocks of the full variant that fit the card at once.
int plane_stage_clusters(int* clusters) {
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = 8;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(8);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = cluster_smem<float, 256>();
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  cudaError_t err = prepare_cluster<plane_stage_kernel<3>>(8, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, plane_stage_kernel<3>, &cfg));
}

}  // extern "C"
