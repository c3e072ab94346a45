// Stage-by-stage timing of the cluster form (msm_tpu_torch/ops/csrc/
// plane_cluster.cuh), built and run by scripts/torch_probe_plane_cluster.py.
// complex64, N = 256, 8 blocks a plane.
//
// K6, K17 and K9 (plane_stage): one kernel with the production kernel's
// building blocks (plane_cluster_kernel's load through VIN, rows_to_columns'
// passes and swap, store_columns through VOUT), stopped after a given
// stage: 0 the load and the store alone, 1 with the row transform, 2 with
// the swap across the cluster, 3 the whole 2-axis transform (K6 and K17
// forward, K9 inverse). Every variant of a kernel moves the same bytes in
// the same pattern (the same load and the same column-chunk store), so the
// differences are the stages' own time; K17 loads and K9 stores reals.
//
// The inverse -> middle -> forward plane of K4, K2 and K10 (chain_stage):
// 0 the load and the store alone (2 grids), 1 with the inverse (rows, swap,
// columns: rows_to_columns), 2 with the middle step (K4: psi read, the
// kick and the block maximum; K2: psi written and rho; K10: rho), which
// adds K4's and K2's third grid, 3 with the forward (columns_to_rows): the
// whole kernel. Every variant loads and stores as the kernel does
// (load_rows_transposed, store_rows_transposed), so stage 2 - stage 1 is
// the third grid with the middle's arithmetic and stage 3 - stage 2 the
// second transform.
//
// K11 (max_stage): 0 the load alone, 1 with the inverse (rows_to_columns),
// 2 with a max epilogue over the stored column slab (max_columns,
// block_max); 3 the shipped kernel's body, the maximum taken in the
// columns' last pass (last_pass_max) where stage 1 stores. Stages 0 and 1
// write one element a block, so the differences are the inverse's and the
// epilogue's own time, and 3 against 2 the two epilogues.
//
// cluster_kernel_resources: registers, local (spill) bytes, dynamic shared
// memory and resident clusters of the shipped cluster kernels, as compiled
// into this library with the build's flags.

#include "../msm_tpu_torch/ops/csrc/plane_cluster.cuh"

namespace {

template <int STAGE, bool INV, typename VIN, typename VOUT>
__global__ void __launch_bounds__(kClusterThreads, 3)
    plane_stage_kernel(const typename VIN::elem* in, typename VOUT::elem* out,
                       const float2* twg) {
  constexpr int N = 256, CL = 8, R = N / CL;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s = reinterpret_cast<float2*>(smem);
  float2* tw = s + pad16(R * N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / CL;
  load_twiddles<float, N>(tw, twg);
  load_rows_transposed<float, N, R, VIN>(s, in + (plane * N + rank * R) * N);
  __syncthreads();
  if constexpr (STAGE >= 1) slab_fft<float, N, INV, true, RowLines<N>>(s, tw, R);
  if constexpr (STAGE >= 2) {
    cluster.sync();
    swap_tiles<float, N, CL, kSwapOnePass>(cluster, s, rank);
    cluster.sync();
  }
  if constexpr (STAGE >= 3) slab_fft<float, N, INV, false, ColLines<N, R>>(s, tw, R);
  store_columns<float, N, VOUT>(out + plane * N * N + rank * R, s, 1.0f / N);
}

enum PlaneKind { kPlaneK6, kPlaneK17, kPlaneK9 };

// plane_stage_kernel's arguments of a kind: K6 and K17 forward, K9 inverse;
// K17 real in, K9 real out.
template <int KIND>
struct StageArgs {
  static constexpr bool kInv = KIND == kPlaneK9;
  using VIN = std::conditional_t<KIND == kPlaneK17, RealVec<float>, Vec<float>>;
  using VOUT = std::conditional_t<KIND == kPlaneK9, RealVec<float>, Vec<float>>;
};
template <int KIND, int STAGE>
cudaError_t launch_stage(const void* in, void* out, const void* tw, int64_t m,
                         cudaStream_t stream) {
  using A = StageArgs<KIND>;
  return launch_cluster<plane_stage_kernel<STAGE, A::kInv, typename A::VIN, typename A::VOUT>>(
      m, 8, cluster_smem<float, 256>(), stream, static_cast<const typename A::VIN::elem*>(in),
      static_cast<typename A::VOUT::elem*>(out), static_cast<const float2*>(tw));
}

template <int KIND>
cudaError_t plane_kind(int stage, const void* in, void* out, const void* tw, int64_t m,
                       cudaStream_t s) {
  switch (stage) {
    case 0: return launch_stage<KIND, 0>(in, out, tw, m, s);
    case 1: return launch_stage<KIND, 1>(in, out, tw, m, s);
    case 2: return launch_stage<KIND, 2>(in, out, tw, m, s);
    case 3: return launch_stage<KIND, 3>(in, out, tw, m, s);
  }
  return cudaErrorInvalidValue;
}

enum ChainKind { kChainK4, kChainK2, kChainK10 };

template <int KIND, int STAGE>
__global__ void __launch_bounds__(kClusterThreads, 3)
    chain_stage_kernel(const float2* in, float2* psi, float2* out, float* maxes,
                       const float* coeff, const float2* twg) {
  constexpr int N = 256, CL = 8, R = N / CL;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s = reinterpret_cast<float2*>(smem);
  float2* tw = s + pad16(R * N);
  float* red = reinterpret_cast<float*>(tw + N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / CL;
  const float scale = 1.0f / N;
  load_twiddles<float, N>(tw, twg);
  load_rows_transposed<float, N, R>(s, in + (plane * N + rank * R) * N);
  __syncthreads();
  if constexpr (STAGE >= 1) rows_to_columns<float, N, true, kSwapTwoPass>(cluster, s, tw, rank);
  if constexpr (STAGE >= 2) {
    float2* slab = psi + plane * N * N + rank * R;
    if constexpr (KIND == kChainK4) {
      block_max(kick_columns<float, N>(s, slab, coeff[plane], scale), red, maxes + blockIdx.x);
    } else {
      density_columns<float, N, KIND == kChainK2>(s, slab, 2.0f, scale);
      __syncthreads();
    }
  }
  if constexpr (STAGE >= 3) columns_to_rows<float, N, false>(cluster, s, tw, rank);
  store_rows_transposed<float, N, R>(out + (plane * N + rank * R) * N, s, scale);
}

template <int KIND, int STAGE>
cudaError_t launch_chain(const void* in, void* psi, void* out, void* maxes, const void* coeff,
                         const void* tw, int64_t m, cudaStream_t stream) {
  return launch_cluster<chain_stage_kernel<KIND, STAGE>>(
      m, 8, cluster_smem<float, 256>(), stream, static_cast<const float2*>(in),
      static_cast<float2*>(psi), static_cast<float2*>(out), static_cast<float*>(maxes),
      static_cast<const float*>(coeff), static_cast<const float2*>(tw));
}

template <int KIND>
cudaError_t chain_kind(int stage, const void* in, void* psi, void* out, void* maxes,
                       const void* coeff, const void* tw, int64_t m, cudaStream_t s) {
  switch (stage) {
    case 0: return launch_chain<KIND, 0>(in, psi, out, maxes, coeff, tw, m, s);
    case 1: return launch_chain<KIND, 1>(in, psi, out, maxes, coeff, tw, m, s);
    case 2: return launch_chain<KIND, 2>(in, psi, out, maxes, coeff, tw, m, s);
    case 3: return launch_chain<KIND, 3>(in, psi, out, maxes, coeff, tw, m, s);
  }
  return cudaErrorInvalidValue;
}

// A max epilogue after rows_to_columns (stage 2): max |scale Re s|
// (NaN-keeping) over the block's column slab, the elements store_columns
// would store. ColLines maps (line w < R, row y < N) one to one onto the
// slab's R N positions, so the thread walks them in order (consecutive
// threads on consecutive positions, a bank each). Returns the thread's
// maximum. The shipped K11 takes the maximum in the columns' last pass
// instead (last_pass_max).
template <typename T, int N>
__device__ __forceinline__ T max_columns(const typename Complex<T>::type* s, T scale) {
  constexpr int R = N / cluster_size<T, N>();
  T mx = T(0);
#pragma unroll 4
  for (int i = threadIdx.x; i < R * N; i += kClusterThreads) {
    const T re = s[pad16(i)].x * scale;
    mx = nan_max(mx, re < T(0) ? -re : re);
  }
  return mx;
}

template <int STAGE>
__global__ void __launch_bounds__(kClusterThreads, 3)
    max_stage_kernel(const float2* in, float* maxes, const float2* twg) {
  constexpr int N = 256, CL = 8, R = N / CL;
  extern __shared__ __align__(16) unsigned char smem[];
  float2* s = reinterpret_cast<float2*>(smem);
  float2* tw = s + pad16(R * N);
  float* red = reinterpret_cast<float*>(tw + N);
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int64_t plane = blockIdx.x / CL;
  load_twiddles<float, N>(tw, twg);
  load_rows_transposed<float, N, R>(s, in + (plane * N + rank * R) * N);
  __syncthreads();
  if constexpr (STAGE == 3) {
    slab_fft<float, N, true, true, RowLines<N>>(s, tw, R);
    cluster.sync();
    swap_tiles<float, N, CL, kSwapOnePass>(cluster, s, rank);
    cluster.sync();
    radix_pass<float, N, 16, true, true, ColLines<N, R>>(s, tw, R, N / 16, 1, N / 16);
    block_max(last_pass_max<float, N>(s, tw, 1.0f / N), red, maxes + blockIdx.x);
    return;
  }
  if constexpr (STAGE >= 1) rows_to_columns<float, N, true, kSwapOnePass>(cluster, s, tw, rank);
  if constexpr (STAGE >= 2) {
    block_max(max_columns<float, N>(s, 1.0f / N), red, maxes + blockIdx.x);
  } else if (threadIdx.x == 0) {
    maxes[blockIdx.x] = s[0].x;
  }
}

template <int STAGE>
cudaError_t launch_max(const void* in, void* maxes, const void* tw, int64_t m,
                       cudaStream_t stream) {
  return launch_cluster<max_stage_kernel<STAGE>>(m, 8, cluster_smem<float, 256>(), stream,
                                                 static_cast<const float2*>(in),
                                                 static_cast<float*>(maxes),
                                                 static_cast<const float2*>(tw));
}

// fields: registers, local bytes a thread, dynamic shared bytes a block,
// clusters resident at once, blocks a cluster
template <auto KERNEL, typename T, int N>
cudaError_t resources(int* fields) {
  constexpr int CL = cluster_size<T, N>();
  const size_t smem = cluster_smem<T, N>();
  cudaError_t err = prepare_cluster<KERNEL>(CL, smem);
  if (err != cudaSuccess) return err;
  cudaFuncAttributes a;
  err = cudaFuncGetAttributes(&a, KERNEL);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr;
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = CL;
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(CL);
  cfg.blockDim = dim3(kClusterThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  int clusters = 0;
  err = cudaOccupancyMaxActiveClusters(&clusters, KERNEL, &cfg);
  fields[0] = a.numRegs;
  fields[1] = static_cast<int>(a.localSizeBytes);
  fields[2] = static_cast<int>(smem);
  fields[3] = clusters;
  fields[4] = CL;
  return err;
}

template <int KIND, int STAGE>
cudaError_t stage_resources(int* fields) {
  using A = StageArgs<KIND>;
  return resources<plane_stage_kernel<STAGE, A::kInv, typename A::VIN, typename A::VOUT>, float,
                   256>(fields);
}

template <typename T>
cudaError_t kernel_resources(int which, int log_n, int* fields) {
  return by_plane_size<T>(log_n, log_n == 8 ? 8 : cluster_size<T, 128>(), [=](auto n) {
    constexpr int N = decltype(n)::value;
    switch (which) {
      case 0: return resources<plane_cluster_kernel<T, N, false, Vec<T>, Vec<T>>, T, N>(fields);
      case 1: return resources<plane_potkick_cluster_kernel<T, N>, T, N>(fields);
      case 2: return resources<plane_inv_density_cluster_kernel<T, N, true>, T, N>(fields);
      case 3: return resources<plane_inv_density_cluster_kernel<T, N, false>, T, N>(fields);
      case 4:
        return resources<plane_cluster_kernel<T, N, false, RealVec<T>, Vec<T>>, T, N>(fields);
      case 5:
        return resources<plane_cluster_kernel<T, N, true, Vec<T>, RealVec<T>>, T, N>(fields);
      case 6: return resources<plane_real_inv_max_cluster_kernel<T, N>, T, N>(fields);
    }
    return cudaErrorInvalidValue;
  });
}

}  // namespace

extern "C" {

// kind 0 K4, 1 K2, 2 K10; stage 0..3. in, out: (m, 256, 256) complex64;
// psi: read (K4) or written (K2), unused by K10; maxes: (m * 8,) float (K4);
// coeff: (m,) float, one per plane (K4); tw: (256,) w_256^k.
int chain_stage(int kind, int stage, const void* in, void* psi, void* out, void* maxes,
                const void* coeff, const void* tw, int64_t m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaErrorInvalidValue;
  switch (kind) {
    case kChainK4: err = chain_kind<kChainK4>(stage, in, psi, out, maxes, coeff, tw, m, s); break;
    case kChainK2: err = chain_kind<kChainK2>(stage, in, psi, out, maxes, coeff, tw, m, s); break;
    case kChainK10: err = chain_kind<kChainK10>(stage, in, psi, out, maxes, coeff, tw, m, s); break;
  }
  return static_cast<int>(err);
}

// The same fields of chain_stage's variant (kind, stage).
int chain_stage_resources(int kind, int stage, int* fields) {
  cudaError_t err = cudaErrorInvalidValue;
  auto of = [&](auto kernel_kind) {
    constexpr int K = decltype(kernel_kind)::value;
    switch (stage) {
      case 0: return resources<chain_stage_kernel<K, 0>, float, 256>(fields);
      case 1: return resources<chain_stage_kernel<K, 1>, float, 256>(fields);
      case 2: return resources<chain_stage_kernel<K, 2>, float, 256>(fields);
      case 3: return resources<chain_stage_kernel<K, 3>, float, 256>(fields);
    }
    return cudaErrorInvalidValue;
  };
  switch (kind) {
    case kChainK4: err = of(std::integral_constant<int, kChainK4>{}); break;
    case kChainK2: err = of(std::integral_constant<int, kChainK2>{}); break;
    case kChainK10: err = of(std::integral_constant<int, kChainK10>{}); break;
  }
  return static_cast<int>(err);
}

// K11 stage 0..3 (max_stage). in: (m, 256, 256) complex64; maxes: (m * 8,)
// float; tw: (256,) w_256^k.
int max_stage(int stage, const void* in, void* maxes, const void* tw, int64_t m, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (stage) {
    case 0: return static_cast<int>(launch_max<0>(in, maxes, tw, m, s));
    case 1: return static_cast<int>(launch_max<1>(in, maxes, tw, m, s));
    case 2: return static_cast<int>(launch_max<2>(in, maxes, tw, m, s));
    case 3: return static_cast<int>(launch_max<3>(in, maxes, tw, m, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The resources fields of max_stage's variant.
int max_stage_resources(int stage, int* fields) {
  switch (stage) {
    case 0: return static_cast<int>(resources<max_stage_kernel<0>, float, 256>(fields));
    case 1: return static_cast<int>(resources<max_stage_kernel<1>, float, 256>(fields));
    case 2: return static_cast<int>(resources<max_stage_kernel<2>, float, 256>(fields));
    case 3: return static_cast<int>(resources<max_stage_kernel<3>, float, 256>(fields));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// which: 0 K6 (forward), 1 K4, 2 K2, 3 K10, 4 K17, 5 K9, 6 K11; log_n 7 or 8;
// fields: 5 ints (see resources).
int cluster_kernel_resources(int which, int is_double, int log_n, int* fields) {
  return static_cast<int>(is_double ? kernel_resources<double>(which, log_n, fields)
                                    : kernel_resources<float>(which, log_n, fields));
}

// kind 0 K6, 1 K17, 2 K9; stage 0..3. in, out: (m, 256, 256) complex64,
// but float32 for K17's in and K9's out; tw: (256,) w_256^k.
int plane_stage(int kind, int stage, const void* in, void* out, const void* tw, int64_t m,
                void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (kind) {
    case kPlaneK6: return static_cast<int>(plane_kind<kPlaneK6>(stage, in, out, tw, m, s));
    case kPlaneK17: return static_cast<int>(plane_kind<kPlaneK17>(stage, in, out, tw, m, s));
    case kPlaneK9: return static_cast<int>(plane_kind<kPlaneK9>(stage, in, out, tw, m, s));
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// The resources fields of plane_stage's variant (kind, stage).
int plane_stage_resources(int kind, int stage, int* fields) {
  auto of = [&](auto kernel_kind) {
    constexpr int K = decltype(kernel_kind)::value;
    switch (stage) {
      case 0: return stage_resources<K, 0>(fields);
      case 1: return stage_resources<K, 1>(fields);
      case 2: return stage_resources<K, 2>(fields);
      case 3: return stage_resources<K, 3>(fields);
    }
    return cudaErrorInvalidValue;
  };
  cudaError_t err = cudaErrorInvalidValue;
  switch (kind) {
    case kPlaneK6: err = of(std::integral_constant<int, kPlaneK6>{}); break;
    case kPlaneK17: err = of(std::integral_constant<int, kPlaneK17>{}); break;
    case kPlaneK9: err = of(std::integral_constant<int, kPlaneK9>{}); break;
  }
  return static_cast<int>(err);
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
  using A = StageArgs<kPlaneK6>;
  cudaError_t err = prepare_cluster<plane_stage_kernel<3, A::kInv, A::VIN, A::VOUT>>(
      8, cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, plane_stage_kernel<3, A::kInv, A::VIN, A::VOUT>, &cfg));
}

}  // extern "C"
