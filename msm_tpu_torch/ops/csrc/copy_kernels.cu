// Hopper (sm_90a) copy of two f32 planes: the device-memory floor that the
// probes measure, bound to Python through a plain C interface
// (msm_tpu_torch/ops/build.py compiles this file with nvcc and loads it
// with ctypes).
//
//   msm_copy_planes : (re, im) -> (re', im'), the identity on two f32 planes
//                     of n elements each. Replaces both TPU copy probes:
//                     scripts/microbench_mxu.py copy_pass / _copy_kernel (P1,
//                     one (1, N, N) plane per grid step) and
//                     scripts/probe_mxu_floor.py copy_pass_lane /
//                     _copy_kernel (P2, 256 rows of N per grid step).
//
// The two probes compute the same function; their block shapes exist only
// to stage planes through VMEM and mean nothing here, so one kernel serves
// both (ops/probes.py gives it the two entry points).
//
// Bound: bytes. Each element is read once and written once, 2 x 2 x 4 n
// bytes, with no arithmetic; the kernel's job is to be the floor that the
// other kernels' times are read against, so its design goes after the
// memory system and nothing else:
//   - 16-byte accesses (float4), a warp's 32 lanes on 512 contiguous bytes;
//   - both planes in one launch (the TPU kernel copies both per grid step
//     too): each thread has two independent 16-byte loads in flight before
//     its stores;
//   - a grid of one float4 per thread and plane, so the block scheduler
//     keeps every SM's 2048 threads busy to the last wave. On the H100 this
//     beat a persistent grid (132 SMs x 8 resident blocks) looping with 2,
//     4 or 8 unrolled loads per plane, and streaming (evict-first) loads
//     and stores, at the 2.4 GB and 268 MB shapes. The grid's 2^31 - 1
//     blocks of 256 float4 cover 8.8 TB per plane, so no thread loops;
//   - no shared memory: nothing is reused.
// The ragged tail (n not a multiple of 4) and pointers that are not 16-byte
// aligned (the scalar path takes the whole copy then) go through scalar
// code. Every entry point launches on the stream it is given and returns
// cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
    copy_planes_kernel(const float* __restrict__ a, const float* __restrict__ b,
                       float* __restrict__ ca, float* __restrict__ cb, int64_t n4,
                       int64_t n) {
  const int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  if (i < n4) {
    const float4 va = __ldg(reinterpret_cast<const float4*>(a) + i);
    const float4 vb = __ldg(reinterpret_cast<const float4*>(b) + i);
    reinterpret_cast<float4*>(ca)[i] = va;
    reinterpret_cast<float4*>(cb)[i] = vb;
  }
  // the scalar elements: the tail past 4 n4 (at most 3 on the vector path,
  // all n on the scalar one, where n4 = 0 and the grid covers n)
  const int64_t j = 4 * n4 + i;
  if (j < n) {
    ca[j] = __ldg(a + j);
    cb[j] = __ldg(b + j);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

}  // namespace

extern "C" {

// a, b: the input planes; ca, cb: the outputs; each n f32 elements,
// contiguous. The outputs must not overlap the inputs.
int msm_copy_planes(const void* a, const void* b, void* ca, void* cb, int64_t n,
                    void* stream) {
  if (n <= 0) return static_cast<int>(cudaGetLastError());
  const bool vec = aligned16(a) && aligned16(b) && aligned16(ca) && aligned16(cb);
  const int64_t n4 = vec ? n / 4 : 0;
  // one thread per float4 of each plane (per element on the scalar path);
  // at least one block for a vector copy of n < 4 (its tail alone)
  int64_t blocks = ((vec ? n4 : n) + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  copy_planes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<float*>(ca),
      static_cast<float*>(cb), n4, n);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
