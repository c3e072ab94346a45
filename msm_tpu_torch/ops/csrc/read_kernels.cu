// Hopper (sm_90a) store of a small device tensor into pinned host memory,
// bound to Python through a plain C interface (msm_tpu_torch/ops/build.py
// compiles this file with nvcc and loads it with ctypes).
//
//   msm_store_to_host : dst[0:bytes] = src[0:bytes], src on the device and
//                       dst in pinned host memory, by one block's stores.
//
// It replaces no TPU kernel. The evolve loop reads a few bytes from the
// device at every chunk, loop entry and prelude dispatch
// (`stepper.host_read`). A `tolist()` copies them with a device-to-host
// cudaMemcpyAsync, which the device's copy engine serves in the order the
// copies were issued, whatever their stream. While a dump's 1.48 GB payload
// travels to the host on its side stream (`simulator._Fetch`, 34 ms on the
// H100's host link), such a read waits for the whole payload, and with it
// the loop: the dump fetch would not overlap the next interval at all, cut
// into pieces or not (PERF.md §6). A kernel's stores reach pinned
// host memory over the same link without a copy engine, through the
// device's mapping of it (cudaHostGetDevicePointer, which fails for host
// memory the device has not mapped), so the read waits only for the
// compute stream's own work.
//
// Bound: latency. A report is 1-72 bytes; one block of 64 threads stores
// 8-byte units where both pointers and the size allow it, else bytes. The
// entry point launches on the stream it is given and returns
// cudaGetLastError(); the caller synchronizes the stream before it reads
// dst.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 64;

template <typename U>
__global__ void __launch_bounds__(kThreads)
    store_to_host_kernel(const U* __restrict__ src, U* __restrict__ dst, int64_t units) {
  for (int64_t i = threadIdx.x; i < units; i += kThreads) dst[i] = src[i];
}

bool aligned(const void* p, uintptr_t to) { return (reinterpret_cast<uintptr_t>(p) % to) == 0; }

}  // namespace

extern "C" {

// src: device memory, dst: the host pointer of pinned host memory that the
// device maps (cudaHostAlloc, or cudaHostRegister under unified
// addressing), bytes >= 0, not overlapping. The kernel stores through the
// device's pointer to dst; where there is none, the error is returned and
// nothing is launched.
int msm_store_to_host(const void* src, void* dst, int64_t bytes, void* stream) {
  if (bytes <= 0) return static_cast<int>(cudaGetLastError());
  void* mapped = nullptr;
  cudaError_t err = cudaHostGetDevicePointer(&mapped, dst, 0);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned(src, 8) && aligned(mapped, 8) && bytes % 8 == 0) {
    store_to_host_kernel<uint64_t><<<1, kThreads, 0, s>>>(
        static_cast<const uint64_t*>(src), static_cast<uint64_t*>(mapped), bytes / 8);
  } else {
    store_to_host_kernel<unsigned char><<<1, kThreads, 0, s>>>(
        static_cast<const unsigned char*>(src), static_cast<unsigned char*>(mapped), bytes);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
