// Hopper (sm_90a) per-stream masked restore of a batched grid, bound to
// Python through a plain C interface (msm_tpu_torch/ops/build.py compiles
// this file with nvcc and loads it with ctypes).
//
//   msm_masked_restore : new[b] = old[b] for every stream b whose mask[b] is
//                        0, in place on new; streams whose mask is 1 keep
//                        new[b] untouched.
//
// It replaces no TPU kernel. JAX's evolve loop freezes the streams that do
// not advance with `lax.cond(all(mask), new, select(mask, new, old))`
// (msm_tpu/stepper.py:1122-1131, :1292): in the steady state every stream
// advances and the cond skips the select. A captured CUDA graph cannot
// branch, so the port's device-side loop calls this kernel on every
// iteration instead, with the mask on the device. Each block reads its
// stream's flag first and returns at once when the stream advances, so the
// steady state costs one launch of blocks that exit, and no grid traffic; a
// frozen stream costs one read of old and one write of new. An
// unconditional torch.where would read both grids and write one every
// iteration: 24 bytes a complex64 cell against the fused iteration's 80.
//
// Bound: bytes, 2 x the frozen streams' grid bytes (each read once from old
// and written once to new), plus the mask. Design after copy_kernels.cu's
// lesson (16-byte accesses, a warp on contiguous 512 bytes), with a fixed
// number of blocks per stream (about 16 per SM over the batch) that loop
// over the stream's grid four 16-byte units at a time, so the steady state
// launches a few thousand blocks at most and a frozen stream still has
// enough loads in flight. Pointers and stream sizes that are not 16-byte
// aligned take 8-byte units (a complex64 cell). The entry point launches on
// the stream it is given and returns cudaGetLastError().

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
// blocks over the whole batch: about 16 a streaming multiprocessor
constexpr int64_t kMaxBlocks = 132 * 16;

template <typename U>
__global__ void __launch_bounds__(kThreads)
    masked_restore_kernel(U* __restrict__ dst, const U* __restrict__ src,
                          const unsigned char* __restrict__ mask, int64_t units) {
  const int64_t b = blockIdx.y;
  if (mask[b]) return;
  dst += b * units;
  src += b * units;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
  for (; i + (kUnroll - 1) * stride < units; i += kUnroll * stride) {
    U v[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) v[u] = src[i + u * stride];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) dst[i + u * stride] = v[u];
  }
  for (; i < units; i += stride) dst[i] = src[i];
}

bool aligned(const void* p, uintptr_t to) { return (reinterpret_cast<uintptr_t>(p) % to) == 0; }

template <typename U>
void launch(void* dst, const void* src, const void* mask, int64_t batch, int64_t bytes,
            cudaStream_t stream) {
  const int64_t units = bytes / static_cast<int64_t>(sizeof(U));
  int64_t per_stream = (units + kThreads * kUnroll - 1) / (kThreads * kUnroll);
  const int64_t cap = kMaxBlocks / batch > 0 ? kMaxBlocks / batch : 1;
  if (per_stream > cap) per_stream = cap;
  if (per_stream < 1) per_stream = 1;
  const dim3 grid(static_cast<unsigned>(per_stream), static_cast<unsigned>(batch));
  masked_restore_kernel<U><<<grid, kThreads, 0, stream>>>(
      static_cast<U*>(dst), static_cast<const U*>(src),
      static_cast<const unsigned char*>(mask), units);
}

}  // namespace

extern "C" {

// dst (new), src (old): (batch, bytes / 8 ...) contiguous, 8-byte aligned,
// not overlapping; mask: (batch,) bool (one byte each). bytes: one stream's
// grid in bytes, a multiple of 8.
int msm_masked_restore(void* dst, const void* src, const void* mask, int64_t batch,
                       int64_t bytes, void* stream) {
  if (batch <= 0 || bytes <= 0) return static_cast<int>(cudaGetLastError());
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned(dst, 16) && aligned(src, 16) && bytes % 16 == 0) {
    launch<uint4>(dst, src, mask, batch, bytes, s);
  } else {
    launch<uint2>(dst, src, mask, batch, bytes, s);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
