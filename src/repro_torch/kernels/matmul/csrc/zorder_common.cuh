// Helpers shared by K1's routes (zorder_matmul*.cu): type codes, the one
// rounding to the output type, and the asynchronous-copy primitives.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"

namespace zorder {

using hopper::smem_addr;

using bf16 = __nv_bfloat16;

// Type codes of the C entry points (kernel.py's _DTYPE_CODE).
enum DType { kF32 = 0, kBF16 = 1 };

template <typename T> __device__ __forceinline__ T from_float(float x);
template <> __device__ __forceinline__ float from_float<float>(float x) { return x; }
template <> __device__ __forceinline__ bf16 from_float<bf16>(float x) {
  return __float2bfloat16_rn(x);
}

// Two neighbouring output columns, rounded once and stored together (the
// column is even and the row length even, so the pair is aligned).
__device__ __forceinline__ void store_pair(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store_pair(bf16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 16-byte cp.async; src_bytes = 0 fills the destination with zeros.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_addr(smem)),
               "l"(gmem), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Kernels above 48 KB of shared memory must opt in, once per kernel and
// device (a race between host threads only repeats the same call).
template <typename Kern>
cudaError_t opt_in_smem(Kern kern, size_t smem, bool (&done)[64]) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return e;
  if (smem > 48 * 1024 && (dev >= 64 || !done[dev])) {
    e = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
    if (dev < 64) done[dev] = true;
  }
  return cudaSuccess;
}

}  // namespace zorder
