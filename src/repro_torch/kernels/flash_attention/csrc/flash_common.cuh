// What K2's routes share (flash_attention.cu: mma and fma;
// flash_attention_wgmma.cu: wgmma): the launch parameters, the CTA's tile,
// the key range and masks of a query tile, and the bf16 packing of P.
#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace flash {

using bf16 = __nv_bfloat16;

enum DType { kF32 = 0, kBF16 = 1 };

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Hq, Hkv, Sq, Skv, D;
  long long q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh;
  int causal, window;
  float scale;
  int nq;  // query tiles per (batch, head)
};

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (lo) in the low half
  return *reinterpret_cast<uint32_t*>(&v);
}

// The CTA's (batch, head, first query row): heads fastest, then batches,
// then query tiles from the last to the first.
struct Tile {
  int b, h, q0;
};
__device__ __forceinline__ Tile tile_of(const Params& p, int bm) {
  int x = blockIdx.x;
  const int h = x % p.Hq;
  x /= p.Hq;
  const int b = x % p.B;
  x /= p.B;
  return {b, h, (p.nq - 1 - x) * bm};
}

// Keys [lo, hi) that some query row in [q0, q_last] may attend to.
__device__ __forceinline__ void kv_range(const Params& p, int q0, int q_last, int& lo, int& hi) {
  hi = p.Skv;
  if (p.causal) hi = min(hi, q_last + 1);
  lo = 0;
  if (p.window > 0) lo = max(0, q0 - p.window + 1);
}

__device__ __forceinline__ bool key_valid(const Params& p, int i, int j) {
  return j < p.Skv && (!p.causal || j <= i) && (p.window <= 0 || j > i - p.window);
}

// Does the tile of keys [j0, j0 + bn) need a mask for rows [q0, q_last]?
__device__ __forceinline__ bool tile_needs_mask(const Params& p, int q0, int q_last, int j0,
                                                int bn) {
  return j0 + bn > p.Skv || (p.causal && j0 + bn - 1 > q0) ||
         (p.window > 0 && j0 <= q_last - p.window);
}

// Above 48 KB of shared memory a kernel must opt in, once per device.
template <typename K>
cudaError_t opt_in(K kern, size_t smem, bool (&done)[64]) {
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

}  // namespace flash
