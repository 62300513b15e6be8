// Flash attention for Hopper (sm_90a): online-softmax attention with causal
// and sliding-window masks and grouped-query heads.  K2's mma route (bf16
// head dims below 64, or any bf16 call forced onto it) and fma route (fp32);
// bf16 head dims 64-128 take the wgmma route in flash_attention_wgmma.cu.
// The CTA tile, key range and masks are shared with it (flash_common.cuh).
//
// Replaces src/repro/kernels/flash_attention/kernel.py::flash_attention (the
// Pallas TPU kernel, body _flash_kernel).  Same function: for each query
// head h and query i, softmax over the keys j of KV head h / (Hq / Hkv) with
// j < S_kv, j <= i when causal, j > i - window when window > 0 (query i and
// key j both counted from position 0), times V; fp32 running max,
// normaliser and accumulator; a row with no valid key outputs 0.  What
// changes with the machine:
//
// * The grid.  On the TPU the kv axis was the last, sequential grid axis,
//   with the running statistics carried across grid steps in VMEM scratch
//   and fully masked blocks skipped by pl.when.  Here one CTA owns one
//   (batch, head, query tile) and loops over the KV tiles itself, from the
//   first tile the window lets in to the last one the causal mask lets in;
//   tiles outside that range are never visited.  CTAs are numbered with
//   the head fastest and the last query tiles first, so the longest causal
//   rows start first and concurrent CTAs share a KV window in L2.
// * Memory.  K and V tiles stream through shared memory with cp.async,
//   double-buffered: the copy of tile t+1 is in flight while tile t is
//   multiplied.  The statistics and the output accumulator stay in fp32
//   registers; nothing of size S_q x S_kv is ever written.
// * Layout.  Every tensor is addressed as (batch, seq, head, dim) with
//   strides, the last dim contiguous, so the model's (B, S, H, D) tensors
//   and the reference's (BH, S, D) layout are both read in place, without
//   transposing copies.  GQA reads KV head h / group; nothing is repeated.
// * Head dims up to 128.  The dim is padded in shared memory to 32, 64 or
//   128 with zeros (cp.async's zero fill), so D = 120 reads zeros in the
//   last 16-wide slice of the QK^T product.  Ragged S_q and S_kv are masked
//   here (keys j >= S_kv are invalid; rows i >= S_q are not stored): nothing
//   is padded in device memory.
//
// bf16: mma.sync m16n8k16 with fp32 accumulators, fragments loaded with
// ldmatrix; each of 4 warps owns 16 query rows of a 64-row tile, against
// 64-key tiles.  The scores are scaled in fp32 after the product (scaling
// bf16 q first, as the reference does in fp32, would add a rounding), and
// the softmax runs in base 2 with scale * log2(e) folded in.  P is rounded
// to bf16 for the PV product (the row sums stay fp32): that rounding, half
// a bf16 ulp of each probability, is why a bf16 output row is held to a
// relative error of 1e-2 against the plain version, not to fp32's 1e-4.
//
// fp32: plain FMA, never TF32 (TF32 keeps ~3 decimal digits, which cannot
// meet a 1e-4 relative tolerance).  q is scaled in fp32 before the product,
// as in the reference; 4-byte cp.async copies fill rows padded to an odd
// stride, so the per-thread key columns read without bank conflicts.
//
// Bound.  At the long-prefill shapes (S = 32768, 32 query heads, D = 120
// with a 4096 window; D = 64 causal) attention is bound by operations:
// 4 * D flops per unmasked (query, key) pair, 1.9 TFLOP and 4.4 TFLOP, i.e.
// 2.0 ms and 4.5 ms at 989 TFLOP/s, against 0.2 ms to move Q, K, V and O
// once.  One exp per unmasked pair is of the same order: the special
// function units do 16 exp per clock per SM, about 4e12/s on the card, so
// the D = 64 shape needs about 4 ms of exps alone.  What the design does:
// tensor-core products for both GEMMs, tiles outside the masks skipped,
// tiles wholly inside them unmasked, P kept in registers between the two
// products.  What it does not do: wgmma (mma.sync reaches well under the
// wgmma peak), TMA, and warp specialisation to overlap the exps of one
// tile with the products of the next; the wgmma route does all three.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace {

using namespace flash;

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, int src_bytes) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem, int src_bytes) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(addr), "l"(gmem),
               "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const void* smem) {
  unsigned addr = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr));
}

// c += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ---------------------------------------------------------------------------
// bf16: mma.sync m16n8k16, 16 query rows per warp.
// ---------------------------------------------------------------------------

constexpr int kBf16Warps = 4;
constexpr int kBf16BM = 16 * kBf16Warps;
constexpr int kBf16BN = 64;

template <int DPAD>
struct Bf16Smem {
  static constexpr int LD = DPAD + 8;  // +16 bytes per row: ldmatrix rows hit distinct banks
  static constexpr int kQ = kBf16BM * LD, kKV = kBf16BN * LD;  // elements
  static constexpr size_t kBytes = (size_t)(kQ + 4 * kKV) * sizeof(bf16);
};

// ROWS x DPAD tile of rows [row0, row0 + ROWS) of a (seq, dim) slice with
// row stride `rs`; rows >= nrows and dims >= D are zero-filled.  D and the
// strides are multiples of 8 and the base is 16-byte aligned (the launcher
// refuses anything else), so each 16-byte chunk is wholly inside or outside.
template <int ROWS, int DPAD>
__device__ __forceinline__ void load_tile_bf16(bf16* dst, const bf16* __restrict__ src,
                                               long long rs, int row0, int nrows, int D) {
  constexpr int LD = Bf16Smem<DPAD>::LD, CH = DPAD / 8, NT = kBf16Warps * 32;
  for (int idx = threadIdx.x; idx < ROWS * CH; idx += NT) {
    const int r = idx / CH, c = (idx % CH) * 8;
    const int gr = row0 + r;
    const bool in = gr < nrows && c < D;
    cp_async16(dst + r * LD + c, in ? src + gr * rs + c : src, in ? 16 : 0);
  }
}

template <int DPAD>
__global__ void __launch_bounds__(kBf16Warps * 32)
    flash_bf16_kernel(const Params p) {
  using S = Bf16Smem<DPAD>;
  constexpr int BM = kBf16BM, BN = kBf16BN, LD = S::LD;
  constexpr int KQ = DPAD / 16;  // k-steps of the QK^T product
  constexpr int ND = DPAD / 8;   // 8-wide output column tiles
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* Qs = reinterpret_cast<bf16*>(smem);
  bf16* Ks = Qs + S::kQ;            // [2][BN][LD]
  bf16* Vs = Ks + 2 * S::kKV;       // [2][BN][LD]

  const Tile t = tile_of(p, BM);
  const int hk = t.h / (p.Hq / p.Hkv);
  const bf16* qg = static_cast<const bf16*>(p.q) + t.b * p.q_sb + t.h * p.q_sh;
  const bf16* kg = static_cast<const bf16*>(p.k) + t.b * p.k_sb + hk * p.k_sh;
  const bf16* vg = static_cast<const bf16*>(p.v) + t.b * p.v_sb + hk * p.v_sh;
  bf16* og = static_cast<bf16*>(p.o) + t.b * p.o_sb + t.h * p.o_sh;

  const int q_last = min(t.q0 + BM, p.Sq) - 1;
  int lo, hi;
  kv_range(p, t.q0, q_last, lo, hi);
  const int jb = lo / BN * BN;
  const int ntiles = hi > lo ? (hi - jb + BN - 1) / BN : 0;

  load_tile_bf16<BM, DPAD>(Qs, qg, p.q_ss, t.q0, p.Sq, p.D);
  if (ntiles > 0) {
    load_tile_bf16<BN, DPAD>(Ks, kg, p.k_ss, jb, p.Skv, p.D);
    load_tile_bf16<BN, DPAD>(Vs, vg, p.v_ss, jb, p.Skv, p.D);
  }
  cp_async_commit();

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, tq = lane & 3;
  const int r0 = t.q0 + warp * 16 + g, r1 = r0 + 8;  // this thread's two query rows
  const float sl2 = p.scale * 1.4426950408889634f;   // scale * log2(e)

  uint32_t qf[KQ][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) o[n][0] = o[n][1] = o[n][2] = o[n][3] = 0.f;
  float m[2] = {-INFINITY, -INFINITY};  // running max of the base-2 scores
  float l[2] = {0.f, 0.f};              // this thread's part of the row sums

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = jb + it * BN;
    if (it + 1 < ntiles) {  // prefetch the next tile into the other buffer
      const int nb = (it + 1) & 1;
      load_tile_bf16<BN, DPAD>(Ks + nb * S::kKV, kg, p.k_ss, j0 + BN, p.Skv, p.D);
      load_tile_bf16<BN, DPAD>(Vs + nb * S::kKV, vg, p.v_ss, j0 + BN, p.Skv, p.D);
    }
    cp_async_commit();
    cp_async_wait<1>();  // this thread's copies of tile `it` (and of Q) have landed
    __syncthreads();     // and everyone's have
    if (it == 0) {
#pragma unroll
      for (int kk = 0; kk < KQ; ++kk)
        ldmatrix_x4(qf[kk], Qs + (warp * 16 + (lane & 15)) * LD + kk * 16 + (lane >> 4) * 8);
    }
    const bf16* kb = Ks + (it & 1) * S::kKV;
    const bf16* vb = Vs + (it & 1) * S::kKV;

    // S = Q K^T: 16 rows x 64 keys per warp, as 8 n-tiles of 16x8.
    float s[BN / 8][4];
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KQ; ++kk) {
      if (kk * 16 >= p.D) break;  // all-zero slices of the padded dim
#pragma unroll
      for (int np = 0; np < BN / 16; ++np) {
        // matrices: keys np*16 + {0-7, 0-7, 8-15, 8-15} x dims kk*16 + {0-7, 8-15, 0-7, 8-15}
        const int mi = lane >> 3, mr = lane & 7;
        uint32_t b[4];
        ldmatrix_x4(b, kb + (np * 16 + (mi >> 1) * 8 + mr) * LD + kk * 16 + (mi & 1) * 8);
        mma_bf16(s[2 * np], qf[kk], b[0], b[1]);
        mma_bf16(s[2 * np + 1], qf[kk], b[2], b[3]);
      }
    }

    // Online softmax in base 2.  s[n][0..1]: row r0, keys j0 + n*8 + 2*tq + {0,1};
    // s[n][2..3]: row r1, the same keys.
    const bool masked = tile_needs_mask(p, t.q0, q_last, j0, BN);
    float mx[2] = {m[0], m[1]};
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        float x = s[n][e] * sl2;
        if (masked && !key_valid(p, e < 2 ? r0 : r1, j0 + n * 8 + 2 * tq + (e & 1))) x = -INFINITY;
        s[n][e] = x;
        mx[e >> 1] = fmaxf(mx[e >> 1], x);
      }
    }
    float alpha[2], m_use[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
      mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
      // a row with no valid key so far keeps max -inf: subtract 0 so that
      // exp2(-inf - 0) = 0 instead of exp2(-inf + inf) = NaN
      m_use[r] = mx[r] == -INFINITY ? 0.f : mx[r];
      alpha[r] = exp2f(m[r] - m_use[r]);
      m[r] = mx[r];
      l[r] *= alpha[r];
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= alpha[0];
      o[n][1] *= alpha[0];
      o[n][2] *= alpha[1];
      o[n][3] *= alpha[1];
    }
#pragma unroll
    for (int n = 0; n < BN / 8; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float pe = exp2f(s[n][e] - m_use[e >> 1]);
        s[n][e] = pe;
        l[e >> 1] += pe;
      }
    }

    // O += P V: P from registers (the S accumulator layout is the A
    // fragment layout), V through ldmatrix.trans.
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      const uint32_t a[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                             pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                             pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                             pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int nd = 0; nd < ND / 2; ++nd) {
        if (nd * 16 >= p.D) break;
        // matrices: keys kk*16 + {0-7, 8-15, 0-7, 8-15} x dims nd*16 + {0-7, 0-7, 8-15, 8-15}
        const int mi = lane >> 3, mr = lane & 7;
        uint32_t b[4];
        ldmatrix_x4_trans(b, vb + (kk * 16 + (mi & 1) * 8 + mr) * LD + nd * 16 + (mi >> 1) * 8);
        mma_bf16(o[2 * nd], a, b[0], b[1]);
        mma_bf16(o[2 * nd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();  // everyone is done with this buffer before it is refilled
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
  }
  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
#pragma unroll
  for (int n = 0; n < ND; ++n) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = e < 2 ? r0 : r1, col = n * 8 + 2 * tq + (e & 1);
      if (row < p.Sq && col < p.D)
        og[row * p.o_ss + col] = __float2bfloat16_rn(o[n][e] * inv[e >> 1]);
    }
  }
}

// ---------------------------------------------------------------------------
// fp32: FMA on 4 x 2 score micro-tiles, 16 x 16 threads per 64 x 32 tile.
// ---------------------------------------------------------------------------

constexpr int kF32Threads = 256;
constexpr int kF32BM = 64;
constexpr int kF32BN = 32;

template <int DPAD>
struct F32Smem {
  static constexpr int LD = DPAD + 1;       // odd stride: column reads hit distinct banks
  static constexpr int LDP = kF32BN + 1;
  static constexpr int kQ = kF32BM * LD, kKV = kF32BN * LD, kP = kF32BM * LDP;  // floats
  static constexpr size_t kBytes = (size_t)(kQ + 4 * kKV + kP) * sizeof(float);
};

template <int ROWS, int DPAD>
__device__ __forceinline__ void load_tile_f32(float* dst, const float* __restrict__ src,
                                              long long rs, int row0, int nrows, int D) {
  constexpr int LD = F32Smem<DPAD>::LD;
  for (int idx = threadIdx.x; idx < ROWS * DPAD; idx += kF32Threads) {
    const int r = idx / DPAD, c = idx % DPAD;
    const int gr = row0 + r;
    const bool in = gr < nrows && c < D;
    cp_async4(dst + r * LD + c, in ? src + gr * rs + c : src, in ? 4 : 0);
  }
}

template <int DPAD>
__global__ void __launch_bounds__(kF32Threads) flash_f32_kernel(const Params p) {
  using S = F32Smem<DPAD>;
  constexpr int BM = kF32BM, BN = kF32BN, LD = S::LD, LDP = S::LDP;
  constexpr int NC = DPAD / 16;  // output columns per thread: tx + 16 c
  extern __shared__ __align__(128) unsigned char smem[];
  float* Qs = reinterpret_cast<float*>(smem);
  float* Ks = Qs + S::kQ;       // [2][BN][LD]
  float* Vs = Ks + 2 * S::kKV;  // [2][BN][LD]
  float* Ps = Vs + 2 * S::kKV;  // [BM][LDP]

  const Tile t = tile_of(p, BM);
  const int hk = t.h / (p.Hq / p.Hkv);
  const float* qg = static_cast<const float*>(p.q) + t.b * p.q_sb + t.h * p.q_sh;
  const float* kg = static_cast<const float*>(p.k) + t.b * p.k_sb + hk * p.k_sh;
  const float* vg = static_cast<const float*>(p.v) + t.b * p.v_sb + hk * p.v_sh;
  float* og = static_cast<float*>(p.o) + t.b * p.o_sb + t.h * p.o_sh;

  const int q_last = min(t.q0 + BM, p.Sq) - 1;
  int lo, hi;
  kv_range(p, t.q0, q_last, lo, hi);
  const int jb = lo / BN * BN;
  const int ntiles = hi > lo ? (hi - jb + BN - 1) / BN : 0;

  if (ntiles > 0) {
    load_tile_f32<BN, DPAD>(Ks, kg, p.k_ss, jb, p.Skv, p.D);
    load_tile_f32<BN, DPAD>(Vs, vg, p.v_ss, jb, p.Skv, p.D);
  }
  cp_async_commit();
  // q scaled in fp32 before the product, as in the reference
  for (int idx = threadIdx.x; idx < BM * DPAD; idx += kF32Threads) {
    const int r = idx / DPAD, c = idx % DPAD, gr = t.q0 + r;
    Qs[r * LD + c] = (gr < p.Sq && c < p.D) ? qg[gr * p.q_ss + c] * p.scale : 0.f;
  }

  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;  // a row's 16 threads share a warp
  float o[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < NC; ++c) o[i][c] = 0.f;
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) m[i] = -INFINITY, l[i] = 0.f;

  for (int it = 0; it < ntiles; ++it) {
    const int j0 = jb + it * BN;
    if (it + 1 < ntiles) {
      const int nb = (it + 1) & 1;
      load_tile_f32<BN, DPAD>(Ks + nb * S::kKV, kg, p.k_ss, j0 + BN, p.Skv, p.D);
      load_tile_f32<BN, DPAD>(Vs + nb * S::kKV, vg, p.v_ss, j0 + BN, p.Skv, p.D);
    }
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const float* kb = Ks + (it & 1) * S::kKV;
    const float* vb = Vs + (it & 1) * S::kKV;

    // rows ty*4 + i, keys j0 + tx + 16 j
    float s[4][2] = {};
    for (int d = 0; d < p.D; ++d) {
      float a[4], b[2];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = Qs[(ty * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 2; ++j) b[j] = kb[(tx + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 2; ++j) s[i][j] = fmaf(a[i], b[j], s[i][j]);
    }
    const bool masked = tile_needs_mask(p, t.q0, q_last, j0, BN);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = t.q0 + ty * 4 + i;
      float mx = m[i];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        if (masked && !key_valid(p, row, j0 + tx + 16 * j)) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_use = mx == -INFINITY ? 0.f : mx;
      const float alpha = expf(m[i] - m_use);
      m[i] = mx;
      l[i] *= alpha;
#pragma unroll
      for (int c = 0; c < NC; ++c) o[i][c] *= alpha;
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const float pe = expf(s[i][j] - m_use);
        l[i] += pe;
        Ps[(ty * 4 + i) * LDP + tx + 16 * j] = pe;
      }
    }
    __syncthreads();
    const int kmax = min(BN, p.Skv - j0);  // zero-filled keys past S_kv add nothing
    for (int kk = 0; kk < kmax; ++kk) {
      float pr[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pr[i] = Ps[(ty * 4 + i) * LDP + kk];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        if (tx + 16 * c < p.D) {
          const float vv = vb[kk * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) o[i][c] = fmaf(pr[i], vv, o[i][c]);
        }
      }
    }
    __syncthreads();
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float li = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1) li += __shfl_xor_sync(0xffffffffu, li, off);
    const float inv = li > 0.f ? 1.f / li : 0.f;
    const int row = t.q0 + ty * 4 + i;
    if (row < p.Sq) {
#pragma unroll
      for (int c = 0; c < NC; ++c)
        if (tx + 16 * c < p.D) og[row * p.o_ss + tx + 16 * c] = o[i][c] * inv;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

template <int DPAD>
cudaError_t launch_bf16(const Params& p, int grid, cudaStream_t stream) {
  static bool done[64] = {};
  auto kern = flash_bf16_kernel<DPAD>;
  const size_t smem = Bf16Smem<DPAD>::kBytes;
  cudaError_t e = opt_in(kern, smem, done);
  if (e != cudaSuccess) return e;
  kern<<<grid, kBf16Warps * 32, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DPAD>
cudaError_t launch_f32(const Params& p, int grid, cudaStream_t stream) {
  static bool done[64] = {};
  auto kern = flash_f32_kernel<DPAD>;
  const size_t smem = F32Smem<DPAD>::kBytes;
  cudaError_t e = opt_in(kern, smem, done);
  if (e != cudaSuccess) return e;
  kern<<<grid, kF32Threads, smem, stream>>>(p);
  return cudaGetLastError();
}

template <int DPAD>
cudaError_t dispatch_bf16(Params p, cudaStream_t stream) {
  p.nq = (p.Sq + kBf16BM - 1) / kBf16BM;
  const long long grid = (long long)p.nq * p.Hq * p.B;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  // The stride of a dim of extent 1 is never stepped; any other must be a
  // multiple of 8 elements (0, a broadcast batch or head, is one).
  const long long strides[][2] = {{p.q_sb, p.B}, {p.q_ss, p.Sq}, {p.q_sh, p.Hq},
                                  {p.k_sb, p.B}, {p.k_ss, p.Skv}, {p.k_sh, p.Hkv},
                                  {p.v_sb, p.B}, {p.v_ss, p.Skv}, {p.v_sh, p.Hkv}};
  bool aligned = p.D % 8 == 0 && reinterpret_cast<uintptr_t>(p.q) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(p.k) % 16 == 0 &&
                 reinterpret_cast<uintptr_t>(p.v) % 16 == 0;
  for (const auto& s : strides) aligned = aligned && (s[1] <= 1 || s[0] % 8 == 0);
  if (!aligned) return cudaErrorMisalignedAddress;
  return launch_bf16<DPAD>(p, (int)grid, stream);
}

template <int DPAD>
cudaError_t dispatch_f32(Params p, cudaStream_t stream) {
  p.nq = (p.Sq + kF32BM - 1) / kF32BM;
  const long long grid = (long long)p.nq * p.Hq * p.B;
  if (grid > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  return launch_f32<DPAD>(p, (int)grid, stream);
}

}  // namespace

extern "C" {

// o = attention(q, k, v) for q, o of shape (B, S_q, H_q, D) and k, v of
// shape (B, S_kv, H_kv, D), each addressed through its (batch, seq, head)
// strides in elements with the last dim contiguous; bf16 or fp32 (dtype
// 1 or 0), all four of one type.  H_q % H_kv == 0, 1 <= D <= 128; for
// bf16 also D, and q's, k's and v's strides, multiples of 8 and their
// bases 16-byte aligned.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when the launch was accepted).
int flash_attention_launch(const void* q, const void* k, const void* v, void* o, int dtype,
                           int B, int Hq, int Hkv, int Sq, int Skv, int D, long long q_sb,
                           long long q_ss, long long q_sh, long long k_sb, long long k_ss,
                           long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                           long long o_sb, long long o_ss, long long o_sh, int causal, int window,
                           float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv < 0 || D <= 0 ||
      D > 128)
    return (int)cudaErrorInvalidValue;
  Params p{q,    k,    v,    o,    B,    Hq,   Hkv,  Sq,   Skv,    D,      q_sb,  q_ss, q_sh,
           k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh, causal, window, scale, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == kBF16) {
    if (D <= 32) return (int)dispatch_bf16<32>(p, st);
    if (D <= 64) return (int)dispatch_bf16<64>(p, st);
    return (int)dispatch_bf16<128>(p, st);
  }
  if (dtype == kF32) {
    if (D <= 32) return (int)dispatch_f32<32>(p, st);
    if (D <= 64) return (int)dispatch_f32<64>(p, st);
    return (int)dispatch_f32<128>(p, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
