// K2's wgmma route: warp-specialised flash attention for Hopper (sm_90a),
// bf16 with fp32 statistics, head dims 64-128.
//
// Replaces src/repro/kernels/flash_attention/kernel.py:92 (flash_attention,
// the Pallas TPU kernel, body _flash_kernel) for bf16 calls whose head dim
// and strides TMA can take; it computes the same function as the mma route
// in flash_attention.cu: for each query head h and query i, softmax over the
// keys j of KV head h / (Hq / Hkv) with j < S_kv, j <= i when causal and
// j > i - window when window > 0 (query and key both counted from 0), times
// V; fp32 running max, normaliser and accumulator; P rounded to bf16 for the
// PV product; a row with no valid key outputs 0.
//
// Bound.  At the long prefill's shapes the work is 4 * D flops per unmasked
// (query, key) pair (1.93 TFLOP at danube's D = 120 with a 4096 window,
// 4.40 TFLOP at Llama's D = 64 causal, S = 32768, 32 query heads): 2.0 and
// 4.4 ms at the 989 TFLOP/s bf16 tensor-core peak, against 0.2 ms to move
// Q, K, V and O once.  Beside it stands an exp floor: one exp2 per unmasked
// pair on the special-function units (16 a clock per SM), about 1.0 ms at
// danube's shape and 4.1 ms at Llama's at a 1980 MHz SM clock, nearly as
// long as the tensor bound itself at D = 64.  What the design does about
// each:
//
// * wgmma.  S = Q K^T is m64n128k16 with both operands in shared memory
//   (Q and K K-major, D contiguous); O += P V is m64nDk16 with P in
//   registers (the RS form: the fp32 S accumulator, rounded to bf16 pairs,
//   is already wgmma's A-fragment layout) and V read MN-major through the
//   transpose flag, as K1's wide route reads its row-major B.
// * TMA.  One producer thread loads Q once and streams K and V tiles of 128
//   keys through a ring of STAGES stages, a full and an empty mbarrier per
//   stage for each of K and V, so the QK^T product of a tile can start
//   while its V is still in flight.  Each operand is a 4-D tensor map over
//   (D, H, S, B) with the tensor's own byte strides, encoded per call and
//   passed as a __grid_constant__ parameter (launches are capturable in a
//   CUDA graph); boxes are 64 elements (the 128-byte swizzle span) x 1 head
//   x 128 rows x 1 batch.  Dim 0 is the true D, so for D = 120 the second
//   box reads columns 120-127 as TMA's out-of-bounds zeros, and keys past
//   S_kv come in as zeros too: nothing is padded in device memory.
// * Warp specialisation.  One CTA per (batch, head, 128-row query tile):
//   warpgroups 0 and 1 each own 64 query rows, warp 8 is the producer.  The
//   two consumer warpgroups take turns to issue their products through two
//   named barriers, so one's exps and row sums run while the other's
//   wgmmas hold the tensor cores.  In its turn a warpgroup issues O += P V
//   of the last tile, waits for it, then issues S = Q K^T of this tile:
//   P and S are never live together.  ptxas (CUDA 12.9) holds every thread
//   of a 288- or 384-thread CTA to 168 registers whatever setmaxnreg asks
//   for, so there is no setmaxnreg and the producer is one warp.  Keeping
//   PV in flight across the softmax instead (P, S and O live at once)
//   spills at D = 128 and, even at D = 64 where it does not, runs slower
//   at both long-prefill shapes (PERF.md).
// * Masks.  The producer walks only the key tiles in kv_range (from the
//   first tile the window admits to the last one the causal mask admits);
//   only the tiles tile_needs_mask marks (the first and last of the range)
//   compare positions, one unsigned compare per score against the row's
//   key interval; every other tile runs unmasked.  The softmax runs in
//   base 2 with scale * log2(e) applied to the fp32 scores after the product,
//   folded into one FFMA per probability: exp2(s * scale * log2(e) - max).
// * Epilogue.  Each consumer warpgroup divides by l, rounds to bf16, stages
//   its 64 rows in its half of the Q buffer (free once its last QK^T is
//   done) and writes rows < S_q, columns < D with 16-byte stores.
//
// Safety: a lost mbarrier arrival traps after a bounded spin (hopper.cuh)
// instead of holding the card.  No float atomics: every output is summed
// in one order, so reruns are bitwise equal.
//
// The wrapper (kernel.py) decides the route and computes each tensor map's
// dims, byte strides and box (tma_geometry); this entry point checks them
// against the compiled tile and refuses anything else.
#include <limits.h>
#include <math.h>
#include <stddef.h>

#include "flash_common.cuh"
#include "hopper.cuh"  // kernels/common: mbarriers, TMA, wgmma, named barriers, encoder

namespace {

using namespace flash;
using namespace hopper;

template <int DPAD_, int STAGES_>
struct WgTile {
  static constexpr int BM = 128, BN = 128, DPAD = DPAD_, STAGES = STAGES_;
  static constexpr int kThreads = 288;               // 2 consumer warpgroups + a producer warp
  static constexpr int kChunks = DPAD / 64;          // 64-column TMA boxes per row
  static constexpr int kQChunk = BM * 128;           // bytes of one Q box
  static constexpr int kKVChunk = BN * 128;          // bytes of one K or V box
  static constexpr int kQBytes = kChunks * kQChunk;
  static constexpr int kKVBytes = kChunks * kKVChunk;  // one K or V tile
  static constexpr int kS = BN / 2;                  // fp32 scores a consumer thread holds
  static constexpr int kO = DPAD / 2;                // fp32 outputs a consumer thread holds
  static constexpr int kP = BN / 4;                  // bf16 pairs of P a consumer thread holds
  // Q, the K and V rings, a Q barrier and full + empty barriers per stage
  // for K and V, and slack to align the tiles to the swizzle's 1024 bytes
  static constexpr size_t kSmemBytes =
      1024 + (size_t)kQBytes + 2 * STAGES * (size_t)kKVBytes + (1 + 4 * STAGES) * 8;
  static_assert(DPAD == 64 || DPAD == 128, "head dims are padded to 64 or 128");
  static_assert(kSmemBytes <= 232448, "a block may use 227 KB of shared memory");
};

// Named barriers: the consumers' turns to issue products (1, 2) and each
// consumer warpgroup's epilogue (3, 4).  0 is __syncthreads.
constexpr int kBarTurn = 1, kBarEpilogue = 3;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int DPAD> struct Pv;
template <> struct Pv<64> {
  static __device__ __forceinline__ void run(float (&o)[32], const uint32_t (&a)[4], uint64_t db) {
    wgmma_m64n64k16_rs<1>(o, a, db, 1);
  }
};
template <> struct Pv<128> {
  static __device__ __forceinline__ void run(float (&o)[64], const uint32_t (&a)[4], uint64_t db) {
    wgmma_m64n128k16_rs<1>(o, a, db, 1);
  }
};

// S = Q_g K^T for this warpgroup's 64 rows: D / 16 k-steps, 32 bytes apart
// inside a 128-byte swizzled row, 64-column boxes kQChunk / kKVChunk apart.
template <typename T>
__device__ __forceinline__ void issue_qk(float (&s)[T::kS], uint32_t q_addr, uint32_t k_addr) {
#pragma unroll
  for (int kk = 0; kk < T::DPAD / 16; ++kk)
    wgmma_m64n128k16_ss<0>(
        s, smem_desc(q_addr + (kk / 4) * T::kQChunk + (kk % 4) * 32, 16, 1024),
        smem_desc(k_addr + (kk / 4) * T::kKVChunk + (kk % 4) * 32, 16, 1024), kk > 0);
}

// O += P V: 16 keys a k-step (16 rows of 128 bytes), V MN-major with its
// 64-column boxes kKVChunk apart (LBO) and 8-key groups 1024 bytes apart.
template <typename T>
__device__ __forceinline__ void issue_pv(float (&o)[T::kO], const uint32_t (&pf)[T::kP],
                                         uint32_t v_addr) {
#pragma unroll
  for (int kk = 0; kk < T::BN / 16; ++kk) {
    const uint32_t a[4] = {pf[4 * kk], pf[4 * kk + 1], pf[4 * kk + 2], pf[4 * kk + 3]};
    Pv<T::DPAD>::run(o, a, smem_desc(v_addr + kk * 16 * 128, T::kKVChunk, 1024));
  }
}

template <typename T>
__global__ void __launch_bounds__(T::kThreads, 1)
    flash_wgmma_kernel(const __grid_constant__ CUtensorMap tma_q,
                       const __grid_constant__ CUtensorMap tma_k,
                       const __grid_constant__ CUtensorMap tma_v, const Params p) {
  constexpr int BM = T::BM, BN = T::BN, STAGES = T::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* Qs = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* Ks = Qs + T::kQBytes;             // [STAGES][chunk][BN rows][128 B]
  unsigned char* Vs = Ks + STAGES * T::kKVBytes;   // [STAGES][chunk][BN rows][128 B]
  uint64_t* bar_q = reinterpret_cast<uint64_t*>(Vs + STAGES * T::kKVBytes);
  uint64_t* full_k = bar_q + 1;
  uint64_t* empty_k = full_k + STAGES;
  uint64_t* full_v = empty_k + STAGES;
  uint64_t* empty_v = full_v + STAGES;

  const Tile t = tile_of(p, BM);
  const int hk = t.h / (p.Hq / p.Hkv);
  const int q_last = min(t.q0 + BM, p.Sq) - 1;
  int lo, hi;
  kv_range(p, t.q0, q_last, lo, hi);
  const int jb = lo / BN * BN;
  const int ntiles = hi > lo ? (hi - jb + BN - 1) / BN : 0;
  // Warpgroups 0 and 1 consume, warp 8 (warpgroup 2) produces.  The index
  // is broadcast from lane 0 so that the compiler sees it is the same in
  // every lane: wgmma under a branch it cannot prove uniform is serialised.
  const int wg = __shfl_sync(0xffffffffu, (int)threadIdx.x / 128, 0);

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full_k[s], 1);   // the producer's expect_tx
      mbar_init(&full_v[s], 1);
      mbar_init(&empty_k[s], 8);  // one arrive per consumer warp
      mbar_init(&empty_v[s], 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 2) {
    // Producer warp: one thread loads Q, then keeps the K and V rings full.
    // Nothing is loaded for a query tile that no key reaches.
    if (threadIdx.x == 256 && ntiles > 0) {
      mbar_expect_tx(bar_q, T::kQBytes);
#pragma unroll
      for (int c = 0; c < T::kChunks; ++c)
        tma_load_4d(Qs + c * T::kQChunk, &tma_q, 64 * c, t.h, t.q0, t.b, bar_q);
      int stage = 0, phase = 0;
      for (int it = 0; it < ntiles; ++it) {
        const int j0 = jb + it * BN;
        mbar_wait(&empty_k[stage], phase ^ 1);   // the first round passes at once
        mbar_expect_tx(&full_k[stage], T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load_4d(Ks + stage * T::kKVBytes + c * T::kKVChunk, &tma_k, 64 * c, hk, j0, t.b,
                      &full_k[stage]);
        mbar_wait(&empty_v[stage], phase ^ 1);
        mbar_expect_tx(&full_v[stage], T::kKVBytes);
#pragma unroll
        for (int c = 0; c < T::kChunks; ++c)
          tma_load_4d(Vs + stage * T::kKVBytes + c * T::kKVChunk, &tma_v, 64 * c, hk, j0, t.b,
                      &full_v[stage]);
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
    }
  } else {
    // Consumer warpgroups: g owns query rows q0 + 64 g .. q0 + 64 g + 63.
    const int g = wg, tid = threadIdx.x % 128, lane = tid % 32;
    const int rq = (tid / 32) * 16 + lane / 4;  // this thread's rows rq and rq + 8 of the 64
    const int r0 = t.q0 + g * 64 + rq;
    const float sl2 = p.scale * 1.4426950408889634f;  // scale * log2(e)
    // A positive scale multiplies inside the exponent's FFMA (c = sl2);
    // any other is applied to the scores first (c = 1, exactly s - max).
    const bool positive = sl2 > 0.f;
    const float c = positive ? sl2 : 1.f;
    const uint32_t q_addr = smem_addr(Qs) + g * 64 * 128;

    float o[T::kO];
#pragma unroll
    for (int i = 0; i < T::kO; ++i) o[i] = 0.f;
    float m[2] = {-INFINITY, -INFINITY};  // running max of the base-2 scores
    float l[2] = {0.f, 0.f};              // this thread's part of the row sums
    uint32_t pf[T::kP];                   // P of the previous tile: wgmma's A fragment

    if (ntiles > 0) {
      mbar_wait(bar_q, 0);
      if (g == 1) bar_arrive(kBarTurn, 256);  // warpgroup 0 issues first
      int ks = 0, kph = 0, vs = 0, vph = 0;
      for (int it = 0; it < ntiles; ++it) {
        const int j0 = jb + it * BN;
        float s[T::kS];
        mbar_wait(&full_k[ks], kph);
        if (it > 0) mbar_wait(&full_v[vs], vph);  // V of tile it - 1
        // This warpgroup's turn at the tensor cores: O += P V of the last
        // tile, then S = Q K^T of this one, then the other warpgroup's turn
        // while this one runs its softmax.  PV is done before QK^T starts,
        // so P and S are never live together (ptxas holds every thread to
        // the launch's 168 registers).
        bar_sync(kBarTurn + g, 256);
        wgmma_fence();
        if (it > 0) {
          issue_pv<T>(o, pf, smem_addr(Vs + vs * T::kKVBytes));
          wgmma_commit();
          wgmma_wait<0>();
          fence_accum(o);
          if (lane == 0) mbar_arrive(&empty_v[vs]);
          if (++vs == STAGES) vs = 0, vph ^= 1;
        }
        issue_qk<T>(s, q_addr, smem_addr(Ks + ks * T::kKVBytes));
        wgmma_commit();
        if (g == 0 || it + 1 < ntiles) bar_arrive(kBarTurn + 1 - g, 256);
        wgmma_wait<0>();
        fence_accum(s);
        if (lane == 0) mbar_arrive(&empty_k[ks]);
        if (++ks == STAGES) ks = 0, kph ^= 1;

        // Online softmax in base 2.  s[i]: row rq + 8 ((i >> 1) & 1), key
        // j0 + 8 (i >> 2) + 2 (lane % 4) + (i & 1).  With a positive scale
        // the max is taken over the raw scores and scaled once, so that each
        // probability is one FFMA and one exp2: exp2(s * sl2 - max).
        if (!positive) {
#pragma unroll
          for (int i = 0; i < T::kS; ++i) s[i] *= sl2;
        }
        if (tile_needs_mask(p, t.q0, q_last, j0, BN)) {
          // Row r admits the keys [lo, hi) (key_valid's rule): one unsigned
          // compare per score, modulo 2^32, so lo may be negative.
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const int row = r0 + 8 * h;
            const int hi = p.causal ? min(p.Skv, row + 1) : p.Skv;
            const int lo = p.window > 0 ? row - p.window + 1 : 0;
            const unsigned span = hi > lo ? (unsigned)hi - (unsigned)lo : 0u;
            const unsigned key = (unsigned)(j0 + 2 * (lane & 3)) - (unsigned)lo;
#pragma unroll
            for (int i = 2 * h; i < T::kS; i += 4) {
              if (key + 8 * (i >> 2) >= span) s[i] = -INFINITY;
              if (key + 8 * (i >> 2) + 1 >= span) s[i + 1] = -INFINITY;
            }
          }
        }
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int i = 0; i < T::kS; ++i) mx[(i >> 1) & 1] = fmaxf(mx[(i >> 1) & 1], s[i]);
        float alpha[2], mu[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          mx[r] = fmaxf(m[r], mx[r] * c);
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
          mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
          // a row with no valid key so far keeps max -inf: subtract 0 so that
          // exp2(-inf - 0) = 0 instead of exp2(-inf + inf) = NaN
          mu[r] = mx[r] == -INFINITY ? 0.f : mx[r];
          alpha[r] = ex2(m[r] - mu[r]);
          m[r] = mx[r];
          l[r] *= alpha[r];
        }
#pragma unroll
        for (int i = 0; i < T::kS; ++i) {
          s[i] = ex2(fmaf(s[i], c, -mu[(i >> 1) & 1]));
          l[(i >> 1) & 1] += s[i];
        }
#pragma unroll
        for (int i = 0; i < T::kO; ++i) o[i] *= alpha[(i >> 1) & 1];
#pragma unroll
        for (int i = 0; i < T::kP; ++i) pf[i] = pack_bf16(s[2 * i], s[2 * i + 1]);
      }
      mbar_wait(&full_v[vs], vph);
      wgmma_fence();
      issue_pv<T>(o, pf, smem_addr(Vs + vs * T::kKVBytes));
      wgmma_commit();
      wgmma_wait<0>();
      fence_accum(o);
      if (lane == 0) mbar_arrive(&empty_v[vs]);
    }

    // Epilogue: O / l in bf16, staged in this warpgroup's rows of the Q
    // buffer (16-byte units XOR-swizzled by row, so neither the writes nor
    // the reads collide on banks), then 16-byte stores of rows < S_q and
    // columns < D.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    }
    const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f, l[1] > 0.f ? 1.f / l[1] : 0.f};
    unsigned char* ob = Qs + g * 64 * 128;
    bar_sync(kBarEpilogue + g, 128);  // every warp's last product has read these rows
#pragma unroll
    for (int j = 0; j < T::DPAD / 8; ++j) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int row = rq + 8 * h;
        *reinterpret_cast<uint32_t*>(ob + (j / 8) * T::kQChunk + row * 128 +
                                     (((j % 8) ^ (row & 7)) * 16) + (lane & 3) * 4) =
            pack_bf16(o[4 * j + 2 * h] * inv[h], o[4 * j + 2 * h + 1] * inv[h]);
      }
    }
    bar_sync(kBarEpilogue + g, 128);
    bf16* og = static_cast<bf16*>(p.o) + t.b * p.o_sb + t.h * p.o_sh;
    constexpr int kUnits = T::DPAD / 8;  // 16-byte units of a row
    for (int idx = tid; idx < 64 * kUnits; idx += 128) {
      const int row = idx / kUnits, j = idx % kUnits;
      const int grow = t.q0 + g * 64 + row, col = 8 * j;
      if (grow < p.Sq && col < p.D)
        *reinterpret_cast<uint4*>(og + grow * p.o_ss + col) = *reinterpret_cast<const uint4*>(
            ob + (j / 8) * T::kQChunk + row * 128 + (((j % 8) ^ (row & 7)) * 16));
    }
  }
}

// ---------------------------------------------------------------------------
// Host side.
// ---------------------------------------------------------------------------

using Wg64 = WgTile<64, 4>;
using Wg128 = WgTile<128, 2>;

// Geometry of one operand as the wrapper computes it (kernel.tma_geometry):
// dims (D, H, S, B), byte strides of H, S and B, box (64, 1, rows, 1).
constexpr int kGeo = 11;

bool encode(CUtensorMap* map, const void* base, const long long* g) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[4], strides[3];
  cuuint32_t box[4], elem[4] = {1, 1, 1, 1};
  for (int i = 0; i < 4; ++i) dims[i] = (cuuint64_t)g[i];
  for (int i = 0; i < 3; ++i) strides[i] = (cuuint64_t)g[4 + i];
  for (int i = 0; i < 4; ++i) box[i] = (cuuint32_t)g[7 + i];
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(base), dims, strides,
            box, elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// Does an operand's geometry describe (D, h, s, B) in boxes of `rows` rows,
// with byte strides TMA takes (multiples of 16 below 2^40)?
bool geometry_ok(const long long* g, int D, int h, int s, int B, int rows) {
  if (g[0] != D || g[1] != h || g[2] != s || g[3] != B) return false;
  for (int i = 4; i < 7; ++i)
    if (g[i] <= 0 || g[i] % 16 || g[i] >= (1LL << 40)) return false;
  return g[7] == 64 && g[8] == 1 && g[9] == rows && g[10] == 1;
}

template <typename T>
cudaError_t launch(Params p, const long long* geo, cudaStream_t stream) {
  p.nq = (p.Sq + T::BM - 1) / T::BM;
  const long long grid = (long long)p.nq * p.Hq * p.B;
  if (grid > INT_MAX) return cudaErrorInvalidConfiguration;
  if (!geometry_ok(geo, p.D, p.Hq, p.Sq, p.B, T::BM) ||
      !geometry_ok(geo + kGeo, p.D, p.Hkv, p.Skv, p.B, T::BN) ||
      !geometry_ok(geo + 2 * kGeo, p.D, p.Hkv, p.Skv, p.B, T::BN))
    return cudaErrorInvalidValue;
  CUtensorMap mq, mk, mv;
  if (!encode(&mq, p.q, geo) || !encode(&mk, p.k, geo + kGeo) ||
      !encode(&mv, p.v, geo + 2 * kGeo))
    return cudaErrorInvalidValue;
  auto kern = flash_wgmma_kernel<T>;
  static bool opted_in[64] = {};
  cudaError_t e = opt_in(kern, T::kSmemBytes, opted_in);
  if (e != cudaSuccess) return e;
  kern<<<(int)grid, T::kThreads, T::kSmemBytes, stream>>>(mq, mk, mv, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// o = attention(q, k, v) in bf16 for q, o of shape (B, S_q, H_q, D) and k,
// v of shape (B, S_kv, H_kv, D).  q, k and v are read through tensor maps
// whose geometry (3 x 11 int64: q, k, v) the wrapper computed; o is
// written through its (batch, seq, head) strides in elements, the last dim
// contiguous.  Refuses (cudaErrorInvalidValue) what this route does not
// take: D outside 64-128 or not a multiple of 8, S_kv = 0, H_q % H_kv != 0,
// a base not 16-byte aligned, an o stride not a multiple of 8 on a dim
// longer than 1, a geometry that does not match the shapes and the
// compiled tiles.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError().
int flash_attention_wgmma_launch(const void* q, const void* k, const void* v, void* o,
                                 const long long* geometry, int B, int Hq, int Hkv, int Sq,
                                 int Skv, int D, long long o_sb, long long o_ss, long long o_sh,
                                 int causal, int window, float scale, void* stream) {
  if (B <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || D < 64 ||
      D > 128 || D % 8 || (B > 1 && o_sb % 8) || (Sq > 1 && o_ss % 8) ||
      (Hq > 1 && o_sh % 8))
    return (int)cudaErrorInvalidValue;
  const void* bases[] = {q, k, v, o};
  for (const void* b : bases)
    if (reinterpret_cast<uintptr_t>(b) % 16) return (int)cudaErrorMisalignedAddress;
  Params p{q, k, v, o, B, Hq, Hkv, Sq, Skv, D, 0, 0, 0, 0, 0, 0, 0, 0, 0, o_sb, o_ss, o_sh,
           causal, window, scale, 0};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (D <= 64) return (int)launch<Wg64>(p, geometry, st);
  return (int)launch<Wg128>(p, geometry, st);
}

}  // extern "C"
