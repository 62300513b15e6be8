// Routed MoE experts for Hopper (sm_90a): the SwiGLU of every kept (token,
// expert) pair as a grouped product over the stacked expert weights, bf16
// in, fp32 accumulation, then each token's gated sum of its choices.
//
// Replaces no TPU kernel: the reference computes the MoE with jnp.einsum
// outside any Pallas kernel (repro/layers/moe.py), over one-hot dispatch
// and combine tensors, so every expert runs on every capacity slot.  The
// port's plain version of that form (repro_torch/layers/moe.py, the dense
// route) stays for the CPU and for calls with grad.  Same function here,
// over a pair list of the same routing, built on the card (the choices the
// capacity keeps, sorted by expert, with the E + 1 expert offsets;
// layers/moe.py's pairs() is its plain version): for each kept pair (t, e)
//   h  = bf16(silu(bf16(x_t W_gate[e])) * bf16(x_t W_up[e]))   (fp32 between)
//   ye = bf16(h W_down[e])
// and y_t = bf16(sum over t's kept choices, in choice order, of gate * ye),
// the reference's rounding points, fp32 accumulation everywhere.
//
// Bound.  At decode (64 tokens, top-6 of 64 experts) an expert has ~6 rows,
// so the products do ~6 operations per weight byte, far below the card's
// ~295: the least time is every chosen expert's weights read once at the
// memory rate (3.35 TB/s), 1.1 GB a deepseek layer.  In a prefill slice an
// expert has ~3,000 rows and the products are bound by the tensor cores.
// What the design does about it:
//
// * One grouped launch per product.  A CTA owns one expert, one column
//   tile of the output and one row tile of that expert's pairs (grid: row
//   tile fastest, then column tile, then expert, so the CTAs that share a
//   weight tile run together and find it in L2).  A CTA whose row tile
//   lies past its expert's rows exits before loading anything, so an
//   expert with no rows reads no weights.  The grid is static (row tiles
//   for the most rows an expert can hold), so a CUDA graph captures it.
// * The weights are read in place in their stored (E, d, ff) / (E, ff, d)
//   layouts: 16-byte cp.async copies of (k x columns) tiles into a ring of
//   STAGES shared-memory stages, ldmatrix.trans into mma.sync m16n8k16
//   fragments.  Launch 1 streams W_gate[e] and W_up[e] side by side and
//   multiplies both with the same rows of x, gathered by token index; its
//   epilogue forms SiLU(gate) * up and writes h, one bf16 row per pair.
//   Launch 2 streams W_down[e] against h's rows and writes ye.
// * The tile follows the shape (moe_experts/kernel.py's tile_for, from the
//   static pairs per expert): "thin" at decode, 16 rows, 64-deep stages,
//   many column CTAs, each streaming its weight tile once with several
//   stages in flight (K1 thin's design); "wide" in a prefill, 128 rows by
//   64 (two products) / 128 columns, 4 warps of 64 x 64 products, 64-deep
//   stages, so the tensor cores see large tiles and each ldmatrix feeds
//   four mma (of the tilings measured on an H100, 8 warps of 32 x 32,
//   256-row tiles and 32-deep stages were slower, and loading the next
//   step's fragments ahead of this step's mma gained nothing).  Every
//   CTA walks all of k in order (no split-K), so an output's accumulation
//   order is the same in both tiles.
// * The combine (launch 3) gives one CTA to each token: its kept choices'
//   ye rows, gate * ye in fp32 added in choice order, one rounding.  No
//   float atomics anywhere: reruns and graph replays are bitwise equal.
// * The pair list itself is built here too, from the routing's top-k
//   experts (moe_pairs_launch: two small launches, a warp a routing group
//   ranking its choices by expert, then a CTA a group scanning the counts
//   and placing them), in place of a global sort and some twenty small
//   PyTorch launches a layer.
//
// The entry points allocate nothing and do not synchronise.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stddef.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

using bf16 = __nv_bfloat16;
using hopper::smem_addr;

constexpr int kMaxTopK = 16;

struct Params {
  const bf16* x;        // (T, d): the tokens, launch 1's rows by token index
  const bf16* w_gate;   // (E, d, ff)
  const bf16* w_up;     // (E, d, ff)
  const bf16* w_down;   // (E, ff, d)
  const int* rows;      // (P,): each sorted pair's token
  const int* offsets;   // (E + 1,): expert e's pairs are [offsets[e], offsets[e + 1])
  const int* pos;       // (T, k): each choice's sorted position, -1 if dropped
  const float* gates;   // (T, k), rows gates_ld apart
  bf16* h;              // (P, ff)
  bf16* ye;             // (P, d)
  bf16* y;              // (T, d)
  int T, k, E, d, ff, gates_ld;
};

// BM x BN output tile of NB products sharing the A rows (2: gate and up;
// 1: down), BK-deep stages, WARPS_M x WARPS_N warps.
template <int BM_, int BN_, int BK_, int STAGES_, int WARPS_M_, int WARPS_N_, int NB_>
struct Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_, NB = NB_;
  static constexpr int WARPS_M = WARPS_M_, WARPS_N = WARPS_N_;
  static constexpr int kThreads = 32 * WARPS_M * WARPS_N;
  static constexpr int WM = BM / WARPS_M, WN = BN / WARPS_N;  // a warp's rows and columns
  static constexpr int MT = WM / 16, NT = WN / 8;             // its m16 and n8 tiles
  // +8 bf16 (16 bytes) a row spreads ldmatrix rows over the banks and keeps
  // every row 16-byte aligned.
  static constexpr int LDA = BK + 8, LDB = BN + 8;
  static constexpr int kStageA = BM * LDA, kStageB = BK * LDB;
  static constexpr int kStage = kStageA + NB * kStageB;
  static constexpr size_t kSmemBytes = (size_t)STAGES * kStage * sizeof(bf16);
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "m16n8k16 tiles, x4 ldmatrix");
  static_assert(NB == 1 || NB == 2, "one or two products");
};

// kernel.py's TILES mirror these (rows a tile takes, for the grid).
using ThinGateUp = Tile<16, 64, 64, 4, 1, 4, 2>;
using ThinDown = Tile<16, 64, 64, 6, 1, 4, 1>;
using WideGateUp = Tile<128, 64, 64, 3, 2, 2, 2>;
using WideDown = Tile<128, 128, 64, 3, 2, 2, 1>;

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
__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_addr(p)));
}
// d (16 x 8 fp32) += a (16 x 16 bf16, row) @ b (16 x 8 bf16, col)
__device__ __forceinline__ void mma_16816(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                          uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One BK-deep stage: the tile's A rows (launch 1: x's rows of the tokens in
// `arow`; launch 2: h's rows row0..) and each product's (BK x BN) block of
// its (K, N) weight.  K and N are multiples of 8, so every 16-byte chunk
// is wholly in or out of its matrix; chunks outside, and the rows past the
// expert's last, are zero-filled.
template <typename Tl, bool GATHER>
__device__ __forceinline__ void load_stage(bf16* st, const bf16* __restrict__ A,
                                           const int* arow, size_t row0, int nrows,
                                           const bf16* __restrict__ B0,
                                           const bf16* __restrict__ B1, int K, int N, int col0,
                                           int k0) {
  constexpr int CA = Tl::BK / 8;
  for (int idx = threadIdx.x; idx < Tl::BM * CA; idx += Tl::kThreads) {
    const int r = idx / CA, c = (idx % CA) * 8;
    const bool in = r < nrows && k0 + c < K;
    const size_t row = GATHER ? (size_t)(in ? arow[r] : 0) : row0 + r;
    cp_async16(st + r * Tl::LDA + c, in ? A + row * K + k0 + c : A, in ? 16 : 0);
  }
  constexpr int CB = Tl::BN / 8;
  bf16* sb = st + Tl::kStageA;
  for (int idx = threadIdx.x; idx < Tl::BK * CB; idx += Tl::kThreads) {
    const int r = idx / CB, c = (idx % CB) * 8;
    const bool in = k0 + r < K && col0 + c < N;
    const size_t off = (size_t)(k0 + r) * N + col0 + c;
    cp_async16(sb + r * Tl::LDB + c, in ? B0 + off : B0, in ? 16 : 0);
    if constexpr (Tl::NB == 2)
      cp_async16(sb + Tl::kStageB + r * Tl::LDB + c, in ? B1 + off : B1, in ? 16 : 0);
  }
}

// One 16-deep step's mma fragments of a warp: A for each m16 tile, B for
// each product and pair of n8 tiles.
template <typename Tl>
struct Frags {
  uint32_t a[Tl::MT][4];
  uint32_t b[Tl::NB][Tl::NT / 2][4];
};

// The fragments of step kk from a stage: A (m 0-7, k 0-7), (m 8-15, k 0-7),
// (m 0-7, k 8-15), (m 8-15, k 8-15); B per pair of n8 tiles (k 0-7, n 0-7),
// (k 8-15, n 0-7), (k 0-7, n 8-15), (k 8-15, n 8-15), stored (k, n):
// transposed on load.  m16 tiles past the tile's rows are not loaded.
template <typename Tl>
__device__ __forceinline__ void load_frags(Frags<Tl>& f, const bf16* a_st, const bf16* b_st,
                                           int kk, int wm, int wn, int lane, int nrows) {
  const int j = lane / 8;
#pragma unroll
  for (int nb = 0; nb < Tl::NB; ++nb)
#pragma unroll
    for (int q = 0; q < Tl::NT / 2; ++q) {
      const int n = wn * Tl::WN + q * 16 + (j / 2) * 8, k = kk + (j % 2) * 8;
      ldmatrix_x4_trans(f.b[nb][q], b_st + nb * Tl::kStageB + (k + lane % 8) * Tl::LDB + n);
    }
#pragma unroll
  for (int mt = 0; mt < Tl::MT; ++mt) {
    if (wm * Tl::WM + mt * 16 < nrows) {
      const int m = wm * Tl::WM + mt * 16 + (j % 2) * 8, k = kk + (j / 2) * 8;
      ldmatrix_x4(f.a[mt], a_st + (m + lane % 8) * Tl::LDA + k);
    }
  }
}

// Launch 1 (GATE_UP): h[p] = bf16(silu(bf16(x_t W_gate[e])) * bf16(x_t W_up[e]))
// for the pairs p of expert e in this row tile, t = rows[p].  Launch 2:
// ye[p] = bf16(h[p] W_down[e]).  Grid (row tiles, column tiles, E).
template <typename Tl, bool GATE_UP>
__global__ void __launch_bounds__(Tl::kThreads) expert_kernel(const Params p) {
  constexpr int BM = Tl::BM, BN = Tl::BN, BK = Tl::BK, STAGES = Tl::STAGES, NB = Tl::NB;
  constexpr int MT = Tl::MT, NT = Tl::NT, WM = Tl::WM, WN = Tl::WN;
  static_assert(NB == (GATE_UP ? 2 : 1), "gate and up, or down");
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* stages = reinterpret_cast<bf16*>(smem);
  __shared__ int arow[GATE_UP ? BM : 1];

  const int e = blockIdx.z;
  const int seg0 = p.offsets[e], seg1 = p.offsets[e + 1];
  const int row0 = seg0 + blockIdx.x * BM;
  if (row0 >= seg1) return;  // no rows here: load nothing
  const int nrows = min(BM, seg1 - row0);
  const int col0 = blockIdx.y * BN;
  const int K = GATE_UP ? p.d : p.ff, N = GATE_UP ? p.ff : p.d;
  const size_t wsize = (size_t)p.d * p.ff;
  const bf16* B0 = (GATE_UP ? p.w_gate : p.w_down) + (size_t)e * wsize;
  const bf16* B1 = GATE_UP ? p.w_up + (size_t)e * wsize : nullptr;
  const bf16* A = GATE_UP ? p.x : p.h;
  if constexpr (GATE_UP) {
    for (int r = threadIdx.x; r < BM; r += Tl::kThreads) arow[r] = r < nrows ? p.rows[row0 + r] : 0;
    __syncthreads();
  }

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int wm = warp / Tl::WARPS_N, wn = warp % Tl::WARPS_N;
  const int nk = (K + BK - 1) / BK;

  float acc[NB][MT][NT][4];
#pragma unroll
  for (int b = 0; b < NB; ++b)
#pragma unroll
    for (int i = 0; i < MT; ++i)
#pragma unroll
      for (int j = 0; j < NT; ++j)
#pragma unroll
        for (int v = 0; v < 4; ++v) acc[b][i][j][v] = 0.f;

#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < nk)
      load_stage<Tl, GATE_UP>(stages + s * Tl::kStage, A, arow, (size_t)row0, nrows, B0, B1, K,
                              N, col0, s * BK);
    cp_async_commit();  // empty groups keep the group count in step
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies for block kt have landed
    __syncthreads();              // everyone's have, and block kt-1's stage is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk)
      load_stage<Tl, GATE_UP>(stages + (nxt % STAGES) * Tl::kStage, A, arow, (size_t)row0,
                              nrows, B0, B1, K, N, col0, nxt * BK);
    cp_async_commit();
    const bf16* a_st = stages + (kt % STAGES) * Tl::kStage;
    const bf16* b_st = a_st + Tl::kStageA;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      Frags<Tl> f;
      load_frags<Tl>(f, a_st, b_st, kk, wm, wn, lane, nrows);
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (wm * WM + mt * 16 < nrows) {  // uniform over the warp: skip empty row tiles
#pragma unroll
          for (int nb = 0; nb < NB; ++nb)
#pragma unroll
            for (int q = 0; q < NT / 2; ++q) {
              mma_16816(acc[nb][mt][2 * q], f.a[mt], f.b[nb][q][0], f.b[nb][q][1]);
              mma_16816(acc[nb][mt][2 * q + 1], f.a[mt], f.b[nb][q][2], f.b[nb][q][3]);
            }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Fragment (mt, nt): rows mt*16 + lane/4 (+8), columns nt*8 + 2 (lane%4) (+1).
  bf16* out = GATE_UP ? p.h : p.ye;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = wm * WM + mt * 16 + lane / 4;
      const int c = col0 + wn * WN + nt * 8 + (lane % 4) * 2;
      if (c >= N) continue;
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        if (r + 8 * half >= nrows) continue;
        float v0 = acc[0][mt][nt][2 * half], v1 = acc[0][mt][nt][2 * half + 1];
        if constexpr (GATE_UP) {
          // each product rounded to bf16, then SiLU(gate) * up in fp32
          const float g0 = round_bf16(v0), g1 = round_bf16(v1);
          const float u0 = round_bf16(acc[NB - 1][mt][nt][2 * half]);
          const float u1 = round_bf16(acc[NB - 1][mt][nt][2 * half + 1]);
          v0 = g0 / (1.f + expf(-g0)) * u0;
          v1 = g1 / (1.f + expf(-g1)) * u1;
        }
        *reinterpret_cast<__nv_bfloat162*>(out + (size_t)(row0 + r + 8 * half) * N + c) =
            __floats2bfloat162_rn(v0, v1);
      }
    }
}

// 8 bf16 -> 8 fp32, exactly: a bf16 is the top half of its fp32.
__device__ __forceinline__ void unpack8(const uint4& u, float (&f)[8]) {
  const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(w[i] << 16);
    f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

// Two fp32 -> one word of two bf16, the first in the low half (unpack8's order).
__device__ __forceinline__ unsigned pack2(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&v);
}

constexpr int kCombineThreads = 128;

// Launch 3, one CTA a token: y_t = bf16(sum over its kept choices c, in
// choice order, of gates[t, c] * ye[pos[t, c]]), fp32 products and sums.
__global__ void __launch_bounds__(kCombineThreads) combine_kernel(const Params p) {
  __shared__ int q[kMaxTopK];
  __shared__ float g[kMaxTopK];
  const int t = blockIdx.x;
  if (threadIdx.x < p.k) {
    q[threadIdx.x] = p.pos[(size_t)t * p.k + threadIdx.x];
    g[threadIdx.x] = p.gates[(size_t)t * p.gates_ld + threadIdx.x];
  }
  __syncthreads();
  for (int v = threadIdx.x; v < p.d / 8; v += kCombineThreads) {
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int c = 0; c < p.k; ++c) {
      if (q[c] < 0) continue;  // dropped
      float f[8];
      unpack8(__ldg(reinterpret_cast<const uint4*>(p.ye + (size_t)q[c] * p.d + v * 8)), f);
#pragma unroll
      for (int i = 0; i < 8; ++i) acc[i] = __fadd_rn(acc[i], __fmul_rn(g[c], f[i]));
    }
    *reinterpret_cast<uint4*>(p.y + (size_t)t * p.d + v * 8) =
        make_uint4(pack2(acc[0], acc[1]), pack2(acc[2], acc[3]), pack2(acc[4], acc[5]),
                   pack2(acc[6], acc[7]));
  }
}

// --- The pair list -----------------------------------------------------------
// layers/moe.py's pairs() on the device: the routing's choices idx (T, k)
// int64, rows idx_ld apart, tokens in routing groups of g; a choice's slot
// is the count of its group's earlier choices of the same expert,
// choice-major (every token's choice 0, then choice 1, ...), and it is
// kept below cap.  rows lists the kept pairs' tokens by expert, group by
// group, slot by slot; offsets (E + 1) bound each expert's; pos (T, k) is
// each choice's place in rows, -1 if dropped.

constexpr int kPairThreads = 128;

// P1, one warp a group: each choice's slot (-1 past cap) into slot (N, k g),
// and the group's kept choices of each expert into kept (N, E).  Lanes
// with the same expert rank among themselves (match.any), then add the
// expert's running count (shared memory, E ints).
__global__ void __launch_bounds__(32) slots_kernel(const long long* __restrict__ idx,
                                                   int idx_ld, int g, int k, int E, int cap,
                                                   int* __restrict__ slot,
                                                   int* __restrict__ kept) {
  extern __shared__ int cnt[];
  const int n = blockIdx.x, lane = threadIdx.x, total = k * g;
  for (int e = lane; e < E; e += 32) cnt[e] = 0;
  __syncwarp();
  for (int base = 0; base < total; base += 32) {
    const int j = base + lane, c = j / g, t = j % g;
    const bool live = j < total;
    const int e = live ? (int)idx[(size_t)(n * g + t) * idx_ld + c] : -1;
    const unsigned same = __match_any_sync(0xffffffffu, e);
    const int rank = __popc(same & ((1u << lane) - 1));
    const int s = live ? cnt[e] + rank : 0;
    __syncwarp();
    if (live && rank == 0) cnt[e] += __popc(same);
    __syncwarp();
    if (live) slot[(size_t)n * total + j] = s < cap ? s : -1;
  }
  for (int e = lane; e < E; e += 32) kept[(size_t)n * E + e] = min(cnt[e], cap);
}

// P2, one CTA a group n: each expert's kept pairs in all groups and in the
// groups before n (a thread an expert, summing kept's columns), their
// exclusive scan over the experts, offsets[e]; then each kept choice's
// place offsets[e] + (expert e's pairs in groups before n) + slot: rows[place]
// = its token, pos[token][c] = place (or -1).  Every CTA sums the same
// counts, N^2 E reads in all (64^2 x 64 at a batch-64 decode, 128^2 x 64 in
// a prefill slice of 256-token groups), which costs less than a launch of
// its own; CTA 0 writes offsets.
__global__ void __launch_bounds__(kPairThreads) place_kernel(
    const long long* __restrict__ idx, int idx_ld, int N, int g, int k, int E,
    const int* __restrict__ slot, const int* __restrict__ kept, int* __restrict__ offsets,
    int* __restrict__ rows, int* __restrict__ pos) {
  extern __shared__ int sh[];
  int* first = sh;        // (E + 1): the scan of the experts' totals
  int* before = sh + E + 1;  // (E): expert e's kept pairs in groups before n
  const int n = blockIdx.x, total = k * g;
  for (int e = threadIdx.x; e < E; e += kPairThreads) {
    int all = 0, pre = 0;
    for (int m = 0; m < N; ++m) {
      const int v = kept[(size_t)m * E + e];
      pre += m < n ? v : 0;
      all += v;
    }
    first[e] = all;
    before[e] = pre;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int acc = 0;
    for (int e = 0; e < E; ++e) {
      const int v = first[e];
      first[e] = acc;
      acc += v;
    }
    first[E] = acc;
  }
  __syncthreads();
  if (n == 0)
    for (int e = threadIdx.x; e <= E; e += kPairThreads) offsets[e] = first[e];
  for (int j = threadIdx.x; j < total; j += kPairThreads) {
    const int c = j / g, t = j % g, tok = n * g + t;
    const int s = slot[(size_t)n * total + j];
    int dest = -1;
    if (s >= 0) {
      const int e = (int)idx[(size_t)tok * idx_ld + c];
      dest = first[e] + before[e] + s;
      rows[dest] = tok;
    }
    pos[(size_t)tok * k + c] = dest;
  }
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

template <typename Tl, bool GATE_UP>
cudaError_t launch_experts(const Params& p, int max_rows, cudaStream_t stream) {
  auto kern = expert_kernel<Tl, GATE_UP>;
  static bool opted_in[64] = {};
  cudaError_t e = opt_in_smem(kern, Tl::kSmemBytes, opted_in);
  if (e != cudaSuccess) return e;
  const int n = GATE_UP ? p.ff : p.d;
  const dim3 grid((max_rows + Tl::BM - 1) / Tl::BM, (n + Tl::BN - 1) / Tl::BN, p.E);
  if (grid.y > 65535 || grid.z > 65535) return cudaErrorInvalidConfiguration;
  kern<<<grid, Tl::kThreads, Tl::kSmemBytes, stream>>>(p);
  return cudaGetLastError();
}

template <typename GateUp, typename Down>
cudaError_t launch_all(const Params& p, int max_rows, cudaStream_t stream) {
  cudaError_t e = launch_experts<GateUp, true>(p, max_rows, stream);
  if (e != cudaSuccess) return e;
  e = launch_experts<Down, false>(p, max_rows, stream);
  if (e != cudaSuccess) return e;
  combine_kernel<<<p.T, kCombineThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// The pair list of the choices idx (T, k) int64, rows idx_ld apart, in
// routing groups of g tokens with capacity cap, over E <= 1024 experts
// (module note): rows (T k) int32, offsets (E + 1) int32, pos (T, k)
// int32; scratch slot (T k) and kept (T / g, E) int32.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int moe_pairs_launch(const void* idx, int idx_ld, int T, int k, int g, int E, int cap,
                     void* rows, void* offsets, void* pos, void* slot, void* kept,
                     void* stream) {
  if (T <= 0 || k <= 0 || k > E || g <= 0 || T % g || E > 1024 || cap <= 0 || idx_ld < k)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int N = T / g;
  const long long* ix = static_cast<const long long*>(idx);
  slots_kernel<<<N, 32, E * sizeof(int), st>>>(ix, idx_ld, g, k, E, cap,
                                               static_cast<int*>(slot), static_cast<int*>(kept));
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  place_kernel<<<N, kPairThreads, (2 * E + 1) * sizeof(int), st>>>(
      ix, idx_ld, N, g, k, E, static_cast<const int*>(slot), static_cast<const int*>(kept),
      static_cast<int*>(offsets), static_cast<int*>(rows), static_cast<int*>(pos));
  return (int)cudaGetLastError();
}

// y = the routed experts' SwiGLU of x over a pair list (module note): x (T,
// d), w_gate / w_up (E, d, ff), w_down (E, ff, d), h (P, ff), ye (P, d) and
// y (T, d) contiguous bf16 with 16-byte aligned bases, d and ff multiples
// of 8; rows (P,), offsets (E + 1,) and pos (T, k) int32, gates (T, k)
// fp32 with rows gates_ld apart, P = T * k, 1 <= k <= 16.  max_rows bounds
// any expert's rows (the grid's row tiles); tile 0 is the thin tiling, 1
// the wide one.  Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when all three launches were accepted).
int moe_experts_launch(const void* x, const void* w_gate, const void* w_up, const void* w_down,
                       const void* rows, const void* offsets, const void* pos,
                       const void* gates, int gates_ld, void* h, void* ye, void* y, int T, int k,
                       int E, int d, int ff, int max_rows, int tile, void* stream) {
  if (T <= 0 || k <= 0 || k > kMaxTopK || k > E || d <= 0 || ff <= 0 || d % 8 || ff % 8 ||
      max_rows <= 0 || max_rows > T || gates_ld < k)
    return (int)cudaErrorInvalidValue;
  if (!(aligned16(x) && aligned16(w_gate) && aligned16(w_up) && aligned16(w_down) &&
        aligned16(h) && aligned16(ye) && aligned16(y)))
    return (int)cudaErrorMisalignedAddress;
  Params p{static_cast<const bf16*>(x), static_cast<const bf16*>(w_gate),
           static_cast<const bf16*>(w_up), static_cast<const bf16*>(w_down),
           static_cast<const int*>(rows), static_cast<const int*>(offsets),
           static_cast<const int*>(pos), static_cast<const float*>(gates),
           static_cast<bf16*>(h), static_cast<bf16*>(ye), static_cast<bf16*>(y),
           T, k, E, d, ff, gates_ld};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (tile == 0) return (int)launch_all<ThinGateUp, ThinDown>(p, max_rows, st);
  if (tile == 1) return (int)launch_all<WideGateUp, WideDown>(p, max_rows, st);
  return (int)cudaErrorInvalidValue;
}

const char* moe_experts_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
