// K1's thin route: split-K streaming Z-order matmul for Hopper (sm_90a),
// C = A @ B in bf16 with fp32 accumulation, for products with few rows.
//
// Replaces src/repro/kernels/matmul/kernel.py:46 (zorder_matmul, the Pallas
// TPU kernel, body _matmul_kernel) for bf16 products with few rows: decode
// (m = batch, 4-8) and serving prefill (m = batch x bucket, 64).  Same
// function: A (m, k) @ B (k, n), fp32 accumulator, one rounding.
//
// Bound.  With a few rows the product does m operations per weight byte,
// far below the card's 295, so the least time is the weight bytes at the
// memory rate (3.35 TB/s).  What holds the time there is how many bytes are
// in flight, not the tensor-core rate.  What the design does about it:
//
// * Split-K.  A tile of n columns alone gives n/64 CTAs (8 at n = 512),
//   each walking all of k.  Here each output tile's k range is cut into
//   `splits` slices of `kb_per` 64-deep blocks (kernel.py's split_plan, a
//   pure function of k, n and the SM count), so each of decode's products
//   launches one or two CTAs per SM, in one wave, and all 132 SMs stream
//   weights at once.
// * Streaming.  Each CTA streams its (k slice x 64 columns) of B with
//   16-byte cp.async copies, up to STAGES - 1 blocks of 8 KB (56 KB at
//   decode) kept in flight, and multiplies with mma.sync m16n8k16 (bf16
//   in, fp32 out) from ldmatrix fragments; the tensor cores are idle most
//   of the time, as they must be.
// * A fixed reduction order.  Each CTA writes its fp32 partial tile to a
//   workspace (allocated by the wrapper); the last CTA of a tile to finish,
//   found with a per-tile counter that it resets to 0, sums splits 0..S-1
//   in that order (all splits' loads in flight) and rounds once.  No float
//   atomics touch the output, so the result is bitwise the same in every
//   run, whichever CTA is last.
// * The tile order is the Morton table (blockIdx.x), split index
//   blockIdx.y; both orders give bitwise-equal outputs.
// * Either operand may be stored transposed (the .t() of a row-major
//   tensor: a tied embedding as the LM head, the backward's B^T and A^T),
//   and is read in place: chunks are copied along each operand's rows as
//   stored, and ldmatrix takes its fragments with or without .trans, so
//   no transposed copy is ever made.
//
// The entry point allocates nothing and does not synchronise, so a CUDA
// graph captures it.  Operands that 16-byte copies cannot take (a stored
// row or n not a multiple of 8 long, a base not 16-byte aligned) go to
// zorder_matmul.cu's wmma kernel, as row-major copies; this entry point
// refuses them.
#include <stddef.h>

#include "zorder_common.cuh"

namespace {

using namespace zorder;

// At most this many partials per output (kernel.py's MAX_SPLITS): the last
// CTA of a tile keeps one load per split in flight.
constexpr int kMaxSplits = 16;

// AT: A stored transposed, as (k, m) row-major; BT: B stored as (n, k).
template <int BM_, int BN_, int BK_, int STAGES_, bool AT_ = false, bool BT_ = false>
struct ThinTile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, STAGES = STAGES_;
  static constexpr bool AT = AT_, BT = BT_;
  static constexpr int MT = BM / 16;        // m16 row tiles
  static constexpr int kThreads = 128;      // 4 warps, BN / 4 columns each
  static constexpr int WN = BN / 4, NT = WN / 8;  // a warp's columns, its n8 tiles
  // Each stage holds the blocks as stored: A (BM x BK), or (BK x BM) when
  // AT; B (BK x BN), or (BN x BK) when BT.  +8 bf16 (16 bytes) per row
  // spreads ldmatrix rows over the banks and keeps every row 16-byte
  // aligned.
  static constexpr int LDA = (AT ? BM : BK) + 8, LDB = (BT ? BK : BN) + 8;
  static constexpr int kStageA = (AT ? BK : BM) * LDA, kStageB = (BT ? BN : BK) * LDB;
  static constexpr size_t kSmemBytes = (size_t)STAGES * (kStageA + kStageB) * sizeof(bf16);
  static_assert(BM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "m16n8k16 tiles, x4 ldmatrix");
  template <bool A2, bool B2> using Layout = ThinTile<BM_, BN_, BK_, STAGES_, A2, B2>;
};

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

// One 64-deep block: A rows row0.., B columns col0.., k from k0, each
// copied as stored.  The stored rows are multiples of 8 long (k or m for A,
// n or k for B), so every 16-byte chunk is wholly in or out of the matrix;
// chunks outside are zero-filled.
template <typename Tile>
__device__ __forceinline__ void load_block(bf16* As, bf16* Bs, const bf16* __restrict__ A,
                                           const bf16* __restrict__ B, int M, int N, int K,
                                           int row0, int col0, int k0) {
  if constexpr (Tile::AT) {  // BK rows of k, BM columns of m
    constexpr int C = Tile::BM / 8;  // 16-byte chunks in a row
    for (int idx = threadIdx.x; idx < Tile::BK * C; idx += Tile::kThreads) {
      const int r = idx / C, c = (idx % C) * 8;
      const bool in = k0 + r < K && row0 + c < M;
      cp_async16(As + r * Tile::LDA + c, in ? A + (size_t)(k0 + r) * M + row0 + c : A,
                 in ? 16 : 0);
    }
  } else {  // BM rows of m, BK columns of k
    constexpr int C = Tile::BK / 8;
    for (int idx = threadIdx.x; idx < Tile::BM * C; idx += Tile::kThreads) {
      const int r = idx / C, c = (idx % C) * 8;
      const bool in = row0 + r < M && k0 + c < K;
      cp_async16(As + r * Tile::LDA + c, in ? A + (size_t)(row0 + r) * K + k0 + c : A,
                 in ? 16 : 0);
    }
  }
  if constexpr (Tile::BT) {  // BN rows of n, BK columns of k
    constexpr int C = Tile::BK / 8;
    for (int idx = threadIdx.x; idx < Tile::BN * C; idx += Tile::kThreads) {
      const int r = idx / C, c = (idx % C) * 8;
      const bool in = col0 + r < N && k0 + c < K;
      cp_async16(Bs + r * Tile::LDB + c, in ? B + (size_t)(col0 + r) * K + k0 + c : B,
                 in ? 16 : 0);
    }
  } else {  // BK rows of k, BN columns of n
    constexpr int C = Tile::BN / 8;
    for (int idx = threadIdx.x; idx < Tile::BK * C; idx += Tile::kThreads) {
      const int r = idx / C, c = (idx % C) * 8;
      const bool in = k0 + r < K && col0 + c < N;
      cp_async16(Bs + r * Tile::LDB + c, in ? B + (size_t)(k0 + r) * N + col0 + c : B,
                 in ? 16 : 0);
    }
  }
}

template <typename Tile, typename TOut>
__global__ void __launch_bounds__(Tile::kThreads)
    zorder_matmul_thin_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                              TOut* __restrict__ C, float* __restrict__ ws, int* counters,
                              const int* __restrict__ tiles, int ntiles, int M, int N, int K,
                              int splits, int kb_per) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK, STAGES = Tile::STAGES;
  constexpr int MT = Tile::MT, NT = Tile::NT, WN = Tile::WN;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * Tile::kStageA;
  __shared__ int last;

  const int s = blockIdx.x, split = blockIdx.y;
  const int row0 = tiles[s] * BM, col0 = tiles[ntiles + s] * BN;
  const int nkb = (K + BK - 1) / BK;
  const int kb0 = min(split * kb_per, nkb), nk = min(kb0 + kb_per, nkb) - kb0;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  float acc[MT][NT][4];
#pragma unroll
  for (int i = 0; i < MT; ++i)
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_block<Tile>(As + st * Tile::kStageA, Bs + st * Tile::kStageB, A, B, M, N, K, row0, col0,
                       (kb0 + st) * BK);
    cp_async_commit();  // empty groups keep the group count in step
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies for block kt have landed
    __syncthreads();              // everyone's have, and block kt-1's stage is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      const int st = nxt % STAGES;
      load_block<Tile>(As + st * Tile::kStageA, Bs + st * Tile::kStageB, A, B, M, N, K, row0, col0,
                       (kb0 + nxt) * BK);
    }
    cp_async_commit();
    const bf16* a_st = As + (kt % STAGES) * Tile::kStageA;
    const bf16* b_st = Bs + (kt % STAGES) * Tile::kStageB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      // B, per pair of n8 tiles: matrices (k 0-7, n 0-7), (k 8-15, n 0-7),
      // (k 0-7, n 8-15), (k 8-15, n 8-15); stored (k, n) they are
      // transposed on load, stored (n, k) they are the mma's layout already.
      uint32_t b[NT / 2][4];
      const int j = lane / 8;
#pragma unroll
      for (int p = 0; p < NT / 2; ++p) {
        const int n = warp * WN + p * 16 + (j / 2) * 8, k = kk + (j % 2) * 8;
        if constexpr (Tile::BT)
          ldmatrix_x4(b[p], b_st + (n + lane % 8) * Tile::LDB + k);
        else
          ldmatrix_x4_trans(b[p], b_st + (k + lane % 8) * Tile::LDB + n);
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (row0 + mt * 16 < M) {  // uniform over the CTA
          // A: matrices (m 0-7, k 0-7), (m 8-15, k 0-7), (m 0-7, k 8-15),
          // (m 8-15, k 8-15); stored (k, m) they are transposed on load.
          uint32_t a[4];
          const int m = mt * 16 + (j % 2) * 8, k = kk + (j / 2) * 8;
          if constexpr (Tile::AT)
            ldmatrix_x4_trans(a, a_st + (k + lane % 8) * Tile::LDA + m);
          else
            ldmatrix_x4(a, a_st + (m + lane % 8) * Tile::LDA + k);
#pragma unroll
          for (int p = 0; p < NT / 2; ++p) {
            mma_16816(acc[mt][2 * p], a, b[p][0], b[p][1]);
            mma_16816(acc[mt][2 * p + 1], a, b[p][2], b[p][3]);
          }
        }
      }
    }
  }
  cp_async_wait<0>();

  // Fragment (mt, nt): rows mt*16 + lane/4 (+8), columns warp*WN + nt*8 +
  // 2 (lane%4) (+1).
  const size_t mn = (size_t)M * N;
  if (splits == 1) {
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int nt = 0; nt < NT; ++nt) {
        const int r = row0 + mt * 16 + lane / 4, c = col0 + warp * WN + nt * 8 + (lane % 4) * 2;
        if (c < N) {
          if (r < M) store_pair(C + (size_t)r * N + c, acc[mt][nt][0], acc[mt][nt][1]);
          if (r + 8 < M) store_pair(C + (size_t)(r + 8) * N + c, acc[mt][nt][2], acc[mt][nt][3]);
        }
      }
    return;
  }
  float* part = ws + (size_t)split * mn;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int r = row0 + mt * 16 + lane / 4, c = col0 + warp * WN + nt * 8 + (lane % 4) * 2;
      if (c < N) {
        if (r < M) store_pair(part + (size_t)r * N + c, acc[mt][nt][0], acc[mt][nt][1]);
        if (r + 8 < M) store_pair(part + (size_t)(r + 8) * N + c, acc[mt][nt][2], acc[mt][nt][3]);
      }
    }
  __threadfence();  // this CTA's partial is visible before it is counted
  __syncthreads();
  if (threadIdx.x == 0) last = atomicAdd(&counters[s], 1) == splits - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // Sum the splits in order, four columns a thread, two groups of four
  // at a time with every split's loads in flight (n is a multiple of 8, so
  // a group is wholly in or out of the matrix and 16-byte aligned).
  constexpr int G = BM * BN / 4, U = 2;
  for (int base = threadIdx.x; base < G; base += U * Tile::kThreads) {
    float4 v[U][kMaxSplits];
    const float* p[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int idx = base + u * Tile::kThreads;
      const int r = row0 + idx / (BN / 4), c = col0 + (idx % (BN / 4)) * 4;
      p[u] = idx < G && r < M && c < N ? ws + (size_t)r * N + c : nullptr;
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)
        if (p[u] != nullptr && sp < splits)
          v[u][sp] = __ldcg(reinterpret_cast<const float4*>(p[u] + sp * mn));
    }
#pragma unroll
    for (int u = 0; u < U; ++u) {
      if (p[u] == nullptr) continue;
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
      for (int sp = 0; sp < kMaxSplits; ++sp)  // fixed order: splits 0, 1, ..., S-1
        if (sp < splits) sum.x += v[u][sp].x, sum.y += v[u][sp].y, sum.z += v[u][sp].z,
                         sum.w += v[u][sp].w;
      TOut* out = C + (p[u] - ws);  // the same (row, column) in C
      store_pair(out, sum.x, sum.y);
      store_pair(out + 2, sum.z, sum.w);
    }
  }
  if (threadIdx.x == 0) counters[s] = 0;  // zero again for the next launch
}

// ---------------------------------------------------------------------------
// Host side: the compiled tiles (kernel.py's BLOCKS and smem_bytes mirror them).
// ---------------------------------------------------------------------------

// Deep enough that a CTA of the one-wave split plan has most of its k slice
// in flight at once, shallow enough for two CTAs per SM.
using Thin16 = ThinTile<16, 64, 64, 8>;  // decode: m <= 16
using Thin64 = ThinTile<64, 64, 64, 6>;  // serving prefill: 16 < m <= kernel.py's THIN_MAX_M

template <typename Tile, typename TOut>
cudaError_t launch_thin(const void* a, const void* b, void* c, float* ws, int* counters,
                        const int* tiles, int ntiles, int m, int n, int k, int splits, int kb_per,
                        cudaStream_t stream) {
  auto kern = zorder_matmul_thin_kernel<Tile, TOut>;
  static bool opted_in[64] = {};
  cudaError_t e = opt_in_smem(kern, Tile::kSmemBytes, opted_in);
  if (e != cudaSuccess) return e;
  kern<<<dim3(ntiles, splits), Tile::kThreads, Tile::kSmemBytes, stream>>>(
      static_cast<const bf16*>(a), static_cast<const bf16*>(b), static_cast<TOut*>(c), ws,
      counters, tiles, ntiles, m, n, k, splits, kb_per);
  return cudaGetLastError();
}

template <typename Tile>
cudaError_t dispatch_out(int out_dtype, const void* a, const void* b, void* c, float* ws,
                         int* counters, const int* tiles, int ntiles, int m, int n, int k,
                         int splits, int kb_per, cudaStream_t stream) {
  if (out_dtype == kBF16)
    return launch_thin<Tile, bf16>(a, b, c, ws, counters, tiles, ntiles, m, n, k, splits, kb_per,
                                   stream);
  if (out_dtype == kF32)
    return launch_thin<Tile, float>(a, b, c, ws, counters, tiles, ntiles, m, n, k, splits, kb_per,
                                    stream);
  return cudaErrorInvalidValue;
}

// The tile in the operands' stored layouts.
template <typename Tile>
cudaError_t dispatch_thin(int a_t, int b_t, int out_dtype, const void* a, const void* b, void* c,
                          float* ws, int* counters, const int* tiles, int ntiles, int m, int n,
                          int k, int splits, int kb_per, cudaStream_t stream) {
  using NN = typename Tile::template Layout<false, false>;
  using NT = typename Tile::template Layout<false, true>;
  using TN = typename Tile::template Layout<true, false>;
  using TT = typename Tile::template Layout<true, true>;
  auto go = [&](auto tile) {
    return dispatch_out<decltype(tile)>(out_dtype, a, b, c, ws, counters, tiles, ntiles, m, n, k,
                                        splits, kb_per, stream);
  };
  return a_t ? (b_t ? go(TT{}) : go(TN{})) : (b_t ? go(NT{}) : go(NN{}));
}

}  // namespace

extern "C" {

// C = A @ B for bf16 A (m, k), B (k, n) and a row-major C (m, n) of type
// out_dtype, each output tile's k range cut into `splits` slices of
// `kb_per` 64-deep blocks.  A is row-major (a_t = 0) or stored transposed
// as a row-major (k, m) (a_t = 1); B row-major or stored as (n, k) (b_t =
// 1).  With splits > 1, ws holds splits * m * n fp32 and counters one
// zeroed int32 per tile (left zeroed); both unused with splits = 1.  tiles
// holds 2 * ntiles int32 on the device.  Refuses (cudaErrorInvalidValue)
// stored rows that are not a multiple of 8 long (n, and k or m for A, k
// for a transposed B) and bases not 16-byte aligned.  Launches on
// `stream`, does not synchronise, returns cudaGetLastError().
int zorder_matmul_thin_launch(const void* a, const void* b, void* c, void* ws, void* counters,
                              const int* tiles, int ntiles, int m, int n, int k, int a_t, int b_t,
                              int out_dtype, int bm, int bn, int bk, int splits, int kb_per,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles <= 0 || m <= 0 || n <= 0 || k <= 0 || n % 8 || (a_t ? m % 8 : k % 8) ||
      (b_t && k % 8) || splits <= 0 || kb_per <= 0 || splits > kMaxSplits ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16 ||
      (splits > 1 && (ws == nullptr || counters == nullptr)))
    return (int)cudaErrorInvalidValue;
  float* w = static_cast<float*>(ws);
  int* cnt = static_cast<int*>(counters);
  if (bm == Thin16::BM && bn == Thin16::BN && bk == Thin16::BK)
    return (int)dispatch_thin<Thin16>(a_t, b_t, out_dtype, a, b, c, w, cnt, tiles, ntiles, m, n, k,
                                      splits, kb_per, st);
  if (bm == Thin64::BM && bn == Thin64::BN && bk == Thin64::BK)
    return (int)dispatch_thin<Thin64>(a_t, b_t, out_dtype, a, b, c, w, cnt, tiles, ntiles, m, n, k,
                                      splits, kb_per, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
