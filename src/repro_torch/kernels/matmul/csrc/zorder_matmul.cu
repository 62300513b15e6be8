// K1's wmma route and fp32 route: Z-order block matmul for Hopper (sm_90a),
// C = A @ B with fp32 accumulation.
//
// Replaces src/repro/kernels/matmul/kernel.py:46 (zorder_matmul, the Pallas
// TPU kernel, body _matmul_kernel).  Same function: A (m, k) @ B (k, n), both
// fp32 or both bf16, fp32 accumulator, one rounding to the output type at
// the end.  bf16 products whose operands TMA and 16-byte copies can take run
// the thin route (zorder_matmul_thin.cu, few rows) or the wide route
// (zorder_matmul_wide.cu, many rows); this file keeps the kernels for the
// rest: bf16 with k or n not a multiple of 8 or a base not 16-byte aligned,
// and fp32.  What changes with the machine:
//
// * Tile order.  On the TPU the grid runs in order on one core, so the
//   Morton (Z-order) table was the sequential HBM->VMEM block schedule.  On
//   Hopper the CTAs run in parallel on 132 SMs, so the same table becomes
//   the CTA rasterisation: CTA s computes output tile (tiles[s],
//   tiles[ntiles + s]), and CTAs resident together touch nearby A row
//   panels and B column panels, which is what governs L2 reuse here.  Both
//   orders give bitwise-identical tiles: each tile's k loop is the same.
// * Sequential k.  The TPU carried the accumulator across grid steps in a
//   VMEM scratch; here the k loop runs inside the CTA with the fp32
//   accumulators in registers (wmma fragments for bf16, a per-thread
//   micro-tile for fp32).
// * Ragged edges.  The kernel masks them itself (zero-filled loads, masked
//   stores) instead of padding, which would copy the weights every call.
//
// Bound.  Both are bound as the routes above are (weight bytes with few
// rows, the tensor cores' or FMA rate with many).  This route serves
// shapes no model on the port's paths has, so its design stays simple:
// bf16 tiles stream through shared memory with 16-byte cp.async copies
// where the operands allow it (element copies otherwise), STAGES deep,
// into wmma 16x16x16; a 16-row tile with a deep k step for m <= 16.
//
// fp32 runs on plain FMA, never TF32 (TF32 keeps ~3 decimal digits, which
// cannot meet a 1e-4 relative tolerance).
#include <mma.h>
#include <stddef.h>

#include "zorder_common.cuh"

namespace {

using namespace zorder;
using namespace nvcuda;

// ---------------------------------------------------------------------------
// bf16: wmma 16x16x16 with fp32 accumulators, STAGES-deep cp.async pipeline.
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int WM_, int WN_, int STAGES_>
struct Bf16Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, WM = WM_, WN = WN_, STAGES = STAGES_;
  static constexpr int WARPS_M = BM / WM, WARPS_N = BN / WN;
  static constexpr int kThreads = WARPS_M * WARPS_N * 32;
  // +8 bf16 (16 bytes) per row breaks shared-memory bank aliasing and keeps
  // every wmma pointer 32-byte aligned and every cp.async target 16-byte aligned.
  static constexpr int LDA = BK + 8, LDB = BN + 8, LDC = BN + 4;
  static constexpr int kStageA = BM * LDA, kStageB = BK * LDB;  // elements
  static constexpr size_t kPipeBytes = (size_t)STAGES * (kStageA + kStageB) * sizeof(bf16);
  static constexpr size_t kEpiBytes = (size_t)BM * LDC * sizeof(float);
  static constexpr size_t kSmemBytes = kPipeBytes > kEpiBytes ? kPipeBytes : kEpiBytes;
  static_assert(WM % 16 == 0 && WN % 16 == 0 && BK % 16 == 0, "wmma tiles are 16x16x16");
  static_assert((kStageA * sizeof(bf16)) % 32 == 0 && (kStageB * sizeof(bf16)) % 32 == 0,
                "stage buffers must keep 32-byte alignment");
};

// VEC: k and n are multiples of 8 and both operands 16-byte aligned, so every
// 8-element chunk is either wholly inside the matrix or wholly outside it.
template <typename Tile, bool VEC>
__device__ __forceinline__ void load_stage_bf16(bf16* As, bf16* Bs, const bf16* __restrict__ A,
                                                const bf16* __restrict__ B, int M, int N, int K,
                                                int row0, int col0, int k0) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK;
  constexpr int NT = Tile::kThreads;
  constexpr int ACH = BK / 8, BCH = BN / 8;  // 16-byte chunks per row
  const bf16 zero = __float2bfloat16_rn(0.f);
  for (int idx = threadIdx.x; idx < BM * ACH; idx += NT) {
    const int r = idx / ACH, c = (idx % ACH) * 8;
    const int gr = row0 + r, gc = k0 + c;
    bf16* dst = As + r * Tile::LDA + c;
    if (VEC) {
      const bool in = gr < M && gc < K;
      cp_async16(dst, in ? A + (size_t)gr * K + gc : A, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < M && gc + e < K) ? A[(size_t)gr * K + gc + e] : zero;
    }
  }
  for (int idx = threadIdx.x; idx < BK * BCH; idx += NT) {
    const int r = idx / BCH, c = (idx % BCH) * 8;
    const int gr = k0 + r, gc = col0 + c;
    bf16* dst = Bs + r * Tile::LDB + c;
    if (VEC) {
      const bool in = gr < K && gc < N;
      cp_async16(dst, in ? B + (size_t)gr * N + gc : B, in ? 16 : 0);
    } else {
#pragma unroll
      for (int e = 0; e < 8; ++e)
        dst[e] = (gr < K && gc + e < N) ? B[(size_t)gr * N + gc + e] : zero;
    }
  }
}

template <typename Tile, typename TOut, bool VEC>
__global__ void __launch_bounds__(Tile::kThreads)
    zorder_matmul_bf16_kernel(const bf16* __restrict__ A, const bf16* __restrict__ B,
                              TOut* __restrict__ C, const int* __restrict__ tiles, int ntiles,
                              int M, int N, int K) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK, STAGES = Tile::STAGES;
  constexpr int FM = Tile::WM / 16, FN = Tile::WN / 16;
  extern __shared__ __align__(128) unsigned char smem[];
  bf16* As = reinterpret_cast<bf16*>(smem);
  bf16* Bs = As + STAGES * Tile::kStageA;

  const int s = blockIdx.x;
  const int row0 = tiles[s] * BM, col0 = tiles[ntiles + s] * BN;
  const int warp = threadIdx.x / 32;
  const int wm = warp / Tile::WARPS_N, wn = warp % Tile::WARPS_N;

  wmma::fragment<wmma::accumulator, 16, 16, 16, float> acc[FM][FN];
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j) wmma::fill_fragment(acc[i][j], 0.f);

  const int nk = (K + BK - 1) / BK;
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < nk)
      load_stage_bf16<Tile, VEC>(As + st * Tile::kStageA, Bs + st * Tile::kStageB, A, B, M, N, K,
                                 row0, col0, st * BK);
    cp_async_commit();  // empty groups keep the group count in step
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<STAGES - 2>();  // this thread's copies for tile kt have landed
    __syncthreads();              // everyone's have, and stage kt-1 is free
    const int nxt = kt + STAGES - 1;
    if (nxt < nk) {
      const int st = nxt % STAGES;
      load_stage_bf16<Tile, VEC>(As + st * Tile::kStageA, Bs + st * Tile::kStageB, A, B, M, N, K,
                                 row0, col0, nxt * BK);
    }
    cp_async_commit();
    const bf16* a_st = As + (kt % STAGES) * Tile::kStageA;
    const bf16* b_st = Bs + (kt % STAGES) * Tile::kStageB;
#pragma unroll
    for (int kk = 0; kk < BK; kk += 16) {
      wmma::fragment<wmma::matrix_a, 16, 16, 16, bf16, wmma::row_major> fa[FM];
      wmma::fragment<wmma::matrix_b, 16, 16, 16, bf16, wmma::row_major> fb[FN];
#pragma unroll
      for (int i = 0; i < FM; ++i)
        wmma::load_matrix_sync(fa[i], a_st + (wm * Tile::WM + i * 16) * Tile::LDA + kk, Tile::LDA);
#pragma unroll
      for (int j = 0; j < FN; ++j)
        wmma::load_matrix_sync(fb[j], b_st + kk * Tile::LDB + wn * Tile::WN + j * 16, Tile::LDB);
#pragma unroll
      for (int i = 0; i < FM; ++i)
#pragma unroll
        for (int j = 0; j < FN; ++j) wmma::mma_sync(acc[i][j], fa[i], fb[j], acc[i][j]);
    }
  }

  // Epilogue: stage the fp32 tile in (reused) shared memory, then write the
  // in-bounds part with one rounding to TOut.
  cp_async_wait<0>();
  __syncthreads();
  float* Cs = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int i = 0; i < FM; ++i)
#pragma unroll
    for (int j = 0; j < FN; ++j)
      wmma::store_matrix_sync(Cs + (wm * Tile::WM + i * 16) * Tile::LDC + wn * Tile::WN + j * 16,
                              acc[i][j], Tile::LDC, wmma::mem_row_major);
  __syncthreads();
  for (int idx = threadIdx.x; idx < BM * BN; idx += Tile::kThreads) {
    const int r = idx / BN, c = idx % BN;
    const int gr = row0 + r, gc = col0 + c;
    if (gr < M && gc < N) C[(size_t)gr * N + gc] = from_float<TOut>(Cs[r * Tile::LDC + c]);
  }
}

// ---------------------------------------------------------------------------
// fp32: shared-memory tiles, TM x TN register micro-tile per thread, FMA.
// ---------------------------------------------------------------------------

template <int BM_, int BN_, int BK_, int TM_, int TN_>
struct F32Tile {
  static constexpr int BM = BM_, BN = BN_, BK = BK_, TM = TM_, TN = TN_;
  static constexpr int TX = BN / TN;  // threads along n
  static constexpr int kThreads = (BM / TM) * TX;
  static constexpr size_t kSmemBytes = (size_t)BK * ((BM + 1) + (BN + 1)) * sizeof(float);
  static_assert(kSmemBytes <= 48 * 1024, "static shared memory is capped at 48 KB");
};

template <typename Tile, typename TOut>
__global__ void __launch_bounds__(Tile::kThreads)
    zorder_matmul_f32_kernel(const float* __restrict__ A, const float* __restrict__ B,
                             TOut* __restrict__ C, const int* __restrict__ tiles, int ntiles,
                             int M, int N, int K) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK, TM = Tile::TM, TN = Tile::TN;
  constexpr int NT = Tile::kThreads;
  __shared__ float As[BK][BM + 1];  // k-major: a thread's TM rows read along one k
  __shared__ float Bs[BK][BN + 1];

  const int s = blockIdx.x;
  const int row0 = tiles[s] * BM, col0 = tiles[ntiles + s] * BN;
  const int tx = threadIdx.x % Tile::TX, ty = threadIdx.x / Tile::TX;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int idx = threadIdx.x; idx < BM * BK; idx += NT) {
      const int r = idx / BK, c = idx % BK;
      const int gr = row0 + r, gc = k0 + c;
      As[c][r] = (gr < M && gc < K) ? A[(size_t)gr * K + gc] : 0.f;
    }
    for (int idx = threadIdx.x; idx < BK * BN; idx += NT) {
      const int r = idx / BN, c = idx % BN;
      const int gr = k0 + r, gc = col0 + c;
      Bs[r][c] = (gr < K && gc < N) ? B[(size_t)gr * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = As[kk][ty * TM + i];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = Bs[kk][tx * TN + j];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gr = row0 + ty * TM + i;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gc = col0 + tx * TN + j;
      if (gr < M && gc < N) C[(size_t)gr * N + gc] = from_float<TOut>(acc[i][j]);
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the compiled block shapes (kernel.py's BLOCKS must list the same).
// ---------------------------------------------------------------------------

using Bf16Large = Bf16Tile<64, 64, 32, 32, 32, 4>;   // prefill: m > 16
using Bf16Small = Bf16Tile<16, 64, 128, 16, 16, 4>;  // decode: m <= 16
using F32Large = F32Tile<64, 64, 16, 4, 4>;
using F32Small = F32Tile<16, 64, 32, 1, 4>;

template <typename Tile, typename TOut, bool VEC>
cudaError_t launch_bf16_vec(const void* a, const void* b, void* c, const int* tiles, int ntiles,
                            int m, int n, int k, cudaStream_t stream) {
  auto kern = zorder_matmul_bf16_kernel<Tile, TOut, VEC>;
  const size_t smem = Tile::kSmemBytes;
  static bool opted_in[64] = {};
  cudaError_t e = opt_in_smem(kern, smem, opted_in);
  if (e != cudaSuccess) return e;
  kern<<<ntiles, Tile::kThreads, smem, stream>>>(static_cast<const bf16*>(a),
                                                  static_cast<const bf16*>(b),
                                                  static_cast<TOut*>(c), tiles, ntiles, m, n, k);
  return cudaGetLastError();
}

template <typename Tile, typename TOut>
cudaError_t launch_bf16(const void* a, const void* b, void* c, const int* tiles, int ntiles, int m,
                        int n, int k, cudaStream_t stream) {
  const bool vec = k % 8 == 0 && n % 8 == 0 && reinterpret_cast<uintptr_t>(a) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(b) % 16 == 0;
  return vec ? launch_bf16_vec<Tile, TOut, true>(a, b, c, tiles, ntiles, m, n, k, stream)
             : launch_bf16_vec<Tile, TOut, false>(a, b, c, tiles, ntiles, m, n, k, stream);
}

template <typename Tile, typename TOut>
cudaError_t launch_f32(const void* a, const void* b, void* c, const int* tiles, int ntiles, int m,
                       int n, int k, cudaStream_t stream) {
  zorder_matmul_f32_kernel<Tile, TOut><<<ntiles, Tile::kThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b), static_cast<TOut*>(c), tiles,
      ntiles, m, n, k);
  return cudaGetLastError();
}

template <typename Tile>
bool is_tile(int bm, int bn, int bk) {
  return bm == Tile::BM && bn == Tile::BN && bk == Tile::BK;
}

template <typename Tile>
cudaError_t dispatch_out_bf16(int out_dtype, const void* a, const void* b, void* c,
                              const int* tiles, int ntiles, int m, int n, int k,
                              cudaStream_t stream) {
  if (out_dtype == kBF16) return launch_bf16<Tile, bf16>(a, b, c, tiles, ntiles, m, n, k, stream);
  if (out_dtype == kF32) return launch_bf16<Tile, float>(a, b, c, tiles, ntiles, m, n, k, stream);
  return cudaErrorInvalidValue;
}

template <typename Tile>
cudaError_t dispatch_out_f32(int out_dtype, const void* a, const void* b, void* c,
                             const int* tiles, int ntiles, int m, int n, int k,
                             cudaStream_t stream) {
  if (out_dtype == kF32) return launch_f32<Tile, float>(a, b, c, tiles, ntiles, m, n, k, stream);
  if (out_dtype == kBF16) return launch_f32<Tile, bf16>(a, b, c, tiles, ntiles, m, n, k, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// C = A @ B for row-major contiguous A (m, k), B (k, n), C (m, n).  tiles holds
// 2 * ntiles int32 on the device: the tile rows, then the tile columns, in the
// order CTAs are numbered.  Launches on `stream`, does not synchronise, and
// returns cudaGetLastError() (0 when the launch was accepted).
int zorder_matmul_launch(const void* a, const void* b, void* c, const int* tiles, int ntiles,
                         int m, int n, int k, int in_dtype, int out_dtype, int bm, int bn, int bk,
                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles <= 0 || m <= 0 || n <= 0 || k < 0) return (int)cudaErrorInvalidValue;
  if (in_dtype == kBF16) {
    if (is_tile<Bf16Large>(bm, bn, bk))
      return (int)dispatch_out_bf16<Bf16Large>(out_dtype, a, b, c, tiles, ntiles, m, n, k, st);
    if (is_tile<Bf16Small>(bm, bn, bk))
      return (int)dispatch_out_bf16<Bf16Small>(out_dtype, a, b, c, tiles, ntiles, m, n, k, st);
  } else if (in_dtype == kF32) {
    if (is_tile<F32Large>(bm, bn, bk))
      return (int)dispatch_out_f32<F32Large>(out_dtype, a, b, c, tiles, ntiles, m, n, k, st);
    if (is_tile<F32Small>(bm, bn, bk))
      return (int)dispatch_out_f32<F32Small>(out_dtype, a, b, c, tiles, ntiles, m, n, k, st);
  }
  return (int)cudaErrorInvalidValue;
}

const char* zorder_matmul_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
