// K1's wide route: persistent, warp-specialised wgmma + TMA Z-order matmul
// for Hopper (sm_90a), C = A @ B in bf16 with fp32 accumulation.
//
// Replaces src/repro/kernels/matmul/kernel.py:46 (zorder_matmul, the Pallas
// TPU kernel, body _matmul_kernel) for bf16 products with many rows (the
// long prefill's M = 32768).  Same function: A (m, k) @ B (k, n), fp32
// accumulator, one rounding to the output type.
//
// Bound.  At these shapes the product does about 2 m n k / (2 (mk + kn +
// mn)) operations a byte, far above the card's 295, so it is bound by the
// tensor cores' rate (989 TFLOP/s dense bf16).  Only wgmma reaches that
// rate, and only if the tensor cores never wait for operands.  What the
// design does about it:
//
// * wgmma.  Two consumer warpgroups each own 64 rows of a 128 x BN tile
//   (BN = 128 or 256) and issue m64nBNk16 wgmma on operands in shared
//   memory, fp32 accumulators in registers (64 or 128 a thread).
// * TMA.  One producer thread issues cp.async.bulk.tensor loads of the
//   A (128 x 64) and B (64 x BN) blocks into a ring of STAGES stages, with
//   a full and an empty mbarrier per stage; no thread computes a copy
//   address.  Both operands land with the 128-byte swizzle that wgmma's
//   descriptors read.  A (m, k) row-major is K-major; B (k, n) row-major is
//   MN-major, so B is read with wgmma's transpose flag, in 64-column boxes.
//   TMA zero-fills boxes past the matrix, which covers ragged m, n and k
//   (danube's n = 960 is 7.5 tiles of 128); stores are masked.
// * Transposed operands in place.  An operand stored transposed (the .t()
//   of a row-major tensor: a tied embedding as the LM head, the backward's
//   B^T and A^T) is read as stored: B stored (n, k) is K-major, loaded in
//   one (BN x 64) box and read without the transpose flag; A stored (k, m)
//   is MN-major, loaded in two (64 x 64) boxes, one per consumer, and read
//   with wgmma's A-transpose flag (bf16 operands in shared memory allow
//   it).  No transposed copy is made.
// * setmaxnreg moves registers from the producer warpgroup (40) to the
//   consumers (232), which hold the accumulators.
// * Persistent CTAs.  One CTA per SM walks the output tiles of the Morton
//   (Z-order) table, CTA c taking entries c, c + grid, ...: the paper's
//   schedule stays the order in which resident CTAs share A row panels and
//   B column panels in L2, and the producer loads the next tile's blocks
//   while the consumers store the last one.  Every tile runs the same k
//   loop, so both orders give bitwise-equal outputs.
//
// Operands TMA cannot take (a stored row or n not a multiple of 8 long, a
// base not 16-byte aligned) go to the cp.async + wmma kernel in
// zorder_matmul.cu, as row-major copies; this entry point refuses them.
// The tensor maps are encoded on the host at every call through
// cuTensorMapEncodeTiled, reached by cudaGetDriverEntryPointByVersion so
// that the library links nothing beyond the CUDA runtime.
#include <stddef.h>

#include "hopper.cuh"  // kernels/common: mbarriers, TMA, wgmma, the tensor-map encoder
#include "zorder_common.cuh"

namespace {

using namespace hopper;
using namespace zorder;

// AT: A stored transposed, as (k, m) row-major; BT: B stored as (n, k).
template <int BN_, int STAGES_, bool AT_ = false, bool BT_ = false>
struct WideTile {
  static constexpr int BM = 128, BN = BN_, BK = 64, STAGES = STAGES_;
  static constexpr bool AT = AT_, BT = BT_;
  static constexpr int kConsumers = 2;  // warpgroups, 64 rows each
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kAccum = BN / 2;  // fp32 accumulators a consumer thread holds
  static constexpr int kABytes = BM * BK * 2;  // one TMA box (64 x 128), or two (64 x 64) when AT
  static constexpr int kBoxBytes = BK * 64 * 2;                 // a 64 x 64 box
  static constexpr int kBBytes = BK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the ring, a full and an empty barrier per stage, and slack to align
  // the ring to the 1024 bytes the 128-byte swizzle repeats over
  static constexpr size_t kSmemBytes = (size_t)STAGES * kStageBytes + 2 * STAGES * 8 + 1024;
  static_assert(BN % 64 == 0 && BN <= 256, "B is loaded in 64-column boxes, wgmma N <= 256");
  static_assert(kSmemBytes <= 232448, "a block may use 227 KB of shared memory");
  template <bool A2, bool B2> using Layout = WideTile<BN_, STAGES_, A2, B2>;
};

template <int N, bool AT, bool BT> struct Wgmma;
// D += A @ B, N = BN: A MN-major (the A-transpose flag) when stored (k, m),
// B MN-major (the B-transpose flag) when stored (k, n).
template <bool AT, bool BT> struct Wgmma<128, AT, BT> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    wgmma_m64n128k16_ss<BT ? 0 : 1, AT ? 1 : 0>(d, da, db, 1);
  }
};
template <bool AT, bool BT> struct Wgmma<256, AT, BT> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db) {
    wgmma_m64n256k16_ss<BT ? 0 : 1, AT ? 1 : 0>(d, da, db, 1);
  }
};

template <typename Tile, typename TOut>
__global__ void __launch_bounds__(Tile::kThreads, 1)
    zorder_matmul_wide_kernel(const __grid_constant__ CUtensorMap tma_a,
                              const __grid_constant__ CUtensorMap tma_b, TOut* __restrict__ C,
                              const int* __restrict__ tiles, int ntiles, int M, int N, int K) {
  constexpr int BM = Tile::BM, BN = Tile::BN, BK = Tile::BK, STAGES = Tile::STAGES;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* ring = smem_raw + ((1024 - (smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + STAGES * Tile::kStageBytes);
  uint64_t* empty = full + STAGES;
  const int nk = (K + BK - 1) / BK;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(&full[s], 1);                        // the producer's expect_tx
      mbar_init(&empty[s], Tile::kConsumers * 4);    // one arrive per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == 0) {
    // Producer warpgroup: one thread keeps the ring full.
    setmaxnreg_dec<40>();
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int row0 = tiles[t] * BM, col0 = tiles[ntiles + t] * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);       // the first round passes at once
          unsigned char* st = ring + stage * Tile::kStageBytes;
          mbar_expect_tx(&full[stage], Tile::kStageBytes);
          if constexpr (Tile::AT) {  // rows 64 g.. of the tile: box g
            tma_load_2d(st, &tma_a, row0, kb * BK, &full[stage]);
            tma_load_2d(st + Tile::kBoxBytes, &tma_a, row0 + 64, kb * BK, &full[stage]);
          } else {
            tma_load_2d(st, &tma_a, kb * BK, row0, &full[stage]);
          }
          if constexpr (Tile::BT) {
            tma_load_2d(st + Tile::kABytes, &tma_b, kb * BK, col0, &full[stage]);
          } else {
#pragma unroll
            for (int c = 0; c < BN / 64; ++c)
              tma_load_2d(st + Tile::kABytes + c * Tile::kBoxBytes, &tma_b, col0 + 64 * c,
                          kb * BK, &full[stage]);
          }
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroups: rows 64 g .. 64 g + 63 of every tile.
    setmaxnreg_inc<232>();
    const int g = wg - 1, warp = (threadIdx.x % 128) / 32, lane = threadIdx.x % 32;
    int stage = 0, phase = 0;
    for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
      const int row0 = tiles[t] * BM, col0 = tiles[ntiles + t] * BN;
      float acc[Tile::kAccum];
#pragma unroll
      for (int i = 0; i < Tile::kAccum; ++i) acc[i] = 0.f;
      int prev = 0;
      for (int kb = 0; kb < nk; ++kb) {
        mbar_wait(&full[stage], phase);
        const uint32_t a = smem_addr(ring + stage * Tile::kStageBytes) + g * 64 * 128;
        const uint32_t b = smem_addr(ring + stage * Tile::kStageBytes + Tile::kABytes);
        fence_accum(acc);
        wgmma_fence();
        // 16 k: 32 bytes of each K-major row, or 16 rows of 128 bytes MN-major
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)
          Wgmma<BN, Tile::AT, Tile::BT>::run(
              acc,
              Tile::AT ? smem_desc(a + kk * 16 * 128, Tile::kBoxBytes, 1024)
                       : smem_desc(a + kk * 32, 16, 1024),
              Tile::BT ? smem_desc(b + kk * 32, 16, 1024)
                       : smem_desc(b + kk * 16 * 128, Tile::kBoxBytes, 1024));
        wgmma_commit();
        wgmma_wait<1>();                       // the previous k block's products are done
        fence_accum(acc);
        if (kb > 0 && lane == 0) mbar_arrive(&empty[prev]);
        prev = stage;
        if (++stage == STAGES) stage = 0, phase ^= 1;
      }
      wgmma_wait<0>();
      fence_accum(acc);
      if (nk > 0 && lane == 0) mbar_arrive(&empty[prev]);
      // Epilogue: the wgmma accumulator layout, one rounding, masked stores
      // of neighbouring column pairs (n is a multiple of 8).
      const int r = row0 + g * 64 + warp * 16 + lane / 4;
      const int c0 = col0 + (lane % 4) * 2;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int c = c0 + j * 8;
        if (c < N) {
          if (r < M) store_pair(C + (size_t)r * N + c, acc[4 * j], acc[4 * j + 1]);
          if (r + 8 < M) store_pair(C + (size_t)(r + 8) * N + c, acc[4 * j + 2], acc[4 * j + 3]);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: the compiled tiles (kernel.py's BLOCKS and smem_bytes mirror them).
// ---------------------------------------------------------------------------

using Wide128 = WideTile<128, 6>;
using Wide256 = WideTile<256, 4>;

// A row-major bf16 (rows, cols) matrix read in (box_rows x 64) boxes with
// the 128-byte swizzle; boxes past the edge are zero-filled.
bool encode_rowmajor(CUtensorMap* map, const void* base, int rows, int cols, int box_rows) {
  EncodeTiledFn fn = encode_fn();
  if (fn == nullptr) return false;
  cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  cuuint64_t strides[1] = {(cuuint64_t)cols * 2};
  cuuint32_t box[2] = {64, (cuuint32_t)box_rows};
  cuuint32_t elem[2] = {1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2, const_cast<void*>(base), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename Tile, typename TOut>
cudaError_t launch_wide(const void* a, const void* b, void* c, const int* tiles, int ntiles,
                        int m, int n, int k, int grid, cudaStream_t stream) {
  // each operand's map as it is stored
  CUtensorMap ma, mb;
  const bool ok_a = Tile::AT ? encode_rowmajor(&ma, a, k, m, Tile::BK)
                             : encode_rowmajor(&ma, a, m, k, Tile::BM);
  const bool ok_b = Tile::BT ? encode_rowmajor(&mb, b, n, k, Tile::BN)
                             : encode_rowmajor(&mb, b, k, n, Tile::BK);
  if (!ok_a || !ok_b) return cudaErrorInvalidValue;
  auto kern = zorder_matmul_wide_kernel<Tile, TOut>;
  static bool opted_in[64] = {};
  cudaError_t e = opt_in_smem(kern, Tile::kSmemBytes, opted_in);
  if (e != cudaSuccess) return e;
  kern<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(ma, mb, static_cast<TOut*>(c), tiles,
                                                          ntiles, m, n, k);
  return cudaGetLastError();
}

template <typename Tile>
cudaError_t dispatch_out(int out_dtype, const void* a, const void* b, void* c, const int* tiles,
                         int ntiles, int m, int n, int k, int grid, cudaStream_t stream) {
  if (out_dtype == kBF16)
    return launch_wide<Tile, bf16>(a, b, c, tiles, ntiles, m, n, k, grid, stream);
  if (out_dtype == kF32)
    return launch_wide<Tile, float>(a, b, c, tiles, ntiles, m, n, k, grid, stream);
  return cudaErrorInvalidValue;
}

// The tile in the operands' stored layouts.
template <typename Tile>
cudaError_t dispatch_wide(int a_t, int b_t, int out_dtype, const void* a, const void* b, void* c,
                          const int* tiles, int ntiles, int m, int n, int k, int grid,
                          cudaStream_t stream) {
  using NN = typename Tile::template Layout<false, false>;
  using NT = typename Tile::template Layout<false, true>;
  using TN = typename Tile::template Layout<true, false>;
  using TT = typename Tile::template Layout<true, true>;
  auto go = [&](auto tile) {
    return dispatch_out<decltype(tile)>(out_dtype, a, b, c, tiles, ntiles, m, n, k, grid, stream);
  };
  return a_t ? (b_t ? go(TT{}) : go(TN{})) : (b_t ? go(NT{}) : go(NN{}));
}

}  // namespace

extern "C" {

// C = A @ B for bf16 A (m, k), B (k, n) and a row-major C (m, n) of type
// out_dtype.  A is row-major (a_t = 0) or stored transposed as a row-major
// (k, m) (a_t = 1); B row-major or stored as (n, k) (b_t = 1).  tiles holds
// 2 * ntiles int32 on the device (tile rows, then tile columns, in the
// Z-order or row-major visit order); `grid` persistent CTAs walk it.
// Refuses (cudaErrorInvalidValue) what TMA cannot take: stored rows that
// are not a multiple of 8 long (n, and k or m for A, k for a transposed B),
// or a base not 16-byte aligned.  Launches on `stream`, does not
// synchronise, returns cudaGetLastError().
int zorder_matmul_wide_launch(const void* a, const void* b, void* c, const int* tiles, int ntiles,
                              int m, int n, int k, int a_t, int b_t, int out_dtype, int bm, int bn,
                              int bk, int grid, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles <= 0 || grid <= 0 || m <= 0 || n <= 0 || k <= 0 || n % 8 ||
      (a_t ? m % 8 : k % 8) || (b_t && k % 8) || reinterpret_cast<uintptr_t>(a) % 16 ||
      reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  if (bm == Wide128::BM && bn == Wide128::BN && bk == Wide128::BK)
    return (int)dispatch_wide<Wide128>(a_t, b_t, out_dtype, a, b, c, tiles, ntiles, m, n, k, grid,
                                       st);
  if (bm == Wide256::BM && bn == Wide256::BN && bk == Wide256::BK)
    return (int)dispatch_wide<Wide256>(a_t, b_t, out_dtype, a, b, c, tiles, ntiles, m, n, k, grid,
                                       st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
