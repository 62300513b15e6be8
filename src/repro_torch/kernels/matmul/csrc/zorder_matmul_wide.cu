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
// * setmaxnreg moves registers from the producer warpgroup (40) to the
//   consumers (232), which hold the accumulators.
// * Persistent CTAs.  One CTA per SM walks the output tiles of the Morton
//   (Z-order) table, CTA c taking entries c, c + grid, ...: the paper's
//   schedule stays the order in which resident CTAs share A row panels and
//   B column panels in L2, and the producer loads the next tile's blocks
//   while the consumers store the last one.  Every tile runs the same k
//   loop, so both orders give bitwise-equal outputs.
//
// Operands TMA cannot take (k or n not a multiple of 8, a base not 16-byte
// aligned) go to the cp.async + wmma kernel in zorder_matmul.cu; this entry
// point refuses them.  The tensor maps are encoded on the host at every
// call through cuTensorMapEncodeTiled, reached by cudaGetDriverEntryPoint-
// ByVersion so that the library links nothing beyond the CUDA runtime.
#include <cuda.h>  // CUtensorMap and its enums: types only, nothing links libcuda
#include <stddef.h>

#include "zorder_common.cuh"

namespace {

using namespace zorder;

template <int BN_, int STAGES_>
struct WideTile {
  static constexpr int BM = 128, BN = BN_, BK = 64, STAGES = STAGES_;
  static constexpr int kConsumers = 2;  // warpgroups, 64 rows each
  static constexpr int kThreads = 128 * (1 + kConsumers);
  static constexpr int kAccum = BN / 2;  // fp32 accumulators a consumer thread holds
  static constexpr int kABytes = BM * BK * 2;                   // one TMA box (64 x 128)
  static constexpr int kBBoxBytes = BK * 64 * 2;                // one 64-column box of B
  static constexpr int kBBytes = BK * BN * 2;
  static constexpr int kStageBytes = kABytes + kBBytes;
  // the ring, a full and an empty barrier per stage, and slack to align
  // the ring to the 1024 bytes the 128-byte swizzle repeats over
  static constexpr size_t kSmemBytes = (size_t)STAGES * kStageBytes + 2 * STAGES * 8 + 1024;
  static_assert(BN % 64 == 0 && BN <= 256, "B is loaded in 64-column boxes, wgmma N <= 256");
  static_assert(kSmemBytes <= 232448, "a block may use 227 KB of shared memory");
};

// --- mbarrier, TMA and wgmma primitives (PTX) ------------------------------

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(smem_addr(bar)), "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(smem_addr(bar)) : "memory");
}
// Arrive and add `bytes` to the transaction count the phase waits for.
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_addr(bar)),
               "r"(bytes)
               : "memory");
}
// Spin until the phase of parity `parity` has completed.  A phase that
// never completes (a lost arrival) traps after about 2^28 tries, seconds
// of spinning, so the launch fails instead of holding the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_addr(bar);
  uint32_t done = 0;
  for (uint32_t tries = 0;; ++tries) {
    if (tries == (1u << 28)) __trap();
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
    if (done) return;
  }
}

// One 2-D box of a tensor map into shared memory; completion is counted in
// bytes on `bar`.  c0 is the inner (contiguous) coordinate.
__device__ __forceinline__ void tma_load_2d(void* dst, const CUtensorMap* map, int c0, int c1,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(smem_addr(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N> __device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keep the compiler from moving accumulator reads or writes across the
// asynchronous wgmma that owns them.
template <int N> __device__ __forceinline__ void fence_accum(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// Shared-memory matrix descriptor with the 128-byte swizzle: start address,
// leading and stride byte offsets, all in 16-byte units.  K-major A: rows of
// 128 bytes, 8-row groups 1024 bytes apart (SBO), LBO unused.  MN-major B:
// 64-column chunks LBO apart, groups of 8 k-rows 1024 bytes apart (SBO).
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

// D (64 x 128, fp32, in registers) += A (64 x 16, K-major) @ B (16 x 128, MN-major),
// both read from shared memory through descriptors.
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

// D (64 x 256, fp32, in registers) += A (64 x 16, K-major) @ B (16 x 256, MN-major),
// both read from shared memory through descriptors.
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, %88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, %104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, %120, %121, %122, %123, %124, %125, %126, %127"
      "}, %128, %129, p, 1, 1, 0, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]), "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]), "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]), "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]), "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]), "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]), "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(da), "l"(db), "r"(1));
}

template <int N> struct Wgmma;
template <> struct Wgmma<128> {
  static __device__ __forceinline__ void run(float (&d)[64], uint64_t da, uint64_t db) {
    wgmma_m64n128k16(d, da, db);
  }
};
template <> struct Wgmma<256> {
  static __device__ __forceinline__ void run(float (&d)[128], uint64_t da, uint64_t db) {
    wgmma_m64n256k16(d, da, db);
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
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (threadIdx.x == 0) {
      int stage = 0, phase = 0;
      for (int t = blockIdx.x; t < ntiles; t += gridDim.x) {
        const int row0 = tiles[t] * BM, col0 = tiles[ntiles + t] * BN;
        for (int kb = 0; kb < nk; ++kb) {
          mbar_wait(&empty[stage], phase ^ 1);       // the first round passes at once
          unsigned char* st = ring + stage * Tile::kStageBytes;
          mbar_expect_tx(&full[stage], Tile::kStageBytes);
          tma_load_2d(st, &tma_a, kb * BK, row0, &full[stage]);
#pragma unroll
          for (int c = 0; c < BN / 64; ++c)
            tma_load_2d(st + Tile::kABytes + c * Tile::kBBoxBytes, &tma_b, col0 + 64 * c, kb * BK,
                        &full[stage]);
          if (++stage == STAGES) stage = 0, phase ^= 1;
        }
      }
    }
  } else {
    // Consumer warpgroups: rows 64 g .. 64 g + 63 of every tile.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
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
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk)   // 16 k = 32 bytes of an A row, 16 rows of B
          Wgmma<BN>::run(acc, smem_desc(a + kk * 32, 16, 1024),
                         smem_desc(b + kk * 16 * 128, Tile::kBBoxBytes, 1024));
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

typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                  const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                  CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiledFn encode_fn() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q = cudaDriverEntryPointSymbolNotFound;
#if CUDART_VERSION >= 12050
    cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                     cudaEnableDefault, &q);
#else
    cudaError_t e = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

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
  CUtensorMap ma, mb;
  if (!encode_rowmajor(&ma, a, m, k, Tile::BM) || !encode_rowmajor(&mb, b, k, n, Tile::BK))
    return cudaErrorInvalidValue;
  auto kern = zorder_matmul_wide_kernel<Tile, TOut>;
  static bool opted_in[64] = {};
  cudaError_t e = opt_in_smem(kern, Tile::kSmemBytes, opted_in);
  if (e != cudaSuccess) return e;
  kern<<<grid, Tile::kThreads, Tile::kSmemBytes, stream>>>(ma, mb, static_cast<TOut*>(c), tiles,
                                                          ntiles, m, n, k);
  return cudaGetLastError();
}

template <typename Tile>
cudaError_t dispatch_wide(int out_dtype, const void* a, const void* b, void* c, const int* tiles,
                          int ntiles, int m, int n, int k, int grid, cudaStream_t stream) {
  if (out_dtype == kBF16)
    return launch_wide<Tile, bf16>(a, b, c, tiles, ntiles, m, n, k, grid, stream);
  if (out_dtype == kF32)
    return launch_wide<Tile, float>(a, b, c, tiles, ntiles, m, n, k, grid, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// C = A @ B for row-major contiguous bf16 A (m, k), B (k, n) and C (m, n) of
// type out_dtype.  tiles holds 2 * ntiles int32 on the device (tile rows,
// then tile columns, in the Z-order or row-major visit order); `grid`
// persistent CTAs walk it.  Refuses (cudaErrorInvalidValue) what TMA cannot
// take: k or n not a multiple of 8, or a base not 16-byte aligned.  Launches
// on `stream`, does not synchronise, returns cudaGetLastError().
int zorder_matmul_wide_launch(const void* a, const void* b, void* c, const int* tiles, int ntiles,
                              int m, int n, int k, int out_dtype, int bm, int bn, int bk, int grid,
                              void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (ntiles <= 0 || grid <= 0 || m <= 0 || n <= 0 || k <= 0 || k % 8 || n % 8 ||
      reinterpret_cast<uintptr_t>(a) % 16 || reinterpret_cast<uintptr_t>(b) % 16)
    return (int)cudaErrorInvalidValue;
  if (bm == Wide128::BM && bn == Wide128::BN && bk == Wide128::BK)
    return (int)dispatch_wide<Wide128>(out_dtype, a, b, c, tiles, ntiles, m, n, k, grid, st);
  if (bm == Wide256::BM && bn == Wide256::BN && bk == Wide256::BK)
    return (int)dispatch_wide<Wide256>(out_dtype, a, b, c, tiles, ntiles, m, n, k, grid, st);
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
