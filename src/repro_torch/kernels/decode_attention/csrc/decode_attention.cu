// Split-KV decode attention for Hopper (sm_90a): one query per row against
// a bf16 KV cache, grouped-query heads, fp32 arithmetic throughout.  The
// serving decode step's attention core.
//
// Replaces no TPU kernel: the reference decodes through its chunked masked
// einsum (repro/layers/attention.py, _sdpa), which XLA fuses on the TPU.
// The port's plain version of it (repro_torch/layers/attention.py::_sdpa)
// upcasts the whole cache to fp32 on every layer and step and runs fp32
// einsums over every slot, masked or not.  Same function here: for row b,
// query head (h, g) and the slots s of KV head h whose key position
// kpos[b, s] is valid against the query's qpos[b] (kpos >= 0; kpos <= qpos
// when causal; kpos > qpos - window when window > 0), softmax(scale q.k)
// weighted sum of v; fp32 products of the bf16 values (exact in fp32),
// fp32 sums, fp32 probabilities into PV, one rounding of the output to
// bf16.  A row with no valid key gets the plain version's answer, the
// uniform softmax over its -1e30 scores: the mean of v over all S slots.
//
// Bound.  At one query per row the core does 4 D flops per slot and query
// head against 4 D bytes of K and V per slot and KV head: with G query
// heads per KV head that is G flops a byte, far below the card's ridge
// (~20 in fp32 FMA, ~295 in bf16 tensor-core work), so the least time is
// the valid slots' K and V bytes at the memory rate (3.35 TB/s).  What the
// design does about it:
//
// * Split-KV (flash-decoding).  One CTA per (row, KV head, group of up to
//   GT query heads, chunk of `chunk` slots); kernel.py's split_plan sizes
//   the chunk from B * Hkv against the SM count and S, and keeps a CTA's
//   slots x query heads within a fixed share.  Each CTA writes its
//   fp32 partials (max, sum, unnormalised accumulator per query head) to a
//   workspace the wrapper allocates; a second launch combines each query
//   head's partials in split order, so the result is bitwise the same in
//   every run.  (Combining in the last CTA of each group instead, found by
//   an arrival counter, measured 3 % slower at danube's layout and 4 %
//   faster at deepseek's on an H100: the second launch stays.)
// * Only valid slots are read.  The CTA first evaluates the mask of its
//   chunk from kpos and qpos (device tensors: one CUDA graph serves every
//   decode step at every position); a chunk with no valid slot for its row
//   writes an empty partial and issues no K/V load, and inside a chunk a
//   masked slot issues none either.  Masked slots contribute exactly 0.
// * GQA.  The G query heads of a KV head (up to GT at a time) share every
//   K and V load.
// * 16-byte loads.  A key or value row of D bf16 is D / 8 16-byte vectors;
//   LPK lanes (a power of two >= D / 8) read one row, so a warp reads
//   32 / LPK rows at once, kUnroll loads in flight per thread.  The QK dot
//   products reduce across the LPK lanes by a reduce-scatter over the query
//   heads (GT heads in log2 LPK shuffle steps: 5 shuffles a row for 4
//   heads, not 16); the scores and probabilities of the chunk sit in shared
//   memory; PV accumulates 8 outputs per lane and query head in registers,
//   reduced across the warps through shared memory in a fixed order.
//
// The entry point allocates nothing and does not synchronise, so a CUDA
// graph captures it.  Every tensor is read through its strides with the
// last dim contiguous: the cache in place, no copy.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxChunk = 256;   // kernel.py's MAX_CHUNK
constexpr int kUnroll = 4;

struct Params {
  const __nv_bfloat16* q;   // (B, Hkv, G, Dk)
  const __nv_bfloat16* k;   // (B, S, Hkv, Dk)
  const __nv_bfloat16* v;   // (B, S, Hkv, Dv)
  const long long* qpos;    // qpos[b * qp_sb]
  const long long* kpos;    // kpos[b * kp_sb + s * kp_ss]
  float* part_ml;           // (B * Hkv * G, nsplit, 2): each split's max and sum
  float* part_acc;          // (B * Hkv * G, nsplit, Dv): its unnormalised output
  __nv_bfloat16* o;         // (B, Hkv, G, Dv)
  int B, S, Hkv, G, Dk, Dv;
  long long q_sb, q_sh, q_sg, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, o_sg;
  long long qp_sb, kp_sb, kp_ss;
  int causal, window;
  float scale;
  int chunk, nsplit;
};

__device__ __forceinline__ bool key_valid(long long kp, long long qp, int causal, int window) {
  return kp >= 0 && (!causal || kp <= qp) && (window <= 0 || kp > qp - window);
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

__device__ __forceinline__ uint4 load16(const __nv_bfloat16* p) {
  return __ldg(reinterpret_cast<const uint4*>(p));
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// One (split, KV head and query-head group, row) per CTA: grid (nsplit,
// Hkv * ceil(G / GT), B).
template <int LPK, int GT>
__global__ void __launch_bounds__(kThreads) decode_split_kernel(const Params p) {
  static_assert(LPK >= GT, "the scores' reduce-scatter gives each head LPK / GT lanes");
  constexpr int KPW = 32 / LPK;          // rows a warp reads at once
  constexpr int KPC = kWarps * KPW;      // rows the CTA reads at once
  __shared__ float sc[GT][kMaxChunk];    // scores, then probabilities
  __shared__ float red[kWarps][GT][LPK * 8];
  __shared__ unsigned char ok[kMaxChunk];

  const int ngt = (p.G + GT - 1) / GT;
  const int split = blockIdx.x, h = blockIdx.y / ngt, g0 = (blockIdx.y % ngt) * GT;
  const int b = blockIdx.z;
  const int ng = min(GT, p.G - g0);
  const int s0 = split * p.chunk, n = min(p.chunk, p.S - s0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int sub = lane / LPK, vl = lane % LPK;
  const long long row0 = ((long long)b * p.Hkv + h) * p.G + g0;   // query head g0's row

  // 1. The chunk's mask; a chunk with no valid slot loads nothing.
  const long long qp = p.qpos[b * p.qp_sb];
  int any = 0;
  for (int j = tid; j < n; j += kThreads) {
    const bool valid = key_valid(p.kpos[b * p.kp_sb + (long long)(s0 + j) * p.kp_ss], qp,
                                 p.causal, p.window);
    ok[j] = valid;
    any |= valid;
  }
  if (!__syncthreads_or(any)) {
    if (tid < ng) {
      p.part_ml[((row0 + tid) * p.nsplit + split) * 2] = -INFINITY;
      p.part_ml[((row0 + tid) * p.nsplit + split) * 2 + 1] = 0.f;
    }
    return;
  }

  // 2. Scores: lane vl holds the vl-th 16-byte vector of each query head.
  //    The dot products reduce across the LPK lanes of a row by a
  //    reduce-scatter: each shuffle step halves the heads a lane carries,
  //    so lane vl ends with head vl / (LPK / GT), then a plain reduction.
  const int dkv = p.Dk / 8, dvv = p.Dv / 8;
  float qf[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g) {
    uint4 u = make_uint4(0, 0, 0, 0);
    if (g < ng && vl < dkv)
      u = load16(p.q + b * p.q_sb + h * p.q_sh + (g0 + g) * p.q_sg + vl * 8);
    unpack8(u, qf[g]);
  }
  const __nv_bfloat16* kb = p.k + b * p.k_sb + h * p.k_sh + vl * 8;
  for (int base = warp * KPW; base < n; base += kUnroll * KPC) {
    uint4 raw[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + sub + u * KPC;
      live[u] = j < n && ok[j];
      raw[u] = make_uint4(0, 0, 0, 0);
      if (live[u] && vl < dkv) raw[u] = load16(kb + (long long)(s0 + j) * p.k_ss);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + sub + u * KPC;
      float kf[8];
      unpack8(raw[u], kf);
      float d[GT];
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        d[g] = 0.f;
#pragma unroll
        for (int e = 0; e < 8; ++e) d[g] = fmaf(qf[g][e], kf[e], d[g]);
      }
#pragma unroll
      for (int off = LPK / 2, cnt = GT; off > 0; off >>= 1) {
        if (cnt > 1) {
          const int half = cnt / 2;
          const bool upper = (vl & off) != 0;
#pragma unroll
          for (int i = 0; i < half; ++i) {
            const float send = upper ? d[i] : d[i + half];
            const float keep = upper ? d[i + half] : d[i];
            d[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
          }
          cnt = half;
        } else {
          d[0] += __shfl_xor_sync(0xffffffffu, d[0], off);
        }
      }
      if (vl % (LPK / GT) == 0 && j < n)
        sc[vl / (LPK / GT)][j] = live[u] ? d[0] * p.scale : -INFINITY;
    }
  }
  __syncthreads();

  // 3. The chunk's softmax statistics, one warp per query head.
  for (int g = warp; g < ng; g += kWarps) {
    float m = -INFINITY;
    for (int j = lane; j < n; j += 32) m = fmaxf(m, sc[g][j]);
    m = warp_max(m);
    float l = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float e = expf(sc[g][j] - m);   // a masked slot: exp(-inf) = 0
      sc[g][j] = e;
      l += e;
    }
    l = warp_sum(l);
    if (lane == 0) {
      p.part_ml[((row0 + g) * p.nsplit + split) * 2] = m;
      p.part_ml[((row0 + g) * p.nsplit + split) * 2 + 1] = l;
    }
  }
  __syncthreads();

  // 4. PV over the valid slots, fp32 probabilities.
  float acc[GT][8];
#pragma unroll
  for (int g = 0; g < GT; ++g)
#pragma unroll
    for (int e = 0; e < 8; ++e) acc[g][e] = 0.f;
  const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh + vl * 8;
  for (int base = warp * KPW; base < n; base += kUnroll * KPC) {
    uint4 raw[kUnroll];
    bool live[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = base + sub + u * KPC;
      live[u] = j < n && ok[j] && vl < dvv;
      if (live[u]) raw[u] = load16(vb + (long long)(s0 + j) * p.v_ss);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (!live[u]) continue;
      const int j = base + sub + u * KPC;
      float vf[8];
      unpack8(raw[u], vf);
#pragma unroll
      for (int g = 0; g < GT; ++g) {
        const float pg = sc[g][j];
#pragma unroll
        for (int e = 0; e < 8; ++e) acc[g][e] = fmaf(pg, vf[e], acc[g][e]);
      }
    }
  }
  // across the warp's rows (lanes vl, vl + LPK, ...), then across warps
#pragma unroll
  for (int off = LPK; off < 32; off <<= 1)
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) acc[g][e] += __shfl_xor_sync(0xffffffffu, acc[g][e], off);
  if (sub == 0) {
#pragma unroll
    for (int g = 0; g < GT; ++g)
#pragma unroll
      for (int e = 0; e < 8; ++e) red[warp][g][vl * 8 + e] = acc[g][e];
  }
  __syncthreads();
  for (int i = tid; i < ng * p.Dv; i += kThreads) {
    const int g = i / p.Dv, d = i % p.Dv;
    float s = red[0][g][d];
#pragma unroll
    for (int w = 1; w < kWarps; ++w) s += red[w][g][d];
    p.part_acc[((row0 + g) * p.nsplit + split) * p.Dv + d] = s;
  }
}

// One warp per query head (row (b * Hkv + h) * G + g): the splits' partials
// in split order, one rounding.
__global__ void __launch_bounds__(kThreads) decode_combine_kernel(const Params p) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kWarps + warp;
  if (row >= (long long)p.B * p.Hkv * p.G) return;
  const int g = (int)(row % p.G);
  const int h = (int)(row / p.G % p.Hkv);
  const int b = (int)(row / p.G / p.Hkv);
  const float* ml = p.part_ml + row * p.nsplit * 2;
  float m = -INFINITY;
  for (int i = 0; i < p.nsplit; ++i)
    if (ml[2 * i + 1] > 0.f) m = fmaxf(m, ml[2 * i]);
  float l = 0.f;
  for (int i = 0; i < p.nsplit; ++i)
    if (ml[2 * i + 1] > 0.f) l += ml[2 * i + 1] * expf(ml[2 * i] - m);
  __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh + g * p.o_sg;
  if (l > 0.f) {
    const float* acc = p.part_acc + row * p.nsplit * p.Dv;
    for (int d = lane; d < p.Dv; d += 32) {
      float s = 0.f;
      for (int i = 0; i < p.nsplit; ++i)
        if (ml[2 * i + 1] > 0.f) s = fmaf(acc[(long long)i * p.Dv + d], expf(ml[2 * i] - m), s);
      out[d] = __float2bfloat16_rn(s / l);
    }
  } else {
    // No valid key: the uniform softmax over -1e30 scores, the mean of v.
    const float w = 1.f / (float)p.S;
    const __nv_bfloat16* vb = p.v + b * p.v_sb + h * p.v_sh;
    for (int d = lane; d < p.Dv; d += 32) {
      float s = 0.f;
      for (int t = 0; t < p.S; ++t) s = fmaf(w, __bfloat162float(vb[(long long)t * p.v_ss + d]), s);
      out[d] = __float2bfloat16_rn(s);
    }
  }
}

template <int LPK, int GT>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const int ngt = (p.G + GT - 1) / GT;
  if ((long long)p.Hkv * ngt > 65535 || p.B > 65535) return cudaErrorInvalidConfiguration;
  decode_split_kernel<LPK, GT><<<dim3(p.nsplit, p.Hkv * ngt, p.B), kThreads, 0, stream>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  const long long rows = (long long)p.B * p.Hkv * p.G;
  const long long blocks = (rows + kWarps - 1) / kWarps;
  if (blocks > 0x7fffffffLL) return cudaErrorInvalidConfiguration;
  decode_combine_kernel<<<(unsigned)blocks, kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

template <int LPK>
cudaError_t dispatch_group(const Params& p, cudaStream_t stream) {
  if (p.G == 1) return launch<LPK, 1>(p, stream);
  if (p.G == 2) return launch<LPK, 2>(p, stream);
  if (p.G <= 4) return launch<LPK, 4>(p, stream);
  return launch<LPK, 8>(p, stream);
}

bool aligned16(const void* ptr) { return reinterpret_cast<uintptr_t>(ptr) % 16 == 0; }

}  // namespace

extern "C" {

// o = decode attention for q (B, Hkv, G, Dk), k (B, S, Hkv, Dk), v (B, S,
// Hkv, Dv), all bf16, and o (B, Hkv, G, Dv) bf16, each addressed through
// its strides in elements with the last dim contiguous; int64 positions
// qpos[b * qp_sb] and kpos[b * kp_sb + s * kp_ss] (a stride of 0 broadcasts
// one row).  Dk and Dv multiples of 8 up to 256; the bases of q, k, v
// 16-byte aligned and their strides multiples of 8 elements.  part_ml and
// part_acc hold B * Hkv * G * nsplit * 2 and * Dv floats, nsplit =
// ceil(S / chunk), 1 <= chunk <= 256.
// Launches on `stream`, does not synchronise, and returns
// cudaGetLastError() (0 when both launches were accepted).
int decode_attention_launch(const void* q, const void* k, const void* v, const void* qpos,
                            const void* kpos, void* part_ml, void* part_acc, void* o, int B,
                            int S, int Hkv, int G, int Dk, int Dv, long long q_sb,
                            long long q_sh, long long q_sg, long long k_sb, long long k_ss,
                            long long k_sh, long long v_sb, long long v_ss, long long v_sh,
                            long long o_sb, long long o_sh, long long o_sg, long long qp_sb,
                            long long kp_sb, long long kp_ss, int causal, int window,
                            float scale, int chunk, int nsplit, void* stream) {
  if (B <= 0 || S <= 0 || Hkv <= 0 || G <= 0 || Dk <= 0 || Dv <= 0 || Dk % 8 || Dv % 8 ||
      Dk > 256 || Dv > 256 || chunk <= 0 || chunk > kMaxChunk ||
      nsplit != (S + chunk - 1) / chunk)
    return (int)cudaErrorInvalidValue;
  const long long strides[][2] = {{q_sb, B}, {q_sh, Hkv}, {q_sg, G}, {k_sb, B}, {k_ss, S},
                                  {k_sh, Hkv}, {v_sb, B}, {v_ss, S}, {v_sh, Hkv}};
  bool ok = aligned16(q) && aligned16(k) && aligned16(v);
  for (const auto& s : strides) ok = ok && (s[1] <= 1 || s[0] % 8 == 0);
  if (!ok) return (int)cudaErrorMisalignedAddress;
  Params p{static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
           static_cast<const __nv_bfloat16*>(v), static_cast<const long long*>(qpos),
           static_cast<const long long*>(kpos), static_cast<float*>(part_ml),
           static_cast<float*>(part_acc), static_cast<__nv_bfloat16*>(o), B, S, Hkv, G, Dk,
           Dv, q_sb, q_sh, q_sg, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_sh, o_sg,
           qp_sb, kp_sb, kp_ss, causal, window, scale, chunk, nsplit};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int d = Dk > Dv ? Dk : Dv;
  if (d <= 64) return (int)dispatch_group<8>(p, st);
  if (d <= 128) return (int)dispatch_group<16>(p, st);
  return (int)dispatch_group<32>(p, st);
}

const char* decode_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
