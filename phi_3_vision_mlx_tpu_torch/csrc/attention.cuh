// Shared by the attention kernels: the masking and rounding rules, the int4
// cache's per-key scale loads (K4, K7), and the CUDA-core flash-attention
// body of K5 (quant_kv_attention.cu), which takes a tile of keys and values
// through a loader.  K2 runs the tensor-core body of flash_mma.cuh.
//
// The rules, as in the plain path (ops/attention.py): q * scale is rounded
// to the input type before the dot product, scores and the softmax are f32,
// masked scores take the finite NEG_INF = -0.7 * FLT_MAX (never -inf), and a
// row with no visible key comes out as the uniform average of all Lk values
// — finite, so a padded cache position is never poisoned by 0 * NaN in p.V.
// Key j is visible from query i iff j <= pos(i) and valid[b, j].  GQA: query
// head h reads kv head h / (H / KV).
//
// Flash body: one thread per query row holds its accumulator in registers,
// 64 rows per block, and K/V tiles of 32 keys are staged in shared memory as
// f32 (K transposed so a thread reads four keys per float4); both products
// run on the CUDA cores in f32.  Tiles past the causal horizon of the whole
// query tile are skipped, which is exact, unless a row in the tile has seen
// no visible key yet (a left-pad row): that block walks all tiles to produce
// the uniform average.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
constexpr int kBQ = 64;   // flash: query rows (threads) per block
constexpr int kBK = 32;   // flash: keys per tile
constexpr int kDecThreads = 256;  // decode kernels: threads per block (8 warps)
constexpr int kGroup = 32;  // quantized cache: values per scale/bias group along D

__device__ __forceinline__ float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

// One quantized value: f32 q * s, then + b, each rounded on its own (no
// fused multiply-add), then rounded once to bf16 — the bits of the plain
// path's _kv_dequantize(...).to(bfloat16).
__device__ __forceinline__ float dequant(unsigned q, float s, float b) {
  return round_bf(__fadd_rn(__fmul_rn(static_cast<float>(q), s), b));
}

// The int4 cache (K4, K7): one key's 4G scales: G loads of 8 bytes (4G bf16 = 8G bytes per key).
// at(i) widens bf16 i to f32 (its bits are the f32's top half); i is a
// constant after unrolling, so the words stay in registers.
template <int G>
struct KeyScales {
  uint2 w[G];
  __device__ __forceinline__ float at(int i) const {
    const unsigned word = (i % 4) < 2 ? w[i / 4].x : w[i / 4].y;
    return __uint_as_float(i % 2 ? word & 0xffff0000u : word << 16);
  }
};

template <int G>
__device__ __forceinline__ KeyScales<G> load_scales(const __nv_bfloat16* sc) {
  KeyScales<G> ks;
  const uint2* src = reinterpret_cast<const uint2*>(sc);
#pragma unroll
  for (int t = 0; t < G; ++t) ks.w[t] = __ldg(src + t);
  return ks;
}

// How the flash body reads key j's dim c of the cache: a key/value source
// is a stateless loader over the kernel's two cache pointers `a` and `b`
// (__restrict__ kernel arguments), `key` being the key's index in the
// layer's (B, KV, Lk) keys: `static void load(a, b, size_t key, int c,
// float& k, float& v)` (quant_kv_attention.cu: Int4KV).
template <int D, class KVSource>
__global__ void __launch_bounds__(kBQ)
    flash_attention_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kv_a,
                           const void* __restrict__ kv_b, const uint8_t* __restrict__ valid,
                           __nv_bfloat16* __restrict__ out,
                           int H, int KV, int Lq, int Lk, long long qsb, long long qsh,
                           long long qsl, long long osb, long long osh, long long osl, int q_pos0,
                           float scale) {
  extern __shared__ __align__(16) float smem[];
  float* kt = smem;              // [D][kBK]  keys transposed
  float* vs = kt + D * kBK;      // [kBK][D]
  float* qs = vs + kBK * D;      // [kBQ][D + 1]  (odd stride: no bank conflicts)
  __shared__ int key_ok[kBK];

  const int tid = threadIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int i0 = blockIdx.x * kBQ;
  const int i = i0 + tid;
  const bool row_ok = i < Lq;
  const int qpos = q_pos0 + i;
  const int horizon = q_pos0 + min(Lq, i0 + kBQ) - 1;

  for (int idx = tid; idx < kBQ * D; idx += kBQ) {
    const int r = idx / D, c = idx % D, qi = i0 + r;
    qs[r * (D + 1) + c] =
        qi < Lq ? round_bf(bf(q[b * qsb + h * qsh + qi * qsl + c]) * scale) : 0.f;
  }
  const size_t key0 = ((size_t)b * KV + kvh) * (size_t)Lk;
  const uint8_t* vrow = valid + (size_t)b * Lk;

  float m = kNegInf, l = 0.f;
  float acc[D];
#pragma unroll
  for (int d = 0; d < D; ++d) acc[d] = 0.f;

  for (int j0 = 0; j0 < Lk; j0 += kBK) {
    if (j0 > horizon && !__syncthreads_or(row_ok && m == kNegInf)) break;
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kBQ) {
      const int r = idx / D, c = idx % D, j = j0 + r;
      // Unconditional loads (at a clamped key), then a select: predicated
      // loads or a branch around them made K2 about 20% slower (NVIDIA H100
      // 80GB HBM3, 700 W, with this body shared by K2 and K5).
      float kk, vv;
      KVSource::load(kv_a, kv_b, key0 + min(j, Lk - 1), c, kk, vv);
      const bool in = j < Lk;
      kt[c * kBK + r] = in ? kk : 0.f;
      vs[r * D + c] = in ? vv : 0.f;
    }
    if (tid < kBK) key_ok[tid] = (j0 + tid < Lk) ? (vrow[j0 + tid] != 0 ? 1 : 0) : -1;
    __syncthreads();
    if (!row_ok) continue;

    float s[kBK];
#pragma unroll
    for (int c = 0; c < kBK; ++c) s[c] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      const float qd = qs[tid * (D + 1) + d];
      const float4* kr = reinterpret_cast<const float4*>(kt + d * kBK);
#pragma unroll
      for (int c4 = 0; c4 < kBK / 4; ++c4) {
        const float4 kk = kr[c4];
        s[4 * c4 + 0] = fmaf(qd, kk.x, s[4 * c4 + 0]);
        s[4 * c4 + 1] = fmaf(qd, kk.y, s[4 * c4 + 1]);
        s[4 * c4 + 2] = fmaf(qd, kk.z, s[4 * c4 + 2]);
        s[4 * c4 + 3] = fmaf(qd, kk.w, s[4 * c4 + 3]);
      }
    }
    float mt = -INFINITY;
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      const int ok = key_ok[c];
      if (ok < 0) s[c] = -INFINITY;                        // past Lk: no key at all
      else if (!(ok && j0 + c <= qpos)) s[c] = kNegInf;  // masked key
      mt = fmaxf(mt, s[c]);
    }
    const float m_new = fmaxf(m, mt);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int c = 0; c < kBK; ++c) {
      s[c] = expf(s[c] - m_new);
      psum += s[c];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int d4 = 0; d4 < D / 4; ++d4) {
      float4 a = make_float4(acc[4 * d4] * alpha, acc[4 * d4 + 1] * alpha,
                             acc[4 * d4 + 2] * alpha, acc[4 * d4 + 3] * alpha);
#pragma unroll
      for (int c = 0; c < kBK; ++c) {
        const float4 vv = reinterpret_cast<const float4*>(vs + c * D)[d4];
        a.x = fmaf(s[c], vv.x, a.x);
        a.y = fmaf(s[c], vv.y, a.y);
        a.z = fmaf(s[c], vv.z, a.z);
        a.w = fmaf(s[c], vv.w, a.w);
      }
      acc[4 * d4] = a.x;
      acc[4 * d4 + 1] = a.y;
      acc[4 * d4 + 2] = a.z;
      acc[4 * d4 + 3] = a.w;
    }
    m = m_new;
  }
  if (!row_ok) return;
  const float denom = l == 0.f ? 1.f : l;
  __nv_bfloat16* o = out + b * osb + h * osh + i * osl;
#pragma unroll
  for (int d = 0; d < D; ++d) o[d] = __float2bfloat16(acc[d] / denom);
}

template <int D, class KVSource>
cudaError_t launch_flash(const void* q, const void* kv_a, const void* kv_b, const void* valid,
                         void* out, int B, int H, int KV, int Lq, int Lk, const long long* st,
                         int q_pos0, float scale, cudaStream_t stream) {
  const size_t bytes = sizeof(float) * (2 * D * kBK + kBQ * (D + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D, KVSource>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid((Lq + kBQ - 1) / kBQ, H, B);
  flash_attention_kernel<D, KVSource><<<grid, kBQ, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kv_a, kv_b, static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), H, KV, Lq, Lk, st[0], st[1], st[2], st[3], st[4], st[5],
      q_pos0, scale);
  return cudaGetLastError();
}

}  // namespace
