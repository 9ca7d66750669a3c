// Shared by the attention kernels: the masking and rounding rules and the
// int4 cache's dequantization (K4, K5, K7) and per-key scale loads (K4).  K2
// and K5 run the tensor-core flash body of flash_mma.cuh.
//
// The rules, as in the plain path (ops/attention.py): q * scale is rounded
// to the input type before the dot product, scores and the softmax are f32,
// masked scores take the finite NEG_INF = -0.7 * FLT_MAX (never -inf), and a
// row with no visible key comes out as the uniform average of all Lk values
// — finite, so a padded cache position is never poisoned by 0 * NaN in p.V.
// Key j is visible from query i iff j <= pos(i) and valid[b, j].  GQA: query
// head h reads kv head h / (H / KV).
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <float.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kNegInf = -0.7f * FLT_MAX;
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

// dequant's f32 value (before the bf16 rounding) in fewer instructions (K5,
// K7).  A level q <= 15 becomes f32 as the bits of 2^23 + q less 2^23
// (exact: a logic op and an add, both at full rate, where an int-to-float
// conversion runs at a fraction of it).  q * s has at most 4 + 8
// significant bits (s is a bf16), so it is exact in f32, and one fused
// multiply-add rounds q * s + b once: dequant's f32 value, bit for bit.
__device__ __forceinline__ float dequant_fma(unsigned q, float s, float b) {
  return __fmaf_rn(__int_as_float(0x4B000000u | q) - 8388608.f, s, b);
}

// The int4 cache (K4): one key's 4G scales: G loads of 8 bytes (4G bf16 = 8G bytes per key).
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

}  // namespace
