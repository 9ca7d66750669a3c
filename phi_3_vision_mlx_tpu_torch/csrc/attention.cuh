// Shared by the attention kernels: the masking and rounding rules and the
// int4 cache's dequantization (K4, K5, K7, and E2/E3's modes of it).  K2 and
// K5 run the tensor-core flash body of flash_mma.cuh; K4, K6 and K7 the
// split-run decode body of split_runs.cuh.
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
constexpr int kGroup = 32;  // quantized cache: values per scale/bias group along D

__device__ __forceinline__ float bf(const __nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float round_bf(float v) { return __bfloat162float(__float2bfloat16(v)); }

// One quantized value, as the plain path computes it: f32 q * s, then + b,
// each rounded on its own, then rounded once to bf16 (the bits of
// _kv_dequantize(...).to(bfloat16)).  dequant_fma gives that f32 value in
// fewer instructions.  A level q <= 15 becomes f32 as the bits of 2^23 + q
// less 2^23 (exact: a logic op and an add, both at full rate, where an
// int-to-float conversion runs at a fraction of it).  q * s has at most 4 +
// 8 significant bits (s is a bf16), so it is exact in f32, and one fused
// multiply-add rounds q * s + b once: the plain path's f32 value, bit for
// bit.  (A paired bf16 fma would round q * s + b once to bf16 instead, which
// is another function: q = 3, s = 1.0078125, b = -2^-30 gives 3.015625
// there and 3.03125 on the plain path.)
__device__ __forceinline__ float level_f(unsigned q) { return __int_as_float(0x4B000000u | q) - 8388608.f; }

// Byte n of a word of levels (each byte <= 15) as f32, the same way: one
// byte permute puts it under 2^23's exponent (the int4 tiles mask a word's
// four key or value nibbles at once).
__device__ __forceinline__ float byte_level(unsigned w, int n) {
  return __int_as_float(__byte_perm(w, 0x4B000000u, 0x7440 | n)) - 8388608.f;
}

__device__ __forceinline__ float dequant_fma(float lv, float s, float b) { return __fmaf_rn(lv, s, b); }

// E2/E3 (experiments/qkv_probe.py, experiments/qdecode_sweep.py): how a level
// q of a group with scale s and bias b becomes a key or a value, mode by mode
// (ops/kernels/kv_attention.py:_variant_kv is the plain version):
//   kFp32      K4 itself: bf16(q * s + b);
//   kBf16      bf16 arithmetic: bf16(bf16(q * s) + b);
//   kConvert   the raw level q (no scales read);
//   kNoMul     bf16(q + s), no multiply and no bias;
//   kFBias     bf16(q * s) + b, the bias factored out of the dot products;
//   kMxu       q * s + b, scale and bias both factored out;
//   kNoSoftmax kConvert with no mask and no softmax: out = sum_j score_j v_j.
enum Mode { kFp32 = 0, kBf16, kConvert, kNoMul, kFBias, kMxu, kNoSoftmax };

// Modes that read no scales, and modes that add the bias (and, for kMxu,
// the scale) outside the dot products.
template <int MODE>
constexpr bool kRaw = MODE == kConvert || MODE == kNoSoftmax;
template <int MODE>
constexpr bool kFactored = MODE == kFBias || MODE == kMxu;

// What a bf16 K or V tile holds for a level lv (f32; before the tile's
// rounding to bf16, which is exact for every mode but kFp32's and kNoMul's).
template <int MODE>
__device__ __forceinline__ float tile_value(float lv, float s, float b) {
  if constexpr (MODE == kFp32) return dequant_fma(lv, s, b);
  else if constexpr (MODE == kBf16) return round_bf(__fadd_rn(round_bf(__fmul_rn(lv, s)), b));
  else if constexpr (MODE == kNoMul) return __fadd_rn(lv, s);
  else if constexpr (MODE == kFBias) return __fmul_rn(lv, s);
  else return lv;  // kConvert, kNoSoftmax, kMxu: the raw level
}

// A key or value as the mode defines it, bias included (the uniform average
// of a row that sees no key).
template <int MODE>
__device__ __forceinline__ float mode_value(float lv, float s, float b) {
  if constexpr (MODE == kFBias) return __fadd_rn(round_bf(__fmul_rn(lv, s)), b);
  else if constexpr (MODE == kMxu) return __fmaf_rn(lv, s, b);
  else return round_bf(tile_value<MODE>(lv, s, b));
}

}  // namespace
