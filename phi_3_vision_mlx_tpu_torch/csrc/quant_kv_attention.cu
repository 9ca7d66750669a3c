// Kernels K4 (decode attention over the int4 KV cache) and K5 (flash
// attention of a prefill or extend chunk over the int4 KV cache).  Each has
// its own entry point.
//
// K4 replaces phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:
// quantized_kv_attention (:603), body _kernel (:51).  K5 replaces
// kv_attention.py:quantized_flash_attention (:777), body _qflash_kernel
// (:692).
//
// The cache (engine/state.py) is token-major and in the original D order:
// payload (layers, B, KV, Lmax, D) uint8 with byte d = k_q[d] | v_q[d] << 4,
// scales (layers, B, KV, Lmax, 4G) bf16 = [k_scale, k_bias, v_scale, v_bias]
// for G = D / 32 groups.  A value dequantizes to bf16(f32(q * s) + b), the
// bits of the plain path (attention.cuh: dequant).  The TPU kernel factors
// the bias out of the dot products to spare its vector unit two passes over
// each tile; here dequantizing in registers costs two f32 operations per
// value, so the bias is applied directly.  The masking and rounding rules
// are those of K2/K3 (attention.cuh).
//
// What bounds them on the H100:
// * K4 (decode, Lq <= 16) is bound by bytes: 120 B per (kv head, key) at
//   D = 96 (96 B of payload, 24 B of scales), a third of the dense cache's
//   384 B.  A warp takes one key at a time: lane l holds dims l, l + 32,
//   l + 64, which are groups 0, 1 and 2, so a key's 96 payload bytes are one
//   coalesced read and its 24 B of scales one broadcast.  K3's grid (one
//   block per query row and head) fills only 32 of the 132 SMs at B = 1, so
//   K4 splits the window into runs of `split_keys` keys, one block each, and
//   a second kernel merges the blocks' (max, sum, output) in a fixed order:
//   deterministic, and 17 x 32 blocks at a 4352-key window.  A window of one
//   run skips the second kernel.
// * K5 (prefill, extend) is bound by operations like K2 and runs K2's
//   tensor-core flash body (flash_mma.cuh) behind its `Tiles` seam, with the
//   loader Int4Tiles: a tile of 64 keys arrives raw (6 KB of payload, 1.5 KB
//   of scales) in a two-stage ring of 16- and 8-byte cp.async copies, read
//   in place from the stacked cache with no dequantized copy in memory, and
//   is dequantized once per block into the bf16 K and V tiles the products
//   read — not per warp into fragments, which would dequantize every value
//   four times (each warp needs every key).  The dequantized values are the
//   plain path's bits (attention.cuh: dequant_fma); as in K2, P is rounded
//   to bf16 before P V.  Shared memory: 13 KB of Q, 15 KB of raw ring and
//   26 KB of K and V tiles, 54 KB a block; three blocks an SM, as K2 (the
//   launch bound).
//
// E2 and E3 (the experiment kernels experiments/qkv_probe.py:probe_attention
// (:84) and experiments/qdecode_sweep.py:qkv_attn (:196)) are K4's decode
// kernel with a compile-time MODE that changes how a key and a value are
// dequantized (entry e23_quantized_kv_attention_variant):
//   kFp32      K4 itself (E2 "full", E3 "fp32" and "u8"): bf16(q * s + b);
//   kBf16      bf16 arithmetic: bf16(bf16(q * s) + b);
//   kConvert   the raw level q (E2 "convert", E3 "noscale"; no scale loads);
//   kNoMul     bf16(q + s), no multiply and no bias;
//   kFBias     bf16(q * s), the bias factored out: each score gains
//              sum_g b_g * (sum of the query over group g), the output
//              sum_j p_j * b_g(d), both accumulated beside the main sums;
//   kMxu       scale and bias both factored: scores (q_d * lvl) * s_g, the
//              output (p * s_g) * lvl, and the biases as in kFBias;
//   kNoSoftmax E2 "mxuonly": kConvert with no mask and no softmax over all
//              Lmax keys, out = sum_j score_j * lvl_j.
// The groups are the port's d / 32, not the TPU's permuted c % G.  K4's
// production instantiation is MODE = kFp32, whose code the other modes leave
// as it was (each difference is an `if constexpr`).
//
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "flash_mma.cuh"

namespace {

// K5's loader behind the flash body's seam (flash_mma.cuh): a = the layer's
// payload (B, KV, Lk, D) uint8, 16-byte aligned, b = its scales (B, KV, Lk,
// 4G) bf16, 8-byte aligned.  A raw stage is the int4 raw tile
// (flash_mma.cuh: kInt4TileBytes); keys past Lk are copied from the clamped
// key Lk - 1, as in DenseTiles (the kernel masks them in the scores).
template <int D>
struct Int4Tiles {
  static constexpr int G = D / kGroup;
  static constexpr int kStride = D + 8;
  static constexpr int kRawBytes = kInt4TileBytes<D>;

  static __device__ __forceinline__ void issue(__nv_bfloat16*, __nv_bfloat16*, unsigned char* raw,
                                               const void* __restrict__ a,
                                               const void* __restrict__ b, size_t key0, int j0,
                                               int Lk) {
    constexpr int kChunks = D / 16;  // 16-byte payload chunks per key
    const uint8_t* p = static_cast<const uint8_t*>(a) + key0 * D;
    const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(b) + key0 * 4 * G;
    __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(raw + kMmaBK * D);
    for (int idx = threadIdx.x; idx < kMmaBK * kChunks; idx += kMmaThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      cp_async16(raw + r * D + c * 16, p + (size_t)min(j0 + r, Lk - 1) * D + c * 16);
    }
    for (int idx = threadIdx.x; idx < kMmaBK * G; idx += kMmaThreads) {  // G pieces of 8 B a key
      const int r = idx / G, c = idx % G;
      cp_async8(rs + r * 4 * G + c * 4, sc + (size_t)min(j0 + r, Lk - 1) * 4 * G + c * 4);
    }
  }

  static __device__ __forceinline__ void convert(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                                 const unsigned char* raw) {
    dequantize_int4_tile<D>(ks, vs, raw);
  }
};

enum Mode { kFp32 = 0, kBf16, kConvert, kNoMul, kFBias, kMxu, kNoSoftmax };

// Modes that read no scales, and modes that add the bias outside the dot
// products.
template <int MODE>
constexpr bool kRaw = MODE == kConvert || MODE == kNoSoftmax;
template <int MODE>
constexpr bool kFactored = MODE == kFBias || MODE == kMxu;

template <int MODE, int G>
__device__ __forceinline__ KeyScales<G> mode_scales(const __nv_bfloat16* sc) {
  if constexpr (kRaw<MODE>) return KeyScales<G>{};
  else return load_scales<G>(sc);
}

// A level q with its group's scale s and bias b as the mode dequantizes it
// (without the bias in the factored modes).
template <int MODE>
__device__ __forceinline__ float deq(unsigned q, float s, float b) {
  if constexpr (MODE == kFp32) return dequant(q, s, b);
  else if constexpr (MODE == kBf16) return round_bf(__fadd_rn(round_bf(__fmul_rn(static_cast<float>(q), s)), b));
  else if constexpr (MODE == kNoMul) return round_bf(__fadd_rn(static_cast<float>(q), s));
  else if constexpr (MODE == kFBias) return round_bf(__fmul_rn(static_cast<float>(q), s));
  else if constexpr (MODE == kMxu) return __fmul_rn(static_cast<float>(q), s);
  else return static_cast<float>(q);
}

// A value as the mode dequantizes it, bias included.
template <int MODE>
__device__ __forceinline__ float deq_value(unsigned q, float s, float b) {
  if constexpr (kFactored<MODE>) return __fadd_rn(deq<MODE>(q, s, b), b);
  else return deq<MODE>(q, s, b);
}

// The uniform average of every value of the window, for a query row that
// sees no key.  Called by the whole block; sm_acc is [kWarps][D] scratch.
template <int D, int MODE>
__device__ void store_uniform_average(const uint8_t* pb, const __nv_bfloat16* sb, int Lmax,
                                      float (*sm_acc)[D], __nv_bfloat16* o) {
  constexpr int G = D / kGroup;
  constexpr int kWarps = kDecThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  __syncthreads();
  float sum[G];
#pragma unroll
  for (int r = 0; r < G; ++r) sum[r] = 0.f;
  for (int j = warp; j < Lmax; j += kWarps) {
    const KeyScales<G> sc = mode_scales<MODE, G>(sb + (size_t)j * 4 * G);
#pragma unroll
    for (int r = 0; r < G; ++r)
      sum[r] += deq_value<MODE>(pb[(size_t)j * D + lane + 32 * r] >> 4, sc.at(2 * G + r), sc.at(3 * G + r));
  }
#pragma unroll
  for (int r = 0; r < G; ++r) sm_acc[warp][lane + 32 * r] = sum[r];
  __syncthreads();
  if (threadIdx.x < D) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][threadIdx.x];
    o[threadIdx.x] = __float2bfloat16(a / (float)Lmax);
  }
}

// Grid (n_split, H, B * Lq).  Block s attends query row i of head h to keys
// [s * split_keys, min((s + 1) * split_keys, pos(i) + 1)).  With one split it
// writes the output; otherwise it writes (max, sum, unnormalized output) to
// partial[s, row] for the combine kernel, row = (b * H + h) * Lq + i.
// kNoSoftmax runs over keys [s * split_keys, (s + 1) * split_keys) of the
// whole window, with no mask, and writes plain sums.
template <int D, int MODE>
__global__ void __launch_bounds__(kDecThreads)
    quantized_kv_partial_kernel(const __nv_bfloat16* __restrict__ q,
                                const uint8_t* __restrict__ payload,
                                const __nv_bfloat16* __restrict__ scales,
                                const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ out,
                                float* __restrict__ partial, int H, int KV, int Lq, int Lmax,
                                long long qsb, long long qsh, long long qsl, long long osb,
                                long long osh, long long osl, int offset, float scale,
                                int split_keys) {
  constexpr int G = D / kGroup;  // groups along D == dims per lane
  constexpr int kWarps = kDecThreads / 32;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int split = blockIdx.x, h = blockIdx.y;
  const int b = blockIdx.z / Lq, i = blockIdx.z % Lq;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t key0 = ((size_t)b * KV + kvh) * (size_t)Lmax;
  const uint8_t* pb = payload + key0 * D;
  const __nv_bfloat16* sb = scales + key0 * 4 * G;
  const uint8_t* vrow = valid + (size_t)b * Lmax;
  const int qpos = offset + i;
  const int jbeg = split * split_keys;
  const int jend = MODE == kNoSoftmax ? min(Lmax, jbeg + split_keys)
                                      : min(min(Lmax, qpos + 1), jbeg + split_keys);

  float qv[G];
#pragma unroll
  for (int r = 0; r < G; ++r)
    qv[r] = round_bf(bf(q[b * qsb + h * qsh + i * qsl + lane + 32 * r]) * scale);
  // The factored modes: the sum of the query over each group (lane l holds
  // dim l + 32 r of group r), and the bias term of the output.
  float qs[G], pbias[G];
  if constexpr (kFactored<MODE>) {
#pragma unroll
    for (int r = 0; r < G; ++r) {
      float t = qv[r];
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) t += __shfl_xor_sync(0xffffffffu, t, sh);
      qs[r] = t;
      pbias[r] = 0.f;
    }
  }

  float m = kNegInf, l = 0.f, acc[G];
#pragma unroll
  for (int r = 0; r < G; ++r) acc[r] = 0.f;
  for (int j = jbeg + warp; j < jend; j += kWarps) {
    unsigned byte[G];
#pragma unroll
    for (int r = 0; r < G; ++r) byte[r] = pb[(size_t)j * D + lane + 32 * r];
    const KeyScales<G> sc = mode_scales<MODE, G>(sb + (size_t)j * 4 * G);
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if constexpr (MODE == kMxu) part = fmaf(qv[r] * static_cast<float>(byte[r] & 15u), sc.at(r), part);
      else part = fmaf(qv[r], deq<MODE>(byte[r] & 15u, sc.at(r), sc.at(G + r)), part);
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) part += __shfl_xor_sync(0xffffffffu, part, sh);
    if constexpr (kFactored<MODE>) {
#pragma unroll
      for (int r = 0; r < G; ++r) part = fmaf(qs[r], sc.at(G + r), part);
    }
    if constexpr (MODE == kNoSoftmax) {
#pragma unroll
      for (int r = 0; r < G; ++r) acc[r] = fmaf(part, static_cast<float>(byte[r] >> 4), acc[r]);
      continue;
    }
    const float s = vrow[j] ? part : kNegInf;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int r = 0; r < G; ++r) {
      if constexpr (MODE == kMxu)
        acc[r] = fmaf(p * sc.at(2 * G + r), static_cast<float>(byte[r] >> 4), acc[r] * alpha);
      else
        acc[r] = fmaf(p, deq<MODE>(byte[r] >> 4, sc.at(2 * G + r), sc.at(3 * G + r)), acc[r] * alpha);
      if constexpr (kFactored<MODE>) pbias[r] = fmaf(p, sc.at(3 * G + r), pbias[r] * alpha);
    }
    m = m_new;
  }
  if constexpr (kFactored<MODE>) {
#pragma unroll
    for (int r = 0; r < G; ++r) acc[r] += pbias[r];
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int r = 0; r < G; ++r) sm_acc[warp][lane + 32 * r] = acc[r];
  __syncthreads();

  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  float lsum = 0.f, a = 0.f;
  if (threadIdx.x < D) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mx);
      lsum += sm_l[w] * f;
      a += sm_acc[w][threadIdx.x] * f;
    }
  }
  if (gridDim.x > 1) {
    const size_t row = ((size_t)b * H + h) * Lq + i;
    float* dst = partial + ((size_t)split * gridDim.y * gridDim.z + row) * (D + 2);
    if (threadIdx.x < D) dst[2 + threadIdx.x] = a;
    if (threadIdx.x == 0) {
      dst[0] = mx;
      dst[1] = lsum;
    }
    return;
  }
  __nv_bfloat16* o = out + b * osb + h * osh + i * osl;
  if constexpr (MODE == kNoSoftmax) {
    if (threadIdx.x < D) o[threadIdx.x] = __float2bfloat16(a);
    return;
  }
  if (mx > kNegInf) {
    if (threadIdx.x < D) o[threadIdx.x] = __float2bfloat16(a / lsum);
    return;
  }
  store_uniform_average<D, MODE>(pb, sb, Lmax, sm_acc, o);
}

// Grid (H, B * Lq): merges the n_split partial results of one query row in
// split order (kNoSoftmax: adds them).
template <int D, int MODE>
__global__ void __launch_bounds__(kDecThreads)
    quantized_kv_combine_kernel(const float* __restrict__ partial,
                                const uint8_t* __restrict__ payload,
                                const __nv_bfloat16* __restrict__ scales,
                                __nv_bfloat16* __restrict__ out, int H, int KV, int Lq, int Lmax,
                                long long osb, long long osh, long long osl, int n_split) {
  constexpr int G = D / kGroup;
  constexpr int kWarps = kDecThreads / 32;
  __shared__ float sm_acc[kWarps][D];

  const int h = blockIdx.x, b = blockIdx.y / Lq, i = blockIdx.y % Lq;
  const size_t rows = (size_t)gridDim.x * gridDim.y;
  const float* src = partial + (((size_t)b * H + h) * Lq + i) * (D + 2);
  __nv_bfloat16* o = out + b * osb + h * osh + i * osl;
  if constexpr (MODE == kNoSoftmax) {
    if (threadIdx.x < D) {
      float a = 0.f;
      for (int s = 0; s < n_split; ++s) a += src[s * rows * (D + 2) + 2 + threadIdx.x];
      o[threadIdx.x] = __float2bfloat16(a);
    }
    return;
  }
  float mx = kNegInf;
  for (int s = 0; s < n_split; ++s) mx = fmaxf(mx, src[s * rows * (D + 2)]);
  if (mx > kNegInf) {
    if (threadIdx.x < D) {
      float lsum = 0.f, a = 0.f;
      for (int s = 0; s < n_split; ++s) {
        const float* ps = src + s * rows * (D + 2);
        const float f = expf(ps[0] - mx);
        lsum += ps[1] * f;
        a += ps[2 + threadIdx.x] * f;
      }
      o[threadIdx.x] = __float2bfloat16(a / lsum);
    }
    return;
  }
  const int kvh = h / (H / KV);
  const size_t key0 = ((size_t)b * KV + kvh) * (size_t)Lmax;
  store_uniform_average<D, MODE>(payload + key0 * D, scales + key0 * 4 * G, Lmax, sm_acc, o);
}

template <int D, int MODE>
cudaError_t launch_quantized_decode(const void* q, const void* payload, const void* scales,
                                    const void* valid, void* out, void* partial, int B, int H,
                                    int KV, int Lq, int Lmax, const long long* st, int layer,
                                    int offset, float scale, int n_split, int split_keys,
                                    cudaStream_t stream) {
  constexpr int G = D / kGroup;
  if (n_split < 1 || (n_split > 1 && partial == nullptr) || split_keys < 1) return cudaErrorInvalidValue;
  const size_t layer_keys = (size_t)B * KV * Lmax;
  const uint8_t* p = static_cast<const uint8_t*>(payload) + (size_t)layer * layer_keys * D;
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(scales) + (size_t)layer * layer_keys * 4 * G;
  dim3 grid(n_split, H, B * Lq);
  quantized_kv_partial_kernel<D, MODE><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), p, s, static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), static_cast<float*>(partial), H, KV, Lq, Lmax, st[0],
      st[1], st[2], st[3], st[4], st[5], offset, scale, split_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  quantized_kv_combine_kernel<D, MODE><<<dim3(H, B * Lq), kDecThreads, 0, stream>>>(
      static_cast<const float*>(partial), p, s, static_cast<__nv_bfloat16*>(out), H, KV, Lq, Lmax,
      st[3], st[4], st[5], n_split);
  return cudaGetLastError();
}

}  // namespace

// K4.  q (B, H, Lq, D) bf16 with element strides (qsb, qsh, qsl) and unit
// stride along D; payload (layers, B, KV, Lmax, D) uint8 and scales (layers,
// B, KV, Lmax, 4G) bf16, contiguous, read at `layer` in place; valid (B,
// Lmax) uint8; out (B, H, Lq, D) bf16 with strides (osb, osh, osl); partial
// f32 scratch of n_split * B * H * Lq * (D + 2) floats (unused when n_split
// is 1).  Query i sits at position offset + i.  Returns a cudaError_t.
extern "C" int k4_quantized_kv_attention(const void* q, const void* payload, const void* scales,
                                         const void* valid, void* out, void* partial, int B,
                                         int H, int KV, int Lq, int Lmax, int D, long long qsb,
                                         long long qsh, long long qsl, long long osb,
                                         long long osh, long long osl, int layer, int offset,
                                         float scale, int n_split, int split_keys,
                                         void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  switch (D) {
    case 96: return (int)launch_quantized_decode<96, kFp32>(q, payload, scales, valid, out, partial, B, H, KV, Lq, Lmax, st, layer, offset, scale, n_split, split_keys, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K5.  q, out, valid as in K4, any Lq, out 4-byte aligned; the cache as in
// K4, the payload 16-byte aligned.  Query i sits at absolute position
// q_pos0 + i.  Returns a cudaError_t.
extern "C" int k5_quantized_flash_attention(const void* q, const void* payload, const void* scales,
                                            const void* valid, void* out, int B, int H, int KV,
                                            int Lq, int Lmax, int D, long long qsb, long long qsh,
                                            long long qsl, long long osb, long long osh,
                                            long long osl, int layer, int q_pos0, float scale,
                                            void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  const size_t layer_keys = (size_t)B * KV * Lmax;
  switch (D) {
    case 96: {
      constexpr int G = Int4Tiles<96>::G;
      const void* p = static_cast<const uint8_t*>(payload) + (size_t)layer * layer_keys * 96;
      const void* s = static_cast<const __nv_bfloat16*>(scales) + (size_t)layer * layer_keys * 4 * G;
      return (int)launch_flash_mma<96, Int4Tiles<96>>(q, p, s, valid, out, B, H, KV, Lq, Lmax, st, q_pos0, scale, stream);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

// E2/E3.  As k4_quantized_kv_attention, with `mode` one of Mode (kFp32 is
// K4's own instantiation).  kNoSoftmax ignores offset and valid and splits
// the whole window.  Returns a cudaError_t.
extern "C" int e23_quantized_kv_attention_variant(const void* q, const void* payload,
                                                  const void* scales, const void* valid, void* out,
                                                  void* partial, int B, int H, int KV, int Lq,
                                                  int Lmax, int D, long long qsb, long long qsh,
                                                  long long qsl, long long osb, long long osh,
                                                  long long osl, int layer, int offset,
                                                  float scale, int n_split, int split_keys,
                                                  int mode, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  if (D != 96) return (int)cudaErrorInvalidValue;
#define E23_CASE(M)                                                                               \
  case M:                                                                                         \
    return (int)launch_quantized_decode<96, M>(q, payload, scales, valid, out, partial, B, H, KV, \
                                               Lq, Lmax, st, layer, offset, scale, n_split,      \
                                               split_keys, stream);
  switch (mode) {
    E23_CASE(kFp32)
    E23_CASE(kBf16)
    E23_CASE(kConvert)
    E23_CASE(kNoMul)
    E23_CASE(kFBias)
    E23_CASE(kMxu)
    E23_CASE(kNoSoftmax)
    default: return (int)cudaErrorInvalidValue;
  }
#undef E23_CASE
}
