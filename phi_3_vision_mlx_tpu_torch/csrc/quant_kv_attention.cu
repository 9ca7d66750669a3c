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
//   384 B.  It runs the split-run decode body of split_runs.cuh (K7's, on
//   the tensor cores) through the Stacked window: blocks of `block_keys`
//   keys (the wrapper's quantized_split_plan: a count per window from the
//   H100, the window only, never the offset), each walking its 64-key runs
//   with the next run's raw copy in flight, one block per (block of runs,
//   query head, batch row) for all Lq rows of the row, each run dequantized
//   once into bf16 tiles by the Int4Run loader (K7's); a second kernel
//   merges the blocks in a fixed order (deterministic).
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
// (:84) and experiments/qdecode_sweep.py:qkv_attn (:196)) are K4's kernels
// with a compile-time MODE (attention.cuh: Mode) that changes what the
// int4 loader's tiles hold and, for the factored modes and kNoSoftmax, the
// run body (split_runs.cuh); entry e23_quantized_kv_attention_variant.  The
// groups are the port's d / 32, not the TPU's permuted c % G.  K4's
// production instantiation is MODE = kFp32.
//
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "split_runs.cuh"

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

// K4's window (split_runs.cuh) over one layer of the stacked cache (B, KV,
// Lmax, ...): batch row s's key j of kv head kvh at row (s * KV + kvh) *
// Lmax + j; query i sits at offset + i for every row and sees key j iff j
// <= offset + i and valid[s, j] (no fresh region: the step's keys are
// written and listed before the kernel runs).  The offset is one int32 in
// device memory, which each block loads once (a captured launch replays at
// any offset).
struct Stacked {
  const uint8_t* valid;  // (B, Lmax)
  const int* off;        // (1,) int32, on the device
  int KV, L;
  __host__ __device__ __forceinline__ int width() const { return L; }
  __device__ __forceinline__ int offset(int) const { return *off; }
  __device__ __forceinline__ size_t row(int s, int kvh, int j) const { return ((size_t)s * KV + kvh) * L + j; }
  __device__ __forceinline__ bool listed(int s, int j, int) const { return valid[(size_t)s * L + j] != 0; }
};

template <int D, int MODE>
cudaError_t launch_quantized_decode(const void* q, const void* payload, const void* scales,
                                    const void* valid, void* out, void* partial, int B, int H,
                                    int KV, int Lq, int Lmax, const long long* st, int layer,
                                    const void* offset, float scale, int n_split, int block_keys,
                                    cudaStream_t stream) {
  constexpr int G = D / kGroup;
  if (offset == nullptr) return cudaErrorInvalidValue;
  const size_t layer_keys = (size_t)B * KV * Lmax;
  const uint8_t* p = static_cast<const uint8_t*>(payload) + (size_t)layer * layer_keys * D;
  const __nv_bfloat16* s = static_cast<const __nv_bfloat16*>(scales) + (size_t)layer * layer_keys * 4 * G;
  const Stacked win{static_cast<const uint8_t*>(valid), static_cast<const int*>(offset), KV, Lmax};
  return launch_split_runs<D, Int4Run<D, MODE>>(q, p, s, win, out, partial, B, H, Lq, st, scale,
                                                 n_split, block_keys, stream);
}

}  // namespace

// K4.  q (B, H, Lq, D) bf16 with element strides (qsb, qsh, qsl) and unit
// stride along D; payload (layers, B, KV, Lmax, D) uint8 and scales (layers,
// B, KV, Lmax, 4G) bf16, contiguous, read at `layer` in place; valid (B,
// Lmax) uint8; out (B, H, Lq, D) bf16 with strides (osb, osh, osl); partial
// f32 scratch of n_split * B * H * Lq * (D + 2) floats; Lq <= 16;
// split_keys (keys per block) a multiple of 64 and n_split = ceil(Lmax /
// split_keys) (the wrapper's quantized_split_plan); payload 16-byte and
// scales 8-byte aligned; offset a device pointer to one int32 >= 0 (the
// caller checks it).  Query i sits at position *offset + i.  Returns a
// cudaError_t.
extern "C" int k4_quantized_kv_attention(const void* q, const void* payload, const void* scales,
                                         const void* valid, void* out, void* partial, int B,
                                         int H, int KV, int Lq, int Lmax, int D, long long qsb,
                                         long long qsh, long long qsl, long long osb,
                                         long long osh, long long osl, int layer,
                                         const void* offset, float scale, int n_split, int split_keys,
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
// K4's own instantiation).  kNoSoftmax ignores offset and valid and reads
// the whole window.  Returns a cudaError_t.
extern "C" int e23_quantized_kv_attention_variant(const void* q, const void* payload,
                                                  const void* scales, const void* valid, void* out,
                                                  void* partial, int B, int H, int KV, int Lq,
                                                  int Lmax, int D, long long qsb, long long qsh,
                                                  long long qsl, long long osb, long long osh,
                                                  long long osl, int layer, const void* offset,
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
