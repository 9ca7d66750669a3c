// Kernels K2 (masked flash attention for prefill and extend) and K3 (decode
// attention over the stacked dense KV cache).  Each has its own entry point.
//
// K2 replaces phi_3_vision_mlx_tpu/ops/kernels/flash_attention.py:
// flash_attention (:112), body _kernel (:34).  K3 replaces
// phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:dense_kv_attention (:213),
// body _dense_kernel (:151).
//
// The masking and rounding rules, and the flash body that K2 shares with
// K5, are in attention.cuh.
//
// What bounds them on the H100:
// * K2 (prefill, Lq ~ Lk in the thousands) is bound by FLOPs: 4 * Lq * Lk * D
//   per head for q.k and p.v, halved by causality.  This first version runs
//   them on the CUDA cores in f32 (not the tensor cores), with the flash body
//   of attention.cuh over bf16 tiles; wgmma for both products is later work.
// * K3 (decode, Lq <= 16) is bound by bytes: the layer's K and V for the
//   window, 2 * Lk * D * 2 B per (batch, kv head), read once per query row.
//   One block per (query row, head, batch); each warp takes every 8th key,
//   a lane holds D/32 dims, the score is a warp all-reduce, and the softmax is
//   online per warp; warps merge their (max, sum, acc) through shared memory.
//   At B = 1 this fills only 32 of the 132 SMs; split-K flash-decoding is
//   later work (K4 in quant_kv_attention.cu splits the window).  The cache is
//   read in place from the stacked (layers, B, KV, Lmax, D) buffer: no
//   per-layer copy.
//
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "attention.cuh"

namespace {

template <int D>
__global__ void __launch_bounds__(kDecThreads)
    dense_kv_attention_kernel(const __nv_bfloat16* __restrict__ q,
                              const __nv_bfloat16* __restrict__ k,
                              const __nv_bfloat16* __restrict__ v,
                              const uint8_t* __restrict__ valid, __nv_bfloat16* __restrict__ out,
                              int H, int KV, int Lmax, long long qsb, long long qsh,
                              long long qsl, long long osb, long long osh, long long osl,
                              int offset, float scale) {
  constexpr int PER = D / 32;
  constexpr int kWarps = kDecThreads / 32;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int i = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const size_t head = ((size_t)b * KV + kvh) * (size_t)Lmax * D;
  const __nv_bfloat16* kb = k + head;
  const __nv_bfloat16* vb = v + head;
  const uint8_t* vrow = valid + (size_t)b * Lmax;
  const int qpos = offset + i;
  const int kend = min(Lmax, qpos + 1);

  float qv[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r)
    qv[r] = round_bf(bf(q[b * qsb + h * qsh + i * qsl + lane + 32 * r]) * scale);

  float m = kNegInf, l = 0.f, acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc[r] = 0.f;
  for (int j = warp; j < kend; j += kWarps) {
    const __nv_bfloat16* kr = kb + (size_t)j * D + lane;
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < PER; ++r) part = fmaf(qv[r], bf(kr[32 * r]), part);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) part += __shfl_xor_sync(0xffffffffu, part, sh);
    const float s = vrow[j] ? part : kNegInf;
    const float m_new = fmaxf(m, s);
    const float alpha = expf(m - m_new);
    const float p = expf(s - m_new);
    l = l * alpha + p;
    const __nv_bfloat16* vr = vb + (size_t)j * D + lane;
#pragma unroll
    for (int r = 0; r < PER; ++r) acc[r] = fmaf(p, bf(vr[32 * r]), acc[r] * alpha);
    m = m_new;
  }
  if (lane == 0) {
    sm_m[warp] = m;
    sm_l[warp] = l;
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) sm_acc[warp][lane + 32 * r] = acc[r];
  __syncthreads();

  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  __nv_bfloat16* o = out + b * osb + h * osh + i * osl;
  if (mx > kNegInf) {
    if (threadIdx.x < D) {
      float lsum = 0.f, a = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float f = expf(sm_m[w] - mx);
        lsum += sm_l[w] * f;
        a += sm_acc[w][threadIdx.x] * f;
      }
      o[threadIdx.x] = __float2bfloat16(a / lsum);
    }
    return;
  }
  // No visible key: the uniform average of every value in the window.
  __syncthreads();
  float sum[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) sum[r] = 0.f;
  for (int j = warp; j < Lmax; j += kWarps) {
#pragma unroll
    for (int r = 0; r < PER; ++r) sum[r] += bf(vb[(size_t)j * D + lane + 32 * r]);
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) sm_acc[warp][lane + 32 * r] = sum[r];
  __syncthreads();
  if (threadIdx.x < D) {
    float a = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) a += sm_acc[w][threadIdx.x];
    o[threadIdx.x] = __float2bfloat16(a / (float)Lmax);
  }
}

template <int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* valid,
                          void* out, int B, int H, int KV, int Lq, int Lmax, const long long* st,
                          int layer, int offset, float scale, cudaStream_t stream) {
  const size_t layer_elems = (size_t)B * KV * Lmax * D;
  dim3 grid(Lq, H, B);
  dense_kv_attention_kernel<D><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k) + (size_t)layer * layer_elems,
      static_cast<const __nv_bfloat16*>(v) + (size_t)layer * layer_elems,
      static_cast<const uint8_t*>(valid), static_cast<__nv_bfloat16*>(out), H, KV, Lmax, st[0],
      st[1], st[2], st[3], st[4], st[5], offset, scale);
  return cudaGetLastError();
}

}  // namespace

// K2.  q (B, H, Lq, D) bf16 with element strides (qsb, qsh, qsl) and unit
// stride along D; k, v (B, KV, Lk, D) bf16 contiguous; valid (B, Lk) uint8;
// out (B, H, Lq, D) bf16 with strides (osb, osh, osl).  Query i sits at
// absolute position q_pos0 + i.  Returns a cudaError_t.
extern "C" int k2_flash_attention(const void* q, const void* k, const void* v, const void* valid,
                                  void* out, int B, int H, int KV, int Lq, int Lk, int D,
                                  long long qsb, long long qsh, long long qsl, long long osb,
                                  long long osh, long long osl, int q_pos0, float scale,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  switch (D) {
    case 96: return (int)launch_flash<96, DenseKV<96>>(q, k, v, valid, out, B, H, KV, Lq, Lk, st, q_pos0, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3.  q (B, H, Lq, D) as in K2; k, v the stacked cache (layers, B, KV, Lmax,
// D) bf16 contiguous, read at `layer` in place; valid (B, Lmax) uint8; query
// i sits at position offset + i.  Returns a cudaError_t.
extern "C" int k3_dense_kv_attention(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, int B, int H, int KV, int Lq,
                                     int Lmax, int D, long long qsb, long long qsh, long long qsl,
                                     long long osb, long long osh, long long osl, int layer,
                                     int offset, float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  switch (D) {
    case 96: return (int)launch_decode<96>(q, k, v, valid, out, B, H, KV, Lq, Lmax, st, layer, offset, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
