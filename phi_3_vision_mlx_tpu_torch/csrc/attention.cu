// Kernels K2 (masked flash attention for prefill and extend) and K3 (decode
// attention over the stacked dense KV cache).  Each has its own entry point.
//
// K2 replaces phi_3_vision_mlx_tpu/ops/kernels/flash_attention.py:
// flash_attention (:112), body _kernel (:34).  K3 replaces
// phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:dense_kv_attention (:213),
// body _dense_kernel (:151).
//
// The masking and rounding rules are in attention.cuh.
//
// What bounds them on the H100:
// * K2 (prefill, Lq ~ Lk in the thousands) is bound by operations: 4 * Lq *
//   Lk * D per head for q.k and p.v, halved by causality.  It runs the
//   tensor-core flash body of flash_mma.cuh (bf16 mma.sync, f32 softmax, K/V
//   tiles in a cp.async ring) with the dense tile loader, DenseTiles (K5
//   runs the same body with the int4 loader).
// * K3 (decode, Lq <= 16) is bound by bytes: the layer's K and V for the
//   keys any row can see, 2 * Lk * D * 2 B per (batch, kv head).  The window
//   is split into runs of `split_keys` keys (the wrapper's plan, which takes
//   the window only: the offset is read from device memory, once a block,
//   so a captured launch replays at any offset), one block per (run, head,
//   batch), so the grid fills the card at B = 1 (68 x 32 blocks at a
//   4352-key window, 12 x 32 at 768, with 64-key runs).  A block whose run
//   starts at or past the last visible key writes an empty partial and
//   returns.  A block
//   requests its run's K and V rows at once into shared memory (16-byte
//   cp.async; 24 KB at 64 keys, eight blocks an SM), scores all its keys for
//   all the head's query rows, then takes one max and one sum per row over
//   the run: no per-key rescale.  It writes each row's (max, sum,
//   unnormalized output) to the f32 partials, and a second kernel merges
//   them in a fixed order (deterministic), every split's read in flight at
//   once up to 72 splits.  (Folding the merge into the last block of each head saves the
//   launch but took 19% more device time at 4224 keys on an NVIDIA H100
//   80GB HBM3 at 700 W: every block then fences its writes before it frees
//   its shared memory.)  A run where a row sees no key carries max = NEG_INF
//   and sum 0, so it weighs nothing beside a run that saw one; a row that
//   sees no key in any run gets the uniform average of all Lmax values.
//   The cache is read in place from the stacked (layers, B, KV, Lmax, D)
//   buffer: no per-layer copy.
//
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "flash_mma.cuh"

namespace {

constexpr int kSplitThreads = 128;  // K3: threads per block (4 warps)
constexpr int kSplitMaxRows = 16;   // K3: query rows per (batch, head)
constexpr int kCombineThreads = 256;  // K3's combine: threads per query row

template <int D>
size_t split_smem_bytes(int split_keys, int Lq) {
  return sizeof(__nv_bfloat16) * (size_t)split_keys * (2 * D + 8) +
         sizeof(float) * (size_t)Lq * (D + split_keys);
}

// Grid (H, B * Lq), kCombineThreads threads: merges the n_split partials of
// one query row into its output in a fixed order (deterministic).  Warp w
// takes splits w, w + kWarps, ..., kDeep at a time, all loaded before any is
// used (one round trip to L2 for a window of up to kDeep * kWarps splits),
// and keeps an online (max, sum, output) over them, each lane three of the
// row's dims; then the warps merge through shared memory.  A row that saw
// no key in any split gets the uniform average of the Lmax values.
template <int D>
__global__ void __launch_bounds__(kCombineThreads)
    dense_kv_combine_kernel(const float* __restrict__ partial, const __nv_bfloat16* __restrict__ v,
                            __nv_bfloat16* __restrict__ out, int H, int KV, int Lq, int Lmax,
                            long long osb, long long osh, long long osl, int n_split) {
  constexpr int kWarps = kCombineThreads / 32, PER = D / 32, kDeep = 9;
  __shared__ float sm_acc[kWarps][D];
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x, b = blockIdx.y / Lq, i = blockIdx.y % Lq;
  const size_t stride = (size_t)gridDim.x * gridDim.y * (D + 2);  // one split's partials
  const float* src = partial + (((size_t)b * H + h) * Lq + i) * (D + 2);
  __nv_bfloat16* o = out + b * osb + h * osh + i * osl;

  float m = kNegInf, lsum = 0.f, a[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) a[r] = 0.f;
  for (int s0 = warp; s0 < n_split; s0 += kDeep * kWarps) {
    float md[kDeep], ld[kDeep], ad[kDeep][PER];
#pragma unroll
    for (int u = 0; u < kDeep; ++u) {
      const bool in = s0 + u * kWarps < n_split;  // a split past the end carries nothing
      const float* ps = src + min(s0 + u * kWarps, n_split - 1) * stride;
      md[u] = in ? ps[0] : kNegInf;
      ld[u] = in ? ps[1] : 0.f;
#pragma unroll
      for (int r = 0; r < PER; ++r) ad[u][r] = in ? ps[2 + lane + 32 * r] : 0.f;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kDeep; ++u) m_new = fmaxf(m_new, md[u]);
    const float alpha = expf(m - m_new);
    lsum *= alpha;
#pragma unroll
    for (int r = 0; r < PER; ++r) a[r] *= alpha;
#pragma unroll
    for (int u = 0; u < kDeep; ++u) {
      const float f = expf(md[u] - m_new);
      lsum = fmaf(ld[u], f, lsum);
#pragma unroll
      for (int r = 0; r < PER; ++r) a[r] = fmaf(ad[u][r], f, a[r]);
    }
    m = m_new;
  }
  if (lane == 0) sm_m[warp] = m;
  __syncthreads();
  float mx = kNegInf;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, sm_m[w]);
  if (mx > kNegInf) {
    const float g = expf(m - mx);
    lsum *= g;
#pragma unroll
    for (int r = 0; r < PER; ++r) a[r] *= g;
  } else {
    // No visible key in the whole window: the uniform average of every value.
    const __nv_bfloat16* vb = v + ((size_t)b * KV + h / (H / KV)) * (size_t)Lmax * D;
#pragma unroll
    for (int r = 0; r < PER; ++r) a[r] = 0.f;
    for (int j = warp; j < Lmax; j += kWarps) {
#pragma unroll
      for (int r = 0; r < PER; ++r) a[r] += bf(vb[(size_t)j * D + lane + 32 * r]);
    }
    lsum = warp == 0 ? (float)Lmax : 0.f;
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) sm_acc[warp][lane + 32 * r] = a[r];
  if (lane == 0) sm_l[warp] = lsum;
  __syncthreads();
  if (threadIdx.x < D) {
    float acc = 0.f, l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      acc += sm_acc[w][threadIdx.x];
      l += sm_l[w];
    }
    o[threadIdx.x] = __float2bfloat16(acc / l);
  }
}

// Grid (n_split, H, B), n_split = ceil(Lmax / split_keys).  Block s reads
// keys [s * split_keys, min((s + 1) * split_keys, kend)), kend = min(Lmax,
// *offset + Lq): the keys some row can see; a block with none writes every
// row's empty partial (max NEG_INF, sum 0, output 0).  Query row i sees key
// j iff j <= offset + i and valid[b, j].  The
// block's K and V rows are all requested at once (16-byte cp.async), so
// every block resident on an SM has its whole run in flight.  It writes
// each row's (max, sum, unnormalized output) to partial[s, row], row = (b *
// H + h) * Lq + i.
template <int D>
__global__ void __launch_bounds__(kSplitThreads)
    dense_kv_split_kernel(const __nv_bfloat16* __restrict__ q, const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v, const uint8_t* __restrict__ valid,
                          float* __restrict__ partial, int H, int KV, int Lq, int Lmax,
                          long long qsb, long long qsh, long long qsl,
                          const int* __restrict__ offset_ptr, float scale, int split_keys) {
  constexpr int S = D + 8;        // K row stride in shared memory: conflict-free 16-byte reads
  constexpr int kChunks = D / 8;  // 16-byte chunks per row
  constexpr int kWarps = kSplitThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* ks = reinterpret_cast<__nv_bfloat16*>(smem_raw);     // [split_keys][S]
  __nv_bfloat16* vs = ks + (size_t)split_keys * S;                    // [split_keys][D]
  float* qs = reinterpret_cast<float*>(vs + (size_t)split_keys * D);  // [Lq][D]
  float* ps = qs + Lq * D;                                            // [Lq][split_keys]
  __shared__ float sm_m[kSplitMaxRows], sm_l[kSplitMaxRows];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = split * split_keys;
  const int offset = *offset_ptr;
  const int n = min(split_keys, min(Lmax, offset + Lq) - j0);
  const size_t rows = (size_t)gridDim.y * gridDim.z * Lq;
  if (n <= 0) {  // past every row's last visible key: an empty partial
    for (int r = 0; r < Lq; ++r) {
      float* dst = partial + ((size_t)split * rows + ((size_t)b * H + h) * Lq + r) * (D + 2);
      if (tid < D) dst[2 + tid] = 0.f;
      if (tid == 0) {
        dst[0] = kNegInf;
        dst[1] = 0.f;
      }
    }
    return;
  }
  const size_t kv0 = ((size_t)b * KV + kvh) * (size_t)Lmax * D;
  for (int idx = tid; idx < n * kChunks; idx += kSplitThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    cp_async16(ks + r * S + c * 8, k + kv0 + (size_t)(j0 + r) * D + c * 8);
  }
  cp_async_commit();
  for (int idx = tid; idx < n * kChunks; idx += kSplitThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    cp_async16(vs + r * D + c * 8, v + kv0 + (size_t)(j0 + r) * D + c * 8);
  }
  cp_async_commit();
  for (int idx = tid; idx < Lq * D; idx += kSplitThreads) {
    const int r = idx / D, c = idx % D;
    qs[idx] = round_bf(bf(q[b * qsb + h * qsh + r * qsl + c]) * scale);
  }
  cp_async_wait<1>();  // K has arrived; V may still be in flight
  __syncthreads();

  // Scores: one key per thread, every query row at once.
  const uint8_t* vrow = valid + (size_t)b * Lmax + j0;
  for (int c = tid; c < n; c += kSplitThreads) {
    float sc[kSplitMaxRows];
#pragma unroll
    for (int r = 0; r < kSplitMaxRows; ++r) sc[r] = 0.f;
    const __nv_bfloat16* kr = ks + c * S;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      const uint4 raw = *reinterpret_cast<const uint4*>(kr + ch * 8);
      const __nv_bfloat162* k2 = reinterpret_cast<const __nv_bfloat162*>(&raw);
      float kf[8];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const float2 f = __bfloat1622float2(k2[e]);
        kf[2 * e] = f.x;
        kf[2 * e + 1] = f.y;
      }
#pragma unroll
      for (int r = 0; r < kSplitMaxRows; ++r) {
        if (r >= Lq) break;
        const float4 qa = *reinterpret_cast<const float4*>(qs + r * D + ch * 8);
        const float4 qb = *reinterpret_cast<const float4*>(qs + r * D + ch * 8 + 4);
        sc[r] = fmaf(qa.x, kf[0], sc[r]);
        sc[r] = fmaf(qa.y, kf[1], sc[r]);
        sc[r] = fmaf(qa.z, kf[2], sc[r]);
        sc[r] = fmaf(qa.w, kf[3], sc[r]);
        sc[r] = fmaf(qb.x, kf[4], sc[r]);
        sc[r] = fmaf(qb.y, kf[5], sc[r]);
        sc[r] = fmaf(qb.z, kf[6], sc[r]);
        sc[r] = fmaf(qb.w, kf[7], sc[r]);
      }
    }
    const bool ok = vrow[c] != 0;
#pragma unroll
    for (int r = 0; r < kSplitMaxRows; ++r) {
      if (r >= Lq) break;
      ps[r * split_keys + c] = ok && j0 + c <= offset + r ? sc[r] : -INFINITY;  // -inf: not seen
    }
  }
  __syncthreads();

  // One max and one sum per row over the run; p overwrites the scores.
  for (int r = warp; r < Lq; r += kWarps) {
    float* pr = ps + r * split_keys;
    float mx = -INFINITY;
    for (int c = lane; c < n; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
    float sum = 0.f;
    for (int c = lane; c < n; c += 32) {
      const float p = mx == -INFINITY ? 0.f : expf(pr[c] - mx);
      pr[c] = p;
      sum += p;
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
    if (lane == 0) {
      sm_m[r] = mx == -INFINITY ? kNegInf : mx;
      sm_l[r] = sum;
    }
  }
  cp_async_wait<0>();
  __syncthreads();

  // Unnormalized output: thread d < D owns dim d of every row.
  if (tid >= D) return;
  float acc[kSplitMaxRows];
#pragma unroll
  for (int r = 0; r < kSplitMaxRows; ++r) acc[r] = 0.f;
  for (int c = 0; c < n; ++c) {
    const float vv = bf(vs[c * D + tid]);
#pragma unroll
    for (int r = 0; r < kSplitMaxRows; ++r) {
      if (r >= Lq) break;
      acc[r] = fmaf(ps[r * split_keys + c], vv, acc[r]);
    }
  }
  for (int r = 0; r < Lq; ++r) {
    float* dst = partial + ((size_t)split * rows + ((size_t)b * H + h) * Lq + r) * (D + 2);
    dst[2 + tid] = acc[r];
    if (tid == 0) {
      dst[0] = sm_m[r];
      dst[1] = sm_l[r];
    }
  }
}

template <int D>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* valid,
                          void* out, void* partial, int B, int H, int KV, int Lq, int Lmax,
                          const long long* st, int layer, const int* offset, float scale,
                          int n_split, int split_keys, cudaStream_t stream) {
  if (Lq < 1 || Lq > kSplitMaxRows || KV < 1 || H % KV || Lmax < 1 || offset == nullptr ||
      split_keys < 1 || partial == nullptr || n_split != (Lmax + split_keys - 1) / split_keys)
    return cudaErrorInvalidValue;
  const size_t bytes = split_smem_bytes<D>(split_keys, Lq);
  cudaError_t err = cudaFuncSetAttribute(dense_kv_split_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const size_t layer_elems = (size_t)B * KV * Lmax * D;
  const __nv_bfloat16* kl = static_cast<const __nv_bfloat16*>(k) + (size_t)layer * layer_elems;
  const __nv_bfloat16* vl = static_cast<const __nv_bfloat16*>(v) + (size_t)layer * layer_elems;
  dense_kv_split_kernel<D><<<dim3(n_split, H, B), kSplitThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kl, vl, static_cast<const uint8_t*>(valid),
      static_cast<float*>(partial), H, KV, Lq, Lmax, st[0], st[1], st[2], offset, scale,
      split_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_kv_combine_kernel<D><<<dim3(H, B * Lq), kCombineThreads, 0, stream>>>(
      static_cast<const float*>(partial), vl, static_cast<__nv_bfloat16*>(out), H, KV, Lq, Lmax,
      st[3], st[4], st[5], n_split);
  return cudaGetLastError();
}

}  // namespace

// K2.  q (B, H, Lq, D) bf16 with element strides (qsb, qsh, qsl) and unit
// stride along D; k, v (B, KV, Lk, D) bf16 contiguous, 16-byte aligned;
// valid (B, Lk) uint8; out (B, H, Lq, D) bf16 with strides (osb, osh, osl),
// 4-byte aligned.  Query i sits at absolute position q_pos0 + i.  Returns a
// cudaError_t.
extern "C" int k2_flash_attention(const void* q, const void* k, const void* v, const void* valid,
                                  void* out, int B, int H, int KV, int Lq, int Lk, int D,
                                  long long qsb, long long qsh, long long qsl, long long osb,
                                  long long osh, long long osl, int q_pos0, float scale,
                                  void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  switch (D) {
    case 96: return (int)launch_flash_mma<96, DenseTiles<96>>(q, k, v, valid, out, B, H, KV, Lq, Lk, st, q_pos0, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3.  q (B, H, Lq, D) as in K2, Lq <= 16; k, v the stacked cache (layers,
// B, KV, Lmax, D) bf16 contiguous, 16-byte aligned, read at `layer` in
// place; valid (B, Lmax) uint8; partial f32 scratch of n_split * B * H * Lq
// * (D + 2) floats, n_split = ceil(Lmax / split_keys); offset a device
// pointer to one int32 >= 0, read by the kernels (the caller checks it).
// Query i sits at position *offset + i.  Returns a cudaError_t.
extern "C" int k3_dense_kv_attention(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, void* partial, int B, int H,
                                     int KV, int Lq, int Lmax, int D, long long qsb, long long qsh,
                                     long long qsl, long long osb, long long osh, long long osl,
                                     int layer, const void* offset, float scale, int n_split,
                                     int split_keys, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  switch (D) {
    case 96: return (int)launch_decode<96>(q, k, v, valid, out, partial, B, H, KV, Lq, Lmax, st, layer, static_cast<const int*>(offset), scale, n_split, split_keys, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}
