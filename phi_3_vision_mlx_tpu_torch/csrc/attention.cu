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
// Both also run fp32 models (the token-exact fp32 gate, verify.py's config
// 1), as the JAX kernels are generic in the element type:
// * K3 in fp32 is the same split and combine, templated on the element
//   type T: f32 keys, values, output and 16-byte copies of 4 values, the
//   rest unchanged (the device offset, row0, the window-only plan, the
//   fixed-order combine).  Its shared memory doubles with the keys' width:
//   60416 bytes a block at 64 keys, D = 96 and 16 rows (split_smem_bytes),
//   under the 227 KB a block may take, so the bf16 plan carries over (three
//   blocks an SM where bf16 fits eight).
// * K2 in fp32 (flash_f32_kernel) is a simple CUDA-core kernel beside the
//   tensor-core body: no bf16 rounding anywhere and no TF32, so it is held
//   to the plain fp32 version at fp32's precision.  A block owns 32 query
//   rows of one (head, batch), four threads a row; it walks the keys in
//   tiles of 32 with f32 FMAs and an online softmax (one max and one
//   rescale per row a tile), with the rules of the bf16 body: the causal
//   offset q_pos0, the valid bits, tiles past the block's causal horizon
//   skipped unless a row has seen no visible key, which then walks every
//   tile to the uniform average of all Lk values.  It is bound by
//   operations on the CUDA cores (67 TFLOP/s f32), not by bytes.
//
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "flash_mma.cuh"

namespace {

constexpr int kSplitThreads = 128;  // K3: threads per block (4 warps)
constexpr int kSplitMaxRows = 16;   // K3: query rows per (batch, head)
constexpr int kCombineThreads = 256;  // K3's combine: threads per query row

// The element types of K2 and K3: bf16 (the served models) and f32.  A
// value as f32, an f32 rounded to T, and a 16-byte chunk's 16 / sizeof(T)
// values as f32.
__device__ __forceinline__ float to_f(const __nv_bfloat16 v) { return bf(v); }
__device__ __forceinline__ float to_f(const float v) { return v; }
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) { return __float2bfloat16(v); }
template <>
__device__ __forceinline__ float from_f<float>(float v) { return v; }
template <typename T>
__device__ __forceinline__ float round_to(float v) { return to_f(from_f<T>(v)); }
__device__ __forceinline__ void unpack(const uint4 raw, float (&f)[8]) {  // 8 bf16
  const __nv_bfloat162* p = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float2 x = __bfloat1622float2(p[e]);
    f[2 * e] = x.x;
    f[2 * e + 1] = x.y;
  }
}
__device__ __forceinline__ void unpack(const uint4 raw, float (&f)[4]) {  // 4 f32
  f[0] = __uint_as_float(raw.x);
  f[1] = __uint_as_float(raw.y);
  f[2] = __uint_as_float(raw.z);
  f[3] = __uint_as_float(raw.w);
}

// K3's shared memory: K rows padded by 16 bytes (conflict-free 16-byte
// reads), V rows, the f32 queries and the f32 scores.
template <int D, typename T>
size_t split_smem_bytes(int split_keys, int Lq) {
  return sizeof(T) * (size_t)split_keys * (2 * D + 16 / sizeof(T)) +
         sizeof(float) * (size_t)Lq * (D + split_keys);
}

// Grid (H, B * Lq), kCombineThreads threads: merges the n_split partials of
// one query row into its output in a fixed order (deterministic).  Warp w
// takes splits w, w + kWarps, ..., kDeep at a time, all loaded before any is
// used (one round trip to L2 for a window of up to kDeep * kWarps splits),
// and keeps an online (max, sum, output) over them, each lane three of the
// row's dims; then the warps merge through shared memory.  A row that saw
// no key in any split gets the uniform average of the Lmax values.
template <int D, typename T>
__global__ void __launch_bounds__(kCombineThreads)
    dense_kv_combine_kernel(const float* __restrict__ partial, const T* __restrict__ v,
                            T* __restrict__ out, int H, int KV, int Lq, int Lmax,
                            long long osb, long long osh, long long osl, int n_split) {
  constexpr int kWarps = kCombineThreads / 32, PER = D / 32, kDeep = 9;
  __shared__ float sm_acc[kWarps][D];
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int h = blockIdx.x, b = blockIdx.y / Lq, i = blockIdx.y % Lq;
  const size_t stride = (size_t)gridDim.x * gridDim.y * (D + 2);  // one split's partials
  const float* src = partial + (((size_t)b * H + h) * Lq + i) * (D + 2);
  T* o = out + b * osb + h * osh + i * osl;

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
    const T* vb = v + ((size_t)b * KV + h / (H / KV)) * (size_t)Lmax * D;
#pragma unroll
    for (int r = 0; r < PER; ++r) a[r] = 0.f;
    for (int j = warp; j < Lmax; j += kWarps) {
#pragma unroll
      for (int r = 0; r < PER; ++r) a[r] += to_f(vb[(size_t)j * D + lane + 32 * r]);
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
    o[threadIdx.x] = from_f<T>(acc / l);
  }
}

// Grid (n_split, H, B), n_split = ceil(Lmax / split_keys).  Block s reads
// keys [s * split_keys, min((s + 1) * split_keys, kend)), kend = min(Lmax,
// *offset + row0 + Lq): the keys some row can see; a block with none writes
// every row's empty partial (max NEG_INF, sum 0, output 0).  Query row i
// sits at position offset + row0 + i (row0: the launch's first row of a
// longer pass) and sees key j iff j <= offset + row0 + i and valid[b, j].  The
// block's K and V rows are all requested at once (16-byte cp.async), so
// every block resident on an SM has its whole run in flight.  It writes
// each row's (max, sum, unnormalized output) to partial[s, row], row = (b *
// H + h) * Lq + i.
template <int D, typename T>
__global__ void __launch_bounds__(kSplitThreads)
    dense_kv_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, const uint8_t* __restrict__ valid,
                          float* __restrict__ partial, int H, int KV, int Lq, int Lmax,
                          long long qsb, long long qsh, long long qsl,
                          const int* __restrict__ offset_ptr, int row0, float scale, int split_keys) {
  constexpr int E = 16 / sizeof(T);  // values per 16-byte chunk
  constexpr int S = D + E;           // K row stride in shared memory: conflict-free 16-byte reads
  constexpr int kChunks = D / E;     // 16-byte chunks per row
  constexpr int kWarps = kSplitThreads / 32;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ks = reinterpret_cast<T*>(smem_raw);                             // [split_keys][S]
  T* vs = ks + (size_t)split_keys * S;                                // [split_keys][D]
  float* qs = reinterpret_cast<float*>(vs + (size_t)split_keys * D);  // [Lq][D]
  float* ps = qs + Lq * D;                                            // [Lq][split_keys]
  __shared__ float sm_m[kSplitMaxRows], sm_l[kSplitMaxRows];

  const int split = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (H / KV);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int j0 = split * split_keys;
  const int offset = *offset_ptr + row0;  // the position of query row 0
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
    cp_async16(ks + r * S + c * E, k + kv0 + (size_t)(j0 + r) * D + c * E);
  }
  cp_async_commit();
  for (int idx = tid; idx < n * kChunks; idx += kSplitThreads) {
    const int r = idx / kChunks, c = idx % kChunks;
    cp_async16(vs + r * D + c * E, v + kv0 + (size_t)(j0 + r) * D + c * E);
  }
  cp_async_commit();
  for (int idx = tid; idx < Lq * D; idx += kSplitThreads) {
    const int r = idx / D, c = idx % D;
    qs[idx] = round_to<T>(to_f(q[b * qsb + h * qsh + r * qsl + c]) * scale);
  }
  cp_async_wait<1>();  // K has arrived; V may still be in flight
  __syncthreads();

  // Scores: one key per thread, every query row at once.
  const uint8_t* vrow = valid + (size_t)b * Lmax + j0;
  for (int c = tid; c < n; c += kSplitThreads) {
    float sc[kSplitMaxRows];
#pragma unroll
    for (int r = 0; r < kSplitMaxRows; ++r) sc[r] = 0.f;
    const T* kr = ks + c * S;
#pragma unroll
    for (int ch = 0; ch < kChunks; ++ch) {
      float kf[E];
      unpack(*reinterpret_cast<const uint4*>(kr + ch * E), kf);
#pragma unroll
      for (int r = 0; r < kSplitMaxRows; ++r) {
        if (r >= Lq) break;
#pragma unroll
        for (int e = 0; e < E; e += 4) {
          const float4 qa = *reinterpret_cast<const float4*>(qs + r * D + ch * E + e);
          sc[r] = fmaf(qa.x, kf[e], sc[r]);
          sc[r] = fmaf(qa.y, kf[e + 1], sc[r]);
          sc[r] = fmaf(qa.z, kf[e + 2], sc[r]);
          sc[r] = fmaf(qa.w, kf[e + 3], sc[r]);
        }
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
    const float vv = to_f(vs[c * D + tid]);
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

template <int D, typename T>
cudaError_t launch_decode(const void* q, const void* k, const void* v, const void* valid,
                          void* out, void* partial, int B, int H, int KV, int Lq, int Lmax,
                          const long long* st, int layer, const int* offset, int row0,
                          float scale, int n_split, int split_keys, cudaStream_t stream) {
  if (Lq < 1 || Lq > kSplitMaxRows || KV < 1 || H % KV || Lmax < 1 || offset == nullptr || row0 < 0 ||
      split_keys < 1 || partial == nullptr || n_split != (Lmax + split_keys - 1) / split_keys)
    return cudaErrorInvalidValue;
  const size_t bytes = split_smem_bytes<D, T>(split_keys, Lq);
  cudaError_t err = cudaFuncSetAttribute(dense_kv_split_kernel<D, T>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  const size_t layer_elems = (size_t)B * KV * Lmax * D;
  const T* kl = static_cast<const T*>(k) + (size_t)layer * layer_elems;
  const T* vl = static_cast<const T*>(v) + (size_t)layer * layer_elems;
  dense_kv_split_kernel<D, T><<<dim3(n_split, H, B), kSplitThreads, bytes, stream>>>(
      static_cast<const T*>(q), kl, vl, static_cast<const uint8_t*>(valid),
      static_cast<float*>(partial), H, KV, Lq, Lmax, st[0], st[1], st[2], offset, row0, scale,
      split_keys);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  dense_kv_combine_kernel<D, T><<<dim3(H, B * Lq), kCombineThreads, 0, stream>>>(
      static_cast<const float*>(partial), vl, static_cast<T*>(out), H, KV, Lq, Lmax,
      st[3], st[4], st[5], n_split);
  return cudaGetLastError();
}

constexpr int kF32BQ = 32;  // K2 in fp32: query rows per block, four threads a row
constexpr int kF32BK = 32;  // keys per tile
constexpr int kF32Threads = 4 * kF32BQ;

// K2 in fp32.  Grid (H, B, ceil(Lq / kF32BQ)), kF32Threads threads; query
// tile gridDim.z - 1 - blockIdx.z, so the longest causal ranges start
// first.  Thread t owns row t / 4 of the tile: the scores of keys t % 4 + 4j
// of each key tile and the output dims 4 (t % 4 + 4i) .. + 3.  Rows of Q, K
// and V are padded to D + 4 floats (16-byte reads of four rows in distinct
// banks), P's to kF32BK + 1.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_f32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v, const uint8_t* __restrict__ valid,
                     float* __restrict__ out, int H, int KV, int Lq, int Lk, long long qsb,
                     long long qsh, long long qsl, long long osb, long long osh, long long osl,
                     int q_pos0, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16 (four float4 groups a row's threads)");
  constexpr int S = D + 4, PS = kF32BK + 1;
  constexpr int KJ = kF32BK / 4;  // keys a thread scores per tile
  constexpr int DV = D / 16;      // float4 output groups a thread owns
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);  // [kF32BQ][S]
  float* ks = qs + kF32BQ * S;                     // [kF32BK][S]
  float* vs = ks + kF32BK * S;                     // [kF32BK][S]
  float* ps = vs + kF32BK * S;                     // [kF32BQ][PS]
  __shared__ bool vbits[kF32BK];

  const int tid = threadIdx.x, row = tid >> 2, qd = tid & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kF32BQ;
  const int horizon = q_pos0 + min(Lq, i0 + kF32BQ) - 1;
  const size_t kv0 = ((size_t)b * KV + h / (H / KV)) * (size_t)Lk * D;
  const uint8_t* vrow = valid + (size_t)b * Lk;
  for (int idx = tid; idx < kF32BQ * D; idx += kF32Threads) {
    const int r = idx / D, c = idx % D, qi = i0 + r;
    qs[r * S + c] = qi < Lq ? q[b * qsb + h * qsh + qi * qsl + c] * scale : 0.f;
  }
  const int qi = i0 + row, qpos = q_pos0 + qi;
  const bool row_ok = qi < Lq;
  float m = kNegInf, l = 0.f;
  float4 acc[DV];
#pragma unroll
  for (int i = 0; i < DV; ++i) acc[i] = make_float4(0.f, 0.f, 0.f, 0.f);

  for (int j0 = 0; j0 < Lk; j0 += kF32BK) {
    // Past the block's causal horizon: needed only while a row has seen no
    // visible key.  (The barrier also frees the last tile's K, V and P.)
    if (!__syncthreads_or(j0 <= horizon || (row_ok && m == kNegInf))) break;
    for (int idx = tid; idx < kF32BK * (D / 4); idx += kF32Threads) {
      const int r = idx / (D / 4), c = idx % (D / 4);
      const size_t src = kv0 + (size_t)min(j0 + r, Lk - 1) * D + c * 4;  // past Lk: key Lk - 1, masked
      *reinterpret_cast<float4*>(ks + r * S + c * 4) = *reinterpret_cast<const float4*>(k + src);
      *reinterpret_cast<float4*>(vs + r * S + c * 4) = *reinterpret_cast<const float4*>(v + src);
    }
    if (tid < kF32BK) vbits[tid] = j0 + tid < Lk && vrow[j0 + tid] != 0;
    __syncthreads();

    float s[KJ];
#pragma unroll
    for (int j = 0; j < KJ; ++j) s[j] = 0.f;
#pragma unroll 4
    for (int c4 = 0; c4 < D / 4; ++c4) {
      const float4 qa = *reinterpret_cast<const float4*>(qs + row * S + c4 * 4);
#pragma unroll
      for (int j = 0; j < KJ; ++j) {
        const float4 ka = *reinterpret_cast<const float4*>(ks + (qd + 4 * j) * S + c4 * 4);
        s[j] = fmaf(qa.x, ka.x, s[j]);
        s[j] = fmaf(qa.y, ka.y, s[j]);
        s[j] = fmaf(qa.z, ka.z, s[j]);
        s[j] = fmaf(qa.w, ka.w, s[j]);
      }
    }
    // Mask (a hidden key NEG_INF, a key past Lk -inf), then one max and one
    // rescale for the row's tile (the four threads of a row are a quad).
    float mt = -INFINITY;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const int c = qd + 4 * j, key = j0 + c;
      s[j] = key >= Lk ? -INFINITY : (vbits[c] && key <= qpos) ? s[j] : kNegInf;
      mt = fmaxf(mt, s[j]);
    }
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 1));
    mt = fmaxf(mt, __shfl_xor_sync(0xffffffffu, mt, 2));
    const float m_new = fmaxf(m, mt), alpha = expf(m - m_new);
    m = m_new;
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < KJ; ++j) {
      const float p = expf(s[j] - m);
      ps[row * PS + qd + 4 * j] = p;
      psum += p;
    }
    l = l * alpha + psum;  // this thread's keys; the quad's sum at the end
#pragma unroll
    for (int i = 0; i < DV; ++i) {
      acc[i].x *= alpha;
      acc[i].y *= alpha;
      acc[i].z *= alpha;
      acc[i].w *= alpha;
    }
    __syncthreads();
#pragma unroll 4
    for (int c = 0; c < kF32BK; ++c) {
      const float p = ps[row * PS + c];
#pragma unroll
      for (int i = 0; i < DV; ++i) {
        const float4 vv = *reinterpret_cast<const float4*>(vs + c * S + (qd + 4 * i) * 4);
        acc[i].x = fmaf(p, vv.x, acc[i].x);
        acc[i].y = fmaf(p, vv.y, acc[i].y);
        acc[i].z = fmaf(p, vv.z, acc[i].z);
        acc[i].w = fmaf(p, vv.w, acc[i].w);
      }
    }
  }
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  if (!row_ok) return;
  float* orow = out + b * osb + h * osh + (long long)qi * osl;
#pragma unroll
  for (int i = 0; i < DV; ++i)
    *reinterpret_cast<float4*>(orow + (qd + 4 * i) * 4) =
        make_float4(acc[i].x / l, acc[i].y / l, acc[i].z / l, acc[i].w / l);
}

template <int D>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v, const void* valid,
                             void* out, int B, int H, int KV, int Lq, int Lk, const long long* st,
                             int q_pos0, float scale, cudaStream_t stream) {
  if (Lq < 1 || Lk < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  const size_t bytes = sizeof(float) * ((kF32BQ + 2 * kF32BK) * (D + 4) + kF32BQ * (kF32BK + 1));
  cudaError_t err = cudaFuncSetAttribute(flash_f32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Lq + kF32BQ - 1) / kF32BQ);
  flash_f32_kernel<D><<<grid, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), H, KV, Lq, Lk, st[0], st[1],
      st[2], st[3], st[4], st[5], q_pos0, scale);
  return cudaGetLastError();
}

template <typename T>
int k3_launch(const void* q, const void* k, const void* v, const void* valid, void* out,
              void* partial, int B, int H, int KV, int Lq, int Lmax, int D, const long long* st,
              int layer, const void* offset, int row0, float scale, int n_split, int split_keys,
              void* stream_ptr) {
  switch (D) {
    case 96: return (int)launch_decode<96, T>(q, k, v, valid, out, partial, B, H, KV, Lq, Lmax, st, layer, static_cast<const int*>(offset), row0, scale, n_split, split_keys, static_cast<cudaStream_t>(stream_ptr));
    default: return (int)cudaErrorInvalidValue;
  }
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

// K2 in fp32: as k2_flash_attention with f32 q, k, v and out, out 16-byte
// aligned with strides that are multiples of 4.
extern "C" int k2_flash_attention_f32(const void* q, const void* k, const void* v,
                                      const void* valid, void* out, int B, int H, int KV, int Lq,
                                      int Lk, int D, long long qsb, long long qsh, long long qsl,
                                      long long osb, long long osh, long long osl, int q_pos0,
                                      float scale, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  if (osb % 4 || osh % 4 || osl % 4 || reinterpret_cast<uintptr_t>(out) % 16)
    return (int)cudaErrorInvalidValue;
  switch (D) {
    case 96: return (int)launch_flash_f32<96>(q, k, v, valid, out, B, H, KV, Lq, Lk, st, q_pos0, scale, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K3.  q (B, H, Lq, D) as in K2, Lq <= 16; k, v the stacked cache (layers,
// B, KV, Lmax, D) bf16 contiguous, 16-byte aligned, read at `layer` in
// place; valid (B, Lmax) uint8; partial f32 scratch of n_split * B * H * Lq
// * (D + 2) floats, n_split = ceil(Lmax / split_keys); offset a device
// pointer to one int32 >= 0, read by the kernels (the caller checks it).
// Query i sits at position *offset + row0 + i: a pass of more than 16 rows
// runs as launches on groups of 16, each with its own row0.  Returns a
// cudaError_t.
extern "C" int k3_dense_kv_attention(const void* q, const void* k, const void* v,
                                     const void* valid, void* out, void* partial, int B, int H,
                                     int KV, int Lq, int Lmax, int D, long long qsb, long long qsh,
                                     long long qsl, long long osb, long long osh, long long osl,
                                     int layer, const void* offset, int row0, float scale,
                                     int n_split, int split_keys, void* stream_ptr) {
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  return k3_launch<__nv_bfloat16>(q, k, v, valid, out, partial, B, H, KV, Lq, Lmax, D, st, layer,
                                  offset, row0, scale, n_split, split_keys, stream_ptr);
}

// K3 in fp32: as k3_dense_kv_attention with f32 q, k, v and out.
extern "C" int k3_dense_kv_attention_f32(const void* q, const void* k, const void* v,
                                         const void* valid, void* out, void* partial, int B, int H,
                                         int KV, int Lq, int Lmax, int D, long long qsb,
                                         long long qsh, long long qsl, long long osb,
                                         long long osh, long long osl, int layer,
                                         const void* offset, int row0, float scale, int n_split,
                                         int split_keys, void* stream_ptr) {
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  return k3_launch<float>(q, k, v, valid, out, partial, B, H, KV, Lq, Lmax, D, st, layer, offset,
                          row0, scale, n_split, split_keys, stream_ptr);
}
