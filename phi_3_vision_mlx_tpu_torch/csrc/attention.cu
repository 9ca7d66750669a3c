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
// * K2 in fp32 (flash_tf32_kernel) is bound by operations, as in bf16, and
//   runs them on the tensor cores as 3xTF32: each f32 operand x is split
//   into hi = tf32(x) and lo = tf32(x - hi) (round to nearest on a 10-bit
//   mantissa, two integer ops), and each product as three tf32
//   mma.sync.m16n8k8 with f32 sums, a_lo b_hi + a_hi b_lo + a_hi b_hi.  A
//   tf32 product is exact in f32, and hi + lo holds x to 2^-22 |x|, so only
//   a_lo b_lo (at most 2^-22 of a product) is lost: the sums keep f32's
//   accuracy, held to the plain fp32 version at fp32's limits (plain TF32,
//   one product, keeps about three digits).  That is the card's only
//   f32-accurate product faster than the CUDA cores (495 TFLOP/s TF32, so
//   165 TFLOP/s of f32 products, against 67 TFLOP/s).  The tensor cores
//   round each sum toward zero, so accumulator chains are kept short (S's lo
//   terms apart, each tile's P V from zero, added to O by one rounded fma).
//   The layout is the bf16 body's: 64 query rows of one (head, batch) a
//   block, four warps of 16 rows, keys in tiles of 64, a two-stage 16-byte
//   cp.async ring of f32 K tiles and one V tile (the next V tile copied
//   during the next Q K^T), the block's q * scale rows in shared memory,
//   split into hi and lo where they are used (105 KB a block, two blocks an
//   SM, O and S in registers with no spill).  The online softmax runs in
//   f32 registers (one max and one rescale per tile, exp2 on scores in log2
//   units); P is never rounded below f32: it is split hi/lo in registers
//   and is P V's A operand as it stands, since the k order of a key step is
//   free (see flash_tf32_kernel).  The masking rules are the bf16 body's:
//   q_pos0, the valid bits, a key past Lk scoring -inf, tiles past the
//   block's causal horizon skipped unless a row has seen no visible key,
//   which then walks every tile to the uniform average of all Lk values.
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

constexpr int kF32BQ = 64;  // K2 in fp32: query rows per block, four warps of 16
constexpr int kF32BK = 64;  // keys per tile
constexpr int kF32Threads = 2 * kF32BQ;

// fp32 K2's shared memory: a two-stage ring of f32 K tiles, one V tile and
// the block's q * scale rows.  K and Q rows are padded to D + 8 floats, V
// rows to D + 4: the 8-byte fragment loads below then fall in distinct
// banks in each half-warp.  105,472 bytes a block at D = 96: two blocks an
// SM.
template <int D>
constexpr size_t kF32SmemBytes = sizeof(float) * ((2 * kF32BK + kF32BQ) * (D + 8) + kF32BK * (D + 4));

// K2 in fp32.  Grid (H, B, ceil(Lq / kF32BQ)), kF32Threads threads; query
// tile gridDim.z - 1 - blockIdx.z, so the longest causal ranges start
// first.  Warp w owns rows 16 w .. 16 w + 15 of the tile, the layout of
// flash_mma.cuh with tf32 m16n8k8 products, each run as 3xTF32.  Two free
// permutations let every operand come from one 8-byte load, with no
// shuffle:
// * in Q K^T, k index t of a k-step stands for dim 8 kk + 2t and t + 4 for
//   8 kk + 2t + 1 (in both Q's A and K's B fragments);
// * in P V, k index t of key step n stands for key 8n + 2t and t + 4 for key
//   8n + 2t + 1, so S's accumulator (columns 2t, 2t + 1) is P's A fragment;
//   and n-tiles 2p and 2p + 1 take dims 16p + 2 gid and 16p + 2 gid + 1, so a
//   thread's four output columns of each pair are dims 16p + 4 tig .. + 3.
// Registers hold O, S and one tile's P V, with no spill: Q stays in shared
// memory (split where it is used), and V is single-buffered, its next tile
// copied during the next Q K^T (the K ring keeps two).  The tensor cores
// round an f32 sum toward zero, so a long chain of adds into one
// accumulator drifts one way, and the chains are cut short: S's lo terms
// have their own accumulator, and each tile's P V is summed from zero and
// added to O with one rounded fma (O alpha + P V).  The short chains also
// leave more products in flight.
template <int D>
__global__ void __launch_bounds__(kF32Threads)
    flash_tf32_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v, const uint8_t* __restrict__ valid,
                      float* __restrict__ out, int H, int KV, int Lq, int Lk, long long qsb,
                      long long qsh, long long qsl, long long osb, long long osh, long long osl,
                      int q_pos0, float scale) {
  static_assert(D % 16 == 0, "D must be a multiple of 16 (n-tiles of P V in pairs)");
  static_assert(kF32BK % 32 == 0 && kF32Threads >= kF32BK, "a word of valid bits each 32 keys, a thread a key");
  constexpr int BK = kF32BK, BQ = kF32BQ, kThreads = kF32Threads;
  constexpr int KS = D + 8, VS = D + 4;  // row strides (floats) of the K / Q and V tiles
  constexpr int KD = D / 8;              // k-steps of Q K^T
  constexpr int NK = BK / 8;             // n-tiles of S, k-steps of P V
  constexpr int DP = D / 16;             // pairs of n-tiles of P V
  constexpr int kChunks = D / 4;         // 16-byte chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);  // [2][BK][KS]
  float* qs = ks + 2 * BK * KS;                    // [BQ][KS]
  float* vs = qs + BQ * KS;                        // [BK][VS]
  __shared__ unsigned vmask[2][BK / 32];           // per stage: valid bits of each 32 keys

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int horizon = q_pos0 + min(Lq, i0 + BQ) - 1;
  const int n_tiles = (Lk + BK - 1) / BK;
  const size_t kv0 = ((size_t)b * KV + h / (H / KV)) * (size_t)Lk * D;
  const uint8_t* vrow = valid + (size_t)b * Lk;

  // Copies of tile t (a key past Lk is copied from key Lk - 1 and masked).
  // Thread tid < BK holds the valid byte of key tid of the last K tile
  // issued.
  unsigned vbyte = 0;
  auto issue_k = [&](int t) {
    const int j0 = t * BK;
    float* kd = ks + (t & 1) * BK * KS;
    for (int idx = tid; idx < BK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      cp_async16(kd + r * KS + c * 4, k + kv0 + (size_t)min(j0 + r, Lk - 1) * D + c * 4);
    }
    if (tid < BK) vbyte = (j0 + tid < Lk) & (vrow[min(j0 + tid, Lk - 1)] != 0);
  };
  auto issue_v = [&](int t) {
    const int j0 = t * BK;
    for (int idx = tid; idx < BK * kChunks; idx += kThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      cp_async16(vs + r * VS + c * 4, v + kv0 + (size_t)min(j0 + r, Lk - 1) * D + c * 4);
    }
  };
  // Commit groups, in order: K of tile 0, V of tile 0, then for each tile t
  // K of t + 1 (top) and V of t + 1 (after P V), empty where none is due.
  issue_k(0);
  cp_async_commit();
  issue_v(0);
  cp_async_commit();
  for (int idx = tid; idx < BQ * D; idx += kThreads) {
    const int r = idx / D, c = idx % D, qi = i0 + r;
    qs[r * KS + c] = qi < Lq ? q[b * qsb + h * qsh + qi * qsl + c] * scale : 0.f;  // f32, as the plain path
  }

  // This thread's rows: r0 and r0 + 8 of the block's tile.
  const int r0 = i0 + warp * 16 + gid;
  const int qpos[2] = {q_pos0 + r0, q_pos0 + r0 + 8};
  const bool row_ok[2] = {r0 < Lq, r0 + 8 < Lq};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[2 * DP][4];
#pragma unroll
  for (int dn = 0; dn < 2 * DP; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;
  const float* qw = qs + (warp * 16 + gid) * KS + 2 * tig;  // A fragment: row gid, dims 8 kk + 2 tig, + 1

  for (int t = 0;;) {
    const int st = t & 1, j0 = t * BK;
    if (warp < BK / 32) {
      const unsigned bits = __ballot_sync(0xffffffffu, vbyte);
      if (lane == 0) vmask[st][warp] = bits;
    }
    const bool next = t + 1 < n_tiles && (t + 1) * BK <= horizon;
    if (next) issue_k(t + 1);
    cp_async_commit();
    cp_async_wait<2>();  // K of tile t has landed (V of t and K of t + 1 may not have)
    __syncthreads();

    // S = Q K^T: per warp 16 rows x BK keys; K's B fragment (key 8n + gid,
    // dims 8 kk + 2 tig and + 1) and each row of Q's A fragment are one
    // 8-byte load.  hi * hi sums in s, the lo terms in slo.
    float s[NK][4], slo[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = slo[n][e] = 0.f;
    const float* kt = ks + st * BK * KS + gid * KS + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
      const float2 q0 = *reinterpret_cast<const float2*>(qw + kk * 8);
      const float2 q1 = *reinterpret_cast<const float2*>(qw + 8 * KS + kk * 8);
      unsigned qh[4], ql[4];
      split_tf32(q0.x, qh[0], ql[0]);  // a0: row gid, k index tig
      split_tf32(q1.x, qh[1], ql[1]);  // a1: row gid + 8
      split_tf32(q0.y, qh[2], ql[2]);  // a2: row gid, k index tig + 4
      split_tf32(q1.y, qh[3], ql[3]);  // a3: row gid + 8
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        const float2 kb = *reinterpret_cast<const float2*>(kt + n * 8 * KS + kk * 8);
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(kb.x, bh0, bl0);
        split_tf32(kb.y, bh1, bl1);
        mma_tf32(slo[n], ql, bh0, bh1);
        mma_tf32(slo[n], qh, bl0, bl1);
        mma_tf32(s[n], qh, bh0, bh1);
      }
    }

    // Mask, then one max and one rescale per row for the tile (scores in
    // log2 units; a masked score stays NEG_INF, a key past Lk -inf).
    unsigned w[BK / 32];
#pragma unroll
    for (int i = 0; i < BK / 32; ++i) w[i] = vmask[st][i];
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tig * 2 + (e & 1), j = j0 + c, r = e >> 1;
        const bool key_valid = (w[c >> 5] >> (c & 31)) & 1u;
        const float x = s[n][e] + slo[n][e];
        s[n][e] = j >= Lk ? -INFINITY : (key_valid && j <= qpos[r]) ? x * kLog2e : kNegInf;
        mt[r] = fmaxf(mt[r], s[n][e]);
      }
    }
    float alpha[2], psum[2] = {0.f, 0.f};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 1));
      mt[r] = fmaxf(mt[r], __shfl_xor_sync(0xffffffffu, mt[r], 2));
      const float m_new = fmaxf(m[r], mt[r]);
      alpha[r] = exp2f(m[r] - m_new);
      m[r] = m_new;
    }
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - m[e >> 1]);
        psum[e >> 1] += s[n][e];
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + psum[r];  // this thread's columns

    cp_async_wait<1>();  // V of tile t has landed
    __syncthreads();

    // This tile's P V, summed from zero: P (f32) split hi/lo as the A
    // fragment of key step n (row gid, key 8n + 2 tig: s[n][0]; row gid + 8:
    // s[n][2]; key 8n + 2 tig + 1: s[n][1], s[n][3]); V's B fragments (keys
    // 8n + 2 tig and + 1, dims 16p + 2 gid and + 1) two 8-byte loads.
    float pv[2 * DP][4];
#pragma unroll
    for (int dn = 0; dn < 2 * DP; ++dn) pv[dn][0] = pv[dn][1] = pv[dn][2] = pv[dn][3] = 0.f;
    const float* vt = vs + 2 * tig * VS + 2 * gid;
#pragma unroll
    for (int n = 0; n < NK; ++n) {
      unsigned ph[4], pl[4];
      split_tf32(s[n][0], ph[0], pl[0]);
      split_tf32(s[n][2], ph[1], pl[1]);
      split_tf32(s[n][1], ph[2], pl[2]);
      split_tf32(s[n][3], ph[3], pl[3]);
#pragma unroll
      for (int p = 0; p < DP; ++p) {
        const float2 v0 = *reinterpret_cast<const float2*>(vt + n * 8 * VS + p * 16);
        const float2 v1 = *reinterpret_cast<const float2*>(vt + (n * 8 + 1) * VS + p * 16);
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(v0.x, bh0, bl0);
        split_tf32(v1.x, bh1, bl1);
        mma_3xtf32(pv[2 * p], ph, pl, bh0, bh1, bl0, bl1);
        split_tf32(v0.y, bh0, bl0);
        split_tf32(v1.y, bh1, bl1);
        mma_3xtf32(pv[2 * p + 1], ph, pl, bh0, bh1, bl0, bl1);
      }
    }
#pragma unroll
    for (int dn = 0; dn < 2 * DP; ++dn)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[dn][e] = fmaf(o[dn][e], alpha[e >> 1], pv[dn][e]);
    __syncthreads();  // V's tile and K's stage are free
    if (next) issue_v(t + 1);
    cp_async_commit();

    if (++t >= n_tiles) break;
    if (!next) {
      // Past the horizon: needed only while a row has seen no visible key.
      const bool unseen = (row_ok[0] && m[0] == kNegInf) || (row_ok[1] && m[1] == kNegInf);
      if (!__syncthreads_or(unseen)) break;
      issue_k(t);
      cp_async_commit();
      issue_v(t);
      cp_async_commit();
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (l[r] == 0.f) l[r] = 1.f;
  }
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (!row_ok[r]) continue;
    float* orow = out + b * osb + h * osh + (long long)(r0 + 8 * r) * osl + 4 * tig;
#pragma unroll
    for (int p = 0; p < DP; ++p)
      *reinterpret_cast<float4*>(orow + 16 * p) =
          make_float4(o[2 * p][2 * r] / l[r], o[2 * p + 1][2 * r] / l[r], o[2 * p][2 * r + 1] / l[r],
                      o[2 * p + 1][2 * r + 1] / l[r]);
  }
}

template <int D>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v, const void* valid,
                             void* out, int B, int H, int KV, int Lq, int Lk, const long long* st,
                             int q_pos0, float scale, cudaStream_t stream) {
  if (Lq < 1 || Lk < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  constexpr size_t bytes = kF32SmemBytes<D>;
  cudaError_t err = cudaFuncSetAttribute(flash_tf32_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Lq + kF32BQ - 1) / kF32BQ);
  flash_tf32_kernel<D><<<grid, kF32Threads, bytes, stream>>>(
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
