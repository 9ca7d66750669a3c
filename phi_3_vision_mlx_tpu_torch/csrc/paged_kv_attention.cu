// Kernels K6 (decode attention through page tables over the dense page
// pool) and K7 (the same over the int4 page pool).  Each has its own entry
// point; both run one kernel template, which differs only in how it reads a
// key's row.
//
// K6 replaces phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:
// paged_kv_attention (:354), body _paged_kernel (:285).  K7 replaces
// kv_attention.py:paged_quantized_kv_attention (:519), body _paged_q_kernel
// (:442).
//
// The pool (engine/paging.py) is the port's token-major layout with pages in
// place of the batch and window axes: dense (layers, P + 1, KV, page, D)
// bf16 for K and for V; int4 (layers, P + 1, KV, page, D) uint8 with byte
// d = k_q[d] | v_q[d] << 4, and scales (layers, P + 1, KV, page, 4G) bf16.
// Page P is the spare page that unallocated table entries point at.  Slot s
// reads logical key j at page tables[s, j / page], row j % page; a table
// entry outside [0, P] is clamped into it, so a bad table cannot read out of
// bounds.  Query i of slot s sits at position offsets[s] + i and sees key j
// iff j <= offsets[s] + i and (valid[s, j] or j >= offsets[s]): the keys
// from the offset on are this step's fresh ones, whose validity bits commit
// after the step (the TPU kernel's fresh-region rule).  A row that sees no
// key comes out as the uniform average of every value of its window, as the
// plain version's finite NEG_INF gives.  The rounding rules are those of
// K3/K4 (attention.cuh); the int4 values dequantize to the plain version's
// bits.
//
// What bounds them on the H100: bytes.  A decode step reads each slot's
// keys up to its offset once per query head: 2 * D * 2 B per (kv head, key)
// dense, D + 8G B (120 B at D = 96) int4.  The design is K4's: a warp takes
// one key at a time, lane l holds dims l, l + 32 and l + 64 (at D = 96 these
// are the three quantization groups, so each lane needs one scale/bias pair
// per group and a key's scales load as three 8-byte broadcasts); the window
// is cut into runs of `split_keys` keys, one block per (run, query head,
// slot row), and a second kernel merges the runs' (max, sum, output) in run
// order.  The number of runs comes from the window, which the host knows;
// the offsets live on the device, so a run past its slot's last visible key
// finds nothing to do and writes an empty partial.  The TPU kernel walks
// every page of the table; the answer is the same.
//
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "attention.cuh"

namespace {

// Key row `row` of the dense pool's layer: lane holds dims lane + 32 r.
template <int D>
struct DenseKey {
  static constexpr int PER = D / 32;
  float kf[PER], vf[PER];
  __device__ __forceinline__ void load(const void* __restrict__ a, const void* __restrict__ b,
                                       size_t row, int lane) {
    const __nv_bfloat16* kr = static_cast<const __nv_bfloat16*>(a) + row * D + lane;
    const __nv_bfloat16* vr = static_cast<const __nv_bfloat16*>(b) + row * D + lane;
#pragma unroll
    for (int r = 0; r < PER; ++r) {
      kf[r] = bf(kr[32 * r]);
      vf[r] = bf(vr[32 * r]);
    }
  }
  __device__ __forceinline__ float k(int r) const { return kf[r]; }
  __device__ __forceinline__ float v(int r) const { return vf[r]; }
};

// Key row `row` of the int4 pool's layer: a = payload, b = scales.  Lane
// dims lane + 32 r lie in quantization group r.
template <int D>
struct Int4Key {
  static constexpr int PER = D / kGroup;
  unsigned byte[PER];
  KeyScales<PER> sc;
  __device__ __forceinline__ void load(const void* __restrict__ a, const void* __restrict__ b,
                                       size_t row, int lane) {
    const uint8_t* p = static_cast<const uint8_t*>(a) + row * D + lane;
#pragma unroll
    for (int r = 0; r < PER; ++r) byte[r] = p[32 * r];
    sc = load_scales<PER>(static_cast<const __nv_bfloat16*>(b) + row * 4 * PER);
  }
  __device__ __forceinline__ float k(int r) const {
    return dequant(byte[r] & 15u, sc.at(r), sc.at(PER + r));
  }
  __device__ __forceinline__ float v(int r) const {
    return dequant(byte[r] >> 4, sc.at(2 * PER + r), sc.at(3 * PER + r));
  }
};

// Where slot s's logical key j of kv head kvh lies in the layer's pool.
struct Pages {
  const int* tables;     // (S, mp) int32
  int mp, page, KV, P1;  // P1 = P + 1 pages, the spare one included
  __device__ __forceinline__ size_t row(int s, int kvh, int j) const {
    const int pid = min(max(tables[(size_t)s * mp + j / page], 0), P1 - 1);
    return ((size_t)pid * KV + kvh) * page + j % page;
  }
};

// The uniform average of every value of slot s's window, for a query row
// that sees no key.  Called by the whole block; sm_acc is [kWarps][D].
template <int D, class Key>
__device__ void store_paged_uniform_average(const void* a, const void* b, const Pages& pg, int s,
                                            int kvh, float (*sm_acc)[D], __nv_bfloat16* o) {
  constexpr int PER = D / 32;
  constexpr int kWarps = kDecThreads / 32;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = pg.mp * pg.page;
  __syncthreads();
  float sum[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) sum[r] = 0.f;
  for (int j = warp; j < W; j += kWarps) {
    Key key;
    key.load(a, b, pg.row(s, kvh, j), lane);
#pragma unroll
    for (int r = 0; r < PER; ++r) sum[r] += key.v(r);
  }
#pragma unroll
  for (int r = 0; r < PER; ++r) sm_acc[warp][lane + 32 * r] = sum[r];
  __syncthreads();
  if (threadIdx.x < D) {
    float acc = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) acc += sm_acc[w][threadIdx.x];
    o[threadIdx.x] = __float2bfloat16(acc / (float)W);
  }
}

// Grid (n_split, H, S * Lq).  Block `split` attends query row i of head h of
// slot s to keys [split * split_keys, min((split + 1) * split_keys,
// offsets[s] + i + 1, W)).  With one split it writes the output; otherwise
// (max, sum, unnormalized output) to partial[split, row] for the combine
// kernel, row = (s * H + h) * Lq + i.
template <int D, class Key>
__global__ void __launch_bounds__(kDecThreads)
    paged_partial_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ a,
                         const void* __restrict__ b, Pages pg, const uint8_t* __restrict__ valid,
                         const int* __restrict__ offsets, __nv_bfloat16* __restrict__ out,
                         float* __restrict__ partial, int H, int Lq, long long qsb, long long qsh,
                         long long qsl, long long osb, long long osh, long long osl, float scale,
                         int split_keys) {
  constexpr int PER = D / 32;
  constexpr int kWarps = kDecThreads / 32;
  __shared__ float sm_m[kWarps], sm_l[kWarps];
  __shared__ float sm_acc[kWarps][D];

  const int split = blockIdx.x, h = blockIdx.y;
  const int s = blockIdx.z / Lq, i = blockIdx.z % Lq;
  const int kvh = h / (H / pg.KV);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int W = pg.mp * pg.page;
  const uint8_t* vrow = valid + (size_t)s * W;
  const int off = offsets[s];
  const int jbeg = split * split_keys;
  const int jend = min(min(W, off + i + 1), jbeg + split_keys);

  float qv[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r)
    qv[r] = round_bf(bf(q[s * qsb + h * qsh + i * qsl + lane + 32 * r]) * scale);

  float m = kNegInf, l = 0.f, acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc[r] = 0.f;
  for (int j = jbeg + warp; j < jend; j += kWarps) {
    Key key;
    key.load(a, b, pg.row(s, kvh, j), lane);
    float part = 0.f;
#pragma unroll
    for (int r = 0; r < PER; ++r) part = fmaf(qv[r], key.k(r), part);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) part += __shfl_xor_sync(0xffffffffu, part, sh);
    const float sc = (j >= off || vrow[j]) ? part : kNegInf;
    const float m_new = fmaxf(m, sc);
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);
    l = l * alpha + p;
#pragma unroll
    for (int r = 0; r < PER; ++r) acc[r] = fmaf(p, key.v(r), acc[r] * alpha);
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
  float lsum = 0.f, o_acc = 0.f;
  if (threadIdx.x < D) {
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const float f = expf(sm_m[w] - mx);
      lsum += sm_l[w] * f;
      o_acc += sm_acc[w][threadIdx.x] * f;
    }
  }
  if (gridDim.x > 1) {
    const size_t row = ((size_t)s * H + h) * Lq + i;
    float* dst = partial + ((size_t)split * gridDim.y * gridDim.z + row) * (D + 2);
    if (threadIdx.x < D) dst[2 + threadIdx.x] = o_acc;
    if (threadIdx.x == 0) {
      dst[0] = mx;
      dst[1] = lsum;
    }
    return;
  }
  __nv_bfloat16* o = out + s * osb + h * osh + i * osl;
  if (mx > kNegInf) {
    if (threadIdx.x < D) o[threadIdx.x] = __float2bfloat16(o_acc / lsum);
    return;
  }
  store_paged_uniform_average<D, Key>(a, b, pg, s, kvh, sm_acc, o);
}

// Grid (H, S * Lq): merges the n_split partial results of one query row in
// split order.
template <int D, class Key>
__global__ void __launch_bounds__(kDecThreads)
    paged_combine_kernel(const float* __restrict__ partial, const void* __restrict__ a,
                         const void* __restrict__ b, Pages pg, __nv_bfloat16* __restrict__ out,
                         int H, int Lq, long long osb, long long osh, long long osl,
                         int n_split) {
  constexpr int kWarps = kDecThreads / 32;
  __shared__ float sm_acc[kWarps][D];

  const int h = blockIdx.x, s = blockIdx.y / Lq, i = blockIdx.y % Lq;
  const size_t rows = (size_t)gridDim.x * gridDim.y;
  const float* src = partial + (((size_t)s * H + h) * Lq + i) * (D + 2);
  float mx = kNegInf;
  for (int t = 0; t < n_split; ++t) mx = fmaxf(mx, src[t * rows * (D + 2)]);
  __nv_bfloat16* o = out + s * osb + h * osh + i * osl;
  if (mx > kNegInf) {
    if (threadIdx.x < D) {
      float lsum = 0.f, acc = 0.f;
      for (int t = 0; t < n_split; ++t) {
        const float* ps = src + t * rows * (D + 2);
        const float f = expf(ps[0] - mx);
        lsum += ps[1] * f;
        acc += ps[2 + threadIdx.x] * f;
      }
      o[threadIdx.x] = __float2bfloat16(acc / lsum);
    }
    return;
  }
  store_paged_uniform_average<D, Key>(a, b, pg, s, h / (H / pg.KV), sm_acc, o);
}

template <int D, class Key>
cudaError_t launch_paged(const void* q, const void* a, const void* b, Pages pg, const void* valid,
                         const void* offsets, void* out, void* partial, int S, int H, int Lq,
                         const long long* st, float scale, int n_split, int split_keys,
                         cudaStream_t stream) {
  if (n_split < 1 || split_keys < 1 || (long long)n_split * split_keys < (long long)pg.mp * pg.page ||
      (n_split > 1 && partial == nullptr) || Lq < 1 || pg.KV < 1 || H % pg.KV || pg.page < 1)
    return cudaErrorInvalidValue;
  dim3 grid(n_split, H, S * Lq);
  paged_partial_kernel<D, Key><<<grid, kDecThreads, 0, stream>>>(
      static_cast<const __nv_bfloat16*>(q), a, b, pg, static_cast<const uint8_t*>(valid),
      static_cast<const int*>(offsets), static_cast<__nv_bfloat16*>(out),
      static_cast<float*>(partial), H, Lq, st[0], st[1], st[2], st[3], st[4], st[5], scale,
      split_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || n_split == 1) return err;
  paged_combine_kernel<D, Key><<<dim3(H, S * Lq), kDecThreads, 0, stream>>>(
      static_cast<const float*>(partial), a, b, pg, static_cast<__nv_bfloat16*>(out), H, Lq,
      st[3], st[4], st[5], n_split);
  return cudaGetLastError();
}

}  // namespace

// K6.  q (S, H, Lq, D) bf16 with element strides (qsb, qsh, qsl) and unit
// stride along D; pool_k, pool_v (layers, P1, KV, page, D) bf16 contiguous,
// read at `layer` in place; tables (S, mp) int32; valid (S, mp * page) uint8;
// offsets (S,) int32; out (S, H, Lq, D) bf16 with strides (osb, osh, osl);
// partial f32 scratch of n_split * S * H * Lq * (D + 2) floats (unused when
// n_split is 1), n_split * split_keys >= mp * page.  Returns a cudaError_t.
extern "C" int k6_paged_kv_attention(const void* q, const void* pool_k, const void* pool_v,
                                     const void* tables, const void* valid, const void* offsets,
                                     void* out, void* partial, int S, int H, int KV, int Lq,
                                     int P1, int page, int mp, int D, long long qsb, long long qsh,
                                     long long qsl, long long osb, long long osh, long long osl,
                                     int layer, float scale, int n_split, int split_keys,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  const Pages pg{static_cast<const int*>(tables), mp, page, KV, P1};
  const size_t layer_elems = (size_t)P1 * KV * page * D;
  switch (D) {
    case 96: return (int)launch_paged<96, DenseKey<96>>(
        q, static_cast<const __nv_bfloat16*>(pool_k) + (size_t)layer * layer_elems,
        static_cast<const __nv_bfloat16*>(pool_v) + (size_t)layer * layer_elems, pg, valid,
        offsets, out, partial, S, H, Lq, st, scale, n_split, split_keys, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7.  As K6, with payload (layers, P1, KV, page, D) uint8 and scales
// (layers, P1, KV, page, 4G) bf16 (8-byte aligned) in place of pool_k and
// pool_v.  Returns a cudaError_t.
extern "C" int k7_paged_quantized_kv_attention(const void* q, const void* payload,
                                               const void* scales, const void* tables,
                                               const void* valid, const void* offsets, void* out,
                                               void* partial, int S, int H, int KV, int Lq, int P1,
                                               int page, int mp, int D, long long qsb,
                                               long long qsh, long long qsl, long long osb,
                                               long long osh, long long osl, int layer,
                                               float scale, int n_split, int split_keys,
                                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  const Pages pg{static_cast<const int*>(tables), mp, page, KV, P1};
  const size_t layer_rows = (size_t)P1 * KV * page;
  switch (D) {
    case 96: {
      constexpr int G = 96 / kGroup;
      return (int)launch_paged<96, Int4Key<96>>(
          q, static_cast<const uint8_t*>(payload) + (size_t)layer * layer_rows * 96,
          static_cast<const __nv_bfloat16*>(scales) + (size_t)layer * layer_rows * 4 * G, pg,
          valid, offsets, out, partial, S, H, Lq, st, scale, n_split, split_keys, stream);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
