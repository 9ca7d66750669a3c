// Kernels K6 (decode attention through page tables over the dense page
// pool) and K7 (the same over the int4 page pool).  Each has its own entry
// point.
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
// dense, D + 8G B (120 B at D = 96) int4.  The offsets live on the device,
// so the number of blocks comes from the window, which the host knows, and
// a block past its slot's last visible key finds nothing to do.  The TPU
// kernel walks every page of the table; the answer is the same.
//
// Both run K3's split design over the pages (paged_split_kernel): the
// window is cut into runs of kRunKeys = 64 keys, one block per (run, query
// head, slot) taking all of the slot's Lq <= 16 rows, so a page is read once
// per head, not once per query row.  At the served page of 64 a run is one
// page.  The run's loader, a template parameter, is the seam between the
// pools: DenseRun (K6) copies each key's bf16 K and V rows (16-byte
// cp.async, each key's row from the table, so a run may span pages or part
// of one) straight into the padded bf16 tiles; Int4Run (K7) requests one
// contiguous 6 KB block of payload and 1.5 KB of scales into a raw stage and
// dequantizes it once into the same tiles (flash_mma.cuh:
// dequantize_int4_tile, K5's).  Both products then run on the tensor cores
// with the slot's rows as one 16-row tile: one max and one sum per row over
// the run, no per-key rescale.  The block writes each row's (max, sum,
// unnormalized output) to the f32 partials, and paged_run_combine_kernel
// merges each row's runs up to its last visible key in a fixed order, one
// warp a row.
//
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "flash_mma.cuh"

namespace {

// Where slot s's logical key j of kv head kvh lies in the layer's pool.
struct Pages {
  const int* tables;     // (S, mp) int32
  int mp, page, KV, P1;  // P1 = P + 1 pages, the spare one included
  __device__ __forceinline__ size_t row(int s, int kvh, int j) const {
    const int pid = min(max(tables[(size_t)s * mp + j / page], 0), P1 - 1);
    return ((size_t)pid * KV + kvh) * page + j % page;
  }
};

// ---- Runs of pages, K3's split design on the tensor cores ----

constexpr int kRunKeys = kMmaBK;         // keys per run: one page at the served page of 64
constexpr int kRunThreads = kMmaThreads;  // four warps
constexpr int kRunMaxRows = 16;           // a slot's query rows (MAX_PAGED_ROWS): one m16 row tile
constexpr int kPStride = kRunKeys + 8;    // P's row stride (floats): A-fragment reads conflict-free

// The seam: a run's loader has kRawBytes, the bytes of its raw stage (0: the
// copy lands in the bf16 tiles themselves), and three hooks, each called by
// every thread of the block:
// * issue(kt, vt, raw, a, b, pg, s, kvh, j0, n) starts the copy of keys [j0,
//   j0 + n) of slot s's window, kv head kvh, into the K and V tiles
//   ([kRunKeys][D + 8] bf16 each) or the raw stage; rows past n repeat key
//   j0 + n - 1, so the tiles hold finite values there; the kernel commits,
//   waits and adds a barrier;
// * tiles(kt, vt, raw) fills the tiles from the raw stage (the kernel adds a
//   barrier after it when there is a raw stage);
// * window_value(a, b, row, d) reads dim d of the value at pool row `row`
//   (the uniform average of a row that sees no key).

// K6's loader for the dense pool: a = the layer's keys, b = its values,
// (P1, KV, page, D) bf16, 16-byte aligned.  Threads 2r and 2r + 1 copy row
// r, one table lookup each, half of its K row and half of its V row each,
// in 16-byte chunks straight into the padded tiles.
template <int D>
struct DenseRun {
  static constexpr int kRawBytes = 0;

  static __device__ __forceinline__ void issue(__nv_bfloat16* kt, __nv_bfloat16* vt, unsigned char*,
                                               const void* __restrict__ a, const void* __restrict__ b,
                                               const Pages& pg, int s, int kvh, int j0, int n) {
    static_assert(kRunThreads == 2 * kRunKeys && D % 16 == 0, "two threads per row, 16-byte halves");
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    const size_t row = pg.row(s, kvh, j0 + min(r, n - 1));
    const __nv_bfloat16* kr = static_cast<const __nv_bfloat16*>(a) + row * D + c0;
    const __nv_bfloat16* vr = static_cast<const __nv_bfloat16*>(b) + row * D + c0;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {  // D / 16 chunks of 16 B each
      cp_async16(kt + r * (D + 8) + c0 + c, kr + c);
      cp_async16(vt + r * (D + 8) + c0 + c, vr + c);
    }
  }

  static __device__ __forceinline__ void tiles(__nv_bfloat16*, __nv_bfloat16*, const unsigned char*) {}

  static __device__ __forceinline__ float window_value(const void* __restrict__, const void* __restrict__ b,
                                                       size_t row, int d) {
    return bf(static_cast<const __nv_bfloat16*>(b)[row * D + d]);
  }
};

// K7's loader for the int4 pool: a = the layer's payload (P1, KV, page, D)
// uint8, 16-byte aligned; b = its scales (P1, KV, page, 4G) bf16, 8-byte
// aligned.  The raw stage is the int4 raw tile (flash_mma.cuh:
// kInt4TileBytes), which tiles() dequantizes into the bf16 tiles of keys
// and values.
template <int D>
struct Int4Run {
  static constexpr int G = D / kGroup;
  static constexpr int kRawBytes = kInt4TileBytes<D>;

  // Threads 2r and 2r + 1 copy row r, one table lookup each, half of its
  // payload and of its scales each.
  static __device__ __forceinline__ void issue(__nv_bfloat16*, __nv_bfloat16*, unsigned char* raw,
                                               const void* __restrict__ a, const void* __restrict__ b,
                                               const Pages& pg, int s, int kvh, int j0, int n) {
    static_assert(kRunThreads == 2 * kRunKeys, "two threads per row");
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const size_t row = pg.row(s, kvh, j0 + min(r, n - 1));
    const uint8_t* p = static_cast<const uint8_t*>(a) + row * D;
    const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(b) + row * 4 * G;
    __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(raw + kRunKeys * D) + r * 4 * G;
#pragma unroll
    for (int c = half * G; c < (half + 1) * G; ++c) cp_async16(raw + r * D + c * 16, p + c * 16);  // 2G chunks of 16 B
#pragma unroll
    for (int c = half; c < G; c += 2) cp_async8(rs + c * 4, sc + c * 4);  // G pieces of 8 B
  }

  static __device__ __forceinline__ void tiles(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                               const unsigned char* raw) {
    dequantize_int4_tile<D>(ks, vs, raw);
  }

  static __device__ __forceinline__ float window_value(const void* __restrict__ a,
                                                       const void* __restrict__ b, size_t row,
                                                       int d) {
    const __nv_bfloat16* sr = static_cast<const __nv_bfloat16*>(b) + row * 4 * G;
    const int g = d / kGroup;
    return round_bf(dequant_fma(static_cast<const uint8_t*>(a)[row * D + d] >> 4,
                                bf(sr[2 * G + g]), bf(sr[3 * G + g])));
  }
};

// Grid (n_split, H, S), kRunThreads threads.  Block `run` reads keys [run *
// kRunKeys, min((run + 1) * kRunKeys, kend)) of slot s, kend = min(W,
// offsets[s] + Lq): the keys some row of the slot can see.  It writes each
// of the slot's Lq rows' (max, sum, unnormalized output) to partial[run,
// row], row = (s * H + h) * Lq + i; a row that sees no key of the run
// carries max NEG_INF and sum 0.  A run at or past kend writes that empty
// partial for every row and returns at once.
//
// Both products run on the tensor cores (bf16 mma.sync.m16n8k16, f32 sums),
// the slot's rows as one 16-row tile (rows past Lq zero):
// * the run's keys and values reach two bf16 tiles through the loader, the
//   int4 pool's dequantized once, in one pass (timed on an NVIDIA H100 80GB
//   HBM3 at 700 W against keys, then values, through one tile at eight
//   blocks an SM: 9% faster at Lq = 1 though six blocks fit an SM);
// * S = Q K^T: Q's A fragments come straight from q (q * scale rounded to
//   bf16, the rule of attention.cuh); warp w scores keys [16 w, 16 w + 16).
//   The masked scores go to shared memory, and one max and one sum per row
//   over the run turn them into f32 weights p;
// * O = P V: P enters as two bf16 operands, hi = bf16(p) and lo = bf16(p -
//   hi), so it keeps about 16 significant bits (the values are exact in
//   bf16), and the f32 sums come within a few f32 ulps of the plain
//   version's f32 p.  Warp w takes the output's 16-dim column pairs w and
//   w + 4.
template <int D, class Run>
__global__ void __launch_bounds__(kRunThreads)
    paged_split_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ a,
                       const void* __restrict__ b, Pages pg, const uint8_t* __restrict__ valid,
                       const int* __restrict__ offsets, float* __restrict__ partial, int H, int Lq,
                       long long qsb, long long qsh, long long qsl, float scale) {
  constexpr int S = D + 8;          // the tile's row stride (elements): conflict-free ldmatrix
  constexpr int KD = D / 16;        // k-steps of Q K^T
  constexpr int NP = D / 16;        // 16-dim column pairs of O
  constexpr int kWarps = kRunThreads / 32;
  static_assert(D % 32 == 0 && NP <= 2 * kWarps && kRunKeys == 16 * kWarps,
                "k-steps in pairs; two column pairs and 16 keys a warp");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* raw = smem_raw;                                                     // [kRawBytes]
  __nv_bfloat16* kt = reinterpret_cast<__nv_bfloat16*>(smem_raw + Run::kRawBytes);  // [kRunKeys][S]
  __nv_bfloat16* vt = kt + kRunKeys * S;                                             // [kRunKeys][S]
  float* ps = reinterpret_cast<float*>(vt + kRunKeys * S);                           // [Lq][kPStride]
  __shared__ float sm_m[kRunMaxRows], sm_l[kRunMaxRows];
  __shared__ bool listed[kRunKeys];  // key c is in the run and valid or fresh

  const int run = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int kvh = h / (H / pg.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int W = pg.mp * pg.page, off = offsets[s];
  const int j0 = run * kRunKeys;
  const int n = min(kRunKeys, min(W, off + Lq) - j0);
  float* dst = partial + ((size_t)run * gridDim.y * gridDim.z * Lq + ((size_t)s * H + h) * Lq) * (D + 2);
  if (n <= 0) {
    if (tid < Lq) {
      dst[tid * (D + 2)] = kNegInf;
      dst[tid * (D + 2) + 1] = 0.f;
    }
    return;
  }
  Run::issue(kt, vt, raw, a, b, pg, s, kvh, j0, n);
  cp_async_commit();
  if (tid < kRunKeys) listed[tid] = tid < n && (j0 + tid >= off || valid[(size_t)s * W + j0 + tid] != 0);
  unsigned qa[KD][4];  // A fragments: rows gid, gid + 8; columns 2 tig, 2 tig + 8 of each k-step
  const __nv_bfloat16* qb = q + s * qsb + h * qsh;
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e & 1), c = kk * 16 + 2 * tig + 8 * (e >> 1);
      qa[kk][e] = r < Lq ? pack_bf16(bf(qb[r * qsl + c]) * scale, bf(qb[r * qsl + c + 1]) * scale) : 0u;
    }
  }
  cp_async_wait<0>();
  __syncthreads();
  Run::tiles(kt, vt, raw);
  if constexpr (Run::kRawBytes > 0) __syncthreads();

  // S = Q K^T, warp w: keys [16 w, 16 w + 16), two n-tiles.
  float sc[2][4] = {};
#pragma unroll
  for (int kk = 0; kk < KD; kk += 2) {
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      unsigned kb[4];
      ldsm_x4(kb, kt + ((2 * warp + nn) * 8 + (lane & 7)) * S + kk * 16 + (lane >> 3) * 8);
      mma_bf16(sc[nn], qa[kk], kb[0], kb[1]);
      mma_bf16(sc[nn], qa[kk + 1], kb[2], kb[3]);
    }
  }
#pragma unroll
  for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e >> 1), c = (2 * warp + nn) * 8 + 2 * tig + (e & 1);
      if (r < Lq) ps[r * kPStride + c] = listed[c] && j0 + c <= off + r ? sc[nn][e] : -INFINITY;  // -inf: not seen
    }
  }
  __syncthreads();

  // One max and one sum per row over the run; p overwrites the scores.
  for (int r = warp; r < Lq; r += kWarps) {
    float* pr = ps + r * kPStride;
    float mx = -INFINITY;
    for (int t = lane; t < kRunKeys; t += 32) mx = fmaxf(mx, pr[t]);
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
    float sum = 0.f;
    for (int t = lane; t < kRunKeys; t += 32) {
      const float p = mx == -INFINITY ? 0.f : expf(pr[t] - mx);
      pr[t] = p;
      sum += p;
    }
#pragma unroll
    for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
    if (lane == 0) {
      sm_m[r] = mx == -INFINITY ? kNegInf : mx;
      sm_l[r] = sum;
    }
  }
  __syncthreads();

  // O = P V (hi + lo), warp w: column pairs w and w + kWarps.
  float o[2][2][4] = {};
#pragma unroll
  for (int kj = 0; kj < kRunKeys / 16; ++kj) {
    unsigned hi[4], lo[4];
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = gid + 8 * (e & 1), c = kj * 16 + 2 * tig + 8 * (e >> 1);
      const float2 p = r < Lq ? *reinterpret_cast<const float2*>(ps + r * kPStride + c) : make_float2(0.f, 0.f);
      hi[e] = pack_bf16(p.x, p.y);
      lo[e] = pack_bf16(p.x - __uint_as_float(hi[e] << 16), p.y - __uint_as_float(hi[e] & 0xffff0000u));
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int pair = warp + kWarps * u;
      if (pair >= NP) break;
      unsigned vb[4];
      ldsm_x4_trans(vb, vt + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + pair * 16 + (lane >> 4) * 8);
      mma_bf16(o[u][0], hi, vb[0], vb[1]);
      mma_bf16(o[u][0], lo, vb[0], vb[1]);
      mma_bf16(o[u][1], hi, vb[2], vb[3]);
      mma_bf16(o[u][1], lo, vb[2], vb[3]);
    }
  }
#pragma unroll
  for (int u = 0; u < 2; ++u) {
    const int pair = warp + kWarps * u;
    if (pair >= NP) break;
#pragma unroll
    for (int m = 0; m < 2; ++m) {
#pragma unroll
      for (int x = 0; x < 2; ++x) {
        const int r = gid + 8 * x, c = (2 * pair + m) * 8 + 2 * tig;
        if (r < Lq) *reinterpret_cast<float2*>(dst + (size_t)r * (D + 2) + 2 + c) = make_float2(o[u][m][2 * x], o[u][m][2 * x + 1]);
      }
    }
  }
  if (tid < Lq) {
    dst[(size_t)tid * (D + 2)] = sm_m[tid];
    dst[(size_t)tid * (D + 2) + 1] = sm_l[tid];
  }
}

// Grid (H, S), 32 * Lq threads: warp i merges query row i's runs up to its
// last visible key, offsets[s] + i (the runs after it are empty for the
// row), in run order (deterministic), kDeep at a time with all their loads
// in flight; lane l holds dims l + 32 r.  A row that sees no key in any
// run gets the uniform average of every value of the slot's window, read
// through its table, which the block computes once when a row needs it.
template <int D, class Run>
__global__ void __launch_bounds__(32 * kRunMaxRows)
    paged_run_combine_kernel(const float* __restrict__ partial, const void* __restrict__ a,
                             const void* __restrict__ b, Pages pg, const int* __restrict__ offsets,
                             __nv_bfloat16* __restrict__ out, int H, int Lq, long long osb,
                             long long osh, long long osl, int n_split) {
  constexpr int PER = D / 32, kDeep = 16;  // a 1024-key window's runs in one round trip
  __shared__ float sm_sum[kRunMaxRows][D];
  const int h = blockIdx.x, s = blockIdx.y, i = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = pg.mp * pg.page;
  const int live = min(n_split, min(W - 1, offsets[s] + i) / kRunKeys + 1);
  const size_t stride = (size_t)gridDim.y * H * Lq * (D + 2);  // one run's partials
  const float* src = partial + (((size_t)s * H + h) * Lq + i) * (D + 2);

  float m = kNegInf, lsum = 0.f, acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc[r] = 0.f;
  for (int t0 = 0; t0 < live; t0 += kDeep) {
    float md[kDeep], ld[kDeep], ad[kDeep][PER];
#pragma unroll
    for (int u = 0; u < kDeep; ++u) {
      const bool in = t0 + u < live;  // a run past the row's last key carries nothing
      const float* pt = src + min(t0 + u, live - 1) * stride;
      md[u] = in ? pt[0] : kNegInf;
      ld[u] = in ? pt[1] : 0.f;
#pragma unroll
      for (int r = 0; r < PER; ++r) ad[u][r] = in ? pt[2 + lane + 32 * r] : 0.f;
    }
    float m_new = m;
#pragma unroll
    for (int u = 0; u < kDeep; ++u) m_new = fmaxf(m_new, md[u]);
    const float alpha = expf(m - m_new);
    lsum *= alpha;
#pragma unroll
    for (int r = 0; r < PER; ++r) acc[r] *= alpha;
#pragma unroll
    for (int u = 0; u < kDeep; ++u) {
      const float f = expf(md[u] - m_new);
      lsum = fmaf(ld[u], f, lsum);
#pragma unroll
      for (int r = 0; r < PER; ++r) acc[r] = fmaf(ad[u][r], f, acc[r]);
    }
    m = m_new;
  }
  const bool seen = m > kNegInf;
  if (__syncthreads_or(!seen)) {
    // The uniform average of the window: warp w sums keys w, w + Lq, ...
    const int kvh = h / (H / pg.KV);
    float sum[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) sum[r] = 0.f;
    for (int j = i; j < W; j += Lq) {
      const size_t row = pg.row(s, kvh, j);
#pragma unroll
      for (int r = 0; r < PER; ++r) sum[r] += Run::window_value(a, b, row, lane + 32 * r);
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) sm_sum[i][lane + 32 * r] = sum[r];
    __syncthreads();
    if (!seen) {
#pragma unroll
      for (int r = 0; r < PER; ++r) {
        float t = 0.f;
        for (int w = 0; w < Lq; ++w) t += sm_sum[w][lane + 32 * r];
        acc[r] = t;
      }
      lsum = (float)W;
    }
  }
  __nv_bfloat16* o = out + s * osb + h * osh + i * osl;
#pragma unroll
  for (int r = 0; r < PER; ++r) o[lane + 32 * r] = __float2bfloat16(acc[r] / lsum);
}

template <int D, class Run>
cudaError_t launch_paged_runs(const void* q, const void* a, const void* b, Pages pg,
                              const void* valid, const void* offsets, void* out, void* partial,
                              int S, int H, int Lq, const long long* st, float scale, int n_split,
                              int split_keys, cudaStream_t stream) {
  const int W = pg.mp * pg.page;
  if (Lq < 1 || Lq > kRunMaxRows || pg.KV < 1 || H % pg.KV || pg.page < 1 || W < 1 ||
      split_keys != kRunKeys || n_split != (W + kRunKeys - 1) / kRunKeys || partial == nullptr)
    return cudaErrorInvalidValue;
  const size_t bytes = Run::kRawBytes + 2 * sizeof(__nv_bfloat16) * kRunKeys * (D + 8) +
                       sizeof(float) * (size_t)Lq * kPStride;  // int4 34-39 KB, dense 27-31 KB a block
  paged_split_kernel<D, Run><<<dim3(n_split, H, S), kRunThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), a, b, pg, static_cast<const uint8_t*>(valid),
      static_cast<const int*>(offsets), static_cast<float*>(partial), H, Lq, st[0], st[1], st[2],
      scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  paged_run_combine_kernel<D, Run><<<dim3(H, S), 32 * Lq, 0, stream>>>(
      static_cast<const float*>(partial), a, b, pg, static_cast<const int*>(offsets),
      static_cast<__nv_bfloat16*>(out), H, Lq, st[3], st[4], st[5], n_split);
  return cudaGetLastError();
}

}  // namespace

// K6.  q (S, H, Lq, D) bf16 with element strides (qsb, qsh, qsl) and unit
// stride along D, Lq <= 16; pool_k, pool_v (layers, P1, KV, page, D) bf16
// contiguous and 16-byte aligned, read at `layer` in place; tables (S, mp)
// int32; valid (S, mp * page) uint8; offsets (S,) int32; out (S, H, Lq, D)
// bf16 with strides (osb, osh, osl); partial f32 scratch of n_split * S * H
// * Lq * (D + 2) floats; split_keys = 64 and n_split = ceil(mp * page / 64)
// (the wrapper's paged_split_plan).  Returns a cudaError_t.
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
    case 96: return (int)launch_paged_runs<96, DenseRun<96>>(
        q, static_cast<const __nv_bfloat16*>(pool_k) + (size_t)layer * layer_elems,
        static_cast<const __nv_bfloat16*>(pool_v) + (size_t)layer * layer_elems, pg, valid,
        offsets, out, partial, S, H, Lq, st, scale, n_split, split_keys, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7.  As K6, with payload (layers, P1, KV, page, D) uint8 (16-byte
// aligned) and scales (layers, P1, KV, page, 4G) bf16 (8-byte aligned) in
// place of pool_k and pool_v.  Returns a cudaError_t.
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
      return (int)launch_paged_runs<96, Int4Run<96>>(
          q, static_cast<const uint8_t*>(payload) + (size_t)layer * layer_rows * 96,
          static_cast<const __nv_bfloat16*>(scales) + (size_t)layer * layer_rows * 4 * G, pg,
          valid, offsets, out, partial, S, H, Lq, st, scale, n_split, split_keys, stream);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}
