// The split-run decode body of K4 (quant_kv_attention.cu: the stacked int4
// cache, and E2/E3's modes of it), K6 and K7 (paged_kv_attention.cu: the
// dense and the int4 page pool).  Decode attention (Lq <= 16 query rows)
// over one layer of a cache read in place.
//
// What bounds it on the H100: bytes.  A decode step reads each kv head's
// keys up to the last query's position once: 2 * D * 2 B per (kv head, key)
// dense, D + 8G B (120 B at D = 96) int4.  So the window is cut into runs of
// kRunKeys = 64 keys, and the grid is one block per (block of runs, query
// head, row of the cache), each taking all of the row's Lq query rows, so a
// key is read once per head, not once per query row.  A block walks
// `block_keys / 64` consecutive runs (the wrapper's plan; K6 and K7 take
// one run a block, K4 its own count per window, PERF.md): the next run's
// copy is in flight (a two-stage ring of the loader's raw stage, or of the
// bf16 tiles where the loader has none) while it computes the current one.
// Per run, the run's keys and values reach two bf16 tiles through the
// loader (the seam), and both products run on the tensor cores (bf16
// mma.sync.m16n8k16, f32 sums) with the block's rows as one 16-row tile
// (rows past Lq zero):
// * S = Q K^T: the block stages its rows of q once in shared memory (q *
//   scale rounded to bf16, the rule of attention.cuh), and each warp reads
//   its A fragments from there with ldmatrix in every run (rows past Lq
//   from one zero row); warp w scores keys [16 w, 16 w + 16).
//   The masked scores go to shared memory, and one max and one sum per row
//   over the run update the row's running (max, sum) and turn the scores
//   into f32 weights p;
// * O = O * alpha + P V: P enters as two bf16 operands, hi = bf16(p) and lo
//   = bf16(p - hi), so it keeps about 16 significant bits (the values are
//   exact in bf16 but for the rounding every plain version also does), and
//   the f32 sums come within a few f32 ulps of the plain version's f32 p.
//   Warp w takes the output's 16-dim column pairs w and w + 4; its output
//   fragments are rescaled by the row's alpha = exp(old max - new max)
//   between runs (flash style).
// The block writes each row's (max, sum, unnormalized output) to the f32
// partials, and run_combine_kernel merges each row's blocks up to its last
// visible key in a fixed order (deterministic), one warp a row.  A block
// past the keys any row of its cache row can see writes its empty partial
// and returns: the plan takes the window only, never the offsets, so a
// launch replays for any offset.
//
// The window (the other seam) says where logical key j of cache row s and
// kv head kvh lies, the row's offset, and whether a key is listed (may be
// seen); query i of a launch sits at position offset + row0 + i and sees key
// j iff listed and j <= offset + row0 + i (row0: the launch's first row of a
// pass of more than 16 rows, which runs as launches on groups of 16).  A
// row that sees no key comes out as the uniform average of every value of
// its window, as the plain versions' finite NEG_INF gives.  A window has
// KV, row0, width() (its keys), offset(s), row(s, kvh, j) (the key's row in
// the loader's arrays) and listed(s, j, offset), which takes the offset
// without row0:
// * Pages (K6, K7): the page table, per-slot offsets on the device and the
//   fresh-region rule, listed iff valid[s, j] or j >= offsets[s];
// * Stacked (K4): row (s * KV + kvh) * Lmax + j of the layer's stacked
//   cache, one offset on the device for every row, listed iff valid[s, j]
//   (no fresh region).
//
// E2/E3's modes (attention.cuh: Mode) are compile-time variants of the
// int4 loader's tiles and of this body: the tiles hold the mode's values
// (kMxu and kConvert the raw levels); the factored modes add each key's
// bias term sum_g qsum[row][g] * k_bias_g(key) to its score (qsum: the
// query's sum over group g, once per block) and each output dim d the term
// sum_j p_j * v_bias_{g(d)}(j), summed beside the softmax sum; kMxu keeps
// one score accumulator per group (two k-steps each), scaled by the key's k
// scale, and P V takes p * v_scale_g(key) (hi + lo) as the A operand of
// group g's column pairs; kNoSoftmax has no mask and no exp (P is the raw
// score), every run of the whole window is live, and the combine adds.
#pragma once

#include <type_traits>

#include "flash_mma.cuh"

namespace {

constexpr int kRunKeys = kMmaBK;          // keys per run: one page at the served page of 64
constexpr int kRunThreads = kMmaThreads;  // four warps
constexpr int kRunMaxRows = 16;           // query rows of a cache row: one m16 row tile
constexpr int kPStride = kRunKeys + 8;    // P's row stride (floats): A-fragment reads conflict-free

// The loader seam: a run's loader has kRawBytes, the bytes of its raw stage
// (0: the copy lands in the bf16 tiles themselves), kMode (attention.cuh:
// Mode; kFp32 but for E2/E3's variants), and three hooks, each called by
// every thread of the block:
// * issue(kt, vt, raw, a, b, win, s, kvh, j0, n) starts the copy of keys
//   [j0, j0 + n) of row s, kv head kvh, into the K and V tiles ([kRunKeys][D
//   + 8] bf16 each) or the raw stage; rows past n repeat key j0 + n - 1, so
//   the tiles hold finite values there; the kernel commits and waits;
// * tiles(kt, vt, raw) fills the tiles from the raw stage (the kernel adds
//   a barrier after it when there is a raw stage);
// * window_value(a, b, row, d) reads dim d of the value at row `row` (the
//   uniform average of a row that sees no key).

// The int4 loader (K4, K7, E2/E3): a = the layer's payload (rows of D bytes,
// byte d = k_q[d] | v_q[d] << 4), 16-byte aligned; b = its scales (rows of
// 4G bf16: k scale, k bias, v scale, v bias per group), 8-byte aligned.  The
// raw stage is the int4 raw tile (flash_mma.cuh: kInt4TileBytes), which
// tiles() dequantizes into the bf16 tiles of keys and values.  Threads 2r
// and 2r + 1 copy row r, one window lookup each, half of its payload and of
// its scales each (no scales in the modes that read none).
template <int D, int MODE = kFp32>
struct Int4Run {
  static constexpr int G = D / kGroup;
  static constexpr int kRawBytes = kInt4TileBytes<D>;
  static constexpr int kMode = MODE;
  static constexpr bool kF32 = false;

  template <class Win>
  static __device__ __forceinline__ void issue(__nv_bfloat16*, __nv_bfloat16*, unsigned char* raw,
                                               const void* __restrict__ a, const void* __restrict__ b,
                                               const Win& win, int s, int kvh, int j0, int n) {
    static_assert(kRunThreads == 2 * kRunKeys, "two threads per row");
    const int r = threadIdx.x >> 1, half = threadIdx.x & 1;
    const size_t row = win.row(s, kvh, j0 + min(r, n - 1));
    const uint8_t* p = static_cast<const uint8_t*>(a) + row * D;
#pragma unroll
    for (int c = half * G; c < (half + 1) * G; ++c) cp_async16(raw + r * D + c * 16, p + c * 16);  // 2G chunks of 16 B
    if constexpr (!kRaw<MODE>) {
      const __nv_bfloat16* sc = static_cast<const __nv_bfloat16*>(b) + row * 4 * G;
      __nv_bfloat16* rs = reinterpret_cast<__nv_bfloat16*>(raw + kRunKeys * D) + r * 4 * G;
#pragma unroll
      for (int c = half; c < G; c += 2) cp_async8(rs + c * 4, sc + c * 4);  // G pieces of 8 B
    }
  }

  static __device__ __forceinline__ void tiles(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                               const unsigned char* raw) {
    dequantize_int4_tile<D, MODE>(ks, vs, raw);
  }

  static __device__ __forceinline__ float window_value(const void* __restrict__ a,
                                                       const void* __restrict__ b, size_t row,
                                                       int d) {
    const __nv_bfloat16* sr = static_cast<const __nv_bfloat16*>(b) + row * 4 * G;
    const int g = d / kGroup;
    const unsigned lvl = static_cast<const uint8_t*>(a)[row * D + d] >> 4;
    if constexpr (kRaw<MODE>) return level_f(lvl);
    else return mode_value<MODE>(level_f(lvl), bf(sr[2 * G + g]), bf(sr[3 * G + g]));
  }
};

// The loader seam of the fp32 body (split_run_tf32_kernel), where the
// products read their fragments straight from the loader's raw stage (or,
// for keys, from device memory): a loader of an fp32 model has kRawBytes (a
// stage), kQStride (the staged q rows' stride), kKGlobal (keys read from
// device memory, not from the stage) and these hooks:
// * issue(raw, a, b, win, s, kvh, j0, n) starts the copy of keys [j0, j0 +
//   n) of row s, kv head kvh, into the raw stage (rows past n repeat key j0
//   + n - 1); the kernel commits and waits;
// * kdim(kk, tig): the first of the two dims that k slots tig and tig + 4 of
//   Q K^T's k-step kk stand for (the loader picks the order in which its
//   keys read best; the staged q rows are read in the same order);
// * k_pairs(raw, a, win, s, kvh, j, key, tig, k): the values of key `key`
//   of the run (logical key j of the window) at those dims for every
//   k-step, in f32;
// * v_cols(raw, key, col0, v): key's values at dims col0 + 32 i, in f32;
// * window_value(a, b, row, d) as for the bf16 body.
//
// The int4 loader of an fp32 model (K4, K7 in fp32): Int4Run's raw stage and
// copies, each value dequantized in registers as dequant_fma gives it (the
// plain fp32 path's bits: q * s exact, one rounding of + b).  Thread tig's
// dims of Q K^T are the D / 4 consecutive ones from D / 4 tig (kdim), so a
// key's levels are three 8-byte reads, which with rows of D = 96 bytes fall
// in distinct banks for the four keys and four tig of a half-warp; those
// dims lie in at most two groups of 32.  A key's value scales and biases
// are G 4-byte reads.
template <int D>
struct Int4RunF32 {
  static constexpr int G = D / kGroup;
  static constexpr int PER = D / 4;  // a thread's dims of Q K^T
  static constexpr int kRawBytes = kInt4TileBytes<D>;
  static constexpr int kQStride = D + 2;  // q rows two banks apart: 8-byte reads conflict-free
  static constexpr bool kKGlobal = false;
  static constexpr int kMode = kFp32;
  static constexpr bool kF32 = true;
  static_assert(PER % 8 == 0 && PER <= kGroup, "8-byte reads, at most two groups a thread");

  template <class Win>
  static __device__ __forceinline__ void issue(unsigned char* raw, const void* __restrict__ a,
                                               const void* __restrict__ b, const Win& win, int s, int kvh, int j0,
                                               int n) {
    Int4Run<D>::issue(nullptr, nullptr, raw, a, b, win, s, kvh, j0, n);
  }

  static __device__ __forceinline__ int kdim(int kk, int tig) { return PER * tig + 2 * kk; }

  template <class Win>
  static __device__ __forceinline__ void k_pairs(const unsigned char* __restrict__ raw, const void* __restrict__,
                                                 const Win&, int, int, int, int key, int tig, float2 (&k)[D / 8]) {
    const unsigned char* p = raw + key * D + PER * tig;
    const __nv_bfloat16* sr = reinterpret_cast<const __nv_bfloat16*>(raw + kRunKeys * D) + key * 4 * G;
    const int g0 = PER * tig / kGroup, g1 = min(g0 + 1, G - 1), edge = (g0 + 1) * kGroup;
    const float s0 = bf(sr[g0]), b0 = bf(sr[G + g0]), s1 = bf(sr[g1]), b1 = bf(sr[G + g1]);
#pragma unroll
    for (int i = 0; i < PER / 8; ++i) {
      const uint2 w = *reinterpret_cast<const uint2*>(p + 8 * i);
#pragma unroll
      for (int h = 0; h < 2; ++h) {  // word h: dims 8 i + 4 h .. + 3, k-steps 4 i + 2 h and + 1
        const unsigned lv = (h ? w.y : w.x) & 0x0F0F0F0Fu;
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int kk = 4 * i + 2 * h + e;
          const bool hi = PER * tig + 2 * kk >= edge;
          const float sc = hi ? s1 : s0, bi = hi ? b1 : b0;
          k[kk] = make_float2(dequant_fma(byte_level(lv, 2 * e), sc, bi), dequant_fma(byte_level(lv, 2 * e + 1), sc, bi));
        }
      }
    }
  }

  static __device__ __forceinline__ void v_cols(const unsigned char* __restrict__ raw, int key, int col0,
                                                float (&v)[D / 32]) {
    static_assert(kGroup == 32, "dims col0 + 32 i lie in group i");
    const unsigned char* p = raw + key * D + col0;
    // bf16 m of the key's v scales then v biases: half m % 2 of word m / 2
    const unsigned* sw = reinterpret_cast<const unsigned*>(raw + kRunKeys * D) + key * 2 * G + G;
    unsigned w[G];
#pragma unroll
    for (int i = 0; i < G; ++i) w[i] = sw[i];
    auto bf_at = [&](int m) { return __uint_as_float(m & 1 ? w[m / 2] & 0xFFFF0000u : w[m / 2] << 16); };
#pragma unroll
    for (int i = 0; i < D / 32; ++i) v[i] = dequant_fma(level_f(p[32 * i] >> 4), bf_at(i), bf_at(G + i));
  }

  static __device__ __forceinline__ float window_value(const void* __restrict__ a, const void* __restrict__ b,
                                                       size_t row, int d) {
    const __nv_bfloat16* sr = static_cast<const __nv_bfloat16*>(b) + row * 4 * G;
    const int g = d / kGroup;
    return dequant_fma(level_f(static_cast<const uint8_t*>(a)[row * D + d] >> 4), bf(sr[2 * G + g]),
                       bf(sr[3 * G + g]));
  }
};

// Grid (n_split, H, rows of the cache), kRunThreads threads.  Block `blk`
// reads keys [blk * block_keys, min((blk + 1) * block_keys, kend)) of row s
// in runs of kRunKeys, kend = min(W, offset + row0 + Lq) (kNoSoftmax: W): the keys
// some query row can see.  It writes each of the row's Lq query rows'
// (max, sum, unnormalized output) to partial[blk, (s * H + h) * Lq + i]; a
// query row that sees no key of the block carries max NEG_INF and sum 0.  A
// block at or past kend writes that empty partial for every row and
// returns at once.  kMulti: the block may walk more than one run (block_keys
// > kRunKeys); without it the run loop is one pass, compiled as such.
template <int D, class Run, class Win, bool kMulti>
__global__ void __launch_bounds__(kRunThreads)
    split_run_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ a,
                     const void* __restrict__ b, Win win, float* __restrict__ partial, int H, int Lq,
                     long long qsb, long long qsh, long long qsl, float scale, int block_keys) {
  constexpr int MODE = Run::kMode;
  constexpr bool kSoftmax = MODE != kNoSoftmax, kFact = kFactored<MODE>;
  constexpr int G = D / kGroup;
  constexpr int S = D + 8;          // the tile's row stride (elements): conflict-free ldmatrix
  constexpr int KD = D / 16;        // k-steps of Q K^T, two per group of 32
  constexpr int NP = D / 16;        // 16-dim column pairs of O, two per group
  constexpr int kWarps = kRunThreads / 32;
  constexpr bool kRawRing = Run::kRawBytes > 0;  // a raw ring, single-buffered tiles
  static_assert(D % 32 == 0 && NP <= 2 * kWarps && kRunKeys == 16 * kWarps && kGroup == 32,
                "k-steps in pairs, a pair per group; two column pairs and 16 keys a warp");
  constexpr int kStages = kMulti ? 2 : 1;  // the ring: raw stages, or tile stages without them
  constexpr int kTileStages = kRawRing ? 1 : kStages;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* raw = smem_raw;  // [kStages][kRawBytes]
  __nv_bfloat16* kt0 = reinterpret_cast<__nv_bfloat16*>(smem_raw + kStages * Run::kRawBytes);
  __nv_bfloat16* vt0 = kt0 + kTileStages * kRunKeys * S;                   // [kTileStages][kRunKeys][S]
  float* ps = reinterpret_cast<float*>(vt0 + kTileStages * kRunKeys * S);  // [Lq][kPStride]
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(ps + Lq * kPStride);  // [Lq + 1][S]: q * scale, a zero row
  __shared__ float sm_m[kRunMaxRows], sm_l[kRunMaxRows], sm_a[kRunMaxRows];     // running max, sum; alpha
  __shared__ float sm_qs[kFact ? kRunMaxRows : 1][G], sm_pb[kFact ? kRunMaxRows : 1][G];  // qsum; value bias
  __shared__ bool listed[kRunKeys];  // key c is in the run and listed

  const int blk = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int kvh = h / (H / win.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int W = win.width(), off = win.offset(s), q0 = off + win.row0;  // q0: query row 0's position
  const int jb = blk * block_keys;
  const int je = min(kSoftmax ? min(W, q0 + Lq) : W, jb + block_keys);
  float* dst = partial + ((size_t)blk * gridDim.y * gridDim.z * Lq + ((size_t)s * H + h) * Lq) * (D + 2);
  if (je <= jb) {
    if (tid < Lq) {
      dst[tid * (D + 2)] = kNegInf;
      dst[tid * (D + 2) + 1] = 0.f;
    }
    return;
  }
  const int n_runs = kMulti ? (je - jb + kRunKeys - 1) / kRunKeys : 1;
  auto kt = [&](int t) { return kt0 + (t & (kTileStages - 1)) * kRunKeys * S; };
  auto vt = [&](int t) { return vt0 + (t & (kTileStages - 1)) * kRunKeys * S; };
  auto rw = [&](int t) { return raw + (t & (kStages - 1)) * Run::kRawBytes; };
  auto issue = [&](int t) {
    const int j0 = jb + t * kRunKeys;
    Run::issue(kt(t), vt(t), rw(t), a, b, win, s, kvh, j0, min(kRunKeys, je - j0));
  };
  issue(0);
  cp_async_commit();
  const __nv_bfloat16* qb = q + s * qsb + h * qsh;
  for (int x = tid; x < (Lq + 1) * D; x += kRunThreads) {
    const int r = x / D, c = x % D;
    qs[r * S + c] = __float2bfloat16(r < Lq ? bf(qb[r * qsl + c]) * scale : 0.f);
  }
  const __nv_bfloat16* qrow = qs + min(lane & 15, Lq) * S + (lane >> 4) * 8;  // rows past Lq: the zero row
  if (tid < kRunMaxRows) {
    sm_m[tid] = -INFINITY;
    sm_l[tid] = 0.f;
  }
  if constexpr (kFact) {  // each row's query summed over each group, as the A fragments hold it
    __syncthreads();
    for (int x = tid; x < Lq * G; x += kRunThreads) {
      const int r = x / G, g = x % G;
      float t = 0.f;
      for (int c = 0; c < kGroup; ++c) t += bf(qs[r * S + g * kGroup + c]);
      sm_qs[r][g] = t;
      sm_pb[r][g] = 0.f;
    }
  }

  float o[2][2][4] = {};
  for (int t = 0; t < n_runs; ++t) {
    const int j0 = jb + t * kRunKeys, n = min(kRunKeys, je - j0);
    if (kMulti && t + 1 < n_runs) issue(t + 1);
    cp_async_commit();
    if (tid < kRunKeys) listed[tid] = tid < n && (!kSoftmax || win.listed(s, j0 + tid, off));
    cp_async_wait<1>();
    __syncthreads();
    Run::tiles(kt(t), vt(t), rw(t));
    if constexpr (kRawRing) __syncthreads();
    // The run's scales (the factored modes): key c's plane p, group g.
    const __nv_bfloat16* rsc = reinterpret_cast<const __nv_bfloat16*>(rw(t) + kRunKeys * D);
    auto key_scale = [&](int c, int p, int g) { return bf(rsc[c * 4 * G + p * G + g]); };

    // S = Q K^T, warp w: keys [16 w, 16 w + 16), two n-tiles.
    float sc[2][4] = {};
    const __nv_bfloat16* ktt = kt(t);
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
      unsigned qa[2][4];  // A fragments of k-steps kk and kk + 1: rows gid, gid + 8; columns 2 tig, 2 tig + 8
      ldsm_x4(qa[0], qrow + kk * 16);
      ldsm_x4(qa[1], qrow + kk * 16 + 16);
      float sg[2][4] = {};  // kMxu: group kk / 2's own sums
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
        unsigned kb[4];
        ldsm_x4(kb, ktt + ((2 * warp + nn) * 8 + (lane & 7)) * S + kk * 16 + (lane >> 3) * 8);
        if constexpr (MODE == kMxu) {
          mma_bf16(sg[nn], qa[0], kb[0], kb[1]);
          mma_bf16(sg[nn], qa[1], kb[2], kb[3]);
        } else {
          mma_bf16(sc[nn], qa[0], kb[0], kb[1]);
          mma_bf16(sc[nn], qa[1], kb[2], kb[3]);
        }
      }
      if constexpr (MODE == kMxu) {
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            sc[nn][e] = fmaf(sg[nn][e], key_scale((2 * warp + nn) * 8 + 2 * tig + (e & 1), 0, kk / 2), sc[nn][e]);
        }
      }
    }
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + 8 * (e >> 1), c = (2 * warp + nn) * 8 + 2 * tig + (e & 1);
        if (r >= Lq) continue;
        float v = sc[nn][e];
        if constexpr (kFact) {
#pragma unroll
          for (int g = 0; g < G; ++g) v = fmaf(sm_qs[r][g], key_scale(c, 1, g), v);
        }
        if constexpr (kSoftmax) ps[r * kPStride + c] = listed[c] && j0 + c <= q0 + r ? v : -INFINITY;  // -inf: not seen
        else ps[r * kPStride + c] = listed[c] ? v : 0.f;  // P is the score; keys past n weigh nothing
      }
    }
    __syncthreads();

    if constexpr (kSoftmax) {
      // One max per row over the run, the row's new running max, and p
      // (over the scores, in place); the running sum (and value bias) rescaled.
      for (int r = warp; r < Lq; r += kWarps) {
        float* pr = ps + r * kPStride;
        float mx = -INFINITY;
        for (int c = lane; c < kRunKeys; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
        const float m_old = sm_m[r], m_new = fmaxf(m_old, mx);
        float sum = 0.f, pb[kFact ? G : 1] = {};
        for (int c = lane; c < kRunKeys; c += 32) {
          const float p = m_new == -INFINITY ? 0.f : expf(pr[c] - m_new);
          pr[c] = p;
          sum += p;
          if constexpr (kFact) {
#pragma unroll
            for (int g = 0; g < G; ++g) pb[g] = fmaf(p, key_scale(c, 3, g), pb[g]);
          }
        }
#pragma unroll
        for (int sh = 16; sh > 0; sh >>= 1) {
          sum += __shfl_xor_sync(0xffffffffu, sum, sh);
          if constexpr (kFact) {
#pragma unroll
            for (int g = 0; g < G; ++g) pb[g] += __shfl_xor_sync(0xffffffffu, pb[g], sh);
          }
        }
        if (lane == 0) {
          const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);  // exp(-inf) = 0: a first max
          sm_a[r] = alpha;
          sm_m[r] = m_new;
          sm_l[r] = fmaf(sm_l[r], alpha, sum);
          if constexpr (kFact) {
#pragma unroll
            for (int g = 0; g < G; ++g) sm_pb[r][g] = fmaf(sm_pb[r][g], alpha, pb[g]);
          }
        }
      }
      __syncthreads();
      if (kMulti && t > 0) {  // the output so far, to the new max
        const float a0 = gid < Lq ? sm_a[gid] : 0.f, a1 = gid + 8 < Lq ? sm_a[gid + 8] : 0.f;
#pragma unroll
        for (int u = 0; u < 2; ++u) {
#pragma unroll
          for (int m = 0; m < 2; ++m) {
            o[u][m][0] *= a0;
            o[u][m][1] *= a0;
            o[u][m][2] *= a1;
            o[u][m][3] *= a1;
          }
        }
      }
    }

    // O += P V (hi + lo), warp w: column pairs w and w + kWarps.  kMxu: the
    // A operand of group g's pairs is p * v_scale_g(key).
    const __nv_bfloat16* vtt = vt(t);
    auto p_frag = [&](int kj, int g, unsigned(&hi)[4], unsigned(&lo)[4]) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = gid + 8 * (e & 1), c = kj * 16 + 2 * tig + 8 * (e >> 1);
        float2 p = r < Lq ? *reinterpret_cast<const float2*>(ps + r * kPStride + c) : make_float2(0.f, 0.f);
        if constexpr (MODE == kMxu) {
          p.x *= key_scale(c, 2, g);
          p.y *= key_scale(c + 1, 2, g);
        }
        hi[e] = pack_bf16(p.x, p.y);
        lo[e] = pack_bf16(p.x - __uint_as_float(hi[e] << 16), p.y - __uint_as_float(hi[e] & 0xffff0000u));
      }
    };
#pragma unroll
    for (int kj = 0; kj < kRunKeys / 16; ++kj) {
      unsigned hi[4], lo[4];
      if constexpr (MODE != kMxu) p_frag(kj, 0, hi, lo);
#pragma unroll
      for (int u = 0; u < 2; ++u) {
        const int pair = warp + kWarps * u;
        if (pair >= NP) break;
        if constexpr (MODE == kMxu) p_frag(kj, pair / 2, hi, lo);
        unsigned vb[4];
        ldsm_x4_trans(vb, vtt + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + pair * 16 + (lane >> 4) * 8);
        mma_bf16(o[u][0], hi, vb[0], vb[1]);
        mma_bf16(o[u][0], lo, vb[0], vb[1]);
        mma_bf16(o[u][1], hi, vb[2], vb[3]);
        mma_bf16(o[u][1], lo, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the scores, the listed bits, the tiles and the raw stage are free
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
        if (r >= Lq) continue;
        float2 v = make_float2(o[u][m][2 * x], o[u][m][2 * x + 1]);
        if constexpr (kFact) {  // the value biases (c and c + 1 share a group)
          v.x += sm_pb[r][c / kGroup];
          v.y += sm_pb[r][c / kGroup];
        }
        *reinterpret_cast<float2*>(dst + (size_t)r * (D + 2) + 2 + c) = v;
      }
    }
  }
  if (tid < Lq) {
    dst[(size_t)tid * (D + 2)] = sm_m[tid] == -INFINITY ? kNegInf : sm_m[tid];
    dst[(size_t)tid * (D + 2) + 1] = sm_l[tid];
  }
}

// The fp32 body (Run::kF32): split_run_kernel's grid, plan, window, mask,
// softmax and partials, with f32 q and both products on the tensor cores in
// 3xTF32 (tf32 mma.sync.m16n8k8, each f32 operand split into tf32 hi + lo,
// lo * lo dropped: mma.cuh's mma_3xtf32), so the f32 values go through
// neither the CUDA cores' FMAs nor f32 tiles in shared memory.  The block's
// Lq rows form one 16-row tile (rows past Lq zero):
// * S = Q K^T: warp w scores keys [16 w, 16 w + 16), two n-tiles; a thread's
//   B fragments are its key's values at the loader's dims (k_pairs: for
//   int4 read and dequantized in f32 straight from the raw stage, for an f32
//   pool read from device memory, issued before the wait for the run's
//   stage), split as they are read; its A fragments come from q * scale,
//   staged once a block already split into tf32 hi and lo; hi * hi sums
//   apart from the lo terms (the tensor cores round their f32 sums toward
//   zero: short chains drift less);
// * the masked scores go to shared memory, and one max and one sum per row
//   over the run update the row's running (max, sum) and turn the scores
//   into f32 weights p, as in the bf16 body, written back split into tf32 hi
//   and lo (once, not once per warp);
// * O = O * alpha + P V: warp w owns D's 8-wide column tiles w, w + 4, ..
//   (dims 32 i + 8 w + gid for column gid: tile i lies in group i), key
//   slots t and t + 4 of k-step j stand for keys 8 j + t and + 4; V's values
//   (v_cols) are split as they are read; each run's P V is summed from zero
//   and joins O in one rounded fma.
// Shared memory: the loader's ring, q * scale's hi and lo [Lq][kQStride]
// and P's [Lq][kF32PStride]: 9-29 KB a block over the int4 cache (17-37 KB
// where a block walks several runs), 26-47 KB over an f32 pool (its V stage,
// 24 KB).
constexpr int kF32PStride = kRunKeys + 4;  // P's row stride: A-fragment reads conflict-free

template <int D, class Run, class Win, bool kMulti>
__global__ void __launch_bounds__(kRunThreads)
    split_run_tf32_kernel(const float* __restrict__ q, const void* __restrict__ a, const void* __restrict__ b,
                          Win win, float* __restrict__ partial, int H, int Lq, long long qsb, long long qsh,
                          long long qsl, float scale, int block_keys) {
  constexpr int KD = D / 8;   // k-steps of Q K^T
  constexpr int NW = D / 32;  // P V's column tiles a warp
  constexpr int kWarps = kRunThreads / 32;
  constexpr int QS = Run::kQStride, PS = kF32PStride;
  static_assert(D % 32 == 0 && kRunKeys == 16 * kWarps && kWarps == 4, "16 keys and D / 32 column tiles a warp");
  constexpr int kStages = kMulti ? 2 : 1;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  unsigned char* raw = smem_raw;                                                   // [kStages][kRawBytes]
  unsigned* qh = reinterpret_cast<unsigned*>(smem_raw + kStages * Run::kRawBytes);  // [Lq][QS]: q * scale, hi
  unsigned* ql = qh + Lq * QS;                                                     // [Lq][QS]: lo
  float* ps = reinterpret_cast<float*>(ql + Lq * QS);  // [Lq][PS]: the scores, then P's hi
  unsigned* pl = reinterpret_cast<unsigned*>(ps + Lq * PS);                        // [Lq][PS]: P's lo
  __shared__ float sm_m[kRunMaxRows], sm_l[kRunMaxRows], sm_a[kRunMaxRows];        // running max, sum; alpha
  __shared__ bool listed[kRunKeys];

  const int blk = blockIdx.x, h = blockIdx.y, s = blockIdx.z;
  const int kvh = h / (H / win.KV);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int W = win.width(), off = win.offset(s), q0 = off + win.row0;
  const int jb = blk * block_keys;
  const int je = min(min(W, q0 + Lq), jb + block_keys);
  float* dst = partial + ((size_t)blk * gridDim.y * gridDim.z * Lq + ((size_t)s * H + h) * Lq) * (D + 2);
  if (je <= jb) {
    if (tid < Lq) {
      dst[tid * (D + 2)] = kNegInf;
      dst[tid * (D + 2) + 1] = 0.f;
    }
    return;
  }
  const int n_runs = kMulti ? (je - jb + kRunKeys - 1) / kRunKeys : 1;
  auto rw = [&](int t) { return raw + (t & (kStages - 1)) * Run::kRawBytes; };
  auto issue = [&](int t) {
    const int j0 = jb + t * kRunKeys;
    Run::issue(rw(t), a, b, win, s, kvh, j0, min(kRunKeys, je - j0));
  };
  float2 kv[2][KD];  // S's B fragments: keys 16 w + 8 nn + gid of the run at the thread's dims
  auto load_k = [&](int t) {
    const int j0 = jb + t * kRunKeys, n = min(kRunKeys, je - j0);
#pragma unroll
    for (int nn = 0; nn < 2; ++nn) {
      const int key = 16 * warp + 8 * nn + gid;
      Run::k_pairs(rw(t), a, win, s, kvh, j0 + min(key, n - 1), key, tig, kv[nn]);
    }
  };
  issue(0);
  cp_async_commit();
  if constexpr (Run::kKGlobal) load_k(0);  // in flight with the stage's copy and q's loads
  const float* qb = q + s * qsb + h * qsh;
  for (int x = tid; x < Lq * D; x += kRunThreads) {
    const int r = x / D, c = x % D;
    split_tf32(qb[r * qsl + c] * scale, qh[r * QS + c], ql[r * QS + c]);  // q * scale in f32, as the plain path
  }
  if (tid < kRunMaxRows) {
    sm_m[tid] = -INFINITY;
    sm_l[tid] = 0.f;
  }
  const bool row_in[2] = {gid < Lq, gid + 8 < Lq};  // this thread's rows gid and gid + 8

  float o[NW][4] = {};
  for (int t = 0; t < n_runs; ++t) {
    const int j0 = jb + t * kRunKeys, n = min(kRunKeys, je - j0);
    if (kMulti && t + 1 < n_runs) issue(t + 1);
    cp_async_commit();
    if (tid < kRunKeys) listed[tid] = tid < n && win.listed(s, j0 + tid, off);
    const unsigned char* rt = rw(t);
    if (Run::kKGlobal && t > 0) load_k(t);  // in flight with the stage's copy
    cp_async_wait<1>();
    __syncthreads();
    if constexpr (!Run::kKGlobal) load_k(t);

    // S = Q K^T, warp w: keys 16 w + 8 nn + gid (B fragments), two n-tiles.
    {
      float sc[2][4] = {}, slo[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < KD; ++kk) {
        const int d0 = Run::kdim(kk, tig);
        const uint2 z = make_uint2(0u, 0u);
        const uint2 h0 = row_in[0] ? *reinterpret_cast<const uint2*>(qh + gid * QS + d0) : z;
        const uint2 h1 = row_in[1] ? *reinterpret_cast<const uint2*>(qh + (gid + 8) * QS + d0) : z;
        const uint2 l0 = row_in[0] ? *reinterpret_cast<const uint2*>(ql + gid * QS + d0) : z;
        const uint2 l1 = row_in[1] ? *reinterpret_cast<const uint2*>(ql + (gid + 8) * QS + d0) : z;
        // a0: row gid, k slot tig; a1: row gid + 8; a2, a3: k slot tig + 4
        const unsigned qah[4] = {h0.x, h1.x, h0.y, h1.y}, qal[4] = {l0.x, l1.x, l0.y, l1.y};
#pragma unroll
        for (int nn = 0; nn < 2; ++nn) {
          unsigned bh0, bl0, bh1, bl1;
          split_tf32(kv[nn][kk].x, bh0, bl0);
          split_tf32(kv[nn][kk].y, bh1, bl1);
          mma_tf32(slo[nn], qal, bh0, bh1);
          mma_tf32(slo[nn], qah, bl0, bl1);
          mma_tf32(sc[nn], qah, bh0, bh1);
        }
      }
#pragma unroll
      for (int nn = 0; nn < 2; ++nn) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = gid + 8 * (e >> 1), c = 16 * warp + 8 * nn + 2 * tig + (e & 1);
          if (r >= Lq) continue;
          ps[r * PS + c] = listed[c] && j0 + c <= q0 + r ? sc[nn][e] + slo[nn][e] : -INFINITY;  // -inf: not seen
        }
      }
    }
    __syncthreads();

    // One max per row over the run, the row's new running max, and p (over
    // the scores, in place, as tf32 hi; lo beside it); the running sum
    // rescaled.
    for (int r = warp; r < Lq; r += kWarps) {
      float* pr = ps + r * PS;
      float mx = -INFINITY;
      for (int c = lane; c < kRunKeys; c += 32) mx = fmaxf(mx, pr[c]);
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, sh));
      const float m_old = sm_m[r], m_new = fmaxf(m_old, mx);
      float sum = 0.f;
      for (int c = lane; c < kRunKeys; c += 32) {
        const float p = m_new == -INFINITY ? 0.f : expf(pr[c] - m_new);
        unsigned hi;
        split_tf32(p, hi, pl[r * PS + c]);
        pr[c] = __uint_as_float(hi);
        sum += p;
      }
#pragma unroll
      for (int sh = 16; sh > 0; sh >>= 1) sum += __shfl_xor_sync(0xffffffffu, sum, sh);
      if (lane == 0) {
        const float alpha = m_new == -INFINITY ? 1.f : expf(m_old - m_new);  // exp(-inf) = 0: a first max
        sm_a[r] = alpha;
        sm_m[r] = m_new;
        sm_l[r] = fmaf(sm_l[r], alpha, sum);
      }
    }
    __syncthreads();

    // This run's P V, summed from zero: A = P (rows gid, gid + 8; keys 8 j +
    // tig and + 4), B = V (those keys, dims 32 i + 8 w + gid).
    const unsigned* ph = reinterpret_cast<const unsigned*>(ps);
    float pv[NW][4] = {};
#pragma unroll
    for (int j = 0; j < kRunKeys / 8; ++j) {
      const int c = 8 * j + tig;
      const int i0 = gid * PS + c, i1 = (gid + 8) * PS + c;
      const unsigned pah[4] = {row_in[0] ? ph[i0] : 0u, row_in[1] ? ph[i1] : 0u, row_in[0] ? ph[i0 + 4] : 0u,
                               row_in[1] ? ph[i1 + 4] : 0u};
      const unsigned pal[4] = {row_in[0] ? pl[i0] : 0u, row_in[1] ? pl[i1] : 0u, row_in[0] ? pl[i0 + 4] : 0u,
                               row_in[1] ? pl[i1 + 4] : 0u};
      float v0[NW], v1[NW];
      Run::v_cols(rt, c, 8 * warp + gid, v0);
      Run::v_cols(rt, c + 4, 8 * warp + gid, v1);
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        unsigned bh0, bl0, bh1, bl1;
        split_tf32(v0[i], bh0, bl0);
        split_tf32(v1[i], bh1, bl1);
        mma_3xtf32(pv[i], pah, pal, bh0, bh1, bl0, bl1);
      }
    }
    const float al[2] = {row_in[0] ? sm_a[gid] : 0.f, row_in[1] ? sm_a[gid + 8] : 0.f};
#pragma unroll
    for (int i = 0; i < NW; ++i)
#pragma unroll
      for (int e = 0; e < 4; ++e) o[i][e] = fmaf(o[i][e], al[e >> 1], pv[i][e]);
    __syncthreads();  // the scores, P, the listed bits and the raw stage are free
  }

#pragma unroll
  for (int i = 0; i < NW; ++i) {
#pragma unroll
    for (int x = 0; x < 2; ++x) {
      if (!row_in[x]) continue;
      const int r = gid + 8 * x, c = 8 * (warp + kWarps * i) + 2 * tig;
      *reinterpret_cast<float2*>(dst + (size_t)r * (D + 2) + 2 + c) = make_float2(o[i][2 * x], o[i][2 * x + 1]);
    }
  }
  if (tid < Lq) {
    dst[(size_t)tid * (D + 2)] = sm_m[tid] == -INFINITY ? kNegInf : sm_m[tid];
    dst[(size_t)tid * (D + 2) + 1] = sm_l[tid];
  }
}

// Grid (H, rows of the cache), 32 * Lq threads: warp i merges query row i's
// blocks up to its last visible key, offset + row0 + i (the blocks after it are
// empty for the row), in block order (deterministic), kDeep at a time with
// all their loads in flight; lane l holds dims l + 32 r.  A row that sees no
// key in any block gets the uniform average of every value of its window,
// read through the window, which the block computes once when a row needs
// it.  kNoSoftmax adds every block's output.
template <int D, class Run, class Win, typename T>
__global__ void __launch_bounds__(32 * kRunMaxRows)
    run_combine_kernel(const float* __restrict__ partial, const void* __restrict__ a,
                       const void* __restrict__ b, Win win, T* __restrict__ out, int H,
                       int Lq, long long osb, long long osh, long long osl, int n_split,
                       int block_keys) {
  constexpr int PER = D / 32, kDeep = 16;  // a 1024-key window's 64-key blocks in one round trip
  __shared__ float sm_sum[kRunMaxRows][D];
  const int h = blockIdx.x, s = blockIdx.y, i = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int W = win.width();
  const size_t stride = (size_t)gridDim.y * H * Lq * (D + 2);  // one block's partials
  const float* src = partial + (((size_t)s * H + h) * Lq + i) * (D + 2);
  T* o = out + s * osb + h * osh + i * osl;
  float acc[PER];
#pragma unroll
  for (int r = 0; r < PER; ++r) acc[r] = 0.f;
  if constexpr (Run::kMode == kNoSoftmax) {
#pragma unroll 4
    for (int t = 0; t < n_split; ++t) {
#pragma unroll
      for (int r = 0; r < PER; ++r) acc[r] += src[t * stride + 2 + lane + 32 * r];
    }
#pragma unroll
    for (int r = 0; r < PER; ++r) put(o + lane + 32 * r, acc[r]);
    return;
  }
  const int live = min(n_split, min(W - 1, win.offset(s) + win.row0 + i) / block_keys + 1);

  float m = kNegInf, lsum = 0.f;
  for (int t0 = 0; t0 < live; t0 += kDeep) {
    float md[kDeep], ld[kDeep], ad[kDeep][PER];
#pragma unroll
    for (int u = 0; u < kDeep; ++u) {
      const bool in = t0 + u < live;  // a block past the row's last key carries nothing
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
    const int kvh = h / (H / win.KV);
    float sum[PER];
#pragma unroll
    for (int r = 0; r < PER; ++r) sum[r] = 0.f;
    for (int j = i; j < W; j += Lq) {
      const size_t row = win.row(s, kvh, j);
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
#pragma unroll
  for (int r = 0; r < PER; ++r) put(o + lane + 32 * r, acc[r] / lsum);
}

// The split kernel of a Run: the fp32 body for an fp32 Run, else the bf16 one.
template <int D, class Run, class Win, bool kMulti>
auto split_kernel() {
  if constexpr (Run::kF32) return split_run_tf32_kernel<D, Run, Win, kMulti>;
  else return split_run_kernel<D, Run, Win, kMulti>;
}

// Launches both kernels over `rows` rows of the cache (slots or batch rows)
// with n_split = ceil(W / block_keys) blocks each; block_keys a multiple of
// kRunKeys; partial f32 scratch of n_split * rows * H * Lq * (D + 2) floats.
// q and out are bf16, or f32 for an fp32 Run (Run::kF32).
template <int D, class Run, class Win, bool kMulti>
cudaError_t launch_split_runs(const void* q, const void* a, const void* b, const Win& win,
                              void* out, void* partial, int rows, int H, int Lq,
                              const long long* st, float scale, int n_split, int block_keys,
                              cudaStream_t stream) {
  constexpr int kStages = kMulti ? 2 : 1;
  constexpr int kTileStages = Run::kRawBytes > 0 ? 1 : kStages;
  using T = typename std::conditional<Run::kF32, float, __nv_bfloat16>::type;
  const auto kernel = split_kernel<D, Run, Win, kMulti>();
  // bf16: int4 35-51 KB, dense 27-62 KB a block; f32: int4 9-37 KB, dense 26-47 KB (one stage)
  size_t bytes = kStages * Run::kRawBytes;
  if constexpr (Run::kF32)
    bytes += 2 * sizeof(float) * (size_t)Lq * (Run::kQStride + kF32PStride);
  else
    bytes += kTileStages * 2 * sizeof(__nv_bfloat16) * kRunKeys * (D + 8) + sizeof(float) * (size_t)Lq * kPStride +
             sizeof(__nv_bfloat16) * (size_t)(Lq + 1) * (D + 8);
  if (bytes > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
    if (err != cudaSuccess) return err;
  }
  kernel<<<dim3(n_split, H, rows), kRunThreads, bytes, stream>>>(
      static_cast<const T*>(q), a, b, win, static_cast<float*>(partial), H, Lq, st[0],
      st[1], st[2], scale, block_keys);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  run_combine_kernel<D, Run, Win, T><<<dim3(H, rows), 32 * Lq, 0, stream>>>(
      static_cast<const float*>(partial), a, b, win, static_cast<T*>(out), H, Lq, st[3],
      st[4], st[5], n_split, block_keys);
  return cudaGetLastError();
}

template <int D, class Run, class Win>
cudaError_t launch_split_runs(const void* q, const void* a, const void* b, const Win& win,
                              void* out, void* partial, int rows, int H, int Lq,
                              const long long* st, float scale, int n_split, int block_keys,
                              cudaStream_t stream) {
  const int W = win.width();
  if (Lq < 1 || Lq > kRunMaxRows || win.KV < 1 || H % win.KV || W < 1 || win.row0 < 0 || block_keys < kRunKeys ||
      block_keys % kRunKeys || n_split != (W + block_keys - 1) / block_keys || partial == nullptr)
    return cudaErrorInvalidValue;
  return block_keys == kRunKeys
             ? launch_split_runs<D, Run, Win, false>(q, a, b, win, out, partial, rows, H, Lq, st, scale, n_split,
                                                     block_keys, stream)
             : launch_split_runs<D, Run, Win, true>(q, a, b, win, out, partial, rows, H, Lq, st, scale, n_split,
                                                    block_keys, stream);
}

}  // namespace
