// The fp32 flash body of K2 (attention.cu, the dense f32 cache) and K5
// (quant_kv_attention.cu, the int4 cache of an fp32 model): 3xTF32 products
// on the tensor cores, the bf16 body's tiling (attention.cu's header says
// why and how).  A tile of keys and values reaches the f32 K and V tiles
// through a loader (the seam, as flash_mma.cuh's Tiles): DenseF32Tiles
// copies f32 rows; K5's Int4F32Tiles copies the int4 raw tile into a
// two-stage raw ring and dequantizes it once per block into single-buffered
// f32 tiles (q * s + b in f32, the plain fp32 path's bits).
#pragma once

#include "flash_mma.cuh"

namespace {

constexpr int kF32BQ = 64;  // K2 in fp32: query rows per block, four warps of 16
constexpr int kF32BK = 64;  // keys per tile
constexpr int kF32Threads = 2 * kF32BQ;

// The loader seam of the fp32 body: how tile t's keys and values reach the
// f32 K tile ([kF32BK][D + 8], a ring of kKStages) and V tile ([kF32BK][D +
// 4], one).  A loader has kKStages, kRawBytes (a stage of its raw ring, 0:
// none) and three hooks, each called by every thread of the block:
// * issue_k(kd, raw, a, b, key0, j0, Lk) starts the copy of keys [j0, j0 +
//   kF32BK) (clamped to Lk - 1) into the K stage kd or the raw stage raw;
// * issue_v(vs, a, b, key0, j0, Lk) starts the copy of their values into vs
//   (nothing where issue_k's raw stage holds them);
// * convert(kd, vs, raw), after the K copy has landed and a barrier, fills
//   kd and vs from the raw stage (the kernel adds a barrier after it when
//   there is a raw ring).
// DenseF32Tiles (K2): a = k, b = v, f32 (B, KV, Lk, D) contiguous.
template <int D>
struct DenseF32Tiles {
  static constexpr int kKStages = 2;
  static constexpr int kRawBytes = 0;
  static constexpr int kChunks = D / 4;  // 16-byte chunks per row
  static __device__ __forceinline__ void issue_k(float* kd, unsigned char*, const void* __restrict__ a,
                                                 const void* __restrict__, size_t key0, int j0, int Lk) {
    const float* k = static_cast<const float*>(a) + key0 * D;
    for (int idx = threadIdx.x; idx < kF32BK * kChunks; idx += kF32Threads) {
      const int r = idx / kChunks, c = idx % kChunks;
      cp_async16(kd + r * (D + 8) + c * 4, k + (size_t)min(j0 + r, Lk - 1) * D + c * 4);
    }
  }
  static __device__ __forceinline__ void issue_v(float* vs, const void* __restrict__, const void* __restrict__ b,
                                                 size_t key0, int j0, int Lk) {
    const float* v = static_cast<const float*>(b) + key0 * D;
    for (int idx = threadIdx.x; idx < kF32BK * kChunks; idx += kF32Threads) {
      const int r = idx / kChunks, c = idx % kChunks;
      cp_async16(vs + r * (D + 4) + c * 4, v + (size_t)min(j0 + r, Lk - 1) * D + c * 4);
    }
  }
  static __device__ __forceinline__ void convert(float*, float*, const unsigned char*) {}
};

// fp32 K2's shared memory: a ring of L::kKStages f32 K tiles, one V tile,
// the block's q * scale rows and L's raw ring.  K and Q rows are padded to D
// + 8 floats, V rows to D + 4: the 8-byte fragment loads below then fall in
// distinct banks in each half-warp.  105,472 bytes a block at D = 96 for
// K2: two blocks an SM.
template <int D, class L>
constexpr size_t kF32SmemBytes =
    sizeof(float) * ((L::kKStages * kF32BK + kF32BQ) * (D + 8) + kF32BK * (D + 4)) + 2 * L::kRawBytes;

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
template <int D, class L>
__global__ void __launch_bounds__(kF32Threads)
    flash_tf32_kernel(const float* __restrict__ q, const void* __restrict__ kv_a,
                      const void* __restrict__ kv_b, const uint8_t* __restrict__ valid,
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
  extern __shared__ __align__(16) unsigned char smem_raw[];
  constexpr int kKStages = L::kKStages;
  float* ks = reinterpret_cast<float*>(smem_raw);  // [kKStages][BK][KS]
  float* qs = ks + kKStages * BK * KS;             // [BQ][KS]
  float* vs = qs + BQ * KS;                        // [BK][VS]
  unsigned char* raw = reinterpret_cast<unsigned char*>(vs + BK * VS);  // [2][L::kRawBytes]
  __shared__ unsigned vmask[2][BK / 32];           // per stage: valid bits of each 32 keys

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int i0 = (gridDim.z - 1 - blockIdx.z) * BQ;
  const int horizon = q_pos0 + min(Lq, i0 + BQ) - 1;
  const int n_tiles = (Lk + BK - 1) / BK;
  const size_t key0 = ((size_t)b * KV + h / (H / KV)) * (size_t)Lk;
  const uint8_t* vrow = valid + (size_t)b * Lk;

  // Copies of tile t (a key past Lk is copied from key Lk - 1 and masked).
  // Thread tid < BK holds the valid byte of key tid of the last K tile
  // issued.
  unsigned vbyte = 0;
  auto kstage = [&](int t) { return ks + (t & (kKStages - 1)) * BK * KS; };
  auto rstage = [&](int t) { return raw + (t & 1) * L::kRawBytes; };
  auto issue_k = [&](int t) {
    const int j0 = t * BK;
    L::issue_k(kstage(t), rstage(t), kv_a, kv_b, key0, j0, Lk);
    if (tid < BK) vbyte = (j0 + tid < Lk) & (vrow[min(j0 + tid, Lk - 1)] != 0);
  };
  auto issue_v = [&](int t) { L::issue_v(vs, kv_a, kv_b, key0, t * BK, Lk); };
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
    L::convert(kstage(t), vs, rstage(t));
    if constexpr (L::kRawBytes > 0) __syncthreads();

    // S = Q K^T: per warp 16 rows x BK keys; K's B fragment (key 8n + gid,
    // dims 8 kk + 2 tig and + 1) and each row of Q's A fragment are one
    // 8-byte load.  hi * hi sums in s, the lo terms in slo.
    float s[NK][4], slo[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[n][e] = slo[n][e] = 0.f;
    const float* kt = kstage(t) + gid * KS + 2 * tig;
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

template <int D, class L>
cudaError_t launch_flash_f32(const void* q, const void* k, const void* v, const void* valid,
                             void* out, int B, int H, int KV, int Lq, int Lk, const long long* st,
                             int q_pos0, float scale, cudaStream_t stream) {
  if (Lq < 1 || Lk < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  constexpr size_t bytes = kF32SmemBytes<D, L>;
  cudaError_t err = cudaFuncSetAttribute(flash_tf32_kernel<D, L>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Lq + kF32BQ - 1) / kF32BQ);
  flash_tf32_kernel<D, L><<<grid, kF32Threads, bytes, stream>>>(
      static_cast<const float*>(q), k, v,
      static_cast<const uint8_t*>(valid), static_cast<float*>(out), H, KV, Lq, Lk, st[0], st[1],
      st[2], st[3], st[4], st[5], q_pos0, scale);
  return cudaGetLastError();
}

}  // namespace
