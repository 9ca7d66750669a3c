// The tensor-core flash-attention body of K2 (attention.cu, the dense
// cache) and K5 (quant_kv_attention.cu, the int4 cache): a tile of keys and
// values reaches the bf16 K and V tiles in shared memory through a `Tiles`
// loader (the seam), and everything after that point — the products, the
// mask, the softmax, the output — is shared.
//
// What bounds it on the H100: prefill attention is bound by operations, 4 *
// Lq * Lk * D per head (halved by causality), so both products run on the
// tensor cores as bf16 mma.sync.m16n8k16 with f32 accumulation:
// * a block owns 64 query rows of one (head, batch), four warps of 16 rows;
//   the Q tile (q * scale rounded to bf16, the rule of attention.cuh) is
//   staged once and held as A fragments in registers (6 k-steps of 16 at
//   D = 96);
// * keys come in tiles of 64 through a two-stage ring filled by 16-byte
//   cp.async: the next tile's copy is in flight while the tensor cores work
//   on this one.  DenseTiles copies K and V as bf16 straight into a
//   two-stage ring of K and V tiles; a loader of another layout (Int4Tiles)
//   copies its raw tile into a two-stage raw ring and converts it, after
//   the copy lands, into single-buffered K and V tiles.  Rows are padded to
//   D + 8 elements (208 B), so the eight 16-byte rows an ldmatrix reads fall
//   in distinct banks;
// * S = Q K^T comes from ldmatrix on K's rows; the online softmax runs per
//   row in f32 registers, one max and one rescale per key tile (the four
//   threads of a quad share a row), on visible scores times log2(e) so that
//   each weight is one exp2 (a masked score stays NEG_INF, never scaled, so
//   it cannot overflow to -inf); P is rounded to bf16 and reused from
//   registers as the A operand of O += P V (the JAX kernel rounds p to v's
//   type there too: phi_3_vision_mlx_tpu/ops/kernels/flash_attention.py:86),
//   with V's B fragments from ldmatrix.trans; the row sums stay f32;
// * the ragged Lk edge and the valid bits are masked in the scores, never
//   around the copies: a key past Lk is copied from the clamped key Lk - 1
//   and scores -inf; the tile's 64 valid bytes are read one tile ahead and
//   published as a 64-bit ballot;
// * tiles past the causal horizon of the whole query tile are skipped
//   (exact) unless a row of the tile has seen no visible key yet (a left-pad
//   row), which walks every tile to the uniform average of all Lk values.
// Why 64-row tiles and no persistent blocks: at lq = 1024, 16 tiles x 32
// heads = 512 blocks of 128 threads, with at most 168 registers a thread (3
// blocks per SM: the launch bound, set by the registers; K2's 65 KB and
// K5's 54 KB of shared memory would allow 3 and 4), fill the 132 SMs; the
// blocks are launched heaviest first (the query tile with the longest
// causal range has the lowest block index), so the short tiles fill the
// tail.  A 128-row tile would halve that count.
#pragma once

#include "attention.cuh"
#include "mma.cuh"

namespace {

constexpr int kMmaBQ = 64;        // query rows per block: 4 warps x 16 rows
constexpr int kMmaBK = 64;        // keys per tile
constexpr int kMmaThreads = 128;
constexpr float kLog2e = 1.4426950408889634f;  // scores in log2 units: exp2 is one MUFU op

// The seam: how a tile of kMmaBK keys reaches the K and V tiles
// ([kMmaBK][kStride] bf16 each) that the products read.  A loader has
// kStride and kRawBytes, the bytes of one stage of its raw ring (0: no raw
// ring, the copy lands in the K and V tiles themselves), and two hooks, each
// called by every thread of the block:
// * issue(ks, vs, raw, a, b, key0, j0, Lk) starts the copy of keys [j0, j0 +
//   kMmaBK) of the (batch, kv head) whose keys start at `key0` into the
//   stage's K and V tiles, or into its raw stage; the kernel commits and
//   waits;
// * convert(ks, vs, raw), after the copy has landed and a barrier, fills
//   the K and V tiles from the raw stage; the kernel adds a barrier after it
//   when there is a raw ring.
// With a raw ring the K and V tiles are single-buffered (the raw ring keeps
// the next copy in flight); without one they are the two-stage ring.
template <class Tiles>
constexpr int kTileStages = Tiles::kRawBytes > 0 ? 1 : 2;

// DenseTiles: a = k, b = v, bf16 (B, KV, Lk, D) contiguous.
template <int D>
struct DenseTiles {
  static constexpr int kStride = D + 8;
  static constexpr int kRawBytes = 0;
  static __device__ __forceinline__ void issue(__nv_bfloat16* ks, __nv_bfloat16* vs,
                                               unsigned char*, const void* __restrict__ a,
                                               const void* __restrict__ b, size_t key0, int j0,
                                               int Lk) {
    constexpr int kChunks = D / 8;  // 16-byte chunks per row
    const __nv_bfloat16* k = static_cast<const __nv_bfloat16*>(a) + key0 * D;
    const __nv_bfloat16* v = static_cast<const __nv_bfloat16*>(b) + key0 * D;
    for (int idx = threadIdx.x; idx < kMmaBK * kChunks; idx += kMmaThreads) {
      const int r = idx / kChunks, c = idx % kChunks;
      const size_t src = (size_t)min(j0 + r, Lk - 1) * D + c * 8;
      cp_async16(ks + r * kStride + c * 8, k + src);
      cp_async16(vs + r * kStride + c * 8, v + src);
    }
  }
  static __device__ __forceinline__ void convert(__nv_bfloat16*, __nv_bfloat16*,
                                                 const unsigned char*) {}
};

// The int4 cache's raw tile (K5's Int4Tiles, K4's and K7's Int4Run): kMmaBK rows of D
// payload bytes (byte d = k_q[d] | v_q[d] << 4), then kMmaBK rows of 4G bf16
// scales (k scale, k bias, v scale, v bias for each group of kGroup values).
template <int D>
constexpr int kInt4TileBytes = kMmaBK * (D + 8 * (D / kGroup));

// Fills the bf16 tiles ks and vs ([kMmaBK][D + 8] each) with the raw
// tile's keys and values, as the plain path's bf16 bits (attention.cuh:
// dequant_fma), or as E2/E3's MODE has them (attention.cuh: tile_value).
// Called by the whole block; each thread takes 16 values of a key at a
// time: one 16-byte payload chunk, its group's k and v scale and bias, two
// 16-byte stores to each tile.
template <int D, int MODE = kFp32>
__device__ __forceinline__ void dequantize_int4_tile(__nv_bfloat16* __restrict__ ks,
                                                     __nv_bfloat16* __restrict__ vs,
                                                     const unsigned char* __restrict__ raw) {
  constexpr int G = D / kGroup, kChunks = D / 16;
  static_assert(D % 16 == 0 && kInt4TileBytes<D> % 16 == 0, "16-byte chunks and raw stages");
  const __nv_bfloat16* rs = reinterpret_cast<const __nv_bfloat16*>(raw + kMmaBK * D);
  for (int idx = threadIdx.x; idx < kMmaBK * kChunks; idx += kMmaThreads) {
    const int r = idx / kChunks, c = idx % kChunks, g = c * 16 / kGroup;
    const uint4 w = *reinterpret_cast<const uint4*>(raw + r * D + c * 16);
    const __nv_bfloat16* sr = rs + r * 4 * G;
    const float k_s = bf(sr[g]), k_b = bf(sr[G + g]), v_s = bf(sr[2 * G + g]), v_b = bf(sr[3 * G + g]);
    const unsigned words[4] = {w.x, w.y, w.z, w.w};
    unsigned kp[8], vp[8];  // 16 values each, two to a register
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const unsigned kw = words[i] & 0x0F0F0F0Fu, vw = (words[i] >> 4) & 0x0F0F0F0Fu;  // four levels each
#pragma unroll
      for (int e = 0; e < 2; ++e) {  // bytes 2e and 2e + 1
        kp[2 * i + e] = pack_bf16(tile_value<MODE>(byte_level(kw, 2 * e), k_s, k_b),
                                  tile_value<MODE>(byte_level(kw, 2 * e + 1), k_s, k_b));
        vp[2 * i + e] = pack_bf16(tile_value<MODE>(byte_level(vw, 2 * e), v_s, v_b),
                                  tile_value<MODE>(byte_level(vw, 2 * e + 1), v_s, v_b));
      }
    }
    uint4* kd = reinterpret_cast<uint4*>(ks + r * (D + 8) + c * 16);
    uint4* vd = reinterpret_cast<uint4*>(vs + r * (D + 8) + c * 16);
    kd[0] = make_uint4(kp[0], kp[1], kp[2], kp[3]);
    kd[1] = make_uint4(kp[4], kp[5], kp[6], kp[7]);
    vd[0] = make_uint4(vp[0], vp[1], vp[2], vp[3]);
    vd[1] = make_uint4(vp[4], vp[5], vp[6], vp[7]);
  }
}

// Grid (H, B, ceil(Lq / kMmaBQ)), kMmaThreads threads; query tile
// gridDim.z - 1 - blockIdx.z, so the longest causal ranges start first.
template <int D, class Tiles>
__global__ void __launch_bounds__(kMmaThreads, 3)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q, const void* __restrict__ kv_a,
                     const void* __restrict__ kv_b, const uint8_t* __restrict__ valid,
                     __nv_bfloat16* __restrict__ out, int H, int KV, int Lq, int Lk,
                     long long qsb, long long qsh, long long qsl, long long osb, long long osh,
                     long long osl, int q_pos0, float scale) {
  static_assert(D % 32 == 0, "D must be a multiple of 32 (k-steps in pairs, n-tiles in pairs)");
  constexpr int S = Tiles::kStride;
  constexpr int KD = D / 16;         // k-steps of Q K^T
  constexpr int ND = D / 8;          // n-tiles of P V
  constexpr int NK = kMmaBK / 8;     // n-tiles of S
  constexpr int kStages = kTileStages<Tiles>;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(smem_raw);  // [kMmaBQ][S]
  __nv_bfloat16* ks = qs + kMmaBQ * S;                             // [kStages][kMmaBK][S]
  __nv_bfloat16* vs = ks + kStages * kMmaBK * S;                   // [kStages][kMmaBK][S]
  unsigned char* raw = reinterpret_cast<unsigned char*>(vs + kStages * kMmaBK * S);  // [2][kRawBytes]
  __shared__ unsigned vmask[2][2];  // per stage: valid bits of keys 0-31, 32-63

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int h = blockIdx.x, b = blockIdx.y;
  const int kvh = h / (H / KV);
  const int i0 = (gridDim.z - 1 - blockIdx.z) * kMmaBQ;
  const int horizon = q_pos0 + min(Lq, i0 + kMmaBQ) - 1;
  const int n_tiles = (Lk + kMmaBK - 1) / kMmaBK;
  const size_t key0 = ((size_t)b * KV + kvh) * (size_t)Lk;
  const uint8_t* vrow = valid + (size_t)b * Lk;

  // Thread tid < kMmaBK holds the valid byte of key tid of the last tile
  // issued, read with the tile's copy and turned into bits when it is used.
  unsigned vbyte = 0;
  auto tile = [&](int t) { return (t & (kStages - 1)) * kMmaBK * S; };  // tile t's K/V stage
  auto issue = [&](int t) {
    const int j0 = t * kMmaBK;
    Tiles::issue(ks + tile(t), vs + tile(t), raw + (t & 1) * Tiles::kRawBytes, kv_a, kv_b, key0,
                 j0, Lk);
    if (tid < kMmaBK) vbyte = (j0 + tid < Lk) & (vrow[min(j0 + tid, Lk - 1)] != 0);
  };
  issue(0);
  cp_async_commit();

  for (int idx = tid; idx < kMmaBQ * D; idx += kMmaThreads) {
    const int r = idx / D, c = idx % D, qi = i0 + r;
    qs[r * S + c] = __float2bfloat16(qi < Lq ? bf(q[b * qsb + h * qsh + qi * qsl + c]) * scale : 0.f);
  }
  __syncthreads();
  unsigned qa[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk)
    ldsm_x4(qa[kk], qs + (warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + kk * 16 + (lane >> 4) * 8);

  // This thread's rows: r0 and r0 + 8 of the block's tile.
  const int r0 = i0 + warp * 16 + gid;
  const int qpos[2] = {q_pos0 + r0, q_pos0 + r0 + 8};
  const bool row_ok[2] = {r0 < Lq, r0 + 8 < Lq};
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
  float o[ND][4];
#pragma unroll
  for (int dn = 0; dn < ND; ++dn) o[dn][0] = o[dn][1] = o[dn][2] = o[dn][3] = 0.f;

  for (int t = 0;;) {
    const int st = t & 1, j0 = t * kMmaBK;
    if (warp < kMmaBK / 32) {
      const unsigned bits = __ballot_sync(0xffffffffu, vbyte);
      if (lane == 0) vmask[st][warp] = bits;
    }
    const bool next = t + 1 < n_tiles && (t + 1) * kMmaBK <= horizon;
    if (next) issue(t + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    Tiles::convert(ks + tile(t), vs + tile(t), raw + st * Tiles::kRawBytes);
    if constexpr (Tiles::kRawBytes > 0) __syncthreads();

    // S = Q K^T: per warp 16 rows x 64 keys.
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    const __nv_bfloat16* kt = ks + tile(t);
#pragma unroll
    for (int kk = 0; kk < KD; kk += 2) {
#pragma unroll
      for (int n = 0; n < NK; ++n) {
        unsigned kb[4];
        ldsm_x4(kb, kt + (n * 8 + (lane & 7)) * S + kk * 16 + (lane >> 3) * 8);
        mma_bf16(s[n], qa[kk], kb[0], kb[1]);
        mma_bf16(s[n], qa[kk + 1], kb[2], kb[3]);
      }
    }

    // Mask, then one max and one rescale per row for the tile.
    const unsigned w0 = vmask[st][0], w1 = vmask[st][1];
    float mt[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < NK; ++n) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int c = n * 8 + tig * 2 + (e & 1), j = j0 + c, r = e >> 1;
        const bool key_valid = ((c < 32 ? w0 : w1) >> (c & 31)) & 1u;
        s[n][e] = j >= Lk ? -INFINITY : (key_valid && j <= qpos[r]) ? s[n][e] * kLog2e : kNegInf;
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
#pragma unroll
    for (int dn = 0; dn < ND; ++dn) {
      o[dn][0] *= alpha[0];
      o[dn][1] *= alpha[0];
      o[dn][2] *= alpha[1];
      o[dn][3] *= alpha[1];
    }

    // O += P V, P from registers (S's accumulator layout is the A layout).
    const __nv_bfloat16* vt = vs + tile(t);
#pragma unroll
    for (int kj = 0; kj < kMmaBK / 16; ++kj) {
      const unsigned pa[4] = {pack_bf16(s[2 * kj][0], s[2 * kj][1]),
                              pack_bf16(s[2 * kj][2], s[2 * kj][3]),
                              pack_bf16(s[2 * kj + 1][0], s[2 * kj + 1][1]),
                              pack_bf16(s[2 * kj + 1][2], s[2 * kj + 1][3])};
#pragma unroll
      for (int dn = 0; dn < ND; dn += 2) {
        unsigned vb[4];
        ldsm_x4_trans(vb, vt + (kj * 16 + (lane & 7) + ((lane >> 3) & 1) * 8) * S + dn * 8 +
                              (lane >> 4) * 8);
        mma_bf16(o[dn], pa, vb[0], vb[1]);
        mma_bf16(o[dn + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();  // the stage is free for the copy after next

    if (++t >= n_tiles) break;
    if (!next) {
      // Past the horizon: needed only while a row has seen no visible key.
      const bool unseen = (row_ok[0] && m[0] == kNegInf) || (row_ok[1] && m[1] == kNegInf);
      if (!__syncthreads_or(unseen)) break;
      issue(t);
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
    __nv_bfloat16* orow = out + b * osb + h * osh + (long long)(r0 + 8 * r) * osl + tig * 2;
#pragma unroll
    for (int dn = 0; dn < ND; ++dn)
      *reinterpret_cast<__nv_bfloat162*>(orow + dn * 8) =
          __floats2bfloat162_rn(o[dn][2 * r] / l[r], o[dn][2 * r + 1] / l[r]);
  }
}

template <int D, class Tiles>
cudaError_t launch_flash_mma(const void* q, const void* kv_a, const void* kv_b, const void* valid,
                             void* out, int B, int H, int KV, int Lq, int Lk, const long long* st,
                             int q_pos0, float scale, cudaStream_t stream) {
  if (Lq < 1 || Lk < 1 || KV < 1 || H % KV) return cudaErrorInvalidValue;
  const size_t bytes = sizeof(__nv_bfloat16) * (kMmaBQ + 2 * kTileStages<Tiles> * kMmaBK) *
                           Tiles::kStride + 2 * Tiles::kRawBytes;
  cudaError_t err = cudaFuncSetAttribute(flash_mma_kernel<D, Tiles>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return err;
  dim3 grid(H, B, (Lq + kMmaBQ - 1) / kMmaBQ);
  flash_mma_kernel<D, Tiles><<<grid, kMmaThreads, bytes, stream>>>(
      static_cast<const __nv_bfloat16*>(q), kv_a, kv_b, static_cast<const uint8_t*>(valid),
      static_cast<__nv_bfloat16*>(out), H, KV, Lq, Lk, st[0], st[1], st[2], st[3], st[4], st[5],
      q_pos0, scale);
  return cudaGetLastError();
}

}  // namespace
