// Kernels K1 (W4A16), K8 (W8A16) and K9 (W4A16, flat packed layout):
// y[M, N] = x[M, K] @ W[K, N], for M <= 256.
//
// K1 replaces the TPU kernels phi_3_vision_mlx_tpu/ops/kernels/quant_matmul.py:
// quant_matmul_tiled (:489) and quant_matmul_tiled_stacked (:541), body
// _tiled_kernel (:439).  K8 replaces quant_matmul_interleaved (:312), body
// _kernel (:285).  K9 replaces quant_matmul_packed (:139), body _packed_kernel
// (:103), and quant_matmul_packed_stacked (:219), body _packed_kernel_stacked
// (:179).  The stacked variants are zero-copy w[layer] views in PyTorch, so
// one kernel of each layout serves both.
//
// K9 reads the JAX package's flat packed payload in place and computes K1's
// function (W rounded once to bf16, f32 accumulation; the XLA path
// ops/linear.py:124-131), with K1's K split and sum_splits_kernel.  It moves
// the same bytes as K1 (0.5 B per weight, 4 B of scale and bias per 64), so
// its bound is K1's: 0.0048 ms at qkv M = 1, 15.9 MB at 3.35 TB/s
// (datasheet).  A lane loads four packed bytes (eight weights of two column
// runs) per row, so a warp reads 128 B of a row, as K1 does.
//
// Math (the same as the TPU kernels and ops/quant.py:quantized_matmul for
// bf16 activations): W = bf16(s[k/64, n] * q[k, n] + b[k/64, n]) (affine) or
// bf16(s * (q - 8)) (symmetric, 4-bit only), computed in f32 without FMA
// contraction and rounded once to bf16; products accumulate in f32.  The
// 8-bit levels are unsigned, 0..255: the TPU kernel widens its int8 payload
// as signed, so levels >= 128 dequantize there as (q - 256) * s + b, which is
// not the function the XLA path (and this kernel) computes.
//
// What bounds it on the H100: at decode (M = 1) every weight is used once, so
// the kernel is bound by weight bytes — 0.5 B (K1) or 1 B (K8) per weight plus
// 4 B of bf16 scale and bias per 64 weights: about 2.09 GB (K1) or 3.96 GB
// (K8) per Phi-3.5-mini token, which the 3.35 TB/s datasheet bandwidth turns
// into a 0.62 ms or a 1.18 ms floor (datasheet bounds, not measurements).
//
// Design: the payload is (K * BITS / 32, N) int32, 32 / BITS K-consecutive
// values of one column per word (eight nibbles, or four bytes), so a warp
// reads 32 consecutive words (128 B) of one row and each thread owns one
// output column.  The activation tile of one 64-wide group is staged in shared
// memory as f32 and broadcast to all threads.  M is tiled by BM rows (BM = 1,
// 2, 4 or 8) so the accumulators stay in registers at M = 256.  K is split
// across blockIdx.z so that decode fills the card's 132 SMs even at N = 3072;
// each split writes f32 partial sums, and a second kernel adds them in a
// fixed order (deterministic) and casts to the output type.  The ragged N
// edge (lm_head's 32064 columns) is masked per thread, with no padding.  No
// tensor cores, TMA or wgmma yet: this is the simple, correct first version.

#include "quant_matmul.cuh"

namespace {

template <int BITS, int BM>
__global__ void wq_partial_kernel(const __nv_bfloat16* __restrict__ x,
                                  const int32_t* __restrict__ qw,
                                  const __nv_bfloat16* __restrict__ scales,
                                  const __nv_bfloat16* __restrict__ biases,
                                  float* __restrict__ partial, int M, int K, int N,
                                  int groups_per_split) {
  constexpr int kPer = 32 / BITS;               // values per int32 word
  constexpr int kWords = kGroup / kPer;         // words per group and column
  constexpr uint32_t kMask = (1u << BITS) - 1;  // one value's bits
  constexpr int kMid = 1 << (BITS - 1);         // symmetric zero point
  __shared__ __align__(16) float xs[BM][kGroup];
  const int n = blockIdx.x * kThreads + threadIdx.x;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int G = K / kGroup;
  const int g0 = split * groups_per_split;
  const int g1 = min(G, g0 + groups_per_split);
  const bool col_ok = n < N;

  float acc[BM];
#pragma unroll
  for (int r = 0; r < BM; ++r) acc[r] = 0.f;

  for (int g = g0; g < g1; ++g) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * kGroup; idx += kThreads) {
      const int r = idx / kGroup, c = idx % kGroup, m = m0 + r;
      xs[r][c] = m < M ? __bfloat162float(x[(size_t)m * K + (size_t)g * kGroup + c]) : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    const float s = __bfloat162float(scales[(size_t)g * N + n]);
    const float b = biases ? __bfloat162float(biases[(size_t)g * N + n]) : 0.f;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const uint32_t word = static_cast<uint32_t>(qw[((size_t)g * kWords + w) * N + n]);
      float wv[kPer];
#pragma unroll
      for (int j = 0; j < kPer; ++j) {
        const int q = (int)((word >> (BITS * j)) & kMask);
        const float f = biases ? __fadd_rn(__fmul_rn(s, (float)q), b) : __fmul_rn(s, (float)(q - kMid));
        wv[j] = __bfloat162float(__float2bfloat16(f));
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        float a = acc[r];
#pragma unroll
        for (int j4 = 0; j4 < kPer; j4 += 4) {
          const float4 xa = *reinterpret_cast<const float4*>(&xs[r][w * kPer + j4]);
          a = fmaf(xa.x, wv[j4], a);
          a = fmaf(xa.y, wv[j4 + 1], a);
          a = fmaf(xa.z, wv[j4 + 2], a);
          a = fmaf(xa.w, wv[j4 + 3], a);
        }
        acc[r] = a;
      }
    }
  }
  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m < M) partial[((size_t)split * M + m) * N + n] = acc[r];
  }
}

template <int BITS, int BM>
void launch_partial(const __nv_bfloat16* x, const int32_t* qw, const __nv_bfloat16* s,
                    const __nv_bfloat16* b, float* partial, int M, int K, int N, int splits,
                    int groups_per_split, cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads, (M + BM - 1) / BM, splits);
  wq_partial_kernel<BITS, BM><<<grid, kThreads, 0, stream>>>(x, qw, s, b, partial, M, K, N,
                                                             groups_per_split);
}

template <int BITS>
int wq_matmul(const void* x, const void* qw, const void* scales, const void* biases,
              void* partial, void* out, int M, int K, int N, int splits, int groups_per_split,
              int out_f32, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int32_t*>(qw);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* bp = static_cast<const __nv_bfloat16*>(biases);
  auto* pp = static_cast<float*>(partial);
  if (M <= 1)
    launch_partial<BITS, 1>(xp, qp, sp, bp, pp, M, K, N, splits, groups_per_split, stream);
  else if (M <= 2)
    launch_partial<BITS, 2>(xp, qp, sp, bp, pp, M, K, N, splits, groups_per_split, stream);
  else if (M <= 4)
    launch_partial<BITS, 4>(xp, qp, sp, bp, pp, M, K, N, splits, groups_per_split, stream);
  else
    launch_partial<BITS, 8>(xp, qp, sp, bp, pp, M, K, N, splits, groups_per_split, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits(pp, out, M, N, splits, out_f32, stream);
}

// bf16 e (0..3) of four packed in a uint2, widened to f32 (its bits are the
// f32's top half).
__device__ __forceinline__ float bf16_at(uint2 v, int e) {
  const unsigned w = e < 2 ? v.x : v.y;
  return __uint_as_float(e % 2 ? w & 0xffff0000u : w << 16);
}

// K9: the flat packed layout.  Lane l of block x owns the four byte columns
// jb = 4 (32 x + l) .. jb + 3 of the (K, N/2) payload, i.e. output columns
// c .. c + 3 (low nibbles, c = (jb / 256) * 512 + jb % 256) and c + 256 ..
// c + 259 (high nibbles), so every byte it loads is used whole and a warp
// reads 128 consecutive bytes of a row as 32 words (K1's pattern).  The
// block's four warps split each group's 64 rows (warp w: rows w, w + 4, ...)
// and add their sums through shared memory in warp order at the end, so the
// grid has as many threads as K1's for half as many loads per weight.  (One
// byte per thread made K9 3.4x slower than K1 on an H100, four bytes per
// thread with each thread walking all 64 rows 1.8-3.3x.)  Group g's 64 rows
// sit in block g / gk at rows (i * gk + g % gk), so row i of the group is
// read in place and multiplies x[g * 64 + i] in natural order (no activation
// permutation).  W is rounded as in K1.
template <int BM>
__global__ void packed_partial_kernel(const __nv_bfloat16* __restrict__ x,
                                      const uint8_t* __restrict__ qp,
                                      const __nv_bfloat16* __restrict__ scales,
                                      const __nv_bfloat16* __restrict__ biases,
                                      float* __restrict__ partial, int M, int K, int N,
                                      int block_k, int groups_per_split) {
  constexpr int kCols = 4;                // byte columns (one word) per lane
  constexpr int kWarps = kThreads / 32;   // warps that split a group's rows
  __shared__ __align__(16) float xs[BM][kGroup];
  __shared__ float red[kWarps - 1][BM][2 * kCols][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int NH = N / 2;
  const int jb = kCols * (blockIdx.x * 32 + lane);
  const int c_lo = (jb / 256) * 512 + jb % 256, c_hi = c_lo + 256;
  const int m0 = blockIdx.y * BM;
  const int split = blockIdx.z;
  const int G = K / kGroup, gk = block_k / kGroup;
  const int g0 = split * groups_per_split;
  const int g1 = min(G, g0 + groups_per_split);
  const bool col_ok = jb < NH;

  float lo[BM][kCols], hi[BM][kCols];
#pragma unroll
  for (int r = 0; r < BM; ++r)
#pragma unroll
    for (int e = 0; e < kCols; ++e) lo[r][e] = hi[r][e] = 0.f;

  for (int g = g0; g < g1; ++g) {
    __syncthreads();
    for (int idx = threadIdx.x; idx < BM * kGroup; idx += kThreads) {
      const int r = idx / kGroup, c = idx % kGroup, m = m0 + r;
      xs[r][c] = m < M ? __bfloat162float(x[(size_t)m * K + (size_t)g * kGroup + c]) : 0.f;
    }
    __syncthreads();
    if (!col_ok) continue;
    // Four bf16 scales (biases) of the low and of the high columns: 8 bytes each.
    const uint2 sl = *reinterpret_cast<const uint2*>(scales + (size_t)g * N + c_lo);
    const uint2 sh = *reinterpret_cast<const uint2*>(scales + (size_t)g * N + c_hi);
    const uint2 bl = *reinterpret_cast<const uint2*>(biases + (size_t)g * N + c_lo);
    const uint2 bh = *reinterpret_cast<const uint2*>(biases + (size_t)g * N + c_hi);
    float s_lo[kCols], s_hi[kCols], b_lo[kCols], b_hi[kCols];
#pragma unroll
    for (int e = 0; e < kCols; ++e) {
      s_lo[e] = bf16_at(sl, e);
      s_hi[e] = bf16_at(sh, e);
      b_lo[e] = bf16_at(bl, e);
      b_hi[e] = bf16_at(bh, e);
    }
    const uint32_t* row0 = reinterpret_cast<const uint32_t*>(
        qp + ((size_t)(g / gk) * block_k + g % gk) * NH + jb);
    const size_t stride = (size_t)gk * NH / 4;  // words between consecutive rows of a group
#pragma unroll
    for (int t = 0; t < kGroup / kWarps; ++t) {
      const int i = warp + kWarps * t;
      const uint32_t word = row0[i * stride];
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        const unsigned byte = (word >> (8 * e)) & 255u;
        const float wl = __bfloat162float(__float2bfloat16(__fadd_rn(__fmul_rn(s_lo[e], (float)(byte & 15u)), b_lo[e])));
        const float wh = __bfloat162float(__float2bfloat16(__fadd_rn(__fmul_rn(s_hi[e], (float)(byte >> 4)), b_hi[e])));
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          lo[r][e] = fmaf(xs[r][i], wl, lo[r][e]);
          hi[r][e] = fmaf(xs[r][i], wh, hi[r][e]);
        }
      }
    }
  }
  if (warp > 0) {
#pragma unroll
    for (int r = 0; r < BM; ++r)
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        red[warp - 1][r][e][lane] = lo[r][e];
        red[warp - 1][r][kCols + e][lane] = hi[r][e];
      }
  }
  __syncthreads();
  if (warp > 0 || !col_ok) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m >= M) continue;
#pragma unroll
    for (int w = 0; w < kWarps - 1; ++w)
#pragma unroll
      for (int e = 0; e < kCols; ++e) {
        lo[r][e] += red[w][r][e][lane];
        hi[r][e] += red[w][r][kCols + e][lane];
      }
    float* dst = partial + ((size_t)split * M + m) * N;
    *reinterpret_cast<float4*>(dst + c_lo) = make_float4(lo[r][0], lo[r][1], lo[r][2], lo[r][3]);
    *reinterpret_cast<float4*>(dst + c_hi) = make_float4(hi[r][0], hi[r][1], hi[r][2], hi[r][3]);
  }
}

template <int BM>
void launch_packed(const __nv_bfloat16* x, const uint8_t* qp, const __nv_bfloat16* s,
                   const __nv_bfloat16* b, float* partial, int M, int K, int N, int block_k,
                   int splits, int groups_per_split, cudaStream_t stream) {
  dim3 grid((N / 8 + 31) / 32, (M + BM - 1) / BM, splits);  // 32 words of a row per block
  packed_partial_kernel<BM><<<grid, kThreads, 0, stream>>>(x, qp, s, b, partial, M, K, N, block_k,
                                                           groups_per_split);
}

}  // namespace

// x (M, K) bf16; qw (K/8, N) int32; scales/biases (K/64, N) bf16 (biases may
// be null: symmetric mode); partial (splits, M, N) f32 scratch; out (M, N)
// bf16 or f32.  Returns cudaGetLastError().
extern "C" int k1_w4a16_matmul(const void* x, const void* qw, const void* scales,
                               const void* biases, void* partial, void* out, int M, int K,
                               int N, int splits, int groups_per_split, int out_f32,
                               void* stream_ptr) {
  return wq_matmul<4>(x, qw, scales, biases, partial, out, M, K, N, splits, groups_per_split,
                      out_f32, stream_ptr);
}

// As k1_w4a16_matmul with qw (K/4, N) int32 of unsigned 8-bit levels (byte j
// of word [r, n] holds q[4r + j, n]) and biases never null (affine only).
extern "C" int k8_w8a16_matmul(const void* x, const void* qw, const void* scales,
                               const void* biases, void* partial, void* out, int M, int K,
                               int N, int splits, int groups_per_split, int out_f32,
                               void* stream_ptr) {
  return wq_matmul<8>(x, qw, scales, biases, partial, out, M, K, N, splits, groups_per_split,
                      out_f32, stream_ptr);
}

// K9 (and K10, on a w[layer] view).  x (M, K) bf16; qp (K, N/2) uint8 in the
// flat packed layout (rows group-interleaved within blocks of block_k =
// min(512, K), byte j of each 256-byte run = column j | column j + 256 << 4 of
// its 512-column block); scales/biases (K/64, N) bf16, never null; partial,
// out as in k1_w4a16_matmul.  N must be a multiple of 512 and K of block_k;
// qp, scales, biases 8-byte aligned and partial 16-byte aligned.
extern "C" int k9_w4a16_packed_matmul(const void* x, const void* qp, const void* scales,
                                      const void* biases, void* partial, void* out, int M, int K,
                                      int N, int block_k, int splits, int groups_per_split,
                                      int out_f32, void* stream_ptr) {
  if (N % 512 || block_k % kGroup || K % block_k || biases == nullptr) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* q = static_cast<const uint8_t*>(qp);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* bp = static_cast<const __nv_bfloat16*>(biases);
  auto* pp = static_cast<float*>(partial);
  if (M <= 1)
    launch_packed<1>(xp, q, sp, bp, pp, M, K, N, block_k, splits, groups_per_split, stream);
  else if (M <= 2)
    launch_packed<2>(xp, q, sp, bp, pp, M, K, N, block_k, splits, groups_per_split, stream);
  else if (M <= 4)
    launch_packed<4>(xp, q, sp, bp, pp, M, K, N, block_k, splits, groups_per_split, stream);
  else
    launch_packed<8>(xp, q, sp, bp, pp, M, K, N, block_k, splits, groups_per_split, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits(pp, out, M, N, splits, out_f32, stream);
}
