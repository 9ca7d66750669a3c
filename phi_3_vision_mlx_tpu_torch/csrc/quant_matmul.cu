// Kernels K1 (W4A16) and K8 (W8A16): y[M, N] = x[M, K] @ W[K, N], for M <= 256.
//
// K1 replaces the TPU kernels phi_3_vision_mlx_tpu/ops/kernels/quant_matmul.py:
// quant_matmul_tiled (:489) and quant_matmul_tiled_stacked (:541), body
// _tiled_kernel (:439).  K8 replaces quant_matmul_interleaved (:312), body
// _kernel (:285).  The stacked variants are zero-copy w[layer] views in
// PyTorch, so one kernel of each width serves both.
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

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 64;     // quantization group along K
constexpr int kThreads = 128;  // one output column per thread

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

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

template <typename T>
__global__ void sum_splits_kernel(const float* __restrict__ partial, T* __restrict__ out,
                                  int splits, size_t MN) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= MN) return;
  float a = 0.f;
  for (int s = 0; s < splits; ++s) a += partial[(size_t)s * MN + i];
  out[i] = from_float<T>(a);
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
  const size_t MN = (size_t)M * N;
  const unsigned blocks = (unsigned)((MN + 255) / 256);
  if (out_f32)
    sum_splits_kernel<float><<<blocks, 256, 0, stream>>>(pp, static_cast<float*>(out), splits, MN);
  else
    sum_splits_kernel<__nv_bfloat16>
        <<<blocks, 256, 0, stream>>>(pp, static_cast<__nv_bfloat16*>(out), splits, MN);
  return (int)cudaGetLastError();
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
