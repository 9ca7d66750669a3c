// Kernel K1: W4A16 matmul, y[M, N] = x[M, K] @ W[K, N], for M <= 256.
//
// Replaces the TPU kernels phi_3_vision_mlx_tpu/ops/kernels/quant_matmul.py:
// quant_matmul_tiled (:489) and quant_matmul_tiled_stacked (:541), body
// _tiled_kernel (:439).  The stacked variant is a zero-copy w[layer] view in
// PyTorch, so one kernel serves both.
//
// Math (the same as _tiled_kernel and ops/quant.py:quantized_matmul for bf16
// activations): W = bf16(s[k/64, n] * q[k, n] + b[k/64, n]) (affine) or
// bf16(s * (q - 8)) (symmetric), computed in f32 without FMA contraction and
// rounded once to bf16; products accumulate in f32.
//
// What bounds it on the H100: at decode (M = 1) every weight is used once, so
// the kernel is bound by weight bytes — 0.5 B per weight plus 4 B of bf16
// scale and bias per 64 weights, about 2.09 GB per Phi-3.5-mini token, which
// the 3.35 TB/s datasheet bandwidth turns into a 0.62 ms floor (a datasheet
// bound, not a measurement).
//
// Design: the payload is (K/8, N) int32, eight K-consecutive nibbles of one
// column per word, so a warp reads 32 consecutive words (128 B) of one row
// and each thread owns one output column.  The activation tile of one
// 64-wide group is staged in shared memory as f32 and broadcast to all
// threads.  M is tiled by BM rows (BM = 1, 2, 4 or 8) so the accumulators stay
// in registers at M = 256.  K is split across blockIdx.z so that decode
// fills the card's 132 SMs even at N = 3072; each split writes f32 partial
// sums, and a second kernel adds them in a fixed order (deterministic) and
// casts to the output type.  No tensor cores, TMA or wgmma yet: this is the
// simple, correct first version.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 64;     // quantization group along K
constexpr int kThreads = 128;  // one output column per thread

template <int BM>
__global__ void w4a16_partial_kernel(const __nv_bfloat16* __restrict__ x,
                                     const int32_t* __restrict__ qw,
                                     const __nv_bfloat16* __restrict__ scales,
                                     const __nv_bfloat16* __restrict__ biases,
                                     float* __restrict__ partial, int M, int K, int N,
                                     int groups_per_split) {
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
    for (int w = 0; w < kGroup / 8; ++w) {
      const uint32_t word = static_cast<uint32_t>(qw[((size_t)g * (kGroup / 8) + w) * N + n]);
      float wv[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int q = (word >> (4 * j)) & 15;
        const float f = biases ? __fadd_rn(__fmul_rn(s, (float)q), b) : __fmul_rn(s, (float)(q - 8));
        wv[j] = __bfloat162float(__float2bfloat16(f));
      }
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        const float4 xa = *reinterpret_cast<const float4*>(&xs[r][w * 8]);
        const float4 xb = *reinterpret_cast<const float4*>(&xs[r][w * 8 + 4]);
        float a = acc[r];
        a = fmaf(xa.x, wv[0], a);
        a = fmaf(xa.y, wv[1], a);
        a = fmaf(xa.z, wv[2], a);
        a = fmaf(xa.w, wv[3], a);
        a = fmaf(xb.x, wv[4], a);
        a = fmaf(xb.y, wv[5], a);
        a = fmaf(xb.z, wv[6], a);
        a = fmaf(xb.w, wv[7], a);
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

template <int BM>
void launch_partial(const __nv_bfloat16* x, const int32_t* qw, const __nv_bfloat16* s,
                    const __nv_bfloat16* b, float* partial, int M, int K, int N, int splits,
                    int groups_per_split, cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads, (M + BM - 1) / BM, splits);
  w4a16_partial_kernel<BM><<<grid, kThreads, 0, stream>>>(x, qw, s, b, partial, M, K, N,
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
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* qp = static_cast<const int32_t*>(qw);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* bp = static_cast<const __nv_bfloat16*>(biases);
  auto* pp = static_cast<float*>(partial);
  if (M <= 1)
    launch_partial<1>(xp, qp, sp, bp, pp, M, K, N, splits, groups_per_split, stream);
  else if (M <= 2)
    launch_partial<2>(xp, qp, sp, bp, pp, M, K, N, splits, groups_per_split, stream);
  else if (M <= 4)
    launch_partial<4>(xp, qp, sp, bp, pp, M, K, N, splits, groups_per_split, stream);
  else
    launch_partial<8>(xp, qp, sp, bp, pp, M, K, N, splits, groups_per_split, stream);
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
