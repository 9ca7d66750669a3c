// Shared by the quantized matmuls (quant_matmul.cu: K1, K8, K9;
// w4a8_matmul.cu: E1): the quantization group, the threads per block, the
// widening of packed bf16 scales, and the second pass of the K split, which
// adds the splits' f32 partial sums in a fixed order (deterministic) and
// casts to the output type.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kGroup = 64;     // quantization group along K
constexpr int kThreads = 128;  // threads per block of every quantized matmul

// The bf16 in the low / high half of u, widened to f32.
__device__ __forceinline__ float lo_f32(unsigned u) { return __uint_as_float(u << 16); }
__device__ __forceinline__ float hi_f32(unsigned u) { return __uint_as_float(u & 0xffff0000u); }

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

// partial (splits, M, N) f32 -> out (M, N), bf16 or f32.  Returns
// cudaGetLastError().
inline int sum_splits(const float* partial, void* out, int M, int N, int splits, int out_f32,
                      cudaStream_t stream) {
  const size_t MN = (size_t)M * N;
  const unsigned blocks = (unsigned)((MN + 255) / 256);
  if (out_f32)
    sum_splits_kernel<float><<<blocks, 256, 0, stream>>>(partial, static_cast<float*>(out), splits, MN);
  else
    sum_splits_kernel<__nv_bfloat16>
        <<<blocks, 256, 0, stream>>>(partial, static_cast<__nv_bfloat16*>(out), splits, MN);
  return (int)cudaGetLastError();
}

}  // namespace
