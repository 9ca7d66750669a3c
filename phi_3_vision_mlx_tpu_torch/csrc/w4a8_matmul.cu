// Kernel E1 (W4A8): y[m, n] = sx[m] * sum_g s[g, n] * (x8[m, g] . (q[g, n] - 8))
// for int8 activations x8 (M, K) with one f32 scale sx per row, and the
// port's 4-bit symmetric layout (K1's: (K/8, N) int32 words, nibble j of word
// [r, n] = q[8r + j, n]; bf16 scales (K/64, N)).  Exact int32 sums inside
// each group of 64, f32 across groups; f32 output.
//
// Replaces the TPU experiment kernel experiments/w4a8_bench.py:w4a8_matmul
// (:87), body _w4a8_kernel (:42).  The activation prologue (per-row absmax,
// round, clip) is plain PyTorch in ops/kernels/w4a8.py, as the JAX package
// leaves it to XLA.  The TPU tiling of w4a8_layout is not copied: E1 reads
// K1's symmetric bytes, so the A/B against K1 moves the same bytes.
//
// What bounds it on the H100: at decode every weight is read once, so bytes
// (14.2 MB of payload and 0.9 MB of scales at K = 3072, N = 9216: 0.0045 ms
// at 3.35 TB/s, datasheet), as for K1.  The int8 tensor cores (twice the bf16
// rate) cannot help a step bound by bytes, and the per-(group, column) scale
// cuts the contraction into 64-deep pieces either way.
//
// Design (simple and correct first): K1's grid, one output column per thread,
// K split across blockIdx.z with the shared second pass.  A group's int8
// activations are staged in shared memory as int32 words, the even rows of
// each 8-row run in one word and the odd rows in the next; each payload word
// splits into two words of four signed bytes (q - 8) with byte-wise
// subtraction, which meet the staged words in two __dp4a per word.  No
// mma.sync or wgmma yet.

#include "quant_matmul.cuh"

namespace {

template <int BM>
__global__ void w4a8_partial_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx,
                                    const int32_t* __restrict__ qw,
                                    const __nv_bfloat16* __restrict__ scales,
                                    float* __restrict__ partial, int M, int K, int N,
                                    int groups_per_split) {
  constexpr int kWords = kGroup / 8;  // payload words per group and column
  __shared__ __align__(16) int32_t xs[BM][kGroup / 4];
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
      const int j = c % 8;  // even rows of the run to bytes 0-3, odd rows to 4-7
      reinterpret_cast<int8_t*>(xs[r])[(c / 8) * 8 + (j & 1) * 4 + (j >> 1)] =
          m < M ? x8[(size_t)m * K + (size_t)g * kGroup + c] : (int8_t)0;
    }
    __syncthreads();
    if (!col_ok) continue;
    int isum[BM];
#pragma unroll
    for (int r = 0; r < BM; ++r) isum[r] = 0;
#pragma unroll
    for (int w = 0; w < kWords; ++w) {
      const unsigned word = static_cast<unsigned>(qw[((size_t)g * kWords + w) * N + n]);
      const int even = (int)__vsub4(word & 0x0F0F0F0Fu, 0x08080808u);         // rows 8w + 0, 2, 4, 6
      const int odd = (int)__vsub4((word >> 4) & 0x0F0F0F0Fu, 0x08080808u);   // rows 8w + 1, 3, 5, 7
#pragma unroll
      for (int r = 0; r < BM; ++r) {
        isum[r] = __dp4a(even, xs[r][2 * w], isum[r]);
        isum[r] = __dp4a(odd, xs[r][2 * w + 1], isum[r]);
      }
    }
    const float s = __bfloat162float(scales[(size_t)g * N + n]);
#pragma unroll
    for (int r = 0; r < BM; ++r) acc[r] = __fadd_rn(acc[r], __fmul_rn((float)isum[r], s));
  }
  if (!col_ok) return;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const int m = m0 + r;
    if (m < M) partial[((size_t)split * M + m) * N + n] = acc[r] * sx[m];
  }
}

template <int BM>
void launch_w4a8(const int8_t* x8, const float* sx, const int32_t* qw, const __nv_bfloat16* s,
                 float* partial, int M, int K, int N, int splits, int groups_per_split,
                 cudaStream_t stream) {
  dim3 grid((N + kThreads - 1) / kThreads, (M + BM - 1) / BM, splits);
  w4a8_partial_kernel<BM><<<grid, kThreads, 0, stream>>>(x8, sx, qw, s, partial, M, K, N,
                                                         groups_per_split);
}

}  // namespace

// E1.  x8 (M, K) int8; sx (M,) f32; qw (K/8, N) int32 (K1's layout); scales
// (K/64, N) bf16; partial (splits, M, N) f32 scratch; out (M, N) f32.
// Returns cudaGetLastError().
extern "C" int e1_w4a8_matmul(const void* x8, const void* sx, const void* qw, const void* scales,
                              void* partial, void* out, int M, int K, int N, int splits,
                              int groups_per_split, void* stream_ptr) {
  if (K % kGroup) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xp = static_cast<const int8_t*>(x8);
  const auto* sp = static_cast<const float*>(sx);
  const auto* qp = static_cast<const int32_t*>(qw);
  const auto* cp = static_cast<const __nv_bfloat16*>(scales);
  auto* pp = static_cast<float*>(partial);
  if (M <= 1)
    launch_w4a8<1>(xp, sp, qp, cp, pp, M, K, N, splits, groups_per_split, stream);
  else if (M <= 2)
    launch_w4a8<2>(xp, sp, qp, cp, pp, M, K, N, splits, groups_per_split, stream);
  else if (M <= 4)
    launch_w4a8<4>(xp, sp, qp, cp, pp, M, K, N, splits, groups_per_split, stream);
  else
    launch_w4a8<8>(xp, sp, qp, cp, pp, M, K, N, splits, groups_per_split, stream);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  return sum_splits(pp, out, M, N, splits, 1, stream);
}
