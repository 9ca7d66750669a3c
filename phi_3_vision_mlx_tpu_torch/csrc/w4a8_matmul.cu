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
// What bounds it on the H100: at decode (M = 1) every weight is read once,
// so bytes (14.2 MB of payload and 0.9 MB of scales at K = 3072, N = 9216:
// 0.0045 ms at 3.35 TB/s, datasheet), as for K1.  At M = 256 the int8
// products take 0.0073 ms at 1,979 TOP/s, and the per-(group, column) scale
// cuts the contraction into 64-deep pieces: every group's int32 sums are
// scaled into the f32 sums on the CUDA cores.
//
// The levels enter the products as they lie in the payload: nibble 2e of a
// word is byte e of (word & 0x0F0F0F0F), nibble 2e + 1 byte e of (word >> 4 &
// 0x0F0F0F0F).  So inside each 8-row run of K the products take the even
// rows, then the odd ones, and x8 is read in that order (a byte permute of
// each 8-byte run).  The int32 group sum is exact and is scaled as the plain
// version does (__fmul_rn, then __fadd_rn into the f32 sum), so each group's
// term is the plain version's bit for bit.
//
// Route A (M = 1, decode), a GEMV in the shape of K1's route A: a lane owns
// four columns and reads a group's eight word rows as eight 16-byte loads,
// the next group's loads issued before this group's arithmetic (two register
// buffers); the block's x8 is staged once, in the products' order.  The zero
// point is taken out of the products, x8 . (q - 8) = x8 . q - 8 sum(x8), with
// each group's sum(x8) taken at staging, so a payload word costs a mask, a
// shift-and-mask and two dp4a (unsigned levels, signed x8), about 0.6
// instructions a weight.
//
// Route B (M >= 2), the int8 tensor cores (mma.sync.m16n8k32, s8 x s8, int32
// sums): tiles of BM = 16/32/64 rows x 128 columns, so each weight is read
// and unpacked once per BM rows, to signed bytes q - 8 (three instructions a
// word of four levels); x8, payload and scales of the next group in flight by
// cp.async while this one runs.  Each group's int32 fragment starts at 1.5 *
// 2^23's bits, so after its two k-steps the fragment, read as f32, is 1.5 *
// 2^23 plus the exact group sum (one subtraction instead of a quarter-rate
// int-to-float conversion).  Taking the zero point out as route A does cost
// more here: each warp's rows need their sums, and a quad's shuffles to add
// them (measured on the H100: 12% slower at M = 256, PERF.md).
//
// Both routes write f32 partial sums per K split; sum_splits adds them in a
// fixed order (deterministic), or, with one split, the kernel writes the
// output itself.  No wgmma or TMA yet.

#include "mma.cuh"
#include "quant_matmul.cuh"

namespace {

constexpr int kWarps = kThreads / 32;
constexpr int kAMaxGroups = 64;               // route A: groups per split (x8 staged in 4 KB)
constexpr int kBN = 128;                      // route B: output columns of a block, 4 warps x 32
constexpr int kWordRowBytes = kBN * 4 + 16;   // route B: a staged word row, padded (as K1's WordTiles<4>)
constexpr int kOnes = 0x01010101;             // dp4a with it sums four signed bytes
constexpr int kMagicBits = 0x4B400000;        // 1.5 * 2^23 as f32
constexpr float kMagic = 12582912.f;

// c + the four products of a's unsigned bytes and b's signed bytes.
__device__ __forceinline__ int dp4a_us(unsigned a, int b, int c) {
  int d;
  asm("dp4a.u32.s32 %0, %1, %2, %3;\n" : "=r"(d) : "r"(a), "r"(b), "r"(c));
  return d;
}

// Levels (0..15, a nibble a byte) to signed bytes q - 8: with bit 7 set no
// byte borrows from the next, and 128 + q - 8 with bit 7 flipped is q - 8.
__device__ __forceinline__ unsigned less8(unsigned lv) { return ((lv | 0x80808080u) - 0x08080808u) ^ 0x80808080u; }

// The products' order of an 8-byte run of x8 (bytes lo, hi): its rows 0, 2,
// 4, 6 (which meet the low nibbles) and 1, 3, 5, 7 (the high nibbles).
__device__ __forceinline__ unsigned even_rows(unsigned lo, unsigned hi) { return __byte_perm(lo, hi, 0x6420); }
__device__ __forceinline__ unsigned odd_rows(unsigned lo, unsigned hi) { return __byte_perm(lo, hi, 0x7531); }

// acc + isum * s, rounded as the plain version rounds it.
__device__ __forceinline__ float add_group(float acc, float isum, float s) {
  return __fadd_rn(acc, __fmul_rn(isum, s));
}

// --- Route A: M = 1 on the CUDA cores, bound by the weight bytes -------------

// One group's eight word rows for a lane's four columns, and their scales.
struct E1Unit {
  uint4 w[8];
  uint2 s;
};

__device__ __forceinline__ void e1_load(E1Unit& d, const int32_t* __restrict__ qw,
                                        const __nv_bfloat16* __restrict__ scales, int g, int n, int N) {
#pragma unroll
  for (int r = 0; r < 8; ++r) d.w[r] = __ldg(reinterpret_cast<const uint4*>(qw + ((size_t)g * 8 + r) * N + n));
  d.s = __ldg(reinterpret_cast<const uint2*>(scales + (size_t)g * N + n));
}

// acc[c] += s[g, c] * (x8 . (q - 8)) over the unit's group for the lane's
// column c; xg: the group's 16 staged words (run r: words 2 r, 2 r + 1), xsum
// the group's sum of x8.
__device__ __forceinline__ void e1_compute(float (&acc)[4], const E1Unit& d, const int* xg, int xsum) {
  int isum[4] = {0, 0, 0, 0};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const int2 xv = *reinterpret_cast<const int2*>(xg + 2 * r);
    const unsigned wc[4] = {d.w[r].x, d.w[r].y, d.w[r].z, d.w[r].w};
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      isum[c] = dp4a_us(wc[c] & 0x0F0F0F0Fu, xv.x, isum[c]);
      isum[c] = dp4a_us((wc[c] >> 4) & 0x0F0F0F0Fu, xv.y, isum[c]);
    }
  }
  const float s[4] = {lo_f32(d.s.x), hi_f32(d.s.x), lo_f32(d.s.y), hi_f32(d.s.y)};
#pragma unroll
  for (int c = 0; c < 4; ++c) acc[c] = add_group(acc[c], (float)(isum[c] - 8 * xsum), s[c]);
}

// Lane l of block x owns the columns n = 4 (32 x + l) .. n + 3; split y
// covers groups [y gps, (y + 1) gps), warp w its groups g0 + w, g0 + w + 4,
// ...  Warps 1-3 hand their sums to warp 0, which adds them in warp order.
__global__ void __launch_bounds__(kThreads)
    e1_gemv_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx, const int32_t* __restrict__ qw,
                   const __nv_bfloat16* __restrict__ scales, float* __restrict__ dst, int K, int N, int gps) {
  __shared__ __align__(16) int xs[kAMaxGroups * kGroup / 4];
  __shared__ int xsum[kAMaxGroups];
  __shared__ __align__(16) float4 red[kWarps - 1][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = (blockIdx.x * 32 + lane) * 4;
  const int G = K / kGroup, g0 = blockIdx.y * gps, ng = min(G, g0 + gps) - g0;
  const int nu = warp < ng ? (ng - warp + kWarps - 1) / kWarps : 0;  // this warp's groups
  auto group = [&](int u) { return warp + kWarps * u; };               // less g0
  E1Unit da, db;
  if (n < N && nu > 0) e1_load(da, qw, scales, g0 + group(0), n, N);  // over the x8 copy

  // Run c of the block's x8 (8 bytes) to words 2 c, 2 c + 1 in the products'
  // order; a group's eight runs are eight neighbouring lanes, which add up
  // its sum (the loop bound is uniform, so every lane shuffles).
  for (int c0 = 0; c0 < ng * 8; c0 += kThreads) {
    const int c = c0 + threadIdx.x;
    int part = 0;
    if (c < ng * 8) {
      const uint2 v = *reinterpret_cast<const uint2*>(x8 + (size_t)g0 * kGroup + 8 * c);
      reinterpret_cast<int2*>(xs)[c] = make_int2((int)even_rows(v.x, v.y), (int)odd_rows(v.x, v.y));
      part = __dp4a((int)v.x, kOnes, __dp4a((int)v.y, kOnes, 0));
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    part += __shfl_xor_sync(0xffffffffu, part, 2);
    part += __shfl_xor_sync(0xffffffffu, part, 4);
    if (c < ng * 8 && c % 8 == 0) xsum[c / 8] = part;
  }
  __syncthreads();

  float acc[4] = {0.f, 0.f, 0.f, 0.f};
  if (n < N) {
    for (int u = 0; u < nu; u += 2) {
      if (u + 1 < nu) e1_load(db, qw, scales, g0 + group(u + 1), n, N);
      e1_compute(acc, da, xs + group(u) * 16, xsum[group(u)]);
      if (u + 1 >= nu) break;
      if (u + 2 < nu) e1_load(da, qw, scales, g0 + group(u + 2), n, N);
      e1_compute(acc, db, xs + group(u + 1) * 16, xsum[group(u + 1)]);
    }
  }
  if (warp > 0) red[warp - 1][lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (warp > 0 || n >= N) return;
#pragma unroll
  for (int w = 0; w < kWarps - 1; ++w) {
    const float4 v = red[w][lane];
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  const float r = sx[0];
  *reinterpret_cast<float4*>(dst + (size_t)blockIdx.y * N + n) =
      make_float4(acc[0] * r, acc[1] * r, acc[2] * r, acc[3] * r);
}

// --- Route B: M >= 2 on the int8 tensor cores ---------------------------------
//
// A block owns BM rows x 128 columns; warp w the 32 columns of its quarter for
// all BM rows, as (BM / 16) x 4 tiles of m16n8k32.  Thread (gid, t) of warp w
// owns the B columns 32 w + 4 gid + j (one 16-byte word of a row: n-tile j's
// column gid) and the group's rows 16 t .. 16 t + 15 (word rows 2 t + h, h =
// 0, 1), which k-step h feeds to the mma's k slots in the products' order:
// b0 = the low nibbles of word row 2 t + h less 8 (rows 8 (2 t + h) + 2 e, at
// slots 4 t + e), b1 = its high nibbles less 8 (rows + 1, at slots 16 + 4 t +
// e).  The A
// registers are the same rows of x8, from one 16-byte read of the raw row and
// a byte permute.  Its outputs are the mma's columns 2 t, 2 t + 1 of n-tile
// j, i.e. columns 32 w + 8 t + 4 c + j: two runs of four.

// Grid (tiles, ceil(M / BM), splits); split z covers groups [z gps, (z + 1) gps).
template <int BM>
__global__ void __launch_bounds__(kThreads)
    e1_mma_kernel(const int8_t* __restrict__ x8, const float* __restrict__ sx, const int32_t* __restrict__ qw,
                  const __nv_bfloat16* __restrict__ scales, float* __restrict__ dst, int M, int K, int N,
                  int gps) {
  constexpr int MT = BM / 16;
  constexpr int kXBytes = BM * kGroup;         // the raw x8 rows of the group, 64 B each
  constexpr int kWBytes = 8 * kWordRowBytes;   // its eight word rows
  constexpr int kStage = kXBytes + kWBytes + kBN * 2;
  __shared__ __align__(16) uint8_t smem[2 * kStage];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, m0 = blockIdx.y * BM;
  const int G = K / kGroup, g0 = blockIdx.z * gps, g1 = min(G, g0 + gps);

  // Rows past M and columns past N arrive as zeros from clamped addresses.
  auto issue = [&](int g) {
    uint8_t* st = smem + ((g - g0) & 1) * kStage;
    for (int idx = tid; idx < BM * 4; idx += kThreads) {
      const int r = idx / 4, c = idx % 4, m = m0 + r;
      cp_async16_zfill(st + r * kGroup + c * 16, x8 + (size_t)min(m, M - 1) * K + g * kGroup + c * 16,
                       m < M ? 16 : 0);
    }
    for (int idx = tid; idx < 8 * (kBN / 4); idx += kThreads) {
      const int r = idx / (kBN / 4), c = idx % (kBN / 4), n = tile * kBN + 4 * c;
      cp_async16_zfill(st + kXBytes + r * kWordRowBytes + c * 16, qw + ((size_t)g * 8 + r) * N + min(n, N - 4),
                       n < N ? 16 : 0);
    }
    if (tid < kBN / 8) {
      const int col = tile * kBN + 8 * tid;
      cp_async16_zfill(st + kXBytes + kWBytes + tid * 16, scales + (size_t)g * N + min(col, N - 8),
                       col < N ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  const int magic[4] = {kMagicBits, kMagicBits, kMagicBits, kMagicBits};
  issue(g0);
  cp_async_commit();
  for (int g = g0; g < g1; ++g) {
    if (g + 1 < g1) issue(g + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = smem + ((g - g0) & 1) * kStage;
    const uint8_t* wp = st + kXBytes + warp * 128 + gid * 16;
    const uint4 wa = *reinterpret_cast<const uint4*>(wp + (2 * t) * kWordRowBytes);
    const uint4 wb = *reinterpret_cast<const uint4*>(wp + (2 * t + 1) * kWordRowBytes);
    const unsigned w[2][4] = {{wa.x, wa.y, wa.z, wa.w}, {wb.x, wb.y, wb.z, wb.w}};
    unsigned b[2][4][2];  // [k-step h][n-tile j]: low, high nibbles, less 8
#pragma unroll
    for (int h = 0; h < 2; ++h)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        b[h][j][0] = less8(w[h][j] & 0x0F0F0F0Fu);
        b[h][j][1] = less8((w[h][j] >> 4) & 0x0F0F0F0Fu);
      }
    // The scales of the thread's output columns 32 w + 8 t .. + 7.
    const uint4 sv = *reinterpret_cast<const uint4*>(st + kXBytes + kWBytes + (warp * 32 + 8 * t) * 2);
    const float s[8] = {lo_f32(sv.x), hi_f32(sv.x), lo_f32(sv.y), hi_f32(sv.y),
                        lo_f32(sv.z), hi_f32(sv.z), lo_f32(sv.w), hi_f32(sv.w)};
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      // Rows gid and gid + 8 of the m-tile, bytes 16 t .. 16 t + 15 (runs 2 t, 2 t + 1).
      const uint8_t* xr = st + (mt * 16 + gid) * kGroup + 16 * t;
      const uint4 u = *reinterpret_cast<const uint4*>(xr);
      const uint4 v = *reinterpret_cast<const uint4*>(xr + 8 * kGroup);
      const unsigned a[2][4] = {
          {even_rows(u.x, u.y), even_rows(v.x, v.y), odd_rows(u.x, u.y), odd_rows(v.x, v.y)},
          {even_rows(u.z, u.w), even_rows(v.z, v.w), odd_rows(u.z, u.w), odd_rows(v.z, v.w)}};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int c[4];
        mma_s8(c, a[0], b[0][j][0], b[0][j][1], magic);
        mma_s8(c, a[1], b[1][j][0], b[1][j][1], c);
#pragma unroll
        for (int i = 0; i < 4; ++i)  // row gid + 8 (i >> 1), column 32 w + 8 t + 4 (i & 1) + j
          acc[mt][j][i] = add_group(acc[mt][j][i], __fsub_rn(__int_as_float(c[i]), kMagic), s[4 * (i & 1) + j]);
      }
    }
    __syncthreads();  // the stage is free for the copy after next
  }
  cp_async_wait<0>();

#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = m0 + mt * 16 + gid + 8 * h;
      if (m >= M) continue;
      const float r = sx[m];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = tile * kBN + warp * 32 + 8 * t + 4 * c;
        if (col >= N) continue;
        *reinterpret_cast<float4*>(dst + ((size_t)blockIdx.z * M + m) * N + col) =
            make_float4(acc[mt][0][2 * h + c] * r, acc[mt][1][2 * h + c] * r, acc[mt][2][2 * h + c] * r,
                        acc[mt][3][2 * h + c] * r);
      }
    }
}

template <int BM>
void launch_mma(const int8_t* x8, const float* sx, const int32_t* qw, const __nv_bfloat16* s, float* dst, int M,
                int K, int N, int splits, int gps, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  e1_mma_kernel<BM><<<grid, kThreads, 0, stream>>>(x8, sx, qw, s, dst, M, K, N, gps);
}

}  // namespace

// E1.  x8 (M, K) int8; sx (M,) f32; qw (K/8, N) int32 (K1's layout); scales
// (K/64, N) bf16; the K split as in k1_w4a16_matmul: `splits` = ceil(K/64 /
// gps) runs of `gps` groups (at M = 1, route A, gps <= 64), whose f32 sums go
// to partial (splits, M, N) and are added in split order (partial may be
// null when splits == 1); out (M, N) f32.  Route A at M = 1, route B above
// with the smallest row tile that holds M (the wrapper's route() and plan()
// make the same choice).  N must be a multiple of 8, every pointer 16-byte
// aligned.  Returns cudaGetLastError() (cudaErrorInvalidValue for a plan it
// does not take).
extern "C" int e1_w4a8_matmul(const void* x8, const void* sx, const void* qw, const void* scales,
                              void* partial, void* out, int M, int K, int N, int splits,
                              int groups_per_split, void* stream_ptr) {
  const int G = K / kGroup, gps = groups_per_split;
  const bool plan_ok = M >= 1 && K % kGroup == 0 && N % 8 == 0 && gps >= 1 && splits == (G + gps - 1) / gps &&
                       (splits == 1 || partial != nullptr) && (M > 1 || gps <= kAMaxGroups);
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xp = static_cast<const int8_t*>(x8);
  const auto* sp = static_cast<const float*>(sx);
  const auto* qp = static_cast<const int32_t*>(qw);
  const auto* cp = static_cast<const __nv_bfloat16*>(scales);
  float* dst = static_cast<float*>(splits > 1 ? partial : out);
  if (M == 1) {
    dim3 grid((N / 4 + 31) / 32, splits);  // 32 lanes x 4 columns per block
    e1_gemv_kernel<<<grid, kThreads, 0, stream>>>(xp, sp, qp, cp, dst, K, N, gps);
  } else if (M <= 16) {
    launch_mma<16>(xp, sp, qp, cp, dst, M, K, N, splits, gps, stream);
  } else if (M <= 32) {
    launch_mma<32>(xp, sp, qp, cp, dst, M, K, N, splits, gps, stream);
  } else {
    launch_mma<64>(xp, sp, qp, cp, dst, M, K, N, splits, gps, stream);
  }
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return sum_splits(static_cast<const float*>(partial), out, M, N, splits, 1, stream);
}
