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
// Math (the same as the TPU kernels and ops/quant.py:quantized_matmul for
// bf16 activations): W = bf16(s[k/64, n] * q[k, n] + b[k/64, n]) (affine) or
// bf16(s * (q - 8)) (symmetric, K1 only), computed in f32 without FMA
// contraction and rounded once to bf16; products accumulate in f32, so the
// kernels differ from the plain version only in the order of the f32 sums.
// The 8-bit levels are unsigned, 0..255: the TPU kernel widens its int8
// payload as signed, so levels >= 128 dequantize there as (q - 256) * s + b,
// which is not the function the XLA path (and this kernel) computes.
//
// What bounds them on the H100: at decode (M = 1) every weight is used once,
// so they are bound by weight bytes -- 0.5 B (K1, K9) or 1 B (K8) per weight
// plus 4 B of bf16 scale and bias per 64 weights: about 2.09 GB (4-bit) or
// 3.96 GB (8-bit) per Phi-3.5-mini token, a 0.62 ms or 1.18 ms floor at the
// 3.35 TB/s datasheet bandwidth.  At M = 256 the products set the bound
// (0.0147 ms for qkv at 989 TFLOP/s bf16), so the work must reach the tensor
// cores and each weight must be dequantized few times.
//
// All three run on route B, the tensor cores (mma.sync.m16n8k16, bf16 in,
// f32 sums; the TPU kernels fed their dequantized tile to the MXU): tiles of
// BM = 16/32/64 rows x 128 columns, x, payload and scales of the next 64-row
// group in flight by cp.async while this one runs, B fragments dequantized
// once per block straight into registers.  K1 and K8 at M = 1 (decode) take
// route A, a GEMV on the CUDA cores for the bytes: 16-byte loads per lane,
// the next loads in flight while this buffer is dequantized, x staged once
// per block, scales and biases 8 bytes at a time.  Both turn a level into
// f32 by a byte permute into 2^23's mantissa (no int-to-float conversion).
// On the H100 route A lost to route B from M = 2 on, and a GEMV over K9's
// packed rows lost to route B at every M (PERF.md section 6).  Both routes
// write f32 partial sums per K split; sum_splits adds them in a fixed order
// (deterministic) and casts, or, with one split, the kernel writes the
// output itself (adding the splits in the last block of each tile measured
// slower).  Layouts reach the routes through a loader (the seam, as
// flash_mma.cuh's Tiles): WordTiles<4> for K1's (K/8, N) words,
// WordTiles<8> for K8's (K/4, N) words, PackedTiles for K9's bytes.

#include "mma.cuh"
#include "quant_matmul.cuh"

namespace {

constexpr int kAWarps = kThreads / 32;    // route A: a block's warps split its K range
constexpr int kAMaxGroups = 64;           // route A: groups per split (x staged as f32, 16 KB)
constexpr int kBN = 128;                  // route B: output columns of a block, 4 warps x 32
constexpr int kXStride = kGroup + 8;      // route B: bf16 per staged x row (144 B, conflict-free)
constexpr float kAffineZero = 8388608.f;     // 2^23: level() gives q
constexpr float kSymmetricZero = 8388616.f;  // 2^23 + 8: level() gives q - 8

// The level in byte b of v, minus the zero point, exactly: the byte becomes
// the low mantissa bits of 2^23 (a PRMT and an FADD; an int-to-float
// conversion runs at a quarter of the rate).  4-bit levels are masked to a
// nibble per byte first; an 8-bit level is the whole byte, 0..255.
__device__ __forceinline__ float level(unsigned v, int b, float zero) {
  return __fsub_rn(__uint_as_float(__byte_perm(v, 0x4B000000u, 0x7540 | b)), zero);
}

// One weight in f32 as the plain version computes it, rn(rn(s * lv) + b) or
// rn(s * lv); the caller rounds it to bf16.  s is a bf16 (8 significant
// bits) and lv an integer of at most 8 bits, so s * lv is exact in f32 and
// the fused multiply-add rounds once to the same value as __fmul_rn then
// __fadd_rn: one instruction per weight instead of two, bit for bit.
template <bool AFFINE>
__device__ __forceinline__ float dequant(float lv, float s, float b) {
  return AFFINE ? __fmaf_rn(s, lv, b) : __fmul_rn(s, lv);
}

__device__ __forceinline__ void store4(void* dst, int dst_bf16, size_t i, float a, float b, float c,
                                       float d) {
  if (dst_bf16)
    *reinterpret_cast<uint2*>(static_cast<__nv_bfloat16*>(dst) + i) =
        make_uint2(pack_bf16(a, b), pack_bf16(c, d));
  else
    *reinterpret_cast<float4*>(static_cast<float*>(dst) + i) = make_float4(a, b, c, d);
}

// --- Route A: K1 and K8 at M = 1 on the CUDA cores, bound by the weight bytes
//
// A block's x row for its whole K range is staged once as f32 behind one
// barrier; its four warps split the K range and add their sums in warp order
// at the end (deterministic); the splits' sums go through sum_splits.

// Route A's register buffer: eight 16-byte rows of (K * BITS / 32, N) words
// for a lane's four columns, and their group's scales and biases.  At 4 bits
// it holds a whole group (64 rows of K), at 8 bits half of one (32 rows): two
// buffers of 8 rows stay within the registers either way, where two of a
// whole 8-bit group would not.
struct GemvUnit {
  uint4 w[8];
  uint2 s, b;
};

// Loads half `half` of group g (at 4 bits, half 0: the group) into d.  The
// scales and biases are read for half 0; half 1 takes those of `first`,
// which holds half 0 of the same group.
template <int BITS, bool AFFINE>
__device__ __forceinline__ void gemv_load(GemvUnit& d, const GemvUnit& first, const int32_t* __restrict__ qw,
                                          const __nv_bfloat16* __restrict__ scales,
                                          const __nv_bfloat16* __restrict__ biases, int g, int half, int n,
                                          int N) {
  constexpr int kRows = 2 * BITS;  // word rows of a group
#pragma unroll
  for (int r = 0; r < 8; ++r)
    d.w[r] = __ldg(reinterpret_cast<const uint4*>(qw + ((size_t)g * kRows + 8 * half + r) * N + n));
  if (half == 0) {
    d.s = __ldg(reinterpret_cast<const uint2*>(scales + (size_t)g * N + n));
    d.b = AFFINE ? __ldg(reinterpret_cast<const uint2*>(biases + (size_t)g * N + n)) : make_uint2(0u, 0u);
  } else {
    d.s = first.s;
    d.b = first.b;
  }
}

// acc[c] += the unit's rows of column c times x; xg is x at the unit's first
// row of K.  4 bits: nibble n of word row r is row 8 r + n.  8 bits: byte e
// of word row r is row 4 r + e.
template <int BITS, bool AFFINE>
__device__ __forceinline__ void gemv_compute(float (&acc)[4], const GemvUnit& d, const float* xg) {
  const float zero = AFFINE ? kAffineZero : kSymmetricZero;
  const float s[4] = {lo_f32(d.s.x), hi_f32(d.s.x), lo_f32(d.s.y), hi_f32(d.s.y)};
  const float b[4] = {lo_f32(d.b.x), hi_f32(d.b.x), lo_f32(d.b.y), hi_f32(d.b.y)};
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    const unsigned wc[4] = {d.w[r].x, d.w[r].y, d.w[r].z, d.w[r].w};
    if constexpr (BITS == 4) {
      const float4 p = *reinterpret_cast<const float4*>(xg + r * 8);
      const float4 q = *reinterpret_cast<const float4*>(xg + r * 8 + 4);
      const float xv[8] = {p.x, p.y, p.z, p.w, q.x, q.y, q.z, q.w};
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        // nibble 2e of the word is byte e of lo, nibble 2e + 1 byte e of hi
        const unsigned lo = wc[c] & 0x0F0F0F0Fu, hi = (wc[c] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const unsigned u = pack_bf16(dequant<AFFINE>(level(lo, e, zero), s[c], b[c]),
                                       dequant<AFFINE>(level(hi, e, zero), s[c], b[c]));
          acc[c] = fmaf(xv[2 * e], lo_f32(u), acc[c]);
          acc[c] = fmaf(xv[2 * e + 1], hi_f32(u), acc[c]);
        }
      }
    } else {
      const float4 p = *reinterpret_cast<const float4*>(xg + r * 4);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const unsigned u0 = pack_bf16(dequant<AFFINE>(level(wc[c], 0, zero), s[c], b[c]),
                                      dequant<AFFINE>(level(wc[c], 1, zero), s[c], b[c]));
        const unsigned u1 = pack_bf16(dequant<AFFINE>(level(wc[c], 2, zero), s[c], b[c]),
                                      dequant<AFFINE>(level(wc[c], 3, zero), s[c], b[c]));
        acc[c] = fmaf(p.x, lo_f32(u0), acc[c]);
        acc[c] = fmaf(p.y, hi_f32(u0), acc[c]);
        acc[c] = fmaf(p.z, lo_f32(u1), acc[c]);
        acc[c] = fmaf(p.w, hi_f32(u1), acc[c]);
      }
    }
  }
}

// Route A (K1: BITS = 4, K8: BITS = 8).  Lane l of block x owns the four
// columns n = 4 (32 x + l) .. n + 3: one 16-byte load gives their words of
// one row of (K * BITS / 32, N) words, so a unit is eight 16-byte loads (128
// B) per lane and a warp reads 512 consecutive bytes of each row.  Warp w
// takes groups g0 + w, g0 + w + 4, ..., as units: one per group at 4 bits,
// its two halves at 8 bits.  The next unit's loads are issued before this
// one's arithmetic (two register buffers), so the bytes stream while the CUDA
// cores dequantize.  Warps 1-3 hand their sums to warp 0 through red, which
// adds them in warp order.
template <int BITS, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    k1_gemv_kernel(const __nv_bfloat16* __restrict__ x, const int32_t* __restrict__ qw,
                   const __nv_bfloat16* __restrict__ scales, const __nv_bfloat16* __restrict__ biases,
                   void* __restrict__ dst, int dst_bf16, int K, int N, int gps) {
  static_assert(BITS == 4 || (BITS == 8 && AFFINE), "4-bit levels, or affine 8-bit ones");
  constexpr int U = BITS / 4;  // units per group
  extern __shared__ __align__(16) float xs[];  // [kr]
  __shared__ __align__(16) float4 red[kAWarps - 1][32];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int n = (blockIdx.x * 32 + lane) * 4;
  const int G = K / kGroup, g0 = blockIdx.y * gps, g1 = min(G, g0 + gps), kr = (g1 - g0) * kGroup;
  // Unit u of this warp: group g0 + warp + kAWarps * (u / U), half u % U.
  const int nu = g0 + warp < g1 ? (g1 - g0 - warp + kAWarps - 1) / kAWarps * U : 0;
  auto group = [&](int u) { return g0 + warp + kAWarps * (u / U); };
  GemvUnit da, db;
  if (n < N && nu > 0) gemv_load<BITS, AFFINE>(da, da, qw, scales, biases, group(0), 0, n, N);  // over the x copy
  for (int c = threadIdx.x; c < kr / 8; c += kThreads) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(x + g0 * kGroup + c * 8));
    float4* d = reinterpret_cast<float4*>(xs + c * 8);
    d[0] = make_float4(lo_f32(v.x), hi_f32(v.x), lo_f32(v.y), hi_f32(v.y));
    d[1] = make_float4(lo_f32(v.z), hi_f32(v.z), lo_f32(v.w), hi_f32(v.w));
  }
  __syncthreads();
  float acc[4] = {0.f, 0.f, 0.f, 0.f};

  if (n < N) {
    // x of unit u: its group's 64 rows, and the half's 32 at 8 bits.
    auto xg = [&](int u) { return xs + (group(u) - g0) * kGroup + (u % U) * (kGroup / U); };
    for (int u = 0; u < nu; u += 2) {
      if (u + 1 < nu) gemv_load<BITS, AFFINE>(db, da, qw, scales, biases, group(u + 1), (u + 1) % U, n, N);
      gemv_compute<BITS, AFFINE>(acc, da, xg(u));
      if (u + 1 >= nu) break;
      if (u + 2 < nu) gemv_load<BITS, AFFINE>(da, db, qw, scales, biases, group(u + 2), (u + 2) % U, n, N);
      gemv_compute<BITS, AFFINE>(acc, db, xg(u + 1));
    }
  }
  if (warp > 0) red[warp - 1][lane] = make_float4(acc[0], acc[1], acc[2], acc[3]);
  __syncthreads();
  if (warp > 0 || n >= N) return;
#pragma unroll
  for (int w = 0; w < kAWarps - 1; ++w) {
    const float4 v = red[w][lane];
    acc[0] += v.x;
    acc[1] += v.y;
    acc[2] += v.z;
    acc[3] += v.w;
  }
  store4(dst, dst_bf16, (size_t)blockIdx.y * N + n, acc[0], acc[1], acc[2], acc[3]);
}

// --- Route B: K1 and K8 at M >= 2, K9 at every M, on the tensor cores -------
//
// A block owns BM rows x kBN = 128 columns; warp w the 32 columns of its
// quarter for all BM rows, as (BM / 16) x 4 tiles of mma.sync.m16n8k16.  Per
// 64-row group of K, one cp.async stage brings the x tile (BM x 64 bf16),
// the payload tile and the 128 scales and biases into shared memory, the
// next group's stage in flight while this one is used (two stages).  Each
// thread dequantizes its B fragments straight from the payload tile into
// registers, once per block, and reuses them for every row tile.
//
// The k order inside a group is free (the sums are f32 either way), so the
// mma's k slots are mapped to make every operand load contiguous: thread
// (gid, t) of a warp holds, for k-step s, the four rows k = 16 t + 4 s + e (e
// = 0..3) of its columns (B: e = 0, 1 in b0, e = 2, 3 in b1), and the x
// values of the same k (A: 8 contiguous bytes of a row).  Its columns: the
// mma's column gid of n-tile j is the loader's column (gid, j).
//
// The seam: a loader says how a group's payload tile reaches shared memory
// (issue), where the tile's 128 scale columns lie (scale_col: 16 runs of 8),
// which staged scale belongs to the thread's column j (scale_idx), how the
// thread's 4 x 4 x 2 B registers come out of the tile (frags), and where its
// outputs go (two runs of four columns: run_col, run_val).

// K1's (K/8, N) and K8's (K/4, N) int32 words: thread (gid, t) of warp w
// owns columns n0 + 32 w + 4 gid + j (one 16-byte word of a row).  4 bits:
// it reads the group's word rows 2 t and 2 t + 1 (rows 16 t .. 16 t + 15 of
// K), from rows padded to 528 B so that a quarter-warp's 16-byte reads hit
// distinct banks.  8 bits: for k-step s it reads word row 4 t + s, whose
// bytes e = 0..3 are the rows 16 t + 4 s + e of K the mma's k slots want;
// word row 4 t + s is staged at slot 4 s + t of rows padded to 544 B, so the
// four t and two gid of a quarter-warp read eight distinct 16-byte banks.
// The ragged N edge arrives as zeros and is not stored.
template <int BITS>
struct WordTiles {
  static_assert(BITS == 4 || BITS == 8, "4- or 8-bit words");
  static constexpr int kBits = BITS;
  static constexpr bool kGemv = true;       // route A takes M = 1
  static constexpr bool kSymmetric = BITS == 4;  // symmetric mode: 4 bits only
  static constexpr int kRows = 2 * BITS;    // word rows of a group
  static constexpr int kRowBytes = kBN * 4 + (BITS == 4 ? 16 : 32);
  static constexpr int kBytes = kRows * kRowBytes;
  static constexpr bool kRagged = true;
  // Where the tile stages the group's word row r.
  static __device__ __forceinline__ int slot(int r) { return BITS == 4 ? r : 4 * (r % 4) + r / 4; }
  static __device__ __forceinline__ void issue(uint8_t* dst, const void* __restrict__ q, int N, int,
                                               int g, int tile) {
    const int32_t* qw = static_cast<const int32_t*>(q);
    for (int idx = threadIdx.x; idx < kRows * (kBN / 4); idx += kThreads) {
      const int r = idx / (kBN / 4), c = idx % (kBN / 4), n = tile * kBN + 4 * c;
      cp_async16_zfill(dst + slot(r) * kRowBytes + c * 16, qw + ((size_t)g * kRows + r) * N + min(n, N - 4),
                       n < N ? 16 : 0);
    }
  }
  static __device__ __forceinline__ int scale_col(int tile, int c8) { return tile * kBN + 8 * c8; }
  static __device__ __forceinline__ int scale_idx(int warp, int gid, int j) {
    return warp * 32 + 4 * gid + j;
  }
  template <bool AFFINE>
  static __device__ __forceinline__ void frags(const uint8_t* st, int warp, int gid, int t,
                                               const float (&s)[4], const float (&b)[4],
                                               unsigned (&f)[4][4][2]) {
    const float zero = AFFINE ? kAffineZero : kSymmetricZero;
    const uint8_t* p = st + warp * 128 + gid * 16;
    if constexpr (BITS == 4) {
      const uint4 wa = *reinterpret_cast<const uint4*>(p + (2 * t) * kRowBytes);
      const uint4 wb = *reinterpret_cast<const uint4*>(p + (2 * t + 1) * kRowBytes);
      const unsigned w[2][4] = {{wa.x, wa.y, wa.z, wa.w}, {wb.x, wb.y, wb.z, wb.w}};
#pragma unroll
      for (int h = 0; h < 2; ++h)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          // row 16 t + 8 h + n is nibble n of w[h][j]: nibble 2e in byte e of
          // lo, 2e + 1 in byte e of hi; step s = 2 h + sh takes nibbles 4 sh ..
          const unsigned lo = w[h][j] & 0x0F0F0F0Fu, hi = (w[h][j] >> 4) & 0x0F0F0F0Fu;
#pragma unroll
          for (int sh = 0; sh < 2; ++sh) {
            f[2 * h + sh][j][0] = pack_bf16(dequant<AFFINE>(level(lo, 2 * sh, zero), s[j], b[j]),
                                            dequant<AFFINE>(level(hi, 2 * sh, zero), s[j], b[j]));
            f[2 * h + sh][j][1] = pack_bf16(dequant<AFFINE>(level(lo, 2 * sh + 1, zero), s[j], b[j]),
                                            dequant<AFFINE>(level(hi, 2 * sh + 1, zero), s[j], b[j]));
          }
        }
    } else {
#pragma unroll
      for (int sx = 0; sx < 4; ++sx) {
        const uint4 wv = *reinterpret_cast<const uint4*>(p + slot(4 * t + sx) * kRowBytes);
        const unsigned w[4] = {wv.x, wv.y, wv.z, wv.w};
#pragma unroll
        for (int j = 0; j < 4; ++j) {  // byte e of w[j] is row 16 t + 4 sx + e
          f[sx][j][0] = pack_bf16(dequant<AFFINE>(level(w[j], 0, zero), s[j], b[j]),
                                  dequant<AFFINE>(level(w[j], 1, zero), s[j], b[j]));
          f[sx][j][1] = pack_bf16(dequant<AFFINE>(level(w[j], 2, zero), s[j], b[j]),
                                  dequant<AFFINE>(level(w[j], 3, zero), s[j], b[j]));
        }
      }
    }
  }
  // v[j][c]: the sum of n-tile j at the mma's column 2 t + c.
  static __device__ __forceinline__ int run_col(int tile, int warp, int t, int which) {
    return tile * kBN + warp * 32 + 8 * t + 4 * which;
  }
  static __device__ __forceinline__ float run_val(const float (&v)[4][2], int which, int i) {
    return v[i][which];
  }
};

// K9's flat packed (K, N/2) bytes: tile x covers byte columns j0 .. j0 + 63
// of 512-column block B = x / 4 (j0 = 64 (x % 4)), i.e. the low columns lo =
// 512 B + j0 .. + 63 and the high columns lo + 256 ..  Thread (gid, t) of warp
// w owns byte columns 16 w + 2 gid and + 1: columns j = 0, 1 low, j = 2, 3
// high.  The group's 64 rows are staged in k order (row i of the group from
// packed row (g / gk) * block_k + i * gk + g % gk), 64 B each, with 16 B of
// padding every 16 rows so the four t of a warp read distinct banks.
struct PackedTiles {
  static constexpr bool kGemv = false;  // route B at every M
  static constexpr bool kSymmetric = false;
  static constexpr int kRowBytes = kBN / 2;
  static constexpr int kBytes = kGroup * kRowBytes + 4 * 16;
  static constexpr bool kRagged = false;
  static __device__ __forceinline__ int byte0(int tile) { return (tile / 4) * 256 + (tile % 4) * 64; }
  static __device__ __forceinline__ void issue(uint8_t* dst, const void* __restrict__ q, int N,
                                               int block_k, int g, int tile) {
    const uint8_t* qp = static_cast<const uint8_t*>(q) + byte0(tile);
    const int NH = N / 2, gk = block_k / kGroup;
    const size_t row0 = (size_t)(g / gk) * block_k + g % gk;
    for (int idx = threadIdx.x; idx < kGroup * 4; idx += kThreads) {
      const int i = idx / 4, c = idx % 4;
      cp_async16(dst + i * kRowBytes + (i / 16) * 16 + c * 16, qp + (row0 + (size_t)i * gk) * NH + c * 16);
    }
  }
  static __device__ __forceinline__ int scale_col(int tile, int c8) {
    const int lo = (tile / 4) * 512 + (tile % 4) * 64;
    return c8 < 8 ? lo + 8 * c8 : lo + 256 + 8 * (c8 - 8);
  }
  static __device__ __forceinline__ int scale_idx(int warp, int gid, int j) {
    return (j / 2) * 64 + warp * 16 + 2 * gid + (j & 1);
  }
  template <bool AFFINE>
  static __device__ __forceinline__ void frags(const uint8_t* st, int warp, int gid, int t,
                                               const float (&s)[4], const float (&b)[4],
                                               unsigned (&f)[4][4][2]) {
    const uint8_t* p = st + (16 * t) * kRowBytes + t * 16 + warp * 16 + 2 * gid;
#pragma unroll
    for (int sx = 0; sx < 4; ++sx) {
      float wv[4][4];  // [column j][e]
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const unsigned v = *reinterpret_cast<const uint16_t*>(p + (4 * sx + e) * kRowBytes);
        const unsigned lo = v & 0x0F0Fu, hi = (v >> 4) & 0x0F0Fu;
        wv[0][e] = dequant<AFFINE>(level(lo, 0, kAffineZero), s[0], b[0]);
        wv[1][e] = dequant<AFFINE>(level(lo, 1, kAffineZero), s[1], b[1]);
        wv[2][e] = dequant<AFFINE>(level(hi, 0, kAffineZero), s[2], b[2]);
        wv[3][e] = dequant<AFFINE>(level(hi, 1, kAffineZero), s[3], b[3]);
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        f[sx][j][0] = pack_bf16(wv[j][0], wv[j][1]);
        f[sx][j][1] = pack_bf16(wv[j][2], wv[j][3]);
      }
    }
  }
  static __device__ __forceinline__ int run_col(int tile, int warp, int t, int which) {
    return (tile / 4) * 512 + (tile % 4) * 64 + 256 * which + warp * 16 + 4 * t;
  }
  static __device__ __forceinline__ float run_val(const float (&v)[4][2], int which, int i) {
    return v[2 * which + (i & 1)][i >> 1];
  }
};

// Grid (tiles, ceil(M / BM), splits); split z covers groups [z gps, (z + 1) gps).
template <int BM, class L, bool AFFINE>
__global__ void __launch_bounds__(kThreads)
    wq_mma_kernel(const __nv_bfloat16* __restrict__ x, const void* __restrict__ q,
                  const __nv_bfloat16* __restrict__ scales, const __nv_bfloat16* __restrict__ biases,
                  void* __restrict__ dst, int dst_bf16, int M, int K, int N, int block_k, int gps) {
  constexpr int MT = BM / 16;
  constexpr int kXBytes = BM * kXStride * 2;
  constexpr int kStage = kXBytes + L::kBytes + 2 * kBN * 2;
  __shared__ __align__(16) uint8_t smem[2 * kStage];
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31, gid = lane >> 2, t = lane & 3;
  const int tile = blockIdx.x, m0 = blockIdx.y * BM;
  const int G = K / kGroup, g0 = blockIdx.z * gps, g1 = min(G, g0 + gps);

  auto issue = [&](int g) {
    uint8_t* st = smem + ((g - g0) & 1) * kStage;
    for (int idx = tid; idx < BM * 8; idx += kThreads) {
      const int r = idx / 8, c = idx % 8, m = m0 + r;
      cp_async16_zfill(st + r * kXStride * 2 + c * 16, x + (size_t)min(m, M - 1) * K + g * kGroup + c * 8,
                       m < M ? 16 : 0);
    }
    L::issue(st + kXBytes, q, N, block_k, g, tile);
    if (tid < 32 && (AFFINE || tid < 16)) {  // 16 runs of 8 scales, then of 8 biases
      const int c8 = tid & 15, col = L::scale_col(tile, c8);
      const __nv_bfloat16* src = (tid < 16 ? scales : biases) + (size_t)g * N + min(col, N - 8);
      cp_async16_zfill(st + kXBytes + L::kBytes + tid * 16, src, col < N ? 16 : 0);
    }
  };

  float acc[MT][4][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[mt][j][0] = acc[mt][j][1] = acc[mt][j][2] = acc[mt][j][3] = 0.f;

  issue(g0);
  cp_async_commit();
  for (int g = g0; g < g1; ++g) {
    if (g + 1 < g1) issue(g + 1);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    const uint8_t* st = smem + ((g - g0) & 1) * kStage;
    const __nv_bfloat16* ss = reinterpret_cast<const __nv_bfloat16*>(st + kXBytes + L::kBytes);
    float s[4], b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int i = L::scale_idx(warp, gid, j);
      s[j] = __bfloat162float(ss[i]);
      b[j] = AFFINE ? __bfloat162float(ss[kBN + i]) : 0.f;
    }
    unsigned f[4][4][2];
    L::template frags<AFFINE>(st + kXBytes, warp, gid, t, s, b, f);
    const uint8_t* xt = st + (gid * kXStride + 16 * t) * 2;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const uint8_t* r0 = xt + mt * 16 * kXStride * 2;
      const uint8_t* r1 = r0 + 8 * kXStride * 2;
      const uint4 u0 = *reinterpret_cast<const uint4*>(r0), u1 = *reinterpret_cast<const uint4*>(r0 + 16);
      const uint4 v0 = *reinterpret_cast<const uint4*>(r1), v1 = *reinterpret_cast<const uint4*>(r1 + 16);
      const unsigned u[8] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y, u1.z, u1.w};
      const unsigned v[8] = {v0.x, v0.y, v0.z, v0.w, v1.x, v1.y, v1.z, v1.w};
#pragma unroll
      for (int sx = 0; sx < 4; ++sx) {
        const unsigned a[4] = {u[2 * sx], v[2 * sx], u[2 * sx + 1], v[2 * sx + 1]};
#pragma unroll
        for (int j = 0; j < 4; ++j) mma_bf16(acc[mt][j], a, f[sx][j][0], f[sx][j][1]);
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
      float v[4][2];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        v[j][0] = acc[mt][j][2 * h];
        v[j][1] = acc[mt][j][2 * h + 1];
      }
#pragma unroll
      for (int which = 0; which < 2; ++which) {
        const int col = L::run_col(tile, warp, t, which);
        if (L::kRagged && col >= N) continue;
        store4(dst, dst_bf16, ((size_t)blockIdx.z * M + m) * N + col, L::run_val(v, which, 0),
               L::run_val(v, which, 1), L::run_val(v, which, 2), L::run_val(v, which, 3));
      }
    }
}

template <int BM, class L, bool AFFINE>
void launch_mma(const __nv_bfloat16* x, const void* q, const __nv_bfloat16* s,
                const __nv_bfloat16* b, void* dst, int dst_bf16, int M, int K, int N, int block_k,
                int splits, int gps, cudaStream_t stream) {
  dim3 grid((N + kBN - 1) / kBN, (M + BM - 1) / BM, splits);
  wq_mma_kernel<BM, L, AFFINE><<<grid, kThreads, 0, stream>>>(x, q, s, b, dst, dst_bf16, M, K, N,
                                                              block_k, gps);
}

// Route A for K1 and K8 at M = 1, else route B with the smallest row tile
// that holds M (the wrapper's plan() sizes the K split for the same route).
template <class L, bool AFFINE>
void launch_route(const __nv_bfloat16* x, const void* q, const __nv_bfloat16* s,
                  const __nv_bfloat16* b, void* dst, int dst_bf16, int M, int K, int N, int block_k,
                  int splits, int gps, cudaStream_t stream) {
#define ARGS x, q, s, b, dst, dst_bf16, M, K, N, block_k, splits, gps, stream
  if constexpr (L::kGemv) {
    if (M == 1) {
      dim3 grid((N / 4 + 31) / 32, splits);  // 32 lanes x 4 columns per block
      k1_gemv_kernel<L::kBits, AFFINE><<<grid, kThreads, (size_t)gps * kGroup * sizeof(float), stream>>>(
          x, static_cast<const int32_t*>(q), s, b, dst, dst_bf16, K, N, gps);
      return;
    }
  }
  if (M <= 16) {
    launch_mma<16, L, AFFINE>(ARGS);
  } else if (M <= 32) {
    launch_mma<32, L, AFFINE>(ARGS);
  } else {
    launch_mma<64, L, AFFINE>(ARGS);
  }
#undef ARGS
}

// Every layout: check the plan, launch a route, then add the splits.
template <class L>
int wq_matmul(const void* x, const void* q, const void* scales, const void* biases, void* partial,
              void* out, int M, int K, int N, int block_k, int splits, int gps, int out_f32,
              void* stream_ptr) {
  const int G = K / kGroup;
  const bool plan_ok = M >= 1 && K % kGroup == 0 && gps >= 1 && splits == (G + gps - 1) / gps &&
                       (splits == 1 || partial != nullptr) && (!L::kGemv || M > 1 || gps <= kAMaxGroups);
  if (!plan_ok) return (int)cudaErrorInvalidValue;
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const auto* xp = static_cast<const __nv_bfloat16*>(x);
  const auto* sp = static_cast<const __nv_bfloat16*>(scales);
  const auto* bp = static_cast<const __nv_bfloat16*>(biases);
  void* dst = splits > 1 ? partial : out;
  const int dst_bf16 = splits > 1 ? 0 : !out_f32;
  if (biases != nullptr)
    launch_route<L, true>(xp, q, sp, bp, dst, dst_bf16, M, K, N, block_k, splits, gps, stream);
  else if constexpr (L::kSymmetric)
    launch_route<L, false>(xp, q, sp, bp, dst, dst_bf16, M, K, N, block_k, splits, gps, stream);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
  return sum_splits(static_cast<const float*>(partial), out, M, N, splits, out_f32, stream);
}

}  // namespace

// K1 (K1a on a w[layer] view, K1b on lm_head).  x (M, K) bf16; qw (K/8, N)
// int32; scales/biases (K/64, N) bf16 (biases may be null: symmetric mode);
// the K split: `splits` = ceil(K/64 / gps) runs of `gps` groups (at M = 1,
// route A, gps <= 64), whose f32 sums go to partial (splits, M, N) and are
// added in split order by sum_splits (partial may be null when splits ==
// 1); out (M, N) bf16 or f32.  N must be a multiple of 8, every pointer
// 16-byte aligned.
// Returns cudaGetLastError() (cudaErrorInvalidValue for a plan it does not
// take).
extern "C" int k1_w4a16_matmul(const void* x, const void* qw, const void* scales,
                               const void* biases, void* partial, void* out, int M, int K,
                               int N, int splits, int groups_per_split, int out_f32,
                               void* stream_ptr) {
  if (N % 8) return (int)cudaErrorInvalidValue;
  return wq_matmul<WordTiles<4>>(x, qw, scales, biases, partial, out, M, K, N, 0, splits,
                                  groups_per_split, out_f32, stream_ptr);
}

// K8.  x (M, K) bf16; qw (K/4, N) int32 of unsigned 8-bit levels (byte j of
// word [r, n] holds q[4r + j, n]); scales/biases (K/64, N) bf16, biases never
// null (affine only); splits, partial, out as in k1_w4a16_matmul (route A at
// M = 1, gps <= 64; route B above).  N must be a multiple of 8, every
// pointer 16-byte aligned.  Returns cudaGetLastError()
// (cudaErrorInvalidValue for a plan it does not take).
extern "C" int k8_w8a16_matmul(const void* x, const void* qw, const void* scales,
                               const void* biases, void* partial, void* out, int M, int K,
                               int N, int splits, int groups_per_split, int out_f32,
                               void* stream_ptr) {
  if (N % 8 || biases == nullptr) return (int)cudaErrorInvalidValue;
  return wq_matmul<WordTiles<8>>(x, qw, scales, biases, partial, out, M, K, N, 0, splits,
                                 groups_per_split, out_f32, stream_ptr);
}

// K9 (and K10, on a w[layer] view).  x (M, K) bf16; qp (K, N/2) uint8 in the
// flat packed layout (rows group-interleaved within blocks of block_k =
// min(512, K), byte j of each 256-byte run = column j | column j + 256 << 4 of
// its 512-column block); scales/biases (K/64, N) bf16, never null; splits,
// partial, out as in k1_w4a16_matmul (route B at every M).  N must
// be a multiple of 512 and K of block_k; every pointer 16-byte aligned.
extern "C" int k9_w4a16_packed_matmul(const void* x, const void* qp, const void* scales,
                                      const void* biases, void* partial, void* out, int M, int K,
                                      int N, int block_k, int splits, int groups_per_split,
                                      int out_f32, void* stream_ptr) {
  if (N % 512 || block_k % kGroup || block_k < kGroup || K % block_k || biases == nullptr)
    return (int)cudaErrorInvalidValue;
  return wq_matmul<PackedTiles>(x, qp, scales, biases, partial, out, M, K, N, block_k, splits,
                                groups_per_split, out_f32, stream_ptr);
}
