// Kernels K6 (decode attention through page tables over the dense page
// pool) and K7 (the same over the int4 page pool).  Each has its own entry
// point.
//
// K6 replaces phi_3_vision_mlx_tpu/ops/kernels/kv_attention.py:
// paged_kv_attention (:354), body _paged_kernel (:285).  K7 replaces
// kv_attention.py:paged_quantized_kv_attention (:519), body _paged_q_kernel
// (:442).
//
// The pool (engine/paging.py) is the port's token-major layout with pages in
// place of the batch and window axes: dense (layers, P + 1, KV, page, D)
// bf16 for K and for V; int4 (layers, P + 1, KV, page, D) uint8 with byte
// d = k_q[d] | v_q[d] << 4, and scales (layers, P + 1, KV, page, 4G) bf16.
// Page P is the spare page that unallocated table entries point at.  Slot s
// reads logical key j at page tables[s, j / page], row j % page; a table
// entry outside [0, P] is clamped into it, so a bad table cannot read out of
// bounds.  Query i of slot s sits at position offsets[s] + i and sees key j
// iff j <= offsets[s] + i and (valid[s, j] or j >= offsets[s]): the keys
// from the offset on are this step's fresh ones, whose validity bits commit
// after the step (the TPU kernel's fresh-region rule).  A row that sees no
// key comes out as the uniform average of every value of its window, as the
// plain version's finite NEG_INF gives.  The rounding rules are those of
// K3/K4 (attention.cuh); the int4 values dequantize to the plain version's
// bits.
//
// What bounds them on the H100: bytes.  A decode step reads each slot's
// keys up to its offset once per query head: 2 * D * 2 B per (kv head, key)
// dense, D + 8G B (120 B at D = 96) int4.  The offsets live on the device,
// so the number of blocks comes from the window, which the host knows, and
// a block past its slot's last visible key finds nothing to do.  The TPU
// kernel walks every page of the table; the answer is the same.
//
// Both run the split-run decode body of split_runs.cuh (split_run_kernel +
// run_combine_kernel, K4's too) through the Pages window: runs of kRunKeys
// = 64 keys, one block per (run, query head, slot) taking all of the slot's
// Lq <= 16 rows (block_keys = 64: paged_split_plan), so a page is read once
// per head, not once per query row.  At the served page of 64 a run is one
// page.  The run's loader is the seam between the pools: DenseRun (K6)
// copies each key's bf16 K and V rows (16-byte cp.async, each key's row
// from the table, so a run may span pages or part of one) straight into the
// padded bf16 tiles; Int4Run (K7) requests one contiguous 6 KB block of
// payload and 1.5 KB of scales into a raw stage and dequantizes it once
// into the same tiles (flash_mma.cuh: dequantize_int4_tile, K5's).
//
// fp32 models run both in f32 (the _f32 entries): an f32 query, and for K6
// an f32 pool, through split_runs.cuh's fp32 body (split_run_tf32_kernel,
// 3xTF32 on the tensor cores): DenseRunF32 reads each key's f32 K row
// straight into the fragments and copies its V row into the stage (its
// bound doubles the bf16 bytes: 4 * D * 2 B per (kv head, key)), K7 in fp32
// takes Int4RunF32 over the same int4 pool and bytes as in bf16.
//
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "split_runs.cuh"

namespace {

// The paged window (split_runs.cuh): slot s's logical key j of kv head kvh
// at page tables[s, j / page] (clamped into the pool), row j % page; query
// i sees key j iff j <= offsets[s] + row0 + i and (valid[s, j] or j >=
// offsets[s]): the fresh region starts at the offset whatever row0 is.
struct Pages {
  const int* tables;       // (S, mp) int32
  const uint8_t* valid;    // (S, mp * page)
  const int* offsets;      // (S,) int32, on the device
  int mp, page, KV, P1;    // P1 = P + 1 pages, the spare one included
  int row0;                // the launch's first query row in the pass
  __host__ __device__ __forceinline__ int width() const { return mp * page; }
  __device__ __forceinline__ int offset(int s) const { return offsets[s]; }
  __device__ __forceinline__ size_t row(int s, int kvh, int j) const {
    const int pid = min(max(tables[(size_t)s * mp + j / page], 0), P1 - 1);
    return ((size_t)pid * KV + kvh) * page + j % page;
  }
  __device__ __forceinline__ bool listed(int s, int j, int off) const {
    return j >= off || valid[(size_t)s * width() + j] != 0;
  }
};

// K6's loader for the dense pool: a = the layer's keys, b = its values,
// (P1, KV, page, D) bf16, 16-byte aligned.  Threads 2r and 2r + 1 copy row
// r, one table lookup each, half of its K row and half of its V row each,
// in 16-byte chunks straight into the padded tiles.
template <int D>
struct DenseRun {
  static constexpr int kRawBytes = 0;
  static constexpr int kMode = kFp32;
  static constexpr bool kF32 = false;

  static __device__ __forceinline__ void issue(__nv_bfloat16* kt, __nv_bfloat16* vt, unsigned char*,
                                               const void* __restrict__ a, const void* __restrict__ b,
                                               const Pages& pg, int s, int kvh, int j0, int n) {
    static_assert(kRunThreads == 2 * kRunKeys && D % 16 == 0, "two threads per row, 16-byte halves");
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (D / 2);
    const size_t row = pg.row(s, kvh, j0 + min(r, n - 1));
    const __nv_bfloat16* kr = static_cast<const __nv_bfloat16*>(a) + row * D + c0;
    const __nv_bfloat16* vr = static_cast<const __nv_bfloat16*>(b) + row * D + c0;
#pragma unroll
    for (int c = 0; c < D / 2; c += 8) {  // D / 16 chunks of 16 B each
      cp_async16(kt + r * (D + 8) + c0 + c, kr + c);
      cp_async16(vt + r * (D + 8) + c0 + c, vr + c);
    }
  }

  static __device__ __forceinline__ void tiles(__nv_bfloat16*, __nv_bfloat16*, const unsigned char*) {}

  static __device__ __forceinline__ float window_value(const void* __restrict__, const void* __restrict__ b,
                                                       size_t row, int d) {
    return bf(static_cast<const __nv_bfloat16*>(b)[row * D + d]);
  }
};

// K6's loader for an fp32 model's f32 pool (split_runs.cuh's fp32 seam): a
// = the layer's keys, b = its values, (P1, KV, page, D) f32, 16-byte
// aligned.  Keys go from device memory straight into the S fragments
// (kKGlobal: thread tig of key r reads dims 8 kk + 2 tig, +1, 8 bytes at a
// time, a key's 32 bytes of each k-step in one sector), so only the values
// are staged: [kRunKeys][D] f32, unpadded, 16-byte chunk c of key r's row at
// chunk c ^ 2 (r & 3) (an XOR within aligned groups of eight chunks), so the
// P V fragment reads (keys 8 j + tig, dims 32 i + 8 w + gid) fall in
// distinct banks.  Threads 2r and 2r + 1 copy half of row r's values each,
// 16 bytes at a time.
template <int D>
struct DenseRunF32 {
  static constexpr int kChunks = D / 4;  // 16-byte chunks a row
  static constexpr int kRawBytes = kRunKeys * D * 4;
  static constexpr int kQStride = D + 8;  // q rows eight banks apart: 8-byte reads conflict-free
  static constexpr bool kKGlobal = true;
  static constexpr int kMode = kFp32;
  static constexpr bool kF32 = true;
  static_assert(kChunks % 8 == 0, "the swizzle stays inside a row");

  static __device__ __forceinline__ int chunk(int key, int c) { return c ^ (2 * (key & 3)); }

  static __device__ __forceinline__ void issue(unsigned char* raw, const void* __restrict__,
                                               const void* __restrict__ b, const Pages& pg, int s, int kvh, int j0,
                                               int n) {
    static_assert(kRunThreads == 2 * kRunKeys, "two threads per row");
    const int r = threadIdx.x >> 1, c0 = (threadIdx.x & 1) * (kChunks / 2);
    const float* vr = static_cast<const float*>(b) + pg.row(s, kvh, j0 + min(r, n - 1)) * D;
    float* vt = reinterpret_cast<float*>(raw) + r * D;
#pragma unroll
    for (int c = c0; c < c0 + kChunks / 2; ++c) cp_async16(vt + 4 * chunk(r, c), vr + 4 * c);
  }

  static __device__ __forceinline__ int kdim(int kk, int tig) { return 8 * kk + 2 * tig; }

  static __device__ __forceinline__ void k_pairs(const unsigned char*, const void* __restrict__ a, const Pages& pg,
                                                 int s, int kvh, int j, int, int tig, float2 (&k)[D / 8]) {
    const float* kr = static_cast<const float*>(a) + pg.row(s, kvh, j) * D + 2 * tig;
#pragma unroll
    for (int kk = 0; kk < D / 8; ++kk) k[kk] = __ldg(reinterpret_cast<const float2*>(kr + 8 * kk));
  }

  static __device__ __forceinline__ void v_cols(const unsigned char* __restrict__ raw, int key, int col0,
                                                float (&v)[D / 32]) {
    const float* vt = reinterpret_cast<const float*>(raw) + key * D + (col0 & 3);
#pragma unroll
    for (int i = 0; i < D / 32; ++i) v[i] = vt[4 * chunk(key, (col0 >> 2) + 8 * i)];
  }

  static __device__ __forceinline__ float window_value(const void* __restrict__, const void* __restrict__ b,
                                                       size_t row, int d) {
    return static_cast<const float*>(b)[row * D + d];
  }
};

template <int D, class Run>
int paged_launch(const void* q, const void* a, const void* b, size_t a_row_bytes, size_t b_row_bytes,
                 const void* tables, const void* valid, const void* offsets, void* out, void* partial, int S,
                 int H, int KV, int Lq, int P1, int page, int mp, const long long* st, int layer, int row0,
                 float scale, int n_split, int split_keys, void* stream_ptr) {
  const Pages pg{static_cast<const int*>(tables), static_cast<const uint8_t*>(valid),
                 static_cast<const int*>(offsets), mp, page, KV, P1, row0};
  const size_t layer_rows = (size_t)P1 * KV * page;
  return (int)launch_split_runs<D, Run>(q, static_cast<const uint8_t*>(a) + layer * layer_rows * a_row_bytes,
                                        static_cast<const uint8_t*>(b) + layer * layer_rows * b_row_bytes, pg,
                                        out, partial, S, H, Lq, st, scale, n_split, split_keys,
                                        static_cast<cudaStream_t>(stream_ptr));
}

}  // namespace

// K6.  q (S, H, Lq, D) bf16 with element strides (qsb, qsh, qsl) and unit
// stride along D, Lq <= 16; pool_k, pool_v (layers, P1, KV, page, D) bf16
// contiguous and 16-byte aligned, read at `layer` in place; tables (S, mp)
// int32; valid (S, mp * page) uint8; offsets (S,) int32; out (S, H, Lq, D)
// bf16 with strides (osb, osh, osl); partial f32 scratch of n_split * S * H
// * Lq * (D + 2) floats; split_keys (keys per block) a multiple of 64 and
// n_split = ceil(mp * page / split_keys) (the wrapper's paged_split_plan).
// Query i of slot s sits at position offsets[s] + row0 + i (row0 >= 0: a
// pass of more than 16 rows runs as launches on groups of 16).  Returns a
// cudaError_t.
extern "C" int k6_paged_kv_attention(const void* q, const void* pool_k, const void* pool_v,
                                     const void* tables, const void* valid, const void* offsets,
                                     void* out, void* partial, int S, int H, int KV, int Lq,
                                     int P1, int page, int mp, int D, long long qsb, long long qsh,
                                     long long qsl, long long osb, long long osh, long long osl,
                                     int layer, int row0, float scale, int n_split,
                                     int split_keys, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  const Pages pg{static_cast<const int*>(tables), static_cast<const uint8_t*>(valid),
                 static_cast<const int*>(offsets), mp, page, KV, P1, row0};
  const size_t layer_elems = (size_t)P1 * KV * page * D;
  switch (D) {
    case 96: return (int)launch_split_runs<96, DenseRun<96>>(
        q, static_cast<const __nv_bfloat16*>(pool_k) + (size_t)layer * layer_elems,
        static_cast<const __nv_bfloat16*>(pool_v) + (size_t)layer * layer_elems, pg, out, partial,
        S, H, Lq, st, scale, n_split, split_keys, stream);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7.  As K6, with payload (layers, P1, KV, page, D) uint8 (16-byte
// aligned) and scales (layers, P1, KV, page, 4G) bf16 (8-byte aligned) in
// place of pool_k and pool_v.  Returns a cudaError_t.
extern "C" int k7_paged_quantized_kv_attention(const void* q, const void* payload,
                                               const void* scales, const void* tables,
                                               const void* valid, const void* offsets, void* out,
                                               void* partial, int S, int H, int KV, int Lq, int P1,
                                               int page, int mp, int D, long long qsb,
                                               long long qsh, long long qsl, long long osb,
                                               long long osh, long long osl, int layer,
                                               int row0, float scale, int n_split,
                                               int split_keys, void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  const Pages pg{static_cast<const int*>(tables), static_cast<const uint8_t*>(valid),
                 static_cast<const int*>(offsets), mp, page, KV, P1, row0};
  const size_t layer_rows = (size_t)P1 * KV * page;
  switch (D) {
    case 96: {
      constexpr int G = 96 / kGroup;
      return (int)launch_split_runs<96, Int4Run<96>>(
          q, static_cast<const uint8_t*>(payload) + (size_t)layer * layer_rows * 96,
          static_cast<const __nv_bfloat16*>(scales) + (size_t)layer * layer_rows * 4 * G, pg, out,
          partial, S, H, Lq, st, scale, n_split, split_keys, stream);
    }
    default: return (int)cudaErrorInvalidValue;
  }
}

// K6 in fp32: as k6_paged_kv_attention with f32 q, pool_k, pool_v and out.
extern "C" int k6_paged_kv_attention_f32(const void* q, const void* pool_k, const void* pool_v,
                                         const void* tables, const void* valid, const void* offsets,
                                         void* out, void* partial, int S, int H, int KV, int Lq,
                                         int P1, int page, int mp, int D, long long qsb, long long qsh,
                                         long long qsl, long long osb, long long osh, long long osl,
                                         int layer, int row0, float scale, int n_split,
                                         int split_keys, void* stream_ptr) {
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  switch (D) {
    case 96: return paged_launch<96, DenseRunF32<96>>(q, pool_k, pool_v, 96 * 4, 96 * 4, tables, valid, offsets,
                                                      out, partial, S, H, KV, Lq, P1, page, mp, st, layer, row0,
                                                      scale, n_split, split_keys, stream_ptr);
    default: return (int)cudaErrorInvalidValue;
  }
}

// K7 in fp32: as k7_paged_quantized_kv_attention with f32 q and out.
extern "C" int k7_paged_quantized_kv_attention_f32(const void* q, const void* payload,
                                                   const void* scales, const void* tables,
                                                   const void* valid, const void* offsets, void* out,
                                                   void* partial, int S, int H, int KV, int Lq, int P1,
                                                   int page, int mp, int D, long long qsb,
                                                   long long qsh, long long qsl, long long osb,
                                                   long long osh, long long osl, int layer,
                                                   int row0, float scale, int n_split,
                                                   int split_keys, void* stream_ptr) {
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  switch (D) {
    case 96: return paged_launch<96, Int4RunF32<96>>(q, payload, scales, 96, 4 * (96 / kGroup) * 2, tables, valid,
                                                     offsets, out, partial, S, H, KV, Lq, P1, page, mp, st, layer,
                                                     row0, scale, n_split, split_keys, stream_ptr);
    default: return (int)cudaErrorInvalidValue;
  }
}
