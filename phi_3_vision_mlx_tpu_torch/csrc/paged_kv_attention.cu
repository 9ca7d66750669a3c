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
// Only D = 96 (Phi-3.5-mini) is instantiated; another head dim returns
// cudaErrorInvalidValue until a configuration on the card needs it.

#include "split_runs.cuh"

namespace {

// The paged window (split_runs.cuh): slot s's logical key j of kv head kvh
// at page tables[s, j / page] (clamped into the pool), row j % page; query
// i sees key j iff j <= offsets[s] + i and (valid[s, j] or j >= offsets[s]).
struct Pages {
  const int* tables;       // (S, mp) int32
  const uint8_t* valid;    // (S, mp * page)
  const int* offsets;      // (S,) int32, on the device
  int mp, page, KV, P1;    // P1 = P + 1 pages, the spare one included
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

}  // namespace

// K6.  q (S, H, Lq, D) bf16 with element strides (qsb, qsh, qsl) and unit
// stride along D, Lq <= 16; pool_k, pool_v (layers, P1, KV, page, D) bf16
// contiguous and 16-byte aligned, read at `layer` in place; tables (S, mp)
// int32; valid (S, mp * page) uint8; offsets (S,) int32; out (S, H, Lq, D)
// bf16 with strides (osb, osh, osl); partial f32 scratch of n_split * S * H
// * Lq * (D + 2) floats; split_keys (keys per block) a multiple of 64 and
// n_split = ceil(mp * page / split_keys) (the wrapper's paged_split_plan).
// Returns a cudaError_t.
extern "C" int k6_paged_kv_attention(const void* q, const void* pool_k, const void* pool_v,
                                     const void* tables, const void* valid, const void* offsets,
                                     void* out, void* partial, int S, int H, int KV, int Lq,
                                     int P1, int page, int mp, int D, long long qsb, long long qsh,
                                     long long qsl, long long osb, long long osh, long long osl,
                                     int layer, float scale, int n_split, int split_keys,
                                     void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  const Pages pg{static_cast<const int*>(tables), static_cast<const uint8_t*>(valid),
                 static_cast<const int*>(offsets), mp, page, KV, P1};
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
                                               float scale, int n_split, int split_keys,
                                               void* stream_ptr) {
  cudaStream_t stream = static_cast<cudaStream_t>(stream_ptr);
  const long long st[6] = {qsb, qsh, qsl, osb, osh, osl};
  const Pages pg{static_cast<const int*>(tables), static_cast<const uint8_t*>(valid),
                 static_cast<const int*>(offsets), mp, page, KV, P1};
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
