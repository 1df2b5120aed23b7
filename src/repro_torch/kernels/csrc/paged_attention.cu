// paged_attention: the unfused paged attention kernels.
//
// paged_decode_attention replaces the TPU kernel
// src/repro/kernels/paged_attention.py (_decode_kernel, :56-108; wrapper
// paged_decode_attention, :111): one query token per row against the row's
// block table, slots valid iff their logical position is below lengths[b].
//
// paged_verify_attention replaces (_verify_kernel, :178-260; wrapper
// paged_verify_attention, :263): SPIN's packed verification (Eq. 13) over
// a list of live blocks, the function of fused_verify.cu, by the same
// kernel (verify_runs.cuh).
//
// Both are public through kernels/ops.py; the serving engine takes the
// fused kernels instead.  Both dequantize int8/fp8 blocks with the
// per-(slot, head) scale.
//
// What bounds them on the H100: the least time is the attended blocks' K/V
// (plus scales, tags and table entries) read once over 3.35 TB/s -- a few
// multiply-adds per K/V element against the ~295 operations per byte at
// which the tensor cores would be the limit.  At the ops path's short rows
// that is under a microsecond, and a call costs its chain of dependent
// memory round trips and its idle lanes; a long row at a small batch has
// the bytes to fill the card only if many CTAs share it.
//
// What the designs do about it.
// - decode: dense decode_attention's run-of-tiles kernel (decode_runs.cuh)
//   over the block pool (PagedRow): one launch over (row, kv head, run of
//   32-slot tiles), sized by decode_attention.run_plan over NB * bs slots
//   (the host knows no length); each live run copies its slice of the
//   row's table into shared memory, streams its slots as 32-slot tiles
//   whatever the block size, and the last live run of a row merges.  As in
//   the reference, an unallocated entry (< 0) of the live prefix reads
//   block 0, and the slots past the length are never read.
// - verify: one CTA per (segment tile, kv head group, chunk), tensor
//   cores for bf16 queries; verify_runs.cuh (shared with fused_verify.cu)
//   holds the kernels and their design.
#include "decode_runs.cuh"
#include "verify_runs.cuh"

// q (B, H, D) f32/bf16; pools (N, bs, Kh, D) f32/bf16/int8/fp8;
// block_tables (B, NB), < 0 = unallocated; lengths (B,); ks/vs (N, bs, Kh)
// f32 for int8/fp8 pools, else null; out like q.  The plan, the float32
// scratch pm/pl (runs, B, H), pacc (runs, B, H, D) and the counters
// (B * Kh) are spin_decode_attention's (decode_attention.cu) over S = NB
// bs slots.  One launch.  Returns cudaGetLastError() after it (0 =
// launched).
extern "C" int spin_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* block_tables, const int* lengths, const float* k_scale,
    const float* v_scale, float* pm, float* pl, float* pacc, int* counters,
    void* out, int B, int H, int Kh, int D, int bs, int NB, int per_run,
    int runs, int wpt, int stages, int q_dtype, int kv_dtype, float scale,
    void* stream) {
  using namespace spin;
  const bool quant = kv_dtype == kI8 || kv_dtype == kFP8;
  if (bs <= 0 || NB < 0 || NB > INT_MAX / bs ||
      quant != (k_scale != nullptr && v_scale != nullptr) ||
      !decode_runs_ok(B, NB * bs, H, Kh, D, per_run, runs, wpt, stages, pm,
                      pl, pacc, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const PagedRow row{block_tables, k_scale, v_scale, bs, NB};
  int rc = 0;
#define SPIN_DECODE(QT, KT)                                                 \
  rc = launch_decode_runs<QT, KT>(q, k_pool, v_pool, row, lengths, pm, pl, \
                                  pacc, counters, out, B, NB * bs, H, Kh,   \
                                  D, per_run, runs, wpt, stages, scale, st)
#define SPIN_DECODE_KV(QT)                                        \
  switch (kv_dtype) {                                             \
    case kF32: SPIN_DECODE(QT, float); break;                     \
    case kBF16: SPIN_DECODE(QT, __nv_bfloat16); break;            \
    case kI8: SPIN_DECODE(QT, int8_t); break;                     \
    case kFP8: SPIN_DECODE(QT, __nv_fp8_e4m3); break;             \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }
  if (q_dtype == kF32) {
    SPIN_DECODE_KV(float)
  } else if (q_dtype == kBF16) {
    SPIN_DECODE_KV(__nv_bfloat16)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_DECODE_KV
#undef SPIN_DECODE
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// The arguments of spin::verify_runs (verify_runs.cuh).  Returns
// cudaGetLastError() after the launch.
extern "C" int spin_paged_verify_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* pool_seg,
    const int* pool_pos, const int* q_seg, const int* q_pos, const int* q_anc,
    const int* block_ids, const int* block_owner, const int* block_node,
    const float* k_scale, const float* v_scale, float* pm, float* pl,
    float* pacc, int* counters, void* out, int Tq, int H, int Kh, int D,
    int bs, int M, int tokens, int span, int chunks, int cap, int mma,
    int heads, int wpt, int stages, int q_dtype, int kv_dtype, int window,
    float scale, void* stream) {
  return spin::verify_runs(q, k_pool, v_pool, pool_seg, pool_pos, q_seg,
                           q_pos, q_anc, block_ids, block_owner, block_node,
                           k_scale, v_scale, pm, pl, pacc, counters, out, Tq,
                           H, Kh, D, bs, M, tokens, span, chunks, cap, mma,
                           heads, wpt, stages, q_dtype, kv_dtype, window,
                           scale, stream);
}
