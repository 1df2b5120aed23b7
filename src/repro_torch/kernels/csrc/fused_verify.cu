// fused_paged_verify: SPIN's packed verification (Eq. 13) streaming K/V
// straight from the paged block pool, one launch per attention layer (the
// serving path's LLM verify, serving/paged.py).
//
// Replaces the TPU kernel src/repro/kernels/fused_verify.py
// (_fused_verify_kernel, :43-134; wrapper fused_paged_verify, :139).
//
// What bounds it: the KV bytes.  Every query row of the cohort is scored
// once against the live blocks of its own request; the work per KV byte is
// a few multiply-adds per query token of the tile, far below the ~295
// operations per byte at which the H100's tensor cores would be the limit.
// So the least time is the live K/V (plus scales) read once over 3.35 TB/s;
// at the serving path's short contexts a call costs its dependent memory
// round trips and its idle lanes instead.
//
// What the design does about it: the run-of-entries kernel of
// verify_runs.cuh, which paged_verify_attention (paged_attention.cu) runs
// too: one CTA per (query tile, kv head, run of block entries), one query
// row per warp where the GQA group allows it, the run's live entries
// compacted by ballot (padding entries and other requests' blocks cost no
// K/V byte), 32-slot tiles streamed by cp.async through the tile pipeline
// (tile_pipeline.cuh), int8/fp8 dequantized at use, and with more than
// one run the last run of a query tile merging the partials in the same
// launch.  The wrapper (kernels/fused_verify.py) sizes the call with
// paged_attention.run_plan.
#include "verify_runs.cuh"

// The arguments of spin::verify_runs (verify_runs.cuh).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int spin_fused_paged_verify(
    const void* q, const void* k_pool, const void* v_pool, const int* pool_seg,
    const int* pool_pos, const int* q_seg, const int* q_pos, const int* q_anc,
    const int* block_ids, const int* block_owner, const int* block_node,
    const float* k_scale, const float* v_scale, float* pm, float* pl,
    float* pacc, int* counters, void* out, int Tq, int H, int Kh, int D,
    int bs, int M, int BQ, int per_run, int runs, int wpt, int stages,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  return spin::verify_runs(q, k_pool, v_pool, pool_seg, pool_pos, q_seg,
                           q_pos, q_anc, block_ids, block_owner, block_node,
                           k_scale, v_scale, pm, pl, pacc, counters, out, Tq,
                           H, Kh, D, bs, M, BQ, per_run, runs, wpt, stages,
                           q_dtype, kv_dtype, scale, stream);
}
