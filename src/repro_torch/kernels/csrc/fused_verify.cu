// fused_paged_verify: SPIN's packed verification (Eq. 13) streaming K/V
// straight from the paged block pool, one launch per attention layer (the
// serving path's LLM verify, serving/paged.py).
//
// Replaces the TPU kernel src/repro/kernels/fused_verify.py
// (_fused_verify_kernel, :43-134; wrapper fused_paged_verify, :139).
//
// What bounds it: the live K/V read once over 3.35 TB/s.  Each request's
// blocks meet its W + 1 verify tokens times the GQA group (25-30 rows at
// the serving cells' G 5-6), about 25-30 operations per K/V byte: on the
// CUDA cores the arithmetic alone takes longer than the bytes, on the
// tensor cores a twelfth of it.
//
// What the design does about it: verify_runs.cuh, which
// paged_verify_attention (paged_attention.cu) runs too: one CTA per
// (segment tile, group of kv heads, chunk), found on the device from q_seg
// and the block list's owners (no host sync, no reordering), streaming its
// segment's blocks once for all its rows by cp.async; bf16 queries score
// on mma.sync (m16n8k16, bf16 -> f32), float32 ones on the CUDA cores;
// int8/fp8 blocks dequantized at use; long lists per token split a
// segment's entries into chunks merged by the last chunk in the same
// launch.  The wrapper (kernels/fused_verify.py) sizes the call with
// paged_attention.verify_plan.
#include "verify_runs.cuh"

// The arguments of spin::verify_runs (verify_runs.cuh).  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int spin_fused_paged_verify(
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
