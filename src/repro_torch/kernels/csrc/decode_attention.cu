// decode_attention: dense GQA decode, one query token per row against the
// row's (S, Kh, D) slice of a dense cache; slots at or past lengths[b] are
// masked and a row of length 0 gives zeros.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py (_kernel,
// :25-69; wrapper decode_attention, :72).  Public through
// kernels/ops.decode_attention.
//
// What bounds it and what the design does about it: the run-of-tiles
// kernel of decode_runs.cuh, which paged_decode_attention
// (paged_attention.cu) runs too, here over a dense cache (DenseRow): one
// launch over (row, kv head, run of 32-slot tiles) on the tile pipeline
// (tile_pipeline.cuh), the last live run of a row merging the partials in
// the same launch.  The wrapper's run_plan (kernels/decode_attention.py)
// sizes it.
#include "decode_runs.cuh"

// q (B, H, D) f32/bf16; k, v (B, S, Kh, D) f32/bf16; lengths (B,); out like
// q.  Run z covers tiles [z per_run, (z + 1) per_run) of 32 slots, runs =
// max(1, ceil(ceil(S / 32) / per_run)); kWarps / wpt teams of `stages`
// tile buffers (H / Kh rows, at most four per warp).  With runs > 1: pm/pl
// (runs, B, H) and pacc (runs, B, H, D) float32 scratch and counters
// (B * Kh) int32, zero before the call and zero after it; with runs = 1
// they may be null.  One launch.  Returns cudaGetLastError() after it (0 =
// launched).
extern "C" int spin_decode_attention(
    const void* q, const void* k, const void* v, const int* lengths,
    float* pm, float* pl, float* pacc, int* counters, void* out, int B, int S,
    int H, int Kh, int D, int per_run, int runs, int wpt, int stages,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace spin;
  if (!decode_runs_ok(B, S, H, Kh, D, per_run, runs, wpt, stages, pm, pl,
                      pacc, counters))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const DenseRow row{};
  int rc = 0;
#define SPIN_DECODE(QT, KT)                                                 \
  rc = launch_decode_runs<QT, KT>(q, k, v, row, lengths, pm, pl, pacc,      \
                                  counters, out, B, S, H, Kh, D, per_run,   \
                                  runs, wpt, stages, scale, st)
  if (q_dtype == kF32 && kv_dtype == kF32) {
    SPIN_DECODE(float, float);
  } else if (q_dtype == kF32 && kv_dtype == kBF16) {
    SPIN_DECODE(float, __nv_bfloat16);
  } else if (q_dtype == kBF16 && kv_dtype == kF32) {
    SPIN_DECODE(__nv_bfloat16, float);
  } else if (q_dtype == kBF16 && kv_dtype == kBF16) {
    SPIN_DECODE(__nv_bfloat16, __nv_bfloat16);
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_DECODE
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
