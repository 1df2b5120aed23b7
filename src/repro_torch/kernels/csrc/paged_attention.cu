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
// per-(slot, head) scale (paged_common.cuh, verify_runs.cuh).
//
// What bounds them on the H100: the least time is the attended blocks' K/V
// (plus scales and tags) read once over 3.35 TB/s -- a few multiply-adds
// per K/V element against the ~295 operations per byte at which the
// tensor cores would be the limit.  At serving lengths that is under a
// microsecond; a call costs its chain of dependent memory round trips and
// its idle lanes, not bytes or arithmetic.
//
// What the designs do about it.
// - decode: one CTA per (row, kv head) holds the GQA group's heads and
//   walks the row's live logical blocks, j < ceil(lengths[b] / bs), each
//   slot read once for all heads; the table's unallocated tail (< 0) and
//   the slots past the length are never read.
// - verify: split over runs of block entries, one launch, the last run of
//   a query tile merging; verify_runs.cuh (shared with fused_verify.cu)
//   holds the kernel and its design.
#include "paged_common.cuh"
#include "verify_runs.cuh"

namespace spin {

// ---------------------------------------------------------------- decode --

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
    paged_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                        const KT* __restrict__ vp,
                        const int* __restrict__ block_tables,
                        const int* __restrict__ lengths,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs, QT* __restrict__ out,
                        int H, int Kh, int D, int bs, int NB, float scale) {
  extern __shared__ float smem_raw[];
  const int G = H / Kh;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int rows = G;
  const Smem sm = carve_smem(smem_raw, rows, D);
  const long long qrow = static_cast<long long>(b) * H;

  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    sm.q[e] = to_f32(q[(qrow + h * G + r) * D + d]) * scale;
  }
  for (int j = threadIdx.x; j < kTile; j += blockDim.x) {
    sm.seg[j] = 0;  // every loaded slot is below the length
    sm.pos[j] = 0;
    sm.node[j] = -1;
  }
  const int warp = threadIdx.x >> 5;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimPerLane];
  int rseg[kRowsPerWarp], rpos[kRowsPerWarp], ranc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) acc[rr][i] = 0.f;
    rseg[rr] = 0;
    rpos[rr] = 0;
    ranc[rr] = -1;
  }
  const int len = max(lengths[b], 0);
  const int live = min(NB, (len + bs - 1) / bs);
  const int* table = block_tables + static_cast<long long>(b) * NB;
  __syncthreads();

  for (int j = 0; j < live; ++j) {
    // the reference reads block max(id, 0) for every live logical block
    const long long blk = max(table[j], 0);
    const int valid = min(bs, len - j * bs);
    for (int s0 = 0; s0 < valid; s0 += kTile) {
      const int n = min(kTile, valid - s0);
      load_kv_tile(sm, kp, vp, ks, vs, blk, s0, n, bs, Kh, h, D);
      __syncthreads();
      attend_tile<false>(sm, n, rows, D, m, l, acc, rseg, rpos, ranc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows)
      store_row(out + (qrow + h * G + r) * D, D, l[rr], acc[rr]);
  }
}

// ------------------------------------------------------------ dispatch --

template <typename QT, typename KT>
static void launch_decode(const void* q, const void* kp, const void* vp,
                          const int* block_tables, const int* lengths,
                          const float* ks, const float* vs, void* out, int B,
                          int H, int Kh, int D, int bs, int NB, float scale,
                          cudaStream_t stream) {
  dim3 grid(B, Kh);
  paged_decode_kernel<QT, KT>
      <<<grid, kThreads, smem_bytes(H / Kh, D), stream>>>(
          static_cast<const QT*>(q), static_cast<const KT*>(kp),
          static_cast<const KT*>(vp), block_tables, lengths, ks, vs,
          static_cast<QT*>(out), H, Kh, D, bs, NB, scale);
}

#define SPIN_KV_SWITCH(QT, CALL)                                  \
  switch (kv_dtype) {                                             \
    case kF32: CALL(QT, float); break;                            \
    case kBF16: CALL(QT, __nv_bfloat16); break;                   \
    case kI8: CALL(QT, int8_t); break;                            \
    case kFP8: CALL(QT, __nv_fp8_e4m3); break;                    \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }

}  // namespace spin

// q (B, H, D) f32/bf16; pools (N, bs, Kh, D) f32/bf16/int8/fp8;
// block_tables (B, NB), < 0 = unallocated; lengths (B,); ks/vs (N, bs, Kh)
// f32 or null; out like q.  Returns cudaGetLastError() after the launch.
extern "C" int spin_paged_decode_attention(
    const void* q, const void* k_pool, const void* v_pool,
    const int* block_tables, const int* lengths, const float* k_scale,
    const float* v_scale, void* out, int B, int H, int Kh, int D, int bs,
    int NB, int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace spin;
  if (B <= 0 || Kh <= 0 || H % Kh != 0 || D <= 0 || D > kMaxD ||
      H / Kh > kMaxRows || bs <= 0 || NB < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPIN_DECODE(QT, KT)                                                 \
  launch_decode<QT, KT>(q, k_pool, v_pool, block_tables, lengths, k_scale, \
                        v_scale, out, B, H, Kh, D, bs, NB, scale, st)
  if (q_dtype == kF32) {
    SPIN_KV_SWITCH(float, SPIN_DECODE)
  } else if (q_dtype == kBF16) {
    SPIN_KV_SWITCH(__nv_bfloat16, SPIN_DECODE)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_DECODE
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
    int bs, int M, int BQ, int per_run, int runs, int wpt, int stages,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  return spin::verify_runs(q, k_pool, v_pool, pool_seg, pool_pos, q_seg,
                           q_pos, q_anc, block_ids, block_owner, block_node,
                           k_scale, v_scale, pm, pl, pacc, counters, out, Tq,
                           H, Kh, D, bs, M, BQ, per_run, runs, wpt, stages,
                           q_dtype, kv_dtype, scale, stream);
}
