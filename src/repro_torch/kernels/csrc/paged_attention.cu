// paged_attention: the unfused paged attention kernels.
//
// paged_decode_attention replaces the TPU kernel
// src/repro/kernels/paged_attention.py (_decode_kernel, :56-108; wrapper
// paged_decode_attention, :111): one query token per row against the row's
// block table, slots valid iff their logical position is below lengths[b].
//
// paged_verify_attention replaces (_verify_kernel, :178-260; wrapper
// paged_verify_attention, :263): SPIN's packed verification (Eq. 13) over
// a list of live blocks, the same function and masks as fused_verify.cu
// (segment, causality, tree tags), with one live block per KV step.
//
// Both are public through kernels/ops.py; the serving engine takes the
// fused kernels instead.  Both dequantize int8/fp8 blocks with the
// per-(slot, head) scale on the way into shared memory (paged_common.cuh).
//
// What bounds them: the KV bytes.  A few multiply-adds per K/V element
// against the H100's ~295 operations per byte, so the least time is the
// attended blocks' K/V (plus scales and tags) read once over 3.35 TB/s.
//
// What the designs do about it.
// - decode: one CTA per (row, kv head) holds the GQA group's heads and
//   walks the row's live logical blocks, j < ceil(lengths[b] / bs), each
//   slot read once for all heads; the table's unallocated tail (< 0) and
//   the slots past the length are never read.
// - verify is split-KV (flash-decoding), the Hopper reading of the TPU
//   grid over (query tile, live block): one CTA per (query tile, kv head,
//   block entry) scores the tile against that one block and writes an
//   unnormalised partial (running max m, sum l, accumulator) to scratch; a
//   second kernel, one warp per (query token, head), merges the partials
//   of every entry with the usual rescaling (merge_partials_kernel,
//   paged_common.cuh).  An entry whose owner is a
//   padding entry (-1) or lies outside the tile's [min q_seg, max q_seg]
//   writes l = 0 and reads no K/V byte; the merge skips it.  So the work
//   spreads over M x more CTAs than fused_verify.cu at the price of the
//   partials' round trip through memory.  Not done yet: wgmma/TMA,
//   splitting decode rows across CTAs.
#include <climits>

#include "paged_common.cuh"

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

// ---------------------------------------------------------------- verify --

// Partials of entry m, query token t, head: pm/pl [(m * Tq + t) * H + head],
// pacc [((m * Tq + t) * H + head) * D + d], all float32.
template <typename QT, typename KT, bool kTree>
__global__ void __launch_bounds__(kThreads)
    paged_verify_partial_kernel(
        const QT* __restrict__ q, const KT* __restrict__ kp,
        const KT* __restrict__ vp, const int* __restrict__ pool_seg,
        const int* __restrict__ pool_pos, const int* __restrict__ q_seg,
        const int* __restrict__ q_pos, const int* __restrict__ q_anc,
        const int* __restrict__ block_ids,
        const int* __restrict__ block_owner,
        const int* __restrict__ block_node, const float* __restrict__ ks,
        const float* __restrict__ vs, float* __restrict__ pm,
        float* __restrict__ pl, float* __restrict__ pacc, int Tq, int H,
        int Kh, int D, int bs, int BQ, float scale) {
  extern __shared__ float smem_raw[];
  const int G = H / Kh;
  const int h = blockIdx.y;
  const int mi = blockIdx.z;
  const int t0 = blockIdx.x * BQ;
  const int nq = min(BQ, Tq - t0);
  const int rows = nq * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;

  int q_lo = INT_MAX, q_hi = INT_MIN;
  for (int i = 0; i < nq; ++i) {
    q_lo = min(q_lo, q_seg[t0 + i]);
    q_hi = max(q_hi, q_seg[t0 + i]);
  }
  const int owner = block_owner[mi];
  if (owner < 0 || owner < q_lo || owner > q_hi) {
    // padding entry or another request's block: no KV byte is read
    for (int r = threadIdx.x; r < rows; r += blockDim.x) {
      const long long o =
          (static_cast<long long>(mi) * Tq + t0 + r / G) * H + h * G + r % G;
      pm[o] = -CUDART_INF_F;
      pl[o] = 0.f;
    }
    return;
  }

  const Smem sm = carve_smem(smem_raw, BQ * G, D);
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    const int t = t0 + r / G;
    const int head = h * G + r % G;
    sm.q[e] = to_f32(q[(static_cast<long long>(t) * H + head) * D + d]) * scale;
  }
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimPerLane];
  int rseg[kRowsPerWarp], rpos[kRowsPerWarp], ranc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    const int t = t0 + (r < rows ? r / G : 0);
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) acc[rr][i] = 0.f;
    rseg[rr] = q_seg[t];
    rpos[rr] = q_pos[t];
    ranc[rr] = kTree ? q_anc[t] : -1;
  }
  const long long blk = max(block_ids[mi], 0);
  for (int s0 = 0; s0 < bs; s0 += kTile) {
    const int n = min(kTile, bs - s0);
    load_kv_tile(sm, kp, vp, ks, vs, blk, s0, n, bs, Kh, h, D);
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      const long long slot = blk * bs + s0 + j;
      // attendable iff the slot holds committed/accepted KV (seg >= 0)
      sm.seg[j] = pool_seg[slot] >= 0 ? owner : -1;
      sm.pos[j] = pool_pos[slot];
      sm.node[j] =
          kTree ? block_node[static_cast<long long>(mi) * bs + s0 + j] : -1;
    }
    __syncthreads();
    attend_tile<kTree>(sm, n, rows, D, m, l, acc, rseg, rpos, ranc);
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows) {
      const long long o =
          (static_cast<long long>(mi) * Tq + t0 + r / G) * H + h * G + r % G;
      if (lane == 0) {
        pm[o] = m[rr];
        pl[o] = l[rr];
      }
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) pacc[o * D + d] = acc[rr][i];
      }
    }
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

template <typename QT, typename KT>
static void launch_verify(const void* q, const void* kp, const void* vp,
                          const int* pool_seg, const int* pool_pos,
                          const int* q_seg, const int* q_pos, const int* q_anc,
                          const int* block_ids, const int* block_owner,
                          const int* block_node, const float* ks,
                          const float* vs, float* pm, float* pl, float* pacc,
                          void* out, int Tq, int H, int Kh, int D, int bs,
                          int M, int BQ, float scale, cudaStream_t stream) {
  const int G = H / Kh;
  if (M > 0) {
    dim3 grid((Tq + BQ - 1) / BQ, Kh, M);
    const size_t smem = smem_bytes(BQ * G, D);
#define SPIN_PV_ARGS                                                        \
  static_cast<const QT*>(q), static_cast<const KT*>(kp),                    \
      static_cast<const KT*>(vp), pool_seg, pool_pos, q_seg, q_pos, q_anc,  \
      block_ids, block_owner, block_node, ks, vs, pm, pl, pacc, Tq, H, Kh, \
      D, bs, BQ, scale
    if (block_node != nullptr)
      paged_verify_partial_kernel<QT, KT, true>
          <<<grid, kThreads, smem, stream>>>(SPIN_PV_ARGS);
    else
      paged_verify_partial_kernel<QT, KT, false>
          <<<grid, kThreads, smem, stream>>>(SPIN_PV_ARGS);
#undef SPIN_PV_ARGS
  }
  merge_partials(pm, pl, pacc, static_cast<QT*>(out), Tq, H, D, M, stream);
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

// q (Tq, H, D) f32/bf16; pools (N, bs, Kh, D); pool_seg/pool_pos (N, bs);
// q_seg/q_pos (Tq,); q_anc (Tq,) or null; block_ids/block_owner (M,);
// block_node (M, bs) or null; ks/vs (N, bs, Kh) f32 or null; pm/pl
// (M, Tq, H) and pacc (M, Tq, H, D) float32 scratch; out like q.  Two
// launches (partials, merge).  Returns cudaGetLastError() after them.
extern "C" int spin_paged_verify_attention(
    const void* q, const void* k_pool, const void* v_pool, const int* pool_seg,
    const int* pool_pos, const int* q_seg, const int* q_pos, const int* q_anc,
    const int* block_ids, const int* block_owner, const int* block_node,
    const float* k_scale, const float* v_scale, float* pm, float* pl,
    float* pacc, void* out, int Tq, int H, int Kh, int D, int bs, int M,
    int BQ, int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace spin;
  if (Tq <= 0 || Kh <= 0 || H % Kh != 0 || D <= 0 || D > kMaxD || BQ <= 0 ||
      BQ * (H / Kh) > kMaxRows || bs <= 0 || M < 0 ||
      (q_anc == nullptr) != (block_node == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPIN_VERIFY(QT, KT)                                                \
  launch_verify<QT, KT>(q, k_pool, v_pool, pool_seg, pool_pos, q_seg,     \
                        q_pos, q_anc, block_ids, block_owner, block_node, \
                        k_scale, v_scale, pm, pl, pacc, out, Tq, H, Kh, D, \
                        bs, M, BQ, scale, st)
  if (q_dtype == kF32) {
    SPIN_KV_SWITCH(float, SPIN_VERIFY)
  } else if (q_dtype == kBF16) {
    SPIN_KV_SWITCH(__nv_bfloat16, SPIN_VERIFY)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_VERIFY
  return static_cast<int>(cudaGetLastError());
}
