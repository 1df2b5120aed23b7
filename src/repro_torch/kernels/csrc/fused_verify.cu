// fused_paged_verify: SPIN's packed verification (Eq. 13) streaming K/V
// straight from the paged block pool.
//
// Replaces the TPU kernel src/repro/kernels/fused_verify.py
// (_fused_verify_kernel, :43-134; wrapper fused_paged_verify, :139).
//
// What bounds it: the KV bytes.  Every query row of the cohort is scored
// once against the live blocks of its own request; the work per KV byte is
// a few multiply-adds per query token of the tile, far below the ~295
// operations per byte at which the H100's tensor cores would be the limit.
// So the least time is the live K/V (plus scales) read once over 3.35 TB/s.
//
// What the design does about it: one CTA per (query tile, kv head) holds
// the tile's GQA rows and reads each block's K/V tile for its head once
// into shared memory, shared by all rows of the tile; blocks whose owning
// segment lies outside the tile's [min q_seg, max q_seg] and padding
// entries (owner < 0) are skipped before any KV byte is read, so a tile
// reads only the blocks of the requests it verifies.  int8/fp8 pools are
// dequantized on the way into shared memory.  Each block is read once per
// query tile that covers its request; the wrapper sizes the tiles so the
// grid holds about two CTAs per SM, since at the serving path's short
// contexts the kernel is latency-bound, not byte-bound.  Not done yet:
// wgmma/TMA, double buffering of the tile loads, packing two 16-slot
// blocks into one 32-slot tile.
#include "paged_common.cuh"

namespace spin {

template <typename QT, typename KT, bool kTree>
__global__ void __launch_bounds__(kThreads)
    fused_verify_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                        const KT* __restrict__ vp,
                        const int* __restrict__ pool_seg,
                        const int* __restrict__ pool_pos,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ q_anc,
                        const int* __restrict__ block_ids,
                        const int* __restrict__ block_owner,
                        const int* __restrict__ block_node,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs, QT* __restrict__ out,
                        int Tq, int H, int Kh, int D, int bs, int M, int BQ,
                        float scale) {
  extern __shared__ float smem_raw[];
  const int G = H / Kh;
  const int h = blockIdx.y;
  const int t0 = blockIdx.x * BQ;
  const int nq = min(BQ, Tq - t0);
  const int rows = nq * G;
  const Smem sm = carve_smem(smem_raw, BQ * G, D);

  // queries of the tile: row r = (token t0 + r / G, head h * G + r % G)
  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    const int t = t0 + r / G;
    const int head = h * G + r % G;
    sm.q[e] = to_f32(q[(static_cast<long long>(t) * H + head) * D + d]) * scale;
  }
  // the tile's segment range (the TPU kernel's block-skip test)
  int q_lo = 0x7fffffff, q_hi = -0x7fffffff;
  for (int i = 0; i < nq; ++i) {
    q_lo = min(q_lo, q_seg[t0 + i]);
    q_hi = max(q_hi, q_seg[t0 + i]);
  }
  const int warp = threadIdx.x >> 5;
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
  __syncthreads();

  for (int mi = 0; mi < M; ++mi) {
    const int owner = block_owner[mi];
    // padding entries and other requests' blocks: no KV byte is read
    if (owner < 0 || owner < q_lo || owner > q_hi) continue;
    const long long blk = max(block_ids[mi], 0);
    for (int s0 = 0; s0 < bs; s0 += kTile) {
      const int n = min(kTile, bs - s0);
      load_kv_tile(sm, kp, vp, ks, vs, blk, s0, n, bs, Kh, h, D);
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const long long slot = blk * bs + s0 + j;
        // a slot is attendable iff its block is live and it holds
        // committed/accepted KV (pool seg >= 0)
        sm.seg[j] = pool_seg[slot] >= 0 ? owner : -1;
        sm.pos[j] = pool_pos[slot];
        sm.node[j] = kTree ? block_node[static_cast<long long>(mi) * bs + s0 + j]
                           : -1;
      }
      __syncthreads();
      attend_tile<kTree>(sm, n, rows, D, m, l, acc, rseg, rpos, ranc);
      __syncthreads();
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows) {
      const int t = t0 + r / G;
      const int head = h * G + r % G;
      store_row(out + (static_cast<long long>(t) * H + head) * D, D, l[rr],
                acc[rr]);
    }
  }
}

template <typename QT, typename KT>
static void launch(const void* q, const void* kp, const void* vp,
                   const int* pool_seg, const int* pool_pos, const int* q_seg,
                   const int* q_pos, const int* q_anc, const int* block_ids,
                   const int* block_owner, const int* block_node,
                   const float* ks, const float* vs, void* out, int Tq, int H,
                   int Kh, int D, int bs, int M, int BQ, float scale,
                   cudaStream_t stream) {
  const int G = H / Kh;
  dim3 grid((Tq + BQ - 1) / BQ, Kh);
  const size_t smem = smem_bytes(BQ * G, D);
  const bool tree = block_node != nullptr;
#define SPIN_VERIFY_ARGS                                                     \
  static_cast<const QT*>(q), static_cast<const KT*>(kp),                     \
      static_cast<const KT*>(vp), pool_seg, pool_pos, q_seg, q_pos, q_anc,   \
      block_ids, block_owner, block_node, ks, vs, static_cast<QT*>(out), Tq, \
      H, Kh, D, bs, M, BQ, scale
  if (tree)
    fused_verify_kernel<QT, KT, true>
        <<<grid, kThreads, smem, stream>>>(SPIN_VERIFY_ARGS);
  else
    fused_verify_kernel<QT, KT, false>
        <<<grid, kThreads, smem, stream>>>(SPIN_VERIFY_ARGS);
#undef SPIN_VERIFY_ARGS
}

template <typename QT>
static int dispatch_kv(int kv_dtype, const void* q, const void* kp,
                       const void* vp, const int* pool_seg,
                       const int* pool_pos, const int* q_seg, const int* q_pos,
                       const int* q_anc, const int* block_ids,
                       const int* block_owner, const int* block_node,
                       const float* ks, const float* vs, void* out, int Tq,
                       int H, int Kh, int D, int bs, int M, int BQ,
                       float scale, cudaStream_t stream) {
#define SPIN_ARGS                                                           \
  q, kp, vp, pool_seg, pool_pos, q_seg, q_pos, q_anc, block_ids,            \
      block_owner, block_node, ks, vs, out, Tq, H, Kh, D, bs, M, BQ, scale, \
      stream
  switch (kv_dtype) {
    case kF32: launch<QT, float>(SPIN_ARGS); break;
    case kBF16: launch<QT, __nv_bfloat16>(SPIN_ARGS); break;
    case kI8: launch<QT, int8_t>(SPIN_ARGS); break;
    case kFP8: launch<QT, __nv_fp8_e4m3>(SPIN_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_ARGS
  return 0;
}

}  // namespace spin

// q (Tq, H, D) f32/bf16; pools (N, bs, Kh, D); pool_seg/pool_pos (N, bs);
// q_seg/q_pos (Tq,); q_anc (Tq,) or null; block_ids/block_owner (M,);
// block_node (M, bs) or null; ks/vs (N, bs, Kh) f32 or null; out like q.
// Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spin_fused_paged_verify(
    const void* q, const void* k_pool, const void* v_pool, const int* pool_seg,
    const int* pool_pos, const int* q_seg, const int* q_pos, const int* q_anc,
    const int* block_ids, const int* block_owner, const int* block_node,
    const float* k_scale, const float* v_scale, void* out, int Tq, int H,
    int Kh, int D, int bs, int M, int BQ, int q_dtype, int kv_dtype,
    float scale, void* stream) {
  using namespace spin;
  if (Tq <= 0 || Kh <= 0 || H % Kh != 0 || D <= 0 || D > kMaxD || BQ <= 0 ||
      BQ * (H / Kh) > kMaxRows || (q_anc == nullptr) != (block_node == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == kF32)
    rc = dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, pool_seg, pool_pos,
                            q_seg, q_pos, q_anc, block_ids, block_owner,
                            block_node, k_scale, v_scale, out, Tq, H, Kh, D,
                            bs, M, BQ, scale, st);
  else if (q_dtype == kBF16)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, pool_seg,
                                    pool_pos, q_seg, q_pos, q_anc, block_ids,
                                    block_owner, block_node, k_scale, v_scale,
                                    out, Tq, H, Kh, D, bs, M, BQ, scale, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
