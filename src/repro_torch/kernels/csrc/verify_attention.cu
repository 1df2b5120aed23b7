// verify_attention: SPIN's dense packed verification (Eq. 13) over one flat
// KV buffer whose slots are tagged with (segment, position, tree node).
//
// Replaces the TPU kernel src/repro/kernels/verify_attention.py (_kernel,
// :37-122; wrapper verify_attention, :125).  The dense KV layout's packed
// verify (core/decompose.make_attn_override) calls it once per LLM layer
// on [packed KV ; new KV].
//
// What bounds it: the KV bytes.  Each query row is scored against the
// slots of its own segment only; the work per KV byte is a few
// multiply-adds per query token of the tile, far below the ~295 operations
// per byte at which the H100's tensor cores would be the limit.  So the
// least time is the K/V of the attended segments (plus the tags) read once
// over 3.35 TB/s.
//
// What the design does about it: one CTA per (query tile, kv head) holds
// the tile's GQA rows and walks the flat buffer in 32-slot tiles.  Warp 0
// first reads a tile's tags and reduces its [min valid seg, max seg]; a
// tile that cannot meet the query tile's [min q_seg, max q_seg] (the TPU
// kernel's block skip, computed from the tags because the buffer may be
// interleaved) is skipped before any K/V byte is read, and so is a tile of
// padding cells only (seg -1).  A live tile's K/V enter shared memory once
// for all rows of the CTA.  The ragged last tile is masked in the kernel:
// no pad copy of K/V on the host.  Not done yet: wgmma/TMA, double
// buffering of the tile loads.
#include <climits>

#include "paged_common.cuh"

namespace spin {

template <typename QT, typename KT, bool kTree>
__global__ void __launch_bounds__(kThreads)
    verify_attention_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                            const KT* __restrict__ v,
                            const int* __restrict__ q_seg,
                            const int* __restrict__ q_pos,
                            const int* __restrict__ q_anc,
                            const int* __restrict__ kv_seg,
                            const int* __restrict__ kv_pos,
                            const int* __restrict__ kv_node,
                            QT* __restrict__ out, int Tq, int Tkv, int H,
                            int Kh, int D, int BQ, float scale) {
  extern __shared__ float smem_raw[];
  __shared__ int tile_live;
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
  int q_lo = INT_MAX, q_hi = INT_MIN;
  for (int i = 0; i < nq; ++i) {
    q_lo = min(q_lo, q_seg[t0 + i]);
    q_hi = max(q_hi, q_seg[t0 + i]);
  }
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
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

  for (int s0 = 0; s0 < Tkv; s0 += kTile) {
    const int n = min(kTile, Tkv - s0);
    if (warp == 0) {
      int sg = -1, ps = -1, nd = -1;
      if (lane < n) {
        sg = kv_seg[s0 + lane];
        ps = kv_pos[s0 + lane];
        if (kTree) nd = kv_node[s0 + lane];
      }
      sm.seg[lane] = sg;
      sm.pos[lane] = ps;
      sm.node[lane] = nd;
      // padding cells (seg -1) never count toward the tile's low end, so a
      // tile of padding only has lo = INT_MAX and is skipped
      const int lo = warp_min_int(sg >= 0 ? sg : INT_MAX);
      const int hi = warp_max_int(sg);
      if (lane == 0) tile_live = hi >= q_lo && lo <= q_hi;
    }
    __syncthreads();  // tags, tile_live (and the queries, first time)
    if (tile_live) {  // block-uniform
      load_kv_tile(sm, k, v, static_cast<const float*>(nullptr),
                   static_cast<const float*>(nullptr), 0, s0, n, 0, Kh, h, D);
      __syncthreads();
      attend_tile<kTree>(sm, n, rows, D, m, l, acc, rseg, rpos, ranc);
    }
    __syncthreads();  // every thread has read tile_live and the tile
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
static void launch(const void* q, const void* k, const void* v,
                   const int* q_seg, const int* q_pos, const int* q_anc,
                   const int* kv_seg, const int* kv_pos, const int* kv_node,
                   void* out, int Tq, int Tkv, int H, int Kh, int D, int BQ,
                   float scale, cudaStream_t stream) {
  const int G = H / Kh;
  dim3 grid((Tq + BQ - 1) / BQ, Kh);
  const size_t smem = smem_bytes(BQ * G, D);
#define SPIN_VA_ARGS                                                       \
  static_cast<const QT*>(q), static_cast<const KT*>(k),                    \
      static_cast<const KT*>(v), q_seg, q_pos, q_anc, kv_seg, kv_pos,      \
      kv_node, static_cast<QT*>(out), Tq, Tkv, H, Kh, D, BQ, scale
  if (kv_node != nullptr)
    verify_attention_kernel<QT, KT, true>
        <<<grid, kThreads, smem, stream>>>(SPIN_VA_ARGS);
  else
    verify_attention_kernel<QT, KT, false>
        <<<grid, kThreads, smem, stream>>>(SPIN_VA_ARGS);
#undef SPIN_VA_ARGS
}

template <typename QT>
static int dispatch_kv(int kv_dtype, const void* q, const void* k,
                       const void* v, const int* q_seg, const int* q_pos,
                       const int* q_anc, const int* kv_seg, const int* kv_pos,
                       const int* kv_node, void* out, int Tq, int Tkv, int H,
                       int Kh, int D, int BQ, float scale,
                       cudaStream_t stream) {
#define SPIN_ARGS                                                        \
  q, k, v, q_seg, q_pos, q_anc, kv_seg, kv_pos, kv_node, out, Tq, Tkv, H, \
      Kh, D, BQ, scale, stream
  switch (kv_dtype) {
    case kF32: launch<QT, float>(SPIN_ARGS); break;
    case kBF16: launch<QT, __nv_bfloat16>(SPIN_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_ARGS
  return 0;
}

}  // namespace spin

// q (Tq, H, D) f32/bf16; k, v (Tkv, Kh, D) f32/bf16; q_seg/q_pos (Tq,);
// q_anc (Tq,) or null; kv_seg/kv_pos (Tkv,); kv_node (Tkv,) or null; out
// like q.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spin_verify_attention(
    const void* q, const void* k, const void* v, const int* q_seg,
    const int* q_pos, const int* q_anc, const int* kv_seg, const int* kv_pos,
    const int* kv_node, void* out, int Tq, int Tkv, int H, int Kh, int D,
    int BQ, int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace spin;
  if (Tq <= 0 || Tkv < 0 || Kh <= 0 || H % Kh != 0 || D <= 0 ||
      D > kMaxD || BQ <= 0 || BQ * (H / Kh) > kMaxRows ||
      (q_anc == nullptr) != (kv_node == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == kF32)
    rc = dispatch_kv<float>(kv_dtype, q, k, v, q_seg, q_pos, q_anc, kv_seg,
                            kv_pos, kv_node, out, Tq, Tkv, H, Kh, D, BQ, scale,
                            st);
  else if (q_dtype == kBF16)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, q_seg, q_pos, q_anc,
                                    kv_seg, kv_pos, kv_node, out, Tq, Tkv, H,
                                    Kh, D, BQ, scale, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
