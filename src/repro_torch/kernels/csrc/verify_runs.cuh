// The run-of-entries packed verify, shared by two entries:
// spin_fused_paged_verify (fused_verify.cu; the serving path's LLM verify,
// kernels/fused_verify.py) and spin_paged_verify_attention
// (paged_attention.cu; kernels/ops.py).  Both compute SPIN's packed
// verification (Eq. 13) over a list of live pool blocks: segment,
// causality and tree masks, int8/fp8 blocks dequantized with the
// per-(slot, head) scale.
//
// What bounds it on the H100: the least time is the attended blocks' K/V
// (plus scales and tags) read once over 3.35 TB/s -- a few multiply-adds
// per K/V element against the ~295 operations per byte at which the
// tensor cores would be the limit.  At serving lengths that is under a
// microsecond; a call costs its chain of dependent memory round trips and
// its idle lanes, not bytes or arithmetic.  So no tensor cores
// (mma.sync/wgmma): a CTA scores 1-16 query rows against 32-slot tiles.
//
// What the design does about it: one launch over (query tile, kv head,
// run of consecutive block entries); the wrappers' run_plan
// (kernels/paged_attention.py) sizes them, about two CTAs per SM.  The CTA
// issues every load that waits on nothing at once (the run's owners and
// block ids, the tile's q_seg by one warp read, the rows' tags, the
// queries through QRows' two steps, stored once the tiles are requested),
// keeps the entries whose owner lies in the tile's [min q_seg, max q_seg]
// (in list order, by ballot: owners need not be sorted; a run with none
// exits before it reads a K/V byte), and streams their slots as 32-slot
// tiles (two 16-slot blocks per tile, so every lane scores; each slot
// tagged with its own block's owner, so blocks of different requests share
// a tile) through tile_pipeline.cuh: teams of warps own shares of the
// tiles, the next tiles in flight by cp.async while one is scored.  With
// one run per (tile, head) the CTA writes the output; with more, each run
// writes an unnormalised partial (m, l, acc) to float32 scratch, and the
// last run to finish (a __threadfence, then an atomic counter per (tile,
// head), reset by that last CTA) merges them (merge_row, paged_common.cuh):
// one launch, so no call pays the start-up of a second, dependent launch
// for a merge of a few kilobytes.
#pragma once

#include <climits>

#include "paged_common.cuh"
#include "tile_pipeline.cuh"

namespace spin {

// Partials of run z, query token t, head: pm/pl [(z * Tq + t) * H + head],
// pacc [((z * Tq + t) * H + head) * D + d], all float32 (runs > 1 only).
// Shared memory: the run's live entries (entry, block, owner; per_run
// each), the queries [R][D] (float32, scaled), then the teams' stages
// (reused by merge_teams).
template <typename QT, typename KT, bool kTree, int RW>
__global__ void __launch_bounds__(kThreads)
    paged_verify_run_kernel(
        const QT* __restrict__ q, const KT* __restrict__ kp,
        const KT* __restrict__ vp, const int* __restrict__ pool_seg,
        const int* __restrict__ pool_pos, const int* __restrict__ q_seg,
        const int* __restrict__ q_pos, const int* __restrict__ q_anc,
        const int* __restrict__ block_ids,
        const int* __restrict__ block_owner,
        const int* __restrict__ block_node, const float* __restrict__ ks,
        const float* __restrict__ vs, float* __restrict__ pm,
        float* __restrict__ pl, float* __restrict__ pacc,
        int* __restrict__ counters, QT* __restrict__ out, int Tq, int H,
        int Kh, int D, int bs, int M, int BQ, int per_run, int runs, int wpt,
        int stages, float scale) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wcnt[kWarps];
  __shared__ int is_last;
  const int G = H / Kh;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int t0 = blockIdx.x * BQ;
  const int nq = min(BQ, Tq - t0);
  const int R = nq * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = warp % wpt;
  const size_t list_bytes = pipe::align16(sizeof(int) * per_run);
  int* l_ent = reinterpret_cast<int*>(smem);
  int* l_blk = reinterpret_cast<int*>(smem + list_bytes);
  int* l_own = reinterpret_cast<int*>(smem + 2 * list_bytes);
  float* sq = reinterpret_cast<float*>(smem + 3 * list_bytes);
  unsigned char* stage_base = reinterpret_cast<unsigned char*>(sq) +
                              pipe::align16(sizeof(float) * BQ * G * D);
  const int e0 = z * per_run;
  const int nE = max(0, min(per_run, M - e0));

  // The run's first owners and ids, the tile's q_seg (a lane per token),
  // the rows' tags and the queries go out first; the queries' conversion
  // to shared memory comes after the tiles' requests.
  pipe::QRows<QT> qf;
  qf.fetch(q, t0, R, G, H, h, D);
  int own = -1, id = 0;
  if (static_cast<int>(threadIdx.x) < nE) {
    own = block_owner[e0 + threadIdx.x];
    id = block_ids[e0 + threadIdx.x];
  }
  const int qs = lane < nq ? q_seg[t0 + lane] : 0;
  pipe::Rows<RW> w;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = k0 + wpt * rr;
    const int t = t0 + (r < R ? r / G : 0);
    w.m[rr] = -CUDART_INF_F;
    w.l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) w.acc[rr][i] = 0.f;
    w.seg[rr] = q_seg[t];
    w.pos[rr] = q_pos[t];
    w.anc[rr] = kTree ? q_anc[t] : -1;
  }
  const int q_lo = warp_min_int(lane < nq ? qs : INT_MAX);
  const int q_hi = warp_max_int(lane < nq ? qs : INT_MIN);

  // The run's entries whose owner may meet the tile, in list order.
  int n_live = 0;
  for (int base = 0; base < nE; base += kThreads) {
    const int e = base + static_cast<int>(threadIdx.x);
    if (base > 0) {
      own = -1;
      id = 0;
      if (e < nE) {
        own = block_owner[e0 + e];
        id = block_ids[e0 + e];
      }
    }
    const bool live = e < nE && own >= 0 && own >= q_lo && own <= q_hi;
    const unsigned bal = __ballot_sync(0xffffffffu, live);
    if (lane == 0) wcnt[warp] = __popc(bal);
    __syncthreads();
    int at = n_live + __popc(bal & ((1u << lane) - 1u));
    for (int i = 0; i < warp; ++i) at += wcnt[i];
    if (live) {
      l_ent[at] = e0 + e;
      l_blk[at] = max(id, 0);
      l_own[at] = own;
    }
    for (int i = 0; i < kWarps; ++i) n_live += wcnt[i];
    __syncthreads();  // the lists; wcnt is free again
  }
  pipe::Pool<KT> p;
  p.k = kp;
  p.v = vp;
  p.seg = pool_seg;
  p.pos = pool_pos;
  p.node = block_node;
  p.ks = ks;
  p.vs = vs;
  p.Kh = Kh;
  p.h = h;
  p.D = D;
  p.KS = pipe::k_stride(D, sizeof(KT));
  p.VS = pipe::v_stride(D, sizeof(KT));
  p.vec = (D * sizeof(KT)) % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(kp) |
            reinterpret_cast<uintptr_t>(vp)) & 15) == 0;
  const int n_slots = n_live * bs;  // 0: no K/V byte is read
  const pipe::RunMap map{l_ent, l_blk, l_own, bs};
  const pipe::Walk walk = pipe::walk_start<KT, kTree>(
      stage_base, stages, p, map, (n_slots + kTile - 1) / kTile, n_slots,
      wpt);
  if (n_live > 0) qf.store(sq, q, t0, R, G, H, h, D, scale);
  __syncthreads();  // the queries
  pipe::walk_rest<KT, kTree, true>(walk, p, map, n_slots, sq, R, wpt, w);
  pipe::merge_teams(reinterpret_cast<float*>(stage_base), wpt, R, D, w);

  if (runs == 1) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp + kWarps * rr;
      if (r < R) {
        const long long o =
            static_cast<long long>(t0 + r / G) * H + h * G + r % G;
        store_row(out + o * D, D, w.l[rr], w.acc[rr]);
      }
    }
    return;
  }
  const long long stride = static_cast<long long>(Tq) * H;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp + kWarps * rr;
    if (r < R) {  // warp-uniform, and so is l
      const long long o = static_cast<long long>(z) * stride +
                          static_cast<long long>(t0 + r / G) * H + h * G +
                          r % G;
      if (lane == 0) {
        pm[o] = w.m[rr];
        pl[o] = w.l[rr];
      }
      if (w.l[rr] > 0.f) {
#pragma unroll
        for (int i = 0; i < kDimPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) pacc[o * D + d] = w.acc[rr][i];
        }
      }
    }
  }
  // The last run of this (tile, head) to finish merges every run's
  // partial (threadFenceReduction's pattern) and resets the counter.
  __threadfence();
  __syncthreads();
  int* count = counters + static_cast<long long>(blockIdx.x) * Kh + h;
  if (threadIdx.x == 0) is_last = atomicAdd(count, 1) == runs - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp + kWarps * rr;
    if (r < R) {
      const long long row =
          static_cast<long long>(t0 + r / G) * H + h * G + r % G;
      merge_row(pm, pl, pacc, out + row * D, stride, row, D, runs);
    }
  }
  if (threadIdx.x == 0) *count = 0;
}

template <typename QT, typename KT>
static int launch_verify(const void* q, const void* kp, const void* vp,
                         const int* pool_seg, const int* pool_pos,
                         const int* q_seg, const int* q_pos, const int* q_anc,
                         const int* block_ids, const int* block_owner,
                         const int* block_node, const float* ks,
                         const float* vs, float* pm, float* pl, float* pacc,
                         int* counters, void* out, int Tq, int H, int Kh,
                         int D, int bs, int M, int BQ, int per_run, int runs,
                         int wpt, int stages, float scale,
                         cudaStream_t stream) {
  const int G = H / Kh;
  const dim3 grid((Tq + BQ - 1) / BQ, Kh, runs);
  const size_t smem =
      3 * pipe::align16(sizeof(int) * per_run) +
      pipe::align16(sizeof(float) * BQ * G * D) +
      pipe::stages_smem(kWarps / wpt, stages, BQ * G, D, sizeof(KT));
  // one row per warp runs the short code (pipe::Rows)
  const bool one = (BQ * G + wpt - 1) / wpt <= 1;
  auto kernel =
      block_node != nullptr
          ? (one ? paged_verify_run_kernel<QT, KT, true, 1>
                 : paged_verify_run_kernel<QT, KT, true, kRowsPerWarp>)
          : (one ? paged_verify_run_kernel<QT, KT, false, 1>
                 : paged_verify_run_kernel<QT, KT, false, kRowsPerWarp>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), pool_seg, pool_pos, q_seg, q_pos, q_anc,
      block_ids, block_owner, block_node, ks, vs, pm, pl, pacc, counters,
      static_cast<QT*>(out), Tq, H, Kh, D, bs, M, BQ, per_run, runs, wpt,
      stages, scale);
  return 0;
}

// Checks and dtype dispatch of one call; the arguments of both entries.
// q (Tq, H, D) f32/bf16; pools (N, bs, Kh, D) f32/bf16/int8/fp8;
// pool_seg/pool_pos (N, bs); q_seg/q_pos (Tq,); q_anc (Tq,) or null;
// block_ids/block_owner (M,); block_node (M, bs) or null; ks/vs (N, bs, Kh)
// f32 or null; out like q.  BQ query tokens per CTA; run z covers entries
// [z * per_run, (z + 1) * per_run), runs = max(1, ceil(M / per_run));
// kWarps / wpt teams of `stages` tile buffers (BQ * G rows, at most four
// per warp).  With runs > 1: pm/pl (runs, Tq, H) and pacc (runs, Tq, H, D)
// float32 scratch and counters (ceil(Tq / BQ) * Kh) int32, zero before the
// call and zero after it; with runs = 1 they may be null.  One launch.
// Returns cudaGetLastError() after it.
inline int verify_runs(const void* q, const void* k_pool, const void* v_pool,
                       const int* pool_seg, const int* pool_pos,
                       const int* q_seg, const int* q_pos, const int* q_anc,
                       const int* block_ids, const int* block_owner,
                       const int* block_node, const float* k_scale,
                       const float* v_scale, float* pm, float* pl,
                       float* pacc, int* counters, void* out, int Tq, int H,
                       int Kh, int D, int bs, int M, int BQ, int per_run,
                       int runs, int wpt, int stages, int q_dtype,
                       int kv_dtype, float scale, void* stream) {
  const int R = BQ * (Kh > 0 ? H / Kh : 0);
  if (Tq <= 0 || Kh <= 0 || H % Kh != 0 || D <= 0 || D > kMaxD || BQ <= 0 ||
      R > kMaxRows || bs <= 0 || M < 0 || per_run <= 0 || runs <= 0 ||
      runs > 65535 || runs != max(1, (M + per_run - 1) / per_run) ||
      (wpt != 1 && wpt != 2 && wpt != kWarps) || R > kRowsPerWarp * wpt ||
      stages < 1 || stages > pipe::kMaxStages ||
      (runs > 1 && (pm == nullptr || pl == nullptr || pacc == nullptr ||
                    counters == nullptr)) ||
      (q_anc == nullptr) != (block_node == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define SPIN_VERIFY(QT, KT)                                                 \
  rc = launch_verify<QT, KT>(q, k_pool, v_pool, pool_seg, pool_pos, q_seg, \
                             q_pos, q_anc, block_ids, block_owner,          \
                             block_node, k_scale, v_scale, pm, pl, pacc,    \
                             counters, out, Tq, H, Kh, D, bs, M, BQ,        \
                             per_run, runs, wpt, stages, scale, st)
#define SPIN_VERIFY_KV(QT)                                        \
  switch (kv_dtype) {                                             \
    case kF32: SPIN_VERIFY(QT, float); break;                     \
    case kBF16: SPIN_VERIFY(QT, __nv_bfloat16); break;            \
    case kI8: SPIN_VERIFY(QT, int8_t); break;                     \
    case kFP8: SPIN_VERIFY(QT, __nv_fp8_e4m3); break;             \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }
  if (q_dtype == kF32) {
    SPIN_VERIFY_KV(float)
  } else if (q_dtype == kBF16) {
    SPIN_VERIFY_KV(__nv_bfloat16)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_VERIFY_KV
#undef SPIN_VERIFY
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spin
