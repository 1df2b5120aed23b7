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
// over 3.35 TB/s.  At serving sizes the buffer is a few hundred slots and
// the time is latency: the design keeps every CTA's chain of dependent
// memory round trips short.
//
// What the design does about it: split-KV.  The TPU kernel's KV grid axis
// (a sequential walk with a block skip) becomes parallel CTAs: one CTA
// per (query tile, kv head, run of 32-slot tiles).  A CTA reads the tags
// of four tiles at once (one slot per thread), each warp reducing its
// tile's [min valid seg, max seg]; a tile that cannot meet the query
// tile's [min q_seg, max q_seg] (the buffer may be interleaved), or holds
// padding cells only (seg -1), is skipped before any K/V byte is read.
// The dense plan lays each request into 128-cell rows (4 tiles), mostly
// padding at serving lengths, so most CTAs read one round of tags and
// exit.  A live tile's K/V enter shared memory once for all rows of the
// CTA by 16-byte loads in the stored dtype (paged_common.cuh).  Each CTA
// writes an unnormalised partial (m, l, acc) per row (l = 0: attended
// nothing); merge_partials_kernel (paged_common.cuh) combines the runs.
// The wrapper (kernels/verify_attention.py, split_plan) sizes the runs and
// the query tile (small: a warp scores its rows one after another).
// Every load that waits on no decision (the first pass of tags, the
// queries, their tags) is issued before the first reduction.  The ragged
// last tile is masked in the kernel: no pad copy of K/V on the host.  CUDA
// cores: a CTA holds at most 16 query rows.
#include <climits>

#include "paged_common.cuh"

namespace spin {

// Partials of run z, query token t, head: pm/pl [(z * Tq + t) * H + head],
// pacc [((z * Tq + t) * H + head) * D + d], all float32.
template <typename QT, typename KT, bool kTree>
__global__ void __launch_bounds__(kThreads)
    verify_partial_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                          const KT* __restrict__ v,
                          const int* __restrict__ q_seg,
                          const int* __restrict__ q_pos,
                          const int* __restrict__ q_anc,
                          const int* __restrict__ kv_seg,
                          const int* __restrict__ kv_pos,
                          const int* __restrict__ kv_node,
                          float* __restrict__ pm, float* __restrict__ pl,
                          float* __restrict__ pacc, int Tq, int Tkv, int H,
                          int Kh, int D, int BQ, int tiles_per_run,
                          float scale) {
  extern __shared__ float smem_raw[];
  __shared__ int gseg[kThreads], gpos[kThreads], gnode[kThreads];
  __shared__ int live[kWarps];
  const int G = H / Kh;
  const int h = blockIdx.y;
  const int run = blockIdx.z;
  const int t0 = blockIdx.x * BQ;
  const int nq = min(BQ, Tq - t0);
  const int rows = nq * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int tile_lo = run * tiles_per_run;
  const int tile_hi = min((Tkv + kTile - 1) / kTile, tile_lo + tiles_per_run);
  const Smem sm = carve_smem(smem_raw, BQ * G, D);

  // Every load that does not wait on a decision goes out first, so they
  // share one memory latency: the first pass of tags, the query tile's
  // segment range (a lane per token), the rows' tags and the queries.
  const int n_tiles_run = tile_hi - tile_lo;
  int sg, ps, nd;                    // this thread's slot of the next pass
  auto read_tags = [&](int g0) {
    const int slot = g0 * kTile + threadIdx.x;
    sg = ps = nd = -1;
    if (g0 + warp < tile_hi && slot < Tkv) {
      sg = kv_seg[slot];
      ps = kv_pos[slot];
      if (kTree) nd = kv_node[slot];
    }
  };
  if (n_tiles_run > 0) read_tags(tile_lo);
  const int qs = lane < nq ? q_seg[t0 + lane] : 0;
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
  // the queries are read even when no tile turns out live: it costs a few
  // KB from L2 and saves a round trip on the CTAs that attend
  load_q_rows(sm.q, q, t0, rows, G, H, h, D, scale);
  const int q_lo = warp_min_int(lane < nq ? qs : INT_MAX);
  const int q_hi = warp_max_int(lane < nq ? qs : INT_MIN);

  for (int g0 = tile_lo; g0 < tile_hi; g0 += kWarps) {
    // tags of tiles g0 .. g0 + 3: warp w holds tile g0 + w, a slot a lane
    gseg[threadIdx.x] = sg;
    gpos[threadIdx.x] = ps;
    gnode[threadIdx.x] = nd;
    // padding cells (seg -1) never count toward the tile's low end, so a
    // tile of padding only has lo = INT_MAX and is skipped
    const int lo = warp_min_int(sg >= 0 ? sg : INT_MAX);
    const int hi = warp_max_int(sg);
    if (lane == 0) live[warp] = hi >= q_lo && lo <= q_hi;
    __syncthreads();                 // tags, live flags (queries, first time)
    if (g0 + kWarps < tile_hi) read_tags(g0 + kWarps);
    for (int w = 0; w < kWarps; ++w) {
      if (!live[w]) continue;        // block-uniform
      const int s0 = (g0 + w) * kTile;
      const int n = min(kTile, Tkv - s0);
      load_kv_tile(sm, k, v, static_cast<const float*>(nullptr),
                   static_cast<const float*>(nullptr), 0, s0, n, 0, Kh, h, D);
      __syncthreads();               // K/V
      Smem tile = sm;
      tile.seg = gseg + w * kTile;
      tile.pos = gpos + w * kTile;
      tile.node = gnode + w * kTile;
      attend_tile<kTree>(tile, n, rows, D, m, l, acc, rseg, rpos, ranc);
      __syncthreads();               // the tile is consumed
    }
    __syncthreads();                 // every thread has read the live flags
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows) {                  // warp-uniform, and so is l
      const long long o =
          (static_cast<long long>(run) * Tq + t0 + r / G) * H + h * G + r % G;
      if (lane == 0) {
        pm[o] = m[rr];
        pl[o] = l[rr];
      }
      if (l[rr] > 0.f) {
#pragma unroll
        for (int i = 0; i < kDimPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) pacc[o * D + d] = acc[rr][i];
        }
      }
    }
  }
}

template <typename QT, typename KT>
static void launch(const void* q, const void* k, const void* v,
                   const int* q_seg, const int* q_pos, const int* q_anc,
                   const int* kv_seg, const int* kv_pos, const int* kv_node,
                   float* pm, float* pl, float* pacc, void* out, int Tq,
                   int Tkv, int H, int Kh, int D, int BQ, int tiles_per_run,
                   int runs, float scale, cudaStream_t stream) {
  const int G = H / Kh;
  if (runs > 0) {
    const dim3 grid((Tq + BQ - 1) / BQ, Kh, runs);
    const size_t smem = smem_bytes(BQ * G, D);
    auto kernel = kv_node != nullptr ? verify_partial_kernel<QT, KT, true>
                                     : verify_partial_kernel<QT, KT, false>;
    kernel<<<grid, kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(k),
        static_cast<const KT*>(v), q_seg, q_pos, q_anc, kv_seg, kv_pos,
        kv_node, pm, pl, pacc, Tq, Tkv, H, Kh, D, BQ, tiles_per_run, scale);
  }
  merge_partials(pm, pl, pacc, static_cast<QT*>(out), Tq, H, D, runs,
                 stream);
}

}  // namespace spin

// q (Tq, H, D) f32/bf16; k, v (Tkv, Kh, D) f32/bf16; q_seg/q_pos (Tq,);
// q_anc (Tq,) or null; kv_seg/kv_pos (Tkv,); kv_node (Tkv,) or null;
// pm/pl (runs, Tq, H) and pacc (runs, Tq, H, D) float32 scratch; out like
// q.  Run z covers the 32-slot tiles [z * tiles_per_run, (z + 1) *
// tiles_per_run); runs = ceil(tiles / tiles_per_run).  Two launches
// (partials, merge).  Returns cudaGetLastError() after them (0 =
// launched).
extern "C" int spin_verify_attention(
    const void* q, const void* k, const void* v, const int* q_seg,
    const int* q_pos, const int* q_anc, const int* kv_seg, const int* kv_pos,
    const int* kv_node, float* pm, float* pl, float* pacc, void* out, int Tq,
    int Tkv, int H, int Kh, int D, int BQ, int tiles_per_run, int runs,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace spin;
  const int tiles = Tkv > 0 ? (Tkv + kTile - 1) / kTile : 0;
  if (Tq <= 0 || Tkv < 0 || Kh <= 0 || H % Kh != 0 || D <= 0 ||
      D > kMaxD || BQ <= 0 || BQ * (H / Kh) > kMaxRows ||
      tiles_per_run <= 0 || runs < 0 || runs > 65535 ||
      (tiles + tiles_per_run - 1) / tiles_per_run != runs ||
      (q_anc == nullptr) != (kv_node == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define SPIN_VA(QT, KT)                                                     \
  launch<QT, KT>(q, k, v, q_seg, q_pos, q_anc, kv_seg, kv_pos, kv_node, pm, \
                 pl, pacc, out, Tq, Tkv, H, Kh, D, BQ, tiles_per_run, runs, \
                 scale, st)
#define SPIN_KV(QT)                                                \
  switch (kv_dtype) {                                              \
    case kF32: SPIN_VA(QT, float); break;                          \
    case kBF16: SPIN_VA(QT, __nv_bfloat16); break;                 \
    default: return static_cast<int>(cudaErrorInvalidValue);       \
  }
  if (q_dtype == kF32) {
    SPIN_KV(float)
  } else if (q_dtype == kBF16) {
    SPIN_KV(__nv_bfloat16)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_KV
#undef SPIN_VA
  return static_cast<int>(cudaGetLastError());
}
