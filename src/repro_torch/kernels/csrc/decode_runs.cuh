// The run-of-tiles decode, shared by two entries: spin_decode_attention
// (decode_attention.cu; a dense (B, S, Kh, D) cache) and
// spin_paged_decode_attention (paged_attention.cu; a block pool read
// through each row's block table).  Both compute GQA decode, one query
// token per row against the row's live prefix of lengths[b] slots; a row
// of length 0 gives zeros.
//
// What bounds it on the H100: the KV bytes.  One query per (row, head)
// scores every live slot once: two multiply-adds per K and V element,
// about one operation per byte, far below the H100's ~295 operations per
// byte.  So the least time is each row's live prefix of K/V (plus the
// paged pool's scales and table) read once over 3.35 TB/s.  A long row at
// a small batch has the bytes to fill the card only if many CTAs share it;
// a short row costs its dependent memory round trips, and its warps must
// all have work.
//
// What the design does about it: one launch over (row, kv head, run of
// 32-slot tiles), on the tile pipeline (tile_pipeline.cuh); the wrappers
// size it with decode_attention.run_plan (kernels/decode_attention.py).
// - A CTA holds one kv head's G query rows; its run's tiles are dealt to
//   teams of warps (one row a warp: at G = 1 four teams of one warp), each
//   with its own cp.async stages, the next tiles in flight while one is
//   scored, the teams merged in shared memory.  (CTAs of several kv heads
//   of one row, one row a warp at G < 4, were measured slower on the H100:
//   a short row's K/V then crowds fewer SMs.)
// - Runs: run z covers the row's tiles [z per_run, (z + 1) per_run); the
//   plan is made over S (the host knows no length), and a CTA reads
//   lengths[b] first: a run past the live prefix min(lengths[b], S) exits
//   at once, and the slots past the length are never read (S need not be a
//   multiple of 32).
// - The row's slots come through a Row source: DenseRow maps slot c of run
//   z to slot z run_slots + c of row b (pipe::DenseMap); PagedRow copies
//   the run's slice of the row's block table into shared memory, issued
//   with the length's read, before any tile is requested, and maps slot c
//   through it (pipe::PagedRowMap), for any block size (a 32-slot tile
//   spans two 16-slot blocks, or half of a 64-slot one); int8/fp8 pools
//   bring their per-(slot, head) scales with each tile.
// - The merge in the same launch: where a row's live prefix spans one run,
//   that run writes the output (a row of length 0: zeros); with more, each
//   live run writes an unnormalised partial (m, l, acc) to float32 scratch
//   and the last to finish (a __threadfence, then an atomic counter per
//   (row, kv head), reset by that CTA) merges them (merge_row,
//   paged_common.cuh).
// Head dims follow the lane layout of paged_common.cuh (lane owns dims
// lane + 32 i), so D = 64 and 96 work.
#pragma once

#include <climits>

#include "paged_common.cuh"
#include "tile_pipeline.cuh"

namespace spin {

// A dense (B, S, Kh, D) cache: run z of row b is the slots from
// b S + z run_slots; float K/V only, no table.
struct DenseRow {
  using Map = pipe::DenseMap;
  static constexpr bool kTable = false;
  __host__ __device__ int table_words(int) const { return 0; }
  __device__ __forceinline__ void fetch_table(int, int, int, int*) const {}
  __device__ __forceinline__ const float* k_scale() const { return nullptr; }
  __device__ __forceinline__ const float* v_scale() const { return nullptr; }
  __device__ __forceinline__ Map map(int b, int S, int z, int run_slots,
                                     const int*) const {
    return Map{static_cast<long long>(b) * S + z * run_slots};
  }
};

// A block pool read through block_tables (B, NB): S = NB bs logical slots
// a row; ks/vs (N, bs, Kh) scales of int8/fp8 pools, or null.
struct PagedRow {
  using Map = pipe::PagedRowMap;
  static constexpr bool kTable = true;
  const int* tables;
  const float* ks;
  const float* vs;
  int bs, NB;
  // the entries run_slots consecutive slots can touch, at any offset
  __host__ __device__ int table_words(int run_slots) const {
    return (run_slots + bs - 2) / bs + 1;
  }
  // Run z's slice of row b's table from its first logical block (at most
  // table_words entries, none past NB), each entry max(id, 0).
  __device__ __forceinline__ void fetch_table(int b, int z, int run_slots,
                                              int* table) const {
    const int e0 = z * run_slots / bs;
    const int n = min(NB - e0, table_words(run_slots));
    const int* src = tables + static_cast<long long>(b) * NB + e0;
    for (int e = threadIdx.x; e < n; e += kThreads) table[e] = max(src[e], 0);
  }
  __device__ __forceinline__ const float* k_scale() const { return ks; }
  __device__ __forceinline__ const float* v_scale() const { return vs; }
  __device__ __forceinline__ Map map(int, int, int z, int run_slots,
                                     const int* table) const {
    const int s0 = z * run_slots;
    return Map{table, s0 - (s0 / bs) * bs, bs};
  }
};

// Partials of run z, row b, head: pm/pl [(z * B + b) * H + head], pacc
// [((z * B + b) * H + head) * D + d], all float32 (live runs > 1 only).
// Shared memory: the queries [R][D] (float32, scaled), the run's table
// slice (PagedRow), then the teams' stages (reused by merge_teams).
template <typename QT, typename KT, int RW, class Row>
__global__ void __launch_bounds__(kThreads)
    decode_run_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                      const KT* __restrict__ v,
                      const int* __restrict__ lengths, float* __restrict__ pm,
                      float* __restrict__ pl, float* __restrict__ pacc,
                      int* __restrict__ counters, QT* __restrict__ out, int B,
                      int S, int H, int Kh, int D, int per_run, int wpt,
                      int stages, float scale, const Row row) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int is_last;
  const int R = H / Kh;  // rows r: query head h R + r of row b
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  float* sq = reinterpret_cast<float*>(smem);
  unsigned char* stage_base = smem + pipe::align16(sizeof(float) * R * D);
  int* table = reinterpret_cast<int*>(stage_base);  // PagedRow only
  if (Row::kTable)
    stage_base +=
        pipe::align16(sizeof(int) * row.table_words(per_run * kTile));

  // The queries, the length and the run's table slice go out together;
  // the queries' conversion to shared memory comes after the tiles'
  // requests.
  pipe::QRows<QT> qf;
  qf.fetch(q, b, R, R, H, h, D);
  const int len = min(max(lengths[b], 0), S);
  const int run_slots = per_run * kTile;
  row.fetch_table(b, z, run_slots, table);
  const int live_runs =
      max(1, (len + run_slots - 1) / run_slots);  // row of length 0: one
  if (z >= live_runs) return;  // CTA-uniform: past the live prefix
  const int n_slots = max(0, min(run_slots, len - z * run_slots));

  pipe::Rows<RW> w;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    w.m[rr] = -CUDART_INF_F;
    w.l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) w.acc[rr][i] = 0.f;
    w.seg[rr] = 0;
    w.pos[rr] = 0;
    w.anc[rr] = -1;
  }
  pipe::Pool<KT> p;
  p.k = k;
  p.v = v;
  p.seg = nullptr;
  p.pos = nullptr;
  p.node = nullptr;
  p.ks = row.k_scale();
  p.vs = row.v_scale();
  p.Kh = Kh;
  p.h = h;
  p.D = D;
  p.KS = pipe::k_stride(D, sizeof(KT));
  p.VS = pipe::v_stride(D, sizeof(KT));
  p.vec = (D * sizeof(KT)) % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(k) |
            reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const typename Row::Map map = row.map(b, S, z, run_slots, table);
  if (Row::kTable) __syncthreads();  // the table slice
  const pipe::Walk walk = pipe::walk_start<KT, false>(
      stage_base, stages, p, map, (n_slots + kTile - 1) / kTile, n_slots,
      wpt);
  qf.store(sq, q, b, R, R, H, h, D, scale);
  __syncthreads();  // the queries
  pipe::walk_rest<KT, false, false>(walk, p, map, n_slots, sq, R, wpt, w);
  pipe::merge_teams(reinterpret_cast<float*>(stage_base), wpt, R, D, w);

  const long long row0 = static_cast<long long>(b) * H + h * R;
  if (live_runs == 1) {
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = warp + kWarps * rr;
      if (r < R) store_row(out + (row0 + r) * D, D, w.l[rr], w.acc[rr]);
    }
    return;
  }
  const long long stride = static_cast<long long>(B) * H;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp + kWarps * rr;
    if (r < R) {  // warp-uniform, and so is l
      const long long o = static_cast<long long>(z) * stride + row0 + r;
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
  // The last live run of this (row, kv head) to finish merges every live
  // run's partial and resets the counter.
  __threadfence();
  __syncthreads();
  int* count = counters + static_cast<long long>(b) * Kh + h;
  if (threadIdx.x == 0) is_last = atomicAdd(count, 1) == live_runs - 1;
  __syncthreads();
  if (!is_last) return;
  __threadfence();
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp + kWarps * rr;
    if (r < R)
      merge_row(pm, pl, pacc, out + (row0 + r) * D, stride, row0 + r, D,
                live_runs);
  }
  if (threadIdx.x == 0) *count = 0;
}

// The checks both entries share: q (B, H, D) over S slots a row; run z
// covers tiles [z per_run, (z + 1) per_run) of 32 slots, runs = max(1,
// ceil(ceil(S / 32) / per_run)); kWarps / wpt teams of `stages` tile
// buffers (H / Kh rows, at most four per warp); with runs > 1 the float32
// scratch and the counters.
inline bool decode_runs_ok(int B, int S, int H, int Kh, int D, int per_run,
                           int runs, int wpt, int stages, const float* pm,
                           const float* pl, const float* pacc,
                           const int* counters) {
  const int R = Kh > 0 ? H / Kh : 0;
  const int tiles = S > 0 ? (S + kTile - 1) / kTile : 0;
  return B > 0 && S >= 0 && Kh > 0 && H % Kh == 0 && D > 0 && D <= kMaxD &&
         R <= kMaxRows && per_run > 0 && per_run <= INT_MAX / kTile &&
         runs > 0 && runs <= 65535 &&
         runs == max(1, (tiles + per_run - 1) / per_run) &&
         (wpt == 1 || wpt == 2 || wpt == kWarps) &&
         R <= kRowsPerWarp * wpt && stages >= 1 &&
         stages <= pipe::kMaxStages &&
         (runs == 1 || (pm != nullptr && pl != nullptr && pacc != nullptr &&
                        counters != nullptr));
}

template <typename QT, typename KT, class Row>
static int launch_decode_runs(const void* q, const void* k, const void* v,
                              const Row& row, const int* lengths, float* pm,
                              float* pl, float* pacc, int* counters,
                              void* out, int B, int S, int H, int Kh, int D,
                              int per_run, int runs, int wpt, int stages,
                              float scale, cudaStream_t stream) {
  const int R = H / Kh;
  const size_t smem =
      pipe::align16(sizeof(float) * R * D) +
      pipe::align16(sizeof(int) * row.table_words(per_run * kTile)) +
      pipe::stages_smem(kWarps / wpt, stages, R, D, sizeof(KT));
  // one row per warp runs the short code (pipe::Rows)
  auto kernel = (R + wpt - 1) / wpt <= 1
                    ? decode_run_kernel<QT, KT, 1, Row>
                    : decode_run_kernel<QT, KT, kRowsPerWarp, Row>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Kh, runs);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), lengths, pm, pl, pacc, counters,
      static_cast<QT*>(out), B, S, H, Kh, D, per_run, wpt, stages, scale,
      row);
  return 0;
}

}  // namespace spin
