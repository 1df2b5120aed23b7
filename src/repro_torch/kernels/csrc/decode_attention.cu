// decode_attention: dense GQA decode, one query token per row against the
// row's (S, Kh, D) slice of a dense cache; slots at or past lengths[b] are
// masked and a row of length 0 gives zeros.
//
// Replaces the TPU kernel src/repro/kernels/decode_attention.py (_kernel,
// :25-69; wrapper decode_attention, :72).  Public through
// kernels/ops.decode_attention.
//
// What bounds it: the KV bytes.  One query per (row, head) scores every
// live slot once: two multiply-adds per K and V element, about one
// operation per byte, far below the H100's ~295 operations per byte.  So
// the least time is each row's live prefix of K/V read once over
// 3.35 TB/s.  A long row at a small batch has the bytes to fill the card
// only if many CTAs share it; a short row costs its dependent memory round
// trips, and its warps must all have work.
//
// What the design does about it: one launch over (row, kv head, run of
// 32-slot tiles), on the tile pipeline of the paged kernels
// (tile_pipeline.cuh); the wrapper's run_plan (kernels/decode_attention.py)
// sizes it.
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
// - The merge in the same launch: where a row's live prefix spans one run,
//   that run writes the output (a row of length 0: zeros); with more, each
//   live run writes an unnormalised partial (m, l, acc) to float32 scratch
//   and the last to finish (a __threadfence, then an atomic counter per
//   (row, kv head), reset by that CTA) merges them (merge_row,
//   paged_common.cuh).
// Head dims follow the lane layout of paged_common.cuh (lane owns dims
// lane + 32 i), so D = 64 and 96 work.
#include "paged_common.cuh"
#include "tile_pipeline.cuh"

namespace spin {

// Partials of run z, row b, head: pm/pl [(z * B + b) * H + head], pacc
// [((z * B + b) * H + head) * D + d], all float32 (live runs > 1 only).
// Shared memory: the queries [R][D] (float32, scaled), then the teams'
// stages (reused by merge_teams).
template <typename QT, typename KT, int RW>
__global__ void __launch_bounds__(kThreads)
    decode_run_kernel(const QT* __restrict__ q, const KT* __restrict__ k,
                      const KT* __restrict__ v,
                      const int* __restrict__ lengths, float* __restrict__ pm,
                      float* __restrict__ pl, float* __restrict__ pacc,
                      int* __restrict__ counters, QT* __restrict__ out, int B,
                      int S, int H, int Kh, int D, int per_run, int wpt,
                      int stages, float scale) {
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

  // The queries and the length go out together; the queries' conversion
  // to shared memory comes after the tiles' requests.
  pipe::QRows<QT> qf;
  qf.fetch(q, b, R, R, H, h, D);
  const int len = min(max(lengths[b], 0), S);
  const int run_slots = per_run * kTile;
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
  p.ks = nullptr;
  p.vs = nullptr;
  p.Kh = Kh;
  p.h = h;
  p.D = D;
  p.KS = pipe::k_stride(D, sizeof(KT));
  p.VS = pipe::v_stride(D, sizeof(KT));
  p.vec = (D * sizeof(KT)) % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(k) |
            reinterpret_cast<uintptr_t>(v)) & 15) == 0;
  const pipe::DenseMap map{static_cast<long long>(b) * S + z * run_slots};
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

template <typename QT, typename KT>
static int launch(const void* q, const void* k, const void* v,
                  const int* lengths, float* pm, float* pl, float* pacc,
                  int* counters, void* out, int B, int S, int H, int Kh,
                  int D, int per_run, int runs, int wpt, int stages,
                  float scale, cudaStream_t stream) {
  const int R = H / Kh;
  const size_t smem =
      pipe::align16(sizeof(float) * R * D) +
      pipe::stages_smem(kWarps / wpt, stages, R, D, sizeof(KT));
  // one row per warp runs the short code (pipe::Rows)
  auto kernel = (R + wpt - 1) / wpt <= 1
                    ? decode_run_kernel<QT, KT, 1>
                    : decode_run_kernel<QT, KT, kRowsPerWarp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(B, Kh, runs);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), lengths, pm, pl, pacc, counters,
      static_cast<QT*>(out), B, S, H, Kh, D, per_run, wpt, stages, scale);
  return 0;
}

}  // namespace spin

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
  const int R = Kh > 0 ? H / Kh : 0;
  const int tiles = S > 0 ? (S + kTile - 1) / kTile : 0;
  if (B <= 0 || S < 0 || Kh <= 0 || H % Kh != 0 || D <= 0 || D > kMaxD ||
      R > kMaxRows || per_run <= 0 || runs <= 0 || runs > 65535 ||
      runs != max(1, (tiles + per_run - 1) / per_run) ||
      (wpt != 1 && wpt != 2 && wpt != kWarps) || R > kRowsPerWarp * wpt ||
      stages < 1 || stages > pipe::kMaxStages ||
      (runs > 1 && (pm == nullptr || pl == nullptr || pacc == nullptr ||
                    counters == nullptr)))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define SPIN_DECODE(QT, KT)                                                 \
  rc = launch<QT, KT>(q, k, v, lengths, pm, pl, pacc, counters, out, B, S, \
                      H, Kh, D, per_run, runs, wpt, stages, scale, st)
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
