// fused_paged_decode: T query tokens per row attend the row's own blocks,
// walked through its block table straight from the paged pool.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py
// (_fused_decode_kernel, :41-114; wrapper fused_paged_decode, :118).  It
// serves SSM draft steps (T = 1), the SSM catch-up (T = W + 1), chunked
// prefill appends (T = the bucketed chunk width) and unpacked verification.
//
// What bounds it on the H100: latency, not bytes or operations.  A decode
// step scores T (usually 1..W+1) query tokens per head against every live
// slot of the row: a few multiply-adds per KV byte, far below the ~295
// operations per byte at which the tensor cores would be the limit, so the
// least time is each row's live K/V (plus scales) read once over 3.35
// TB/s -- well under a microsecond at serving lengths.  What a call costs
// is its chain of dependent memory round trips and the lanes left idle.
// So no tensor cores (mma.sync/wgmma): a CTA scores 1-16 query rows
// against 16-slot blocks, and the gap to the bound is latency and idle
// lanes, not arithmetic.
//
// Two layouts, one launch, no scratch in device memory:
// - split (a CTA with fewer query rows than warps: draft steps, catch-up
//   at small batch; fused_decode_split_kernel): the row's block table is
//   read once into shared memory, q through load_q_rows' two steps
//   (QRows: requested first, stored once the tiles are requested); the
//   row's live slots are cut into 32-slot tiles (two 16-slot blocks fill
//   one, so every lane scores) and the tiles are dealt to teams of warps
//   (one row a warp), each with its own online softmax and its own
//   cp.async stages, the next tiles in flight while one is scored
//   (tile_pipeline.cuh); the teams' states are merged in shared memory
//   before the store.  A row's K/V thus costs about one memory round trip
//   after the table's, not one per block.
// - rows (four or more rows per CTA: chunk appends, GQA groups;
//   fused_decode_kernel): one CTA per (row, kv head, query tile) holds the
//   tile's GQA rows, so each K/V tile of the row's blocks enters shared
//   memory once for all of them (dequantized there for int8/fp8 pools).
// Unallocated table entries (-1) and idle rows cost no KV reads; a row
// with no blocks writes zeros.  The wrapper (kernels/fused_decode.py,
// decode_plan) picks the layout, the query tile, the teams and the stages.
#include "paged_common.cuh"
#include "tile_pipeline.cuh"

namespace spin {

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
    fused_decode_kernel(const QT* __restrict__ q, const KT* __restrict__ kp,
                        const KT* __restrict__ vp,
                        const int* __restrict__ pool_seg,
                        const int* __restrict__ pool_pos,
                        const int* __restrict__ q_seg,
                        const int* __restrict__ q_pos,
                        const int* __restrict__ block_tables,
                        const float* __restrict__ ks,
                        const float* __restrict__ vs, QT* __restrict__ out,
                        int T, int H, int Kh, int D, int bs, int NB, int BQ,
                        float scale, unsigned wlim) {
  extern __shared__ float smem_raw[];
  const int G = H / Kh;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int t0 = blockIdx.z * BQ;
  const int nq = min(BQ, T - t0);
  const int rows = nq * G;
  const Smem sm = carve_smem(smem_raw, BQ * G, D);
  const long long qrow = static_cast<long long>(b) * T;  // first token of b

  for (int e = threadIdx.x; e < rows * D; e += blockDim.x) {
    const int r = e / D;
    const int d = e - r * D;
    const long long t = qrow + t0 + r / G;
    const int head = h * G + r % G;
    sm.q[e] = to_f32(q[(t * H + head) * D + d]) * scale;
  }
  const int warp = threadIdx.x >> 5;
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][kDimPerLane];
  int rseg[kRowsPerWarp], rpos[kRowsPerWarp], ranc[kRowsPerWarp];
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    const long long t = qrow + t0 + (r < rows ? r / G : 0);
    m[rr] = -CUDART_INF_F;
    l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) acc[rr][i] = 0.f;
    rseg[rr] = q_seg[t];  // -1 = bucket padding: matches no slot
    rpos[rr] = q_pos[t];
    ranc[rr] = -1;
  }
  __syncthreads();

  const int* table = block_tables + static_cast<long long>(b) * NB;
  for (int mi = 0; mi < NB; ++mi) {
    const int id = table[mi];
    if (id < 0) continue;  // unallocated: no KV byte is read
    const long long blk = id;
    for (int s0 = 0; s0 < bs; s0 += kTile) {
      const int n = min(kTile, bs - s0);
      load_kv_tile(sm, kp, vp, ks, vs, blk, s0, n, bs, Kh, h, D);
      for (int j = threadIdx.x; j < n; j += blockDim.x) {
        const long long slot = blk * bs + s0 + j;
        sm.seg[j] = pool_seg[slot];  // -1 = invalidated slot
        sm.pos[j] = pool_pos[slot];
        sm.node[j] = -1;
      }
      __syncthreads();
      attend_tile<false>(sm, n, rows, D, m, l, acc, rseg, rpos, ranc,
                         wlim);
      __syncthreads();
    }
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows) {
      const long long t = qrow + t0 + r / G;
      const int head = h * G + r % G;
      store_row(out + (t * H + head) * D, D, l[rr], acc[rr]);
    }
  }
}

// The split layout: rows R = nq * G < kWarps of row b, kv head h.  Shared
// memory: the row's table [NB], the queries [R][D] (float32, scaled), then
// the teams' stages (reused by merge_teams).
template <typename QT, typename KT, int RW>
__global__ void __launch_bounds__(kThreads)
    fused_decode_split_kernel(const QT* __restrict__ q,
                              const KT* __restrict__ kp,
                              const KT* __restrict__ vp,
                              const int* __restrict__ pool_seg,
                              const int* __restrict__ pool_pos,
                              const int* __restrict__ q_seg,
                              const int* __restrict__ q_pos,
                              const int* __restrict__ block_tables,
                              const float* __restrict__ ks,
                              const float* __restrict__ vs,
                              QT* __restrict__ out, int T, int H, int Kh,
                              int D, int bs, int NB, int BQ, int wpt,
                              int stages, float scale, unsigned wlim) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wlast[kWarps];
  const int G = H / Kh;
  const int b = blockIdx.x;
  const int h = blockIdx.y;
  const int t0 = blockIdx.z * BQ;
  const int R = min(BQ, T - t0) * G;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int k0 = warp % wpt;
  int* table = reinterpret_cast<int*>(smem);
  float* sq = reinterpret_cast<float*>(smem + pipe::align16(sizeof(int) * NB));
  unsigned char* stage_base = reinterpret_cast<unsigned char*>(sq) +
                              pipe::align16(sizeof(float) * BQ * G * D);
  const long long tok0 = static_cast<long long>(b) * T + t0;

  // The table, the rows' tags and the queries go out first; the tiles'
  // requests wait only on the table, the queries' conversion to shared
  // memory comes after them.
  pipe::QRows<QT> qf;
  qf.fetch(q, static_cast<int>(tok0), R, G, H, h, D);
  const int* row_table = block_tables + static_cast<long long>(b) * NB;
  int last = -1;
  for (int e = threadIdx.x; e < NB; e += kThreads) {
    const int id = row_table[e];
    table[e] = id;
    if (id >= 0) last = e;
  }
  pipe::Rows<RW> w;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = k0 + wpt * rr;
    const long long t = tok0 + (r < R ? r / G : 0);
    w.m[rr] = -CUDART_INF_F;
    w.l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) w.acc[rr][i] = 0.f;
    w.seg[rr] = q_seg[t];  // -1 = bucket padding: matches no slot
    w.pos[rr] = q_pos[t];
    w.anc[rr] = -1;
  }
  w.wlim = wlim;
  last = warp_max_int(last);
  if (lane == 0) wlast[warp] = last;
  __syncthreads();  // the table, the warps' last live entries
#pragma unroll
  for (int i = 0; i < kWarps; ++i) last = max(last, wlast[i]);

  pipe::Pool<KT> p;
  p.k = kp;
  p.v = vp;
  p.seg = pool_seg;
  p.pos = pool_pos;
  p.node = nullptr;
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
  const int n_slots = (last + 1) * bs;
  const pipe::TableMap map{table, bs};
  const pipe::Walk walk = pipe::walk_start<KT, false>(
      stage_base, stages, p, map, (n_slots + kTile - 1) / kTile, n_slots,
      wpt);
  qf.store(sq, q, static_cast<int>(tok0), R, G, H, h, D, scale);
  __syncthreads();  // the queries
  pipe::walk_rest<KT, false, false>(walk, p, map, n_slots, sq, R, wpt, w);
  pipe::merge_teams(reinterpret_cast<float*>(stage_base), wpt, R, D, w);
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp + kWarps * rr;
    if (r < R) {
      const long long t = tok0 + r / G;
      store_row(out + (t * H + h * G + r % G) * D, D, w.l[rr], w.acc[rr]);
    }
  }
}

template <typename QT, typename KT>
static int launch(const void* q, const void* kp, const void* vp,
                  const int* pool_seg, const int* pool_pos, const int* q_seg,
                  const int* q_pos, const int* block_tables, const float* ks,
                  const float* vs, void* out, int B, int T, int H, int Kh,
                  int D, int bs, int NB, int BQ, int wpt, int stages,
                  float scale, unsigned wlim, cudaStream_t stream) {
  const int G = H / Kh;
  dim3 grid(B, Kh, (T + BQ - 1) / BQ);
  if (wpt == 0) {
    const size_t smem = smem_bytes(BQ * G, D);
    fused_decode_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(
        static_cast<const QT*>(q), static_cast<const KT*>(kp),
        static_cast<const KT*>(vp), pool_seg, pool_pos, q_seg, q_pos,
        block_tables, ks, vs, static_cast<QT*>(out), T, H, Kh, D, bs, NB,
        BQ, scale, wlim);
    return 0;
  }
  const size_t smem =
      pipe::align16(sizeof(int) * NB) +
      pipe::align16(sizeof(float) * BQ * G * D) +
      pipe::stages_smem(kWarps / wpt, stages, BQ * G, D, sizeof(KT));
  // one row per warp runs the short code (pipe::Rows)
  auto kernel = (BQ * G + wpt - 1) / wpt <= 1
                    ? fused_decode_split_kernel<QT, KT, 1>
                    : fused_decode_split_kernel<QT, KT, kRowsPerWarp>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), pool_seg, pool_pos, q_seg, q_pos,
      block_tables, ks, vs, static_cast<QT*>(out), T, H, Kh, D, bs, NB, BQ,
      wpt, stages, scale, wlim);
  return 0;
}

template <typename QT>
static int dispatch_kv(int kv_dtype, const void* q, const void* kp,
                       const void* vp, const int* pool_seg,
                       const int* pool_pos, const int* q_seg, const int* q_pos,
                       const int* block_tables, const float* ks,
                       const float* vs, void* out, int B, int T, int H, int Kh,
                       int D, int bs, int NB, int BQ, int wpt, int stages,
                       float scale, unsigned wlim, cudaStream_t stream) {
#define SPIN_ARGS                                                           \
  q, kp, vp, pool_seg, pool_pos, q_seg, q_pos, block_tables, ks, vs, out, B, \
      T, H, Kh, D, bs, NB, BQ, wpt, stages, scale, wlim, stream
  switch (kv_dtype) {
    case kF32: return launch<QT, float>(SPIN_ARGS);
    case kBF16: return launch<QT, __nv_bfloat16>(SPIN_ARGS);
    case kI8: return launch<QT, int8_t>(SPIN_ARGS);
    case kFP8: return launch<QT, __nv_fp8_e4m3>(SPIN_ARGS);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_ARGS
}

}  // namespace spin

// q (B, T, H, D) f32/bf16; pools (N, bs, Kh, D); pool_seg/pool_pos (N, bs);
// q_seg/q_pos (B, T); block_tables (B, NB), -1 = unallocated; ks/vs
// (N, bs, Kh) f32 or null; out like q.  BQ query tokens per CTA; wpt = 0:
// the row layout (fused_decode_kernel); wpt = 1, 2 or 4: the split layout
// with kWarps / wpt teams of `stages` tile buffers each (BQ * G rows, at
// most four per warp).  window > 0 masks slots at or before q_pos - window
// as well (0: none).  Returns cudaGetLastError() after the launch (0 =
// launched).
extern "C" int spin_fused_paged_decode(
    const void* q, const void* k_pool, const void* v_pool, const int* pool_seg,
    const int* pool_pos, const int* q_seg, const int* q_pos,
    const int* block_tables, const float* k_scale, const float* v_scale,
    void* out, int B, int T, int H, int Kh, int D, int bs, int NB, int BQ,
    int wpt, int stages, int q_dtype, int kv_dtype, int window, float scale,
    void* stream) {
  using namespace spin;
  if (B <= 0 || T <= 0 || Kh <= 0 || H % Kh != 0 || D <= 0 || D > kMaxD ||
      BQ <= 0 || BQ * (H / Kh) > kMaxRows || bs <= 0 || NB < 0 || window < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (wpt != 0 && ((wpt != 1 && wpt != 2 && wpt != kWarps) ||
                   BQ * (H / Kh) > kRowsPerWarp * wpt || stages < 1 ||
                   stages > pipe::kMaxStages))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned wlim = window_limit(window);
  int rc;
  if (q_dtype == kF32)
    rc = dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, pool_seg, pool_pos,
                            q_seg, q_pos, block_tables, k_scale, v_scale, out,
                            B, T, H, Kh, D, bs, NB, BQ, wpt, stages, scale,
                            wlim, st);
  else if (q_dtype == kBF16)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, pool_seg,
                                    pool_pos, q_seg, q_pos, block_tables,
                                    k_scale, v_scale, out, B, T, H, Kh, D, bs,
                                    NB, BQ, wpt, stages, scale, wlim, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
