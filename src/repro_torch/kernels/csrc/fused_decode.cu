// fused_paged_decode: T query tokens per row attend the row's own blocks,
// walked through its block table straight from the paged pool.
//
// Replaces the TPU kernel src/repro/kernels/fused_decode.py
// (_fused_decode_kernel, :41-114; wrapper fused_paged_decode, :118).  It
// serves SSM draft steps (T = 1), the SSM catch-up (T = W + 1), chunked
// prefill appends (T = the bucketed chunk width) and unpacked verification.
//
// What bounds it: the KV bytes.  A decode step scores T (usually 1..W+1)
// query tokens per head against every live slot of the row: a few
// multiply-adds per KV byte, far below the H100's ~295 operations per byte,
// so the least time is each row's live K/V (plus scales) read once over
// 3.35 TB/s.
//
// What the design does about it: one CTA per (row, kv head, query tile over
// T) holds the tile's GQA rows, so each K/V tile of the row's blocks enters
// shared memory once for all of them (dequantized there for int8/fp8
// pools).  Unallocated table entries (-1) and idle rows cost no KV reads;
// a row with no blocks writes zeros.  The wrapper sizes the query tile so
// the grid holds about two CTAs per SM.  Not done yet: splitting long rows
// across CTAs (flash-decoding) to fill the card at small batch, wgmma/TMA.
#include "paged_common.cuh"

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
                        float scale) {
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
      attend_tile<false>(sm, n, rows, D, m, l, acc, rseg, rpos, ranc);
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

template <typename QT, typename KT>
static void launch(const void* q, const void* kp, const void* vp,
                   const int* pool_seg, const int* pool_pos, const int* q_seg,
                   const int* q_pos, const int* block_tables, const float* ks,
                   const float* vs, void* out, int B, int T, int H, int Kh,
                   int D, int bs, int NB, int BQ, float scale,
                   cudaStream_t stream) {
  const int G = H / Kh;
  dim3 grid(B, Kh, (T + BQ - 1) / BQ);
  const size_t smem = smem_bytes(BQ * G, D);
  fused_decode_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(kp),
      static_cast<const KT*>(vp), pool_seg, pool_pos, q_seg, q_pos,
      block_tables, ks, vs, static_cast<QT*>(out), T, H, Kh, D, bs, NB, BQ,
      scale);
}

template <typename QT>
static int dispatch_kv(int kv_dtype, const void* q, const void* kp,
                       const void* vp, const int* pool_seg,
                       const int* pool_pos, const int* q_seg, const int* q_pos,
                       const int* block_tables, const float* ks,
                       const float* vs, void* out, int B, int T, int H, int Kh,
                       int D, int bs, int NB, int BQ, float scale,
                       cudaStream_t stream) {
#define SPIN_ARGS                                                           \
  q, kp, vp, pool_seg, pool_pos, q_seg, q_pos, block_tables, ks, vs, out, B, \
      T, H, Kh, D, bs, NB, BQ, scale, stream
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

// q (B, T, H, D) f32/bf16; pools (N, bs, Kh, D); pool_seg/pool_pos (N, bs);
// q_seg/q_pos (B, T); block_tables (B, NB), -1 = unallocated; ks/vs
// (N, bs, Kh) f32 or null; out like q.  Returns cudaGetLastError() after
// the launch (0 = launched).
extern "C" int spin_fused_paged_decode(
    const void* q, const void* k_pool, const void* v_pool, const int* pool_seg,
    const int* pool_pos, const int* q_seg, const int* q_pos,
    const int* block_tables, const float* k_scale, const float* v_scale,
    void* out, int B, int T, int H, int Kh, int D, int bs, int NB, int BQ,
    int q_dtype, int kv_dtype, float scale, void* stream) {
  using namespace spin;
  if (B <= 0 || T <= 0 || Kh <= 0 || H % Kh != 0 || D <= 0 || D > kMaxD ||
      BQ <= 0 || BQ * (H / Kh) > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == kF32)
    rc = dispatch_kv<float>(kv_dtype, q, k_pool, v_pool, pool_seg, pool_pos,
                            q_seg, q_pos, block_tables, k_scale, v_scale, out,
                            B, T, H, Kh, D, bs, NB, BQ, scale, st);
  else if (q_dtype == kBF16)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k_pool, v_pool, pool_seg,
                                    pool_pos, q_seg, q_pos, block_tables,
                                    k_scale, v_scale, out, B, T, H, Kh, D, bs,
                                    NB, BQ, scale, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
