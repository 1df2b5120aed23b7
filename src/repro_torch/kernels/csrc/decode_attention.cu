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
// 3.35 TB/s.
//
// What the design does about it: one CTA per (row, kv head) holds the GQA
// group's query heads (G <= 16 rows) and streams the row's live prefix
// min(lengths[b], S) through shared memory in 32-slot tiles, each K/V
// element read once for all heads of the group; slots past the length are
// never read, so S need not be a multiple of the tile and no pad copy is
// made.  Head dims follow paged_common.cuh's lane layout (lane owns dims
// lane + 32 i), so D = 96 works.  Not done yet: splitting long rows across
// CTAs (flash-decoding) to fill the card at small batch x heads, wgmma/TMA.
#include "paged_common.cuh"

namespace spin {

template <typename QT, typename KT>
__global__ void __launch_bounds__(kThreads)
    decode_attention_kernel(const QT* __restrict__ q,
                            const KT* __restrict__ k,
                            const KT* __restrict__ v,
                            const int* __restrict__ lengths,
                            QT* __restrict__ out, int S, int H, int Kh, int D,
                            float scale) {
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
    sm.seg[j] = 0;  // every loaded slot is live: the tile stops at length
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
  const int len = min(max(lengths[b], 0), S);
  __syncthreads();

  for (int s0 = 0; s0 < len; s0 += kTile) {
    const int n = min(kTile, len - s0);
    load_kv_tile(sm, k, v, nullptr, nullptr, b, s0, n, S, Kh, h, D);
    __syncthreads();
    attend_tile<false>(sm, n, rows, D, m, l, acc, rseg, rpos, ranc);
    __syncthreads();
  }

#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows)
      store_row(out + (qrow + h * G + r) * D, D, l[rr], acc[rr]);
  }
}

template <typename QT, typename KT>
static void launch(const void* q, const void* k, const void* v,
                   const int* lengths, void* out, int B, int S, int H, int Kh,
                   int D, float scale, cudaStream_t stream) {
  dim3 grid(B, Kh);
  const size_t smem = smem_bytes(H / Kh, D);
  decode_attention_kernel<QT, KT><<<grid, kThreads, smem, stream>>>(
      static_cast<const QT*>(q), static_cast<const KT*>(k),
      static_cast<const KT*>(v), lengths, static_cast<QT*>(out), S, H, Kh, D,
      scale);
}

template <typename QT>
static int dispatch_kv(int kv_dtype, const void* q, const void* k,
                       const void* v, const int* lengths, void* out, int B,
                       int S, int H, int Kh, int D, float scale,
                       cudaStream_t stream) {
  switch (kv_dtype) {
    case kF32:
      launch<QT, float>(q, k, v, lengths, out, B, S, H, Kh, D, scale, stream);
      break;
    case kBF16:
      launch<QT, __nv_bfloat16>(q, k, v, lengths, out, B, S, H, Kh, D, scale,
                                stream);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace spin

// q (B, H, D) f32/bf16; k, v (B, S, Kh, D) f32/bf16; lengths (B,); out like
// q.  Returns cudaGetLastError() after the launch (0 = launched).
extern "C" int spin_decode_attention(const void* q, const void* k,
                                     const void* v, const int* lengths,
                                     void* out, int B, int S, int H, int Kh,
                                     int D, int q_dtype, int kv_dtype,
                                     float scale, void* stream) {
  using namespace spin;
  if (B <= 0 || S < 0 || Kh <= 0 || H % Kh != 0 || D <= 0 || D > kMaxD ||
      H / Kh > kMaxRows)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (q_dtype == kF32)
    rc = dispatch_kv<float>(kv_dtype, q, k, v, lengths, out, B, S, H, Kh, D,
                            scale, st);
  else if (q_dtype == kBF16)
    rc = dispatch_kv<__nv_bfloat16>(kv_dtype, q, k, v, lengths, out, B, S, H,
                                    Kh, D, scale, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
