// Shared pieces of the paged attention kernels (fused_verify.cu,
// fused_decode.cu): element conversions, warp reductions, the shared-memory
// layout and the per-tile online-softmax step.
//
// Work split.  A CTA owns R <= 16 query rows of one kv head (the GQA
// group's heads of a few query tokens; the wrapper picks the tile so the
// grid has about two CTAs per SM), four warps, and walks a list of KV
// blocks.  Each
// block is streamed through shared memory in tiles of up to 32 slots: the
// 128 threads load the tile's K and V (dequantized to float32 with the
// per-(slot, head) scale when the pool is int8/fp8) together with the
// slot's segment, position and tree-node tags.  Then every warp takes its
// rows one at a time: lane j scores slot j against the row's query (a dot
// product over D read from shared memory), the warp reduces max and sum
// with shuffles for the online softmax, and each lane accumulates the
// output dims lane, lane+32, lane+64, lane+96 from the broadcast
// probabilities.  D is at most 128 and need not be a power of two.
#pragma once

#include <cuda_bf16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace spin {

constexpr float kNeg = -1e30f;      // masked score (reference: NEG)
constexpr int kWarps = 4;
constexpr int kThreads = kWarps * 32;
constexpr int kTile = 32;           // KV slots per shared tile: one per lane
constexpr int kRowsPerWarp = 4;
constexpr int kMaxRows = kWarps * kRowsPerWarp;  // 16 query rows per CTA
constexpr int kDimPerLane = 4;
constexpr int kMaxD = 32 * kDimPerLane;          // 128

// dtype codes shared with the Python wrappers
enum DType { kF32 = 0, kBF16 = 1, kI8 = 2, kFP8 = 3 };

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ float to_f32(int8_t x) {
  return static_cast<float>(x);
}
__device__ __forceinline__ float to_f32(__nv_fp8_e4m3 x) {
  return static_cast<float>(x);
}

__device__ __forceinline__ void store_f32(float v, float* p) { *p = v; }
__device__ __forceinline__ void store_f32(float v, __nv_bfloat16* p) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// Dynamic shared memory of one CTA.
struct Smem {
  float* q;   // [R][D]       queries, float32, pre-scaled by 1/sqrt(D)
  float* k;   // [kTile][D+1] keys (row padded: conflict-free lane reads)
  float* v;   // [kTile][D]   values
  int* seg;   // [kTile]      segment a query must carry to attend; -1 never
  int* pos;   // [kTile]      absolute position of the slot
  int* node;  // [kTile]      tree-node tag (-1 committed, < -1 dead)
};

inline size_t smem_bytes(int rows, int D) {
  return sizeof(float) * (size_t(rows) * D + size_t(kTile) * (D + 1) +
                          size_t(kTile) * D) +
         sizeof(int) * 3 * kTile;
}

__device__ __forceinline__ Smem carve_smem(float* base, int rows, int D) {
  Smem s;
  s.q = base;
  s.k = s.q + rows * D;
  s.v = s.k + kTile * (D + 1);
  s.seg = reinterpret_cast<int*>(s.v + kTile * D);
  s.pos = s.seg + kTile;
  s.node = s.pos + kTile;
  return s;
}

// Cooperative load of slots [s0, s0 + n) of physical block `blk`, kv head
// `h`, into shared memory (K/V only; the caller fills seg/pos/node).  Each
// thread issues kUnroll K and V loads before it stores any of them, so a
// tile costs about one memory latency instead of one per element.
constexpr int kUnroll = 8;

template <typename KT>
__device__ __forceinline__ void load_kv_tile(const Smem& sm, const KT* kp,
                                             const KT* vp, const float* ks,
                                             const float* vs, long long blk,
                                             int s0, int n, int bs, int Kh,
                                             int h, int D) {
  const int total = n * D;
  for (int base = threadIdx.x; base < total; base += kThreads * kUnroll) {
    float kv[kUnroll], vv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kThreads;
      if (e < total) {
        const int j = e / D;
        const long long slot = blk * bs + s0 + j;
        const long long src = (slot * Kh + h) * D + (e - j * D);
        kv[u] = to_f32(kp[src]);
        vv[u] = to_f32(vp[src]);
        if (ks != nullptr) {
          kv[u] *= ks[slot * Kh + h];
          vv[u] *= vs[slot * Kh + h];
        }
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int e = base + u * kThreads;
      if (e < total) {
        const int j = e / D;
        const int d = e - j * D;
        sm.k[j * (D + 1) + d] = kv[u];
        sm.v[j * D + d] = vv[u];
      }
    }
  }
}

// Online-softmax update of this warp's rows with one loaded tile of n
// slots.  Row r = warp + rr * kWarps (rr < kRowsPerWarp, r < rows) carries
// the running max m, sum l and output accumulator acc (dims lane + 32 i).
template <bool kTree>
__device__ __forceinline__ void attend_tile(
    const Smem& sm, int n, int rows, int D, float (&m)[kRowsPerWarp],
    float (&l)[kRowsPerWarp], float (&acc)[kRowsPerWarp][kDimPerLane],
    const int (&rseg)[kRowsPerWarp], const int (&rpos)[kRowsPerWarp],
    const int (&ranc)[kRowsPerWarp]) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int rr = 0; rr < kRowsPerWarp; ++rr) {
    const int r = warp + rr * kWarps;
    if (r < rows) {  // warp-uniform
      bool ok = false;
      float s = kNeg;
      if (lane < n) {
        const int kseg = sm.seg[lane];
        ok = kseg >= 0 && kseg == rseg[rr] && sm.pos[lane] <= rpos[rr];
        if (kTree && ok) {
          const int nd = sm.node[lane];
          ok = nd == -1 ||
               (nd >= 0 &&
                ((static_cast<unsigned>(ranc[rr]) >> min(nd, 31)) & 1u));
        }
        if (ok) {
          // four independent partial sums: a 4x shorter dependency chain
          const float* qr = sm.q + r * D;
          const float* kr = sm.k + lane * (D + 1);
          float d0 = 0.f, d1 = 0.f, d2 = 0.f, d3 = 0.f;
          int d = 0;
          for (; d + 4 <= D; d += 4) {
            d0 = fmaf(qr[d], kr[d], d0);
            d1 = fmaf(qr[d + 1], kr[d + 1], d1);
            d2 = fmaf(qr[d + 2], kr[d + 2], d2);
            d3 = fmaf(qr[d + 3], kr[d + 3], d3);
          }
          for (; d < D; ++d) d0 = fmaf(qr[d], kr[d], d0);
          s = (d0 + d1) + (d2 + d3);
        }
      }
      const float m_new = fmaxf(m[rr], warp_max(s));
      const float m_safe = fmaxf(m_new, -1e29f);
      const float p = ok ? expf(s - m_safe) : 0.f;
      const float corr = (m[rr] > -CUDART_INF_F) ? expf(m[rr] - m_safe) : 0.f;
      l[rr] = l[rr] * corr + warp_sum(p);
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) acc[rr][i] *= corr;
      for (int j = 0; j < n; ++j) {
        const float pj = __shfl_sync(0xffffffffu, p, j);
        const float* vr = sm.v + j * D;
#pragma unroll
        for (int i = 0; i < kDimPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) acc[rr][i] = fmaf(pj, vr[d], acc[rr][i]);
        }
      }
      m[rr] = m_new;
    }
  }
}

// Final normalisation: o = acc / l, zeros where no slot was attendable.
template <typename QT>
__device__ __forceinline__ void store_row(QT* out_row, int D, float l,
                                          const float (&acc)[kDimPerLane]) {
  const int lane = threadIdx.x & 31;
  const float denom = fmaxf(l, 1e-30f);
#pragma unroll
  for (int i = 0; i < kDimPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) store_f32(l > 0.f ? acc[i] / denom : 0.f, out_row + d);
  }
}

}  // namespace spin
