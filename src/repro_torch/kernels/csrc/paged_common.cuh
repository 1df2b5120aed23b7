// Shared pieces of the attention kernels (fused_verify.cu, fused_decode.cu,
// verify_attention.cu, decode_attention.cu, paged_attention.cu; the
// redesigned paged kernels add tile_pipeline.cuh): element
// conversions, warp reductions, the shared-memory layout, the dequantizing
// K/V tile loader, the per-tile online-softmax step and the merge of
// split-KV partials.
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
// A slot at position p is attendable from a query at position q iff
// unsigned(q - p) < the limit: kNoWindow is p <= q alone (positions are
// non-negative ints, so q - p < 0 reads at least 2^31); a window w > 0 adds
// p > q - w (the reference's kv_pos > q_pos - window) at no extra cost.
constexpr unsigned kNoWindow = 0x80000000u;
__host__ __device__ inline unsigned window_limit(int window) {
  return window > 0 ? static_cast<unsigned>(window) : kNoWindow;
}

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

__device__ __forceinline__ int warp_min_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = min(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_max_int(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = max(v, __shfl_xor_sync(0xffffffffu, v, o));
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
// `h`, into shared memory (K/V only; the caller fills seg/pos/node).  A
// flat (slots, Kh, D) buffer is the case blk = 0; a dense (B, S, Kh, D)
// cache row b is blk = b, bs = S.  K and V are read in their stored dtype
// as 16-byte chunks (4 float32, 8 bf16, 16 int8/fp8 values) whenever a
// slot's D values fill whole chunks and both buffers are 16-byte aligned,
// else element by element; each thread issues all its chunks (or kUnroll
// elements) of K and of V before it converts (dequantizing with the
// per-(slot, head) scale) and stores any of them, so a tile costs about one
// memory latency.
constexpr int kUnroll = 8;

template <typename KT>
__device__ __forceinline__ void load_kv_tile(const Smem& sm, const KT* kp,
                                             const KT* vp, const float* ks,
                                             const float* vs, long long blk,
                                             int s0, int n, int bs, int Kh,
                                             int h, int D) {
  constexpr int E = 16 / sizeof(KT);  // values per 16-byte chunk
  const bool vec = D % E == 0 &&
                   ((reinterpret_cast<uintptr_t>(kp) |
                     reinterpret_cast<uintptr_t>(vp)) & 15) == 0;
  if (vec) {
    // chunks a thread holds per round: one round for a full tile at D 128
    constexpr int U = 2 * sizeof(KT);
    const int C = D / E;              // chunks per slot
    const int total = n * C;
    for (int base = threadIdx.x; base < total; base += kThreads * U) {
      uint4 kc[U], vc[U];
      float ksc[U], vsc[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * kThreads;
        if (e < total) {
          const int j = e / C;
          const long long slot = blk * bs + s0 + j;
          const long long src = (slot * Kh + h) * D + (e - j * C) * E;
          kc[u] = *reinterpret_cast<const uint4*>(kp + src);
          vc[u] = *reinterpret_cast<const uint4*>(vp + src);
          if (ks != nullptr) {
            ksc[u] = ks[slot * Kh + h];
            vsc[u] = vs[slot * Kh + h];
          }
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * kThreads;
        if (e < total) {
          const int j = e / C;
          const int d0 = (e - j * C) * E;
          const KT* kx = reinterpret_cast<const KT*>(&kc[u]);
          const KT* vx = reinterpret_cast<const KT*>(&vc[u]);
          float* kd = sm.k + j * (D + 1) + d0;
          float* vd = sm.v + j * D + d0;
#pragma unroll
          for (int i = 0; i < E; ++i) {
            float a = to_f32(kx[i]), b = to_f32(vx[i]);
            if (ks != nullptr) {
              a *= ksc[u];
              b *= vsc[u];
            }
            kd[i] = a;
            vd[i] = b;
          }
        }
      }
    }
    return;
  }
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

// The queries of a tile into shared memory, float32, scaled: row r is
// token t0 + r / G, head h G + r % G of a (tokens, H, D) array.  16-byte
// chunks when a row fills whole chunks and q is 16-byte aligned (every
// chunk a thread handles is requested before any is stored), else element
// by element.
template <typename QT>
__device__ __forceinline__ void load_q_rows(float* sq, const QT* q, int t0,
                                            int rows, int G, int H, int h,
                                            int D, float scale) {
  constexpr int E = 16 / sizeof(QT);
  if (D % E == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0) {
    // chunks a thread holds per round: one round for 16 rows at D 128
    constexpr int U = sizeof(QT);
    const int C = D / E;
    const int total = rows * C;
    for (int base = threadIdx.x; base < total; base += kThreads * U) {
      uint4 c[U];
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * kThreads;
        if (e < total) {
          const int r = e / C;
          const long long row =
              static_cast<long long>(t0 + r / G) * H + h * G + r % G;
          c[u] = *reinterpret_cast<const uint4*>(q + row * D +
                                                 (e - r * C) * E);
        }
      }
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = base + u * kThreads;
        if (e < total) {
          const int r = e / C;
          const QT* x = reinterpret_cast<const QT*>(&c[u]);
          float* dst = sq + r * D + (e - r * C) * E;
#pragma unroll
          for (int i = 0; i < E; ++i) dst[i] = to_f32(x[i]) * scale;
        }
      }
    }
    return;
  }
  for (int e = threadIdx.x; e < rows * D; e += kThreads) {
    const int r = e / D;
    const int d = e - r * D;
    const long long row =
        static_cast<long long>(t0 + r / G) * H + h * G + r % G;
    sq[e] = to_f32(q[row * D + d]) * scale;
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
    const int (&ranc)[kRowsPerWarp], unsigned wlim = kNoWindow) {
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
        ok = kseg >= 0 && kseg == rseg[rr] &&
             static_cast<unsigned>(rpos[rr] - sm.pos[lane]) < wlim;
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
#pragma unroll 4
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

// Merge of split-KV partials (verify_attention.cu's merge launch,
// paged_attention.cu's last run of a query tile): one warp per (query
// token, head), lane i reading partial c0 + i of each chunk of 32, so a
// chunk's (m, l) cost one memory round trip.  Partial i of row `row` (t *
// H + head) is pm/pl[i * stride + row] and pacc[(...) * D + d], all
// float32: an unnormalised running max m, sum l and accumulator.
// Partials with l = 0 attended nothing and are skipped (their pacc is never
// read); the others are rescaled to the running max of the live ones and
// summed, lane holding dims lane + 32 i.  Zeros where no partial attended
// anything.  The loads go to L2 (ld.cg): partials written by other CTAs of
// the same launch are never met stale in L1.
template <typename QT>
__device__ __forceinline__ void merge_row(const float* pm, const float* pl,
                                          const float* pacc, QT* out_row,
                                          long long stride, long long row,
                                          int D, int M) {
  const int lane = threadIdx.x & 31;
  float m_run = -CUDART_INF_F, l_run = 0.f, acc[kDimPerLane];
#pragma unroll
  for (int i = 0; i < kDimPerLane; ++i) acc[i] = 0.f;
  for (int c0 = 0; c0 < M; c0 += 32) {
    float mi = -CUDART_INF_F, li = 0.f;
    if (c0 + lane < M) {
      li = __ldcg(pl + (c0 + lane) * stride + row);
      mi = __ldcg(pm + (c0 + lane) * stride + row);
    }
    const bool live = li > 0.f;
    const float m_new = fmaxf(m_run, warp_max(live ? mi : -CUDART_INF_F));
    if (m_new == -CUDART_INF_F) continue;  // nothing attended so far
    const float keep = m_run > -CUDART_INF_F ? expf(m_run - m_new) : 0.f;
    const float w = live ? expf(mi - m_new) : 0.f;
    l_run = l_run * keep + warp_sum(li * w);
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) acc[i] *= keep;
    for (unsigned todo = __ballot_sync(0xffffffffu, live); todo;
         todo &= todo - 1) {
      const int j = __ffs(todo) - 1;
      const float wj = __shfl_sync(0xffffffffu, w, j);
      const float* src = pacc + ((c0 + j) * stride + row) * D;
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int d = lane + 32 * i;
        if (d < D) acc[i] = fmaf(wj, __ldcg(src + d), acc[i]);
      }
    }
    m_run = m_new;
  }
  const float denom = fmaxf(l_run, 1e-30f);
#pragma unroll
  for (int i = 0; i < kDimPerLane; ++i) {
    const int d = lane + 32 * i;
    if (d < D) store_f32(l_run > 0.f ? acc[i] / denom : 0.f, out_row + d);
  }
}

// merge_row over every (query token, head) of Tq * H: launch with
// kThreads threads and ceil(Tq * H / kWarps) CTAs.
template <typename QT>
__global__ void __launch_bounds__(kThreads)
    merge_partials_kernel(const float* __restrict__ pm,
                          const float* __restrict__ pl,
                          const float* __restrict__ pacc,
                          QT* __restrict__ out, int Tq, int H, int D, int M) {
  const long long stride = static_cast<long long>(Tq) * H;
  const long long row =
      static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= stride) return;         // warp-uniform
  merge_row(pm, pl, pacc, out + row * D, stride, row, D, M);
}

// Launch of merge_partials_kernel over every (query token, head).
template <typename QT>
inline void merge_partials(const float* pm, const float* pl,
                           const float* pacc, QT* out, int Tq, int H, int D,
                           int M, cudaStream_t stream) {
  const long long rows = static_cast<long long>(Tq) * H;
  merge_partials_kernel<QT>
      <<<static_cast<unsigned>((rows + kWarps - 1) / kWarps), kThreads, 0,
         stream>>>(pm, pl, pacc, out, Tq, H, D, M);
}

}  // namespace spin
