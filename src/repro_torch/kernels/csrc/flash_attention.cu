// flash_attention: causal prefill attention over (B, S, H, D) queries and
// (B, S, Kh, D) keys/values, GQA (H % Kh == 0), with an optional sliding
// window: query t attends key s iff s <= t and, when window > 0,
// s > t - window.  Float32 online softmax; output in q's dtype.
//
// Replaces the TPU kernel src/repro/kernels/flash_attention.py (_kernel,
// :23-84; wrapper flash_attention, :87).  Public through
// kernels/ops.flash_attention.  The same arithmetic as the Pallas body:
// scores scaled by 1/sqrt(D), masked scores at -1e30, the running max
// clamped at -1e29 before the exponential, running (m, l, acc) in float32,
// output acc / max(l, 1e-30) and zeros where l == 0.
//
// What bounds it: the operations.  Every query meets up to S (or window)
// keys and each (query head, key) pair costs 4 D operations (two dot
// products of length D), while the bytes are each of q, k, v and the
// output once; at prefill lengths that is thousands of operations per
// byte, far above the ~295 at which the H100's tensor cores stop waiting
// for memory.  So the least time is 4 D x (attended pairs) x H over the
// tensor cores' dense peak for the input type.
//
// Two kernels; the wrapper (kernels/flash_attention.py, ``route``) picks
// one by dtype, and each has its own entry point below.
//
// bf16: flash_mma_kernel, FlashAttention-2 on the tensor cores.  One CTA
// of four warps per (batch row, kv head, query tile) holds 64 query rows,
// the G query heads of that kv head for 64 / G consecutive tokens (row r
// is token t0 + r / G, head h G + r % G), so every K/V tile in shared
// memory serves all G heads.  A warp owns 16 rows.  Q, K and V enter
// shared memory in bf16 by 16-byte cp.async copies, rows padded by 16
// bytes so that ldmatrix reads are free of bank conflicts; K/V tiles of
// 64 keys are double buffered (tile j + 1 loads while tile j computes).
// S = Q K^T and O += P V run as mma.sync m16n8k16 bf16 -> f32: the warp's
// Q fragments stay in registers across the KV loop, the online softmax
// runs on the f32 accumulators (row max by quad shuffles; scores scaled by
// log2(e) / sqrt(D) in f32 so the exponentials are exp2), and P, rounded
// to bf16, is the A fragment of P V.  The KV loop runs from the window's
// first key to the tile's last causal key (the Pallas kernel's tile skip,
// flash_attention.py:36-40), only tiles that cross the diagonal or the
// window edge are masked, keys past the range are zero-filled, rows past S
// and idle rows (64 % G != 0) are never stored.  Heavy (late) query tiles
// of every head launch first.  Not done yet: wgmma with TMA and a
// producer warp (the card's full tensor-core rate).
//
// float32: flash_scalar_kernel on the CUDA cores (TF32 tensor cores would
// miss the 1e-4 tolerance).  The same CTA geometry; K/V tiles of 32 keys
// widened in shared memory; a thread scores 4 rows x 4 keys (8 shared
// loads per 16 multiply-adds), the 8 lanes of a row group reduce the row's
// max and sum with shuffles, the probabilities pass through shared memory,
// and each thread accumulates its 4 rows x D / 8 output dims.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace spin {
namespace flash {

constexpr float kNeg = -1e30f;       // masked score (reference: NEG)
constexpr int kThreads = 128;
constexpr int kRows = 64;            // query rows (token, head) per CTA
constexpr int kMaxD = 128;

// Query tile t0 and KV range [kv_lo, kv_hi) of the CTA with linear index
// idx; heavy (late) query tiles of every (kv head, batch row) come first.
struct Tile {
  int h, b, t0, t_last, kv_lo, kv_hi;
};

__device__ __forceinline__ Tile tile_of(int idx, int n_tiles, int B, int S,
                                        int Kh, int tq, int window) {
  Tile t;
  const int hb = idx % (Kh * B);
  t.h = hb % Kh;
  t.b = hb / Kh;
  const int tile = n_tiles - 1 - idx / (Kh * B);
  t.t0 = tile * tq;
  t.t_last = min(S - 1, t.t0 + tq - 1);
  t.kv_lo = window > 0 ? max(0, t.t0 - window + 1) : 0;
  t.kv_hi = t.t_last + 1;
  return t;
}

// --------------------------------------------------- bf16, tensor cores --

namespace mma {

constexpr int kKeys = 64;            // keys per K/V tile
constexpr int kPad = 8;              // bf16 of row padding (16 bytes)

inline size_t smem_bytes(int D) {
  // Q, then two stages of K and two of V
  return sizeof(__nv_bfloat16) * size_t(kRows + 4 * kKeys) * (D + kPad);
}

// cp.async, ldmatrix and mma.sync: mma_sync.cuh (shared with
// verify_runs.cuh's tensor-core path)
using namespace ::spin::tc;

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    flash_mma_kernel(const __nv_bfloat16* __restrict__ q,
                     const __nv_bfloat16* __restrict__ k,
                     const __nv_bfloat16* __restrict__ v,
                     __nv_bfloat16* __restrict__ out, int B, int S, int H,
                     int Kh, int window, int n_qtiles, float scale_log2) {
  constexpr int LD = D + kPad;       // shared row stride, elements
  constexpr int KD = D / 16;         // k-steps of Q K^T
  constexpr int ND = D / 8;          // n-blocks (8 dims) of the output
  constexpr int CH = D / 8;          // 16-byte chunks per row
  constexpr int NK = kKeys / 8;      // n-blocks (8 keys) of a score tile
  extern __shared__ __align__(16) unsigned char flash_smem[];
  __nv_bfloat16* qs = reinterpret_cast<__nv_bfloat16*>(flash_smem);
  __nv_bfloat16* ks = qs + kRows * LD;           // [2][kKeys][LD]
  __nv_bfloat16* vs = ks + 2 * kKeys * LD;       // [2][kKeys][LD]

  const int G = H / Kh;
  const int tq = kRows / G;
  const int rows = tq * G;
  const Tile T = tile_of(blockIdx.x, n_qtiles, B, S, Kh, tq, window);
  const int n_kv = (T.kv_hi - T.kv_lo + kKeys - 1) / kKeys;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const long long kv_row = static_cast<long long>(Kh) * D;  // key stride
  const long long kv0 = (static_cast<long long>(T.b) * S * Kh + T.h) * D;

  // queries of the tile; idle rows and rows past S are zero-filled
  for (int c = tid; c < kRows * CH; c += kThreads) {
    const int r = c / CH;
    const int ch = c - r * CH;
    const int t = T.t0 + r / G;
    const bool ok = r < rows && t < S;
    const long long src =
        ok ? ((static_cast<long long>(T.b) * S + t) * H + T.h * G + r % G) *
                     D + ch * 8
           : 0;
    cp_async16(smem_u32(qs + r * LD + ch * 8), q + src, ok);
  }
  // K/V tile j into stage st; keys past kv_hi are zero-filled
  auto load_kv = [&](int j, int st) {
    const int s0 = T.kv_lo + j * kKeys;
    __nv_bfloat16* kd = ks + st * kKeys * LD;
    __nv_bfloat16* vd = vs + st * kKeys * LD;
    for (int c = tid; c < kKeys * CH; c += kThreads) {
      const int key = c / CH;
      const int ch = c - key * CH;
      const bool ok = s0 + key < T.kv_hi;
      const long long src = ok ? kv0 + (s0 + key) * kv_row + ch * 8 : 0;
      cp_async16(smem_u32(kd + key * LD + ch * 8), k + src, ok);
      cp_async16(smem_u32(vd + key * LD + ch * 8), v + src, ok);
    }
  };
  load_kv(0, 0);
  cp_async_commit();                 // group 0: Q and K/V tile 0

  // this thread's two rows of the warp's 16: g and g + 8
  const int g = lane >> 2;
  const int q4 = lane & 3;
  int tpos[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) tpos[i] = T.t0 + (warp * 16 + g + 8 * i) / G;
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};           // this thread's share of the row sums
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  uint32_t qf[KD][4];

  for (int j = 0; j < n_kv; ++j) {
    const int st = j & 1;
    if (j + 1 < n_kv) {
      load_kv(j + 1, st ^ 1);        // that stage was released at j - 1
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    if (j == 0) {
#pragma unroll
      for (int kk = 0; kk < KD; ++kk)
        ldsm_x4(qf[kk], smem_u32(qs + (warp * 16 + (lane & 15)) * LD +
                                 kk * 16 + (lane >> 4) * 8));
    }
    const __nv_bfloat16* kt = ks + st * kKeys * LD;
    const __nv_bfloat16* vt = vs + st * kKeys * LD;

    // S = Q K^T: 16 rows x 64 keys per warp
    float s[NK][4];
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int jp = 0; jp < NK / 2; ++jp) {
        uint32_t b[4];
        ldsm_x4(b, smem_u32(kt + (jp * 16 + (lane >> 4) * 8 + (lane & 7)) * LD +
                            kk * 16 + ((lane >> 3) & 1) * 8));
        mma_16816(s[2 * jp], qf[kk], b[0], b[1]);
        mma_16816(s[2 * jp + 1], qf[kk], b[2], b[3]);
      }
    }

    // masks (only on tiles crossing the diagonal or the window edge) and
    // the online softmax; element c of block n is row g + 8 (c >> 1), key
    // s0 + 8 n + 2 q4 + (c & 1)
    const int s0 = T.kv_lo + j * kKeys;
    const bool full = s0 + kKeys - 1 <= T.t0 &&
                      (window <= 0 || s0 > T.t_last - window);
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * scale_log2;
        if (!full) {
          const int key = s0 + 8 * n + 2 * q4 + (c & 1);
          const int t = tpos[c >> 1];
          if (key > t || (window > 0 && key <= t - window)) x = kNeg;
        }
        s[n][c] = x;
      }
    float corr[2], m_safe[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = kNeg;
#pragma unroll
      for (int n = 0; n < NK; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * i], s[n][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m[i], mx);
      m_safe[i] = fmaxf(m_new, -1e29f);
      corr[i] = m[i] > -CUDART_INF_F ? exp2f(m[i] - m_safe[i]) : 0.f;
      m[i] = m_new;
    }
    // masked scores give exp2(-1e30 - m_safe) = 0
    float sum[2] = {0.f, 0.f};
#pragma unroll
    for (int n = 0; n < NK; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = exp2f(s[n][c] - m_safe[c >> 1]);
        s[n][c] = p;
        sum[c >> 1] += p;
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) l[i] = l[i] * corr[i] + sum[i];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      o[n][0] *= corr[0];
      o[n][1] *= corr[0];
      o[n][2] *= corr[1];
      o[n][3] *= corr[1];
    }

    // O += P V, P in bf16 as the A fragment
#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t a[4];
      a[0] = pack_bf16(s[2 * kk][0], s[2 * kk][1]);
      a[1] = pack_bf16(s[2 * kk][2], s[2 * kk][3]);
      a[2] = pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      a[3] = pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nd = 0; nd < ND / 2; ++nd) {
        uint32_t b[4];
        ldsm_x4_trans(b, smem_u32(vt + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                        (lane & 7)) * LD +
                                  nd * 16 + (lane >> 4) * 8));
        mma_16816(o[2 * nd], a, b[0], b[1]);
        mma_16816(o[2 * nd + 1], a, b[2], b[3]);
      }
    }
    __syncthreads();                 // stage st is free for tile j + 2
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = warp * 16 + g + 8 * i;
    if (r >= rows || tpos[i] >= S) continue;
    __nv_bfloat16* orow =
        out + ((static_cast<long long>(T.b) * S + tpos[i]) * H + T.h * G +
               r % G) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const float x0 = l[i] > 0.f ? o[n][2 * i] / denom : 0.f;
      const float x1 = l[i] > 0.f ? o[n][2 * i + 1] / denom : 0.f;
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n + 2 * q4) =
          __floats2bfloat162_rn(x0, x1);
    }
  }
}

template <int D>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int Kh, int window, float scale,
                  cudaStream_t stream) {
  const int tq = kRows / (H / Kh);
  const int n_qtiles = (S + tq - 1) / tq;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_mma_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_mma_kernel<D><<<n_qtiles * Kh * B, kThreads, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      B, S, H, Kh, window, n_qtiles, scale * 1.4426950408889634f);
  return 0;
}

}  // namespace mma

// ---------------------------------------------- float32, CUDA cores --

namespace scalar {

constexpr int kKeys = 32;            // keys per shared tile
constexpr int kLanesPerRow = 8;      // lanes sharing a row group
constexpr int kRowGroups = kThreads / kLanesPerRow;  // 16
constexpr int kRowsPerThread = kRows / kRowGroups;   // 4
constexpr int kKeysPerThread = kKeys / kLanesPerRow; // 4
constexpr int kDimsPerThread = kMaxD / kLanesPerRow; // 16

inline size_t smem_bytes(int D) {
  return sizeof(float) * (size_t(kRows) * (D + 1) + size_t(kKeys) * (D + 1) +
                          size_t(kKeys) * D + size_t(kRows) * (kKeys + 1));
}

__global__ void __launch_bounds__(kThreads)
    flash_scalar_kernel(const float* __restrict__ q,
                        const float* __restrict__ k,
                        const float* __restrict__ v, float* __restrict__ out,
                        int B, int S, int H, int Kh, int D, int window,
                        int n_qtiles, float scale) {
  extern __shared__ __align__(16) unsigned char flash_smem[];
  float* qs = reinterpret_cast<float*>(flash_smem);  // [kRows][D+1], scaled
  float* ks = qs + kRows * (D + 1);        // [kKeys][D+1]
  float* vs = ks + kKeys * (D + 1);        // [kKeys][D]
  float* ps = vs + kKeys * D;              // [kRows][kKeys+1]

  const int G = H / Kh;
  const int tq = kRows / G;                // tokens per tile
  const int rows = tq * G;
  const Tile T = tile_of(blockIdx.x, n_qtiles, B, S, Kh, tq, window);
  const int h = T.h, b = T.b, t0 = T.t0;

  const int tid = threadIdx.x;
  const int rg = tid / kLanesPerRow;       // row group: rows rg + 16 i
  const int kg = tid % kLanesPerRow;       // keys kg + 8 j, dims kg + 8 dd

  // queries of the tile: row r = (token t0 + r / G, head h G + r % G); a
  // token's G heads are contiguous in memory
  for (int e = tid; e < rows * D; e += kThreads) {
    const int r = e / D;
    const int t = t0 + r / G;
    const int d = e - r * D;
    float x = 0.f;
    if (t < S)
      x = q[((static_cast<long long>(b) * S + t) * H + h * G + r % G) * D +
            d] * scale;
    qs[r * (D + 1) + d] = x;
  }

  int tpos[kRowsPerThread];
  bool live[kRowsPerThread];
  float m[kRowsPerThread], l[kRowsPerThread];
  float acc[kRowsPerThread][kDimsPerThread];
#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    const int r = rg + kRowGroups * i;
    tpos[i] = t0 + r / G;
    live[i] = r < rows && tpos[i] < S;
    m[i] = -CUDART_INF_F;
    l[i] = 0.f;
#pragma unroll
    for (int dd = 0; dd < kDimsPerThread; ++dd) acc[i][dd] = 0.f;
  }

  for (int s0 = T.kv_lo; s0 < T.kv_hi; s0 += kKeys) {
    const int n = min(kKeys, T.kv_hi - s0);
    __syncthreads();  // the previous tile's K/V/P are consumed
    for (int e = tid; e < n * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const long long src =
          ((static_cast<long long>(b) * S + s0 + j) * Kh + h) * D + d;
      ks[j * (D + 1) + d] = k[src];
      vs[j * D + d] = v[src];
    }
    __syncthreads();

    // scores of 4 rows x 4 keys
    float s[kRowsPerThread][kKeysPerThread];
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) s[i][j] = 0.f;
    const float* qr = qs + rg * (D + 1);
    const float* kr = ks + kg * (D + 1);
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[kRowsPerThread], kv[kKeysPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        qv[i] = qr[i * kRowGroups * (D + 1) + d];
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j)
        kv[j] = kr[j * kLanesPerRow * (D + 1) + d];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
#pragma unroll
        for (int j = 0; j < kKeysPerThread; ++j)
          s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

    // online softmax per row; the 8 lanes of a row group hold its 32 keys
#pragma unroll
    for (int i = 0; i < kRowsPerThread; ++i) {
      bool ok[kKeysPerThread];
      float mx = kNeg;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const int key = kg + kLanesPerRow * j;
        const int kpos = s0 + key;
        ok[j] = live[i] && key < n && kpos <= tpos[i] &&
                (window <= 0 || kpos > tpos[i] - window);
        if (!ok[j]) s[i][j] = kNeg;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < kLanesPerRow; o <<= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float m_new = fmaxf(m[i], mx);
      const float m_safe = fmaxf(m_new, -1e29f);
      float sum = 0.f;
      const int r = rg + kRowGroups * i;
#pragma unroll
      for (int j = 0; j < kKeysPerThread; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_safe) : 0.f;
        sum += p;
        ps[r * (kKeys + 1) + kg + kLanesPerRow * j] = p;
      }
#pragma unroll
      for (int o = 1; o < kLanesPerRow; o <<= 1)
        sum += __shfl_xor_sync(0xffffffffu, sum, o);
      const float corr = m[i] > -CUDART_INF_F ? expf(m[i] - m_safe) : 0.f;
      l[i] = l[i] * corr + sum;
      m[i] = m_new;
#pragma unroll
      for (int dd = 0; dd < kDimsPerThread; ++dd) acc[i][dd] *= corr;
    }
    __syncthreads();

    // acc += P V over the tile's keys
    for (int j = 0; j < n; ++j) {
      float pj[kRowsPerThread];
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        pj[i] = ps[(rg + kRowGroups * i) * (kKeys + 1) + j];
      const float* vr = vs + j * D;
#pragma unroll
      for (int dd = 0; dd < kDimsPerThread; ++dd) {
        const int d = kg + kLanesPerRow * dd;
        if (d < D) {
          const float x = vr[d];
#pragma unroll
          for (int i = 0; i < kRowsPerThread; ++i)
            acc[i][dd] = fmaf(pj[i], x, acc[i][dd]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < kRowsPerThread; ++i) {
    if (!live[i]) continue;
    const int r = rg + kRowGroups * i;
    float* orow = out + ((static_cast<long long>(b) * S + tpos[i]) * H +
                         h * G + r % G) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDimsPerThread; ++dd) {
      const int d = kg + kLanesPerRow * dd;
      if (d < D) orow[d] = l[i] > 0.f ? acc[i][dd] / denom : 0.f;
    }
  }
}

static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int Kh, int D, int window, float scale,
                  cudaStream_t stream) {
  const int tq = kRows / (H / Kh);
  const int n_qtiles = (S + tq - 1) / tq;
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_scalar_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_scalar_kernel<<<n_qtiles * Kh * B, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(out), B, S, H, Kh,
      D, window, n_qtiles, scale);
  return 0;
}

}  // namespace scalar

inline bool bad_geometry(int B, int S, int H, int Kh) {
  return B < 0 || S < 0 || Kh <= 0 || H % Kh != 0 || H / Kh > kRows;
}

}  // namespace flash
}  // namespace spin

// q, out (B, S, H, D); k, v (B, S, Kh, D); bfloat16, contiguous.
// H / Kh <= 64, D in {64, 96, 128}.  Returns cudaGetLastError() after the
// launch (0 = launched).
extern "C" int spin_flash_attention_bf16(const void* q, const void* k,
                                         const void* v, void* out, int B,
                                         int S, int H, int Kh, int D,
                                         int window, float scale,
                                         void* stream) {
  using namespace spin::flash;
  if (bad_geometry(B, S, H, Kh))
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  switch (D) {
#define SPIN_FLASH_D(DD) \
  case DD:               \
    rc = mma::launch<DD>(q, k, v, out, B, S, H, Kh, window, scale, st); \
    break;
    SPIN_FLASH_D(64)
    SPIN_FLASH_D(96)
    SPIN_FLASH_D(128)
#undef SPIN_FLASH_D
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

// q, out (B, S, H, D); k, v (B, S, Kh, D); float32, contiguous.
// H / Kh <= 64, D <= 128.  Returns cudaGetLastError() after the launch.
extern "C" int spin_flash_attention_f32(const void* q, const void* k,
                                        const void* v, void* out, int B,
                                        int S, int H, int Kh, int D,
                                        int window, float scale,
                                        void* stream) {
  using namespace spin::flash;
  if (bad_geometry(B, S, H, Kh) || D <= 0 || D > kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  const int rc = scalar::launch(q, k, v, out, B, S, H, Kh, D, window, scale,
                                static_cast<cudaStream_t>(stream));
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
