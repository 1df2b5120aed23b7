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
// What the design does about it (a simple first design, CUDA cores only):
// one CTA per (batch row, kv head, query tile) holds 64 query rows, the
// G query heads of that kv head for 64 / G consecutive tokens, so every
// K/V element brought into shared memory serves all G heads and all the
// tile's tokens.  The KV loop starts at the window's first key and stops
// at the tile's last causal key (the tile skipping of the Pallas kernel,
// flash_attention.py:36-40), so windowed prefill costs O(S x window), and
// the ragged ends (S not a multiple of the tile) are masked in the kernel,
// with no padded copy.  128 threads form 16 row groups of 8 lanes; a
// thread scores 4 rows x 4 keys of each 32-key tile from shared memory
// (register blocking: 8 shared loads per 16 multiply-adds), the 8 lanes of
// a row group reduce the row's max and sum with shuffles, the
// probabilities pass through shared memory, and each thread accumulates
// its 4 rows x D / 8 output dims.  Heavy tiles (late queries, causal) are
// launched first.  Not done yet: tensor cores (mma/wgmma), TMA and double
// buffered tile loads.
#include "paged_common.cuh"

namespace spin {
namespace flash {

constexpr int kThreads = 128;
constexpr int kRows = 64;            // query rows (token, head) per CTA
constexpr int kKeys = 32;            // keys per shared tile
constexpr int kLanesPerRow = 8;      // lanes sharing a row group
constexpr int kRowGroups = kThreads / kLanesPerRow;  // 16
constexpr int kRowsPerThread = kRows / kRowGroups;   // 4
constexpr int kKeysPerThread = kKeys / kLanesPerRow; // 4
constexpr int kMaxD = 128;
constexpr int kDimsPerThread = kMaxD / kLanesPerRow; // 16

inline size_t smem_bytes(int D) {
  return sizeof(float) * (size_t(kRows) * (D + 1) + size_t(kKeys) * (D + 1) +
                          size_t(kKeys) * D + size_t(kRows) * (kKeys + 1));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ out,
                           int S, int H, int Kh, int D, int window,
                           float scale) {
  extern __shared__ float smem_raw[];
  float* qs = smem_raw;                    // [kRows][D+1], pre-scaled
  float* ks = qs + kRows * (D + 1);        // [kKeys][D+1]
  float* vs = ks + kKeys * (D + 1);        // [kKeys][D]
  float* ps = vs + kKeys * D;              // [kRows][kKeys+1]

  const int G = H / Kh;
  const int tq = kRows / G;                // tokens per tile
  const int rows = tq * G;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tile = gridDim.x - 1 - blockIdx.x;   // heavy (late) tiles first
  const int t0 = tile * tq;
  const int t_last = min(S - 1, t0 + tq - 1);
  const int kv_lo = window > 0 ? max(0, t0 - window + 1) : 0;
  const int kv_hi = t_last + 1;            // keys [kv_lo, kv_hi)

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
      x = to_f32(q[((static_cast<long long>(b) * S + t) * H + h * G + r % G) *
                       D + d]) * scale;
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

  for (int s0 = kv_lo; s0 < kv_hi; s0 += kKeys) {
    const int n = min(kKeys, kv_hi - s0);
    __syncthreads();  // the previous tile's K/V/P are consumed
    for (int e = tid; e < n * D; e += kThreads) {
      const int j = e / D;
      const int d = e - j * D;
      const long long src =
          ((static_cast<long long>(b) * S + s0 + j) * Kh + h) * D + d;
      ks[j * (D + 1) + d] = to_f32(k[src]);
      vs[j * D + d] = to_f32(v[src]);
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
    T* orow = out + ((static_cast<long long>(b) * S + tpos[i]) * H + h * G +
                     r % G) * D;
    const float denom = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int dd = 0; dd < kDimsPerThread; ++dd) {
      const int d = kg + kLanesPerRow * dd;
      if (d < D) store_f32(l[i] > 0.f ? acc[i][dd] / denom : 0.f, orow + d);
    }
  }
}

template <typename T>
static int launch(const void* q, const void* k, const void* v, void* out,
                  int B, int S, int H, int Kh, int D, int window, float scale,
                  cudaStream_t stream) {
  const int tq = kRows / (H / Kh);
  dim3 grid((S + tq - 1) / tq, Kh, B);
  const size_t smem = smem_bytes(D);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  flash_attention_kernel<T><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out), S, H, Kh, D, window,
      scale);
  return 0;
}

}  // namespace flash
}  // namespace spin

// q, out (B, S, H, D); k, v (B, S, Kh, D); all float32 (dtype 0) or bf16
// (dtype 1), contiguous.  H / Kh <= 64, D <= 128.  Returns
// cudaGetLastError() after the launch (0 = launched).
extern "C" int spin_flash_attention(const void* q, const void* k,
                                    const void* v, void* out, int B, int S,
                                    int H, int Kh, int D, int window,
                                    int dtype, float scale, void* stream) {
  using namespace spin;
  if (B < 0 || S < 0 || Kh <= 0 || H % Kh != 0 || H / Kh > flash::kRows ||
      D <= 0 || D > flash::kMaxD)
    return static_cast<int>(cudaErrorInvalidValue);
  if (B == 0 || S == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc;
  if (dtype == kF32)
    rc = flash::launch<float>(q, k, v, out, B, S, H, Kh, D, window, scale,
                              st);
  else if (dtype == kBF16)
    rc = flash::launch<__nv_bfloat16>(q, k, v, out, B, S, H, Kh, D, window,
                                      scale, st);
  else
    rc = static_cast<int>(cudaErrorInvalidValue);
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}
