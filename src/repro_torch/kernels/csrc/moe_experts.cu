// moe_experts: the dropless grouped experts.  Every routed (token, choice)
// pair goes through its expert's SwiGLU and is weighted by its routing
// weight; the wrapper sums a token's top_k rows.
//
// Replaces no TPU kernel: the JAX package computes its experts over a
// capacity-bounded (E, C) grid by batched matmuls (src/repro/models/moe.py,
// left to XLA).  A capacity drops pairs, and a dropped pair breaks SPIN's
// promise that the served tokens are the LLM's greedy ones; a grid wide
// enough to drop nothing (C = T) computes E x T rows of which T x top_k are
// real.  Public through kernels/ops.moe_experts.
//
// What bounds it on the H100: the weights of the experts routed to, read
// once (3 d ff elements an expert: 12.6 MB at d 2048, ff 1024 in bf16).  A
// packed verify of 640 tokens at top-8 over 128 experts gives about 40
// pairs an expert, some 80 operations a weight byte, under the ~295 at
// which the tensor cores would bound it; a decode step's 8 pairs give 8.
//
// What the design does about it.  The wrapper (kernels/moe_experts.py,
// ``plan``) sorts the pairs by expert on the card and cuts them into tiles
// of BM (16, 32 or 64) pairs of one expert, over a grid sized from what the
// host knows; tiles past the real ones exit before they read anything.
// Two launches, one C call:
// - gate_up: one CTA per (tile, 64 of the ff columns) gathers its pairs'
//   token rows of x and streams that column block of the expert's gate and
//   up matrices once for all of them; the SwiGLU silu(g) * u runs on the
//   float32 accumulators and is stored, rounded to x's type, at the pair's
//   sorted row of h (P, ff);
// - down: one CTA per (tile, 64 of the d columns) reads its sorted rows of
//   h and streams the down matrix's column block once; the pair's routing
//   weight scales the float32 accumulators, stored at the pair's own row
//   of y (P, d), so that each token's rows are summed in a fixed order.
// bf16 (experts_mma_kernel): four warps; tiles of A (pairs x 64) and B
// (64 x 64, per weight matrix) enter shared memory by 16-byte cp.async
// copies, rows padded by 16 bytes for conflict-free ldmatrix, in a ring of
// stages (the next tiles in flight while one is multiplied); products on
// mma.sync m16n8k16 bf16 -> f32 (mma_sync.cuh), B through ldmatrix.trans
// (the weights are stored (in, out), out contiguous).  Rows and columns
// past the edge are zero-filled and never stored.
// float32 (experts_f32_kernel, test and lossless paths; TF32 would miss
// their tolerances): the same grid and tiles on the CUDA cores, each thread
// BM / 8 rows x 4 columns of each product.  Not done yet: wgmma with TMA.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_sync.cuh"

namespace spin {
namespace moe {

using namespace ::spin::tc;

constexpr int kThreads = 128;
constexpr int kBN = 64;              // output columns a CTA
constexpr int kBK = 64;              // reduction step (bf16)
constexpr int kPad = 8;              // bf16 of row padding (16 bytes)
constexpr int kLdA = kBK + kPad;     // shared row stride of A, elements
constexpr int kLdB = kBN + kPad;     // shared row stride of B, elements

// One launch's operands.  gate_up: a = x (T, Kd = d), w0 / w1 the gate and
// up matrices (E, d, N = ff), out = h (P, ff).  down: a = h (P, Kd = ff),
// w0 the down matrix (E, ff, N = d), w1 unused, out = y (P, d) float32.
struct Args {
  const void* a;
  const int* order;     // (P,) pair t * K + j, sorted by expert
  const int* expert;    // per tile: its expert, -1 past the real tiles
  const int* start;     // per tile: its first sorted row
  const int* end;       // per tile: the end of its expert's sorted rows
  const void* w0;
  const void* w1;
  const float* wts;     // (P,) routing weight of each pair (down)
  void* out;
  int Kd, N, K;
};

template <int BM>
__host__ __device__ constexpr int stages() {
  return BM == 64 ? 3 : 4;
}

template <int BM, bool GATED>
constexpr size_t mma_smem_bytes() {
  return sizeof(__nv_bfloat16) * size_t(stages<BM>()) *
         (BM * kLdA + (GATED ? 2 : 1) * kBK * kLdB);
}

// Offset (elements) of tile row r's A row, -1 where the tile has no row r.
template <bool GATED>
__device__ __forceinline__ long long a_row(const Args& g, int row, int hi) {
  if (row >= hi) return -1;
  return GATED ? static_cast<long long>(g.order[row] / g.K) * g.Kd
               : static_cast<long long>(row) * g.Kd;
}

// --------------------------------------------------- bf16, tensor cores --

template <int BM, bool GATED>
__global__ void __launch_bounds__(kThreads)
    experts_mma_kernel(Args g) {
  constexpr int S = stages<BM>();
  constexpr int WM = BM / 16;        // warps along the rows
  constexpr int WN = 4 / WM;         // warps along the columns
  constexpr int NW = kBN / WN;       // columns a warp
  constexpr int NB = NW / 8;         // n8 blocks a warp
  constexpr int NM = GATED ? 2 : 1;  // weight matrices
  extern __shared__ __align__(16) unsigned char moe_smem[];
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(moe_smem);
  __nv_bfloat16* bs = as + S * BM * kLdA;          // [S][NM][kBK][kLdB]
  __shared__ long long rows[BM];

  const int e = g.expert[blockIdx.x];
  if (e < 0) return;
  const int lo = g.start[blockIdx.x];
  const int hi = min(lo + BM, g.end[blockIdx.x]);
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int wm = warp % WM;
  const int wn = warp / WM;
  for (int r = tid; r < BM; r += kThreads) rows[r] = a_row<GATED>(g, lo + r, hi);
  __syncthreads();

  const __nv_bfloat16* A = static_cast<const __nv_bfloat16*>(g.a);
  const long long wbase = static_cast<long long>(e) * g.Kd * g.N;
  const __nv_bfloat16* W[2] = {
      static_cast<const __nv_bfloat16*>(g.w0) + wbase,
      GATED ? static_cast<const __nv_bfloat16*>(g.w1) + wbase : nullptr};
  auto load = [&](int kt, int st) {
    const int k0 = kt * kBK;
    __nv_bfloat16* ad = as + st * BM * kLdA;
    for (int c = tid; c < BM * (kBK / 8); c += kThreads) {
      const int r = c >> 3;
      const int ch = c & 7;
      const long long src = rows[r];
      const bool ok = src >= 0 && k0 + ch * 8 < g.Kd;
      cp_async16(smem_u32(ad + r * kLdA + ch * 8),
                 ok ? A + src + k0 + ch * 8 : A, ok);
    }
#pragma unroll
    for (int m = 0; m < NM; ++m) {
      __nv_bfloat16* bd = bs + (st * NM + m) * kBK * kLdB;
      for (int c = tid; c < kBK * (kBN / 8); c += kThreads) {
        const int kr = c >> 3;
        const int ch = c & 7;
        const bool ok = k0 + kr < g.Kd && n0 + ch * 8 < g.N;
        cp_async16(smem_u32(bd + kr * kLdB + ch * 8),
                   ok ? W[m] + static_cast<long long>(k0 + kr) * g.N + n0 +
                            ch * 8
                      : W[0],
                   ok);
      }
    }
  };

  float acc[NM][NB][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int n = 0; n < NB; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][n][c] = 0.f;

  const int nk = (g.Kd + kBK - 1) / kBK;
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < nk) load(s, s);
    cp_async_commit();
  }
  for (int kt = 0; kt < nk; ++kt) {
    cp_async_wait<S - 2>();          // step kt's group has landed
    __syncthreads();                 // ... for every thread; stage
                                     // (kt - 1) % S is free again
    if (kt + S - 1 < nk) load(kt + S - 1, (kt + S - 1) % S);
    cp_async_commit();
    const int st = kt % S;
    const __nv_bfloat16* at = as + st * BM * kLdA;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4];
      ldsm_x4(a, smem_u32(at + (wm * 16 + (lane & 15)) * kLdA + kk * 16 +
                          (lane >> 4) * 8));
#pragma unroll
      for (int m = 0; m < NM; ++m) {
        const __nv_bfloat16* bt = bs + (st * NM + m) * kBK * kLdB;
#pragma unroll
        for (int j = 0; j < NB / 2; ++j) {
          uint32_t b[4];
          ldsm_x4_trans(b, smem_u32(bt + (kk * 16 + ((lane >> 3) & 1) * 8 +
                                          (lane & 7)) * kLdB +
                                    wn * NW + j * 16 + (lane >> 4) * 8));
          mma_16816(acc[m][2 * j], a, b[0], b[1]);
          mma_16816(acc[m][2 * j + 1], a, b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  // element c of block n: row 16 wm + lane / 4 + 8 (c >> 1), column
  // n0 + wn NW + 8 n + 2 (lane % 4) + (c & 1)
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = lo + wm * 16 + (lane >> 2) + 8 * i;
    if (row >= hi) continue;
    float w = 1.f;
    long long orow;
    if (GATED) {
      orow = static_cast<long long>(row) * g.N;
    } else {
      const int pair = g.order[row];
      w = g.wts[pair];
      orow = static_cast<long long>(pair) * g.N;
    }
#pragma unroll
    for (int n = 0; n < NB; ++n) {
      const int col = n0 + wn * NW + 8 * n + 2 * (lane & 3);
      if (col >= g.N) continue;
      const float x0 = acc[0][n][2 * i];
      const float x1 = acc[0][n][2 * i + 1];
      if (GATED) {
        const float u0 = acc[NM - 1][n][2 * i];
        const float u1 = acc[NM - 1][n][2 * i + 1];
        *reinterpret_cast<__nv_bfloat162*>(
            static_cast<__nv_bfloat16*>(g.out) + orow + col) =
            __floats2bfloat162_rn(x0 / (1.f + __expf(-x0)) * u0,
                                  x1 / (1.f + __expf(-x1)) * u1);
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(g.out) + orow + col) =
            make_float2(x0 * w, x1 * w);
      }
    }
  }
}

template <int BM, bool GATED>
static int launch_mma(const Args& g, int n_tiles, cudaStream_t st) {
  const size_t smem = mma_smem_bytes<BM, GATED>();
  cudaError_t err = cudaFuncSetAttribute(
      experts_mma_kernel<BM, GATED>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(n_tiles, (g.N + kBN - 1) / kBN);
  experts_mma_kernel<BM, GATED><<<grid, kThreads, smem, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

// ------------------------------------------------ float32, CUDA cores --

constexpr int kBKf = 32;             // reduction step (float32)

template <int BM, bool GATED>
__global__ void __launch_bounds__(kThreads)
    experts_f32_kernel(Args g) {
  constexpr int NM = GATED ? 2 : 1;
  constexpr int RT = BM / 8;         // rows a thread
  __shared__ float as[BM][kBKf + 1];
  __shared__ float bs[NM][kBKf][kBN];
  __shared__ long long rows[BM];

  const int e = g.expert[blockIdx.x];
  if (e < 0) return;
  const int lo = g.start[blockIdx.x];
  const int hi = min(lo + BM, g.end[blockIdx.x]);
  const int n0 = blockIdx.y * kBN;
  const int tid = threadIdx.x;
  const int tx = tid & 15;           // columns tx + 16 j
  const int ty = tid >> 4;           // rows ty + 8 i
  for (int r = tid; r < BM; r += kThreads) rows[r] = a_row<GATED>(g, lo + r, hi);

  const float* A = static_cast<const float*>(g.a);
  const long long wbase = static_cast<long long>(e) * g.Kd * g.N;
  const float* W[2] = {static_cast<const float*>(g.w0) + wbase,
                       GATED ? static_cast<const float*>(g.w1) + wbase
                             : nullptr};
  float acc[NM][RT][4];
#pragma unroll
  for (int m = 0; m < NM; ++m)
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[m][i][j] = 0.f;

  for (int k0 = 0; k0 < g.Kd; k0 += kBKf) {
    __syncthreads();                 // rows[] written; last step's tiles read
    for (int c = tid; c < BM * kBKf; c += kThreads) {
      const int r = c / kBKf;
      const int kk = c - r * kBKf;
      const long long src = rows[r];
      as[r][kk] = src >= 0 && k0 + kk < g.Kd ? A[src + k0 + kk] : 0.f;
    }
#pragma unroll
    for (int m = 0; m < NM; ++m)
      for (int c = tid; c < kBKf * kBN; c += kThreads) {
        const int kr = c / kBN;
        const int cc = c - kr * kBN;
        bs[m][kr][cc] = k0 + kr < g.Kd && n0 + cc < g.N
                            ? W[m][static_cast<long long>(k0 + kr) * g.N +
                                   n0 + cc]
                            : 0.f;
      }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kBKf; ++kk) {
      float a[RT];
#pragma unroll
      for (int i = 0; i < RT; ++i) a[i] = as[ty + 8 * i][kk];
#pragma unroll
      for (int m = 0; m < NM; ++m)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const float b = bs[m][kk][tx + 16 * j];
#pragma unroll
          for (int i = 0; i < RT; ++i) acc[m][i][j] = fmaf(a[i], b, acc[m][i][j]);
        }
    }
  }

#pragma unroll
  for (int i = 0; i < RT; ++i) {
    const int row = lo + ty + 8 * i;
    if (row >= hi) continue;
    float w = 1.f;
    long long orow = static_cast<long long>(row) * g.N;
    if (!GATED) {
      const int pair = g.order[row];
      w = g.wts[pair];
      orow = static_cast<long long>(pair) * g.N;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int col = n0 + tx + 16 * j;
      if (col >= g.N) continue;
      const float x = acc[0][i][j];
      float* out = static_cast<float*>(g.out) + orow + col;
      if (GATED)
        *out = x / (1.f + expf(-x)) * acc[NM - 1][i][j];
      else
        *out = x * w;
    }
  }
}

template <int BM, bool GATED>
static int launch_f32(const Args& g, int n_tiles, cudaStream_t st) {
  const dim3 grid(n_tiles, (g.N + kBN - 1) / kBN);
  experts_f32_kernel<BM, GATED><<<grid, kThreads, 0, st>>>(g);
  return static_cast<int>(cudaGetLastError());
}

template <int BM>
static int launch_pair(bool bf16, const Args& gu, const Args& dn,
                       int n_tiles, cudaStream_t st) {
  int rc = bf16 ? launch_mma<BM, true>(gu, n_tiles, st)
                : launch_f32<BM, true>(gu, n_tiles, st);
  if (rc != 0) return rc;
  return bf16 ? launch_mma<BM, false>(dn, n_tiles, st)
              : launch_f32<BM, false>(dn, n_tiles, st);
}

}  // namespace moe
}  // namespace spin

// x (T, d); order (P,), P = T k, int32; expert, start, end (n_tiles,)
// int32, as kernels/moe_experts.py's plan makes them for tiles of bm
// pairs; w_gate, w_up (E, d, ff), w_down (E, ff, d) in x's type; wts (P,)
// float32; h (P, ff) in x's type and y (P, d) float32, written here.
// dtype 0 float32, 1 bf16; bf16 needs d and ff multiples of 8 (16-byte
// rows).  All contiguous.  Two launches on the stream; returns
// cudaGetLastError() after them.
extern "C" int spin_moe_experts(const void* x, const int* order,
                                const int* expert, const int* start,
                                const int* end, const void* w_gate,
                                const void* w_up, const void* w_down,
                                const float* wts, void* h, float* y,
                                int n_tiles, int d, int ff, int k, int bm,
                                int dtype, void* stream) {
  using namespace spin::moe;
  const bool bf16 = dtype == 1;
  if (n_tiles < 0 || d <= 0 || ff <= 0 || k <= 0 || (dtype != 0 && !bf16) ||
      (bf16 && (d % 8 != 0 || ff % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_tiles == 0) return 0;
  const Args gu{x, order, expert, start, end, w_gate, w_up, nullptr, h,
                d, ff, k};
  const Args dn{h, order, expert, start, end, w_down, nullptr, wts, y,
                ff, d, k};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (bm) {
    case 16: return launch_pair<16>(bf16, gu, dn, n_tiles, st);
    case 32: return launch_pair<32>(bf16, gu, dn, n_tiles, st);
    case 64: return launch_pair<64>(bf16, gu, dn, n_tiles, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
