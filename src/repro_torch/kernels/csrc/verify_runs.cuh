// The packed verify over a list of live pool blocks, shared by two entries:
// spin_fused_paged_verify (fused_verify.cu; the serving path's LLM verify,
// kernels/fused_verify.py) and spin_paged_verify_attention
// (paged_attention.cu; kernels/ops.py).  Both compute SPIN's packed
// verification (Eq. 13): segment, causality and tree masks, int8/fp8 blocks
// dequantized with the per-(slot, head) scale.
//
// What bounds it on the H100: the attended blocks' K/V read once over 3.35
// TB/s.  A request's K/V meets its W + 1 verify tokens times the GQA group
// (25-30 query rows at G 5-6), about 25-30 operations per K/V byte: on
// the CUDA cores' 67 TFLOP/s the arithmetic takes longer than the bytes,
// on the tensor cores' 989 a twelfth of it.
//
// What the design does about it: one CTA per (segment tile, group of kv
// heads, chunk).  The grid's x is the query token; the CTA of a token that
// does not start a tile of its segment's run of tokens exits after reading
// q_seg (a padding query, seg -1, first zeroes its own output rows).  A
// tile is up to kMmaRows / (G heads) tokens (kMaxRows / G, one head, on
// the CUDA-core path) of one contiguous run of tokens with the same q_seg;
// a segment's queries need not be contiguous, each run is tiled on its
// own.  The CTA reads the whole block list and keeps, by ballot in list
// order, the entries its segment owns (owners unsorted, padding entries -1
// never kept), so it streams only its segment's blocks, once for all its
// rows and heads (the scan, the slots' tags and the CTA's fixed costs are
// shared by its heads); a segment with no entry writes zeros and reads no
// K/V byte.  With chunks > 1 (the plan's split, kernels/paged_attention.py
// verify_plan: long lists a token) the segment's entries are dealt by
// rank to min(chunks, entries) chunks; each writes an unnormalised float32
// partial and the last to finish (a __threadfence, then an atomic counter
// per (tile, head group), reset by that CTA) merges them (merge_row,
// paged_common.cuh), in the same launch.  A chunk's share longer than its
// list in shared memory (`cap` entries) is streamed in windows.
//
// Scoring, by the input's dtype:
// - bf16 queries over bf16/int8/fp8 pools, D a multiple of 16: tensor
//   cores (paged_verify_mma_kernel).  The rows of a head (token t0 + r / G,
//   query head h G + r % G) form 16-row m-tiles; the four warps split into
//   (head, m-tile) units x key teams, each warp scoring its unit against
//   its team's share of every K/V tile (kKeys rows: kKeys / heads slots of
//   each head), 16 keys a step of a rolled loop (a step's code stays in
//   the instruction cache; a CTA's few tiles run cold otherwise): S = Q
//   K^T and O += P V as mma.sync m16n8k16 bf16 -> f32 (mma_sync.cuh), the
//   masks and the online softmax on the f32 accumulators, P rounded to
//   bf16 as the A fragment (flash_attention.cu's scheme).  K/V tiles
//   stream by cp.async in `stages` buffers (slots past the list
//   zero-filled); int8/fp8 tiles are widened to bf16 in shared memory
//   (exact), their K scale applied to the scores and their V scale to P.
//   At the end the key teams' states merge through shared memory and each
//   thread writes 8 dims of a row.
// - float32 queries or pools, or D not a multiple of 16: the CUDA-core
//   tile pipeline (tile_pipeline.cuh; paged_verify_scalar_kernel), up to
//   kMaxRows rows, float32 arithmetic.
#pragma once

#include <climits>
#include <type_traits>

#include "mma_sync.cuh"
#include "paged_common.cuh"
#include "tile_pipeline.cuh"

namespace spin {
namespace vseg {

constexpr int kKeys = 64;      // slots of a K/V tile (tensor-core path)
constexpr int kPad = 8;        // bf16 of row padding of an operand row
constexpr int kMmaRows = 64;   // query rows of a tensor-core CTA
constexpr int kMaxStages = 4;  // K/V buffers of the tensor-core path
constexpr int kScan = 8;       // list entries a thread reads a round
constexpr int kBatch = kThreads * kScan;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Arguments of one call (every pointer as the wrappers pass it).
struct Args {
  const void* q;
  const void* kp;
  const void* vp;
  const int* pool_seg;
  const int* pool_pos;
  const int* q_seg;
  const int* q_pos;
  const int* q_anc;
  const int* block_ids;
  const int* block_owner;
  const int* block_node;
  const float* ks;
  const float* vs;
  float* pm;
  float* pl;
  float* pacc;
  int* counters;
  void* out;
  int Tq, H, Kh, D, bs, M, tokens, span, chunks, cap, heads, wpt, stages;
  float scale;
  unsigned wlim;  // window_limit(window): the causal and window terms
};

// Shared memory.  Both paths: the chunk's list (block, and entry for trees
// on the tensor cores; both on the CUDA cores; cap each).  Tensor cores:
// `stages` stages (K and V rows of the pool's type, each padded by 16
// bytes; tag_arrays() 64-word tag arrays), then for
// int8/fp8 pools the tile's K and V widened to bf16 [kKeys][D + kPad];
// the key teams' merge buffer [kMmaRows][D + 4] float32 reuses the stages.
// CUDA cores: the queries [rows][D] float32, then tile_pipeline.cuh's
// stages.
__host__ __device__ inline size_t list_bytes(int cap, int lists = 2) {
  return lists * pipe::align16(sizeof(int) * size_t(cap));
}

__host__ __device__ inline int raw_row(int D, int es) { return D * es + 16; }

// 64-word tag arrays of a stage: owner word, seg, pos, then node (trees)
// and the k/v scales (int8/fp8 pools)
__host__ __device__ inline int tag_arrays(bool tree, bool quant) {
  return 3 + (tree ? 1 : 0) + (quant ? 2 : 0);
}

__host__ __device__ inline size_t mma_stage_bytes(int D, int es, bool tree) {
  return size_t(2) * kKeys * raw_row(D, es) +
         tag_arrays(tree, es == 1) * kKeys * sizeof(int);
}

__host__ __device__ inline size_t operand_bytes(int D) {
  return size_t(kKeys) * (D + kPad) * sizeof(__nv_bfloat16);
}

inline size_t mma_smem(int cap, int D, int es, int stages, bool tree) {
  size_t area = size_t(stages) * mma_stage_bytes(D, es, tree);
  if (es == 1) area += 2 * operand_bytes(D);
  const size_t merge = sizeof(float) * size_t(kMmaRows) * (D + 4);
  return list_bytes(cap, tree ? 2 : 1) + (area > merge ? area : merge);
}

inline size_t scalar_smem(int cap, int rows, int D, int es, int wpt,
                          int stages) {
  return list_bytes(cap) + pipe::align16(sizeof(float) * rows * D) +
         pipe::stages_smem(kWarps / wpt, stages, rows, D, es);
}

// Slot c of a chunk's list: live entry c / bs (the segment owns it).
struct SegMap {
  static constexpr bool kTags = true;
  const int* ent;  // entry index in block_ids (for block_node)
  const int* blk;  // physical block
  int seg;
  int bs;
  __device__ __forceinline__ bool operator()(int c, long long& slot,
                                             int& owner,
                                             long long& node) const {
    const int e = c / bs;
    const int s = c - e * bs;
    owner = seg;
    slot = static_cast<long long>(blk[e]) * bs + s;
    node = static_cast<long long>(ent[e]) * bs + s;
    return true;
  }
};

// A CTA's tile: its segment, first token, tokens and rows.
struct Tile {
  int seg, t0, nq, R;
};

// Zeros over rows [0, rows) of token t0 + r / G, head h G + r % G.
template <typename QT>
__device__ __forceinline__ void zero_rows(QT* out, int t0, int rows, int G,
                                          int H, int h, int D) {
  QT* base = out + (static_cast<long long>(t0) * H + h * G) * D;
  for (int i = threadIdx.x; i < rows * D; i += kThreads) {
    const int r = i / D;
    store_f32(0.f, base + static_cast<long long>(r / G) * H * D +
                       (r % G) * D + (i - r * D));
  }
}

// The q_seg window a CTA judges its tokens [base, base + span) from: lane
// l holds q_seg[base - 32 + l], q_seg[base + l] and q_seg[base + 32 + l]
// (kOut past either end), all requested at once.
constexpr int kOut = INT_MIN;

struct SegWindow {
  int w0, w1, w2, base;
};

__device__ __forceinline__ SegWindow load_window(const Args& a, int base) {
  const int lane = threadIdx.x & 31;
  const int i0 = base - 32 + lane, i1 = base + lane, i2 = base + 32 + lane;
  SegWindow w;
  w.base = base;
  w.w0 = i0 >= 0 ? a.q_seg[i0] : kOut;
  w.w1 = i1 < a.Tq ? a.q_seg[i1] : kOut;
  w.w2 = i2 < a.Tq ? a.q_seg[i2] : kOut;
  return w;
}

// The tile that token base + j starts (up to TQ tokens of its run of one
// segment), or false: a padding query (the rows of the CTA's hp kv heads
// zeroed by chunk 0) or a token inside a tile.  Every warp computes the
// same answer from the window (a run reaching past it is read 32 tokens at
// a time); no shared memory, no barrier.
template <typename QT>
__device__ __forceinline__ bool find_tile(const Args& a, const SegWindow& w,
                                          int j, int TQ, int hp, Tile& tl) {
  const int lane = threadIdx.x & 31;
  const int t = w.base + j;
  const int G = a.H / a.Kh;
  const int seg = __shfl_sync(0xffffffffu, w.w1, j);
  if (seg < 0) {
    if (blockIdx.z == 0)  // the hp kv heads' G query heads, contiguous
      zero_rows(static_cast<QT*>(a.out), t, hp * G, hp * G, a.H, blockIdx.y,
                a.D);
    return false;
  }
  // the run's first token: after the nearest earlier token of another
  // segment
  int start;
  const unsigned b1 = __ballot_sync(0xffffffffu, lane < j && w.w1 != seg);
  const unsigned b0 = __ballot_sync(0xffffffffu, w.w0 != seg);
  if (b1 != 0) {
    start = w.base + (31 - __clz(b1)) + 1;
  } else if (b0 != 0) {
    start = w.base - 32 + (31 - __clz(b0)) + 1;
  } else {  // lanes look at b - lane
    int b = w.base - 33;
    unsigned bal;
    while ((bal = __ballot_sync(0xffffffffu,
                                b - lane < 0 || a.q_seg[b - lane] != seg)) ==
           0)
      b -= 32;
    start = b - (__ffs(bal) - 1) + 1;
  }
  if ((t - start) % TQ != 0) return false;
  // the tile's end: the next token of another segment, at most TQ on
  int end = min(t + TQ, a.Tq);
  const unsigned e1 = __ballot_sync(0xffffffffu, lane > j && w.w1 != seg);
  const unsigned e2 = __ballot_sync(0xffffffffu, w.w2 != seg);
  if (e1 != 0) {
    end = min(end, w.base + __ffs(e1) - 1);
  } else if (e2 != 0) {
    end = min(end, w.base + 32 + __ffs(e2) - 1);
  } else {
    for (int b2 = w.base + 64; b2 < end; b2 += 32) {
      const int i = b2 + lane;
      const unsigned e = __ballot_sync(
          0xffffffffu, i < end && (i >= a.Tq || a.q_seg[i] != seg));
      if (e != 0) {
        end = b2 + __ffs(e) - 1;
        break;
      }
    }
  }
  tl.seg = seg;
  tl.t0 = t;
  tl.nq = end - t;
  tl.R = tl.nq * G;
  return true;
}

// Entries a chunk z of c holds among the first n of a segment's (by rank).
__device__ __forceinline__ int share(int n, int z, int c) {
  return n > z ? (n - z + c - 1) / c : 0;
}

// One window of the scan of the block list from entry `pos`: the entries
// the segment owns whose rank r has r % chunks == z go to the lists at
// r / chunks - before (in list order; l_ent may be null).  Stops at the
// list's end, or before a round that could overflow `cap` (never with an
// empty list: cap is at least a round's share).  Updates pos and n_seg
// (the segment's entries seen); returns the entries listed.  Every thread
// calls it.
__device__ __forceinline__ int scan_window(const Args& a, int seg, int z,
                                           int before, int* l_ent, int* l_blk,
                                           int* wcnt, int& pos, int& n_seg) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int c = a.chunks;
  int n_list = 0;
  while (pos < a.M) {
    const int take = min(kBatch, a.M - pos);
    if (n_list > 0 && n_list + share(n_seg + take, z, c) -
                              share(n_seg, z, c) > a.cap)
      break;
    int own[kScan], id[kScan];
    const int base = pos + warp * 32 * kScan + lane;
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int e = base + 32 * u;
      own[u] = e < a.M ? a.block_owner[e] : -1;
      id[u] = e < a.M ? a.block_ids[e] : 0;
    }
    unsigned bal[kScan];
    int cnt = 0;
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      bal[u] = __ballot_sync(0xffffffffu, own[u] == seg);
      cnt += __popc(bal[u]);
    }
    if (lane == 0) wcnt[warp] = cnt;
    __syncthreads();
    int r = n_seg, tot = 0;
    for (int w = 0; w < kWarps; ++w) {
      if (w < warp) r += wcnt[w];
      tot += wcnt[w];
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      if (own[u] == seg) {
        const int rr = r + __popc(bal[u] & ((1u << lane) - 1u));
        if (rr % c == z) {
          const int k = rr / c - before;
          if (l_ent != nullptr) l_ent[k] = base + 32 * u;
          l_blk[k] = max(id[u], 0);
        }
      }
      r += __popc(bal[u]);
    }
    n_list = share(n_seg + tot, z, c) - before;
    n_seg += tot;
    pos += take;
    __syncthreads();  // wcnt is free again
  }
  return n_list;
}

// Row r's result: the output (normalised; zeros where nothing was
// attended) when the tile has one chunk, else chunk z's partial (m in the
// natural-log domain, as merge_row reads it).
template <typename QT>
__device__ __forceinline__ void emit_row(const Args& a, const Tile& tl,
                                         int r, bool direct, float m,
                                         float l,
                                         const float (&acc)[kDimPerLane]) {
  const int G = a.H / a.Kh;
  const int lane = threadIdx.x & 31;
  const long long row = static_cast<long long>(tl.t0 + r / G) * a.H +
                        blockIdx.y * G + r % G;
  if (direct) {
    store_row(static_cast<QT*>(a.out) + row * a.D, a.D, l, acc);
    return;
  }
  const long long o =
      static_cast<long long>(blockIdx.z) * a.Tq * a.H + row;
  if (lane == 0) {
    a.pm[o] = m;
    a.pl[o] = l;
  }
  if (l > 0.f) {
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) {
      const int d = lane + 32 * i;
      if (d < a.D) a.pacc[o * a.D + d] = acc[i];
    }
  }
}

// After every row's partial: the last of the tile's `live` chunks to finish
// merges them into the output (the rows of the CTA's hp kv heads) and
// resets the counter.
template <typename QT>
__device__ __forceinline__ void merge_chunks(const Args& a, const Tile& tl,
                                             int hp, int live, int* is_last) {
  const int G = a.H / a.Kh;
  __threadfence();
  __syncthreads();
  int* count = a.counters + static_cast<long long>(tl.t0) * gridDim.y +
               blockIdx.y;
  if (threadIdx.x == 0) *is_last = atomicAdd(count, 1) == live - 1;
  __syncthreads();
  if (!*is_last) return;
  __threadfence();
  const long long stride = static_cast<long long>(a.Tq) * a.H;
  for (int x = threadIdx.x >> 5; x < hp * tl.R; x += kWarps) {
    const int r = x % tl.R;
    const long long row = static_cast<long long>(tl.t0 + r / G) * a.H +
                          (blockIdx.y * hp + x / tl.R) * G + r % G;
    merge_row(a.pm, a.pl, a.pacc, static_cast<QT*>(a.out) + row * a.D,
              stride, row, a.D, live);
  }
  if (threadIdx.x == 0) *count = 0;
}

// ------------------------------------------------------ tensor cores --

using namespace ::spin::tc;

// One tile of the tensor-core kernel (paged_verify_mma_kernel, below).
template <typename KT, bool kTree>
__device__ __forceinline__ void mma_tile(const Args& a, const Tile& tl,
                                         unsigned char* smem, int* wcnt,
                                         int* is_last) {
  using QT = __nv_bfloat16;
  constexpr bool kQuant = sizeof(KT) == 1;
  constexpr int es = sizeof(KT);
  const int G = a.H / a.Kh;
  const int HP = a.heads;  // kv heads of the CTA: h0 .. h0 + HP - 1
  __syncthreads();  // the CTA's previous tile is done with shared memory
  const int h0 = blockIdx.y * HP;
  const int z = blockIdx.z;
  const int D = a.D;
  const int LD = D + kPad;
  const int RB = raw_row(D, es);
  const int TS = kKeys / HP;  // slots of a tile: its kKeys K/V rows
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2;
  const int q4 = lane & 3;

  int* l_blk = reinterpret_cast<int*>(smem);
  int* l_ent = kTree ? reinterpret_cast<int*>(
                           smem + pipe::align16(sizeof(int) * a.cap))
                     : nullptr;
  unsigned char* stage0 = smem + list_bytes(a.cap, kTree ? 2 : 1);
  const size_t SB = mma_stage_bytes(D, es, kTree);
  constexpr int kNode = 3, kKsc = 3 + (kTree ? 1 : 0), kVsc = kKsc + 1;
  QT* conv = reinterpret_cast<QT*>(stage0 + a.stages * SB);  // int8/fp8

  // warps: units of (head, m-tile of 16 rows; MT a head, HP MT <= 4) x key
  // teams sharing a tile
  const int mtiles = (tl.R + 15) / 16;
  const int MT = mtiles <= 1 ? 1 : (mtiles <= 2 ? 2 : 4);
  const int units = HP * MT;
  const int teams = kWarps / units;
  const int unit = warp % units;
  const int hh = unit / MT;
  const int mt = unit % MT;
  const int team = warp / units;
  const int KK = TS / teams;  // keys a warp scores of each tile: 16 MT
  const int kbase = team * KK;
  const int KD = D / 16;         // k-steps of Q K^T
  const int ND = D / 8;          // 8-dim blocks of the output
  const bool rows_here = mt * 16 < tl.R;

  bool rok[2];
  int qpos[2], anc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = mt * 16 + g + 8 * i;
    rok[i] = r < tl.R;
    const int t = tl.t0 + (rok[i] ? r / G : 0);
    qpos[i] = a.q_pos[t];
    anc[i] = kTree ? a.q_anc[t] : 0;
  }
  float m[2] = {-CUDART_INF_F, -CUDART_INF_F};
  float l[2] = {0.f, 0.f};
  float o[kMaxD / 8][4];
#pragma unroll
  for (int n = 0; n < kMaxD / 8; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  // the warp's query fragments (rows g and g + 8 of its unit, dims 2 q4 and
  // 2 q4 + 8 of each k-step) straight from global memory, requested before
  // the list scan so that their latency hides behind it; rows past the
  // tile are zeros
  uint32_t qf[kMaxD / 16][4];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = mt * 16 + g + 8 * i;
    const QT* qrow =
        static_cast<const QT*>(a.q) +
        (static_cast<long long>(tl.t0 + (rok[i] ? r / G : 0)) * a.H +
         (h0 + hh) * G + r % G) * D + 2 * q4;
#pragma unroll
    for (int kk = 0; kk < kMaxD / 16; ++kk) {
      qf[kk][i] = 0u;
      qf[kk][2 + i] = 0u;
      if (kk < KD && rok[i] && rows_here) {
        qf[kk][i] = *reinterpret_cast<const uint32_t*>(qrow + kk * 16);
        qf[kk][2 + i] = *reinterpret_cast<const uint32_t*>(qrow + kk * 16 + 8);
      }
    }
  }
  const float sl = a.scale * kLog2e;

  const KT* kp = static_cast<const KT*>(a.kp);
  const KT* vp = static_cast<const KT*>(a.vp);
  const int C = D * es / 16;  // 16-byte chunks of a K/V row

  // K/V tile `tile` of the listed slots into stage st: thread pair 2j,
  // 2j + 1 takes row j, slot j % TS of head h0 + j / TS (alternate chunks);
  // a slot past the list is zero-filled and tagged -1
  auto issue = [&](int st, int tile, int n_slots) {
    unsigned char* base = stage0 + st * SB;
    int* tags = reinterpret_cast<int*>(base + 2 * kKeys * RB);
    const int j = threadIdx.x >> 1;
    const int half = threadIdx.x & 1;
    const int hs = j / TS;
    const int sj = j - hs * TS;
    const int c = tile * TS + sj;
    const bool ok = c < n_slots;
    long long slot = 0, nidx = 0;
    if (ok) {
      const int e = c / a.bs;
      const int s = c - e * a.bs;
      slot = static_cast<long long>(l_blk[e]) * a.bs + s;
      if (kTree) nidx = static_cast<long long>(l_ent[e]) * a.bs + s;
    }
    if (half == 0) {
      if (hs == 0) {  // the slot's tags, once for the heads
        tags[sj] = ok ? 1 : -1;
        if (ok) {
          pipe::cp4(tags + kKeys + sj, a.pool_seg + slot);
          pipe::cp4(tags + 2 * kKeys + sj, a.pool_pos + slot);
          if (kTree)
            pipe::cp4(tags + kNode * kKeys + sj, a.block_node + nidx);
        }
      }
      if (kQuant && ok) {  // the (slot, head) scales, by row
        pipe::cp4(tags + kKsc * kKeys + j, a.ks + slot * a.Kh + h0 + hs);
        pipe::cp4(tags + kVsc * kKeys + j, a.vs + slot * a.Kh + h0 + hs);
      }
    }
    const long long off = (slot * a.Kh + h0 + hs) * D;
    const unsigned char* ksrc = reinterpret_cast<const unsigned char*>(
        ok ? kp + off : kp);
    const unsigned char* vsrc = reinterpret_cast<const unsigned char*>(
        ok ? vp + off : vp);
    const uint32_t kd = smem_u32(base + j * RB);
    const uint32_t vd = smem_u32(base + (kKeys + j) * RB);
    for (int ch = half; ch < C; ch += 2) {
      cp_async16(kd + ch * 16, ok ? ksrc + ch * 16 : ksrc, ok);
      cp_async16(vd + ch * 16, ok ? vsrc + ch * 16 : vsrc, ok);
    }
  };

  int pos = 0, n_seg = 0, before = 0;
  do {
    const int n_list =
        scan_window(a, tl.seg, z, before, l_ent, l_blk, wcnt, pos, n_seg);
    if (n_list > 0) {
      const int n_slots = n_list * a.bs;
      const int n_tiles = (n_slots + TS - 1) / TS;
      // one issue site: iteration i requests tile i + stages - 1 into the
      // buffer tile i - 1 freed, then scores tile i
      for (int i = 1 - a.stages; i < n_tiles; ++i) {
        const int ni = i + a.stages - 1;
        if (ni < n_tiles) issue(ni % a.stages, ni, n_slots);
        cp_async_commit();
        if (i < 0) continue;
        pipe::wait_pending(a.stages - 1);
        __syncthreads();
        unsigned char* base = stage0 + (i % a.stages) * SB;
        const int* tags = reinterpret_cast<const int*>(base + 2 * kKeys * RB);
        const float* ksc =
            reinterpret_cast<const float*>(tags + kKsc * kKeys);
        const float* vsc =
            reinterpret_cast<const float*>(tags + kVsc * kKeys);
        const QT* kt = reinterpret_cast<const QT*>(base);
        const QT* vt = reinterpret_cast<const QT*>(base + kKeys * RB);
        if (kQuant) {  // widen the tile to bf16 (exact), scales applied later
          const int C16 = D / 16;
#pragma unroll 1
          for (int x = threadIdx.x; x < 2 * kKeys * C16; x += kThreads) {
            const int j = x / C16;  // K rows, then V rows
            const int ch = x - j * C16;
            const uint4 raw =
                *reinterpret_cast<const uint4*>(base + j * RB + ch * 16);
            const KT* xv = reinterpret_cast<const KT*>(&raw);
            uint32_t pk[8];
#pragma unroll
            for (int u = 0; u < 8; ++u)
              pk[u] = pack_bf16(to_f32(xv[2 * u]), to_f32(xv[2 * u + 1]));
            uint4* dst = reinterpret_cast<uint4*>(conv + j * LD + ch * 16);
            dst[0] = make_uint4(pk[0], pk[1], pk[2], pk[3]);
            dst[1] = make_uint4(pk[4], pk[5], pk[6], pk[7]);
          }
          __syncthreads();
          kt = conv;
          vt = conv + kKeys * LD;
        }
        kt += hh * TS * LD;  // the warp's head's rows
        vt += hh * TS * LD;
        // the warp's share of the tile, 16 keys at a time: the code of a
        // step is short enough to stay in the instruction cache
#pragma unroll 1
        for (int k0 = kbase; rows_here && k0 < kbase + KK; k0 += 16) {
          // S = Q K^T: the warp's 16 rows x 16 keys
          float s[2][4] = {{0.f, 0.f, 0.f, 0.f}, {0.f, 0.f, 0.f, 0.f}};
#pragma unroll
          for (int kk = 0; kk < kMaxD / 16; ++kk) {
            if (kk < KD) {
              uint32_t bq[4];
              ldsm_x4(bq, smem_u32(kt + (k0 + (lane >> 4) * 8 + (lane & 7)) *
                                            LD +
                                   kk * 16 + ((lane >> 3) & 1) * 8));
              mma_16816(s[0], qf[kk], bq[0], bq[1]);
              mma_16816(s[1], qf[kk], bq[2], bq[3]);
            }
          }
          // masks: element c of block n is row g + 8 (c >> 1), key k0 + 8 n
          // + 2 q4 + (c & 1) of the tile
#pragma unroll
          for (int n = 0; n < 2; ++n) {
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              const int key = k0 + 8 * n + 2 * q4 + e;
              const bool live = tags[key] >= 0 && tags[kKeys + key] >= 0;
              const int kpos = tags[2 * kKeys + key];
              const int node = kTree ? tags[kNode * kKeys + key] : -1;
              const float sc = kQuant ? sl * ksc[hh * TS + key] : sl;
#pragma unroll
              for (int i2 = 0; i2 < 2; ++i2) {
                bool ok = rok[i2] && live &&
                          static_cast<unsigned>(qpos[i2] - kpos) < a.wlim;
                if (kTree && ok)
                  ok = node == -1 ||
                       (node >= 0 &&
                        ((static_cast<unsigned>(anc[i2]) >> min(node, 31)) &
                         1u));
                s[n][2 * i2 + e] = ok ? s[n][2 * i2 + e] * sc : kNeg;
              }
            }
          }
          // online softmax (log2 domain), rows g and g + 8
          float corr[2], m_safe[2];
#pragma unroll
          for (int i2 = 0; i2 < 2; ++i2) {
            float mx = fmaxf(fmaxf(s[0][2 * i2], s[0][2 * i2 + 1]),
                             fmaxf(s[1][2 * i2], s[1][2 * i2 + 1]));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
            mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
            const float m_new = fmaxf(m[i2], mx);
            m_safe[i2] = fmaxf(m_new, -1e29f);
            corr[i2] = m[i2] > -CUDART_INF_F ? exp2f(m[i2] - m_safe[i2]) : 0.f;
            m[i2] = m_new;
          }
          l[0] *= corr[0];
          l[1] *= corr[1];
#pragma unroll
          for (int n = 0; n < 2; ++n) {
            float v0 = 1.f, v1 = 1.f;
            if (kQuant) {  // V's scale folded into P (a slot past the list
                           // has none: its buffer is stale)
              const int key = k0 + 8 * n + 2 * q4;
              v0 = tags[key] >= 0 ? vsc[hh * TS + key] : 0.f;
              v1 = tags[key + 1] >= 0 ? vsc[hh * TS + key + 1] : 0.f;
            }
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              const float p = exp2f(s[n][c] - m_safe[c >> 1]);
              l[c >> 1] += p;
              s[n][c] = p * ((c & 1) ? v1 : v0);
            }
          }
#pragma unroll
          for (int n = 0; n < kMaxD / 8; ++n) {
            if (n < ND) {
              o[n][0] *= corr[0];
              o[n][1] *= corr[0];
              o[n][2] *= corr[1];
              o[n][3] *= corr[1];
            }
          }
          // O += P V, P in bf16 as the A fragment
          uint32_t pa[4];
          pa[0] = pack_bf16(s[0][0], s[0][1]);
          pa[1] = pack_bf16(s[0][2], s[0][3]);
          pa[2] = pack_bf16(s[1][0], s[1][1]);
          pa[3] = pack_bf16(s[1][2], s[1][3]);
#pragma unroll
          for (int nd = 0; nd < kMaxD / 16; ++nd) {
            if (nd < KD) {
              uint32_t bv[4];
              ldsm_x4_trans(bv, smem_u32(vt + (k0 + ((lane >> 3) & 1) * 8 +
                                               (lane & 7)) * LD +
                                         nd * 16 + (lane >> 4) * 8));
              mma_16816(o[2 * nd], pa, bv[0], bv[1]);
              mma_16816(o[2 * nd + 1], pa, bv[2], bv[3]);
            }
          }
        }
        __syncthreads();  // the tile's buffer (and widened copy) is free
      }
      pipe::wait_pending(0);
    }
    before += n_list;
    __syncthreads();  // the lists are free for the next window
  } while (pos < a.M);

  if (n_seg == 0) {  // nothing to attend: zeros, from chunk 0
    if (z == 0)
      for (int x = 0; x < HP; ++x)
        zero_rows(static_cast<QT*>(a.out), tl.t0, tl.R, G, a.H, h0 + x, D);
    return;
  }
  const int live = min(a.chunks, n_seg);
  if (z >= live) return;  // no entry of this segment fell to this chunk

  // the key teams' states into one per row, through shared memory: row r
  // of head h0 + x, team t at buf[(t units 16 + x MT 16 + r) (D + 4)]: m,
  // l, two pad words, acc
  const int BS = D + 4;
  float* buf = reinterpret_cast<float*>(stage0);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
  }
  if (rows_here) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float* dst = buf + (team * units * 16 + unit * 16 + g + 8 * i) * BS;
      if (q4 == 0) {
        dst[0] = m[i];
        dst[1] = l[i];
      }
#pragma unroll
      for (int n = 0; n < kMaxD / 8; ++n)
        if (n < ND)
          *reinterpret_cast<float2*>(dst + 4 + 8 * n + 2 * q4) =
              make_float2(o[n][2 * i], o[n][2 * i + 1]);
    }
  }
  __syncthreads();
  // a thread a (row, 8 dims): the teams combined, then the output (one
  // 16-byte store) or the chunk's partial (m in the natural-log domain, as
  // merge_row reads it)
  const bool direct = live == 1;
  const int DC = D / 8;
  for (int x = threadIdx.x; x < HP * tl.R * DC; x += kThreads) {
    const int hx = x / (tl.R * DC);
    const int r = (x - hx * tl.R * DC) / DC;
    const int d0 = (x - hx * tl.R * DC - r * DC) * 8;
    const int b0 = hx * MT * 16 + r;  // the row in each team's block
    float mx = -CUDART_INF_F, lt = 0.f, acc[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) acc[u] = 0.f;
    for (int t = 0; t < teams; ++t) {
      const float* src = buf + (t * units * 16 + b0) * BS;
      if (src[1] > 0.f) mx = fmaxf(mx, src[0]);
    }
    for (int t = 0; t < teams && mx > -CUDART_INF_F; ++t) {
      const float* src = buf + (t * units * 16 + b0) * BS;
      if (src[1] > 0.f) {
        const float wt = exp2f(src[0] - mx);
        lt = fmaf(src[1], wt, lt);
        const float4 lo = *reinterpret_cast<const float4*>(src + 4 + d0);
        const float4 hi = *reinterpret_cast<const float4*>(src + 8 + d0);
        acc[0] = fmaf(wt, lo.x, acc[0]);
        acc[1] = fmaf(wt, lo.y, acc[1]);
        acc[2] = fmaf(wt, lo.z, acc[2]);
        acc[3] = fmaf(wt, lo.w, acc[3]);
        acc[4] = fmaf(wt, hi.x, acc[4]);
        acc[5] = fmaf(wt, hi.y, acc[5]);
        acc[6] = fmaf(wt, hi.z, acc[6]);
        acc[7] = fmaf(wt, hi.w, acc[7]);
      }
    }
    const long long row = static_cast<long long>(tl.t0 + r / G) * a.H +
                          (h0 + hx) * G + r % G;
    if (direct) {
      const float inv = lt > 0.f ? 1.f / lt : 0.f;
      *reinterpret_cast<uint4*>(static_cast<QT*>(a.out) + row * D + d0) =
          make_uint4(pack_bf16(acc[0] * inv, acc[1] * inv),
                     pack_bf16(acc[2] * inv, acc[3] * inv),
                     pack_bf16(acc[4] * inv, acc[5] * inv),
                     pack_bf16(acc[6] * inv, acc[7] * inv));
    } else {
      const long long o_ = static_cast<long long>(z) * a.Tq * a.H + row;
      if (d0 == 0) {
        a.pm[o_] = mx * kLn2;
        a.pl[o_] = lt;
      }
      if (lt > 0.f) {
        float4* dst = reinterpret_cast<float4*>(a.pacc + o_ * D + d0);
        dst[0] = make_float4(acc[0], acc[1], acc[2], acc[3]);
        dst[1] = make_float4(acc[4], acc[5], acc[6], acc[7]);
      }
    }
  }
  if (!direct) merge_chunks<QT>(a, tl, HP, live, is_last);
}

// The CTA of tokens [x span, (x + 1) span) (x = blockIdx.x), kv heads
// [y heads, (y + 1) heads), chunk z: every tile that starts among its
// tokens, one after the other.
template <typename KT, bool kTree>
__global__ void __launch_bounds__(kThreads, 3)
    paged_verify_mma_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wcnt[kWarps];
  __shared__ int is_last;
  const int TQ = kMmaRows / (a.heads * (a.H / a.Kh));
  const SegWindow w = load_window(a, blockIdx.x * a.span);
  for (int j = 0; j < a.span && w.base + j < a.Tq; ++j) {
    Tile tl;
    if (find_tile<__nv_bfloat16>(a, w, j, TQ, a.heads, tl))
      mma_tile<KT, kTree>(a, tl, smem, wcnt, &is_last);
  }
}

// -------------------------------------------------------- CUDA cores --

// One tile of the CUDA-core kernel (paged_verify_scalar_kernel, below).
template <typename QT, typename KT, bool kTree, int RW>
__device__ __forceinline__ void scalar_tile(const Args& a, const Tile& tl,
                                            unsigned char* smem, int* wcnt,
                                            int* is_last) {
  const int G = a.H / a.Kh;
  __syncthreads();  // the CTA's previous tile is done with shared memory
  const int h = blockIdx.y;
  const int z = blockIdx.z;
  const int D = a.D;
  const int rows = (kMaxRows / G) * G;  // the plan's rows a CTA at most
  const int warp = threadIdx.x >> 5;
  const int k0 = warp % a.wpt;
  int* l_ent = reinterpret_cast<int*>(smem);
  int* l_blk =
      reinterpret_cast<int*>(smem + pipe::align16(sizeof(int) * a.cap));
  float* sq = reinterpret_cast<float*>(smem + list_bytes(a.cap));
  unsigned char* stage_base = reinterpret_cast<unsigned char*>(sq) +
                              pipe::align16(sizeof(float) * rows * D);
  const QT* q = static_cast<const QT*>(a.q);

  pipe::Rows<RW> w;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = k0 + a.wpt * rr;
    const int t = tl.t0 + (r < tl.R ? r / G : 0);
    w.m[rr] = -CUDART_INF_F;
    w.l[rr] = 0.f;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) w.acc[rr][i] = 0.f;
    w.seg[rr] = tl.seg;
    w.pos[rr] = a.q_pos[t];
    w.anc[rr] = kTree ? a.q_anc[t] : -1;
  }
  w.wlim = a.wlim;
  pipe::Pool<KT> p;
  p.k = static_cast<const KT*>(a.kp);
  p.v = static_cast<const KT*>(a.vp);
  p.seg = a.pool_seg;
  p.pos = a.pool_pos;
  p.node = a.block_node;
  p.ks = a.ks;
  p.vs = a.vs;
  p.Kh = a.Kh;
  p.h = h;
  p.D = D;
  p.KS = pipe::k_stride(D, sizeof(KT));
  p.VS = pipe::v_stride(D, sizeof(KT));
  p.vec = (D * sizeof(KT)) % 16 == 0 &&
          ((reinterpret_cast<uintptr_t>(a.kp) |
            reinterpret_cast<uintptr_t>(a.vp)) & 15) == 0;
  const SegMap map{l_ent, l_blk, tl.seg, a.bs};

  int pos = 0, n_seg = 0, before = 0;
  bool first = true;
  do {
    const int n_list =
        scan_window(a, tl.seg, z, before, l_ent, l_blk, wcnt, pos, n_seg);
    if (n_list > 0) {
      const int n_slots = n_list * a.bs;
      pipe::QRows<QT> qf;
      if (first) qf.fetch(q, tl.t0, tl.R, G, a.H, h, D);
      const pipe::Walk walk = pipe::walk_start<KT, kTree>(
          stage_base, a.stages, p, map, (n_slots + kTile - 1) / kTile,
          n_slots, a.wpt);
      if (first) {
        qf.store(sq, q, tl.t0, tl.R, G, a.H, h, D, a.scale);
        __syncthreads();  // the queries
        first = false;
      }
      pipe::walk_rest<KT, kTree, true>(walk, p, map, n_slots, sq, tl.R,
                                       a.wpt, w);
    }
    before += n_list;
    __syncthreads();  // the lists (and every team's stages) are free
  } while (pos < a.M);

  if (n_seg == 0) {
    if (z == 0)
      zero_rows(static_cast<QT*>(a.out), tl.t0, tl.R, G, a.H, h, D);
    return;
  }
  const int live = min(a.chunks, n_seg);
  if (z >= live) return;
  pipe::merge_teams(reinterpret_cast<float*>(stage_base), a.wpt, tl.R, D,
                    w);
  const bool direct = live == 1;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp + kWarps * rr;
    if (r < tl.R) emit_row<QT>(a, tl, r, direct, w.m[rr], w.l[rr], w.acc[rr]);
  }
  if (!direct) merge_chunks<QT>(a, tl, 1, live, is_last);
}

// As paged_verify_mma_kernel, one kv head a CTA.
template <typename QT, typename KT, bool kTree, int RW>
__global__ void __launch_bounds__(kThreads)
    paged_verify_scalar_kernel(const Args a) {
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int wcnt[kWarps];
  __shared__ int is_last;
  const int TQ = kMaxRows / (a.H / a.Kh);
  const SegWindow w = load_window(a, blockIdx.x * a.span);
  for (int j = 0; j < a.span && w.base + j < a.Tq; ++j) {
    Tile tl;
    if (find_tile<QT>(a, w, j, TQ, 1, tl))
      scalar_tile<QT, KT, kTree, RW>(a, tl, smem, wcnt, &is_last);
  }
}

template <typename QT, typename KT>
static int launch(const Args& a, bool mma, cudaStream_t stream) {
  const dim3 grid((a.Tq + a.span - 1) / a.span, a.Kh / a.heads, a.chunks);
  const bool tree = a.block_node != nullptr;
  if constexpr (std::is_same<QT, __nv_bfloat16>::value &&
                !std::is_same<KT, float>::value) {
    if (mma) {
      const size_t smem = mma_smem(a.cap, a.D, sizeof(KT), a.stages, tree);
      auto kernel = tree ? paged_verify_mma_kernel<KT, true>
                         : paged_verify_mma_kernel<KT, false>;
      cudaError_t err = cudaFuncSetAttribute(
          kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          static_cast<int>(smem));
      if (err != cudaSuccess) return static_cast<int>(err);
      kernel<<<grid, kThreads, smem, stream>>>(a);
      return 0;
    }
  }
  if (mma) return static_cast<int>(cudaErrorInvalidValue);
  const int rows = (kMaxRows / (a.H / a.Kh)) * (a.H / a.Kh);
  const size_t smem =
      scalar_smem(a.cap, rows, a.D, sizeof(KT), a.wpt, a.stages);
  // one row per warp runs the short code (pipe::Rows)
  const bool one = (rows + a.wpt - 1) / a.wpt <= 1;
  auto kernel = tree ? (one ? paged_verify_scalar_kernel<QT, KT, true, 1>
                            : paged_verify_scalar_kernel<QT, KT, true,
                                                         kRowsPerWarp>)
                     : (one ? paged_verify_scalar_kernel<QT, KT, false, 1>
                            : paged_verify_scalar_kernel<QT, KT, false,
                                                         kRowsPerWarp>);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, stream>>>(a);
  return 0;
}

}  // namespace vseg

// Checks and dtype dispatch of one call; the arguments of both entries.
// q (Tq, H, D) f32/bf16; pools (N, bs, Kh, D) f32/bf16/int8/fp8;
// pool_seg/pool_pos (N, bs); q_seg/q_pos (Tq,); q_anc (Tq,) or null;
// block_ids/block_owner (M,); block_node (M, bs) or null; ks/vs (N, bs, Kh)
// f32 or null; out like q; window > 0 masks slots at or before q_pos -
// window as well (0: none).  The plan (kernels/paged_attention.py
// verify_plan): `tokens` query tokens a tile at most, `span` tokens a CTA
// looks at for tiles (the grid's x is ceil(Tq / span)), `heads` kv heads a
// CTA (the grid's y is Kh / heads; tokens x G x heads rows: kMmaRows on
// the tensor cores, kMaxRows with one head on the CUDA cores), `chunks` per
// segment, `cap` list entries a CTA holds (at least a scan round's share,
// min(M, 1024) / chunks), `mma` the tensor-core path (bf16 queries,
// bf16/int8/fp8 pools, D % 16 == 0; `stages` K/V buffers, wpt unused), else
// the CUDA cores' teams of `wpt` warps with `stages` buffers each.  With
// chunks > 1: pm/pl (chunks, Tq, H) and pacc (chunks, Tq, H, D) float32
// scratch and counters (Tq * Kh / heads) int32, zero before the call and
// zero after it; with one chunk they may be null.  One launch.  Returns
// cudaGetLastError() after it.
inline int verify_runs(const void* q, const void* k_pool, const void* v_pool,
                       const int* pool_seg, const int* pool_pos,
                       const int* q_seg, const int* q_pos, const int* q_anc,
                       const int* block_ids, const int* block_owner,
                       const int* block_node, const float* k_scale,
                       const float* v_scale, float* pm, float* pl,
                       float* pacc, int* counters, void* out, int Tq, int H,
                       int Kh, int D, int bs, int M, int tokens, int span,
                       int chunks, int cap, int mma, int heads, int wpt,
                       int stages, int q_dtype, int kv_dtype, int window,
                       float scale, void* stream) {
  const int G = Kh > 0 ? H / Kh : 0;
  const int R = tokens * G * heads;
  const bool tc = mma != 0;
  bool ok = Tq > 0 && Kh > 0 && H % Kh == 0 && D > 0 && D <= kMaxD &&
            bs > 0 && M >= 0 && tokens > 0 && span > 0 && span <= 32 &&
            chunks > 0 && chunks <= 65535 &&
            Kh <= 65535 && cap > 0 &&
            (heads == 1 || heads == 2 || heads == 4) && Kh % heads == 0 &&
            static_cast<long long>(cap) * chunks >=
                (M < vseg::kBatch ? M : vseg::kBatch) &&
            (chunks == 1 || (pm != nullptr && pl != nullptr &&
                             pacc != nullptr && counters != nullptr)) &&
            (q_anc == nullptr) == (block_node == nullptr) && window >= 0;
  if (tc) {
    ok = ok && q_dtype == kBF16 && kv_dtype != kF32 && D % 16 == 0 &&
         R <= vseg::kMmaRows && tokens == vseg::kMmaRows / (G * heads) &&
         stages >= 1 && stages <= vseg::kMaxStages;
  } else {
    ok = ok && heads == 1 && R <= kMaxRows && tokens == kMaxRows / G &&
         (wpt == 1 || wpt == 2 || wpt == kWarps) && R <= kRowsPerWarp * wpt &&
         stages >= 1 && stages <= pipe::kMaxStages;
  }
  if (!ok) return static_cast<int>(cudaErrorInvalidValue);
  const vseg::Args a{q,        k_pool,   v_pool,  pool_seg, pool_pos, q_seg,
                     q_pos,    q_anc,    block_ids, block_owner, block_node,
                     k_scale,  v_scale,  pm,      pl,       pacc,     counters,
                     out,      Tq,       H,       Kh,       D,        bs,
                     M,        tokens,   span,    chunks,   cap,      heads,
                     wpt,      stages,   scale,   window_limit(window)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int rc = 0;
#define SPIN_VERIFY(QT, KT) rc = vseg::launch<QT, KT>(a, tc, st)
#define SPIN_VERIFY_KV(QT)                                        \
  switch (kv_dtype) {                                             \
    case kF32: SPIN_VERIFY(QT, float); break;                     \
    case kBF16: SPIN_VERIFY(QT, __nv_bfloat16); break;            \
    case kI8: SPIN_VERIFY(QT, int8_t); break;                     \
    case kFP8: SPIN_VERIFY(QT, __nv_fp8_e4m3); break;             \
    default: return static_cast<int>(cudaErrorInvalidValue);      \
  }
  if (q_dtype == kF32) {
    SPIN_VERIFY_KV(float)
  } else if (q_dtype == kBF16) {
    SPIN_VERIFY_KV(__nv_bfloat16)
  } else {
    return static_cast<int>(cudaErrorInvalidValue);
  }
#undef SPIN_VERIFY_KV
#undef SPIN_VERIFY
  if (rc != 0) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace spin
