// The tile pipeline of the redesigned attention kernels (fused_decode.cu's
// split layout, verify_runs.cuh's CUDA-core path, decode_runs.cuh's
// runs of a decode row's tiles): K/V tiles of 32 slots streamed into
// shared memory by cp.async, several in flight, and scored by teams of
// warps that each own a share of the tiles.
//
// Teams.  The CTA's four warps form kWarps / wpt teams of wpt warps (wpt
// = 1, 2 or 4).  Team g takes the tiles g, g + teams, g + 2 teams, ... of
// the CTA's slot list; inside a team, warp k scores the rows k, k + wpt,
// k + 2 wpt, ... (at most four), so a CTA with fewer rows than warps still
// keeps every warp scoring (wpt = 1: each warp scores the CTA's one row
// against its own tiles).  Each team keeps its own online softmax (m, l,
// acc) per row; merge_teams folds them into one per row at the end,
// through shared memory.
//
// Code size.  A call lasts a few microseconds and most SMs run one or two
// of its CTAs, so nearly every instruction a CTA runs is fetched cold: on
// the H100 the time of a tile's scoring followed the length of the code
// it ran more than its arithmetic.  So the row state is compiled per RW,
// the rows a warp holds (1, or kRowsPerWarp), and the plan gives a warp
// one row wherever the rows allow it; the loops over a tile's slots stay
// rolled.
//
// Stages.  Team g owns `stages` tile buffers.  It requests its first
// `stages` tiles at once (one cp.async group each; walk_start, after which
// the kernel stores the queries it fetched at its start), then for each
// tile (walk_rest):
// waits for the oldest group, scores the tile, and requests the tile
// `stages` ahead into the buffer it just freed.  A stage holds the tile's
// K and V in the pool's own type (dequantized at use: int8/fp8 K by the
// per-(slot, head) scale after the dot product, V by folding its scale
// into the probability), and each slot's pool tags (segment, position,
// tree node, scales) copied by cp.async too, beside an "owner" word the
// issuing lane knows at once (the block's owner for verify, 0 for decode;
// -1 for a slot outside the list or of an unallocated block, never read).
//
// Scoring.  Lane j holds slot j: it reads its K row as 16-byte chunks
// (rows padded to an odd number of chunks, so eight lanes' chunks fall on
// distinct banks) and forms the dot products of all its warp's rows from
// one read of each chunk, the queries (float32, pre-scaled) broadcast from
// shared memory.  The probabilities then weight V eight slots at a time,
// each V value read once for all rows; eight slots no row attends are
// skipped.  A CTA has few warps, so the inner loops are written for
// independent loads and short dependency chains: a warp's latency is
// hidden by its own instruction-level parallelism, not by other warps.
// Masks and the -1e30 / -1e29 conventions are those of attend_tile
// (paged_common.cuh); a tile that no row attends is skipped whole.
#pragma once

#include "paged_common.cuh"

namespace spin {
namespace pipe {

constexpr int kMaxStages = 4;
constexpr int kTagWords = 6 * kTile;  // seg, pos, node, owner, k/v scale

// Bytes of one K row in a stage: the stored row in whole 16-byte chunks,
// an odd number of them (conflict-free 16-byte reads by eight lanes).
__host__ __device__ inline int k_stride(int D, int es) {
  int c = (D * es + 15) / 16;
  if ((c & 1) == 0) ++c;
  return 16 * c;
}

__host__ __device__ inline int v_stride(int D, int es) {
  return 16 * ((D * es + 15) / 16);
}

__host__ __device__ inline int stage_bytes(int D, int es) {
  return kTile * (k_stride(D, es) + v_stride(D, es)) + 4 * kTagWords;
}

__host__ __device__ inline size_t align16(size_t n) {
  return (n + 15) & ~size_t(15);
}

// Dynamic shared memory of the stages (or of merge_teams' buffer, which
// reuses them).
inline size_t stages_smem(int teams, int stages, int rows, int D, int es) {
  const size_t st = size_t(teams) * stages * stage_bytes(D, es);
  const size_t merge = sizeof(float) * size_t(teams) * rows * (D + 2);
  return st > merge ? st : merge;
}

struct Stage {
  unsigned char* k;  // [kTile][k_stride] stored K rows
  unsigned char* v;  // [kTile][v_stride] stored V rows
  int* seg;          // pool seg of the slot (-1 = not attendable)
  int* pos;          // pool position
  int* node;         // tree-node tag (verify with a tree)
  int* own;          // owner (verify) / 0 (decode); -1 = no slot
  float* ksc;        // per-(slot, head) scales (int8/fp8 pools)
  float* vsc;
};

__device__ __forceinline__ Stage stage_at(unsigned char* base, int KS,
                                          int VS) {
  Stage s;
  s.k = base;
  s.v = base + kTile * KS;
  int* t = reinterpret_cast<int*>(s.v + kTile * VS);
  s.seg = t;
  s.pos = t + kTile;
  s.node = t + 2 * kTile;
  s.own = t + 3 * kTile;
  s.ksc = reinterpret_cast<float*>(t + 4 * kTile);
  s.vsc = s.ksc + kTile;
  return s;
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most n of this thread's cp.async groups are in flight.
__device__ __forceinline__ void wait_pending(int n) {
  if (n <= 0)
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
  else if (n == 1)
    asm volatile("cp.async.wait_group 1;\n" ::: "memory");
  else if (n == 2)
    asm volatile("cp.async.wait_group 2;\n" ::: "memory");
  else
    asm volatile("cp.async.wait_group 3;\n" ::: "memory");
}

// Barrier of team g's wpt warps (named barrier 1 + g for teams of two).
__device__ __forceinline__ void team_sync(int wpt, int g) {
  if (wpt == 1)
    __syncwarp();
  else if (wpt == kWarps)
    __syncthreads();
  else if (g == 0)  // immediate ids: the compiler reserves only these
    asm volatile("bar.sync 1, 64;\n" ::: "memory");
  else
    asm volatile("bar.sync 2, 64;\n" ::: "memory");
}

// The queries of a tile in two steps, so that their load overlaps the
// tiles'.  load_q_rows (paged_common.cuh) does both at once and stays as
// it is: built on this form it changed verify_attention.cu's register
// allocation and cost that kernel 6% on the H100.  fetch() requests row
// r = token t0 + r / G, head h G + r % G of a (tokens, H, D) array as
// 16-byte chunks into registers, one round for every thread (at most
// kMaxRows rows of kMaxD dims: 256 bf16 or 512 float32 chunks), when a
// row fills whole chunks and q is 16-byte aligned; store() converts them
// (else reads element by element), scales and writes shared memory.
template <typename QT>
struct QRows {
  static constexpr int E = 16 / sizeof(QT);
  static constexpr int U = sizeof(QT);  // chunks per thread
  uint4 c[U];
  bool vec;

  __device__ __forceinline__ void fetch(const QT* q, int t0, int rows, int G,
                                        int H, int h, int D) {
    vec = D % E == 0 && (reinterpret_cast<uintptr_t>(q) & 15) == 0;
    if (!vec) return;
    const int C = D / E;
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int e = threadIdx.x + u * kThreads;
      if (e < rows * C) {
        const int r = e / C;
        const long long row =
            static_cast<long long>(t0 + r / G) * H + h * G + r % G;
        c[u] = *reinterpret_cast<const uint4*>(q + row * D + (e - r * C) * E);
      }
    }
  }

  __device__ __forceinline__ void store(float* sq, const QT* q, int t0,
                                        int rows, int G, int H, int h, int D,
                                        float scale) const {
    if (vec) {
      const int C = D / E;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        const int e = threadIdx.x + u * kThreads;
        if (e < rows * C) {
          const int r = e / C;
          const QT* x = reinterpret_cast<const QT*>(&c[u]);
          float* dst = sq + r * D + (e - r * C) * E;
#pragma unroll
          for (int i = 0; i < E; ++i) dst[i] = to_f32(x[i]) * scale;
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
};

// A Map turns slot c of a CTA's slot list into its pool slot, its owner
// word and its tree-node index, and says whether the slot has data.
// kTags: the slots carry pool tags (segment, position; the paged kernels)
// that issue_tile copies and score_tile tests; without them (the dense
// and the paged decode) every slot of the list is attended.

// Slot c of a decode row: logical block c / bs of the row's table (in
// shared memory); a slot of an unallocated block (< 0) has no data.
struct TableMap {
  static constexpr bool kTags = true;
  const int* table;
  int bs;
  __device__ __forceinline__ bool operator()(int c, long long& slot,
                                             int& own,
                                             long long& node) const {
    const int e = c / bs;
    const int id = table[e];
    own = 0;
    node = 0;
    slot = static_cast<long long>(id) * bs + (c - e * bs);
    return id >= 0;
  }
};

// Slot c of a dense decode row: slot s0 + c of row b of a (B, S, Kh, D)
// cache (the list is the row's live slots from s0), no tags.
struct DenseMap {
  static constexpr bool kTags = false;
  long long s0;  // b * S + the run's first slot
  __device__ __forceinline__ bool operator()(int c, long long& slot,
                                             int& own,
                                             long long& node) const {
    own = 0;
    node = 0;
    slot = s0 + c;
    return true;
  }
};

// Slot c of a run of a paged decode row (paged_decode_attention): logical
// slot first + c of the run's slice of the row's table, which the kernel
// has copied into shared memory from the run's first logical block (each
// entry already max(id, 0): an unallocated block of the live prefix reads
// block 0, as the reference does), for any block size; no tags, every
// slot of the list is attended.
struct PagedRowMap {
  static constexpr bool kTags = false;
  const int* table;  // the run's slice, in shared memory
  int first;         // the run's first slot's offset in its block
  int bs;
  __device__ __forceinline__ bool operator()(int c, long long& slot,
                                             int& own,
                                             long long& node) const {
    const int s = first + c;
    const int e = s / bs;
    own = 0;
    node = 0;
    slot = static_cast<long long>(table[e]) * bs + (s - e * bs);
    return true;
  }
};

// Pool tensors of one call, for one kv head.
template <typename KT>
struct Pool {
  const KT* k;
  const KT* v;
  const int* seg;
  const int* pos;
  const int* node;   // block_node (M, bs) of verify with a tree, or null
  const float* ks;   // (N, bs, Kh) scales of int8/fp8 pools, or null
  const float* vs;
  int Kh, h, D, KS, VS;
  bool vec;          // whole 16-byte chunks per row, aligned pools
};

// Team threads tg in [0, 32 wpt) request tile `tile` of the slot list
// (n_slots slots) into stage st: thread tg copies chunks tg / 32,
// tg / 32 + wpt, ... of slot tg % 32's K and V rows; the team's first
// warp also writes each slot's owner word and copies its tags
// (Map::kTags) and, for int8/fp8 pools, its scales (with or without
// tags).
template <typename KT, bool kTree, class Map>
__device__ __forceinline__ void issue_tile(const Stage& st, const Pool<KT>& p,
                                           const Map& map, int tile,
                                           int n_slots, int tg, int wpt) {
  constexpr bool kQuant = sizeof(KT) == 1;
  const int j = tg & 31;
  const int c = tile * kTile + j;
  long long slot = 0, nidx = 0;
  int own = -1;
  const bool ok = c < n_slots && map(c, slot, own, nidx);
  if (tg < kTile) {
    st.own[j] = ok ? own : -1;
    if (ok) {
      if (Map::kTags) {
        cp4(st.seg + j, p.seg + slot);
        cp4(st.pos + j, p.pos + slot);
        if (kTree) cp4(st.node + j, p.node + nidx);
      }
      if (kQuant) {
        cp4(st.ksc + j, p.ks + slot * p.Kh + p.h);
        cp4(st.vsc + j, p.vs + slot * p.Kh + p.h);
      }
    }
  }
  if (!ok) return;
  const long long off = (slot * p.Kh + p.h) * p.D;
  if (p.vec) {
    const int C = p.D * static_cast<int>(sizeof(KT)) / 16;
    const unsigned char* ksrc =
        reinterpret_cast<const unsigned char*>(p.k + off);
    const unsigned char* vsrc =
        reinterpret_cast<const unsigned char*>(p.v + off);
    for (int ch = tg >> 5; ch < C; ch += wpt) {
      cp16(st.k + j * p.KS + ch * 16, ksrc + ch * 16);
      cp16(st.v + j * p.VS + ch * 16, vsrc + ch * 16);
    }
  } else {  // rows not in whole aligned chunks: plain copies
    KT* kd = reinterpret_cast<KT*>(st.k + j * p.KS);
    KT* vd = reinterpret_cast<KT*>(st.v + j * p.VS);
    for (int d = tg >> 5; d < p.D; d += wpt) {
      kd[d] = p.k[off + d];
      vd[d] = p.v[off + d];
    }
  }
}

// Per-row state of a warp: rows k0 + wpt * rr, rr < RW (RW = 1 or
// kRowsPerWarp; compiled per RW, so a CTA of one row per warp runs the
// short code).  wlim: a tagged slot is attendable iff unsigned(row pos -
// slot pos) < wlim, kNoWindow for the causal term alone (pos <= row pos),
// the window w (pos > row pos - w as well) else (window_limit).
template <int RW>
struct Rows {
  float m[RW], l[RW], acc[RW][kDimPerLane];
  int seg[RW], pos[RW], anc[RW];
  unsigned wlim = kNoWindow;
};

// Online-softmax update of this warp's rows with the tile in stage st.
// kOwnerSeg: a slot's segment is its owner when its pool seg is >= 0
// (verify); else the pool seg itself (paged decode).  kTags false: every
// slot with an owner word >= 0 is attended (dense decode).
template <typename KT, bool kTree, bool kOwnerSeg, bool kTags, int RW>
__device__ __forceinline__ void score_tile(const Stage& st, const float* sq,
                                           const Pool<KT>& p, int R, int k0,
                                           int wpt, Rows<RW>& w) {
  constexpr bool kQuant = sizeof(KT) == 1;
  const int lane = threadIdx.x & 31;
  const int D = p.D;
  const int own = st.own[lane];
  int kseg = -1, kpos = 0, knode = -1;
  if (!kTags) {
    kseg = own;  // 0, or -1 past the list
  } else if (own >= 0) {
    const int raw = st.seg[lane];
    kseg = raw < 0 ? -1 : (kOwnerSeg ? own : raw);
    kpos = st.pos[lane];
    if (kTree) knode = st.node[lane];
  }
  bool ok[RW];
  bool any = false;
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = k0 + wpt * rr;
    bool o = r < R && kseg >= 0 &&
             (!kTags || (kseg == w.seg[rr] &&
                         static_cast<unsigned>(w.pos[rr] - kpos) < w.wlim));
    if (kTree && o)
      o = knode == -1 ||
          (knode >= 0 &&
           ((static_cast<unsigned>(w.anc[rr]) >> min(knode, 31)) & 1u));
    ok[rr] = o;
    any |= o;
  }
  const unsigned live = __ballot_sync(0xffffffffu, any);
  if (live == 0) return;  // warp-uniform: no row attends this tile

  float d0[RW], d1[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) d0[rr] = d1[rr] = 0.f;
  if (any) {
    if (p.vec) {
      constexpr int E = 16 / sizeof(KT);
      const unsigned char* kr = st.k + lane * p.KS;
      const int C = D / E;
#pragma unroll 2
      for (int ch = 0; ch < C; ++ch) {
        const uint4 raw = *reinterpret_cast<const uint4*>(kr + ch * 16);
        const KT* x = reinterpret_cast<const KT*>(&raw);
        float kv[E];
#pragma unroll
        for (int i = 0; i < E; ++i) kv[i] = to_f32(x[i]);
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const int r = k0 + wpt * rr;
          if (r < R) {
            const float4* qr =
                reinterpret_cast<const float4*>(sq + r * D + ch * E);
#pragma unroll
            for (int i4 = 0; i4 < E / 4; ++i4) {
              const float4 qq = qr[i4];
              d0[rr] = fmaf(qq.x, kv[4 * i4], d0[rr]);
              d1[rr] = fmaf(qq.y, kv[4 * i4 + 1], d1[rr]);
              d0[rr] = fmaf(qq.z, kv[4 * i4 + 2], d0[rr]);
              d1[rr] = fmaf(qq.w, kv[4 * i4 + 3], d1[rr]);
            }
          }
        }
      }
    } else {
      const KT* kr = reinterpret_cast<const KT*>(st.k + lane * p.KS);
      for (int d = 0; d < D; ++d) {
        const float kv = to_f32(kr[d]);
#pragma unroll
        for (int rr = 0; rr < RW; ++rr) {
          const int r = k0 + wpt * rr;
          if (r < R) d0[rr] = fmaf(sq[r * D + d], kv, d0[rr]);
        }
      }
    }
  }
  const float kscale = (kQuant && any) ? st.ksc[lane] : 1.f;
  const float vscale = (kQuant && any) ? st.vsc[lane] : 1.f;

  float pr[RW];
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = k0 + wpt * rr;
    pr[rr] = 0.f;
    if (r < R) {  // warp-uniform
      const float s = ok[rr] ? (d0[rr] + d1[rr]) * kscale : kNeg;
      const float m_new = fmaxf(w.m[rr], warp_max(s));
      const float m_safe = fmaxf(m_new, -1e29f);
      const float e = ok[rr] ? expf(s - m_safe) : 0.f;
      const float corr =
          (w.m[rr] > -CUDART_INF_F) ? expf(w.m[rr] - m_safe) : 0.f;
      w.l[rr] = w.l[rr] * corr + warp_sum(e);
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) w.acc[rr][i] *= corr;
      w.m[rr] = m_new;
      pr[rr] = e * vscale;
    }
  }
  // V: the tile's slots eight at a time, their probabilities by shuffle
  // and their V values requested together (no chain of dependent shared
  // memory round trips from one slot to the next); a slot no row attends
  // contributes nothing and its row (stale, or never written) is not read
#pragma unroll 1
  for (int j0 = 0; j0 < kTile; j0 += 8) {
    const unsigned eight = (live >> j0) & 0xffu;
    if (eight == 0) continue;  // warp-uniform
    float vv[8][kDimPerLane];
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const KT* vr = reinterpret_cast<const KT*>(st.v + (j0 + u) * p.VS);
#pragma unroll
      for (int i = 0; i < kDimPerLane; ++i) {
        const int d = lane + 32 * i;
        vv[u][i] = ((eight >> u) & 1u) && d < D ? to_f32(vr[d]) : 0.f;
      }
    }
#pragma unroll
    for (int rr = 0; rr < RW; ++rr) {
      const int r = k0 + wpt * rr;
      if (r < R) {
#pragma unroll
        for (int u = 0; u < 8; ++u) {
          const float pj = __shfl_sync(0xffffffffu, pr[rr], j0 + u);
#pragma unroll
          for (int i = 0; i < kDimPerLane; ++i)
            w.acc[rr][i] = fmaf(pj, vv[u][i], w.acc[rr][i]);
        }
      }
    }
  }
}

// Team g's walk over its tiles (g, g + teams, ...) of n_tiles, with
// `stages` buffers from `base` (stage_bytes apart), in two calls:
// walk_start requests the first `stages` tiles (one cp.async group each;
// the caller may load more, e.g. the queries, while they fly), walk_rest
// scores every tile, requesting the tile `stages` ahead into each buffer
// it frees.
struct Walk {
  unsigned char* mine;  // this team's stages
  int sb, stages, teams, g, k0, tg, n;  // n: this team's tiles
};

template <typename KT, bool kTree, class Map>
__device__ __forceinline__ Walk walk_start(unsigned char* base, int stages,
                                           const Pool<KT>& p, const Map& map,
                                           int n_tiles, int n_slots,
                                           int wpt) {
  Walk k;
  const int warp = threadIdx.x >> 5;
  k.teams = kWarps / wpt;
  k.g = warp / wpt;
  k.k0 = warp - k.g * wpt;
  k.tg = k.k0 * 32 + (threadIdx.x & 31);
  k.sb = stage_bytes(p.D, static_cast<int>(sizeof(KT)));
  k.stages = stages;
  k.mine = base + static_cast<size_t>(k.g) * stages * k.sb;
  k.n = n_tiles > k.g ? (n_tiles - k.g + k.teams - 1) / k.teams : 0;
  for (int s = 0; s < stages; ++s) {
    if (s < k.n)
      issue_tile<KT, kTree>(stage_at(k.mine + s * k.sb, p.KS, p.VS), p, map,
                            k.g + s * k.teams, n_slots, k.tg, wpt);
    commit();
  }
  return k;
}

template <typename KT, bool kTree, bool kOwnerSeg, int RW, class Map>
__device__ __forceinline__ void walk_rest(const Walk& k, const Pool<KT>& p,
                                          const Map& map, int n_slots,
                                          const float* sq, int R, int wpt,
                                          Rows<RW>& w) {
  for (int i = 0; i < k.n; ++i) {
    wait_pending(k.stages - 1);
    team_sync(wpt, k.g);
    const Stage st = stage_at(k.mine + (i % k.stages) * k.sb, p.KS, p.VS);
    score_tile<KT, kTree, kOwnerSeg, Map::kTags, RW>(st, sq, p, R, k.k0,
                                                     wpt, w);
    team_sync(wpt, k.g);
    if (i + k.stages < k.n)
      issue_tile<KT, kTree>(st, p, map, k.g + (i + k.stages) * k.teams,
                            n_slots, k.tg, wpt);
    commit();
  }
  wait_pending(0);
}

// Fold the teams' states into one per row: afterwards warp w holds rows
// w + kWarps * rr, rr < RW (m, l, acc; l = 0: nothing attended; R <= 4 RW
// whatever the teams).  buf aliases the stages; every thread of the CTA
// calls this.
template <int RW>
__device__ __forceinline__ void merge_teams(float* buf, int wpt, int R, int D,
                                           Rows<RW>& w) {
  const int teams = kWarps / wpt;
  if (teams == 1) return;  // rows k0 + 4 rr already are warp + 4 rr
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int g = warp / wpt;
  const int k0 = warp - g * wpt;
  __syncthreads();  // every team is done with its stages
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = k0 + wpt * rr;
    if (r < R) {
      float* dst = buf + static_cast<size_t>(g * R + r) * (D + 2);
      if (lane == 0) {
        dst[0] = w.m[rr];
        dst[1] = w.l[rr];
      }
      if (w.l[rr] > 0.f) {
#pragma unroll
        for (int i = 0; i < kDimPerLane; ++i) {
          const int d = lane + 32 * i;
          if (d < D) dst[2 + d] = w.acc[rr][i];
        }
      }
    }
  }
  __syncthreads();
#pragma unroll
  for (int rr = 0; rr < RW; ++rr) {
    const int r = warp + kWarps * rr;
    float mt = -CUDART_INF_F, lt = 0.f, at[kDimPerLane];
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) at[i] = 0.f;
    if (r < R) {
      for (int t = 0; t < teams; ++t) {
        const float* src = buf + static_cast<size_t>(t * R + r) * (D + 2);
        if (src[1] > 0.f) mt = fmaxf(mt, src[0]);
      }
      if (mt > -CUDART_INF_F) {
        for (int t = 0; t < teams; ++t) {
          const float* src = buf + static_cast<size_t>(t * R + r) * (D + 2);
          const float lg = src[1];
          if (lg > 0.f) {
            const float wt = expf(src[0] - mt);
            lt = fmaf(lg, wt, lt);
#pragma unroll
            for (int i = 0; i < kDimPerLane; ++i) {
              const int d = lane + 32 * i;
              if (d < D) at[i] = fmaf(wt, src[2 + d], at[i]);
            }
          }
        }
      }
    }
    w.m[rr] = mt;
    w.l[rr] = lt;
#pragma unroll
    for (int i = 0; i < kDimPerLane; ++i) w.acc[rr][i] = at[i];
  }
}

}  // namespace pipe
}  // namespace spin
