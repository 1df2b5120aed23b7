"""Per-model paged KV-cache pool.

``PagedCachePool`` keeps KV in a physical *block pool* ``(L, num_blocks,
block_size, Kh, D)`` with a free-block list; each request owns an ordered
block table.  The scheduler's KV budget *is* ``num_blocks``.  Admission
writes the prefilled KV into exactly the prompt's blocks (O(prompt
blocks)); decode growth appends one block at a time; eviction returns
blocks to the free list in O(1) with no cache traffic.  Rollback of
rejected drafts trims the tail block in place.  Blocks carry copy-on-write
refcounts: ``fork`` aliases a whole row, ``cow_prepare`` copies only the
shared blocks a write is about to touch, and ``evict`` frees a block only
when its last reference drops — the substrate for tree speculation.
``kv_dtype`` in {bf16, int8, fp8} selects the block storage precision
(``kernels/quant.py``): quantized pools keep per-(slot, head) float32 scale
sidecars, written, copied and freed with the blocks they scale.

Block-accounting invariant: ``free_blocks + allocated_blocks ==
num_blocks`` after every admit/evict/ensure/fork sequence.

The bookkeeping (tables, refcounts, free lists) lives on the host in numpy,
as in the reference; the block pool lives on the pool's device and every
write to it is in place.  The reference's dense pool (``DenseCachePool``)
waits in ROADMAP Queue 1 (dense layout).
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.kernels import quant
from repro_torch.models import transformer as T


def _pow2(n: int) -> int:
    return 1 if n <= 1 else 1 << (n - 1).bit_length()


class PagedCachePool:
    """Block-table paged KV pool (module docstring has the full contract)."""

    def __init__(self, cfg, capacity: int, max_len: int,
                 block_size: int = 16, num_blocks: Optional[int] = None,
                 kv_dtype: str = "bf16", device="cuda"):
        bs = int(block_size)
        if bs <= 0:
            raise ValueError("block_size must be positive")
        quant.storage_dtype(kv_dtype)                # validate the name
        self.cfg = cfg
        self.device = T.resolve_device(device)
        self.capacity = capacity
        self.block_size = bs
        self.kv_dtype = kv_dtype
        self.blocks_per_row = max(1, math.ceil(max_len / bs))
        self.max_len = self.blocks_per_row * bs      # block-aligned
        if num_blocks is None:
            num_blocks = capacity * self.blocks_per_row
        # floor: one full row must always fit (empty-pool admission of an
        # oversized request is unconditional — no deadlock)
        self.num_blocks = max(int(num_blocks), self.blocks_per_row)
        self.cache = T.init_paged_cache(cfg, self.num_blocks, bs,
                                        kv_dtype=kv_dtype,
                                        device=self.device)
        self.lengths = np.zeros(capacity, np.int64)
        self.last_token = np.zeros(capacity, np.int64)
        self.row_of: Dict[int, int] = {}
        self._free_rows = list(range(capacity))
        self._free_blocks = list(range(self.num_blocks))
        self._table = np.full((capacity, self.blocks_per_row), -1, np.int32)
        self._nb = np.zeros(capacity, np.int32)      # allocated blocks/row
        self._ref = np.zeros(self.num_blocks, np.int32)  # CoW refcounts

    # --------------------------------------------------------- accounting --
    def has(self, rid: int) -> bool:
        return rid in self.row_of

    @property
    def free_rows(self) -> int:
        return len(self._free_rows)

    @property
    def free_blocks(self) -> int:
        return len(self._free_blocks)

    @property
    def allocated_blocks(self) -> int:
        # UNIQUE live blocks (a CoW-shared block counts once)
        return int(np.count_nonzero(self._ref))

    def ref_count(self, rid: int, block_index: int) -> int:
        """Refcount of the row's ``block_index``-th block (CoW probes)."""
        return int(self._ref[int(self._table[self.row_of[rid], block_index])])

    def blocks_needed(self, length: int) -> int:
        return min(self.blocks_per_row,
                   max(1, math.ceil(max(int(length), 1) / self.block_size)))

    def can_admit(self, length: int) -> bool:
        return (bool(self._free_rows)
                and len(self._free_blocks) >= self.blocks_needed(length))

    def allocated_cells(self, rid: int) -> int:
        return int(self._nb[self.row_of[rid]]) * self.block_size

    def prefill_len(self, src_len: int) -> int:
        """Block-aligned cache length to prefill with before ``insert``."""
        bs = self.block_size
        return math.ceil(src_len / bs) * bs

    def rows(self, rids) -> np.ndarray:
        return np.array([self.row_of[r] for r in rids], np.int32)

    def _ids(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64), device=self.device)

    # ---------------------------------------------------------- lifecycle --
    def _alloc(self, n: int) -> List[int]:
        if n > len(self._free_blocks):
            raise RuntimeError(
                f"paged pool out of blocks: need {n}, "
                f"free {len(self._free_blocks)}/{self.num_blocks} — the "
                f"scheduler's block accounting should have preempted first")
        ids = [self._free_blocks.pop() for _ in range(n)]
        for b in ids:
            self._ref[b] = 1
        return ids

    def _blocks_write(self, one_cache, ids: List[int]):
        """Write the first ``len(ids)`` blocks of a batch-1 dense cache into
        pool blocks ``ids``, quantizing K/V for int8/fp8 pools."""
        nb, bs = len(ids), self.block_size
        idx = self._ids(ids)
        for leaf in ("k", "v", "pos", "seg"):
            src = one_cache[leaf][:, 0, :nb * bs]
            src = src.reshape(src.shape[0], nb, bs, *src.shape[2:])
            dst = self.cache[leaf]
            if leaf + "_scale" in self.cache:
                src, scale = quant.quantize(src, dst.dtype)
                self.cache[leaf + "_scale"][:, idx] = scale
            dst[:, idx] = src.to(dst.dtype)

    def insert(self, rid: int, one_cache, length: int, last_token: int):
        """Admit a prefilled batch-1 cache: allocate the prompt's blocks and
        write K/V into exactly those — O(prompt blocks), not O(pool)."""
        nb = self.blocks_needed(length)
        S = one_cache["k"].shape[2]
        if S < nb * self.block_size:
            raise ValueError(
                f"prefilled cache covers {S} slots < {nb} blocks x "
                f"{self.block_size}; prefill with max_len=pool.prefill_len()")
        ids = self._alloc(nb)
        self._blocks_write(one_cache, ids)
        row = self._free_rows.pop()
        self.row_of[rid] = row
        self._table[row, :nb] = ids
        self._nb[row] = nb
        self.lengths[row] = length
        self.last_token[row] = last_token
        return row

    def insert_empty(self, rid: int) -> int:
        """Grant a row that owns no blocks yet (chunked prefill: blocks are
        allocated chunk-by-chunk via ``ensure`` as context is appended)."""
        row = self._free_rows.pop()
        self.row_of[rid] = row
        self._nb[row] = 0
        self.lengths[row] = 0
        self.last_token[row] = 0
        return row

    def row_table(self, rid: int) -> torch.Tensor:
        """(1, nb) block table of one row, power-of-two bucketed, for
        append-chunk writes through the paged decode override."""
        row = self.row_of[rid]
        nb = min(self.blocks_per_row, _pow2(max(1, int(self._nb[row]))))
        return torch.as_tensor(self._table[row:row + 1, :nb],
                               device=self.device)

    def ensure(self, rid: int, need_len: int):
        """Append blocks until the row covers ``need_len`` cells."""
        self.ensure_rows({rid: need_len})

    def ensure_rows(self, needs: Dict[int, int]):
        """Batched growth for one slot: allocate every row's missing
        blocks, then seg-invalidate all of them in one write (re-allocated
        blocks may hold a prior owner's slots)."""
        deltas = {}
        for rid, need_len in needs.items():
            row = self.row_of[rid]
            need = self.blocks_needed(need_len)
            if need > int(self._nb[row]):
                deltas[rid] = need
        total = sum(need - int(self._nb[self.row_of[rid]])
                    for rid, need in deltas.items())
        if not total:
            return
        if total > len(self._free_blocks):     # check before mutating
            raise RuntimeError(
                f"paged pool out of blocks: need {total}, "
                f"free {len(self._free_blocks)}/{self.num_blocks} — the "
                f"scheduler's block accounting should have preempted first")
        new_ids: List[int] = []
        for rid, need in deltas.items():
            row = self.row_of[rid]
            have = int(self._nb[row])
            ids = self._alloc(need - have)
            self._table[row, have:need] = ids
            self._nb[row] = need
            new_ids.extend(ids)
        self.cache["seg"][:, self._ids(new_ids)] = -1

    def fork(self, rid: int, new_rid) -> int:
        """Copy-on-write fork: grant ``new_rid`` a row whose block table
        ALIASES every block of ``rid`` — refcounts are bumped, no cache
        traffic moves.  Writes into the shared span must be preceded by
        ``cow_prepare``."""
        if new_rid in self.row_of:
            raise ValueError(f"fork target rid {new_rid} already live")
        if not self._free_rows:
            raise RuntimeError("paged pool out of rows for fork")
        src = self.row_of[rid]
        row = self._free_rows.pop()
        nb = int(self._nb[src])
        self._table[row, :nb] = self._table[src, :nb]
        self._nb[row] = nb
        self.lengths[row] = self.lengths[src]
        self.last_token[row] = self.last_token[src]
        self.row_of[new_rid] = row
        for b in self._table[src, :nb]:
            self._ref[int(b)] += 1
        return row

    def cow_prepare(self, rid, start: int, end: int) -> int:
        """Make the blocks covering cells [start, end) exclusive to
        ``rid``: every shared block (ref > 1) in the span is copied whole
        (all leaves) into a fresh block, the row's table repointed and the
        original's refcount dropped.  Returns the number of blocks copied."""
        row = self.row_of[rid]
        bs = self.block_size
        lo = max(0, int(start)) // bs
        hi = min(int(self._nb[row]), math.ceil(max(int(end), 0) / bs))
        src: List[int] = []
        dst: List[int] = []
        for bi in range(lo, hi):
            blk = int(self._table[row, bi])
            if self._ref[blk] > 1:
                new = self._alloc(1)[0]
                self._ref[blk] -= 1       # ref > 1, so never frees here
                self._table[row, bi] = new
                src.append(blk)
                dst.append(new)
        if src:
            s, d = self._ids(src), self._ids(dst)
            for t in self.cache.values():
                t[:, d] = t[:, s]
        return len(src)

    def rename(self, rid, new_rid):
        """Re-key a live row (winner-branch adoption after tree verify)."""
        if new_rid in self.row_of:
            raise ValueError(f"rename target rid {new_rid} already live")
        self.row_of[new_rid] = self.row_of.pop(rid)

    def evict(self, rid):
        """Free the row and drop one reference per block; blocks return to
        the free list only at refcount zero — O(row blocks), no cache
        traffic (stale blocks are unreachable without a table entry and
        re-invalidated on re-allocation)."""
        row = self.row_of.pop(rid)
        nb = int(self._nb[row])
        for b in self._table[row, :nb]:
            b = int(b)
            self._ref[b] -= 1
            if self._ref[b] == 0:
                self._free_blocks.append(b)
        self._table[row, :nb] = -1
        self._nb[row] = 0
        self.lengths[row] = 0
        self._free_rows.append(row)

    def invalidate_span(self, new_lengths, upper, W: int):
        """Rollback rejected drafts: seg=-1 for positions
        [new_lengths, upper) per row (W = span bound).  Rows whose table has
        no block there (idle rows) write nothing."""
        nl = np.asarray(new_lengths, np.int64)
        up = np.asarray(upper, np.int64)
        bs = self.block_size
        p = nl[:, None] + np.arange(int(W))[None]
        lb = p // bs
        phys = np.take_along_axis(
            self._table, np.clip(lb, 0, self.blocks_per_row - 1), axis=1)
        ok = (p < up[:, None]) & (lb < self.blocks_per_row) & (phys >= 0)
        flat = (phys.astype(np.int64) * bs + p % bs)[ok]
        if flat.size:
            L = self.cache["seg"].shape[0]
            self.cache["seg"].view(L, -1)[:, self._ids(flat)] = -1

    # ------------------------------------------------------------- views --
    def block_table_array(self) -> Tuple[torch.Tensor, int]:
        """(capacity, nb_max) device block table, nb_max bucketed to the
        next power of two of the longest row's allocation."""
        nb_max = min(self.blocks_per_row,
                     _pow2(int(self._nb.max()) if len(self._nb) else 1))
        return (torch.as_tensor(self._table[:, :nb_max], device=self.device),
                nb_max)

    def live_blocks(self) -> Tuple[np.ndarray, np.ndarray]:
        """(block_ids, owner_rows) over all live rows, padded to a power-of
        -two length with (0, -1) entries (owner -1 = skip).  CoW-shared
        blocks are listed ONCE, under the first row encountered."""
        ids: List[int] = []
        owner: List[int] = []
        seen = set()
        for rid, row in self.row_of.items():
            nb = int(self._nb[row])
            for b in self._table[row, :nb]:
                b = int(b)
                if b in seen:
                    continue
                seen.add(b)
                ids.append(b)
                owner.append(row)
        m = _pow2(max(1, len(ids)))
        ids += [0] * (m - len(ids))
        owner += [-1] * (m - len(owner))
        return (np.asarray(ids, np.int32), np.asarray(owner, np.int32))
