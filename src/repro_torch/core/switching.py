"""Fast SSM switching (paper §IV-C).

Switching request i from SSM a to SSM b requires re-computing b's KV cache
over all tokens generated so far (the switching cost c_{i,j}(t), which grows
with context length).  Newly drafted tokens cannot change the KV of existing
tokens, so the destination's cache can be pre-computed while drafting goes
on at the source SSM.  The engine calls ``precompute`` for the *predicted*
destination; a prediction hit makes the switch free, a miss falls back to a
synchronous recompute (cost accounted).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch.core.spec_decode import invalidate_slots


@dataclasses.dataclass
class PrecomputedKV:
    ssm_idx: int
    upto_length: int
    cache: object
    lengths: object
    # sequence capacity the cache was prefilled with; a switch whose
    # context has outgrown it falls back to a miss instead of silently
    # dropping catch-up KV writes past the grid
    width: int = 0


class SwitchManager:
    """Tracks per-request destination pre-computation and switch costs."""

    def __init__(self, ssm_bundles):
        self.ssms = ssm_bundles
        self.pre: Dict[int, PrecomputedKV] = {}
        self.hits = 0
        self.misses = 0
        self.recompute_tokens = 0    # tokens re-prefilled synchronously
        self.saved_tokens = 0        # tokens whose recompute was hidden

    @staticmethod
    def _padded(tokens, length: int, device, align: int = 16):
        """Pad the token row to a bucketed shape."""
        pb = max(align, int(math.ceil(length / align) * align))
        row = np.zeros((1, pb), np.int32)
        row[0, :length] = np.asarray(tokens[:length], np.int32)
        return torch.as_tensor(row, device=device)

    def precompute(self, request_id: int, dst: int, tokens, length: int,
                   max_len: int):
        """Prefill request context on the destination SSM.  ``max_len`` is
        the cache width to build (a bucketed O(context) width for paged
        pools, with a gamma+1 growth margin)."""
        b = self.ssms[dst]
        toks = self._padded(tokens, length, b.device)
        lengths = torch.tensor([length], dtype=torch.int32, device=b.device)
        _, cache = b.prefill(toks, lengths, max_len)
        self.pre[request_id] = PrecomputedKV(
            ssm_idx=dst, upto_length=length, cache=cache, lengths=lengths,
            width=max_len)

    def switch(self, request_id: int, dst: int, tokens, length: int,
               max_len: int) -> Tuple[object, int]:
        """Returns (cache_on_dst, tokens_recomputed_synchronously)."""
        pre = self.pre.pop(request_id, None)
        if (pre is not None and pre.ssm_idx == dst
                and pre.width and length > pre.width):
            pre = None            # context outgrew the precomputed grid
        b = self.ssms[dst]
        if pre is not None and pre.ssm_idx == dst:
            self.hits += 1
            delta = length - pre.upto_length
            self.saved_tokens += pre.upto_length
            if delta <= 0:
                return pre.cache, 0
            # catch up the few tokens drafted since pre-compute (bucketed
            # width; over-written garbage slots invalidated afterwards)
            toks = self._padded(tokens[pre.upto_length:length], delta,
                                b.device, align=8)
            lengths = torch.tensor([pre.upto_length], dtype=torch.int32,
                                   device=b.device)
            _, cache = b.decode(pre.cache, toks, lengths)
            cache = invalidate_slots(
                cache, torch.tensor([length], dtype=torch.int32),
                torch.tensor([pre.upto_length + toks.shape[1]],
                             dtype=torch.int32))
            self.recompute_tokens += delta
            return cache, delta
        # miss: full synchronous recompute
        self.misses += 1
        toks = self._padded(tokens, length, b.device)
        lengths = torch.tensor([length], dtype=torch.int32, device=b.device)
        _, cache = b.prefill(toks, lengths, max_len)
        self.recompute_tokens += length
        return cache, length

    @property
    def stats(self) -> dict:
        return {"hits": self.hits, "misses": self.misses,
                "recompute_tokens": self.recompute_tokens,
                "saved_tokens": self.saved_tokens}
