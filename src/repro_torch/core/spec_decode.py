"""Speculative decoding primitives.

One iteration = the SSM drafts ``gamma`` candidate tokens (autoregressive
decode steps), then the LLM scores ``[last_token, c_1..c_gamma]`` in ONE
forward and accepts a prefix (greedy: accept while draft == LLM argmax, so
the output is identical to plain LLM greedy decoding).  Caches are rolled
back by invalidating rejected slots (segment id -1).
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.models import config as C
from repro_torch.models import transformer as T
from repro_torch.serving import paged


@dataclasses.dataclass
class Bundle:
    """A model and its entry points.  ``fused_cfg`` (a
    ``kernels.autotune.FusedConfig``) routes the paged entry points through
    the fused kernels; None keeps the gather path."""
    cfg: C.ModelConfig
    params: dict

    @property
    def device(self) -> torch.device:
        return self.params["embed"].device

    def prefill(self, toks, lengths, max_len):
        return T.prefill(self.params, self.cfg, tokens=toks, lengths=lengths,
                         max_len=max_len)

    def decode(self, cache, toks, lengths):
        return T.decode_step(self.params, self.cfg, cache, tokens=toks,
                             lengths=lengths)

    def append(self, cache, toks, lengths, segments):
        """Chunked-prefill append on a batch-1 dense row cache; ``segments``
        marks bucket-padding tokens with -1."""
        return T.decode_step(self.params, self.cfg, cache, tokens=toks,
                             lengths=lengths, segments=segments)

    def append_paged(self, cache, toks, lengths, segments, block_tables,
                     fused_cfg=None):
        """Chunked-prefill append through a paged block pool: the (1, T)
        chunk writes straight into the row's blocks and attends its prior
        context blocks (serving/paged.decode_step_paged)."""
        return paged.decode_step_paged(
            self.params, self.cfg, cache, tokens=toks, lengths=lengths,
            segments=segments, block_tables=block_tables,
            fused_cfg=fused_cfg)

    def decode_paged(self, cache, toks, lengths, block_tables,
                     fused_cfg=None):
        """Decode against a paged block pool (serving/pool.py)."""
        return paged.decode_step_paged(
            self.params, self.cfg, cache, tokens=toks, lengths=lengths,
            block_tables=block_tables, fused_cfg=fused_cfg)

    def verify_paged(self, cache, tokens, positions, segments, q_rows,
                     block_tables, block_ids, block_owner, fused_cfg=None):
        """Packed verification over the paged pool's live blocks."""
        return paged.verify_step_paged(
            self.params, self.cfg, cache, tokens=tokens, positions=positions,
            segments=segments, q_rows=q_rows, block_tables=block_tables,
            block_ids=block_ids, block_owner=block_owner,
            fused_cfg=fused_cfg)

    def verify_paged_tree(self, cache, tokens, positions, segments, q_rows,
                          block_tables, block_ids, block_owner, q_anc,
                          block_node, fused_cfg=None):
        """Tree-topology packed verification: :meth:`verify_paged` plus the
        ancestor-bitmask / per-slot node-tag mask term."""
        return paged.verify_step_paged(
            self.params, self.cfg, cache, tokens=tokens, positions=positions,
            segments=segments, q_rows=q_rows, block_tables=block_tables,
            block_ids=block_ids, block_owner=block_owner, q_anc=q_anc,
            block_node=block_node, fused_cfg=fused_cfg)

    @property
    def has_recurrent_state(self) -> bool:
        kinds = set(self.cfg.unit) | set(self.cfg.tail)
        return bool(kinds & {C.MAMBA2, C.MLSTM, C.SLSTM})


def _mask_vocab(logits, vocab_size: int):
    logits = logits.float()
    if logits.shape[-1] > vocab_size:   # mask vocab padding
        mask = torch.arange(logits.shape[-1], device=logits.device)
        logits = torch.where(mask < vocab_size, logits, -1e30)
    return logits


def logits_to_probs(logits, temperature: float, vocab_size: int):
    logits = _mask_vocab(logits, vocab_size)
    if temperature <= 0.0:
        # one-hot argmax (greedy "distribution")
        idx = torch.argmax(logits, -1)
        return torch.nn.functional.one_hot(idx, logits.shape[-1]).float()
    return torch.softmax(logits / temperature, dim=-1)


def sample(probs, generator: torch.Generator):
    return torch.multinomial(probs, 1, generator=generator)[:, 0]


# ------------------------------------------------------------------ draft --

def draft(ssm: Bundle, cache, last_tokens, lengths, gamma: int,
          generator=None, temperature: float = 0.0,
          collect_probs: bool = False, block_tables=None, fused_cfg=None):
    """Generate gamma candidates.  last_tokens: (B, 1) previous accepted
    token.  Returns (cand (B, gamma), qprobs (B, gamma, V) | None, cache).
    ``block_tables`` routes the decode steps through the paged KV pool;
    ``fused_cfg`` additionally routes them through the fused kernel.
    Sampling (``temperature > 0``) draws from ``generator``."""
    cands, qs = [], []
    tok = last_tokens
    for g in range(gamma):
        if block_tables is not None:
            logits, cache = ssm.decode_paged(cache, tok, lengths + g,
                                             block_tables, fused_cfg)
        else:
            logits, cache = ssm.decode(cache, tok, lengths + g)
        if temperature <= 0 and not collect_probs:
            lg = _mask_vocab(logits[:, -1], ssm.cfg.vocab_size)
            tok = torch.argmax(lg, -1, keepdim=True).to(torch.int32)
        else:
            probs = logits_to_probs(logits[:, -1], temperature,
                                    ssm.cfg.vocab_size)
            tok = (torch.argmax(probs, -1, keepdim=True) if temperature <= 0
                   else sample(probs, generator)[:, None]).to(torch.int32)
            qs.append(probs)
        cands.append(tok)
    cand = torch.cat(cands, dim=1)
    qprobs = torch.stack(qs, dim=1) if collect_probs else None
    return cand, qprobs, cache


def draft_tree(ssm: Bundle, cache, last_tokens, lengths, gamma: int, ranks,
               block_tables=None, fused_cfg=None):
    """Greedy tree drafting: each pool row autoregressively extends ONE
    branch of a request's token tree.  Rows of the same request share
    identical context (CoW-forked block tables), so their step-1 logits are
    identical; ``ranks[b]`` selects which top-k candidate row b commits to
    at the first step (rank 0 = argmax, the main chain), after which every
    row continues greedily.  The top-k order is stable (ties: lower token
    id first), as ``jax.lax.top_k``.  Returns (cand (B, gamma), cache)."""
    ranks_np = np.asarray(ranks)
    kmax = int(ranks_np.max()) + 1 if ranks_np.size else 1
    cands = []
    tok = last_tokens
    for g in range(gamma):
        if block_tables is not None:
            logits, cache = ssm.decode_paged(cache, tok, lengths + g,
                                             block_tables, fused_cfg)
        else:
            logits, cache = ssm.decode(cache, tok, lengths + g)
        lg = _mask_vocab(logits[:, -1], ssm.cfg.vocab_size)
        best = torch.argmax(lg, -1, keepdim=True).to(torch.int32)
        if g == 0 and kmax > 1:
            order = torch.sort(lg, dim=-1, descending=True, stable=True)[1]
            rk = torch.as_tensor(ranks_np, dtype=torch.long,
                                 device=lg.device)[:, None]
            ranked = torch.gather(order[:, :kmax], 1, rk).to(torch.int32)
            # rank 0 keeps argmax's tie-breaking (== linear draft exactly)
            tok = torch.where(rk == 0, best, ranked)
        else:
            tok = best
        cands.append(tok)
    return torch.cat(cands, dim=1), cache


# --------------------------------------------------------------- rollback --

def invalidate_slots(cache, new_lengths, upper):
    """Mark dense attention-cache slots with new_len <= pos < upper as
    empty (seg = -1), in place.  cache: ``transformer.init_cache`` dict."""
    pos, seg = cache["pos"], cache["seg"]            # (L, B, S)
    nl = new_lengths.to(pos.device)[None, :, None]
    up = upper.to(pos.device)[None, :, None]
    seg.masked_fill_((pos >= nl) & (pos < up), -1)
    return cache
