"""Training data pipeline.

The corpus is a seeded synthetic language with structure at TWO scales:

  * an order-1 backbone  t1[prev]           — learnable by any tiny model;
  * an order-3 backbone  t3[hash(prev,prev2,prev3)] — needs capacity.

Each token follows the order-3 process with prob = request difficulty, else
the order-1 process.  This gives exactly the capacity-dependent
predictability SPIN's heterogeneous SSMs exploit (paper Fig. 2/3): small
distilled SSMs match the LLM on easy (order-1-dominated) requests; hard
requests need the larger SSMs.  See tests/test_substrates.py.

Deterministic by (seed, step, host): each host reads a disjoint shard, so
restarts resume from the step counter alone — no data-state checkpoint.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

N_CTX2 = 131
N_CTX3 = 521


def _backbone(rng: np.random.Generator, vocab: int):
    """(t1, t2, t3) transition tables — order-1 / order-2 / order-3
    structure (values avoid the mode-marker tokens).  Capacity ladder:
    tiny models learn t1, mid models add t2, only large models fit t3."""
    t1 = rng.integers(3, vocab, size=(vocab,))
    t2 = rng.integers(3, vocab, size=(N_CTX2,))
    t3 = rng.integers(3, vocab, size=(N_CTX3,))
    return t1, t2, t3


def _h2(a: int, b: int) -> int:
    return (a * 31 + b * 7) % N_CTX2


def _h3(a: int, b: int, c: int) -> int:
    return (a * 131 + b * 31 + c * 7) % N_CTX3


def mode_of(difficulty: float) -> int:
    """1 = easy (order-1), 2 = medium (order-2), 3 = hard (order-3)."""
    return 1 if difficulty < 0.33 else (2 if difficulty < 0.66 else 3)


def synthetic_sequence(rng: np.random.Generator, length: int, vocab: int,
                       tables, difficulty: float) -> np.ndarray:
    """Three request modes of increasing structural order; token 0 is the
    MODE MARKER so the mode is observable in-context.  Within a mode the
    greedy continuation is DETERMINISTIC (table chain + 2% noise floor), so
    draft acceptance measures whether a model has the capacity to learn
    that mode's table: tiny models learn t1 only, mid-size add t2 (131
    hashed contexts), only large models fit t3 (521 contexts) — the
    capacity-dependent Fig. 2/3 effect."""
    t1, t2, t3 = tables
    mode = mode_of(difficulty)
    seq = np.empty(length, np.int64)
    seq[1:3] = rng.integers(3, vocab, 2)
    seq[0] = mode
    noise = rng.random(length) < 0.02
    for t in range(3, length):
        if noise[t]:
            seq[t] = rng.integers(3, vocab)
        elif mode == 1:
            seq[t] = t1[int(seq[t - 1])]
        elif mode == 2:
            seq[t] = t2[_h2(int(seq[t - 1]), int(seq[t - 2]))]
        else:
            seq[t] = t3[_h3(int(seq[t - 1]), int(seq[t - 2]),
                            int(seq[t - 3]))]
    return seq


def synthetic_corpus_batch(seed: int, step: int, batch: int, seq_len: int,
                           vocab: int, difficulty: float = 0.35,
                           host_id: int = 0, num_hosts: int = 1):
    """(tokens, labels) int32 arrays for one training step.  Per-sequence
    difficulty is drawn uniform in [0, 2*difficulty] so the corpus teaches
    both scales of structure."""
    rng = np.random.default_rng(
        np.random.SeedSequence([seed, step * num_hosts + host_id]))
    tables = _backbone(np.random.default_rng(seed), vocab)
    # trimodal: easy / medium / hard sequences in equal parts
    toks = np.stack([
        synthetic_sequence(rng, seq_len + 1, vocab, tables,
                           difficulty=float(rng.choice([0.1, 0.5, 0.9])))
        for _ in range(batch)])
    return toks[:, :-1].astype(np.int32), toks[:, 1:].astype(np.int32)


@dataclasses.dataclass
class TokenStream:
    """Stateless-resumable training stream (step index is the only state)."""
    seed: int
    batch: int
    seq_len: int
    vocab: int
    difficulty: float = 0.35
    host_id: int = 0
    num_hosts: int = 1

    def batch_at(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        return synthetic_corpus_batch(
            self.seed, step, self.batch, self.seq_len, self.vocab,
            self.difficulty, self.host_id, self.num_hosts)

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
