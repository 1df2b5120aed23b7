"""The comparison that decides ``correct``.

Once the window has closed and the program's state is freed, a sample
drawn from the seed is judged against each model's plain reference
(``reference/<name>.py``: the model entry's ``"reference"``, else the
configuration's):

* ``llm_gap``: of the requests finished in the window, the one with the
  most served tokens and ``sample_requests - 1`` others; the reference runs
  once over each prompt with its served tokens (the admission prefill's
  first token, then every token the packed verify accepted or produced),
  and the number is the widest gap by which a served token's reference
  logit lies below the reference's best at its position;
* ``draft_gap``: per SSM, of the drafts made in the window, the one with
  the longest context and ``sample_drafts - 1`` others; the reference runs
  the SSM over the context with its drafted tokens, and the number is the
  widest gap of a drafted token below the SSM reference's best.  Greedy
  verification corrects any draft, so the served tokens cannot show a
  fault of the draft or catch-up steps; this number does.

Greedy tokens only, so a gap of 0 is exact agreement and a small gap is a
near tie that rounding may flip.  The control (``control=True``) reads, at
the same positions, the reference gap of the token that the reference in
float8 puts first.
"""

from __future__ import annotations

import numpy as np
import torch


def pick(keys, n: int, rng: np.random.Generator):
    """Indices of the largest key and ``n - 1`` others drawn by ``rng``."""
    if not keys:
        return []
    top = int(np.argmax(keys))
    rest = [i for i in range(len(keys)) if i != top]
    extra = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [top] + [rest[int(i)] for i in sorted(extra)]


def widest_gap(ref, params, m: dict, seqs, control: bool = False):
    """seqs: [(tokens, first)], the served tokens being ``tokens[first:]``.
    Returns (widest reference gap of the served tokens, tokens judged,
    the control's widest gap or None)."""
    device = params["embed"].device
    S = max(len(t) for t, _ in seqs)
    toks = torch.zeros(len(seqs), S, dtype=torch.long)
    b_idx, p_idx, target = [], [], []
    for b, (t, first) in enumerate(seqs):
        toks[b, :len(t)] = torch.as_tensor(np.asarray(t, np.int64))
        for p in range(max(first, 1) - 1, len(t) - 1):
            b_idx.append(b)
            p_idx.append(p)
            target.append(int(t[p + 1]))
    toks = toks.to(device)
    b_idx = torch.tensor(b_idx, device=device)
    p_idx = torch.tensor(p_idx, device=device)
    target = torch.tensor(target, device=device)

    def rows(quant):
        h = ref.hidden(params, m, toks, quant)
        return ref.logits(params, m, h[b_idx, p_idx], quant)

    lg = rows(None)
    best = lg.max(dim=1).values
    gap = float((best - lg.gather(1, target[:, None])[:, 0]).max())
    cgap = None
    if control:
        first = rows("fp8").argmax(dim=1)
        cgap = float((best - lg.gather(1, first[:, None])[:, 0]).max())
    return gap, len(target), cgap
