"""The bytes and operations of one ``ops.moe_experts`` call (the dropless
grouped experts), from its captured arguments."""

from __future__ import annotations

import torch


def experts_work(a):
    """(bytes, operations) the call needs: the weights of every expert its
    ids route to, once; the tokens' rows in and out; the ids and routing
    weights; 2 x 3 d ff operations per (token, choice) pair."""
    E, d, ff = a["w_gate"].shape
    ids, wts = a["ids"], a["weights"]
    T = ids.shape[0]
    touched = torch.unique(ids.cpu()).numel()
    nbytes = (touched * 3 * d * ff * a["w_gate"].element_size()
              + 2 * T * d * a["x"].element_size()
              + ids.numel() * ids.element_size()
              + wts.numel() * wts.element_size())
    return nbytes, 2 * 3 * d * ff * ids.numel()


def pairs_per_expert(a) -> float:
    """Routed pairs per expert that one call touches."""
    ids = a["ids"].cpu()
    return ids.numel() / torch.unique(ids).numel()
