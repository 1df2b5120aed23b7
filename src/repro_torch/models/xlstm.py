"""xLSTM blocks: mLSTM (matrix memory, chunked-parallel) and sLSTM (scalar
memory, strictly sequential recurrence).

Port of the reference's ``models/xlstm.py``.  mLSTM uses the same chunked
log-space-decay form as Mamba2's SSD: the per-head forget gate is the
decay, the exponential input gate (logits clamped) the input scale, with a
value readout (numerator) and a key-sum readout (denominator), in float32.
sLSTM keeps the h_{t-1} -> gates recurrence; its time loop is a Python loop
(the reference's ``lax.scan``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import (constrain, is_dtensor, layout,
                                              on_shards)
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import P

PF_M = 2  # mLSTM up-projection factor
PF_S = 4.0 / 3.0  # sLSTM FFN factor
CLAMP = 8.0  # input-gate logit clamp


class MLstmState(NamedTuple):
    C: torch.Tensor  # (B, nh, dk, dv) float32
    n: torch.Tensor  # (B, nh, dk) float32


class SLstmState(NamedTuple):
    c: torch.Tensor  # (B, nh, hd) float32
    n: torch.Tensor
    h: torch.Tensor
    m: torch.Tensor


# ----------------------------------------------------------------- mLSTM --

def mlstm_spec(cfg):
    d = cfg.d_model
    di = PF_M * d
    return {
        "ln": P((d,), ("embed",), init="zeros"),
        "up_proj": P((d, 2 * di), ("embed", "xl_up")),
        "wq": P((di, di), ("xl_inner", "xl_inner2")),
        "wk": P((di, di), ("xl_inner", "xl_inner2")),
        "wv": P((di, di), ("xl_inner", "xl_inner2")),
        "w_gates": P((d, 2 * cfg.n_heads), ("embed", None)),
        "b_gates": P((2 * cfg.n_heads,), (None,), init="zeros"),
        "norm_w": P((di,), ("xl_inner",), init="zeros"),
        "down_proj": P((di, d), ("xl_inner", "embed")),
    }


def _mlstm_chunk(q, k, v, ig, la, state):
    """q, k, v: (B,Q,nh,dk) float32; ig (input gate), la (log forget
    decay): (B,Q,nh).  Returns (h, new MLstmState)."""
    Q = q.shape[1]
    lac = torch.cumsum(la, dim=1)
    G = torch.einsum("bihd,bjhd->bijh", q, k)  # (B,Q,Q,nh)
    ratio = lac[:, :, None, :] - lac[:, None, :, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    W = torch.where(mask[None, :, :, None], torch.exp(ratio), 0.0)
    W = W * G * ig[:, None, :, :]
    num = torch.einsum("bijh,bjhe->bihe", W, v)
    den = W.sum(2)  # (B,Q,nh)
    decay_i = torch.exp(lac)
    num = num + torch.einsum("bihd,bhde->bihe", q, state.C) \
        * decay_i[..., None]
    den = den + torch.einsum("bihd,bhd->bih", q, state.n) * decay_i
    h = num / torch.clamp(den.abs(), min=1.0)[..., None]
    wj = torch.exp(lac[:, -1:, :] - lac) * ig
    end = torch.exp(lac[:, -1])
    C_new = state.C * end[..., None, None] \
        + torch.einsum("bjh,bjhd,bjhe->bhde", wj, k, v)
    n_new = state.n * end[..., None] + torch.einsum("bjh,bjhd->bhd", wj, k)
    return h, MLstmState(C=C_new, n=n_new)


def _mlstm_chunk_sharded(q, k, v, ig, la, state):
    """:func:`_mlstm_chunk` over DTensors: each device runs its shards of
    the batch and the heads, as the active rule table lays them out (the
    einsums keep batch and heads apart)."""
    B, Q, nh, dk = q.shape
    hp = layout("batch", "seq", "heads", shape=(B, Q, nh))
    sp = layout("batch", "heads", shape=(B, nh))

    def run(q, k, v, ig, la, C, n):
        h, st = _mlstm_chunk(q, k, v, ig, la, MLstmState(C, n))
        return h, st.C, st.n

    h, C, n = on_shards(run, q.device_mesh,
                        (q, k, v, ig, la, state.C, state.n),
                        (hp,) * 5 + (sp, sp), (hp, sp, sp))
    return h, MLstmState(C, n)


def mlstm_forward(params, x, cfg, *, state=None, chunk: int = 128):
    """x: (B, S, d).  Returns (out, MLstmState)."""
    B, S, _ = x.shape
    nh = cfg.n_heads
    di = PF_M * cfg.d_model
    dk = di // nh
    dt_ = x.dtype

    up = x @ params["up_proj"]
    xi, z = up[..., :di], up[..., di:]

    def heads(w):
        # under a rule table the (heads x dk) dim is laid out as the head
        # count allows, so that the split into heads is even
        y = constrain(xi @ w, "batch", "seq", "heads", shape=(B, S, nh))
        return y.reshape(B, S, nh, dk).float()

    q, k, v = heads(params["wq"]), heads(params["wk"]), heads(params["wv"])
    q = q / float(dk) ** 0.5
    gates = (x @ params["w_gates"] + params["b_gates"]).float()
    ig = torch.exp(torch.clamp(gates[..., :nh], -CLAMP, CLAMP))  # (B,S,nh)
    la = F.logsigmoid(gates[..., nh:])  # log forget decay

    s0 = state if state is not None else mlstm_init_state(cfg, B, x.device)
    step = _mlstm_chunk_sharded if is_dtensor(q) else _mlstm_chunk
    if S <= chunk:
        h, s_new = step(q, k, v, ig, la, s0)
    else:
        if S % chunk:
            raise ValueError(f"sequence length {S} is not a multiple of "
                             f"the mLSTM chunk {chunk}")
        hs, s_new = [], s0
        for lo in range(0, S, chunk):
            sl = slice(lo, lo + chunk)
            h_c, s_new = step(q[:, sl], k[:, sl], v[:, sl], ig[:, sl],
                              la[:, sl], s_new)
            hs.append(h_c)
        h = torch.cat(hs, dim=1)

    h = h.reshape(B, S, di).to(dt_)
    h = rms_norm(h, params["norm_w"], cfg.norm_eps)
    h = h * F.silu(z)
    return h @ params["down_proj"], s_new


def mlstm_init_state(cfg, batch, device="cuda"):
    nh = cfg.n_heads
    dk = PF_M * cfg.d_model // nh
    return MLstmState(
        C=torch.zeros((batch, nh, dk, dk), dtype=torch.float32,
                      device=device),
        n=torch.zeros((batch, nh, dk), dtype=torch.float32, device=device))


# ----------------------------------------------------------------- sLSTM --

def slstm_spec(cfg):
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    ff = int(PF_S * d)
    return {
        "ln": P((d,), ("embed",), init="zeros"),
        "w_in": P((d, 4 * d), ("embed", None)),  # i, f, z, o projections
        "r": P((4, nh, hd, hd), (None, "heads", None, None)),
        "b": P((4 * d,), (None,), init="zeros"),
        "norm_w": P((d,), ("embed",), init="zeros"),
        "ff_up": P((d, 2 * ff), ("embed", "mlp")),
        "ff_down": P((ff, d), ("mlp", "embed")),
    }


def _slstm_scan(xproj, r, s):
    """The recurrence over xproj (B, S, 4, nh, hd) from state ``s``.
    Returns (h (B, S, nh, hd), the last SLstmState)."""
    hs = []
    # one unbind each, not a select a step: a select's gradient is a
    # zero tensor of the whole input, one a step
    for x_t in xproj.unbind(1):
        # recurrent contribution from h_{t-1}
        g = x_t + torch.einsum("bhd,ghde->bghe", s.h, r)
        it, ft, zt, ot = g.unbind(1)
        m_new = torch.maximum(ft + s.m, it)
        i_p = torch.exp(it - m_new)
        f_p = torch.exp(ft + s.m - m_new)
        c_new = f_p * s.c + i_p * torch.tanh(zt)
        n_new = f_p * s.n + i_p
        h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1.0)
        s = SLstmState(c_new, n_new, h_new, m_new)
        hs.append(h_new)
    return torch.stack(hs, dim=1), s


def _slstm_scan_sharded(xproj, r, s):
    """:func:`_slstm_scan` over DTensors: each device steps its shards of
    the batch and the heads, as the active rule table lays them out (every
    step is local, so the time loop runs on local tensors)."""
    B, S, _, nh, _ = xproj.shape
    xp = layout("batch", "seq", None, "heads", shape=xproj.shape)
    rp = layout(None, "heads", shape=r.shape)
    sp = layout("batch", "heads", shape=(B, nh))

    def run(xproj, r, *state):
        h, st = _slstm_scan(xproj, r, SLstmState(*state))
        return (h,) + tuple(st)

    h, *st = on_shards(run, xproj.device_mesh, (xproj, r) + tuple(s),
                       (xp, rp) + (sp,) * 4,
                       (layout("batch", "seq", "heads", shape=(B, S, nh)),)
                       + (sp,) * 4)
    return h, SLstmState(*st)


def slstm_forward(params, x, cfg, *, state=None):
    """Sequential sLSTM.  x: (B, S, d).  Returns (out, SLstmState)."""
    B, S, d = x.shape
    nh = cfg.n_heads
    hd = d // nh
    dt_ = x.dtype

    xproj = (x @ params["w_in"] + params["b"]).float()
    # under a rule table the gates' dim is laid out as the table says
    # (whole), so that the split into (gate, head, hd) is even
    xproj = constrain(xproj, "batch", "seq").reshape(B, S, 4, nh, hd)
    r = params["r"].float()
    s = state if state is not None else slstm_init_state(cfg, B, x.device)
    scan = _slstm_scan_sharded if is_dtensor(xproj) else _slstm_scan
    h, s = scan(xproj, r, s)
    h = h.reshape(B, S, d).to(dt_)
    h = rms_norm(h, params["norm_w"], cfg.norm_eps)
    up = h @ params["ff_up"]
    ff = up.shape[-1] // 2
    # jax.nn.gelu defaults to the tanh approximation
    h = F.gelu(up[..., :ff], approximate="tanh") * up[..., ff:]
    return h @ params["ff_down"], s


def slstm_init_state(cfg, batch, device="cuda"):
    nh = cfg.n_heads
    hd = cfg.d_model // nh
    return SLstmState(*[torch.zeros((batch, nh, hd), dtype=torch.float32,
                                    device=device) for _ in range(4)])
