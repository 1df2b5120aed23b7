"""Mamba2 (SSD) block: chunked-parallel prefill, O(1) decode.

Port of the reference's ``models/mamba2.py``.  State-space recurrence per
head h with scalar decay:
    a_t = exp(A_h * dt_t),   S_t = a_t * S_{t-1} + dt_t * B_t x_t^T,
    y_t = C_t . S_t + D_h * x_t
Prefill uses the chunked (SSD) form: a within-chunk quadratic term with
log-space decay ratios plus the state carried across chunks; it equals the
sequential recurrence (``tests/test_torch_models.py``).  The chunk loop is
a Python loop (the reference's ``lax.scan``).
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from repro_torch.distributed.sharding import is_dtensor, layout, on_shards
from repro_torch.models.layers import rms_norm
from repro_torch.models.params import P


class Mamba2State(NamedTuple):
    ssd: torch.Tensor  # (B, nh, hd, ds) float32
    conv: torch.Tensor  # (B, k-1, conv_dim) rolling raw inputs


def param_spec(cfg):
    d, di, ds, nh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * ds
    return {
        "ln": P((d,), ("embed",), init="zeros"),
        "in_proj": P((d, 2 * di + 2 * ds + nh), ("embed", "ssm_in")),
        "conv_w": P((cfg.conv_kernel, conv_dim), (None, "ssm_conv")),
        "conv_b": P((conv_dim,), ("ssm_conv",), init="zeros"),
        "A_log": P((nh,), ("ssm_heads",), init="zeros"),
        "dt_bias": P((nh,), ("ssm_heads",), init="zeros"),
        "D": P((nh,), ("ssm_heads",), init="zeros"),
        "norm_w": P((di,), ("ssm_inner",), init="zeros"),
        "out_proj": P((di, d), ("ssm_inner", "embed")),
    }


def _split(cfg, proj):
    di, ds = cfg.d_inner, cfg.ssm_state
    return proj[..., :di], proj[..., di:2 * di + 2 * ds], \
        proj[..., 2 * di + 2 * ds:]


def _conv(cfg, xbc, conv_w, conv_b, prev):
    """Depthwise causal conv, kernel k.  prev: (B, k-1, C) history or
    None.  Returns (out, the last k-1 raw inputs)."""
    k = cfg.conv_kernel
    if prev is None:
        pad = torch.zeros(xbc.shape[:-2] + (k - 1, xbc.shape[-1]),
                          dtype=xbc.dtype, device=xbc.device)
    else:
        pad = prev.to(xbc.dtype)
    xp = torch.cat([pad, xbc], dim=-2)  # (B, S+k-1, C)
    S = xbc.shape[-2]
    out = sum(xp[..., i:i + S, :] * conv_w[i] for i in range(k))
    out = F.silu(out + conv_b)
    return out, xp[..., xp.shape[-2] - (k - 1):, :]


def _ssd_chunk(xh, Bk, Ck, dt, a_log, state):
    """One chunk of SSD.  xh: (B,Q,nh,hd)  Bk/Ck: (B,Q,ds)  dt, a_log:
    (B,Q,nh)  state: (B,nh,hd,ds) float32.  Returns (y, new_state)."""
    Q = xh.shape[1]
    la = torch.cumsum(a_log, dim=1)  # (B,Q,nh) log cumulative decay
    # intra-chunk: y[i] += sum_{j<=i} (C_i.B_j) exp(la_i - la_j) dt_j x_j
    G = torch.einsum("bis,bjs->bij", Ck, Bk)  # (B,Q,Q)
    ratio = la[:, :, None, :] - la[:, None, :, :]  # (B,i,j,nh)
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xh.device))
    W = torch.where(mask[None, :, :, None], torch.exp(ratio), 0.0)
    W = W * G[..., None] * dt[:, None, :, :]  # (B,i,j,nh)
    y = torch.einsum("bijh,bjhd->bihd", W, xh)
    # inter-chunk: y[i] += C_i . state * exp(la_i)
    y = y + torch.einsum("bis,bhds,bih->bihd", Ck, state, torch.exp(la))
    # S' = exp(la_end) S + sum_j exp(la_end - la_j) dt_j B_j x_j^T
    wj = torch.exp(la[:, -1:, :] - la) * dt  # (B,Q,nh)
    new_state = state * torch.exp(la[:, -1])[:, :, None, None] \
        + torch.einsum("bjh,bjhd,bjs->bhds", wj, xh, Bk)
    return y, new_state


def _ssd_chunk_sharded(xh, Bk, Ck, dt, a_log, state):
    """:func:`_ssd_chunk` over DTensors: each device runs its shards of the
    batch and the heads, as the active rule table lays them out (the
    einsums keep batch and heads apart); B and C, shared by every head,
    are split over the batch only."""
    B, Q, nh, _ = xh.shape
    hp = layout("batch", "seq", "ssm_heads", shape=(B, Q, nh))
    bp = layout("batch", shape=(B,))
    sp = layout("batch", "ssm_heads", shape=(B, nh))
    return on_shards(_ssd_chunk, xh.device_mesh,
                     (xh, Bk, Ck, dt, a_log, state),
                     (hp, bp, bp, hp, hp, sp), (hp, sp))


def forward(params, x, cfg, *, state=None, chunk: int = 128):
    """x: (B, S, d).  Returns (out, Mamba2State).  A sequence longer than
    ``chunk`` must be a whole number of chunks, as in the reference."""
    Bsz, S, _ = x.shape
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    dt_ = x.dtype

    proj = x @ params["in_proj"]
    z, xbc, dt = _split(cfg, proj)
    xbc, new_conv = _conv(cfg, xbc, params["conv_w"], params["conv_b"],
                          None if state is None else state.conv)
    di = cfg.d_inner
    xc = xbc[..., :di]
    Bk = xbc[..., di:di + ds].float()
    Ck = xbc[..., di + ds:].float()
    dt = F.softplus(dt.float() + params["dt_bias"].float())  # (B,S,nh)
    A = -torch.exp(params["A_log"].float())  # (nh,)
    a_log = A * dt  # (B,S,nh)
    xh = xc.reshape(Bsz, S, nh, hd).float()

    s0 = state.ssd if state is not None else torch.zeros(
        (Bsz, nh, hd, ds), dtype=torch.float32, device=x.device)

    step = _ssd_chunk_sharded if is_dtensor(xh) else _ssd_chunk
    if S <= chunk:
        y, s_new = step(xh, Bk, Ck, dt, a_log, s0)
    else:
        if S % chunk:
            raise ValueError(f"sequence length {S} is not a multiple of "
                             f"the SSD chunk {chunk}")
        ys, s_new = [], s0
        for lo in range(0, S, chunk):
            sl = slice(lo, lo + chunk)
            y_c, s_new = step(xh[:, sl], Bk[:, sl], Ck[:, sl], dt[:, sl],
                              a_log[:, sl], s_new)
            ys.append(y_c)
        y = torch.cat(ys, dim=1)

    y = y + params["D"].float()[:, None] * xh
    y = y.reshape(Bsz, S, di).to(dt_)
    y = y * F.silu(z)
    y = rms_norm(y, params["norm_w"], cfg.norm_eps)
    return y @ params["out_proj"], Mamba2State(ssd=s_new, conv=new_conv)


def decode_step(params, x, cfg, state):
    """x: (B, 1, d) single token.  O(1) sequential recurrence."""
    return forward(params, x, cfg, state=state, chunk=1)


def init_state(cfg, batch, dtype=torch.float32, device="cuda"):
    nh, hd, ds = cfg.ssm_heads, cfg.ssm_head_dim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * ds
    return Mamba2State(
        ssd=torch.zeros((batch, nh, hd, ds), dtype=torch.float32,
                        device=device),
        conv=torch.zeros((batch, cfg.conv_kernel - 1, conv_dim),
                         dtype=dtype, device=device))
