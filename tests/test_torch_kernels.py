"""The port's kernel modules on the CPU: the plain versions behind
``fused_paged_verify``/``fused_paged_decode`` against the JAX Pallas kernels
(interpret mode, as tests/test_fused.py runs them) and against the JAX
oracles of ``repro.kernels.ref``, on the same numpy inputs; plus
quantization parity.  float32 throughout, atol = rtol = 1e-5."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import quant as jquant
from repro.kernels import ref as jref
from repro.kernels.fused_decode import fused_paged_decode as j_decode
from repro.kernels.fused_verify import fused_paged_verify as j_verify
from repro_torch.kernels import build, quant
from repro_torch.kernels.fused_decode import fused_paged_decode
from repro_torch.kernels.fused_verify import fused_paged_verify

TOL = dict(atol=1e-5, rtol=1e-5)
QDTYPES = {"int8": (jnp.int8, torch.int8),
           "fp8": (jnp.float8_e4m3fn, torch.float8_e4m3fn)}


def to_torch(a):
    """numpy (incl. ml_dtypes float8) -> torch on the CPU, bit-exact."""
    a = np.asarray(a)
    if a.dtype == np.dtype(jnp.float8_e4m3fn):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    return torch.from_numpy(a.copy())


def quantize_pools(kp, vp, kv):
    """Quantize float pools with the JAX quantizer (numpy out)."""
    if kv == "f32":
        return kp, vp, None, None
    qdt = QDTYPES[kv][0]
    kq, ks = jquant.quantize(jnp.asarray(kp), qdt)
    vq, vs = jquant.quantize(jnp.asarray(vp), qdt)
    return (np.asarray(kq), np.asarray(vq), np.asarray(ks), np.asarray(vs))


def verify_case(seed, lens, gamma, bs, H, Kh, D, kv="f32", tree=False,
                pad_queries=2, pad_entries=2):
    """Packed-verify inputs over a fragmented pool.  Tree cases give every
    request a second branch whose private tail block carries node tags
    (dead straddle copies -2, tree nodes n >= 0) and poisoned dead slots."""
    rng = np.random.default_rng(seed)
    blocks = []               # (owner, node row, seg row, pos row)
    q_seg, q_pos, q_anc = [], [], []
    for i, L in enumerate(lens):
        for b0 in range(0, L + gamma + 1, bs):
            pos = b0 + np.arange(bs)
            seg = np.where(pos < L + gamma + 1, 0, -1).astype(np.int32)
            node = np.full(bs, -1, np.int32)
            if tree:
                node = np.where(pos >= L, np.minimum(pos - L, 31), -1)
            blocks.append((i, node.astype(np.int32), seg,
                           np.where(seg >= 0, pos, -1).astype(np.int32)))
        ks = [gamma, 1] if tree else [gamma]
        off = 0
        for j, k in enumerate(ks):
            if j:      # branch tail: a private copy of the straddle block
                b0 = (L // bs) * bs
                for s0 in range(b0, L + k + 1, bs):
                    pos = s0 + np.arange(bs)
                    node = np.where(pos < L, -2,
                                    np.where(pos <= L + k, off + pos - L, -2))
                    seg = np.where(pos <= L + k, 0, -1).astype(np.int32)
                    blocks.append((i, node.astype(np.int32), seg,
                                   np.where(seg >= 0, pos, -1)
                                   .astype(np.int32)))
            for d in range(k + 1):
                q_seg.append(i)
                q_pos.append(L + d)
                q_anc.append(((1 << (d + 1)) - 1) << off if tree else -1)
            off += k + 1
    q_seg += [-1] * pad_queries
    q_pos += [-1] * pad_queries
    q_anc += [0] * pad_queries
    nb = len(blocks) + 3
    perm = rng.permutation(nb)
    pool_seg = np.full((nb, bs), -1, np.int32)
    pool_pos = np.full((nb, bs), -1, np.int32)
    kp = rng.normal(size=(nb, bs, Kh, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Kh, D)).astype(np.float32)
    ids, owner, node_rows = [], [], []
    for m, (own, node, seg, pos) in enumerate(blocks):
        pb = int(perm[m])
        pool_seg[pb], pool_pos[pb] = seg, pos
        kp[pb, node == -2] = 1e3      # dead slots must not leak
        vp[pb, node == -2] = -1e3
        ids.append(pb)
        owner.append(own)
        node_rows.append(node)
    ids += [0] * pad_entries
    owner += [-1] * pad_entries
    node_rows += [np.full(bs, -1, np.int32)] * pad_entries
    kq, vq, ksc, vsc = quantize_pools(kp, vp, kv)
    q = rng.normal(size=(len(q_seg), H, D)).astype(np.float32)
    i32 = lambda x: np.asarray(x, np.int32)  # noqa: E731
    return dict(q=q, k_pool=kq, v_pool=vq, pool_seg=pool_seg,
                pool_pos=pool_pos, q_seg=i32(q_seg), q_pos=i32(q_pos),
                block_ids=i32(ids), block_owner=i32(owner),
                q_anc=i32(q_anc) if tree else None,
                block_node=i32(node_rows) if tree else None,
                k_scale=ksc, v_scale=vsc)


def decode_case(seed, lens, T, bs, NB, H, Kh, D, kv="f32"):
    """Per-row decode inputs: prefix-allocated tables (a row with length 0
    is idle: no blocks), a few invalidated slots, bucket-padding queries
    (seg -1) after each row's real ones."""
    rng = np.random.default_rng(seed)
    B = len(lens)
    need = [(-(-(L + T) // bs)) if L else 0 for L in lens]
    nb = sum(need) + 2
    perm = list(rng.permutation(nb))
    bt = np.full((B, NB), -1, np.int32)
    pool_seg = np.full((nb, bs), -1, np.int32)
    pool_pos = np.full((nb, bs), -1, np.int32)
    for b, L in enumerate(lens):
        for k in range(need[b]):
            pb = int(perm.pop())
            bt[b, k] = pb
            pos = k * bs + np.arange(bs)
            live = pos < L + T
            pool_seg[pb] = np.where(live, 0, -1)
            pool_pos[pb] = np.where(live, pos, -1)
    pool_seg[rng.random((nb, bs)) < 0.1] = -1           # rolled-back slots
    q_pos = np.asarray([[L + t for t in range(T)] for L in lens], np.int32)
    q_seg = np.zeros((B, T), np.int32)
    q_seg[:, T - 1:] = -1 if T > 1 else 0                # padding queries
    kp = rng.normal(size=(nb, bs, Kh, D)).astype(np.float32)
    vp = rng.normal(size=(nb, bs, Kh, D)).astype(np.float32)
    kq, vq, ksc, vsc = quantize_pools(kp, vp, kv)
    q = rng.normal(size=(B, T, H, D)).astype(np.float32)
    return dict(q=q, k_pool=kq, v_pool=vq, pool_seg=pool_seg,
                pool_pos=pool_pos, q_seg=q_seg, q_pos=q_pos,
                block_tables=bt, k_scale=ksc, v_scale=vsc)


def _jax(args):
    return {k: None if v is None else jnp.asarray(v) for k, v in args.items()}


def _torch(args):
    return {k: None if v is None else to_torch(v) for k, v in args.items()}


VERIFY_CASES = {
    "linear-gqa": dict(seed=0, lens=[37, 5, 61], gamma=4, bs=8, H=4, Kh=2,
                       D=16),
    "tree-gqa": dict(seed=1, lens=[21, 9], gamma=3, bs=8, H=4, Kh=2, D=16,
                     tree=True),
    "int8-linear": dict(seed=2, lens=[30, 17], gamma=4, bs=16, H=4, Kh=4,
                        D=16, kv="int8"),
    "fp8-tree": dict(seed=3, lens=[13, 40], gamma=2, bs=8, H=4, Kh=1, D=16,
                     kv="fp8", tree=True),
}


@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_fused_verify_plain_matches_jax(name):
    args = verify_case(**VERIFY_CASES[name])
    want_kernel = np.asarray(j_verify(**_jax(args), interpret=True))
    want_ref = np.asarray(jref.paged_verify_ref(**_jax(args)))
    build.LAUNCHES.clear()
    got = fused_paged_verify(**_torch(args)).numpy()
    assert not build.LAUNCHES, "the CPU path launches no kernel"
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    pad = args["q_seg"] < 0
    assert np.all(got[pad] == 0), "padding queries give zeros"


DECODE_CASES = {
    "linear-gqa-idle": dict(seed=4, lens=[29, 0, 50], T=3, bs=8, NB=8, H=4,
                            Kh=2, D=16),
    "draft-t1": dict(seed=5, lens=[12, 33], T=1, bs=16, NB=4, H=4, Kh=4,
                     D=16),
    "int8-idle": dict(seed=6, lens=[0, 40], T=5, bs=8, NB=8, H=4, Kh=2,
                      D=16, kv="int8"),
    "fp8": dict(seed=7, lens=[18, 7], T=2, bs=8, NB=4, H=4, Kh=1, D=16,
                kv="fp8"),
}


@pytest.mark.parametrize("name", sorted(DECODE_CASES))
def test_fused_decode_plain_matches_jax(name):
    args = decode_case(**DECODE_CASES[name])
    want_kernel = np.asarray(j_decode(**_jax(args), interpret=True))
    want_ref = np.asarray(jref.paged_seq_decode_ref(**_jax(args)))
    build.LAUNCHES.clear()
    got = fused_paged_decode(**_torch(args)).numpy()
    assert not build.LAUNCHES, "the CPU path launches no kernel"
    np.testing.assert_allclose(got, want_kernel, **TOL)
    np.testing.assert_allclose(got, want_ref, **TOL)
    idle = (args["block_tables"] < 0).all(1)
    assert np.all(got[idle] == 0), "a row with no blocks gives zeros"


@pytest.mark.parametrize("kv", ["int8", "fp8"])
def test_quant_parity(kv):
    rng = np.random.default_rng(8)
    x = rng.normal(size=(6, 4, 3, 16)).astype(np.float32) * 3.0
    x[0, 0, 0] = 0.0                       # all-zero row -> scale 0
    jq, js = jquant.quantize(jnp.asarray(x), QDTYPES[kv][0])
    tq, ts = quant.quantize(torch.from_numpy(x), QDTYPES[kv][1])
    assert tq.dtype == QDTYPES[kv][1]
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert ts[0, 0, 0] == 0 and torch.all(tq[0, 0, 0].float() == 0)
    np.testing.assert_array_equal(
        tq.view(torch.uint8).numpy() if kv == "fp8" else tq.numpy(),
        np.asarray(jq).view(np.uint8) if kv == "fp8" else np.asarray(jq))
    np.testing.assert_array_equal(
        quant.dequantize(tq, ts).numpy(),
        np.asarray(jquant.dequantize(jq, js)))


def test_int8_rounds_half_to_even():
    x = torch.tensor([[0.5, 1.5, 2.5, -0.5, -2.5, 127.0]])
    q, s = quant.quantize(x, torch.int8)
    assert float(s[0]) == 1.0
    assert q.tolist() == [[0, 2, 2, 0, -2, 127]]
