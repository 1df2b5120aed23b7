"""The port's four attention kernels of the dense and unfused paged paths
on the CPU: each wrapper (which runs its plain version for CPU tensors)
against the reference's Pallas kernel in interpret mode, on the same numpy
inputs from a seed.

Tolerances: float32 output at atol = rtol = 1e-5 (two float32 summation
orders); bf16 output at 2^-6 x max(1, max|ref|) absolute (both sides round
a float32 result to bf16, so they may differ by an ulp of the largest
value, 2^-8 to 2^-7 of it)."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels import ops as jops
from repro.kernels import quant as jquant
from repro.kernels.paged_attention import paged_verify_attention as j_pverify
from repro.kernels.verify_attention import verify_attention as j_verify
from repro_torch.kernels import ops

F32_TOL = dict(atol=1e-5, rtol=1e-5)
JDT = {"f32": jnp.float32, "bf16": jnp.bfloat16}
QDT = {"int8": jnp.int8, "fp8": jnp.float8_e4m3fn}


def to_torch(a):
    """numpy / jax array -> torch CPU tensor, bit-exact (incl. bf16, fp8)."""
    a = np.asarray(a)
    if a.dtype == np.dtype(jnp.float8_e4m3fn):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            torch.float8_e4m3fn)
    if a.dtype == np.dtype(jnp.bfloat16):
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16)
    return torch.from_numpy(a.copy())


def both(a, dt="f32"):
    """The same float32 numpy array as (jax, torch) in dtype ``dt``."""
    j = jnp.asarray(a, JDT[dt])
    return j, to_torch(j)


def ints(a):
    a = np.asarray(a, np.int32)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def pools(rng, shape, kv):
    """K and V pools as (jax, torch) pairs, with (jax, torch) scales for
    int8/fp8 (quantized by the reference quantizer)."""
    x = rng.standard_normal((2, *shape)).astype(np.float32)
    if kv in JDT:
        return both(x[0], kv), both(x[1], kv), (None, None), (None, None)
    out = []
    for i in range(2):
        qv, sc = jquant.quantize(jnp.asarray(x[i]), QDT[kv])
        out.append(((qv, to_torch(qv)), (sc, to_torch(sc))))
    (k, ks), (v, vs) = out
    return k, v, ks, vs


def check(got, want):
    """bf16 outputs at the bf16 tolerance, float32 at 1e-5; the port keeps
    the reference's output dtype."""
    bf16 = want.dtype == jnp.bfloat16
    assert got.dtype == (torch.bfloat16 if bf16 else torch.float32)
    got = got.float().numpy()
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if bf16:
        tol = 2.0 ** -6 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got, want, atol=tol, rtol=0)
    else:
        np.testing.assert_allclose(got, want, **F32_TOL)


# ------------------------------------------------------ verify_attention --

def packed_buffer(rng, lens, gamma, n_pad_cells=5):
    """A flat packed KV buffer as the dense layout builds it, but
    interleaved: each request's context cut into fragments, fragments of
    all requests shuffled, padding cells (seg -1, pos -1) scattered in,
    then every request's gamma + 1 new slots.  Queries: gamma + 1 per
    request plus padding queries (seg -1), one of them at pos -1 so that
    it meets padding cells causally."""
    frags = []
    for i, L in enumerate(lens):
        cuts = np.sort(rng.choice(np.arange(1, L), size=min(2, L - 1),
                                  replace=False)) if L > 2 else []
        for lo, hi in zip([0, *cuts], [*cuts, L]):
            frags.append([(i, p) for p in range(lo, hi)])
    frags += [[(-1, -1)] for _ in range(n_pad_cells)]
    rng.shuffle(frags)
    cells = [c for f in frags for c in f]
    cells += [(i, L + d) for i, L in enumerate(lens) for d in range(gamma + 1)]
    kv_seg, kv_pos = map(list, zip(*cells))
    q_seg = [i for i in range(len(lens)) for _ in range(gamma + 1)] + [-1, -1]
    q_pos = [L + d for L in lens for d in range(gamma + 1)] + [-1, 3]
    return kv_seg, kv_pos, q_seg, q_pos


VERIFY_CASES = {
    "f32-gqa": dict(lens=[37, 5, 20], H=4, Kh=2, D=16, dt="f32"),
    "bf16-mha": dict(lens=[11, 30], H=4, Kh=4, D=32, dt="bf16"),
    "f32-mqa": dict(lens=[3, 25, 1, 9], H=4, Kh=1, D=32, dt="f32"),
    "f32-tree": dict(lens=[19, 8], H=4, Kh=2, D=16, dt="f32", tree=True),
    "bf16-tree": dict(lens=[6, 14, 22], H=2, Kh=1, D=32, dt="bf16",
                      tree=True),
}


@pytest.mark.parametrize("name", sorted(VERIFY_CASES))
def test_verify_attention_matches_reference(name):
    c = VERIFY_CASES[name]
    rng = np.random.default_rng(sorted(VERIFY_CASES).index(name))
    kv_seg, kv_pos, q_seg, q_pos = packed_buffer(rng, c["lens"], 4)
    Tq, Tkv = len(q_seg), len(kv_seg)
    jq, tq = both(rng.standard_normal((Tq, c["H"], c["D"])), c["dt"])
    jk, tk = both(rng.standard_normal((Tkv, c["Kh"], c["D"])), c["dt"])
    jv, tv = both(rng.standard_normal((Tkv, c["Kh"], c["D"])), c["dt"])
    tags = [ints(x) for x in (q_seg, q_pos, kv_seg, kv_pos)]
    if c.get("tree"):
        anc = rng.integers(-2**31, 2**31 - 1, Tq)
        node = np.where(rng.random(Tkv) < 0.5,
                        rng.integers(-2, 32, Tkv), -1)
        (ja, ta), (jn, tn) = ints(anc), ints(node)
        want = j_verify(jq, jk, jv, *(j for j, _ in tags), ja, jn, bq=8,
                        bk=16, interpret=True)
        got = ops.verify_attention(tq, tk, tv, *(t for _, t in tags), ta, tn)
    else:
        want = jops.verify_attention(jq, jk, jv, *(j for j, _ in tags), bq=8,
                                     bk=16, interpret=True)
        got = ops.verify_attention(tq, tk, tv, *(t for _, t in tags))
    check(got, want)
    # padding queries (seg -1) give zeros, also the one at pos -1 that
    # meets the padding cells (seg -1, pos -1) causally
    assert not got[-2:].float().abs().any()


# ------------------------------------------------------ decode_attention --

@pytest.mark.parametrize("dt,H,Kh,D", [("f32", 4, 2, 16), ("bf16", 4, 4, 32),
                                       ("f32", 4, 1, 32)])
def test_decode_attention_matches_reference(dt, H, Kh, D):
    rng = np.random.default_rng(H * 10 + Kh)
    B, S = 4, 40                     # S is not a multiple of 32
    lengths = [0, 17, 40, 33]        # a row of length 0 gives zeros
    jq, tq = both(rng.standard_normal((B, H, D)), dt)
    jk, tk = both(rng.standard_normal((B, S, Kh, D)), dt)
    jv, tv = both(rng.standard_normal((B, S, Kh, D)), dt)
    jl, tl = ints(lengths)
    want = jops.decode_attention(jq, jk, jv, jl, bk=8, interpret=True)
    got = ops.decode_attention(tq, tk, tv, tl, bk=8)
    check(got, want)
    assert not got[0].float().abs().any()


def test_decode_attention_rows_over_several_tiles():
    """S = 96 over bk = 16 (six tiles, three of the kernel's 32-slot
    tiles), GQA group 3, rows of unequal lengths ending inside, at and
    past tile edges, one of them empty."""
    rng = np.random.default_rng(31)
    B, S, H, Kh, D = 5, 96, 6, 2, 32
    lengths = [96, 0, 33, 64, 17]
    jq, tq = both(rng.standard_normal((B, H, D)))
    jk, tk = both(rng.standard_normal((B, S, Kh, D)))
    jv, tv = both(rng.standard_normal((B, S, Kh, D)))
    jl, tl = ints(lengths)
    want = jops.decode_attention(jq, jk, jv, jl, bk=16, interpret=True)
    got = ops.decode_attention(tq, tk, tv, tl, bk=16)
    check(got, want)
    assert not got[1].float().abs().any()


def test_decode_attention_rejects_unaligned_bk():
    """An explicit bk must divide S, in the port as in the reference."""
    rng = np.random.default_rng(0)
    jq, tq = both(rng.standard_normal((1, 4, 16)))
    jk, tk = both(rng.standard_normal((1, 40, 2, 16)))
    jl, tl = ints([10])
    with pytest.raises(ValueError, match="multiple of bk"):
        jops.decode_attention(jq, jk, jk, jl, bk=32, interpret=True)
    with pytest.raises(ValueError, match="multiple of bk"):
        ops.decode_attention(tq, tk, tk, tl, bk=32)
    assert ops.decode_attention(tq, tk, tk, tl).shape == (1, 4, 16)


# ------------------------------------------------ paged_decode_attention --

def fragmented_tables(rng, lens, bs, extra_cols=1):
    """Block tables over a shuffled pool, prefix-allocated, with an
    unallocated tail (-1) on every row; a length-0 row owns no block."""
    need = [-(-L // bs) for L in lens]
    N = sum(need) + 3
    perm = list(rng.permutation(N))
    bt = np.full((len(lens), max(need) + extra_cols), -1, np.int32)
    for b, n in enumerate(need):
        for k in range(n):
            bt[b, k] = perm.pop()
    return bt, N


@pytest.mark.parametrize("kv,qdt,H,Kh,D,bs", [
    ("f32", "f32", 4, 2, 16, 8), ("bf16", "bf16", 4, 4, 32, 4),
    ("int8", "f32", 4, 1, 32, 8), ("fp8", "bf16", 2, 2, 16, 4)])
def test_paged_decode_attention_matches_reference(kv, qdt, H, Kh, D, bs):
    rng = np.random.default_rng(bs * 7 + H)
    lens = [13, 0, 24, 5]
    bt, N = fragmented_tables(rng, lens, bs)
    (jk, tk), (jv, tv), (jks, tks), (jvs, tvs) = pools(rng, (N, bs, Kh, D),
                                                       kv)
    jq, tq = both(rng.standard_normal((len(lens), H, D)), qdt)
    (jbt, tbt), (jl, tl) = ints(bt), ints(lens)
    want = jops.paged_decode_attention(jq, jk, jv, jbt, jl, jks, jvs,
                                       interpret=True)
    got = ops.paged_decode_attention(tq, tk, tv, tbt, tl, tks, tvs)
    check(got, want)
    assert not got[1].float().abs().any()


# The geometries of the run-of-tiles kernel: rows whose live prefix ends
# mid-block and mid-tile, block sizes 32 and 64 (a 32-slot tile is half
# a block), three unallocated tail entries, and a hole (-1) inside a live
# prefix, which the reference reads as block 0.  Tolerances as above.
@pytest.mark.parametrize("kv,qdt,H,Kh,D,bs,lens,hole", [
    ("f32", "f32", 4, 2, 16, 32, [45, 0, 64, 97], False),
    ("bf16", "bf16", 6, 1, 32, 64, [100, 1, 63, 0], False),
    ("int8", "bf16", 4, 4, 16, 16, [37, 50, 0, 16], True),
    ("fp8", "f32", 4, 2, 32, 8, [37, 9, 70, 8], True),
    ("f32", "f32", 2, 2, 16, 64, [129, 33], True)])
def test_paged_decode_attention_edge_geometries(kv, qdt, H, Kh, D, bs, lens,
                                                hole):
    rng = np.random.default_rng(bs * 11 + H + len(lens))
    bt, N = fragmented_tables(rng, lens, bs, extra_cols=3)
    if hole:                     # row 0's second block unallocated
        bt[0, 1] = -1
    (jk, tk), (jv, tv), (jks, tks), (jvs, tvs) = pools(rng, (N, bs, Kh, D),
                                                       kv)
    jq, tq = both(rng.standard_normal((len(lens), H, D)), qdt)
    (jbt, tbt), (jl, tl) = ints(bt), ints(lens)
    want = jops.paged_decode_attention(jq, jk, jv, jbt, jl, jks, jvs,
                                       interpret=True)
    got = ops.paged_decode_attention(tq, tk, tv, tbt, tl, tks, tvs)
    check(got, want)
    for b, L in enumerate(lens):
        if L == 0:
            assert not got[b].float().abs().any()


# ------------------------------------------------ paged_verify_attention --

def verify_pool(rng, lens, gamma, bs, tree, shuffle=False, n_entries=None):
    """Live blocks of each request (context + gamma + 1 new slots) over a
    shuffled pool, a few rolled-back slots (seg -1), two trailing padding
    entries (owner -1); tree cases tag the speculative slots with node ids
    in [-2, 31] and give every query a random ancestor mask.  ``shuffle``
    permutes the block list (owners in no order, padding among them);
    ``n_entries`` cuts or pads it to that length."""
    ids, owner, node = [], [], []
    need = [-(-(L + gamma + 1) // bs) for L in lens]
    N = sum(need) + 3
    perm = list(rng.permutation(N))
    pool_seg = np.full((N, bs), -1, np.int32)
    pool_pos = np.full((N, bs), -1, np.int32)
    for r, L in enumerate(lens):
        for k in range(need[r]):
            b = perm.pop()
            pos = k * bs + np.arange(bs)
            live = pos < L + gamma + 1
            pool_seg[b] = np.where(live, 0, -1)
            pool_pos[b] = np.where(live, pos, -1)
            ids.append(b)
            owner.append(r)
            node.append(np.where(pos >= L, rng.integers(-2, 32, bs), -1))
    pool_seg[rng.random((N, bs)) < 0.1] = -1
    ids += [0, 0]
    owner += [-1, -1]
    node += [np.full(bs, -1)] * 2
    if n_entries is not None:
        pad = max(0, n_entries - len(ids))
        ids, owner = (ids + [0] * pad)[:n_entries], \
            (owner + [-1] * pad)[:n_entries]
        node = (node + [np.full(bs, -1)] * pad)[:n_entries]
    if shuffle:
        perm = rng.permutation(len(ids))
        ids, owner = [ids[i] for i in perm], [owner[i] for i in perm]
        node = [node[i] for i in perm]
    q_seg = [r for r in range(len(lens)) for _ in range(gamma + 1)] + [-1]
    q_pos = [L + d for L in lens for d in range(gamma + 1)] + [-1]
    anc = rng.integers(-2**31, 2**31 - 1, len(q_seg))
    tree_args = (ints(anc), ints(np.stack(node))) if tree else None
    return N, [ints(x) for x in (pool_seg, pool_pos, q_seg, q_pos, ids,
                                 owner)], tree_args


# (bs, shuffled block list, entries): the redesigned kernel's edge
# geometries -- owners in no order, a list length that is no multiple of a
# run, block sizes 16 and 32 beside 8; the first five cases keep their ids
BASE = (8, False, None)


@pytest.mark.parametrize("kv,qdt,tree,geometry", [
    pytest.param("bf16", "bf16", False, BASE, id="bf16-bf16-False"),
    pytest.param("f32", "f32", True, BASE, id="f32-f32-True"),
    pytest.param("int8", "f32", False, BASE, id="int8-f32-False"),
    pytest.param("fp8", "bf16", True, BASE, id="fp8-bf16-True"),
    pytest.param("int8", "bf16", True, BASE, id="int8-bf16-True"),
    pytest.param("f32", "f32", True, (8, True, None), id="f32-shuffled"),
    pytest.param("int8", "f32", False, (8, True, 17),
                 id="int8-shuffled-M17"),
    pytest.param("f32", "f32", False, (16, True, None), id="f32-bs16"),
    pytest.param("bf16", "bf16", True, (32, True, None), id="bf16-bs32"),
    pytest.param("fp8", "bf16", True, (16, False, 1), id="fp8-bs16-M1")])
def test_paged_verify_attention_matches_reference(kv, qdt, tree, geometry):
    rng = np.random.default_rng(3 + tree)
    H, Kh, D, gamma = 4, 2, 16, 3
    bs, shuffle, n_entries = geometry
    N, tags, tree_args = verify_pool(rng, [13, 4, 21], gamma, bs, tree,
                                     shuffle, n_entries)
    (jk, tk), (jv, tv), (jks, tks), (jvs, tvs) = pools(rng, (N, bs, Kh, D),
                                                       kv)
    Tq = int(tags[2][1].shape[0])
    jq, tq = both(rng.standard_normal((Tq, H, D)), qdt)
    jt, tt = [j for j, _ in tags], [t for _, t in tags]
    if tree:
        (ja, ta), (jn, tn) = tree_args
        want = j_pverify(jq, jk, jv, *jt, ja, jn, jks, jvs, bq=8,
                         interpret=True)
        got = ops.paged_verify_attention(tq, tk, tv, *tt, tks, tvs, q_anc=ta,
                                         block_node=tn)
    else:
        want = jops.paged_verify_attention(jq, jk, jv, *jt, jks, jvs, bq=8,
                                           interpret=True)
        got = ops.paged_verify_attention(tq, tk, tv, *tt, tks, tvs)
    check(got, want)
    assert not got[-1].float().abs().any()      # the padding query
