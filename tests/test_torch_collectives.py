"""The port's compressed collectives (``distributed/collectives.py``) against
the reference's pure functions on the CPU: the quantizers and the top-k
sparsifier on seeded numpy inputs, and the reductions over a 2-rank
``gloo`` group spawned here, each rank's result held to the reference's
functions applied per rank."""

import multiprocessing as mp

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.distributed import collectives as jcol
from repro_torch.distributed import collectives as col
from torch_dist import collective_rank, seeded

SHAPES = [(64,), (16, 33), (4, 8, 5)]


@pytest.mark.parametrize("shape", SHAPES)
def test_quantize_int8_matches_reference_exactly(shape):
    x = seeded(shape, 0)
    q, scale = col.quantize_int8(torch.from_numpy(x))
    jq, jscale = jcol.quantize_int8(jnp.asarray(x))
    assert q.dtype == torch.int8
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert scale.item() == float(jscale)
    np.testing.assert_array_equal(
        col.dequantize_int8(q, scale).numpy(),
        np.asarray(jcol.dequantize_int8(jq, jscale)))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("frac", [0.01, 0.1, 0.5])
def test_topk_sparsify_matches_reference(shape, frac):
    x = seeded(shape, 1)
    sparse, mask = col.topk_sparsify(torch.from_numpy(x), frac)
    jsparse, jmask = jcol.topk_sparsify(jnp.asarray(x), frac)
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
    np.testing.assert_array_equal(sparse.numpy(), np.asarray(jsparse))
    # the same threshold: the k-th largest magnitude
    k = max(1, int(x.size * frac))
    assert int(mask.sum()) >= k
    assert np.abs(x)[mask.numpy()].min() == np.sort(np.abs(x).ravel())[-k]


@pytest.mark.parametrize("kind", ["int8", "topk"])
def test_compressed_psum_over_two_ranks(tmp_path, kind):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path / "store")
    procs = [ctx.Process(target=collective_rank, args=(r, store, kind, out))
             for r in range(2)]
    for p in procs:
        p.start()
    got = dict((r, (red, new)) for r, red, new in
               (out.get(timeout=120) for _ in procs))
    for p in procs:
        p.join(timeout=60)
        assert not p.is_alive() and p.exitcode == 0
    parts, residuals = [], []
    for r in range(2):
        x = jnp.asarray(seeded((6, 7), 10 + r)
                        + seeded((6, 7), 20 + r) * 0.01)
        if kind == "int8":
            q, scale = jcol.quantize_int8(x)
            part = jcol.dequantize_int8(q, scale)
        else:
            part, _ = jcol.topk_sparsify(x, 0.2)
        parts.append(np.asarray(part))
        residuals.append(np.asarray(x - part))
    want = parts[0] + parts[1]
    for r in range(2):
        red, new = got[r]
        np.testing.assert_allclose(red, want, rtol=1e-6, atol=1e-6)
        np.testing.assert_array_equal(new, residuals[r])
