"""The ops the port's models run over shards (``distributed/sharding.py``'s
``on_shards``, ``row_gather`` and pointwise strategies, as the dry-run's
cells lay them out) against the plain ops on the full tensors, on a
spawned 4-rank ``gloo`` group over a (2, 2) ``data, model`` mesh: the
attention core with batch and kv heads, or the cache sequence, split, and
with query heads that divide neither the model dim nor whole groups
(padded, on a (1, 4) mesh; uneven groups), forward and gradients; the
vocab-sharded embedding and its gradient; the MoE with the batch on both
mesh dims, and under the training table in each gather layout (values,
the tokens' and a weight's gradients); ``row_gather`` in every layout of
a token table and an expert grid (split or partial sums), forward and
gradient; the last-token gather; xLSTM's blocks and logsigmoid; Mamba2;
the prefix concatenation.  One spawn for all of them (each rank pays
torch's import)."""

import multiprocessing as mp

import numpy as np
import pytest

from torch_dist import sharded_ops_rank

CASES = ["attention kv heads", "attention cache seq",
         "attention query heads", "embedding",
         "embedding grad", "moe out", "moe aux", "moe z", "moe grad",
         *(f"moe {plan} [{how}] {what}"
           for plan in ("capacity", "stationary")
           for how in ("local", "gather")
           for what in ("out", "x grad", "w_gate grad")),
         *(f"row_gather {name} {g} {what}"
           for name, layouts in (("tokens", [(), (0,), (1,), (0, 1)]),
                                 ("grid", [(), (0,), (1,), (0, 1)]),
                                 ("partial grid", [(), (0,)]),
                                 ("split d grid", [(), (0,)]))
           for g in layouts for what in ("out", "grad")),
         *(f"attention {name} {what}"
           for name in ("padded", "uneven groups")
           for what in ("out", "q grad", "k grad", "v grad")),
         "last rows", "logsigmoid", "logsigmoid grad", "mlstm out",
         "mlstm state 0", "mlstm state 1", "slstm out", "slstm state 0",
         "slstm state 1", "slstm state 2", "slstm state 3", "mamba2 out",
         "mamba2 state 0", "mamba2 state 1", "prefix concat"]


@pytest.fixture(scope="module")
def results(tmp_path_factory):
    ctx = mp.get_context("spawn")
    out = ctx.Queue()
    store = str(tmp_path_factory.mktemp("gloo") / "store")
    procs = [ctx.Process(target=sharded_ops_rank, args=(r, store, out))
             for r in range(4)]
    for p in procs:
        p.start()
    got = out.get(timeout=300)
    for p in procs:
        p.join(timeout=120)
        assert not p.is_alive() and p.exitcode == 0
    return got


@pytest.mark.parametrize("case", CASES)
def test_sharded_op_equals_the_plain_op(results, case):
    """float32, within 1e-5 of the plain result's largest magnitude."""
    sharded, plain = results[case]
    assert sharded.shape == plain.shape
    scale = max(float(np.abs(plain).max()), 1e-30)
    assert float(np.abs(sharded - plain).max()) <= 1e-5 * scale, case


def test_every_case_ran(results):
    assert sorted(results) == sorted(CASES)
