"""The trained SSM zoo and the serving example of the port
(``examples/train_distill_ssm_torch.py``, ``examples/serve_spin_torch.py``)
on the CPU: the example's recipe trains the 68M and the LLM specs with the
reference's per-step losses (``benchmarks/common.py``'s recipe, run here
step by step from the same bridged init), its cache restores what it
saved, and the serving example serves to the end."""

import math
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
sys.path.insert(0, ROOT)
sys.path.insert(0, os.path.join(ROOT, "examples"))

from benchmarks import common as jzoo  # noqa: E402
from repro.data.pipeline import TokenStream as JTokenStream  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.optim import AdamW as JAdamW  # noqa: E402
from repro.optim import cosine_schedule as jcosine  # noqa: E402
from repro_torch.models import params as pp  # noqa: E402

import serve_spin_torch  # noqa: E402
import train_distill_ssm_torch as zoo  # noqa: E402

STEPS = 5


def _unit_attention(jcfg):
    """The q/k projections rescaled to fan_in = d_model (chip_smoke's
    ``unit_attention``): the reference's initializer takes fan_in = the
    head count, so at the LLM spec (d 128, 4 heads) attention logits have
    std about d / H = 32, a near-hard-max under which the two packages'
    float32 gradients already differ by 2e-4 (relative) at step 0 and
    Adam's normalized steps carry that into the losses (4e-3 by step 5);
    at unit scale the gradients agree within 1e-6."""
    scale = math.sqrt(jcfg.n_heads / jcfg.d_model)

    def one(path, x):
        name = jax.tree_util.keystr(path)
        return x * scale if name.endswith(("['wq']", "['wk']")) else x
    return lambda params: jax.tree_util.tree_map_with_path(one, params)


def _reference_losses(jcfg, steps, seed, n_steps, init_map=None):
    """``benchmarks.common._train``'s loop, its first ``n_steps`` steps,
    from the initializer at ``seed`` (mapped by ``init_map``): (the init,
    each step's loss)."""
    n = jcfg.params_count()
    lr = 1e-2 if n < 3e5 else 5e-3
    total = int(steps * (1.0 + min(1.0, n / 1.5e6)))
    stream = JTokenStream(seed=11, batch=16, seq_len=64, vocab=jzoo.VOCAB)
    opt = JAdamW(lr=jcosine(lr, 30, total), weight_decay=0.01)
    params = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    if init_map is not None:
        params = init_map(params)
    init = jax.tree.map(np.asarray, params)
    state = opt.init(params)
    step_fn = jax.jit(JT.make_train_step(jcfg, opt, JT.Opts(remat="none")))
    losses = []
    for s in range(n_steps):
        toks, labels = stream.batch_at(s)
        params, state, metrics = step_fn(
            params, state, {"tokens": jnp.asarray(toks),
                            "labels": jnp.asarray(labels)})
        losses.append(float(metrics["loss"]))
    return init, losses


@pytest.mark.parametrize("which,n_steps,unit", [
    ("ssm 68m", STEPS, False), ("llm", 1, False), ("llm", STEPS, True)],
    ids=["ssm-68m", "llm-first-step", "llm-unit-attention"])
def test_recipe_losses_match_the_reference(which, n_steps, unit):
    """The example's ``train`` from the reference's init, bridged, takes
    the reference's steps: per-step losses within rtol 1e-4 (float32).
    The LLM spec over several steps at unit-scale attention (see
    :func:`_unit_attention`), its first step at the recipe's own init."""
    if which == "llm":
        spec, jspec, steps, seed = (zoo.LLM_SPEC, jzoo.LLM_SPEC, 375, 0)
    else:
        spec, jspec, steps, seed = (zoo.SSM_SPECS[0], jzoo.SSM_SPECS[0],
                                    250, 1)
    cfg, jcfg = zoo._cfg(*spec), jzoo._cfg(*jspec)
    assert cfg.params_count() == jcfg.params_count()
    assert zoo.recipe(cfg, steps) == (
        1e-2 if jcfg.params_count() < 3e5 else 5e-3,
        int(steps * (1.0 + min(1.0, jcfg.params_count() / 1.5e6))))
    init, want = _reference_losses(jcfg, steps, seed, n_steps,
                                   _unit_attention(jcfg) if unit else None)
    params = pp.from_jax_numpy(init, cfg, "cpu", torch.float32)
    _, got = zoo.train(cfg, steps, seed, device="cpu", params=params,
                       max_steps=n_steps, log=lambda *a: None)
    np.testing.assert_allclose(got, want, rtol=1e-4)


def test_zoo_cache_restores_what_it_saved(tmp_path):
    lines = []
    llm, ssms = zoo.build_zoo(steps=1, force=True, device="cpu",
                              zoo_dir=str(tmp_path), log=lines.append)
    assert lines[0].startswith("[zoo] training LLM + 5 heterogeneous SSMs")
    back, back_ssms = zoo.build_zoo(steps=1, device="cpu",
                                    zoo_dir=str(tmp_path), log=lines.append)
    assert lines[-1] == "[zoo] restored cached models"
    assert [b.cfg for b in back_ssms] == [b.cfg for b in ssms]
    for a, b in zip([llm] + ssms, [back] + back_ssms):
        for x, y in zip(pp.tensor_leaves(a.params),
                        pp.tensor_leaves(b.params)):
            assert x.dtype == y.dtype and torch.equal(x, y)


def test_serve_example_serves_to_the_end(capsys):
    stats = serve_spin_torch.main(["--device", "cpu", "--requests", "3",
                                   "--fused-kernels", "on"])
    assert stats["scheduler"]["finished"] == 3
    assert stats["accepted_tokens"] > 0
    assert '"finished": 3' in capsys.readouterr().out
