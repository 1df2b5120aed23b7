"""The port's training path against the JAX reference, on the CPU: the
loss and its gradients (``transformer.loss_fn``), AdamW steps, the LR
schedules, activation checkpointing (``Opts.remat``), the checkpoint
manager (the reference's on-disk format, a JAX-written checkpoint restored
into the port's tree) and the launcher's crash-restart loop.

Parameters are bridged from the JAX tree (``params.from_jax_numpy``), and
the inputs are the same numpy arrays.  Tolerances (float32, summation
orders differ between the frameworks): the loss at rtol 1e-5; each
gradient leaf at atol 1e-4 x max(1, max|g|) of the reference's; AdamW
params and moments at rtol 1e-5, atol 1e-6; schedules at rtol 1e-6 (the
reference computes them in float32)."""

import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.optim import AdamW as JAdamW
from repro.optim import cosine_schedule as j_cosine
from repro.optim import linear_warmup as j_warmup
from repro_torch.checkpoint import CheckpointManager
from repro_torch.distributed import sharding
from repro_torch.launch import mesh
from repro_torch.launch.train import main as train_main
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.params import (from_jax_numpy, map_tensors,
                                       tensor_leaves)
from repro_torch.optim import (AdamW, AdamWState, cosine_schedule,
                               linear_warmup)
from torch_dist import gloo_world
from torch_fleet import one_thread  # noqa: F401

CPU = torch.device("cpu")
# vocab 300 pads to 512: the loss masks the padding
CASES = {
    "llama-68m": dict(vocab_size=300),
    "mixtral-8x22b": dict(vocab_size=300),       # MoE: aux and z count
    "qwen2-0.5b": dict(vocab_size=300),          # QKV biases, tied embed
    # a body unit and an attention tail: the tail is outside the
    # reference's scan
    "llama-7b": dict(vocab_size=300, n_layers=3, tail=("attn",)),
}


def bridged(arch, seed, **overrides):
    jcfg = jregistry.reduced_for(arch, **overrides)
    jparams = JT.init_params(jcfg, jax.random.PRNGKey(seed))
    cfg = ModelConfig(**dataclasses.asdict(jcfg))
    return jcfg, jparams, cfg


def to_port(tree, cfg):
    return from_jax_numpy(jax.tree.map(np.asarray, tree), cfg, CPU,
                          torch.float32)


def perturbed(jparams, seed):
    """The reference's tree with every leaf drawn at random (norm weights
    and biases nonzero, so weight decay shows on every leaf)."""
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: jnp.asarray(
        0.5 * rng.standard_normal(a.shape).astype(np.float32)), jparams)


def batch(cfg, rng, B=2, S=16):
    toks = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.8).astype(np.float32)
    return dict(tokens=toks, labels=labels, mask=mask)


def _close_tree(got, want, rtol, atol):
    for a, b in zip(tensor_leaves(got), tensor_leaves(want)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("arch", list(CASES))
def test_loss_and_grads_match(arch):
    jcfg, jparams, cfg = bridged(arch, 0, **CASES[arch])
    jparams = perturbed(jparams, 1)
    b = batch(cfg, np.random.default_rng(2))
    grad_fn = jax.jit(jax.value_and_grad(
        lambda p, bb: JT.loss_fn(p, jcfg, bb), has_aux=True))
    (jtotal, jm), jgrads = grad_fn(jparams,
                                   {k: jnp.asarray(v) for k, v in b.items()})

    params = to_port(jparams, cfg)
    flat = tensor_leaves(params)
    for p in flat:
        p.requires_grad_(True)
    total, m = T.loss_fn(params, cfg, {k: torch.from_numpy(v)
                                       for k, v in b.items()})
    grads = torch.autograd.grad(total, flat, allow_unused=True)

    np.testing.assert_allclose(total.item(), float(jtotal), rtol=1e-5)
    np.testing.assert_allclose(m["loss"].item(), float(jm["loss"]),
                               rtol=1e-5)
    if cfg.n_experts:
        assert float(jm["moe_aux"]) > 0
        for k in ("moe_aux", "moe_z"):
            np.testing.assert_allclose(m[k].item(), float(jm[k]), rtol=1e-5)
    want = tensor_leaves(to_port(jgrads, cfg))
    assert len(want) == len(grads)
    for g, w in zip(grads, want):
        w = w.numpy()
        g = np.zeros_like(w) if g is None else g.numpy()
        np.testing.assert_allclose(
            g, w, rtol=0, atol=1e-4 * max(1.0, float(np.abs(w).max())))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_matches_none(remat):
    """Checkpointing recomputes; the loss and gradients stay those of the
    plain backward."""
    cfg = ModelConfig(**dataclasses.asdict(
        jregistry.reduced_for("qwen2-0.5b", vocab_size=300)))
    b = {k: torch.from_numpy(v)
         for k, v in batch(cfg, np.random.default_rng(3)).items()}
    out = {}
    for mode in ("none", remat):
        params = T.init_params(cfg, 4, device=CPU)
        flat = tensor_leaves(params)
        for p in flat:
            p.requires_grad_(True)
        total, _ = T.loss_fn(params, cfg, b, T.Opts(remat=mode))
        out[mode] = (total, torch.autograd.grad(total, flat,
                                                allow_unused=True))
    (t0, g0), (t1, g1) = out["none"], out[remat]
    np.testing.assert_allclose(t1.item(), t0.item(), rtol=1e-6)
    for a, c in zip(g1, g0):
        if c is not None:
            np.testing.assert_allclose(a.numpy(), c.numpy(), rtol=1e-5,
                                       atol=1e-6)


def test_remat_rejects_unknown():
    with pytest.raises(ValueError, match="remat"):
        T.Opts(remat="some")


def test_adamw_three_steps_match():
    """Three steps on the same random gradients: params and both moments.
    zamba2's tree has a scanned body, a Mamba2 tail and shared attention,
    so the reference's decay rule (every body leaf, the rest by rank) is
    exercised leaf by leaf."""
    jcfg, jparams, cfg = bridged("zamba2-1.2b", 0)
    jparams = perturbed(jparams, 5)
    params = to_port(jparams, cfg)
    mask = T.decay_mask(params, cfg)
    assert mask["layers"][0]["ln"] is True           # scanned: decayed
    assert mask["layers"][-1]["ln"] is False         # tail: by rank
    assert mask["final_norm"] is False
    assert mask["shared_attn"]["wq"] is True

    lr = cosine_schedule(1e-2, 2, 10)
    jopt, opt = JAdamW(lr=j_cosine(1e-2, 2, 10)), AdamW(lr=lr)
    jstate, state = jopt.init(jparams), opt.init(params)
    rng = np.random.default_rng(6)
    upd = jax.jit(jopt.update)
    for _ in range(3):
        jgrads = jax.tree.map(lambda a: jnp.asarray(
            rng.standard_normal(a.shape).astype(np.float32)), jparams)
        jparams, jstate = upd(jparams, jgrads, jstate)
        params, state = opt.update(params, to_port(jgrads, cfg), state,
                                   decay=mask)
    assert int(state.step) == int(jstate.step) == 3
    _close_tree(params, to_port(jparams, cfg), 1e-5, 1e-6)
    _close_tree(state.mu, to_port(jstate.mu, cfg), 1e-5, 1e-6)
    _close_tree(state.nu, to_port(jstate.nu, cfg), 1e-5, 1e-6)


@pytest.mark.parametrize("name", ["cosine", "warmup"])
def test_schedules_match(name):
    if name == "cosine":
        mine, ref = cosine_schedule(3e-4, 20, 100), j_cosine(3e-4, 20, 100)
    else:
        mine, ref = linear_warmup(3e-4, 20), j_warmup(3e-4, 20)
    for step in (0, 1, 5, 19, 20, 21, 50, 99, 100, 150):
        np.testing.assert_allclose(mine(step), float(ref(jnp.int32(step))),
                                   rtol=1e-6)


# ------------------------------------------------------------ checkpoint --

def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g),
            "h": torch.randn(5, generator=g).to(torch.bfloat16),
            "layers": [{"b": torch.randn(2, generator=g)},
                       {"b": torch.randn(2, generator=g)}],
            "opt": AdamWState(step=torch.tensor(7, dtype=torch.int32),
                              mu={"x": torch.ones(2)},
                              nu={"x": torch.zeros(2)})}


def _flat(tree, prefix=""):
    """{path: tensor} of a dict/list/tuple tree."""
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, (list, tuple)):
        items = enumerate(tree)
    else:
        return {prefix: tree}
    return {k: v for key, sub in items
            for k, v in _flat(sub, f"{prefix}/{key}").items()}


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for key, x in fa.items():
        assert x.dtype == fb[key].dtype, key
        assert torch.equal(x, fb[key]), key


def test_checkpoint_round_trip_with_bf16(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(3, tree)
    zeros = {k: v for k, v in tree.items()}
    out, step = mgr.restore(zeros)
    assert step == 3
    _same(out, tree)
    assert isinstance(out["opt"], AdamWState)
    # the reference's layout on disk: bf16 as its uint16 bits
    arr = np.load(tmp_path / "step_3" / "h.npy")
    assert arr.dtype == np.uint16
    assert (tmp_path / "step_3" / "layers__1__b.npy").exists()
    with pytest.raises(TypeError):
        mgr.restore(tree, shardings=object())     # not (mesh, placements)


def test_checkpoint_restores_onto_a_mesh(tmp_path):
    """``restore(shardings=(mesh, placements tree))`` on a world-1 mesh
    places every leaf as a DTensor whose values equal the unsharded
    restore's."""
    from torch.distributed.tensor import DTensor
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    mgr.save(4, tree)
    plain, _ = mgr.restore(tree)
    with gloo_world():
        m = mesh.make_local_mesh(device_type="cpu")
        placements = map_tensors(lambda t: sharding.replicated(m), tree)
        out, step = mgr.restore(tree, shardings=(m, placements))
        assert step == 4
        flat = _flat(out)
        assert all(isinstance(x, DTensor) and x.device_mesh == m
                   for x in flat.values())
        _same({k: x.full_tensor() for k, x in flat.items()}, _flat(plain))


def test_checkpoint_atomic_and_gc(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2)
    tree = _tree()
    for s in (1, 2, 3, 4):
        mgr.save(s, tree)
    assert mgr.all_steps() == [3, 4]
    assert mgr.latest_step() == 4
    (tmp_path / "step_9.tmp").mkdir()          # a crash mid-write
    assert mgr.all_steps() == [3, 4]
    (tmp_path / "latest").write_text("9")       # pointer ahead of a crash
    assert mgr.latest_step() == 4


def test_checkpoint_async_save(tmp_path):
    mgr = CheckpointManager(str(tmp_path))
    tree = _tree()
    want = {"w": tree["w"].clone()}
    mgr.save(5, {"w": tree["w"]}, blocking=False)
    tree["w"].add_(1.0)          # the host copy was taken before return
    mgr.wait()
    out, step = mgr.restore({"w": torch.zeros(3, 4)})
    assert step == 5 and torch.equal(out["w"], want["w"])


def test_jax_checkpoint_restores_into_port(tmp_path):
    """(params, AdamW state) written by the JAX package, restored into the
    port's tree through the unit-to-layer mapping: equal to
    ``from_jax_numpy`` of the same trees."""
    jcfg, jparams, cfg = bridged("zamba2-1.2b", 0)
    jparams = perturbed(jparams, 7)
    jopt = JAdamW()
    jstate = jopt.init(jparams)
    jstate = jstate._replace(step=jnp.int32(11), mu=perturbed(jstate.mu, 8))
    JCheckpointManager(str(tmp_path)).save(11, (jparams, jstate))

    opt = AdamW()
    params = T.init_params(cfg, 0, device=CPU)
    (got, state), step = CheckpointManager(str(tmp_path)).restore(
        (params, opt.init(params)), cfg=cfg)
    assert step == 11 and int(state.step) == 11
    _same(got, to_port(jparams, cfg))
    _same(state.mu, to_port(jstate.mu, cfg))
    _same(state.nu, to_port(jstate.nu, cfg))


def test_train_launcher_failure_recovery(tmp_path):
    """Inject a crash; the restart loop resumes from the checkpoint and
    reaches the final loss of an uninterrupted run."""
    argv_common = ["--device", "cpu", "--arch", "llama-68m", "--reduced",
                   "--steps", "40", "--batch", "2", "--seq-len", "32",
                   "--ckpt-every", "10"]
    out_clean = train_main(argv_common + ["--ckpt-dir",
                                          str(tmp_path / "clean")])
    out_crash = train_main(argv_common + [
        "--ckpt-dir", str(tmp_path / "crash"),
        "--simulate-failures", "--fail-at", "25"])
    assert out_crash["resumed_from"] == 20
    assert out_crash["final_loss"] == pytest.approx(
        out_clean["final_loss"], rel=1e-4)
    assert out_crash["losses"] == pytest.approx(out_clean["losses"][20:],
                                                rel=1e-4)
    assert out_clean["losses"][-1] < out_clean["losses"][0]


def test_serving_forwards_take_no_gradients():
    """A training step leaves no leaf taking gradients, so the same params
    serve without autograd: the bundle's entry points build no graph."""
    from repro_torch.core import spec_decode as sd

    cfg = ModelConfig(**dataclasses.asdict(
        jregistry.reduced_for("llama-68m", vocab_size=300)))
    params = T.init_params(cfg, 0, device=CPU)
    opt = AdamW()
    b = {k: torch.from_numpy(v)
         for k, v in batch(cfg, np.random.default_rng(9)).items()}
    params, _, _ = T.make_train_step(cfg, opt)(params, opt.init(params), b)
    assert not any(p.requires_grad for p in tensor_leaves(params))
    llm = sd.Bundle(cfg, params)
    lengths = torch.tensor([8, 8], dtype=torch.int32)
    lg, cache = llm.prefill(b["tokens"][:, :8], lengths, 16)
    lg2, _ = llm.decode(cache, b["tokens"][:, 8:9], lengths)
    assert not lg.requires_grad and not lg2.requires_grad
    assert not any(t.requires_grad for t in cache.values())
