"""The plain reference against the port's plain CPU path, the harness's
weight layout against the port's parameter spec, and each real model's
architecture module against what the harness did before models named
their own (the port's config, the layout, the weights)."""

import hashlib
import importlib
import json
from pathlib import Path

import pytest
import torch

from h100bench import weights as W
from h100bench.reference import decoder as ref

HOME = Path(__file__).resolve().parent
CONFIGS = sorted((HOME / "configs").glob("*.json"))
INIT = {"embed": 0.02, "norm": 0.05, "bias": 0.1}


def models(path):
    cfg = json.loads(path.read_text())
    return [cfg["llm"]] + cfg["ssms"]


def all_models():
    return [(p.stem, i, m) for p in CONFIGS for i, m in enumerate(models(p))]


def arch(m):
    return importlib.import_module("h100bench.arch."
                                   + m.get("arch", "decoder"))


def shrunk(m):
    """The model at a tiny width, with its own GQA ratio, bias and tying."""
    G = m["num_attention_heads"] // m["num_key_value_heads"]
    Kh = 2 if m["num_key_value_heads"] > 1 else 1
    return dict(m, num_hidden_layers=2, hidden_size=16 * G * Kh,
                num_attention_heads=G * Kh, num_key_value_heads=Kh,
                head_dim=16, intermediate_size=48, vocab_size=300)


@pytest.mark.parametrize("name,i,m", all_models(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_layout_is_the_ports(name, i, m):
    """Every leaf's path and shape at the published widths (meta)."""
    from repro_torch.models import transformer as T
    cfg = arch(m).port_config(m, "bfloat16")
    spec = T.abstract_params(cfg)
    ours = arch(m).layout(m, INIT)
    want = [(("layers", j, k), tuple(v.shape))
            for j, layer in enumerate(spec["layers"])
            for k, v in layer.items()]
    want += [((k,), tuple(v.shape)) for k, v in spec.items() if k != "layers"]
    assert sorted((p, tuple(s)) for p, s, _ in ours) == sorted(want)


@pytest.mark.parametrize("name,i,m", all_models(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_reference_matches_port(name, i, m):
    from repro_torch.models import transformer as T
    small = shrunk(m)
    params = W.make(arch(m).layout(small, INIT), 7 + i, "cpu", torch.float32)
    cfg = arch(m).port_config(small, "float32")
    toks = torch.randint(3, small["vocab_size"], (2, 11),
                         generator=torch.Generator().manual_seed(i))
    want, _ = T.apply(params, cfg, tokens=toks)
    got = ref.logits(params, small,
                     ref.hidden(params, small, toks).reshape(-1, cfg.d_model))
    want = want[..., :small["vocab_size"]].reshape(got.shape).float()
    assert torch.allclose(got, want, atol=1e-4, rtol=1e-4), (
        (got - want).abs().max())


def test_control_is_lower_precision():
    m = shrunk(models(CONFIGS[0])[0])
    params = W.make(arch(m).layout(m, INIT), 3, "cpu", torch.float32)
    toks = torch.randint(3, 300, (1, 9),
                         generator=torch.Generator().manual_seed(0))
    h = ref.hidden(params, m, toks)
    h8 = ref.hidden(params, m, toks, "fp8")
    err = (h - h8).abs().max() / h.abs().max()
    assert 1e-3 < err < 0.5


def test_weights_same_seed_same_values():
    m = shrunk(models(CONFIGS[0])[1])
    leaves = arch(m).layout(m, INIT)
    a = W.make(leaves, 11, "cpu", torch.bfloat16)
    b = W.make(leaves, 11, "cpu", torch.bfloat16)
    c = W.make(leaves, 12, "cpu", torch.bfloat16)
    assert torch.equal(a["layers"][1]["wq"], b["layers"][1]["wq"])
    assert not torch.equal(a["layers"][1]["wq"], c["layers"][1]["wq"])
    # q/k take fan_in = hidden size
    std = a["layers"][0]["wq"].float().std().item()
    assert std == pytest.approx(m["hidden_size"] ** -0.5, rel=0.1)


# ---- the architecture modules against the harness before them -----------
# Taken on commit b1f1c693e5168e125e74172c7ed8bebc8a8c2b01, where the
# harness built every model as a dense decoder itself.

def parent_port_config(m, dtype):
    """``harness.port_config`` at that commit."""
    from repro_torch.models.config import ATTN, ModelConfig
    return ModelConfig(
        name=m["name"], family="dense", n_layers=m["num_hidden_layers"],
        d_model=m["hidden_size"], n_heads=m["num_attention_heads"],
        n_kv_heads=m["num_key_value_heads"], d_ff=m["intermediate_size"],
        vocab_size=m["vocab_size"],
        head_dim=m.get("head_dim") or (m["hidden_size"]
                                       // m["num_attention_heads"]),
        qkv_bias=bool(m.get("qkv_bias")), unit=(ATTN,),
        rope_theta=float(m["rope_theta"]), norm_eps=float(m["rms_norm_eps"]),
        tie_embeddings=bool(m["tie_word_embeddings"]), dtype=dtype)


# per model: sha256 (first 16 hex digits) of repr(layout) and its length
# at the configuration's own init; the checksum below of the shrunk
# model's weights made in bfloat16 on the CPU from seed 7 + i
PARENT = {
    ("internlm2-20b-spin", 0): ("e7f0f59204383227", 435, 20038.155607767032),
    ("internlm2-20b-spin", 1): ("3760b18a1739d6ed", 219, 10258.002051384792),
    ("qwen2.5-14b-spin", 0): ("234c4eb096e46989", 579, 21865.262953090856),
    ("qwen2.5-14b-spin", 1): ("5044d0b868a17fa1", 290, 25114.30401281645),
}


def checksum(params, leaves):
    """Sum over leaves k (buffer order) of (k + 1) x (sum + sum of
    squares) of the leaf's values, in float64."""
    tot = 0.0
    for k, (path, _, _) in enumerate(leaves):
        leaf = (params["layers"][path[1]][path[2]] if path[0] == "layers"
                else params[path[0]]).double()
        tot += (k + 1) * float(leaf.sum() + leaf.square().sum())
    return tot


@pytest.mark.parametrize("name,i,m", all_models(),
                         ids=lambda x: x if isinstance(x, str) else "")
@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_port_config_is_the_parents(name, i, m, dtype):
    assert arch(m).port_config(m, dtype) == parent_port_config(m, dtype)
    small = shrunk(m)
    assert (arch(m).port_config(small, dtype)
            == parent_port_config(small, dtype))


@pytest.mark.parametrize("name,i,m", all_models(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_layout_is_the_parents(name, i, m):
    init = json.loads((HOME / "configs" / f"{name}.json").read_text())["init"]
    leaves = arch(m).layout(m, init)
    digest = hashlib.sha256(repr(leaves).encode()).hexdigest()[:16]
    assert (digest, len(leaves)) == PARENT[name, i][:2]


@pytest.mark.parametrize("name,i,m", all_models(),
                         ids=lambda x: x if isinstance(x, str) else "")
def test_weights_are_the_parents(name, i, m):
    leaves = arch(m).layout(shrunk(m), INIT)
    params = W.make(leaves, 7 + i, "cpu", torch.bfloat16)
    assert checksum(params, leaves) == pytest.approx(PARENT[name, i][2],
                                                     rel=1e-6)
