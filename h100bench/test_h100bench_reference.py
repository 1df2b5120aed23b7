"""The plain reference against the port's plain CPU path, and the
harness's weight layout against the port's parameter spec."""

import json
from pathlib import Path

import pytest
import torch

from h100bench import harness, weights as W
from h100bench.reference import decoder as ref

HOME = Path(__file__).resolve().parent
CONFIGS = sorted((HOME / "configs").glob("*.json"))
INIT = {"embed": 0.02, "norm": 0.05, "bias": 0.1}


def models(path):
    cfg = json.loads(path.read_text())
    return [cfg["llm"]] + cfg["ssms"]


def all_models():
    return [(p.stem, i, m) for p in CONFIGS for i, m in enumerate(models(p))]


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
    cfg = harness.port_config(m, "bfloat16")
    spec = T.abstract_params(cfg)
    ours = W.layout(m, INIT)
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
    params = W.make(small, INIT, 7 + i, "cpu", torch.float32)
    cfg = harness.port_config(small, "float32")
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
    params = W.make(m, INIT, 3, "cpu", torch.float32)
    toks = torch.randint(3, 300, (1, 9),
                         generator=torch.Generator().manual_seed(0))
    h = ref.hidden(params, m, toks)
    h8 = ref.hidden(params, m, toks, "fp8")
    err = (h - h8).abs().max() / h.abs().max()
    assert 1e-3 < err < 0.5


def test_weights_same_seed_same_values():
    m = shrunk(models(CONFIGS[0])[1])
    a = W.make(m, INIT, 11, "cpu", torch.bfloat16)
    b = W.make(m, INIT, 11, "cpu", torch.bfloat16)
    c = W.make(m, INIT, 12, "cpu", torch.bfloat16)
    assert torch.equal(a["layers"][1]["wq"], b["layers"][1]["wq"])
    assert not torch.equal(a["layers"][1]["wq"], c["layers"][1]["wq"])
    # q/k take fan_in = hidden size
    std = a["layers"][0]["wq"].float().std().item()
    assert std == pytest.approx(m["hidden_size"] ** -0.5, rel=0.1)
