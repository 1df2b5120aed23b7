"""The AFMoE configuration (``arch/afmoe.py``, ``reference/afmoe.py``,
``configs/trinity-mini-spin.json``) at tiny size on the CPU.

* The port against the reference on logits: the dense prefill, then
  decode steps and one packed verify through a paged pool at contexts past
  the window, each on the gather path and on the fused kernels' plain
  versions.
* Planted faults under a whole run of a tiny cell: each turns ``correct``
  false (the window off, rotary on the global layers, selection without
  ``expert_bias``, ``route_scale`` dropped); the sound run stays true.
* The arch module: its layout is the port's parameter spec, its FLOPs by
  hand, the published configuration's size; the two new readers on a
  synthetic record.
"""

import dataclasses
import json
import math

import numpy as np
import pytest
import torch

from h100bench import harness, tiny, weights as W

HOME = harness.ROOT / "h100bench"
SLOTS = 40             # the window, in engine slots
WINDOW = 8
# the tiny model's stream at the scale of one update (0.02 x sqrt(64)):
# in float32 no rounding flips a selection, and in 8 layers a stream 45
# times an update, the card's cell's (PERF.md section 2), leaves the few
# sampled tokens of a faulty run unchanged
INIT = {"embed": 0.02, "norm": 0.05, "bias": 0.1, "expert_bias": 0.05,
        "afmoe_embed": 0.02}


def tiny_afmoe(name="tiny-afmoe"):
    """2 dense + 6 MoE layers, window 8 on three layers of four, 8 experts
    at top-2 plus a shared one; the published config's keys."""
    L = 8
    return {
        "name": name, "source": "tiny", "arch": "afmoe",
        "reference": "afmoe", "num_hidden_layers": L, "hidden_size": 64,
        "num_attention_heads": 4, "num_key_value_heads": 2, "head_dim": 16,
        "intermediate_size": 96, "moe_intermediate_size": 32,
        "num_experts": 8, "num_experts_per_tok": 2, "num_shared_experts": 1,
        "num_dense_layers": 2, "sliding_window": WINDOW,
        "layer_types": ["full_attention" if i % 4 == 3
                        else "sliding_attention" for i in range(L)],
        "score_func": "sigmoid", "route_norm": True, "route_scale": 2.826,
        "n_group": 1, "topk_group": 1, "mup_enabled": True,
        "rms_norm_eps": 1e-5, "rope_theta": 10000.0, "vocab_size": 500,
        "tie_word_embeddings": False}


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """One intra-op thread while this file runs: its matmuls are too small
    to share, and the test workers share the host's cores (at eight
    threads a worker, a tiny run took twenty times as long)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def modules():
    return (harness.load_module(HOME / "arch" / "afmoe.py"),
            harness.load_module(HOME / "reference" / "afmoe.py"))


# ------------------------------------------------ port against reference --

@pytest.fixture(scope="module")
def model():
    arch, ref = modules()
    m = tiny_afmoe()
    params = W.make(arch.layout(m, INIT), 11, "cpu", torch.float32)
    return m, arch.port_config(m, "float32"), params, ref


@pytest.mark.parametrize("fused", [False, True], ids=["gather", "fused"])
def test_port_matches_reference_past_the_window(model, fused):
    from repro_torch.kernels import autotune
    from repro_torch.models import transformer as T
    from repro_torch.serving import paged
    from repro_torch.serving.pool import PagedCachePool
    m, cfg, params, ref = model
    N, P, D_STEPS = 40, 18, 10        # tokens; prompt; decode steps
    toks = torch.from_numpy(
        np.random.default_rng(3).integers(0, 500, (1, N)))
    want = ref.logits(params, m, ref.hidden(params, m, toks)[0])  # (N, V)
    # float32 program against the float32 reference: summation order and
    # the kernels' plain versions' masking give ~1e-6 of logits of ~1-5
    tol = 1e-4 * float(want.abs().max())

    def close(got, lo, hi):
        err = (got.float()[..., :500].reshape(-1, 500) - want[lo:hi]).abs()
        assert float(err.max()) <= tol, (lo, hi, float(err.max()), tol)

    pool = PagedCachePool(cfg, 1, 64, 8, device="cpu")
    lg, cache = T.prefill(params, cfg, tokens=toks[:, :P].int(),
                          lengths=torch.tensor([P], dtype=torch.int32),
                          max_len=pool.prefill_len(P))
    close(lg, 0, P)
    pool.insert(0, cache, P, 0)
    fcfg = autotune.FusedConfig() if fused else None
    for t in range(P, P + D_STEPS):                 # decode past the window
        pool.ensure(0, t + 1)
        lg, pool.cache = paged.decode_step_paged(
            params, cfg, pool.cache, tokens=toks[:, t:t + 1].int(),
            lengths=torch.tensor([t], dtype=torch.int32),
            block_tables=pool.row_table(0), fused_cfg=fcfg)
        close(lg, t, t + 1)
    lo = P + D_STEPS                                # one packed verify
    pool.ensure(0, N)
    ids, owner = (torch.from_numpy(a) for a in pool.live_blocks())
    Tq = N - lo
    lg, pool.cache = paged.verify_step_paged(
        params, cfg, pool.cache, tokens=toks[:, lo:].int(),
        positions=torch.arange(lo, N, dtype=torch.int32)[None],
        segments=torch.zeros((1, Tq), dtype=torch.int32),
        q_rows=torch.zeros(Tq, dtype=torch.int32),
        block_tables=pool.block_table_array()[0], block_ids=ids,
        block_owner=owner, fused_cfg=fcfg)
    close(lg, lo, N)


def test_window_binds_in_the_tiny_model(model):
    """The window term moves the logits past the window: without it the
    port leaves the reference."""
    from repro_torch.models import transformer as T
    m, cfg, params, ref = model
    toks = torch.arange(3 * WINDOW)[None] % 500
    want = ref.logits(params, m, ref.hidden(params, m, toks)[0])
    full = dataclasses.replace(cfg, layer_windows=(0,) * cfg.n_layers)
    for c, same in ((cfg, True), (full, False)):
        lg, _ = T.apply(params, c, tokens=toks)
        err = float((lg[0, :, :500] - want).abs().max())
        assert (err <= 1e-4 * float(want.abs().max())) == same, err


# ---------------------------------------------------------- planted faults --

def cfg_fault(**change):
    def patch(eng):
        eng.llm.cfg = dataclasses.replace(eng.llm.cfg, **change)
    return patch


def rotary_on_global(eng):
    """Rotary on every layer, the global ones too."""
    cfg_fault(layer_rope=(True,) * eng.llm.cfg.n_layers)(eng)


def window_off(eng):
    cfg_fault(layer_windows=(0,) * eng.llm.cfg.n_layers)(eng)


def route_scale_dropped(eng):
    cfg_fault(route_scale=1.0)(eng)


def no_expert_bias(eng):
    """Experts selected on the score alone (the bias zero in the program's
    copy of the weights; the reference keeps its own)."""
    p = eng.llm.params
    eng.llm.params = dict(p, layers=[
        dict(layer, expert_bias=torch.zeros_like(layer["expert_bias"]))
        if "expert_bias" in layer else layer for layer in p["layers"]])


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    root = tiny.make_root(tmp_path_factory.mktemp("bench"))
    base = tiny.tiny_config()
    cfg = dict(base, name="tiny-afmoe", llm=tiny_afmoe(),
               ssms=base["ssms"][:1], init=INIT)
    (root / "h100bench" / "configs" / "tiny-afmoe.json").write_text(
        json.dumps(cfg))
    bench = json.loads((root / "BENCHMARK.json").read_text())
    bench["configs"].append({"name": "tiny-afmoe", "source": "tiny",
                             "file": "h100bench/configs/tiny-afmoe.json",
                             "reduced": [], "why": "CPU test"})
    bench["workloads"].append({"name": "tiny.afmoe", "config": "tiny-afmoe",
                               "traffic": "tiny.closed", "chips": 1,
                               "why": "CPU test"})
    for m in bench["per_layer"]:
        if "tiny.closed" in m["workloads"] or "trinity-mini.mix.c128" in \
                m.get("workloads", []):
            m["workloads"].append("tiny.afmoe")
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    return root


def run(root, patch=None, trace=False, seed=2**31 + 9):
    r = harness.run_cell("tiny.afmoe", seed, 1.0, trace, root=root,
                         device="cpu", slots=SLOTS, patch=patch)
    return r, {k: v["value"] for k, v in r["checks"].items()}


def test_sound_run_is_correct_and_traced(root):
    r, checks = run(root, trace=True)
    assert r["correct"] and r["attempted"] > 0, checks
    assert r["metrics"]["mfu"]["value"] > 0
    # the routed calls of the profiled slots, read from the captured ids
    assert r["metrics"]["moe_pairs_per_expert"]["value"] >= 1
    calls = r["record"]["profile"]["ranges"]["moe_experts"]["calls"]
    assert calls and all(c["ids"].shape[1] == 2 for c in calls)


@pytest.mark.parametrize("fault", [window_off, rotary_on_global, no_expert_bias,
                                   route_scale_dropped],
                         ids=lambda f: f.__name__)
def test_fault_is_caught(root, fault):
    r, checks = run(root, fault)
    assert not r["correct"] and checks["llm_gap"] > 1e-3, checks


# ------------------------------------------------------------ arch module --

def test_layout_is_the_ports():
    from repro_torch.models import transformer as T
    arch, _ = modules()
    m = tiny_afmoe()
    params = T.abstract_params(arch.port_config(m, "float32"))
    want = [(("layers", j, k), tuple(v.shape))
            for j, layer in enumerate(params["layers"])
            for k, v in layer.items()]
    want += [((k,), tuple(v.shape)) for k, v in params.items()
             if k != "layers"]
    got = [(p, tuple(s)) for p, s, _ in arch.layout(m, INIT)]
    assert sorted(got) == sorted(want)
    assert {"expert_bias", "ws_down", "wg"} <= set(params["layers"][2])
    assert "router" not in params["layers"][1]


def test_flops_by_hand():
    arch, _ = modules()
    m = tiny_afmoe()
    d, H, Kh, hd, ff, f, E, k, V = 64, 4, 2, 16, 96, 32, 8, 2, 500
    proj = d * (H + 2 * Kh) * hd + H * hd * d + d * H * hd    # + the gate
    per_token = (8 * proj + 2 * 3 * d * ff
                 + 6 * (d * E + (k + 1) * 3 * d * f) + d * V)
    # 3 tokens after 9 cached: full layers 10 + 11 + 12 pairs, sliding
    # layers 8 + 8 + 8 (window 8); 2 full and 6 sliding layers
    pairs = 2 * 33 + 6 * 24
    assert arch.flops(m, 9, 3) == 2 * 3 * per_token + 4 * H * hd * pairs
    # at the start of a sequence the window does not bind: 1 + 2 + 3
    assert arch.window_pairs(0, 3, 8) == 6
    assert arch.window_pairs(5, 6, 8) == 6 + 7 + 8 + 8 + 8 + 8


def test_published_config():
    """The file holds the catalog's config at its top level and in the
    LLM's entry alike; the port's config of it has 26.1B parameters and
    its pattern: 2 dense layers, windows on three layers of four."""
    cfg = json.loads((HOME / "configs" / "afmoe" / "trinity-mini-spin.json")
                     .read_text())
    llm = cfg["llm"]
    for key in ("hidden_size", "num_experts", "layer_types",
                "moe_intermediate_size", "route_scale", "sliding_window"):
        assert cfg[key] == llm[key], key
    assert cfg["reduced"] == [] and llm["arch"] == "afmoe"
    arch, _ = modules()
    pc = arch.port_config(llm, "bfloat16")
    assert pc.padded_vocab == pc.vocab_size
    assert abs(pc.params_count() - 26.12e9) < 0.01e9, pc.params_count()
    assert pc.layer_windows[:4] == (2048, 2048, 2048, 0)
    assert pc.layer_rope[:4] == (True, True, True, False)
    assert pc.unit[:3] == ("attn", "attn", "moe") and pc.n_units == 1
    assert pc.embed_scale == math.sqrt(2048)


# ---------------------------------------------------------------- readers --

def test_readers_on_a_synthetic_record():
    roof = harness.load_module(HOME / "metrics" / "moe_experts_roofline.py")
    per = harness.load_module(HOME / "metrics" / "moe_pairs_per_expert.py")
    d, f, E = 2048, 1024, 128
    meta = dict(dtype=torch.bfloat16, device="meta")
    calls = []
    for ids in (torch.tensor([[0, 1], [1, 2]]),      # 4 pairs, 3 experts
                torch.tensor([[5, 6]])):              # 2 pairs, 2 experts
        T = ids.shape[0]
        calls.append({"x": torch.empty(T, d, **meta), "ids": ids,
                      "weights": torch.ones(ids.shape),
                      "w_gate": torch.empty(E, d, f, **meta),
                      "w_up": torch.empty(E, d, f, **meta),
                      "w_down": torch.empty(E, f, d, **meta)})
    rec = {"profile": {"ranges": {"moe_experts": {"device_s": 1e-3,
                                                  "calls": calls}}}}
    assert per.read(rec) == pytest.approx((4 / 3 + 2 / 2) / 2)
    # bytes: 5 experts' weights and each call's x, ids, weights, output
    nbytes = (5 * 3 * d * f * 2 + (2 + 1) * d * 2 * 2
              + (4 + 2) * (8 + 4))
    want = 100 * nbytes / 3.35e12 / 1e-3
    assert roof.read(rec) == pytest.approx(want)
    assert roof.read({"profile": None}) is None
    assert per.read({"profile": {"ranges": {}}}) is None
