"""The port's dry-run (``launch/dryrun.py``) on the CPU: cells of reduced
configs on small fake meshes, the per-device counts of known ops against
hand counts and the ring model, the model flops against the reference's
formula, its ``--json`` records read back by the tile tuner, the counts
of the layouts that give each device its share (the padded head split,
the MoE grid's plans, ``row_gather``'s layout choice), and
``tools/dryrun_table.py``'s flagging of negative fitted counts."""

import collections
import json

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.launch import specs as jspecs
from repro_torch.configs import registry
from repro_torch.kernels import autotune
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import SHAPES

MESHES = [((2, 4), ("data", "model")), ((2, 2, 2), ("pod", "data", "model"))]


@pytest.fixture
def world8():
    with D.fake_world(8):
        yield


def _mesh(dims, names):
    return M._device_mesh("cpu", np.arange(8).reshape(dims), names)


@pytest.mark.parametrize("dims,names", MESHES)
@pytest.mark.parametrize("arch", ["qwen2-0.5b", "mixtral-8x22b",
                                  "zamba2-1.2b"])
def test_run_cell_on_a_small_fake_mesh(world8, arch, dims, names):
    """A reduced config's decode cell on 8 fake ranks lays out: a record
    of the reference's keys, per device."""
    cfg = registry.reduced_for(arch)
    rec = D.run_cell(arch, "decode_32k", multi_pod="pod" in names,
                     roofline=True, cfg=cfg, mesh=_mesh(dims, names))
    assert rec["status"] == "ok", (rec.get("at"), rec.get("error"))
    assert rec["n_chips"] == 8 and rec["flops"] > 0 and rec["bytes"] > 0
    assert rec["collective_bytes"] == rec["collectives"]["total"] > 0
    mem = rec["memory"]
    assert mem["peak_bytes"] == mem["argument_bytes"] + mem["temp_bytes"]
    assert rec["model_flops"] == D.model_flops(cfg, "decode_32k")
    assert rec["roofline"]["dominant"] in ("compute", "memory",
                                           "collective")
    assert rec["useful_flops_frac"] == pytest.approx(
        rec["model_flops"] / (rec["flops"] * 8))


def test_dense_cells_run_on_the_data_model_mesh(world8):
    """qwen2-0.5b's prefill and decode (the cells chip_smoke runs at full
    size) pass on the (2, 4) mesh."""
    cfg = registry.reduced_for("qwen2-0.5b")
    for shape in ("prefill_32k", "decode_32k"):
        rec = D.run_cell("qwen2-0.5b", shape, multi_pod=False,
                         roofline=False, cfg=cfg, mesh=_mesh(*MESHES[0]))
        assert rec["status"] == "ok", rec.get("error")


def test_per_device_flops_of_a_sharded_matmul(world8):
    """(64, 32) rows over data (2) times (32, 48) columns over model (4):
    rank 0 multiplies (32, 32) by (32, 12), the global count over 8."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    m = _mesh(*MESHES[0])
    with FakeTensorMode(allow_non_fake_inputs=True):
        x = distribute_tensor(torch.empty(64, 32), m, (Shard(0), Replicate()))
        w = distribute_tensor(torch.empty(32, 48), m, (Replicate(), Shard(1)))
        counter = D.DeviceCounter()
        with counter:
            y = x @ w
    assert tuple(y.to_local().shape) == (32, 12)
    assert counter.flops == 2 * 64 * 32 * 48 / 8
    assert counter.stats()["collective_bytes"] == 0


def test_collective_bytes_follow_the_ring_model(world8):
    """An all-gather counts its output, an all-reduce twice its input, and
    a shard-to-shard move the all-to-all DTensor asks for (on a CPU mesh it
    runs as an all-gather and a chunk: counted as the all-to-all)."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    m = _mesh(*MESHES[0])
    with FakeTensorMode(allow_non_fake_inputs=True):
        t = distribute_tensor(torch.empty(8, 16), m, (Replicate(), Shard(0)))
        p = DTensor.from_local(torch.empty(8, 16), m,
                               (Replicate(), Partial()), run_check=False)
        counter = D.DeviceCounter()
        with counter.alltoall_as_issued(), counter:
            t.redistribute(m, (Replicate(), Replicate()))
            p.redistribute(m, (Replicate(), Replicate()))
            t.redistribute(m, (Replicate(), Shard(1)))
    c = counter.collectives
    assert c["all-gather"] == 8 * 16 * 4
    assert c["all-reduce"] == 2 * 8 * 16 * 4
    assert c["all-to-all"] == 8 * 4 * 4          # the (8, 4) local shard


@pytest.mark.parametrize("arch", jregistry.ASSIGNED)
def test_model_flops_match_reference_formula(arch):
    cfg, jcfg = registry.get(arch), jregistry.get(arch)
    assert cfg.active_params_count() == jcfg.active_params_count()
    for shape, info in jspecs.SHAPES.items():
        kind = info["kind"]
        tokens = info["batch"] * (info["seq"] if kind in ("train", "prefill")
                                  else 1)
        want = (6.0 if kind == "train" else 2.0) * \
            jcfg.active_params_count() * tokens
        assert D.model_flops(cfg, shape) == want


def test_json_records_feed_the_tuner(tmp_path):
    """``--json`` writes the records ``autotune.roofline_candidates`` reads:
    qwen2-0.5b's decode cell is memory-bound, so the tuner adds the deeper
    pipelines."""
    out = tmp_path / "dry.json"
    rc = D.main(["--arch", "qwen2-0.5b", "--shape", "decode_32k",
                 "--roofline", "--json", str(out)])
    assert rc == 0
    recs = json.loads(out.read_text())
    assert [r["status"] for r in recs] == ["ok"]
    assert recs[0]["roofline"]["dominant"] == "memory"
    assert SHAPES["decode_32k"]["batch"] == 128 and recs[0]["n_chips"] == 256
    assert autotune.roofline_candidates("verify", 16, str(out)) == [
        autotune.FusedConfig(depth=3), autotune.FusedConfig(depth=4)]
    assert autotune.roofline_candidates("decode", 16, str(out)) == [
        autotune.FusedConfig(bq=1, bk=4, depth=3),
        autotune.FusedConfig(bq=1, bk=4, depth=4)]


def test_a_cell_whose_op_raises_is_recorded_as_failed(world8, monkeypatch):
    """An op the step cannot lay out raises inside the model; the cell is
    recorded as FAILED with the error and the model line that raised, as
    the reference records a cell that does not compile."""
    from repro_torch.models import transformer as T

    def no_strategy(*a, **k):
        raise NotImplementedError("no sharding strategy")
    monkeypatch.setattr(T, "swiglu", no_strategy)
    rec = D.run_cell("qwen2-0.5b", "decode_32k", multi_pod=False,
                     roofline=False, cfg=registry.reduced_for("qwen2-0.5b"),
                     mesh=_mesh(*MESHES[0]))
    assert rec["status"] == "FAILED"
    assert rec["error"] == "NotImplementedError: no sharding strategy"
    assert rec["at"].startswith("repro_torch/models/transformer.py")


def _table_tool():
    import importlib.util
    import pathlib
    path = pathlib.Path(__file__).parents[1] / "tools" / "dryrun_table.py"
    spec = importlib.util.spec_from_file_location("dryrun_table", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _record(arch, shape, mp, flops, nbytes, coll, arg, fitted=False):
    rec = {"arch": arch, "shape": shape, "multi_pod": mp, "status": "ok",
           "flops": flops, "bytes": nbytes, "collective_bytes": coll,
           "memory": {"argument_bytes": arg, "peak_bytes": 2 * arg},
           "compile_s": 1.0}
    if fitted:
        rec["counted_seqs"] = [256, 512, 1024]
    return rec


def test_table_flags_negative_fitted_counts(tmp_path, capsys):
    """``tools/dryrun_table.py`` marks fitted cells, prints a fitted count
    below zero as flagged (in the cell and in the 2x16x16 ratio) and lists
    it after the status counts; its exit rules are unchanged: a negative
    count exits 0, a 2x16x16 flops ratio over 1.05 exits 1."""
    tool = _table_tool()
    recs = [_record("zamba2-1.2b", "prefill_32k", False, 2e13, 1.6e14, 1e14,
                    1e9, fitted=True),
            _record("zamba2-1.2b", "prefill_32k", True, 1e13, -1.5e14, 5e13,
                    7e8, fitted=True),
            _record("qwen2-0.5b", "decode_32k", False, 2e9, 1.6e10, 8e7, 3e8),
            _record("qwen2-0.5b", "decode_32k", True, 1e9, 8e9, 4e7, 1.5e8)]
    path = tmp_path / "recs.json"
    path.write_text(json.dumps(recs))
    assert tool.main([str(path)]) == 0
    out = capsys.readouterr().out
    rows = {line.split("|")[1].strip(): line for line in out.splitlines()
            if line.startswith("| ") and "cell" not in line}
    assert "| 20 / 1.6e+05 / 1e+05 / 2 |" in rows[
        "zamba2-1.2b prefill_32k (fitted)"]
    assert rows["zamba2-1.2b prefill_32k (fitted)"].endswith(
        "| 0.500 / flagged / 0.700 |")
    assert rows["qwen2-0.5b decode_32k"].endswith("| 0.500 / 0.500 / 0.500 |")
    counts = out.index("4 cells: 4 ok")
    assert out.index("FLAGGED zamba2-1.2b prefill_32k 2x16x16: bytes "
                     "-1.5e+14") > counts
    assert "-1.5e" not in out.split("\n\n")[0]
    recs[3]["flops"] = 2.2e9
    path.write_text(json.dumps(recs))
    assert tool.main([str(path)]) == 1


def test_attention_core_splits_heads_the_model_dim_does_not_divide(world8):
    """qwen2-0.5b's 14 query heads over 2 kv heads divide neither a model
    dim of 4 nor into whole groups: the core pads them to 16, four a
    device, each reading its heads' kv heads.  Per device its flops are
    at most 1.25x the plain core's over the 8 devices (16 / 14 = 1.14x);
    replicated over model they would be 4x."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding
    from repro_torch.models import layers
    m = _mesh(*MESHES[0])
    B, S, H, Kh, hd = 4, 64, 14, 2, 16
    with FakeTensorMode(allow_non_fake_inputs=True):
        q, k, v = (torch.empty(B, S, h, hd) for h in (H, Kh, Kh))
        pos = torch.zeros(B, S, dtype=torch.int32)
        plain = D.DeviceCounter()
        with plain:
            layers.attention(q, k, v, q_positions=pos, kv_positions=pos)
        qkv = [distribute_tensor(t, m, (Shard(0), Replicate()))
               for t in (q, k, v)]
        counter = D.DeviceCounter()
        with counter, implicit_replication(), sharding.use_rules(
                m, sharding.train_rules()):
            layers.attention(*qkv, q_positions=pos, kv_positions=pos)
    assert 0 < counter.flops <= 1.25 * plain.flops / 8


def test_moe_train_step_runs_on_grid_shards(world8, monkeypatch):
    """A reduced MoE train step (6 experts, which a model dim of 4 does
    not split, as mixtral's 8 over 16) on the (2, 4) fake mesh: every
    product of the (experts x capacity) grid, forward and backward, runs
    on the device's half of the capacity, and the backward's (remat
    recompute and gradients) bmm flops are at most 3x the forward's, the
    count of a backward that runs on the same shards (a full-size grid
    gradient, as torch 2.11 computed it before the grid was laid out,
    reads 16x on the production mesh)."""
    import traceback

    from repro_torch.distributed import sharding
    from repro_torch.models import moe
    from repro_torch.models import transformer as T
    cfg = registry.reduced_for("mixtral-8x22b", n_experts=6)
    info = dict(kind="train", batch=8, seq=64)
    C = moe.capacity(8 * 64, 6, cfg.top_k, cfg.capacity_factor)
    flops, grid = {"fwd": 0.0, "bwd": 0.0}, []
    counted = D.DeviceCounter.__torch_dispatch__

    def spy(self, func, types, args=(), kwargs=None):
        before = self.flops
        out = counted(self, func, types, args, kwargs)
        # a local bmm this device ran (not DTensor's global-shape run)
        if func._overloadpacket.__name__ == "bmm" and self.flops > before:
            bwd = torch._C._current_autograd_node() is not None
            flops["bwd" if bwd else "fwd"] += self.flops - before
            if not bwd and any(f.filename.endswith("models/moe.py")
                               for f in traceback.extract_stack()):
                grid.append(tuple(args[0].shape))
        return out
    monkeypatch.setattr(D.DeviceCounter, "__torch_dispatch__", spy)
    rec = D.count_step(cfg, info, _mesh(*MESHES[0]),
                       sharding.train_rules(), T.Opts())
    assert rec["flops"] > 0 and len(grid) == 3 * cfg.n_layers
    assert all(s[:2] == (6, C // 2) for s in grid), grid
    assert flops["bwd"] <= 3.0 * flops["fwd"]


@pytest.mark.parametrize("what", ["dispatch", "combine"])
def test_row_gather_moves_the_cheaper_layout(world8, what):
    """The MoE's gathers at a decode step's shapes on the (2, 4) fake mesh:
    the dispatch (32 token rows on data, read by a (6, 128) grid of slots
    split on data) all-gathers the token rows, 4 kB, where the masked
    lookup summed over data would reduce-scatter the grid, 96 kB; the
    combine (the grid's slots on data, partial sums over model, read by
    64 (expert, slot) ids on data) reduces its rows.  The bytes counted
    are the ring model's of the layout chosen, the least of all."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.distributed.tensor import (DTensor, Partial, Replicate, Shard,
                                          distribute_tensor)
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.distributed import sharding
    m = _mesh(*MESHES[0])
    R = Replicate()
    with FakeTensorMode(allow_non_fake_inputs=True):
        if what == "dispatch":
            table = distribute_tensor(
                torch.empty(32, 64, dtype=torch.bfloat16), m, (Shard(0), R))
            ids = [distribute_tensor(torch.zeros(6, 128, dtype=torch.long), m,
                                     (Shard(1), R))]
        else:
            table = DTensor.from_local(
                torch.empty(6, 64, 64, dtype=torch.bfloat16), m,
                (Shard(1), Partial()), run_check=False)
            ids = [distribute_tensor(torch.zeros(64, dtype=torch.long), m,
                                     (Shard(0), R)) for _ in range(2)]
        counter = D.DeviceCounter()
        with counter, implicit_replication():
            sharding.row_gather(table, *ids)
    costs = [sharding.lookup_bytes(tuple(table.shape), len(ids), 2,
                                   table.placements, ids[0].numel(), 8,
                                   ids[0].placements, g, [2, 4])
             for g in ((), (0,))]
    got = counter.stats()["collective_bytes"]
    assert got == min(costs) < max(costs)
    if what == "dispatch":
        assert got == 32 * 64 * 2 < 6 * 128 * 64 * 2


def test_moe_decode_leaves_the_expert_weights_in_place(world8,
                                                      monkeypatch):
    """A MoE decode step whose slots are few against its width (d 256, 128
    slots an expert: 4 C < 3 d) on the (2, 4) fake mesh keeps the experts'
    weights where the table lays them out (d over data, ff over model)
    and sums the partial products over data instead: no collective of the
    MoE gathers a weight's (6, 128, 32) shards over data (the collective
    stacks the two shards: (12, 128, 32)), and the (6, 128, 32) products
    are all-reduced; a training step (many slots) gathers them."""
    import traceback
    seen = collections.defaultdict(set)
    counted = D.DeviceCounter._collective

    def spy(self, name, args, out):
        if any(f.filename.endswith("models/moe.py")
               for f in traceback.extract_stack()):
            for t in D._tensors(out):
                seen[name].add(tuple(t.shape))
        return counted(self, name, args, out)
    monkeypatch.setattr(D.DeviceCounter, "_collective", spy)
    cfg = registry.reduced_for("mixtral-8x22b", n_experts=6, d_model=256)
    rec = D.run_cell("mixtral-8x22b", "decode_32k", multi_pod=False,
                     roofline=False, cfg=cfg, mesh=_mesh(*MESHES[0]))
    assert rec["status"] == "ok", (rec.get("at"), rec.get("error"))
    assert (12, 128, 32) not in seen["all_gather_into_tensor"]
    assert (6, 128, 32) in seen["all_reduce"]
    seen.clear()
    D.count_step(cfg, dict(kind="train", batch=8, seq=64),
                 _mesh(*MESHES[0]), D.shd.train_rules(), D.T.Opts())
    assert (12, 128, 32) in seen["all_gather_into_tensor"]
