"""The port's dry-run (``launch/dryrun.py``) on the CPU: cells of reduced
configs on small fake meshes, the per-device counts of known ops against
hand counts and the ring model, the model flops against the reference's
formula, and its ``--json`` records read back by the tile tuner."""

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
