"""The dry-run grid on the CPU, shared by the ``test_torch_dryrun_cells*``
files: every (arch x shape) cell of ``registry.reduced_for(arch)`` on
8-rank fake meshes, (2, 4) ``data, model`` and (2, 2, 2) ``pod, data,
model``, and on the (2, 2) ``data, model`` mesh that the (2, 2, 2) one
doubles in data-parallel ranks (the relation of the production 16x16 and
2x16x16 meshes).  Each file runs a few archs (a parallel test run
spreads files over workers); the records are kept per process, so the
grid's and the ratio's cases share each run.  The recurrent stacks'
train and prefill cells are counted at :data:`FIT_SEQS`, within one
SSD/mLSTM chunk, not the dry-run's 256, 512 and 1024: the layouts are
the same at any length (the several-chunk path is held to the plain op
in ``test_torch_sharded_ops.py`` and laid out at full size on the card's
host), and xLSTM's sLSTM steps one token at a time."""

from unittest import mock

import numpy as np
import pytest

from repro.configs import registry as jregistry
from repro.launch import specs as jspecs
from repro_torch.configs import registry
from repro_torch.launch import dryrun as D
from repro_torch.launch import mesh as M
from repro_torch.launch.specs import SHAPES

FIT_SEQS = (32, 64, 96)
MESHES = {"2x4": ((2, 4), ("data", "model")),
          "2x2x2": ((2, 2, 2), ("pod", "data", "model")),
          "2x2": ((2, 2), ("data", "model"))}
_RECORDS = {}


def record(arch, shape, mesh):
    """``run_cell`` of the reduced config's cell on ``MESHES[mesh]``
    (roofline off), once per process."""
    key = (arch, shape, mesh)
    if key not in _RECORDS:
        dims, names = MESHES[mesh]
        with D.fake_world(8), mock.patch.object(D, "FIT_SEQS", FIT_SEQS):
            m = M._device_mesh("cpu", np.arange(int(np.prod(dims))).reshape(
                dims), names)
            _RECORDS[key] = D.run_cell(arch, shape, multi_pod="pod" in names,
                                       roofline=False,
                                       cfg=registry.reduced_for(arch),
                                       mesh=m)
    return _RECORDS[key]


def check_cell(arch, shape, mesh):
    """The cell lays out (``ok``), or the reference skips it, with the
    reference's reason."""
    rec = record(arch, shape, mesh)
    ok, why = jspecs.cell_applicable(jregistry.get(arch), shape)
    if not ok:
        assert rec["status"] == "skipped" and rec["reason"] == why
        return
    assert rec["status"] == "ok", (rec.get("at"), rec.get("error"))
    assert rec["flops"] > 0 and rec["bytes"] > 0


def check_ratio(arch, shape):
    """Twice the data-parallel ranks at the same model width, (2, 2) ->
    (2, 2, 2), gives no device more work: per-device flops and argument
    bytes within 1.05x (an op replicated over the new ranks would show as
    equal or larger counts)."""
    small, big = record(arch, shape, "2x2"), record(arch, shape, "2x2x2")
    if small["status"] == "skipped":
        assert big["status"] == "skipped"
        return
    assert small["status"] == big["status"] == "ok"
    assert big["flops"] <= 1.05 * small["flops"]
    assert (big["memory"]["argument_bytes"]
            <= 1.05 * small["memory"]["argument_bytes"])


def cases(archs, shapes=tuple(SHAPES), meshes=("2x4", "2x2x2")):
    return [pytest.param(a, s, m, id=f"{a}-{s}-{m}")
            for a in archs for s in shapes for m in meshes]


def pairs(archs, shapes=tuple(SHAPES)):
    return [pytest.param(a, s, id=f"{a}-{s}") for a in archs for s in shapes]
