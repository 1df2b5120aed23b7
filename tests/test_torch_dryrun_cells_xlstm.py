"""The dry-run grid of xlstm-350m (mLSTM and sLSTM blocks) on the CPU but
for its train cells on the (2, 2, 2) mesh, which with their ratio case
have a file of their own (the sLSTM steps one token at a time); see
``test_torch_dryrun_cells.py``."""

import pytest

from torch_dryrun_grid import cases, check_cell, check_ratio, pairs

ARCHS = ["xlstm-350m"]
SHAPES = ["prefill_32k", "decode_32k", "long_500k"]


@pytest.mark.parametrize("arch,shape,mesh", cases(ARCHS, SHAPES)
                         + cases(ARCHS, ["train_4k"], ["2x4"]))
def test_cell_lays_out(arch, shape, mesh):
    check_cell(arch, shape, mesh)


@pytest.mark.parametrize("arch,shape", pairs(ARCHS, SHAPES))
def test_more_data_ranks_give_no_device_more_work(arch, shape):
    check_ratio(arch, shape)
