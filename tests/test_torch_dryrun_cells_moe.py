"""The dry-run grid of the MoE archs (mixtral-8x22b, dbrx-132b) and of the
archs with embedded inputs (musicgen-large's frames, internvl2-26b's
patch prefix) on the CPU; see ``test_torch_dryrun_cells.py``."""

import pytest

from torch_dryrun_grid import cases, check_cell, check_ratio, pairs

ARCHS = ["mixtral-8x22b", "dbrx-132b", "musicgen-large", "internvl2-26b"]


@pytest.mark.parametrize("arch,shape,mesh", cases(ARCHS))
def test_cell_lays_out(arch, shape, mesh):
    check_cell(arch, shape, mesh)


@pytest.mark.parametrize("arch,shape", pairs(ARCHS))
def test_more_data_ranks_give_no_device_more_work(arch, shape):
    check_ratio(arch, shape)
