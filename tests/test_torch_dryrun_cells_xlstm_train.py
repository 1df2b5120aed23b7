"""xlstm-350m's train cell on the (2, 2, 2) mesh and its ratio case
against the (2, 2) mesh; see ``test_torch_dryrun_cells_xlstm.py``."""

import pytest

from torch_dryrun_grid import cases, check_cell, check_ratio, pairs

ARCHS = ["xlstm-350m"]


@pytest.mark.parametrize("arch,shape,mesh",
                         cases(ARCHS, ["train_4k"], ["2x2x2"]))
def test_cell_lays_out(arch, shape, mesh):
    check_cell(arch, shape, mesh)


@pytest.mark.parametrize("arch,shape", pairs(ARCHS, ["train_4k"]))
def test_more_data_ranks_give_no_device_more_work(arch, shape):
    check_ratio(arch, shape)
