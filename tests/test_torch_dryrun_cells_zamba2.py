"""The dry-run grid of zamba2-1.2b (Mamba2 blocks and a shared attention
block) on the CPU, on the (2, 2, 2) mesh and against (2, 2); the (2, 4)
mesh's cells are in ``test_torch_dryrun_cells_zamba2_2x4.py``; see
``test_torch_dryrun_cells.py``."""

import pytest

from torch_dryrun_grid import cases, check_cell, check_ratio, pairs

ARCHS = ["zamba2-1.2b"]


@pytest.mark.parametrize("arch,shape,mesh", cases(ARCHS, meshes=("2x2x2",)))
def test_cell_lays_out(arch, shape, mesh):
    check_cell(arch, shape, mesh)


@pytest.mark.parametrize("arch,shape", pairs(ARCHS))
def test_more_data_ranks_give_no_device_more_work(arch, shape):
    check_ratio(arch, shape)
