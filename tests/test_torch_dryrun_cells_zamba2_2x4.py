"""The dry-run grid of zamba2-1.2b on the CPU's (2, 4) mesh; see
``test_torch_dryrun_cells_zamba2.py``."""

import pytest

from torch_dryrun_grid import cases, check_cell

ARCHS = ["zamba2-1.2b"]


@pytest.mark.parametrize("arch,shape,mesh", cases(ARCHS, meshes=("2x4",)))
def test_cell_lays_out(arch, shape, mesh):
    check_cell(arch, shape, mesh)
