"""The dry-run grid on the CPU (``torch_dryrun_grid``): every cell of the
dense token-input archs lays out on both 8-rank fake meshes (``ok``, or
the reference's skip), and doubling the data-parallel ranks gives no
device more work.  The MoE, audio and vision archs, Zamba2 and xLSTM have
files of their own (a parallel test run spreads files over workers)."""

import pytest

from torch_dryrun_grid import cases, check_cell, check_ratio, pairs

ARCHS = ["qwen2-0.5b", "minitron-4b", "internlm2-20b", "qwen1.5-32b"]


@pytest.mark.parametrize("arch,shape,mesh", cases(ARCHS))
def test_cell_lays_out(arch, shape, mesh):
    check_cell(arch, shape, mesh)


@pytest.mark.parametrize("arch,shape", pairs(ARCHS))
def test_more_data_ranks_give_no_device_more_work(arch, shape):
    check_ratio(arch, shape)
