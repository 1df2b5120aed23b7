"""Host-side logic of the redesigned attention kernels, on the CPU.

* ``verify_attention.split_plan``: the split-KV grid of the dense packed
  verify covers every 32-slot tile exactly once, leaves no run empty and
  stays inside CUDA's grid limits up to 64k slots;
* ``flash_attention.route``: bf16 goes to the tensor-core kernel, float32
  to the CUDA-core kernel, explicitly, and anything else raises;
* ``cases.plan_verify_inputs`` (the dense plan's 128-cell rows, the
  layout the card's split-KV checks use): the port's wrapper on the CPU
  against the reference's Pallas ``verify_attention`` in interpret mode,
  at the tolerances of ``tests/test_torch_attention.py``;
* ``build.ptxas_entries``: the registers and spills ``chip_smoke.py``
  reports from the compiler's output."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.verify_attention import verify_attention as j_verify
from repro_torch.kernels import build, cases, ops
from repro_torch.kernels.flash_attention import MMA_HEAD_DIMS, route
from repro_torch.kernels.verify_attention import (KV_TILE, MAX_RUNS,
                                                  TAG_GROUP, split_plan)

SLOTS = [0, 1, 31, 32, 33, 127, 128, 129, 542, 2000, 2374, 4096, 4097,
         10_000, 65_536]
GEOMETRIES = [(30, 1, 32), (30, 6, 8), (1, 16, 1), (192, 4, 8), (7, 7, 2)]


@pytest.mark.parametrize("Tq,G,Kh", GEOMETRIES)
@pytest.mark.parametrize("Tkv", SLOTS)
def test_split_plan_covers_every_tile_once(Tq, G, Kh, Tkv):
    bq, per_run, runs = split_plan(Tq, G, Kh, Tkv, sms=132)
    tiles = -(-Tkv // KV_TILE)
    covered = [t for z in range(runs)
               for t in range(z * per_run, min(tiles, (z + 1) * per_run))]
    assert covered == list(range(tiles))
    assert all(z * per_run < tiles for z in range(runs)), "an empty run"
    assert per_run >= TAG_GROUP and runs <= MAX_RUNS
    # CUDA: grid x < 2^31, y and z <= 65535; the CTA holds <= 16 rows
    assert 1 <= bq and bq * G <= build.MAX_ROWS
    assert -(-Tq // bq) < 2**31 and Kh <= 65535 and runs <= 65535


def test_split_plan_fills_the_card_at_the_dense_path_shape():
    """q (30, 32, 128) over 542 slots: more than two CTAs per SM, each
    walking at most one pass of tags instead of 17 tiles in a row."""
    bq, per_run, runs = split_plan(30, 1, 32, 542, sms=132)
    assert per_run == TAG_GROUP and runs == 5
    assert -(-30 // bq) * 32 * runs >= 2 * 132


@pytest.mark.parametrize("D", MMA_HEAD_DIMS)
def test_flash_route_by_dtype(D):
    assert route(torch.bfloat16, D) == "mma"
    assert route(torch.float32, D) == "scalar"


@pytest.mark.parametrize("dtype,D", [(torch.bfloat16, 80),
                                     (torch.bfloat16, 32),
                                     (torch.float32, 160),
                                     (torch.float16, 128)])
def test_flash_route_rejects(dtype, D):
    with pytest.raises(ValueError, match="flash_attention takes"):
        route(dtype, D)


def _jax(t):
    if t is None:
        return None
    if t.dtype == torch.bfloat16:
        return jnp.asarray(t.float().numpy(), jnp.bfloat16)
    return jnp.asarray(t.numpy())


@pytest.mark.parametrize("kv,tree", [("f32", False), ("bf16", False),
                                     ("f32", True)])
def test_plan_layout_verify_matches_reference(kv, tree):
    """Requests of 20, 150 and 5 tokens in 128-cell rows (384 packed cells,
    mostly padding) plus W + 1 = 5 new slots each."""
    a = cases.plan_verify_inputs(torch.Generator().manual_seed(3),
                                 [20, 150, 5], 4, 4, 2, 16, kv, tree,
                                 device="cpu")
    assert a["k"].shape[0] == 4 * 128 + 15
    assert int((a["kv_seg"] >= 0).sum()) == 175 + 15
    got = ops.verify_attention(**a)
    j = {n: _jax(t) for n, t in a.items()}
    want = j_verify(j["q"], j["k"], j["v"], j["q_seg"], j["q_pos"],
                    j["kv_seg"], j["kv_pos"], j["q_anc"], j["kv_node"],
                    bq=8, bk=16, interpret=True)
    want = np.asarray(jnp.asarray(want, jnp.float32))
    if kv == "bf16":
        tol = 2.0 ** -6 * max(1.0, float(np.abs(want).max()))
        np.testing.assert_allclose(got.float().numpy(), want, atol=tol,
                                   rtol=0)
    else:
        np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


def test_ptxas_entries_reads_registers_and_spills():
    text = """\
ptxas info    : Compiling entry function '_ZN4spin5flash3mma16flash_mma_kernelILi128EEEvPK13__nv_bfloat16' for 'sm_90a'
ptxas info    : Function properties for _ZN4spin5flash3mma16flash_mma_kernelILi128EEEvPK13__nv_bfloat16
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 198 registers, used 1 barriers, 400 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN4spin21verify_partial_kernelIffLb1EEEvPKT_' for 'sm_90a'
ptxas info    : Function properties for _ZN4spin21verify_partial_kernelIffLb1EEEvPKT_
    8 bytes stack frame, 4 bytes spill stores, 12 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers, 1552 bytes smem, 400 bytes cmem[0]
"""
    got = build.ptxas_entries(text)
    assert [(e["entry"][:16], e["registers"], e["spill_bytes"],
             e["static_smem"]) for e in got] == [
        ("flash_mma_kernel", 198, 0, 0), ("verify_partial_k", 168, 16, 1552)]
