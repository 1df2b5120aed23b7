"""The CUDA kernels against their plain versions on the card.  Needs an
NVIDIA card with the CUDA toolkit (the kernels build with nvcc at first
use); without one every test skips.  On the card:
``PYTHONPATH=src python -m pytest -q tests/test_torch_cuda.py``."""

import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import build, cases
from repro_torch.kernels.fused_decode import (fused_paged_decode,
                                              fused_paged_decode_plain)
from repro_torch.kernels.fused_verify import (fused_paged_verify,
                                              fused_paged_verify_plain)


@pytest.fixture
def gen():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.Generator().manual_seed(0)


def _check(kernel, plain, name, a):
    before = build.LAUNCHES[name]
    out = kernel(**a)
    torch.cuda.synchronize()
    assert build.LAUNCHES[name] == before + 1
    ref = plain(**a)
    # bf16 outputs round an f32 result: one bf16 ulp of the largest value
    tol = (2.0 ** -6 if out.dtype == torch.bfloat16 else 1e-4) * max(
        1.0, ref.float().abs().max().item())
    assert (out.float() - ref.float()).abs().max().item() <= tol


@pytest.mark.parametrize("kv,tree,G", [
    ("f32", False, 1), ("bf16", True, 2), ("int8", False, 4),
    ("fp8", True, 1)])
def test_fused_verify_matches_plain(gen, kv, tree, G):
    a = cases.verify_inputs(gen, [37, 5, 90], 4, 4 * G, 4, 96, 16, kv, tree)
    _check(fused_paged_verify, fused_paged_verify_plain,
           "fused_paged_verify", a)


@pytest.mark.parametrize("kv,T,G", [
    ("f32", 5, 1), ("bf16", 1, 2), ("int8", 64, 1), ("fp8", 3, 4)])
def test_fused_decode_matches_plain(gen, kv, T, G):
    a = cases.decode_inputs(gen, [40, 0, 130, 7], T, 4 * G, 4, 64, 16, kv)
    _check(fused_paged_decode, fused_paged_decode_plain,
           "fused_paged_decode", a)


def test_wrapper_rejects_bad_inputs(gen):
    a = cases.decode_inputs(gen, [10, 3], 1, 4, 4, 64, 16, "int8")
    with pytest.raises(ValueError, match="k_scale"):
        fused_paged_decode(**{**a, "k_scale": None, "v_scale": None})
    with pytest.raises(ValueError, match="int32"):
        fused_paged_decode(**{**a, "q_pos": a["q_pos"].long()})
