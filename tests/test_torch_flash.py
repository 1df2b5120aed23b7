"""``kernels.ops.flash_attention`` on CPU tensors (its plain version,
``ref.mha_ref``) against the reference's Pallas ``flash_attention`` in
interpret mode, on the shape cases of ``tests/test_kernels.py`` and the
same numpy inputs; and the plain version against the port's
``layers.attention`` (the prefill attention of the model) with a window.

Tolerances: the reference's kernel test's, atol 2e-5 (float32) / 3e-2
(bfloat16) with rtol 1e-2; 1e-5 between the port's two float32
formulations of one function."""

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.kernels.flash_attention import flash_attention as jflash
from repro_torch.kernels import ops
from repro_torch.models.layers import attention

ATOL = {"float32": 2e-5, "bfloat16": 3e-2}
CASES = [(2, 64, 8, 4, 32, 0, 16, 16), (1, 96, 4, 4, 16, 24, 32, 32),
         (2, 40, 8, 2, 32, 0, 16, 16), (1, 128, 2, 1, 64, 32, 64, 64)]


def _qkv(seed, B, S, H, Kh, D):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((B, S, H, D), (B, S, Kh, D), (B, S, Kh, D))]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("B,S,H,Kh,D,win,bq,bk", CASES)
def test_flash_matches_reference(B, S, H, Kh, D, win, bq, bk, dtype):
    arrs = _qkv(0, B, S, H, Kh, D)
    want = jflash(*(jnp.asarray(a, dtype) for a in arrs), window=win,
                  bq=bq, bk=bk, interpret=True)
    got = ops.flash_attention(*(torch.from_numpy(a).to(getattr(torch, dtype))
                                for a in arrs), window=win, bq=bq, bk=bk)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, H, D)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               atol=ATOL[dtype], rtol=1e-2)


@pytest.mark.parametrize("window", [0, 7, 50])
def test_flash_plain_equals_layers_attention(window):
    """One unpadded segment: ``layers.attention`` with positions 0..S-1 is
    the same function as flash attention."""
    q, k, v = (torch.from_numpy(a) for a in _qkv(1, 2, 45, 12, 2, 32))
    pos = torch.arange(45, dtype=torch.int32).expand(2, 45)
    want = attention(q, k, v, q_positions=pos, kv_positions=pos,
                     window=window, q_block=16)
    got = ops.flash_attention(q, k, v, window=window)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5,
                               rtol=1e-5)
