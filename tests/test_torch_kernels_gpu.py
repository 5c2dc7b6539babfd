"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip without a card. They import neither jax nor the JAX package, so they
run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

Tolerances: float32 atol 2e-5 (summation order only); bfloat16 atol 2e-2,
compared in bfloat16 (one rounding of outputs near 1); lse is float32 on
both sides from the same inputs.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu_torch.ops import _kernels  # noqa: E402
from gordo_components_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_fwd_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gordo_components_tpu_torch.utils.backend import resolve_device

    return resolve_device("cuda")


def _qkv(shape, device, dtype, seed=3):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.normal(scale=0.5, size=shape).astype(np.float32)).to(device, dtype)
        for _ in range(3)
    ]


@pytest.mark.gpu
@pytest.mark.parametrize(
    "shape,dtype",
    [((12, 129, 16), "float32"), ((3, 37, 8), "float32"), ((2, 64, 4), "float32"),
     ((5, 300, 128), "float32"), ((64, 179, 64), "float32"), ((64, 179, 64), "bfloat16")],
)
def test_flash_fwd_matches_plain_version(shape, dtype, cuda_device):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(shape, cuda_device, dt)
    scale = shape[-1] ** -0.5
    before = _kernels.LAUNCHES["flash_fwd"]
    out, lse = _kernels.flash_fwd_cuda(q, k, v, scale)
    ref_out, ref_lse = flash_fwd_reference(q, k, v, scale)
    torch.cuda.synchronize()
    assert _kernels.LAUNCHES["flash_fwd"] == before + 1
    assert out.dtype == dt and lse.dtype == torch.float32
    torch.testing.assert_close(out, ref_out, atol=2e-5 if dt == torch.float32 else 2e-2, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.gpu
def test_flash_attention_on_the_card_matches_the_cpu(cuda_device):
    q, k, v = _qkv((2, 200, 3, 8), cuda_device, torch.float32)
    out = flash_attention(q, k, v, block_q=96, block_k=64)
    ref = flash_attention(*(t.cpu() for t in (q, k, v)), block_q=96, block_k=64)
    torch.testing.assert_close(out.cpu(), ref, atol=2e-5, rtol=0)


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(2, 8, 6, device=cuda_device)  # head_dim not a multiple of 4
    with pytest.raises(ValueError, match="multiple of 4"):
        _kernels.flash_fwd_cuda(q, q, q, 1.0)
    h = torch.zeros(2, 8, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        _kernels.flash_fwd_cuda(h, h, h, 1.0)
    with pytest.raises(NotImplementedError, match="backward"):
        g = torch.zeros(2, 8, 8, device=cuda_device, requires_grad=True)
        from gordo_components_tpu_torch.ops.flash_attention import flash_fwd

        flash_fwd(g, g, g, 1.0)
