"""Flash attention of the PyTorch port against the reference on the CPU.

On CPU tensors the port's ``flash_attention`` runs ``flash_fwd_reference``
(its kernel's plain version); the reference runs its Pallas kernel in
interpret mode. Shapes follow ``tests/test_flash_attention.py``. Tolerance
2e-5 in float32 (the reference's own kernel-vs-dense bound: summation
order only) and 2e-2 in bfloat16 (one bf16 rounding of outputs near 1).
The CUDA kernel itself is held against the same plain version on the card
by ``chip_smoke.py`` and ``tests/test_torch_kernels_gpu.py``.
"""

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.ops.attention import dense_attention as ref_dense  # noqa: E402
from gordo_components_tpu.ops.flash_attention import (  # noqa: E402
    flash_attention as ref_flash,
    flash_block_with_lse as ref_block,
)

from gordo_components_tpu_torch.ops import _kernels  # noqa: E402
from gordo_components_tpu_torch.ops.attention import dense_attention  # noqa: E402
from gordo_components_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_block_with_lse,
)


def _qkv(shape, seed=0):
    rng = np.random.default_rng(seed)
    return tuple(rng.normal(scale=0.5, size=shape).astype(np.float32) for _ in range(3))


CASES = [
    ((2, 16, 2, 8), dict(block_q=8, block_k=8), {}),  # small head_dim
    ((1, 37, 1, 4), dict(block_q=8, block_k=8), {}),  # odd seq: padded-key mask
    ((2, 160, 2, 8), {}, {}),  # seq above one default tile
    ((1, 200, 1, 8), dict(block_q=256, block_k=128), {}),  # asymmetric blocks
    ((1, 200, 1, 8), dict(block_q=96, block_k=64), {}),  # non-divisible blocks
    ((24, 2, 8), dict(block_q=8, block_k=8), dict(scale=0.3)),  # no batch, custom scale
]


@pytest.mark.parametrize("shape,blocks,kw", CASES)
def test_flash_matches_reference_flash_and_dense(shape, blocks, kw):
    q, k, v = _qkv(shape, seed=len(shape) + shape[-3])
    ours = flash_attention(*map(torch.from_numpy, (q, k, v)), **kw, **blocks).numpy()
    np.testing.assert_allclose(ours, np.asarray(ref_flash(q, k, v, **kw, **blocks)), atol=2e-5)
    np.testing.assert_allclose(ours, np.asarray(ref_dense(q, k, v, **kw)), atol=2e-5)
    port_dense = dense_attention(*map(torch.from_numpy, (q, k, v)), **kw).numpy()
    np.testing.assert_allclose(port_dense, np.asarray(ref_dense(q, k, v, **kw)), atol=2e-5)


def test_flash_bfloat16_forward():
    q, k, v = _qkv((2, 32, 2, 8), seed=5)
    tq, tk, tv = (torch.from_numpy(a).to(torch.bfloat16) for a in (q, k, v))
    ours = flash_attention(tq, tk, tv, block_q=16, block_k=16)
    assert ours.dtype == torch.bfloat16
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (q, k, v))
    ref = ref_flash(jq, jk, jv, block_q=16, block_k=16)
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(ref, np.float32), atol=2e-2)
    exact = ref_dense(*(np.asarray(a, np.float32) for a in (jq, jk, jv)))
    np.testing.assert_allclose(ours.float().numpy(), np.asarray(exact), atol=2e-2)


def test_lse_matches_reference_and_dense_logsumexp():
    q, k, v = _qkv((6, 129, 16), seed=9)
    scale = 16 ** -0.5
    out, lse = flash_block_with_lse(*map(torch.from_numpy, (q, k, v)), scale)
    ref_out, ref_lse = ref_block(q, k, v, scale, 128, 128)
    np.testing.assert_allclose(out.numpy(), np.asarray(ref_out), atol=2e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(ref_lse), atol=2e-5)
    s = np.einsum("bqd,bkd->bqk", q.astype(np.float64), k) * scale
    dense_lse = np.log(np.exp(s - s.max(-1, keepdims=True)).sum(-1)) + s.max(-1)
    np.testing.assert_allclose(lse.numpy(), dense_lse, atol=2e-5)
    assert lse.dtype == torch.float32


def test_short_sequence_takes_dense_and_cpu_takes_plain_version():
    """seq <= min(block_q, block_k) goes to dense attention (the reference's
    single-tile rule); a CPU tensor never reaches the CUDA kernel."""
    q, k, v = map(torch.from_numpy, _qkv((4, 7, 4, 16), seed=17))
    before = dict(_kernels.LAUNCHES)
    np.testing.assert_allclose(
        flash_attention(q, k, v).numpy(), dense_attention(q, k, v).numpy(), atol=1e-6
    )
    long_q, long_k, long_v = map(torch.from_numpy, _qkv((1, 200, 1, 8), seed=19))
    flash_attention(long_q, long_k, long_v)
    assert _kernels.LAUNCHES == before


@pytest.mark.parametrize("in_dims", [(0, 0, 0), (0, None, None), (1, 1, 1)],
                         ids=["all-mapped", "shared-kv", "mapped-dim-1"])
def test_vmap_over_flash_attention_equals_the_per_item_loop(in_dims, monkeypatch):
    """``torch.func.vmap`` of ``flash_attention`` over k = 3 stacked inputs
    (the engine's fused dispatch over machines) equals the loop over items,
    and the operator's vmap rule makes ONE call with the k items folded into
    BH. Float32 on both sides through the same plain version: 1e-6."""
    from gordo_components_tpu_torch.ops import flash_attention as module

    rng = np.random.default_rng(23)
    shapes = {0: (3, 2, 200, 2, 8), 1: (2, 3, 200, 2, 8), None: (2, 200, 2, 8)}
    q, k, v = (torch.from_numpy(rng.normal(scale=0.5, size=shapes[d]).astype(np.float32))
               for d in in_dims)
    calls = []
    reference = module.flash_fwd_reference

    def spy(q3, k3, v3, scale):
        calls.append(tuple(q3.shape))
        return reference(q3, k3, v3, scale)

    monkeypatch.setattr(module, "flash_fwd_reference", spy)
    before = dict(_kernels.LAUNCHES)
    with torch.inference_mode():
        batched = torch.func.vmap(flash_attention, in_dims=in_dims)(q, k, v)
        assert calls == [(3 * 2 * 2, 200, 8)]  # k · batch · heads
        for i in range(3):
            item = [t if d is None else t.select(d, i) for t, d in zip((q, k, v), in_dims)]
            np.testing.assert_allclose(batched[i].numpy(), flash_attention(*item).numpy(),
                                       atol=1e-6)
    assert _kernels.LAUNCHES == before  # CPU tensors never reach the kernel


def test_gradient_through_the_operator_raises_and_no_grad_runs():
    """The operator is differentiable (its registered backward runs the
    plain ``flash_bwd_reference`` on CPU tensors, and no kernel), and it
    still runs under ``no_grad``; a backward that is asked for a CPU
    tensor's kernel raises instead."""
    from gordo_components_tpu_torch.ops.flash_attention import flash_bwd_reference, flash_fwd

    rng = np.random.default_rng(29)
    q = torch.from_numpy(rng.normal(size=(2, 8, 8)).astype(np.float32)).requires_grad_()
    before = dict(_kernels.LAUNCHES)
    out, lse = flash_fwd(q, q, q, 1.0)
    (dq,) = torch.autograd.grad(out.sum() + lse.sum(), q)
    parts = flash_bwd_reference(q, q, q, out, lse, torch.ones_like(out), 1.0,
                                torch.ones_like(lse))
    np.testing.assert_allclose(dq.numpy(), sum(parts).detach().numpy(), atol=1e-6)
    assert _kernels.LAUNCHES == before
    with torch.no_grad():
        out, lse = flash_fwd(q, q, q, 1.0)
    assert out.shape == (2, 8, 8) and lse.shape == (2, 8) and not out.requires_grad
    with pytest.raises(ValueError, match="not CUDA"):
        _kernels.flash_bwd_cuda(q, q, q, out, lse, out, 1.0)


def test_kernel_wrapper_validates_before_building():
    """Each dtype's kernel refuses a CPU tensor before anything is built or
    counted: there is no CPU fallback inside the wrapper."""
    before = dict(_kernels.LAUNCHES)
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros(2, 8, 8, dtype=dtype)
        with pytest.raises(ValueError, match="not CUDA"):
            _kernels.flash_fwd_cuda(q, q, q, 1.0)
    q = torch.zeros(2, 8, 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="not CUDA"):
        _kernels.flash_fwd_bf16_single_stage(q, q, q, 1.0)
    with pytest.raises(ValueError, match="bfloat16"):  # the bf16 kernel's step takes bf16 only
        _kernels.flash_fwd_bf16_single_stage(q.float(), q.float(), q.float(), 1.0)
    g = torch.zeros(2, 8, 8)
    with pytest.raises(ValueError, match="not CUDA"):
        _kernels.flash_bwd_cuda(g, g, g, g, torch.zeros(2, 8), g, 1.0)
    assert set(_kernels.SOURCES) == {"flash_fwd_f32", "flash_fwd_bf16", "flash_bwd"}
    assert _kernels._LIBS == {} and _kernels.LAUNCHES == before
