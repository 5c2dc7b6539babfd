"""The numbers ``chip_smoke.py`` holds the flash kernels to, on the CPU.

The bound of each dtype at the slice shape (W = 16: 8192 sequences of 179
patches, head_dim 64), the 4-D view on which the library yardstick (SDPA
with a fused backend forced) is timed, and the kernel table's sources. No
card, no jax: these check arithmetic and shapes, not times.
"""

import os

import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from gordo_components_tpu_torch.ops import _kernels  # noqa: E402


@pytest.mark.parametrize(
    "dtype,bound_ms,bound_by",
    [("float32", 1.0029, "operations"), ("bfloat16", 0.2259, "bytes")],
)
def test_slice_bound(dtype, bound_ms, bound_by):
    bound = chip_smoke.attention_bound(*chip_smoke.SLICE_SHAPE, getattr(torch, dtype))
    assert chip_smoke.SLICE_SHAPE == (8192, 179, 64)
    assert round(bound["bound_ms"], 4) == bound_ms
    assert bound["bound_by"] == bound_by
    assert round(bound["gflop"], 1) == 67.2


def test_library_view_of_the_slice_shape_is_the_4d_layout():
    q3 = torch.empty(chip_smoke.SLICE_SHAPE)  # never written: only its view is read
    q4 = chip_smoke.library_view(q3)
    assert tuple(q4.shape) == (1024, 8, 179, 64)
    assert q4.data_ptr() == q3.data_ptr() and q4.is_contiguous()


def test_library_view_holds_the_same_numbers():
    # (W*tags, H, S, D) flattened with the heads innermost, as flash_attention does
    x = torch.randn(2, 5, 8, 4, generator=torch.Generator().manual_seed(0))  # (B, S, H, D)
    q3 = x.movedim(-2, -3).reshape(16, 5, 4)
    q4 = chip_smoke.library_view(q3)
    assert tuple(q4.shape) == (2, 8, 5, 4)
    for b in range(2):
        for h in range(8):
            assert torch.equal(q4[b, h], q3[b * 8 + h])
            assert torch.equal(q4[b, h], x[b, :, h])


@pytest.mark.parametrize(
    "dtype,backend", [("float32", "EFFICIENT_ATTENTION"), ("bfloat16", "FLASH_ATTENTION")]
)
def test_library_backend_is_a_fused_one(dtype, backend):
    from torch.nn.attention import SDPBackend

    name = chip_smoke.library_backend(getattr(torch, dtype))
    assert name == backend and name != "MATH"
    assert hasattr(SDPBackend, name)


def test_kernel_table_names_both_sources():
    assert _kernels.SOURCES == {
        "flash_fwd_f32": "flash_fwd_f32.cu",
        "flash_fwd_bf16": "flash_fwd_bf16.cu",
        "flash_bwd": "flash_bwd.cu",
    }
    for source in _kernels.SOURCES.values():
        assert os.path.exists(os.path.join(_kernels.SRC_DIR, source))
    assert set(chip_smoke.KERNELS) == set(_kernels.KERNEL_NAMES)
    for dtype, source in chip_smoke.KERNELS.values():
        assert source.startswith("gordo_components_tpu_torch/csrc/") and dtype in (
            "float32", "bfloat16")
        assert os.path.basename(source) in _kernels.SOURCES.values()
    assert set(_kernels.LAUNCHES) == {"flash_fwd", "flash_bwd", *_kernels.KERNEL_NAMES}


@pytest.mark.parametrize(
    "top,atol",
    [(0.2, 4 * 2.0**-10), (0.3, 4 * 2.0**-9), (0.125, 4 * 2.0**-10), (1.0, 2e-2), (3.0, 2e-2)],
)
def test_bf16_tolerance_is_a_few_ulps_of_the_largest_output(top, atol):
    ref = torch.tensor([0.01, -top, top / 2], dtype=torch.bfloat16)
    assert chip_smoke.bf16_atol(ref) == pytest.approx(atol)
    assert chip_smoke.bf16_atol(ref) <= chip_smoke.BF16_ATOL


def test_bf16_tolerance_catches_a_key_dropped_from_pv_only():
    """A fault confined to P·V (key 0 left out of the weighted sum but kept
    in the softmax's denominator) passes 2e-2 at S = 179 and fails the
    ulp-scaled tolerance; the plain output rounded to bf16 passes it."""
    from gordo_components_tpu_torch.ops.flash_attention import flash_fwd_reference

    gen = torch.Generator().manual_seed(chip_smoke.SEED)
    q, k, v = ((0.5 * torch.randn(4, 179, 64, generator=gen)).to(torch.bfloat16)
               for _ in range(3))
    scale = 64 ** -0.5
    ref, lse = flash_fwd_reference(q, k, v, scale)
    p = torch.exp(torch.einsum("bqd,bkd->bqk", q.float(), k.float()) * scale - lse[..., None])
    faulty = (ref.float() - p[..., :1] * v[:, None, 0].float()).to(torch.bfloat16)
    err = (faulty.float() - ref.float()).abs().max().item()
    assert chip_smoke.bf16_atol(ref) < err < chip_smoke.BF16_ATOL
    exact = torch.einsum("bqk,bkd->bqd", p, v.float())
    assert (exact - ref.float()).abs().max().item() <= chip_smoke.bf16_atol(ref)


def test_debug_build_is_a_library_of_its_own(monkeypatch):
    monkeypatch.delenv("CUDA_KERNEL_DEBUG", raising=False)
    served = {name: _kernels.library_path(name) for name in _kernels.SOURCES}
    assert "-DCUDA_KERNEL_DEBUG" not in _kernels.nvcc_flags()
    monkeypatch.setenv("CUDA_KERNEL_DEBUG", "1")
    assert _kernels.nvcc_flags() == [*_kernels.NVCC_FLAGS, "-DCUDA_KERNEL_DEBUG"]
    for name in _kernels.SOURCES:
        assert _kernels.library_path(name) != served[name]
