"""The port's CUDA kernels against their plain PyTorch versions, on the card.

A CUDA kernel has no CPU mode, so these tests carry the ``gpu`` marker and
skip without a card. They import neither jax nor the JAX package, so they
run on a machine that has only PyTorch:

    python -m pytest tests/test_torch_kernels_gpu.py -m gpu -q --noconftest

Each dtype has its own kernel (``csrc/flash_fwd_f32.cu``,
``csrc/flash_fwd_bf16.cu``; the backward ``csrc/flash_bwd.cu`` has one
entry per dtype) and launch count; a bf16 input never reaches the fp32
kernel. The backward is held to ``chip_smoke.bwd_atol``; gradients and a
small fit on the card are held to the same on the CPU. Tolerances: float32 atol 2e-5 (summation order only);
bfloat16 compared in bfloat16 at ``chip_smoke.bf16_atol`` (4 units in the
last place of the largest plain output, at most 2e-2); lse atol 1e-4,
float32 on both sides from the same inputs. The kernels are built with
``CUDA_KERNEL_DEBUG=1``, so a pipeline fault fails its launch rather than
hanging the card. The last two tests serve an int8 PatchTST machine on the
card: one fp32 launch per layer, the CPU's int8 scores within
``chip_smoke.SERVE_RTOL``, and npz responses equal to JSON's in float32.
"""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import chip_smoke  # noqa: E402
from gordo_components_tpu_torch.ops import _kernels  # noqa: E402
from gordo_components_tpu_torch.ops.flash_attention import (  # noqa: E402
    flash_attention,
    flash_bwd_reference,
    flash_fwd_reference,
)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    os.environ.setdefault("CUDA_KERNEL_DEBUG", "1")
    from gordo_components_tpu_torch.utils.backend import resolve_device

    return resolve_device("cuda")


def _qkv(shape, device, dtype, seed=3):
    rng = np.random.default_rng(seed)
    return [
        torch.from_numpy(rng.normal(scale=0.5, size=shape).astype(np.float32)).to(device, dtype)
        for _ in range(3)
    ]


# each dtype's kernel at every S in {1, 37, 64, 65, 129, 179, 256, 300}
# with every D in {8, 16, 64, 128}; then head_dims that are multiples of 4
# but not of 8 (4, 12, 20, 100: the bf16 kernel's plain-load path, where
# TMA's 16-byte row stride rule does not hold) and the served slice width.
# The last five have BH far above the blocks the card holds at once (132
# SMs, a few blocks each), so every persistent block walks several work
# items in each instantiation: fp32 <32, 4>, <64, 4>, <128, 4>; bf16
# <1, 3, 6>, <2, 3, 2> and the plain-load path.
_SHAPES = [(3, seq, d) for seq in (1, 37, 64, 65, 129, 179, 256, 300) for d in (8, 16, 64, 128)]
_SHAPES += [(2, 64, 4), (2, 37, 12), (2, 129, 20), (2, 65, 100), (64, 179, 64), (12, 129, 16)]
_SHAPES += [(4096, 65, 32), (1024, 179, 64), (2048, 300, 128), (1024, 129, 12), (1024, 65, 100)]


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _SHAPES)
def test_flash_fwd_matches_plain_version(shape, dtype, cuda_device):
    dt = getattr(torch, dtype)
    q, k, v = _qkv(shape, cuda_device, dt)
    scale = shape[-1] ** -0.5
    before = dict(_kernels.LAUNCHES)
    out, lse = _kernels.flash_fwd_cuda(q, k, v, scale)
    ref_out, ref_lse = flash_fwd_reference(q, k, v, scale)
    torch.cuda.synchronize()
    own, other = ("flash_fwd_f32", "flash_fwd_bf16")[:: 1 if dt == torch.float32 else -1]
    assert _kernels.LAUNCHES["flash_fwd"] == before["flash_fwd"] + 1
    assert _kernels.LAUNCHES[own] == before[own] + 1
    assert _kernels.LAUNCHES[other] == before[other]  # never the other dtype's kernel
    assert out.dtype == dt and lse.dtype == torch.float32
    atol = 2e-5 if dt == torch.float32 else chip_smoke.bf16_atol(ref_out)
    torch.testing.assert_close(out, ref_out, atol=atol, rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("shape", [(2, 37, 64), (4, 179, 64), (2, 300, 128), (2, 65, 12)])
def test_bf16_single_stage_step_matches_plain_version(shape, cuda_device):
    """The bf16 kernel's first build-up step: one consumer warpgroup, one
    stage, one bh per block. It checks the wgmma products, the swizzled
    layouts and V's transpose bit apart from the ring and persistence."""
    q, k, v = _qkv(shape, cuda_device, torch.bfloat16)
    scale = shape[-1] ** -0.5
    out, lse = _kernels.flash_fwd_bf16_single_stage(q, k, v, scale)
    ref_out, ref_lse = flash_fwd_reference(q, k, v, scale)
    torch.cuda.synchronize()
    torch.testing.assert_close(out, ref_out, atol=chip_smoke.bf16_atol(ref_out), rtol=0)
    torch.testing.assert_close(lse, ref_lse, atol=1e-4, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vmapped_operator_makes_one_launch_and_equals_per_item_launches(dtype, cuda_device):
    """``torch.func.vmap`` of the flash operator over k = 4 machines at the
    fleet's shape folds them into one launch at BH = 4·8192 = 32768, and
    every item equals its own launch exactly (each bh row is computed the
    same way whichever block takes it). An unmapped k/v is expanded."""
    from gordo_components_tpu_torch.ops.flash_attention import flash_fwd

    dt = getattr(torch, dtype)
    gen = torch.Generator(device=cuda_device).manual_seed(5)
    q, k, v = [(0.5 * torch.randn((4, 8192, 179, 64), generator=gen, device=cuda_device)).to(dt)
               for _ in range(3)]
    scale = 64 ** -0.5
    own = "flash_fwd_f32" if dt == torch.float32 else "flash_fwd_bf16"
    with torch.inference_mode():
        before = _kernels.LAUNCHES[own]
        out, lse = torch.func.vmap(flash_fwd, in_dims=(0, 0, 0, None))(q, k, v, scale)
        assert _kernels.LAUNCHES[own] == before + 1
        shared_kv, _ = torch.func.vmap(flash_fwd, in_dims=(0, None, None, None))(q, k[0], v[0], scale)
        assert _kernels.LAUNCHES[own] == before + 2
        for i in range(4):
            item_out, item_lse = _kernels.flash_fwd_cuda(q[i], k[i], v[i], scale)
            torch.testing.assert_close(out[i], item_out, atol=0, rtol=0)
            torch.testing.assert_close(lse[i], item_lse, atol=0, rtol=0)
            shared_out, _ = _kernels.flash_fwd_cuda(q[i], k[0], v[0], scale)
            torch.testing.assert_close(shared_kv[i], shared_out, atol=0, rtol=0)
    torch.cuda.synchronize()


@pytest.mark.gpu
def test_flash_attention_on_the_card_matches_the_cpu(cuda_device):
    q, k, v = _qkv((2, 200, 3, 8), cuda_device, torch.float32)
    out = flash_attention(q, k, v, block_q=96, block_k=64)
    ref = flash_attention(*(t.cpu() for t in (q, k, v)), block_q=96, block_k=64)
    torch.testing.assert_close(out.cpu(), ref, atol=2e-5, rtol=0)


# the backward at every S in {1, 37, 64, 65, 179, 300} with every D in
# {8, 16, 64, 128} (D = 8 pads to the 16-column tile), then BH large enough
# that the grid holds many blocks per SM, at the served width
_BWD_SHAPES = [(3, seq, d) for seq in (1, 37, 64, 65, 179, 300) for d in (8, 16, 64, 128)]
_BWD_SHAPES += [(2, 37, 12), (2, 65, 100), (2048, 179, 64), (512, 129, 16)]


@pytest.mark.gpu
@pytest.mark.parametrize("with_dlse", [False, True], ids=["no-dlse", "dlse"])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", _BWD_SHAPES)
def test_flash_bwd_matches_plain_version(shape, dtype, with_dlse, cuda_device):
    """``csrc/flash_bwd.cu`` against flash_bwd_reference on the same saved
    forward: float32 within chip_smoke.bwd_atol (2e-5 of the largest plain
    grad, summation order only), bfloat16 grads within 4 ulps of the
    largest one; the lse cotangent, when given, changes dq and dk only."""
    dt = getattr(torch, dtype)
    q, k, v = _qkv(shape, cuda_device, dt)
    do, _, _ = _qkv(shape, cuda_device, dt, seed=4)
    scale = shape[-1] ** -0.5
    out, lse = flash_fwd_reference(q, k, v, scale)
    dlse = None
    if with_dlse:
        dlse = torch.from_numpy(
            np.random.default_rng(5).normal(size=shape[:2]).astype(np.float32)).to(cuda_device)
    before = dict(_kernels.LAUNCHES)
    grads = _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale, dlse)
    plain = flash_bwd_reference(q, k, v, out, lse, do, scale, dlse)
    torch.cuda.synchronize()
    own, other = ("flash_bwd_f32", "flash_bwd_bf16")[:: 1 if dt == torch.float32 else -1]
    assert _kernels.LAUNCHES[own] == before[own] + 1
    assert _kernels.LAUNCHES["flash_bwd"] == before["flash_bwd"] + 1
    assert _kernels.LAUNCHES[other] == before[other]
    for got, ref in zip(grads, plain):
        assert got.dtype == dt and got.shape == ref.shape
        torch.testing.assert_close(got, ref, atol=chip_smoke.bwd_atol(ref), rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_gradient_on_the_card_matches_the_cpu(dtype, cuda_device):
    """``flash_attention`` and ``flash_block_with_lse`` differentiated on the
    card (forward and backward kernels, one launch each) against the same
    gradients on the CPU (the plain versions), in the working dtype."""
    from gordo_components_tpu_torch.ops.flash_attention import flash_block_with_lse

    dt = getattr(torch, dtype)
    x = _qkv((2, 179, 3, 16), "cpu", dt, seed=6)
    cot = _qkv((2, 179, 3, 16), "cpu", dt, seed=7)[0]
    w = torch.from_numpy(np.random.default_rng(8).normal(size=(6, 179)).astype(np.float32))

    def grads(device):
        q, k, v = (t.to(device).requires_grad_() for t in x)
        o = flash_attention(q, k, v)
        o3, lse = flash_block_with_lse(*(t.movedim(-2, -3).reshape(6, 179, 16) for t in (q, k, v)),
                                       16 ** -0.5)
        loss = (o.float() * cot.to(device).float()).sum() + (lse * w.to(device)).sum()
        loss = loss + o3.float().square().sum()
        return [g.cpu() for g in torch.autograd.grad(loss, (q, k, v))]

    before = dict(_kernels.LAUNCHES)
    on_card = grads(cuda_device)
    torch.cuda.synchronize()
    own = "flash_bwd_f32" if dt == torch.float32 else "flash_bwd_bf16"
    assert _kernels.LAUNCHES[own] == before[own] + 2
    for got, ref in zip(on_card, grads("cpu")):
        # bf16: the card's forward rounds P to bf16 before P V, so its saved
        # out differs from the CPU's by an ulp, and that reaches every grad
        atol = (chip_smoke.bwd_atol(ref) if dt == torch.float32 else
                chip_smoke.BF16_SERVE_RTOL * max(1.0, ref.float().abs().max().item()))
        torch.testing.assert_close(got.float(), ref.float(), atol=atol, rtol=0)


@pytest.mark.gpu
@pytest.mark.parametrize("name", ["patchtst-flash-P129", "lstm"])
def test_fit_on_the_card_matches_the_cpu(name, cuda_device):
    """One small fit on the card (the PatchTST at 129 patches through both
    flash kernels, one launch of each per step for its one layer) against
    the same fit on the CPU: the same initial parameters and permutations (one
    CPU generator drives both), float32; losses within 1e-4 relative and
    predictions within 1e-4 of their magnitude (GEMMs and the attention
    summed in other orders over two epochs of Adam steps)."""
    from gordo_components_tpu_torch.models import LSTMAutoEncoder, PatchTSTAutoEncoder

    if name == "lstm":
        make = lambda: LSTMAutoEncoder(kind="lstm_symmetric", dims=[8], lookback_window=12,
                                       epochs=2, batch_size=16)  # noqa: E731
        X = np.random.default_rng(13).normal(size=(100, 4)).astype(np.float32)
    else:
        make = lambda: PatchTSTAutoEncoder(lookback_window=1040, patch_length=16, stride=8,  # noqa: E731
                                           d_model=16, n_heads=2, n_layers=1,
                                           attention_impl="flash", epochs=2, batch_size=4)
        X = np.random.default_rng(13).normal(size=(1047, 2)).astype(np.float32)
    before = dict(_kernels.LAUNCHES)
    card = make().to(cuda_device).fit(X)
    torch.cuda.synchronize()
    steps = 2 * -(-(len(X) - card.lookback_window + 1) // card.batch_size)
    flash = steps if name != "lstm" else 0
    assert _kernels.LAUNCHES["flash_fwd_f32"] == before["flash_fwd_f32"] + flash
    assert _kernels.LAUNCHES["flash_bwd_f32"] == before["flash_bwd_f32"] + flash
    cpu = make().to("cpu").fit(X)
    np.testing.assert_allclose(card.history_, cpu.history_, rtol=1e-4)
    got, ref = card.predict(X), cpu.predict(X)
    assert np.abs(got - ref).max() <= 1e-4 * max(1.0, np.abs(ref).max())


@pytest.mark.gpu
def test_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    q = torch.zeros(2, 8, 6, device=cuda_device)  # head_dim not a multiple of 4
    with pytest.raises(ValueError, match="multiple of 4"):
        _kernels.flash_fwd_cuda(q, q, q, 1.0)
    h = torch.zeros(2, 8, 8, device=cuda_device, dtype=torch.float16)
    with pytest.raises(ValueError, match="bfloat16"):
        _kernels.flash_fwd_cuda(h, h, h, 1.0)
    f32 = torch.zeros(2, 8, 4, device=cuda_device)
    b16 = f32.to(torch.bfloat16)
    with pytest.raises(ValueError, match="one dtype"):  # never cast to the other kernel
        _kernels.flash_fwd_cuda(f32, b16, b16, 1.0)
    unaligned = torch.zeros(2 * 8 * 8 + 1, device=cuda_device)[1:].view(2, 8, 8)
    with pytest.raises(ValueError, match="16-byte"):
        _kernels.flash_fwd_cuda(unaligned, unaligned, unaligned, 1.0)
    # the backward: head_dim up to 128, one dtype, float32 lse, no cast
    wide = torch.zeros(2, 8, 132, device=cuda_device)
    lse = torch.zeros(2, 8, device=cuda_device)
    with pytest.raises(ValueError, match="at most 128"):
        _kernels.flash_bwd_cuda(wide, wide, wide, wide, lse, wide, 1.0)
    with pytest.raises(ValueError, match="q is"):
        _kernels.flash_bwd_cuda(f32, f32, f32, f32, lse[:, :8], b16, 1.0)
    with pytest.raises(ValueError, match="lse"):
        _kernels.flash_bwd_cuda(f32, f32, f32, f32, lse.double(), f32, 1.0)
    with pytest.raises(ValueError, match="not CUDA"):
        _kernels.flash_bwd_cuda(f32.cpu(), f32, f32, f32, lse, f32, 1.0)


@pytest.fixture(scope="module")
def int8_artifact(tmp_path_factory):
    """The full-width slice machine written at int8 by the port (metadata
    pins the rung, ``quant_int8.npz`` beside ``state.npz``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernel has no CPU mode")
    from gordo_components_tpu_torch.utils.backend import resolve_device

    path = str(tmp_path_factory.mktemp("int8") / "slice-int8")
    chip_smoke.build_artifact(path, resolve_device("cuda"), precision="int8")
    return path


def _int8_engine(path, device):
    from gordo_components_tpu_torch import precision
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    return ServingEngine({"m": load(path, device="cpu")}, precisions={"m": "int8"},
                         quantized={"m": precision.load_quantized(path)}, device=device)


@pytest.mark.gpu
def test_int8_served_path_runs_the_fp32_kernel_and_matches_the_cpu(int8_artifact, cuda_device):
    """An int8 PatchTST request on the card: int8 weights stacked on the
    card, one fp32 flash launch per layer, and the scores of the CPU plain
    path at int8 within chip_smoke.SERVE_RTOL (float32 both sides, the same
    dequantized weights)."""
    engine = _int8_engine(int8_artifact, cuda_device)
    bucket = engine._buckets[0]
    assert all(t.dtype == torch.int8 and t.is_cuda for t in bucket.stacked["params"].values())
    X = chip_smoke.sensor_rows(np.random.default_rng(11), chip_smoke.LOOKBACK + 15)
    before = dict(_kernels.LAUNCHES)
    scored = engine.anomaly("m", X)
    assert _kernels.LAUNCHES["flash_fwd_f32"] == before["flash_fwd_f32"] + chip_smoke.SLICE["n_layers"]
    assert _kernels.LAUNCHES["flash_fwd_bf16"] == before["flash_fwd_bf16"]
    plain = _int8_engine(int8_artifact, "cpu").anomaly("m", X)
    for got, ref in zip(scored, plain):
        assert np.abs(got - ref).max() <= chip_smoke.SERVE_RTOL * max(1.0, np.abs(ref).max())
    engine.close()


@pytest.mark.gpu
def test_npz_round_trip_on_the_card_equals_json(int8_artifact, cuda_device):
    """The same request over HTTP as JSON and as npz: the npz arrays are
    float32 and equal the JSON values cast to float32."""
    import json
    import threading

    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.server.server import make_server

    httpd = make_server(int8_artifact, port=0, device=cuda_device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/gordo/v0/project/slice-int8/anomaly/prediction")
    X = chip_smoke.sensor_rows(np.random.default_rng(12), chip_smoke.LOOKBACK + 15)
    body = json.dumps({"X": X.tolist()}).encode()
    try:
        status, reply, raw, _ = chip_smoke.http("POST", url, body)
        assert status == 200
        as_json = json.loads(raw)
        status, reply, raw, _ = chip_smoke.http("POST", url, body,
                                                {"Accept": wire.NPZ_CONTENT_TYPE})
        assert status == 200 and wire.content_type_of(reply["Content-Type"]) == wire.NPZ_CONTENT_TYPE
        as_npz = wire.payload_from_npz(raw)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    assert as_npz["tag-thresholds"] == as_json["tag-thresholds"]
    for field in wire.SCORE_FIELDS:
        assert as_npz["data"][field].dtype == np.float32
        np.testing.assert_array_equal(as_npz["data"][field],
                                      np.asarray(as_json["data"][field], np.float32))
