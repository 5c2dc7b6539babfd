#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases; any failure exits non-zero before the result line:

1. environment: torch/CUDA versions, the card's name and power limit, and
   a build of every CUDA kernel from ``gordo_components_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. each kernel (the fp32 one of ``csrc/flash_fwd_f32.cu`` and the bf16 one
   of ``csrc/flash_fwd_bf16.cu``) against its plain PyTorch version on the
   card, at the slice shape and the edge shapes of ``CHECK_SHAPES``; then,
   at the slice shape, its time, the plain version's time and one PyTorch
   library call's time as a yardstick: SDPA on the 4-D view with its fused
   backend forced and named (timed only; the port never calls it). The
   backward (``csrc/flash_bwd.cu``, both dtypes) against
   ``flash_bwd_reference`` at ``CHECK_SHAPES`` and the training shape
   (16384, 179, 64), with and without an lse cotangent (max |Δ| of dq, dk,
   dv each against ``bwd_atol``); then its time, the plain version's, the
   library backward's (``torch.autograd.grad`` of that SDPA call, the
   backward alone) and its bound, at the slice and the training shapes;
3. the main path: a full-width long-window PatchTST anomaly machine
   (d_model 512, 8 heads, 3 layers, 64 tags, lookback 1440 = 179 patches,
   random weights from a seed in the flax layout, scalers fitted on seeded
   data, float32) is dumped as an artifact, served by the port's HTTP
   server on the card, and asked a few ``POST /anomaly/prediction``
   requests, one at a time. The launch counts are zeroed just before and
   read just after; every dispatch (one per lone request) must launch the
   fp32 kernel once per layer, and every response must match the same
   artifact scored by the port with ``device="cpu"`` (its plain path);
3b. the bf16 path: the same machine built with ``compute_dtype="bfloat16"``
   answers one W = 16 request; it must launch the bf16 kernel once per
   layer and the fp32 kernel never, and match the same artifact scored on
   the card with dense attention in bf16;
4. the zoo: the reference's dense and LSTM machines at the widths of its own
   configs (``ZOO``: the dense AE of ``bench.py``'s ``dense_ae_10tag``, the
   ``feedforward_model`` defaults at 100 tags, the LSTM AE of
   ``lstm_ae_50tag``, the LSTM forecast of ``lstm_forecast_100tag``, the
   ``lstm_model`` defaults at 50 tags, that LSTM AE again with
   ``compute_dtype="bfloat16"``, and a joint ``MultiStepForecast``), random
   weights from a seed in the flax layout, dumped by the port into one
   models directory and served by one HTTP server on the card. Each machine
   answers requests of 144 and 1008 rows (a day and a week at 10-minute
   resolution), each matching the same artifact scored on the CPU plain
   path (bf16: at the same dtype, within ``BF16_SERVE_RTOL``), and no
   request launches a flash kernel; the joint forecaster is listed as
   skipped in ``/healthz`` and answers 503. One dense machine is scored at
   the engine's ``bf16`` rung against the CPU at that rung, and one
   1008-row request of ``lstm-ae-50tag`` and of ``dense-ae-default`` is
   traced under ``torch.profiler`` (device time by kernel, launches);
5. the fleet (``FLEETS``): 100 dense machines at 10 tags, 32 LSTM AEs at
   50 tags and 4 full-width PatchTST machines (the slice machine with other
   seeds), dumped into one models directory and served by one HTTP server
   through the stacked engine, which must hold one copy of the weights on
   the card (every machine's own weights on the host, device memory within
   ``HELD_SLACK`` of the stacked trees); each fleet's concurrent clients, spread over
   its machines, send FLEET_ROUNDS timed rounds of requests (req/s, p50,
   p99). Every dense and LSTM response must match the CPU plain path within
   SERVE_RTOL; every PatchTST response the same request served alone on the
   card within FUSED_RTOL, and one of them the CPU within SERVE_RTOL. Every
   fleet must fuse (fusion ratio above 1) with no fused-path repair, and
   the fp32 flash kernel must launch once per layer per PatchTST dispatch
   (at BH = k·8192), fewer times than once per layer per request. One fused
   dispatch per fleet is traced under ``torch.profiler`` (kernels, idle
   share). Then the dense fleet's rounds run again with the clients asking
   for the npz wire format (``Accept: application/x-gordo-npz``), every
   response against the CPU, req/s, p50 and p99 printed beside JSON's;
6. the int8 rung (``phase_int8``): the slice machine, ``dense-ae-default``,
   ``lstm-ae-50tag`` and a four-machine PatchTST fleet, each written by the
   port's ``write_artifact_files(..., precision="int8")`` (its metadata pins
   int8, ``quant_int8.npz`` beside ``state.npz``) and served by one HTTP
   server. The stacked weights must be int8 on the card; lone requests (W =
   1 and 16; 1008 rows), a concurrent W = 16 round over the fleet and one
   fused dispatch of 4 must each match the same artifact at int8 on the CPU
   plain path within SERVE_RTOL and the same weights served at f32 on the
   card within ``precision.error_budget("int8")`` (normalized total-score
   parity); fp32 flash launches = 3 × PatchTST dispatches. Printed: stacked
   bytes at int8 and f32, device memory held after boot, one int8 and one
   f32 W = 16 request under ``torch.profiler``, the dequantize pass alone;
7. the serving surface (``phase_surface``): one server with f32, bf16 and
   int8 machines and a bare (non-detector) dense pipeline: ``/models``,
   ``/metadata``, ``/healthz`` (fleet and per machine), ``/prediction`` (the
   bare machine and a detector), ``/anomaly/prediction`` of the bare machine
   (422), npz == JSON in float32, the trace id echoed, Prometheus
   ``/metrics`` parsed and counting the requests made, a spent
   ``X-Gordo-Deadline`` (504, no dispatch), a scoring fault (quarantine,
   503, named by ``/healthz``, the others serving, probe recovery after the
   cooldown), ``POST /reload`` (a rewritten, an added and a removed machine)
   while clients keep scoring, and a server under ``GORDO_MAX_INFLIGHT=1``,
   ``GORDO_MAX_QUEUE=0`` shedding 8 concurrent clients with 503 +
   ``Retry-After`` while every 200 is right;
8. training (``phase_train``): the slice machine's regressor (scalers, then
   ``PatchTSTAutoEncoder.fit``, float32, flash attention) trained on the
   card for one epoch over ``TRAIN_ROWS`` seeded rows, 8 Adam steps of 32
   windows; the launch counts are zeroed just before and read just after:
   3 fp32 forward and 3 fp32 backward launches per step, nothing else. The
   same fit with dense attention (same initial parameters, same
   permutation) must give the same loss history and W = 16 predictions
   within ``TRAIN_RTOL``. Printed: wall per step, peak device memory, one
   step under ``torch.profiler`` (device busy, GEMMs, flash forward and
   backward, idle share) and the optimizer update alone. The trained
   machine is dumped, served over HTTP and one W = 16 response held to the
   model's own ``predict`` within ``SERVE_RTOL``. Then the bf16 path
   (``phase_train_bf16``): the same fit at ``compute_dtype="bfloat16"``,
   3 bf16 forward and backward launches per step, its loss within
   ``BF16_SERVE_RTOL`` of the same fit with dense attention in bf16;
9. a build at the zoo's widths (``phase_build``): ``dense-ae-default`` and
   ``lstm-ae-50tag`` as anomaly detectors through the port's
   ``build_model`` on the card (``cross_validate`` over 3 folds, then
   ``fit``) on 2016 seeded rows, dumped with the build metadata (the
   reference's keys checked), served by one HTTP server, each 1008-row
   response against the CPU plain path, no flash launch.

The line before last is ``nvidia-smi``'s name and power limit; the one
before that the kernels' JSON record; the last line is the result.
"""

from __future__ import annotations

import json
import math
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
import urllib.error
import urllib.request

import numpy as np

SEED = 0
N_TAGS = 64
LOOKBACK = 1440  # one day at 1-minute resolution
SLICE = dict(patch_length=16, stride=8, d_model=512, n_heads=8, n_layers=3, ff_dim=1024)
WINDOWS = (1, 16, 64, 16, 16)  # windows per request
# card peaks (NVIDIA H100 SXM data sheet, dense): fp32 outside the tensor
# cores, bf16 on the tensor cores, and device memory bandwidth
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12
FP32_ATOL = 2e-5  # summation order only (the reference's kernel-vs-dense bound)
BF16_ATOL = 2e-2  # compared in bf16: one rounding of outputs near 1
# bf16 outputs are also held to BF16_ULPS units in the last place of the
# largest |plain| output (see bf16_atol): the plain version computes in fp32
# from the same bf16 inputs and rounds once; the kernel rounds P to bf16
# (2^-9 relative, ~1e-4 absolute on an output) and rounds once, so the two
# differ by about one ulp. A key dropped or doubled in P·V alone moves an
# output by about |v| / S, ~1e-2 at S = 179, which BF16_ATOL lets through.
BF16_ULPS = 4
LSE_ATOL = 1e-4  # lse is float32 on both sides from the same inputs
# the flash backward in float32, kernel vs plain version on the same saved
# forward: float32 on both sides, the products summed in other orders and
# exp on the MUFU unit (~2 ulp); relative to the largest grad, since a
# grad sums S products of O(1) terms. A dropped key or a wrong mask is O(1)
FP32_BWD_RTOL = 2e-5
# served scores, GPU vs CPU plain path, relative to the array's magnitude:
# float32 on both sides, GEMMs and the online softmax sum in other orders
# (1e-6 .. 1e-5 relative); a wrong mask or layout is an O(1) error
SERVE_RTOL = 1e-4
# bf16 served scores, flash kernel vs dense attention, both on the card in
# bf16: the dense path rounds its logits and softmax weights to bf16 (2^-9
# relative each, ~1e-2 absolute on a logit of a few units), the kernel
# keeps fp32 scores and rounds only P; three layers carry that into the
# scores, ~1e-2 relative. A wrong mask, layout or transpose is O(1).
BF16_SERVE_RTOL = 5e-2


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


def bf16_atol(ref) -> float:
    """The bf16 output tolerance against the plain output ``ref``:
    BF16_ULPS units in the last place of its largest magnitude (bf16 keeps
    8 significant bits), never more than BF16_ATOL."""
    top = ref.float().abs().max().item()
    return min(BF16_ATOL, BF16_ULPS * math.ldexp(1.0, math.frexp(top)[1] - 8))


def bwd_atol(ref) -> float:
    """The flash backward's tolerance against its plain version on the same
    saved forward: float32 grads within FP32_BWD_RTOL of the largest |plain|
    grad (at least of 1); bfloat16 grads within :func:`bf16_atol`, and never
    below FP32_BWD_RTOL: a grad that cancels to ~0 (one key: dP = delta)
    is float32 rounding noise on both sides, which bf16 keeps."""
    import torch

    if ref.dtype == torch.bfloat16:
        return max(bf16_atol(ref), FP32_BWD_RTOL)
    return FP32_BWD_RTOL * max(1.0, ref.abs().max().item())


def timed_ms(fn, iters: int = 10) -> float:
    import torch

    for _ in range(2):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound(bh: int, seq: int, d: int, dtype) -> dict:
    """Least time for the flash forward on these inputs: q, k, v read once,
    out and lse written once; 4·BH·S²·D operations (two products)."""
    import torch

    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 4 * bh * seq * d * elem + bh * seq * 4
    flops = 4 * bh * seq * seq * d
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "gflop": flops / 1e9,
        "gbytes": nbytes / 1e9,
    }


def library_view(t3, heads: int = SLICE["n_heads"]):
    """The ``(W·tags, H, S, D)`` view of a ``(BH, S, D)`` tensor: the port
    flattens ``(..., H, S, D)`` with the heads innermost, so this is the same
    memory. PyTorch's fused attention backends take only 4-D inputs; on 3-D
    inputs ``scaled_dot_product_attention`` runs its math backend, which
    materialises the score matrix."""
    bh, seq, d = t3.shape
    return t3.view(bh // heads, heads, seq, d)


def library_backend(dtype) -> str:
    """The fused backend that is the yardstick: FlashAttention-2 in bf16, the
    memory-efficient kernel in fp32 (FlashAttention takes no fp32)."""
    return "FLASH_ATTENTION" if str(dtype) == "torch.bfloat16" else "EFFICIENT_ATTENTION"


def time_library(torch, F, q, k, v, scale: float):
    """One PyTorch call computing the same function, as a yardstick only (the
    port never calls it): SDPA on the 4-D view with its fused backend forced.
    If that backend refuses the inputs the phase fails: the math backend is
    never what gets timed."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    name = library_backend(q.dtype)
    q4, k4, v4 = (library_view(t) for t in (q, k, v))
    try:
        with sdpa_kernel(getattr(SDPBackend, name)):
            ms = timed_ms(lambda: F.scaled_dot_product_attention(q4, k4, v4, scale=scale))
    except RuntimeError as exc:
        fail(f"SDPA backend {name} refused {tuple(q4.shape)} {q4.dtype}: {exc}")
    return name, ms


def phase_environment():
    import torch

    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if smi.returncode != 0:
        fail(f"nvidia-smi: {smi.stderr.strip()}")
    card = smi.stdout.strip().splitlines()[0]
    print(f"card: {card}")
    from gordo_components_tpu_torch.ops import _kernels

    seconds = _kernels.build_all()
    print(f"kernels built in {seconds:.1f} s: {sorted(_kernels.SOURCES)}")
    return card


SLICE_SHAPE = (16 * N_TAGS * SLICE["n_heads"], (LOOKBACK - 16) // 8 + 1, 64)
# every kernel is held against its plain version at these shapes, in both
# dtypes: the slice shape, S = 64 / 65 (one tile and one past it), S = 256,
# S = 300 at D = 128 (the q-block split and the two-half head), and D = 12
# (the bf16 kernel's plain-load path, where TMA's 16-byte stride rule fails).
# The last three have BH far above the blocks the card holds at once (132
# SMs, a few blocks each), so every persistent block walks several work
# items, as at the slice shape, in every instantiation: fp32 at D <= 32
# and D = 128, bf16's two-half head and its plain-load path.
# a fused dispatch of the four-machine PatchTST fleet at W = 16 (phase 5)
FUSED_SHAPE = (4 * SLICE_SHAPE[0], *SLICE_SHAPE[1:])
CHECK_SHAPES = [SLICE_SHAPE, FUSED_SHAPE, (12, 129, 16), (3, 37, 8), (4, 64, 64), (4, 65, 64),
                (4, 256, 64), (5, 300, 128), (2, 37, 12),
                (4096, 65, 32), (2048, 300, 128), (1024, 129, 12)]
KERNELS = {  # kernel name -> (dtype, source)
    "flash_fwd_f32": ("float32", "gordo_components_tpu_torch/csrc/flash_fwd_f32.cu"),
    "flash_fwd_bf16": ("bfloat16", "gordo_components_tpu_torch/csrc/flash_fwd_bf16.cu"),
    "flash_bwd_f32": ("float32", "gordo_components_tpu_torch/csrc/flash_bwd.cu"),
    "flash_bwd_bf16": ("bfloat16", "gordo_components_tpu_torch/csrc/flash_bwd.cu"),
}
FWD_KERNELS = ("flash_fwd_f32", "flash_fwd_bf16")
BWD_KERNELS = ("flash_bwd_f32", "flash_bwd_bf16")
REPLACES = {  # the TPU kernel each replaces
    **dict.fromkeys(FWD_KERNELS, "gordo_components_tpu/ops/flash_attention.py:157"),
    **dict.fromkeys(BWD_KERNELS, "gordo_components_tpu/ops/flash_attention.py:187-229"),
}
NO_LAUNCHES = dict.fromkeys(KERNELS, 0)
# the backward at the training step's shape (batch 32 x 64 tags x 8 heads)
TRAIN_SHAPE = (32 * N_TAGS * SLICE["n_heads"], SLICE_SHAPE[1], SLICE_SHAPE[2])


def phase_kernels(torch, device) -> dict:
    """Each flash kernel against flash_fwd_reference on the card, then its
    time beside the plain version's and the library yardstick's."""
    import torch.nn.functional as F

    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.ops.flash_attention import (
        flash_attention,
        flash_fwd_reference,
    )

    gen = torch.Generator(device=device).manual_seed(SEED)

    def qkv(shape, dtype):
        return [(0.5 * torch.randn(shape, generator=gen, device=device)).to(dtype)
                for _ in range(3)]

    def check(name, launch, shape, dtype):
        q, k, v = qkv(shape, dtype)
        scale = shape[-1] ** -0.5
        out, lse = launch(q, k, v, scale)
        ref_out, ref_lse = flash_fwd_reference(q, k, v, scale)
        torch.cuda.synchronize()
        atol = FP32_ATOL if dtype == torch.float32 else bf16_atol(ref_out)
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"{name} {tuple(shape)}: max|out-plain| {err:.3g} (atol {atol:.3g}), "
              f"max|lse-plain| {lse_err:.3g} (atol {LSE_ATOL})")
        if not (err <= atol and lse_err <= LSE_ATOL):
            fail(f"{name} disagrees with its plain version at {shape}")
        return err

    record = {}
    for name in FWD_KERNELS:
        dtype = getattr(torch, KERNELS[name][0])
        errs = [check(name, _kernels.flash_fwd_cuda, shape, dtype) for shape in CHECK_SHAPES]
        record[name] = {"max_abs_err": max(errs)}
    # the bf16 kernel's first build-up step (one warpgroup, one stage)
    for shape in (SLICE_SHAPE, (5, 300, 128)):
        check("flash_fwd_bf16 single-stage step", _kernels.flash_fwd_bf16_single_stage,
              shape, torch.bfloat16)
    # the public entry with small blocks: (B, S, H, D) layout into the kernel
    q, k, v = qkv((1, 37, 3, 8), torch.float32)
    before = _kernels.LAUNCHES["flash_fwd_f32"]
    out = flash_attention(q, k, v, block_q=8, block_k=8)
    ref = flash_attention(*(t.cpu() for t in (q, k, v)), block_q=8, block_k=8)
    err = (out.cpu() - ref).abs().max().item()
    print(f"flash_attention (1, 37, 3, 8) blocks 8: max|cuda-cpu| {err:.3g}")
    if err > FP32_ATOL or _kernels.LAUNCHES["flash_fwd_f32"] != before + 1:
        fail("flash_attention on the card did not match the CPU path through the kernel")

    # times at the slice shape, in turns: kernel, plain, library, kernel
    for name in FWD_KERNELS:
        dtype = getattr(torch, KERNELS[name][0])
        q, k, v = qkv(SLICE_SHAPE, dtype)
        scale = SLICE_SHAPE[-1] ** -0.5
        ms_first = timed_ms(lambda: _kernels.flash_fwd_cuda(q, k, v, scale))
        plain_ms = timed_ms(lambda: flash_fwd_reference(q, k, v, scale), iters=3)
        library, library_ms = time_library(torch, F, q, k, v, scale)
        ms_second = timed_ms(lambda: _kernels.flash_fwd_cuda(q, k, v, scale))
        ms = (ms_first + ms_second) / 2
        bound = attention_bound(*SLICE_SHAPE, dtype)
        print(f"{name} {SLICE_SHAPE}: kernel {ms:.4f} ms ({ms_first:.4f}, {ms_second:.4f}), "
              f"plain {plain_ms:.4f} ms, sdpa {library} {library_ms:.4f} ms, bound "
              f"{bound['bound_ms']:.4f} ms ({bound['bound_by']}: {bound['gflop']:.1f} GFLOP, "
              f"{bound['gbytes']:.3f} GB); achieved {bound['gflop'] / ms:.1f} TFLOP/s, "
              f"{bound['gbytes'] / ms:.3f} TB/s, {100 * bound['bound_ms'] / ms:.1f} % of bound")
        record[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library=library,
                            **bound)
        del q, k, v
        q, k, v = qkv(FUSED_SHAPE, dtype)
        fused_ms = timed_ms(lambda: _kernels.flash_fwd_cuda(q, k, v, scale))
        fused_bound = attention_bound(*FUSED_SHAPE, dtype)
        print(f"{name} {FUSED_SHAPE}: kernel {fused_ms:.4f} ms, bound "
              f"{fused_bound['bound_ms']:.4f} ms ({fused_bound['bound_by']}), "
              f"{100 * fused_bound['bound_ms'] / fused_ms:.1f} % of bound")
        del q, k, v
    torch.cuda.empty_cache()
    record.update(phase_kernels_bwd(torch, device))
    return record


def bwd_bound(bh: int, seq: int, d: int, dtype, dlse: bool = False) -> dict:
    """Least time for the flash backward on these inputs: q, k, v, out, dout
    and lse (and dlse) read once, dq, dk, dv written once; 10·BH·S²·D
    operations (five S x S x D products) at the peak rate of the inputs'
    type."""
    import torch

    elem = torch.empty((), dtype=dtype).element_size()
    nbytes = 8 * bh * seq * d * elem + (2 if dlse else 1) * bh * seq * 4
    flops = 10 * bh * seq * seq * d
    t_bytes = nbytes / PEAK_BYTES * 1e3
    t_ops = flops / PEAK_FLOPS[str(dtype).removeprefix("torch.")] * 1e3
    return {
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "gflop": flops / 1e9,
        "gbytes": nbytes / 1e9,
    }


def time_library_bwd(torch, F, q, k, v, do, scale: float):
    """The library yardstick of the backward: ``torch.autograd.grad`` of SDPA
    on the 4-D view with its fused backend forced, the backward alone timed
    (the forward's graph is kept and differentiated again each time)."""
    from torch.nn.attention import SDPBackend, sdpa_kernel

    name = library_backend(q.dtype)
    q4, k4, v4 = (library_view(t).detach().requires_grad_() for t in (q, k, v))
    try:
        with sdpa_kernel(getattr(SDPBackend, name)):
            out = F.scaled_dot_product_attention(q4, k4, v4, scale=scale)
            ms = timed_ms(lambda: torch.autograd.grad(out, (q4, k4, v4), library_view(do),
                                                      retain_graph=True))
    except RuntimeError as exc:
        fail(f"SDPA backend {name} refused the backward at {tuple(q4.shape)} {q4.dtype}: {exc}")
    return name, ms


def phase_kernels_bwd(torch, device) -> dict:
    """The flash backward (csrc/flash_bwd.cu) against flash_bwd_reference on
    the card, from the plain forward's saved out and lse, at CHECK_SHAPES and
    the training shape, with and without an lse cotangent, in both dtypes;
    then its time beside the plain version's, the library backward's and
    the bound, at the slice and the training shapes."""
    import torch.nn.functional as F

    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.ops.flash_attention import (
        flash_bwd_reference,
        flash_fwd_reference,
    )

    gen = torch.Generator(device=device).manual_seed(SEED + 11)

    def inputs(shape, dtype):
        q, k, v, do = [(0.5 * torch.randn(shape, generator=gen, device=device)).to(dtype)
                       for _ in range(4)]
        out, lse = flash_fwd_reference(q, k, v, shape[-1] ** -0.5)
        return q, k, v, out, lse, do

    record = {}
    for name in BWD_KERNELS:
        dtype = getattr(torch, KERNELS[name][0])
        worst = 0.0
        for shape in CHECK_SHAPES + [TRAIN_SHAPE]:
            q, k, v, out, lse, do = inputs(shape, dtype)
            scale = shape[-1] ** -0.5
            for dlse in (None, torch.randn(shape[:2], generator=gen, device=device)):
                grads = _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale, dlse)
                plain = flash_bwd_reference(q, k, v, out, lse, do, scale, dlse)
                torch.cuda.synchronize()
                errs = [(g.float() - r.float()).abs().max().item() for g, r in zip(grads, plain)]
                atols = [bwd_atol(r) for r in plain]
                print(f"{name} {tuple(shape)} {'dlse' if dlse is not None else 'no dlse'}: "
                      f"max|d{{q,k,v}}-plain| {', '.join(f'{e:.3g}' for e in errs)} "
                      f"(atol {', '.join(f'{a:.3g}' for a in atols)})")
                if any(e > a for e, a in zip(errs, atols)):
                    fail(f"{name} disagrees with its plain version at {shape}")
                worst = max(worst, *errs)
                del grads, plain
            del q, k, v, out, lse, do
        torch.cuda.empty_cache()
        record[name] = {"max_abs_err": worst}
        # times, in turns: kernel, plain, library, kernel; the training shape last
        for shape in (SLICE_SHAPE, TRAIN_SHAPE):
            q, k, v, out, lse, do = inputs(shape, dtype)
            scale = shape[-1] ** -0.5
            ms_first = timed_ms(lambda: _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale))
            plain_ms = timed_ms(lambda: flash_bwd_reference(q, k, v, out, lse, do, scale), iters=3)
            library, library_ms = time_library_bwd(torch, F, q, k, v, do, scale)
            ms_second = timed_ms(lambda: _kernels.flash_bwd_cuda(q, k, v, out, lse, do, scale))
            ms = (ms_first + ms_second) / 2
            bound = bwd_bound(*shape, dtype)
            print(f"{name} {shape}: kernel {ms:.4f} ms ({ms_first:.4f}, {ms_second:.4f}), "
                  f"plain {plain_ms:.4f} ms, sdpa backward {library} {library_ms:.4f} ms, "
                  f"bound {bound['bound_ms']:.4f} ms ({bound['bound_by']}: "
                  f"{bound['gflop']:.1f} GFLOP, {bound['gbytes']:.3f} GB); achieved "
                  f"{bound['gflop'] / ms:.1f} TFLOP/s, {100 * bound['bound_ms'] / ms:.1f} % of bound")
            record[name].update(ms=ms, plain_ms=plain_ms, library_ms=library_ms, library=library,
                                **bound, shape=list(shape))
            del q, k, v, out, lse, do
            torch.cuda.empty_cache()
    return record


def slice_weights(rng: np.random.Generator) -> dict:
    """Random PatchTST weights in the flax layout (what ``state.npz``
    holds under ``…/params``): Dense kernels ``(in, out)`` at 1/sqrt(fan_in)."""
    d, h, ff, pl = SLICE["d_model"], SLICE["n_heads"], SLICE["ff_dim"], SLICE["patch_length"]
    n_patches = (LOOKBACK - pl) // SLICE["stride"] + 1

    def dense(shape_in, shape_out):
        fan_in = int(np.prod(shape_in))
        return {
            "kernel": (rng.normal(size=(*shape_in, *shape_out)) / np.sqrt(fan_in)).astype(np.float32),
            "bias": (0.01 * rng.normal(size=shape_out)).astype(np.float32),
        }

    def norm():
        return {"scale": (1 + 0.05 * rng.normal(size=d)).astype(np.float32),
                "bias": (0.05 * rng.normal(size=d)).astype(np.float32)}

    tree = {
        "Dense_0": dense((pl,), (d,)),
        "pos_embedding": (0.02 * rng.normal(size=(n_patches, d))).astype(np.float32),
    }
    for i in range(SLICE["n_layers"]):
        tree[f"TransformerEncoderLayer_{i}"] = {
            "LayerNorm_0": norm(),
            "MultiHeadSelfAttention_0": {
                "qkv": dense((d,), (3, h, d // h)),
                "out": dense((h, d // h), (d,)),
            },
            "LayerNorm_1": norm(),
            "Dense_0": dense((d,), (ff,)),
            "Dense_1": dense((ff,), (d,)),
        }
    tree["LayerNorm_0"] = norm()
    tree["Dense_1"] = dense((n_patches * d,), (1,))
    return tree


def sensor_rows(rng: np.random.Generator, n: int, tags: int = N_TAGS) -> np.ndarray:
    """Seeded plant-like signals: per-tag level and scale, slow drift, noise."""
    t = np.arange(n)[:, None]
    level = rng.uniform(-50, 150, size=tags)
    scale = rng.uniform(0.5, 20, size=tags)
    phase = rng.uniform(0, 2 * np.pi, size=tags)
    wave = np.sin(2 * np.pi * t / 720 + phase)
    return (level + scale * (wave + 0.3 * rng.normal(size=(n, tags)))).astype(np.float32)


def build_artifact(dest: str, device, compute_dtype: str = "float32", seed: int = SEED,
                   precision: str = None) -> list:
    """The slice machine with seeded weights and scalers, dumped by the port
    (at ``precision``: its metadata pins the rung, and at int8
    ``write_artifact_files`` writes the quantized sidecar)."""
    from gordo_components_tpu_torch.serializer import dump, pipeline_from_definition

    rng = np.random.default_rng(seed)
    definition = {
        "DiffBasedAnomalyDetector": {
            "base_estimator": {
                "TransformedTargetRegressor": {
                    "regressor": {
                        "Pipeline": {
                            "steps": [
                                "MinMaxScaler",
                                {"PatchTSTAutoEncoder": {
                                    "kind": "patchtst", "lookback_window": LOOKBACK,
                                    "attention_impl": "flash", "compute_dtype": compute_dtype,
                                    **SLICE,
                                }},
                            ]
                        }
                    },
                    "transformer": "MinMaxScaler",
                }
            }
        }
    }
    model = pipeline_from_definition(definition)
    ttr = model.base_estimator
    scaler, est = (step for _, step in ttr.regressor.steps)
    train = sensor_rows(rng, 4 * LOOKBACK)
    scaler.fit(train)
    ttr.transformer.fit(train)
    est.to(device)
    est.set_state({"params": slice_weights(rng), "n_features": N_TAGS,
                   "n_features_out": N_TAGS, "history": [], "fit_duration": None})
    # the error scaler and thresholds on residuals of the tail of the data
    tail = train[-(LOOKBACK + 127):]
    pred = model.predict(tail)
    residual = np.abs(tail[len(tail) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    tags = [f"TAG-{i:03d}" for i in range(N_TAGS)]
    dump(model, dest, metadata=artifact_metadata(tags, precision), precision=precision)
    return tags


def artifact_metadata(tags: list, precision: str = None) -> dict:
    metadata = {"dataset": {"tag_list": tags}}
    if precision is not None:
        metadata["precision"] = precision
    return metadata


def post(url: str, X: np.ndarray) -> tuple:
    """POST ``{"X": rows}``; returns (HTTP status, payload, wall ms)."""
    return post_body(url, json.dumps({"X": X.tolist()}).encode())


def http(method: str, url: str, body: bytes = None, headers: dict = None) -> tuple:
    """One HTTP request; returns (status, response headers, body bytes,
    wall ms)."""
    req = urllib.request.Request(url, data=body, method=method, headers={
        "Content-Type": "application/json", **(headers or {})})
    t0 = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=300) as resp:
            status, reply, raw = resp.status, dict(resp.headers), resp.read()
    except urllib.error.HTTPError as exc:
        status, reply, raw = exc.code, dict(exc.headers), exc.read()
    return status, reply, raw, (time.perf_counter() - t0) * 1e3


def decode(reply: dict, raw: bytes) -> dict:
    """A scoring response's payload, from JSON or from the npz wire format
    (its arrays then numpy arrays)."""
    from gordo_components_tpu_torch import wire

    if wire.content_type_of(reply.get("Content-Type")) == wire.NPZ_CONTENT_TYPE:
        return wire.payload_from_npz(raw)
    return json.loads(raw)


def post_body(url: str, body: bytes, npz: bool = False) -> tuple:
    """POST an encoded JSON body, asking for the npz wire format if ``npz``;
    returns (HTTP status, payload, wall ms)."""
    from gordo_components_tpu_torch import wire

    headers = {"Accept": wire.NPZ_CONTENT_TYPE} if npz else None
    status, reply, raw, ms = http("POST", url, body, headers)
    return status, decode(reply, raw), ms


def serve(artifact: str, device, windows, rng) -> list:
    """POST one request of each window count to the port's HTTP server on
    the card, one at a time. The launch counts are zeroed just before the
    first request and read after each; returns (X, payload, launches by
    kernel, engine dispatches) per request."""
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.server.server import make_server

    httpd = make_server(artifact, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           f"/gordo/v0/project/{os.path.basename(artifact)}/anomaly/prediction")
    engine = httpd.model_server.engine
    results = []
    try:
        _kernels.reset_launches()
        for w in windows:
            X = sensor_rows(rng, LOOKBACK + w - 1)
            before = dict(_kernels.LAUNCHES)
            dispatches = engine.stats()["dispatches"]
            status, payload, ms = post(url, X)
            launches = {n: _kernels.LAUNCHES[n] - before[n] for n in KERNELS}
            dispatches = engine.stats()["dispatches"] - dispatches
            print(f"POST W={w} ({len(X)} rows): HTTP {status}, {ms:.1f} ms, "
                  f"{dispatches} dispatch(es), launches {launches}")
            if status != 200:
                fail(f"HTTP {status} for W={w}")
            results.append((X, payload, launches, dispatches))
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    return results


def compare_arrays(label: str, w: int, data: dict, plain: dict, rtol: float,
                   tags: int = N_TAGS) -> float:
    """The four score arrays (``w`` rows of ``tags``) against another
    scoring of the same rows: shapes, finiteness, and the worst difference
    relative to each array's magnitude."""
    expected = {"model-input": (w, tags), "model-output": (w, tags),
                "tag-anomaly-scores": (w, tags), "total-anomaly-score": (w,)}
    worst = 0.0
    for field, shape in expected.items():
        got = np.asarray(data[field], np.float64)
        if got.shape != shape or not np.isfinite(got).all():
            fail(f"{label} W={w}: {field} has shape {got.shape} (want {shape}) or non-finite values")
        ref = plain[field].astype(np.float64)
        rel = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
        worst = max(worst, rel)
        if rel > rtol:
            fail(f"{label} W={w}: {field} differs by {rel:.3g} (relative, limit {rtol})")
    return worst


def compare_scores(label: str, w: int, payload: dict, plain: dict, rtol: float,
                   tags: int = N_TAGS) -> float:
    """A response's score arrays against ``plain`` (:func:`compare_arrays`),
    and its thresholds."""
    worst = compare_arrays(label, w, payload["data"], plain, rtol, tags)
    if len(payload["tag-thresholds"]) != tags:
        fail("thresholds missing from the response")
    return worst


def phase_serve(torch, device, tmp: str) -> dict:
    """The main path in float32: the slice machine served over HTTP; each
    dispatch (one per lone request) launches the fp32 kernel once per layer,
    and each response matches the CPU plain path."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    artifact = os.path.join(tmp, "turbine-long-window")
    started = time.perf_counter()
    build_artifact(artifact, device)
    print(f"artifact written in {time.perf_counter() - started:.1f} s: {sorted(os.listdir(artifact))}")
    results = serve(artifact, device, WINDOWS, np.random.default_rng(SEED + 1))
    per_request = [r[2]["flash_fwd_f32"] for r in results]
    if any(r[3] != 1 for r in results) or any(n != SLICE["n_layers"] for n in per_request) or any(
            r[2][n] for r in results for n in ("flash_fwd_bf16", *BWD_KERNELS)):
        fail(f"fp32 kernel launches per request {per_request} in dispatches "
             f"{[r[3] for r in results]}: expected one dispatch of {SLICE['n_layers']} "
             "launches each and no bf16 launch")

    cpu_engine = ServingEngine({"m": load(artifact, device="cpu")}, device="cpu")
    for w, (X, payload, _, _) in zip(WINDOWS, results):
        started = time.perf_counter()
        plain = dict(zip(wire.SCORE_FIELDS, cpu_engine.anomaly("m", X)))
        cpu_s = time.perf_counter() - started
        worst = compare_scores("fp32", w, payload, plain, SERVE_RTOL)
        print(f"W={w}: card vs CPU plain path, worst relative difference {worst:.3g} "
              f"(limit {SERVE_RTOL}); CPU scoring took {cpu_s:.1f} s")
    return {n: sum(r[2][n] for r in results) for n in KERNELS}


def phase_serve_bf16(torch, device, tmp: str) -> dict:
    """The bf16 path: the same slice machine built with compute_dtype
    bfloat16, one W = 16 request over HTTP; it launches the bf16 kernel once
    per layer (and the fp32 kernel never) and matches the same artifact
    scored on the card with dense attention in bf16."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.models.factories.transformer import MultiHeadSelfAttention
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine

    artifact = os.path.join(tmp, "turbine-long-window-bf16")
    build_artifact(artifact, device, compute_dtype="bfloat16")
    w = 16
    [(X, payload, launches, _)] = serve(artifact, device, (w,), np.random.default_rng(SEED + 3))
    if launches != {**NO_LAUNCHES, "flash_fwd_bf16": SLICE["n_layers"]}:
        fail(f"bf16 request launched {launches}, expected {SLICE['n_layers']} bf16 launches only")
    dense = load(artifact, device=device)
    est = dense.base_estimator.regressor.steps[-1][1]
    for module in est.module_.modules():
        if isinstance(module, MultiHeadSelfAttention):
            module.attention_impl = "dense"
    plain = dict(zip(wire.SCORE_FIELDS,
                     ServingEngine({"m": dense}, device=device).anomaly("m", X)))
    worst = compare_scores("bf16", w, payload, plain, BF16_SERVE_RTOL)
    print(f"bf16 W={w}: flash kernel vs dense attention on the card, worst relative "
          f"difference {worst:.3g} (limit {BF16_SERVE_RTOL})")
    return launches


# phase 4: the reference's model zoo at the widths of its own configs.
# name -> (estimator, estimator kwargs, tags); bench.py:122-173 for the
# 10/50/100-tag machines, the factory defaults for the other two
ZOO = {
    "dense-ae-10tag": ("DenseAutoEncoder", dict(kind="feedforward_hourglass"), 10),
    "dense-ae-default": ("DenseAutoEncoder", dict(kind="feedforward_model"), 100),
    "lstm-ae-50tag": ("LSTMAutoEncoder", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24), 50),
    "lstm-forecast-100tag": ("LSTMForecast", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24, horizon=3), 100),
    "lstm-model-default": ("LSTMAutoEncoder", dict(kind="lstm_model", lookback_window=24), 50),
    "lstm-ae-50tag-bf16": ("LSTMAutoEncoder", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24, compute_dtype="bfloat16"), 50),
    "multi-step-forecast": ("MultiStepForecast", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24, horizon=3), 50),
}
ZOO_ROWS = (144, 1008, 144, 1008)  # a day and a week at 10-minute resolution, twice


def zoo_weights(config: dict, rng: np.random.Generator) -> dict:
    """Random weights in the flax layout of a dense or LSTM factory's
    ``config``: Dense kernels ``(in, out)`` at 1/sqrt(fan_in); LSTM cells
    ``OptimizedLSTMCell_i/{ii,if,ig,io}`` (input kernels, no bias) and
    ``{hi,hf,hg,ho}`` (recurrent kernels with bias), head ``Dense_0``."""

    def kernel(n_in, n_out):
        return (rng.normal(size=(n_in, n_out)) / np.sqrt(n_in)).astype(np.float32)

    def dense(n_in, n_out):
        return {"kernel": kernel(n_in, n_out),
                "bias": (0.01 * rng.normal(size=n_out)).astype(np.float32)}

    if "units" in config:
        widths = [config["n_features"], *config["units"]]
        tree = {}
        for i, (n_in, units) in enumerate(zip(widths[:-1], widths[1:])):
            cell = {}
            for gate in "ifgo":
                cell[f"i{gate}"] = {"kernel": kernel(n_in, units)}
                cell[f"h{gate}"] = dense(units, units)
            tree[f"OptimizedLSTMCell_{i}"] = cell
        tree["Dense_0"] = dense(widths[-1], config["n_features_out"])
        return tree
    dims = [config["n_features"], *config["encoding_dim"], *config["decoding_dim"],
            config["n_features_out"]]
    return {f"Dense_{i}": dense(n_in, n_out)
            for i, (n_in, n_out) in enumerate(zip(dims[:-1], dims[1:]))}


def build_zoo_artifact(dest: str, estimator: str, kwargs: dict, tags: int, device,
                       rng: np.random.Generator, precision: str = None) -> None:
    """A DiffBasedAnomalyDetector / TransformedTargetRegressor / MinMaxScaler
    pipeline around ``estimator`` (as bench.py builds them), scalers fitted
    on seeded rows, seeded weights, the error scaler and thresholds on the
    residuals of the training tail (not for a joint forecaster, which emits
    horizon x F values per window), dumped by the port."""
    from gordo_components_tpu_torch.serializer import dump, pipeline_from_definition

    model = pipeline_from_definition({"DiffBasedAnomalyDetector": {"base_estimator": {
        "TransformedTargetRegressor": {
            "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
            "transformer": "MinMaxScaler",
        }}}})
    ttr = model.base_estimator
    scaler, est = (step for _, step in ttr.regressor.steps)
    train = sensor_rows(rng, 2016, tags)
    scaler.fit(train)
    ttr.transformer.fit(train)
    config = est._make_spec(tags, tags).config  # the joint forecaster's head is widened
    est.to(device).set_state({"params": zoo_weights(config, rng), "n_features": tags,
                              "n_features_out": tags})
    if not getattr(est, "joint_horizon", False):
        tail = train[-1008:]
        pred = model.predict(tail)
        residual = np.abs(tail[len(tail) - len(pred):] - pred)
        model.scaler.fit(residual)
        scaled = model.scaler.transform(residual)
        model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
        model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    dump(model, dest, precision=precision, metadata=artifact_metadata(
        [f"TAG-{i:03d}" for i in range(tags)], precision))


def kernel_label(key: str) -> str:
    """A profiler kernel name made short and readable: the kernel's own name
    and, for PyTorch's elementwise kernels, the functor it applies."""
    key = key.removeprefix("void ").replace("(anonymous namespace)::", "")
    name = key.split("<", 1)[0].split("(", 1)[0].split("::")[-1]
    if name in ("Kernel", "Kernel2") and "<" in key:  # CUTLASS's wrapper: name its GEMM
        name = key.split("<", 1)[1].split(">", 1)[0].split(",", 1)[0].split("::")[-1].split("<")[0]
    ops = re.findall(r"\w*Functor\w*|\w+_kernel_cuda", key)
    return f"{name}[{ops[-1]}]" if ops else name[:80]


def profile_request(torch, engine, name: str, X: np.ndarray) -> dict:
    """One warm request under torch.profiler: device time summed by kernel,
    the kernels launched and the device's idle share of the traced wall."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    engine.anomaly(name, X)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        engine.anomaly(name, X)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    events = [evt for evt in prof.key_averages()
              if evt.device_type == DeviceType.CUDA and evt.self_device_time_total]
    kernels = [evt for evt in events if not evt.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(evt.self_device_time_total for evt in events) / 1e3
    by_kernel = sorted(((kernel_label(evt.key), evt.self_device_time_total / 1e3, evt.count)
                        for evt in kernels), key=lambda row: -row[1])
    host_launches = sum(evt.count for evt in prof.key_averages()
                        if evt.key in ("cudaLaunchKernel", "cuLaunchKernel"))
    return {"machine": name, "rows": len(X), "traced_ms": traced_ms,
            "device_busy_ms": busy_ms, "device_idle_share": 1 - busy_ms / traced_ms,
            "kernel_launches": sum(evt.count for evt in kernels),
            "host_launch_calls": host_launches,
            "device_ms_by_kernel": [{"kernel": k, "ms": ms, "launches": n}
                                    for k, ms, n in by_kernel[:8]]}


def phase_zoo(torch, device, tmp: str) -> None:
    """The dense and LSTM machines served by one HTTP server on the card,
    each request against the CPU plain path and launching no flash kernel;
    the joint forecaster skipped with a 503; one dense machine at the bf16
    rung; two requests traced."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "zoo")
    rng = np.random.default_rng(SEED + 4)
    started = time.perf_counter()
    for name, (estimator, kwargs, tags) in ZOO.items():
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device, rng)
    print(f"zoo: {len(ZOO)} artifacts written in {time.perf_counter() - started:.1f} s")

    httpd = make_server(models_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    requests = []  # (machine, X, status, payload, ms)
    try:
        with urllib.request.urlopen(base + "/healthz", timeout=60) as resp:
            skipped = json.loads(resp.read())["skipped"]
        if sorted(skipped) != ["multi-step-forecast"]:
            fail(f"zoo: /healthz skipped {sorted(skipped)}, expected the joint forecaster only")
        print(f"zoo: /healthz skips multi-step-forecast: {skipped['multi-step-forecast']}")
        _kernels.reset_launches()
        for name, (_, _, tags) in ZOO.items():
            url = f"{base}/gordo/v0/project/{name}/anomaly/prediction"
            for rows in ZOO_ROWS:
                X = sensor_rows(rng, rows, tags)
                status, payload, ms = post(url, X)
                print(f"zoo POST {name} {rows} rows: HTTP {status}, {ms:.2f} ms")
                requests.append((name, X, status, payload, ms))
        launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
        engine = httpd.model_server.engine
        traces = [profile_request(torch, engine, name, sensor_rows(rng, 1008, ZOO[name][2]))
                  for name in ("lstm-ae-50tag", "dense-ae-default")]
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if any(launches.values()):
        fail(f"zoo requests launched flash kernels: {launches}")
    print(f"zoo: flash launches over {len(requests)} requests: {launches}")

    cpu_engines = {}
    for name, X, status, payload, ms in requests:
        if name == "multi-step-forecast":
            if status != 503:
                fail(f"zoo: the joint forecaster answered HTTP {status}, expected 503")
            continue
        if status != 200:
            fail(f"zoo: {name} answered HTTP {status}: {payload}")
        if name not in cpu_engines:
            cpu_engines[name] = ServingEngine(
                {name: load(os.path.join(models_dir, name), device="cpu")}, device="cpu")
        plain = dict(zip(wire.SCORE_FIELDS, cpu_engines[name].anomaly(name, X)))
        rtol = BF16_SERVE_RTOL if name.endswith("bf16") else SERVE_RTOL
        rows = len(plain["total-anomaly-score"])
        worst = compare_scores(f"zoo {name}", rows, payload, plain, rtol, tags=X.shape[1])
        print(f"zoo {name} {len(X)} rows ({rows} scored): card vs CPU plain path, worst "
              f"relative difference {worst:.3g} (limit {rtol})")

    # the engine's bf16 rung: bf16 weights and inputs, float32 architecture
    name, tags = "dense-ae-default", ZOO["dense-ae-default"][2]
    X = sensor_rows(rng, 1008, tags)
    artifact = os.path.join(models_dir, name)
    scored = [dict(zip(wire.SCORE_FIELDS, ServingEngine(
        {name: load(artifact, device=where)}, precisions={name: "bf16"}, device=where,
    ).anomaly(name, X))) for where in (device, "cpu")]
    worst = compare_arrays(f"zoo {name} bf16 rung", len(X), scored[0], scored[1],
                           BF16_SERVE_RTOL, tags=tags)
    print(f"zoo {name} at the bf16 rung, 1008 rows: card vs CPU at the same rung, worst "
          f"relative difference {worst:.3g} (limit {BF16_SERVE_RTOL})")
    for trace in traces:
        print(f"zoo profile: {json.dumps(trace)}")


# phase 5: fleets of one architecture each, all served by one HTTP server.
# name -> (machines, estimator, estimator kwargs, tags, rows per request,
# client threads, requests per thread in each round). Widths: the dense
# machine of bench_serving.py:248-307 at its 10 tags, the LSTM AE of
# bench.py's lstm_ae_50tag at its 32 machines, the slice machine.
FLEETS = {
    "dense": (100, "DenseAutoEncoder", dict(kind="feedforward_hourglass"), 10, 144, 12, 10),
    "lstm": (32, "LSTMAutoEncoder", dict(
        kind="lstm_symmetric", dims=[32], lookback_window=24), 50, 144, 8, 8),
    "patchtst": (4, "PatchTSTAutoEncoder", None, N_TAGS, LOOKBACK + 15, 4, 2),
}
FLEET_ROUNDS = 3
# a fused PatchTST dispatch against the same request served alone on the
# card: float32 both, the same kernels, but batched GEMMs (k machines in one
# cuBLAS call) sum in another order than single ones (~1e-7 relative per
# product); a request scored with another machine's weights or rows is O(1)
FUSED_RTOL = 1e-5
# device memory the fleet server may hold past its stacked trees: the warmup
# left 0.9 MiB on an H100, and a second copy of one full-width PatchTST
# machine (3 layers of 2.1 M float32 weights) would add about 24 MiB
HELD_SLACK = 8 * 2**20


def build_fleet(models_dir: str, device) -> dict:
    """Every fleet's artifacts under ``models_dir``, distinct seeded weights
    per machine; returns {fleet: [machine names]}."""
    names = {}
    for f, (fleet, (count, estimator, kwargs, tags, *_)) in enumerate(FLEETS.items()):
        names[fleet] = [f"{fleet}-{i:03d}" for i in range(count)]
        for i, name in enumerate(names[fleet]):
            dest, seed = os.path.join(models_dir, name), SEED + 1000 * (f + 1) + i
            if fleet == "patchtst":
                build_artifact(dest, device, seed=seed)
            else:
                build_zoo_artifact(dest, estimator, kwargs, tags, device,
                                   np.random.default_rng(seed))
    return names


def drive_fleet(base: str, fleet: str, names: list, rng, npz: bool = False) -> tuple:
    """FLEET_ROUNDS timed rounds of concurrent clients spread over the
    fleet's machines (client t's i-th request goes to machine t + i·threads,
    shifted each round). The bodies are encoded before a round, and the
    clients start it together; with ``npz`` they ask for the npz wire
    format. Returns ([(machine, X, payload)], round records)."""
    _, _, _, tags, rows, threads, per_thread = FLEETS[fleet]
    responses, rounds = [], []
    for r in range(FLEET_ROUNDS):
        plan = [[(names[(t + i * threads + r * threads * per_thread) % len(names)],
                  sensor_rows(rng, rows, tags)) for i in range(per_thread)]
                for t in range(threads)]
        bodies = [[json.dumps({"X": X.tolist()}).encode() for _, X in per_client]
                  for per_client in plan]
        out = [[] for _ in range(threads)]
        errors = []
        start = threading.Barrier(threads + 1)

        def client(t):
            try:
                start.wait(timeout=60)
                for (name, X), body in zip(plan[t], bodies[t]):
                    status, payload, ms = post_body(
                        f"{base}/gordo/v0/project/{name}/anomaly/prediction", body, npz)
                    if status != 200:
                        raise RuntimeError(f"{name}: HTTP {status}: {payload}")
                    out[t].append((name, X, payload, ms))
            except Exception as exc:  # noqa: BLE001 - reported below, fails the phase
                errors.append(exc)

        workers = [threading.Thread(target=client, args=(t,)) for t in range(threads)]
        for w in workers:
            w.start()
        start.wait(timeout=60)
        started = time.perf_counter()
        for w in workers:
            w.join(timeout=600)
        wall = time.perf_counter() - started
        if errors or any(w.is_alive() for w in workers):
            fail(f"fleet {fleet} round {r}: {errors[:3] or 'a client did not finish'}")
        done = [entry for per_client in out for entry in per_client]
        lat = np.asarray([entry[3] for entry in done])
        rounds.append({"round": r, "wire": "npz" if npz else "json",
                       "requests": len(done), "wall_s": wall,
                       "req_per_s": len(done) / wall, "p50_ms": float(np.percentile(lat, 50)),
                       "p99_ms": float(np.percentile(lat, 99))})
        print(f"fleet {fleet} round {r}: {json.dumps(rounds[-1])}")
        responses += [entry[:3] for entry in done]
    return responses, rounds


def bucket_counts(engine, name: str) -> dict:
    bucket, _ = engine._by_name[name]
    return {"dispatches": bucket.dispatch_count, "requests": bucket.request_count,
            "fallback_cold": bucket.fallback_cold_count,
            "retry_isolated": bucket.retry_isolated_count}


def profile_fused(torch, engine, names: list, Xs: list) -> dict:
    """One fused dispatch of ``len(names)`` requests for distinct machines,
    under torch.profiler: kernels launched and the device's idle share of
    the traced wall (dispatch to results on the host)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gordo_components_tpu_torch.server.engine import _Item

    bucket, _ = engine._by_name[names[0]]

    def dispatch():
        items = []
        for name, X in zip(names, Xs):
            x, m_valid = engine._prepare(bucket, X)
            items.append(_Item(engine._by_name[name][1], x, m_valid))
        bucket._dispatch(items[0].x.shape[0], items, defer=False)
        for it in items:
            if not it.done.wait(600) or it.error is not None:
                fail(f"fused profile dispatch failed: {it.error}")

    before = bucket.dispatch_count
    dispatch()  # warm at this batch size
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        dispatch()
        traced_ms = (time.perf_counter() - t0) * 1e3
    if bucket.dispatch_count != before + 2 or bucket.max_batch_seen < len(names):
        fail("the profiled requests did not share one dispatch")
    events = [evt for evt in prof.key_averages()
              if evt.device_type == DeviceType.CUDA and evt.self_device_time_total]
    kernels = [evt for evt in events if not evt.key.startswith(("Memcpy", "Memset"))]
    busy_ms = sum(evt.self_device_time_total for evt in events) / 1e3
    return {"machines": len(names), "traced_ms": traced_ms, "device_busy_ms": busy_ms,
            "device_idle_share": 1 - busy_ms / traced_ms,
            "kernel_launches": sum(evt.count for evt in kernels)}


def phase_fleet(torch, device, tmp: str) -> dict:
    """The stacked engine's fleets: 100 dense, 32 LSTM and 4 full-width
    PatchTST machines dumped into one directory and served by one HTTP
    server; each fleet's concurrent clients in FLEET_ROUNDS timed rounds.
    Dense and LSTM responses against the CPU plain path; PatchTST responses
    against the same request served alone on the card, one against the
    CPU; fused dispatches (fusion ratio > 1) in every fleet, no fused-path
    repair, and the fp32 flash kernel launched once per layer per PatchTST
    dispatch. Returns the phase's flash launches."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.models.analysis import analyze_model
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "fleet")
    started = time.perf_counter()
    names = build_fleet(models_dir, device)
    print(f"fleet: {sum(map(len, names.values()))} artifacts written in "
          f"{time.perf_counter() - started:.1f} s")
    started = time.perf_counter()
    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    httpd = make_server(models_dir, port=0, device=device)
    held = torch.cuda.memory_allocated() - allocated
    stacked = sum(b.stacked_nbytes() for b in httpd.model_server.engine._buckets)
    print(f"fleet: server loaded, stacked and warmed up in {time.perf_counter() - started:.1f} s; "
          f"device memory held {held / 2**20:.1f} MiB, stacked trees {stacked / 2**20:.1f} MiB")
    # one copy of the weights: every loaded machine's own weights stay on the
    # host, and the card holds the stacked trees plus what the warmup left
    on_card = [name for name, machine in httpd.model_server.machines.items()
               if any(t.is_cuda for t in analyze_model(
                   machine.model).estimator.module_.state_dict().values())]
    if on_card or held > stacked + HELD_SLACK:
        httpd.server_close()
        fail(f"fleet: the server holds {held} bytes on the card for {stacked} stacked bytes; "
             f"machines with weights on the card: {on_card[:5]}")
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    engine = httpd.model_server.engine
    rng = np.random.default_rng(SEED + 5)
    results, launches = {}, {}
    try:
        stats = engine.stats()
        if stats["buckets"] != len(FLEETS) or stats["machines"] != sum(map(len, names.values())):
            fail(f"fleet: {stats['machines']} machines in {stats['buckets']} buckets")
        for fleet, fleet_names in names.items():
            before = bucket_counts(engine, fleet_names[0])
            _kernels.reset_launches()
            responses, rounds = drive_fleet(base, fleet, fleet_names, rng)
            engine.quiesce()
            if fleet == "patchtst":
                launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
            after = bucket_counts(engine, fleet_names[0])
            delta = {key: after[key] - before[key] for key in after}
            k = FLEETS[fleet][5]
            Xs = [sensor_rows(rng, FLEETS[fleet][4], FLEETS[fleet][3]) for _ in range(k)]
            trace = profile_fused(torch, engine, fleet_names[:k], Xs)
            results[fleet] = {"responses": responses, "rounds": rounds, "counts": delta,
                              "trace": trace}
        # the dense fleet again, its clients asking for the npz wire format
        npz_responses, npz_rounds = drive_fleet(base, "dense", names["dense"], rng, npz=True)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)

    for fleet, result in results.items():
        delta = result["counts"]
        ratio = delta["requests"] / delta["dispatches"] if delta["dispatches"] else 0
        summary = {"fleet": fleet, "machines": len(names[fleet]), "counts": delta,
                   "fusion_ratio": ratio, "rounds": result["rounds"],
                   "fused_dispatch_trace": result["trace"]}
        print(f"fleet summary: {json.dumps(summary)}")
        if delta["fallback_cold"] or delta["retry_isolated"]:
            fail(f"fleet {fleet}: fused-path repairs counted: {delta}")
        if not ratio > 1:
            fail(f"fleet {fleet}: fusion ratio {ratio} ({delta['dispatches']} dispatches)")
        if delta["requests"] != len(result["responses"]):
            fail(f"fleet {fleet}: {delta['requests']} requests scored for "
                 f"{len(result['responses'])} responses")

    # dense and LSTM responses against the CPU plain path
    cpu = ServingEngine({name: load(os.path.join(models_dir, name), device="cpu")
                         for fleet in ("dense", "lstm") for name in names[fleet]}, device="cpu")
    results["dense-npz"] = {"responses": npz_responses}
    for fleet in ("dense", "lstm", "dense-npz"):
        worst = 0.0
        for name, X, payload in results[fleet]["responses"]:
            plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
            rows = len(plain["total-anomaly-score"])
            worst = max(worst, compare_scores(f"fleet {fleet} {name}", rows, payload, plain,
                                              SERVE_RTOL, tags=X.shape[1]))
        print(f"fleet {fleet}: {len(results[fleet]['responses'])} responses vs the CPU plain "
              f"path, worst relative difference {worst:.3g} (limit {SERVE_RTOL})")
    cpu.close()
    json_rounds = results["dense"]["rounds"]
    print("fleet dense, JSON vs npz wire format: " + json.dumps({
        wire_format: {key: [r[key] for r in rounds] for key in ("req_per_s", "p50_ms", "p99_ms")}
        for wire_format, rounds in (("json", json_rounds), ("npz", npz_rounds))}))

    # PatchTST: every response against the same request alone on the card
    responses = results["patchtst"]["responses"]
    dispatches = results["patchtst"]["counts"]["dispatches"]
    if not (launches["flash_fwd_f32"] == SLICE["n_layers"] * dispatches
            < SLICE["n_layers"] * len(responses)) or launches["flash_fwd_bf16"] or any(
                launches[n] for n in BWD_KERNELS):
        fail(f"fleet patchtst: flash launches {launches} for {dispatches} dispatches of "
             f"{len(responses)} requests")
    print(f"fleet patchtst: flash launches {launches} = {SLICE['n_layers']} x {dispatches} "
          f"dispatches for {len(responses)} requests")
    worst = 0.0
    for name, X, payload in responses:
        alone = dict(zip(wire.SCORE_FIELDS, engine.anomaly(name, X)))
        worst = max(worst, compare_scores(f"fleet patchtst {name}", len(alone["model-output"]),
                                          payload, alone, FUSED_RTOL, tags=X.shape[1]))
    print(f"fleet patchtst: {len(responses)} fused responses vs the same request alone on the "
          f"card, worst relative difference {worst:.3g} (limit {FUSED_RTOL})")
    name, X, payload = responses[0]
    cpu = ServingEngine({name: load(os.path.join(models_dir, name), device="cpu")}, device="cpu")
    plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
    worst = compare_scores(f"fleet patchtst {name} vs CPU", len(plain["model-output"]),
                           payload, plain, SERVE_RTOL, tags=X.shape[1])
    print(f"fleet patchtst {name}: fused response vs the CPU plain path, worst relative "
          f"difference {worst:.3g} (limit {SERVE_RTOL})")
    cpu.close()
    return launches


# phase 6: the int8 rung. The slice machine and the four PatchTST fleet
# machines (other seeds) share one bucket; two zoo machines beside them.
INT8_ZOO = ("dense-ae-default", "lstm-ae-50tag")
INT8_FLEET = [f"patchtst-int8-{i}" for i in range(4)]


def dequantize_profile(torch, bucket) -> dict:
    """The dequantize pass of one machine of an int8 bucket alone, as the
    program runs it (``q.float() * scale`` per parameter): its kernels
    under torch.profiler and its time by CUDA events."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    params = {key: q[0] for key, q in bucket.stacked["params"].items()}
    scales = {key: s[0] for key, s in bucket.stacked["params_scale"].items()}

    def dequantize():
        return {key: q.to(torch.float32) * scales[key] for key, q in params.items()}

    ms = timed_ms(dequantize)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        dequantize()
        torch.cuda.synchronize()
    kernels = [evt for evt in prof.key_averages()
               if evt.device_type == DeviceType.CUDA and evt.self_device_time_total]
    return {"weights": sum(q.numel() for q in params.values()), "tensors": len(params),
            "ms": ms, "kernel_launches": sum(evt.count for evt in kernels),
            "device_ms": sum(evt.self_device_time_total for evt in kernels) / 1e3}


def concurrent_posts(urls_and_bodies: list) -> list:
    """POST each (url, body) from its own thread, all started together;
    returns (status, payload, ms) in order."""
    out = [None] * len(urls_and_bodies)
    start = threading.Barrier(len(urls_and_bodies))

    def client(i, url, body):
        start.wait(timeout=60)
        out[i] = post_body(url, body)

    workers = [threading.Thread(target=client, args=(i, *pair))
               for i, pair in enumerate(urls_and_bodies)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=600)
    if any(w.is_alive() for w in workers) or any(r is None for r in out):
        fail("a concurrent client did not finish")
    return out


def phase_int8(torch, device, tmp: str) -> dict:
    """The int8 rung on the card: the slice machine (W = 1 and W = 16 lone
    requests), two zoo machines (1008 rows) and the four-machine PatchTST
    fleet (a concurrent W = 16 round over HTTP, then one fused dispatch of
    4), every artifact written by the port with its int8 sidecar and served
    by one HTTP server. Every response matches the same artifact at int8 on
    the CPU plain path within SERVE_RTOL, and the same weights served at
    f32 on the card within the int8 parity budget; the stacked weights are
    int8 on the card; the fp32 flash kernel launches once per layer per
    PatchTST dispatch. Returns the phase's flash launches."""
    from gordo_components_tpu_torch import precision, wire
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine, _Item
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "int8")
    rng = np.random.default_rng(SEED + 6)
    started = time.perf_counter()
    build_artifact(os.path.join(models_dir, "slice-int8"), device, precision="int8")
    for i, name in enumerate(INT8_FLEET):
        build_artifact(os.path.join(models_dir, name), device, seed=SEED + 3000 + i,
                       precision="int8")
    for name in INT8_ZOO:
        estimator, kwargs, tags = ZOO[name]
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device, rng,
                           precision="int8")
    names = sorted(os.listdir(models_dir))
    missing = [n for n in names
               if precision.QUANT_INT8_FILE not in os.listdir(os.path.join(models_dir, n))]
    if missing:
        fail(f"int8: artifacts without {precision.QUANT_INT8_FILE}: {missing}")
    print(f"int8: {len(names)} artifacts with {precision.QUANT_INT8_FILE} written in "
          f"{time.perf_counter() - started:.1f} s")

    torch.cuda.synchronize()
    allocated = torch.cuda.memory_allocated()
    httpd = make_server(models_dir, port=0, device=device)
    held = torch.cuda.memory_allocated() - allocated
    app = httpd.model_server
    engine = app.engine
    for bucket in engine._buckets:
        leaves = list(bucket.stacked["params"].values())
        if bucket.precision != "int8" or not all(
                t.dtype == torch.int8 and t.device.type == device.type for t in leaves):
            fail(f"int8: bucket {bucket.names} at {bucket.precision} holds "
                 f"{sorted({(str(t.dtype), t.device.type) for t in leaves})}")
    f32 = ServingEngine({name: m.model for name, m in app.machines.items()},
                        precisions={name: "f32" for name in app.machines}, device=device)
    nbytes = {rung: {b.names[0] if len(b.names) == 1 else "patchtst": b.stacked_nbytes()
                     for b in e._buckets} for rung, e in (("int8", engine), ("f32", f32))}
    print(f"int8: stacked trees {json.dumps(nbytes)}; int8 / f32 = "
          f"{sum(nbytes['int8'].values()) / sum(nbytes['f32'].values()):.4f}; device memory "
          f"held by the int8 server after boot {held / 2**20:.1f} MiB")
    per_machine = nbytes["int8"]["patchtst"] / (1 + len(INT8_FLEET))
    print(f"int8: one full-width PatchTST machine {per_machine / 2**20:.2f} MiB at int8, "
          f"{nbytes['f32']['patchtst'] / (1 + len(INT8_FLEET)) / 2**20:.2f} MiB at f32")

    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}/gordo/v0/project"
    slice_bucket = engine._by_name["slice-int8"][0]
    served = []  # (label, machine, X, scored arrays)
    try:
        _kernels.reset_launches()
        before = slice_bucket.dispatch_count
        lone = [("slice-int8", LOOKBACK + w - 1, N_TAGS) for w in (1, 16)]
        lone += [(name, 1008, ZOO[name][2]) for name in INT8_ZOO]
        for name, rows, tags in lone:
            X = sensor_rows(rng, rows, tags)
            status, payload, ms = post(f"{base}/{name}/anomaly/prediction", X)
            print(f"int8 POST {name} {rows} rows: HTTP {status}, {ms:.1f} ms")
            if status != 200:
                fail(f"int8: {name} answered HTTP {status}: {payload}")
            served.append(("lone", name, X, payload["data"]))
        fleet_X = [sensor_rows(rng, LOOKBACK + 15, N_TAGS) for _ in INT8_FLEET]
        replies = concurrent_posts([
            (f"{base}/{name}/anomaly/prediction", json.dumps({"X": X.tolist()}).encode())
            for name, X in zip(INT8_FLEET, fleet_X)])
        for name, X, (status, payload, ms) in zip(INT8_FLEET, fleet_X, replies):
            print(f"int8 fleet POST {name} W=16: HTTP {status}, {ms:.1f} ms")
            if status != 200:
                fail(f"int8: {name} answered HTTP {status}: {payload}")
            served.append(("fleet", name, X, payload["data"]))
        round_dispatches = slice_bucket.dispatch_count - before
        # one fused dispatch of the four machines
        items = []
        for name, X in zip(INT8_FLEET, fleet_X):
            x, m_valid = engine._prepare(slice_bucket, X)
            items.append(_Item(engine._by_name[name][1], x, m_valid))
        slice_bucket._dispatch(items[0].x.shape[0], items, defer=False)
        for name, X, it in zip(INT8_FLEET, fleet_X, items):
            if not it.done.wait(600) or it.error is not None:
                fail(f"int8: fused dispatch failed: {it.error}")
            served.append(("fused", name, X, dict(zip(wire.SCORE_FIELDS, it.result))))
        dispatches = slice_bucket.dispatch_count - before
        launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
        if slice_bucket.max_batch_seen < len(INT8_FLEET):
            fail("int8: the fused dispatch of the fleet did not hold all four requests")
        X16 = served[1][2]
        trace_int8 = profile_request(torch, engine, "slice-int8", X16)
        trace_f32 = profile_request(torch, f32, "slice-int8", X16)
        dequant = dequantize_profile(torch, slice_bucket)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    print(f"int8: {dispatches} PatchTST dispatches ({round_dispatches} for the concurrent "
          f"round of {len(INT8_FLEET)}, then 1 fused), flash launches {launches}")
    if launches != {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"] * dispatches}:
        fail(f"int8: flash launches {launches} for {dispatches} PatchTST dispatches")
    print(f"int8 profile W=16: {json.dumps(trace_int8)}")
    print(f"f32 profile W=16, same weights and rows: {json.dumps(trace_f32)}")
    print(f"int8 dequantize pass of one slice machine: {json.dumps(dequant)}")

    cpu = ServingEngine(
        {name: load(os.path.join(models_dir, name), device="cpu") for name in names},
        precisions={name: "int8" for name in names},
        quantized={name: precision.load_quantized(os.path.join(models_dir, name))
                   for name in names},
        device="cpu")
    budget = precision.error_budget("int8")
    plain_cache = {}
    for label, name, X, data in served:
        key = (name, X.shape[0], float(X[0, 0]))
        if key not in plain_cache:
            plain_cache[key] = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
        plain = plain_cache[key]
        rows = len(plain["total-anomaly-score"])
        worst = compare_arrays(f"int8 {label} {name}", rows, data, plain, SERVE_RTOL,
                               tags=X.shape[1])
        parity = precision.parity_error(f32.anomaly(name, X).total_anomaly_score,
                                        np.asarray(data["total-anomaly-score"]))
        print(f"int8 {label} {name} {len(X)} rows: card vs CPU at int8, worst relative "
              f"difference {worst:.3g} (limit {SERVE_RTOL}); total-score parity with f32 on "
              f"the card {parity:.4g} (budget {budget})")
        if not parity <= budget:
            fail(f"int8 {name}: parity error {parity} above the int8 budget {budget}")
    cpu.close()
    f32.close()
    return launches


# phase 7: the reference's serving surface on one server. name ->
# (estimator kwargs of a zoo machine, precision pinned in its metadata,
# anomaly detector or a bare pipeline)
SURFACE = {
    "dense-f32": ("dense-ae-10tag", None, True),
    "dense-bf16": ("dense-ae-10tag", "bf16", True),
    "dense-int8": ("dense-ae-10tag", "int8", True),
    "lstm-int8": ("lstm-ae-50tag", "int8", True),
    "bare-dense": ("dense-ae-10tag", None, False),
}
QUARANTINE_COOLDOWN = 1.0  # seconds


def build_bare_artifact(dest: str, tags: int, device, rng: np.random.Generator) -> None:
    """A bare Pipeline([MinMaxScaler, DenseAutoEncoder]): no anomaly
    detector, so it serves /prediction only."""
    from gordo_components_tpu_torch.serializer import dump, pipeline_from_definition

    model = pipeline_from_definition({"Pipeline": {"steps": [
        "MinMaxScaler", {"DenseAutoEncoder": {"kind": "feedforward_hourglass"}}]}})
    scaler, est = (step for _, step in model.steps)
    scaler.fit(sensor_rows(rng, 2016, tags))
    config = est._make_spec(tags, tags).config
    est.to(device).set_state({"params": zoo_weights(config, rng), "n_features": tags,
                              "n_features_out": tags})
    dump(model, dest, metadata=artifact_metadata([f"TAG-{i:03d}" for i in range(tags)]))


def build_surface_machine(models_dir: str, name: str, device, seed: int) -> None:
    zoo_name, rung, detector = SURFACE[name]
    estimator, kwargs, tags = ZOO[zoo_name]
    rng = np.random.default_rng(seed)
    if detector:
        build_zoo_artifact(os.path.join(models_dir, name), estimator, kwargs, tags, device, rng,
                           precision=rung)
    else:
        build_bare_artifact(os.path.join(models_dir, name), tags, device, rng)


def prometheus_counts(base: str) -> dict:
    """``/metrics?format=prometheus`` parsed by the port's parser:
    {(series name, sorted labels): value}."""
    from gordo_components_tpu_torch.observability.exposition import parse_prometheus_text

    status, _, raw, _ = http("GET", base + "/metrics?format=prometheus")
    if status != 200:
        fail(f"surface: /metrics?format=prometheus answered HTTP {status}")
    return {(name, tuple(sorted(labels.items()))): value
            for name, samples in parse_prometheus_text(raw.decode()).items()
            for labels, value in samples}


def phase_surface(torch, device, tmp: str) -> None:
    """The reference's serving surface on the card, against the port's CPU
    plain path: /models, /metadata, /healthz (fleet and per machine),
    /prediction, /anomaly/prediction, npz against JSON, Prometheus
    /metrics, a spent deadline (504, no dispatch), admission (503 +
    Retry-After under GORDO_MAX_INFLIGHT=1, GORDO_MAX_QUEUE=0), quarantine
    and probe recovery, and a reload (a rewritten, an added and a removed
    machine) under in-flight requests."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.observability.tracing import TRACE_HEADER
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "surface")
    for i, name in enumerate(SURFACE):
        build_surface_machine(models_dir, name, device, SEED + 4000 + i)
    expected_precision = {name: rung or "f32" for name, (_, rung, _) in SURFACE.items()}

    def cpu_engine(names):
        return ServingEngine(
            {n: load(os.path.join(models_dir, n), device="cpu") for n in names},
            precisions={n: expected_precision.get(n, "f32") for n in names}, device="cpu")

    def tags_of(name):
        return ZOO[SURFACE.get(name, SURFACE["dense-f32"])[0]][2]

    httpd = make_server(models_dir, port=0, device=device,
                        quarantine_cooldown=QUARANTINE_COOLDOWN)
    app = httpd.model_server
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    root = f"http://127.0.0.1:{httpd.server_address[1]}"
    base = f"{root}/gordo/v0/project"
    rng = np.random.default_rng(SEED + 7)
    cpu = cpu_engine(list(SURFACE))
    made = {}  # (endpoint, status) -> requests, checked against /metrics

    def score(name, X, endpoint="anomaly/prediction", headers=None):
        status, reply, raw, _ = http("POST", f"{base}/{name}/{endpoint}",
                                     json.dumps({"X": X.tolist()}).encode(), headers)
        # the server labels a client error's series "error"
        label = "anomaly" if endpoint.startswith("anomaly") else "prediction"
        key = ("error" if 400 <= status < 500 else label, status)
        made[key] = made.get(key, 0) + 1
        return status, reply, raw

    def get_json(path):
        status, reply, raw, _ = http("GET", root + path)
        return status, reply, json.loads(raw)

    try:
        before = prometheus_counts(root)
        status, _, models = get_json("/models")
        if status != 200 or models["models"] != sorted(SURFACE):
            fail(f"surface: /models answered {status} {models}")
        for name in SURFACE:
            status, _, meta = get_json(f"/gordo/v0/project/{name}/metadata")
            if status != 200 or meta["name"] != name or \
                    meta["metadata"].get("precision") != SURFACE[name][1]:
                fail(f"surface: /metadata of {name} answered {status} {meta}")
            status, _, health = get_json(f"/gordo/v0/project/{name}/healthz")
            if status != 200 or health["precision"] != expected_precision[name]:
                fail(f"surface: /healthz of {name} answered {status} {health}")
        if get_json("/metadata")[0] != 404:
            fail("surface: bare /metadata of a fleet did not answer 404")
        status, _, health = get_json("/healthz")
        if status != 200 or health["status"] != "ok" or \
                health["store"]["precisions"] != expected_precision:
            fail(f"surface: /healthz answered {status} {health}")
        print(f"surface: /models, /metadata, /healthz answer; precisions "
              f"{health['store']['precisions']}")

        # /prediction on the bare machine and on a detector; 422 on the bare
        for name in ("bare-dense", "dense-f32"):
            X = sensor_rows(rng, 144, tags_of(name))
            status, reply, raw = score(name, X, "prediction")
            if status != 200:
                fail(f"surface: /prediction of {name} answered HTTP {status}: {raw[:200]}")
            got = np.asarray(json.loads(raw)["data"]["model-output"])
            ref = cpu.predict(name, X)
            rel = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
            if rel > SERVE_RTOL:
                fail(f"surface: /prediction of {name} differs from the CPU by {rel:.3g}")
        status, _, raw = score("bare-dense", sensor_rows(rng, 144, 10))
        if status != 422:
            fail(f"surface: /anomaly/prediction of the bare machine answered {status}")
        print("surface: /prediction serves the bare machine and a detector; "
              "/anomaly/prediction of the bare machine answers 422")

        # every detector, JSON and npz: the same float32 arrays; the CPU
        npz_requests = 0
        for name in ("dense-f32", "dense-bf16", "dense-int8", "lstm-int8"):
            X = sensor_rows(rng, 1008, tags_of(name))
            status, reply, raw = score(name, X, headers={TRACE_HEADER: f"chip-smoke-{name}"})
            if status != 200 or reply.get(TRACE_HEADER) != f"chip-smoke-{name}":
                fail(f"surface: {name} answered {status}, trace id {reply.get(TRACE_HEADER)}")
            as_json = decode(reply, raw)
            status, reply, raw = score(name, X, headers={"Accept": wire.NPZ_CONTENT_TYPE})
            npz_requests += 1
            if status != 200 or wire.content_type_of(reply.get("Content-Type")) != \
                    wire.NPZ_CONTENT_TYPE:
                fail(f"surface: npz request to {name} answered {status} {reply}")
            as_npz = decode(reply, raw)
            for field in wire.SCORE_FIELDS:
                a = np.asarray(as_json["data"][field], np.float32)
                b = as_npz["data"][field]
                if b.dtype != np.float32 or not np.array_equal(a, b):
                    fail(f"surface: {name} {field}: npz and JSON disagree")
            plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
            rtol = BF16_SERVE_RTOL if name.endswith("bf16") else SERVE_RTOL
            worst = compare_scores(f"surface {name}", len(plain["total-anomaly-score"]),
                                   as_npz, plain, rtol, tags=X.shape[1])
            print(f"surface {name}: npz == JSON in float32; vs the CPU {worst:.3g} (limit {rtol})")

        # a deadline already spent: 504, and no dispatch
        dispatches = app.engine.stats()["dispatches"]
        status, reply, raw = score("dense-f32", sensor_rows(rng, 144, 10),
                                   headers={"X-Gordo-Deadline": "0"})
        if status != 504 or int(reply.get("Retry-After", 0)) < 1 or \
                app.engine.stats()["dispatches"] != dispatches:
            fail(f"surface: spent deadline answered {status} {reply} (dispatches "
                 f"{dispatches} -> {app.engine.stats()['dispatches']})")
        print(f"surface: spent deadline -> 504, Retry-After {reply['Retry-After']}, "
              f"dispatches unchanged ({dispatches})")

        after = prometheus_counts(root)
        for (endpoint, status), n in sorted(made.items()):
            key = ("gordo_server_requests_total",
                   (("endpoint", endpoint), ("status", str(status))))
            delta = after.get(key, 0) - before.get(key, 0)
            if delta != n:
                fail(f"surface: /metrics counts {delta} for {key}, {n} were made")
        npz_key = ("gordo_server_wire_format_total", (("format", "npz"),))
        if after.get(npz_key, 0) - before.get(npz_key, 0) != npz_requests:
            fail("surface: /metrics does not count the npz responses")
        print(f"surface: /metrics?format=prometheus parses and counts {json.dumps({f'{e} {s}': n for (e, s), n in sorted(made.items())})}")

        quarantine_and_recover(app, base, rng)
        reload_under_traffic(app, base, models_dir, device, rng, cpu_engine)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
        cpu.close()
    admission_sheds(models_dir, device, rng, cpu_engine)


def quarantine_and_recover(app, base: str, rng) -> None:
    """A device fault while dense-int8 scores quarantines it (503, named by
    /healthz) while the rest answer; after the cooldown one request probes
    and recovers it."""
    bucket, idx = app.engine._by_name["dense-int8"]
    fault = threading.Event()
    program = bucket._program

    def faulty(idxs, xs):
        if fault.is_set() and idx in idxs:
            raise RuntimeError("injected device fault")
        return program(idxs, xs)

    bucket._program = faulty
    X = sensor_rows(rng, 144, 10)
    body = json.dumps({"X": X.tolist()}).encode()
    url = f"{base}/dense-int8/anomaly/prediction"
    fault.set()
    status, reply, raw, _ = http("POST", url, body)
    root = base.rsplit("/gordo/", 1)[0]
    health = json.loads(http("GET", root + "/healthz")[2])
    machine_health = http("GET", f"{base}/dense-int8/healthz")[0]
    others = http("POST", f"{base}/dense-f32/anomaly/prediction", body)[0]
    again = http("POST", url, body)[0]
    if status != 503 or int(reply.get("Retry-After", 0)) < 1 or \
            "dense-int8" not in health["quarantined"] or health["status"] != "degraded" or \
            machine_health != 503 or others != 200 or again != 503:
        fail(f"surface: quarantine: {status} {reply}, /healthz {health['status']} "
             f"{sorted(health['quarantined'])}, machine healthz {machine_health}, "
             f"others {others}, again {again}")
    fault.clear()
    time.sleep(QUARANTINE_COOLDOWN + 0.2)
    probe = http("POST", url, body)[0]
    health = json.loads(http("GET", root + "/healthz")[2])
    bucket._program = program
    if probe != 200 or health["status"] != "ok":
        fail(f"surface: quarantine probe answered {probe}, /healthz {health['status']}")
    print("surface: a scoring fault quarantines dense-int8 (503, named by /healthz, others "
          "200); after the cooldown a probe recovers it")


def reload_under_traffic(app, base: str, models_dir: str, device, rng, cpu_engine) -> None:
    """Rewrite dense-f32's weights, add dense-new, remove dense-bf16 and
    POST /reload while clients keep scoring lstm-int8: every in-flight
    request completes, answers follow the new weights, and the removed
    machine answers 404."""
    import shutil

    from gordo_components_tpu_torch import wire

    X = sensor_rows(rng, 144, 10)
    body = json.dumps({"X": X.tolist()}).encode()
    old = json.loads(http("POST", f"{base}/dense-f32/anomaly/prediction", body)[2])
    build_surface_machine(models_dir, "dense-f32", device, SEED + 5000)
    shutil.copytree(os.path.join(models_dir, "dense-f32"), os.path.join(models_dir, "dense-new"))
    shutil.rmtree(os.path.join(models_dir, "dense-bf16"))
    X_lstm = sensor_rows(rng, 1008, 50)
    lstm_body = json.dumps({"X": X_lstm.tolist()}).encode()
    statuses, stop = [], threading.Event()

    def client():
        while not stop.is_set():
            statuses.append(http("POST", f"{base}/lstm-int8/anomaly/prediction", lstm_body)[0])

    clients = [threading.Thread(target=client) for _ in range(4)]
    for c in clients:
        c.start()
    time.sleep(0.5)
    root = base.rsplit("/gordo/", 1)[0]
    status, _, raw, ms = http("POST", root + "/reload")
    time.sleep(0.5)
    stop.set()
    for c in clients:
        c.join(timeout=120)
    report = json.loads(raw)
    if status != 200 or report["added"] != ["dense-new"] or report["removed"] != ["dense-bf16"] \
            or report["refreshed"] != ["dense-f32"] or report["errors"]:
        fail(f"surface: /reload answered {status} {report}")
    if any(c.is_alive() for c in clients) or not statuses or set(statuses) != {200}:
        fail(f"surface: requests during the reload answered {sorted(set(statuses))}")
    cpu = cpu_engine(["dense-f32", "dense-new"])
    for name in ("dense-f32", "dense-new"):
        status, reply, raw, _ = http("POST", f"{base}/{name}/anomaly/prediction", body)
        if status != 200:
            fail(f"surface: {name} after the reload answered {status}")
        payload = decode(reply, raw)
        plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
        compare_scores(f"surface reload {name}", len(X), payload, plain, SERVE_RTOL, tags=10)
    cpu.close()
    if np.allclose(old["data"]["model-output"], payload["data"]["model-output"]):
        fail("surface: dense-f32 still answers with its old weights after the reload")
    gone = http("POST", f"{base}/dense-bf16/anomaly/prediction", body)[0]
    if gone != 404:
        fail(f"surface: the removed machine answered {gone}")
    print(f"surface: /reload in {ms:.0f} ms ({json.dumps(report)}); {len(statuses)} requests "
          "in flight around it all answered 200; answers follow the new weights; the removed "
          "machine answers 404")


def admission_sheds(models_dir: str, device, rng, cpu_engine) -> None:
    """A server started with GORDO_MAX_INFLIGHT=1 and GORDO_MAX_QUEUE=0
    under 8 concurrent clients sheds some requests with 503 + Retry-After,
    and every 200 it answers is right."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.server.server import make_server

    saved = {k: os.environ.get(k) for k in ("GORDO_MAX_INFLIGHT", "GORDO_MAX_QUEUE")}
    os.environ.update(GORDO_MAX_INFLIGHT="1", GORDO_MAX_QUEUE="0")
    try:
        httpd = make_server(models_dir, port=0, device=device)
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key, None)
            else:
                os.environ[key] = value
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/gordo/v0/project/dense-f32/anomaly/prediction")
    Xs = [sensor_rows(rng, 8064, 10) for _ in range(4)]
    bodies = [json.dumps({"X": X.tolist()}).encode() for X in Xs]
    answers = []
    try:
        def client(t):
            for i in range(8):
                k = (t + i) % len(Xs)
                status, reply, raw, _ = http("POST", url, bodies[k])
                answers.append((k, status, reply, raw))

        workers = [threading.Thread(target=client, args=(t,)) for t in range(8)]
        for w in workers:
            w.start()
        for w in workers:
            w.join(timeout=300)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    shed = [a for a in answers if a[1] == 503]
    ok = [a for a in answers if a[1] == 200]
    if len(answers) != 64 or not shed or not ok or len(shed) + len(ok) != len(answers) or \
            any(int(a[2].get("Retry-After", 0)) < 1 for a in shed):
        fail(f"surface: admission answered {sorted({a[1] for a in answers})}: {len(shed)} "
             f"sheds, {len(ok)} served of {len(answers)}")
    cpu = cpu_engine(["dense-f32"])
    plain = [dict(zip(wire.SCORE_FIELDS, cpu.anomaly("dense-f32", X))) for X in Xs]
    for k, _, reply, raw in ok:
        compare_scores("surface admission", len(Xs[k]), decode(reply, raw), plain[k],
                       SERVE_RTOL, tags=10)
    cpu.close()
    print(f"surface: GORDO_MAX_INFLIGHT=1 GORDO_MAX_QUEUE=0 under 8 clients: {len(shed)} of "
          f"{len(answers)} shed with 503 (Retry-After {sorted({a[2]['Retry-After'] for a in shed})}"
          f"), {len(ok)} served, each matching the CPU")


# phase 8: training at full width. The slice machine's widths, trained one
# epoch over TRAIN_ROWS seeded rows: 1695 - 1440 + 1 = 256 windows, 8 steps
# of batch 32 (a layer's attention at BH = 32 x 64 x 8 = 16384), Adam
TRAIN_ROWS = LOOKBACK + 255
TRAIN_KWARGS = dict(batch_size=32, epochs=1)
# flash-kernel fit vs dense-attention fit on the card, same initial
# parameters and permutation: float32 both, the attention computed in
# other orders (~1e-6 per step), carried through 8 Adam steps; a wrong
# gradient (a dropped key, a missing term) moves the loss by O(1e-2) or more
TRAIN_RTOL = 1e-3


def slice_definition(attention_impl: str = "flash", **estimator_kwargs) -> dict:
    """The slice machine's definition (the served one of phase 3)."""
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {"PatchTSTAutoEncoder": {
            "kind": "patchtst", "lookback_window": LOOKBACK, "attention_impl": attention_impl,
            **SLICE, **estimator_kwargs}}]}},
        "transformer": "MinMaxScaler"}}}}


def fit_slice(torch, device, attention_impl: str, rows: np.ndarray,
              compute_dtype: str = "float32") -> tuple:
    """The slice machine's regressor (scalers, then PatchTSTAutoEncoder.fit)
    trained on the card; returns (model, estimator, wall s, peak bytes)."""
    from gordo_components_tpu_torch.serializer import pipeline_from_definition

    model = pipeline_from_definition(slice_definition(
        attention_impl, compute_dtype=compute_dtype, **TRAIN_KWARGS))
    est = model.base_estimator.regressor.steps[-1][1].to(device)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    started = time.perf_counter()
    model.base_estimator.fit(rows)
    torch.cuda.synchronize()
    return model, est, time.perf_counter() - started, torch.cuda.max_memory_allocated()


def profile_train_step(torch, est, rows: np.ndarray) -> dict:
    """One warm training step of the fitted flash machine (the library's
    batch step on a batch of 32 windows, on copies of its parameters) under
    torch.profiler: device busy, GEMMs, flash forward and backward, and the
    idle share; then the optimizer update alone, traced the same way."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from gordo_components_tpu_torch.models import train
    from gordo_components_tpu_torch.models.factories.spec import apply_updates
    from gordo_components_tpu_torch.ops import windowing

    device = est.device
    spec = est._make_spec(est.n_features_, est.n_features_out_)
    module = est.module_
    # copies: the traced steps must leave the trained machine as it is
    params = {k: v.detach().clone().requires_grad_() for k, v in module.named_parameters()}
    x_rows = torch.as_tensor(rows, device=device)
    starts = torch.arange(32, device=device)
    y = x_rows[LOOKBACK - 1:LOOKBACK - 1 + 32]
    w = torch.ones(32, device=device)

    def apply(p, s, g):
        return torch.func.functional_call(
            module, p, (windowing.gather_windows(x_rows, s, LOOKBACK),), {"generator": g})

    step = train.make_batch_step(apply, spec.optimizer, loss=spec.loss)
    state = spec.optimizer.init(list(params.values()))

    def traced(fn):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            traced_ms = (time.perf_counter() - t0) * 1e3
        events = [evt for evt in prof.key_averages()
                  if evt.device_type == DeviceType.CUDA and evt.self_device_time_total]
        return traced_ms, events

    def one_step():
        nonlocal state
        state, _, _ = step(params, state, (starts, y, w, None))

    traced_ms, events = traced(one_step)
    busy = sum(evt.self_device_time_total for evt in events) / 1e3

    def total(*needles):
        return sum(evt.self_device_time_total for evt in events
                   if any(n in evt.key.lower() for n in needles)) / 1e3

    values = list(params.values())
    grads = [torch.randn_like(p) * 1e-3 for p in values]
    opt_ms, opt_events = traced(lambda: apply_updates(
        values, spec.optimizer.update(grads, spec.optimizer.init(values), values)[0]))
    by_kernel = sorted(((kernel_label(evt.key), evt.self_device_time_total / 1e3, evt.count)
                        for evt in events), key=lambda row: -row[1])
    return {
        "traced_ms": traced_ms, "device_busy_ms": busy, "device_idle_share": 1 - busy / traced_ms,
        "gemm_ms": total("gemm", "cutlass", "xmma"),
        "flash_fwd_ms": total("flash_fwd"), "flash_bwd_ms": total("flash_bwd"),
        "optimizer_alone_device_ms": sum(e.self_device_time_total for e in opt_events) / 1e3,
        "optimizer_alone_traced_ms": opt_ms,
        "kernel_launches": sum(evt.count for evt in events),
        "device_ms_by_kernel": [{"kernel": k, "ms": ms, "launches": n}
                                for k, ms, n in by_kernel[:10]],
    }


def phase_train(torch, device, tmp: str) -> dict:
    """Training at full width: the slice machine fitted on the card through
    PatchTSTAutoEncoder.fit with the flash kernels, forward and backward
    (3 launches each per step), then again with dense attention from the
    same initial parameters and permutation (the card's own yardstick); the
    trained machine dumped, served over HTTP and its W = 16 response held to
    the trained model's own predict."""
    from gordo_components_tpu_torch.models.anomaly.diff import fit_thresholds
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import dump

    rng = np.random.default_rng(SEED + 8)
    rows = sensor_rows(rng, TRAIN_ROWS)
    steps = -(-(TRAIN_ROWS - LOOKBACK + 1) // TRAIN_KWARGS["batch_size"]) * TRAIN_KWARGS["epochs"]
    _kernels.reset_launches()
    model, est, wall, peak = fit_slice(torch, device, "flash", rows)
    launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    per_step = SLICE["n_layers"] * steps
    print(f"train flash: {steps} steps in {wall:.2f} s ({1e3 * wall / steps:.1f} ms per step, "
          f"initialisation included), peak device memory {peak / 2**30:.2f} GiB, "
          f"loss history {est.history_}, launches {launches}")
    if launches != {**NO_LAUNCHES, "flash_fwd_f32": per_step, "flash_bwd_f32": per_step}:
        fail(f"train: launches {launches}, expected {SLICE['n_layers']} fp32 forward and "
             f"backward launches per step over {steps} steps")
    if not all(np.isfinite(est.history_)):
        fail(f"train: loss history {est.history_} is not finite")

    _kernels.reset_launches()
    dense_model, dense_est, dense_wall, dense_peak = fit_slice(torch, device, "dense", rows)
    dense_launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    rel = max(abs(a - b) / abs(b) for a, b in zip(est.history_, dense_est.history_))
    X = sensor_rows(rng, LOOKBACK + 15)
    pred, dense_pred = model.base_estimator.predict(X), dense_model.base_estimator.predict(X)
    pred_rel = np.abs(pred - dense_pred).max() / np.abs(dense_pred).max()
    print(f"train dense: {steps} steps in {dense_wall:.2f} s, peak {dense_peak / 2**30:.2f} GiB, "
          f"loss history {dense_est.history_}; flash vs dense: loss max relative difference "
          f"{rel:.3g}, W=16 predictions {pred_rel:.3g} (limit {TRAIN_RTOL})")
    if any(dense_launches.values()) or rel > TRAIN_RTOL or pred_rel > TRAIN_RTOL:
        fail(f"train: the flash fit departs from the dense fit (loss {rel:.3g}, predictions "
             f"{pred_rel:.3g}) or the dense fit launched {dense_launches}")
    del dense_model, dense_est
    torch.cuda.empty_cache()

    scaled = model.base_estimator.regressor.steps[0][1].transform(rows)
    trace = profile_train_step(torch, est, scaled)
    print(f"train step profile (batch 32, BH 16384): {json.dumps(trace)}")

    # the error scaler and thresholds on the training tail, then serve it
    tail = rows[-(LOOKBACK + 127):]
    model.tag_thresholds_, model.total_threshold_ = fit_thresholds(
        model.scaler, np.abs(tail[LOOKBACK - 1:] - model.predict(tail)))
    artifact = os.path.join(tmp, "turbine-trained")
    dump(model, artifact, metadata=artifact_metadata([f"TAG-{i:03d}" for i in range(N_TAGS)]))
    [(X, payload, served, _)] = serve(artifact, device, (16,), rng)
    if served != {**NO_LAUNCHES, "flash_fwd_f32": SLICE["n_layers"]}:
        fail(f"train: the trained machine's request launched {served}")
    got = np.asarray(payload["data"]["model-output"], np.float64)
    ref = model.predict(X).astype(np.float64)
    worst = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
    print(f"train: the trained machine served over HTTP, W=16 vs its own predict: {worst:.3g} "
          f"(limit {SERVE_RTOL})")
    if got.shape != ref.shape or worst > SERVE_RTOL:
        fail(f"train: served output {got.shape} differs from predict by {worst:.3g}")
    launches["flash_fwd_f32"] += served["flash_fwd_f32"]
    return {"launches": launches, "trace": trace, "peak_gib": peak / 2**30}


def phase_train_bf16(torch, device) -> dict:
    """The bf16 training path: the slice machine with compute_dtype
    bfloat16 fitted through the bf16 flash kernels (3 forward and 3
    backward launches per step, no fp32 launch), against the same bf16 fit
    with dense attention within BF16_SERVE_RTOL of the loss."""
    from gordo_components_tpu_torch.ops import _kernels

    rows = sensor_rows(np.random.default_rng(SEED + 8), TRAIN_ROWS)
    steps = -(-(TRAIN_ROWS - LOOKBACK + 1) // TRAIN_KWARGS["batch_size"]) * TRAIN_KWARGS["epochs"]
    _kernels.reset_launches()
    _, est, wall, peak = fit_slice(torch, device, "flash", rows, "bfloat16")
    launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    _, dense, _, _ = fit_slice(torch, device, "dense", rows, "bfloat16")
    rel = max(abs(a - b) / abs(b) for a, b in zip(est.history_, dense.history_))
    print(f"train bf16 flash: {steps} steps in {wall:.2f} s, peak {peak / 2**30:.2f} GiB, loss "
          f"history {est.history_}, launches {launches}; dense bf16 {dense.history_}, max "
          f"relative difference {rel:.3g} (limit {BF16_SERVE_RTOL})")
    per_step = SLICE["n_layers"] * steps
    if launches != {**NO_LAUNCHES, "flash_fwd_bf16": per_step, "flash_bwd_bf16": per_step}:
        fail(f"train bf16: launches {launches}, expected {per_step} bf16 forward and backward")
    if not all(np.isfinite(est.history_)) or rel > BF16_SERVE_RTOL:
        fail(f"train bf16: loss {est.history_} against dense attention's {dense.history_}")
    torch.cuda.empty_cache()
    return launches


# phase 9: the model phase of a build at the zoo's widths (phase 4's
# dense-ae-default and lstm-ae-50tag), cross-validated and fitted on the
# card, over two weeks of 10-minute rows
BUILD = {name: ZOO[name] for name in ("dense-ae-default", "lstm-ae-50tag")}
BUILD_ROWS = 2016
BUILD_METADATA_KEYS = {"name", "gordo_components_tpu_torch_version", "model", "dataset",
                       "build_duration_s", "build_phases", "user_defined"}
BUILD_MODEL_KEYS = {"model_config", "model_builder_metadata", "cross_validation",
                    "model_training_duration_s", "model_creation_date"}
BUILD_DETECTOR_KEYS = {"type", "base_estimator", "cross_validation", "tag_thresholds",
                       "total_threshold"}


def phase_build(torch, device, tmp: str) -> None:
    """The zoo's machines built on the card: the port's build_model (the
    definition, cross_validate over 3 folds, fit), dumped with the build
    metadata, served by one HTTP server; every response against the same
    artifact on the CPU plain path, and no flash launch."""
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.builder import build_model
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import dump, load, load_metadata
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    models_dir = os.path.join(tmp, "built")
    rng = np.random.default_rng(SEED + 9)
    _kernels.reset_launches()
    for name, (estimator, kwargs, tags) in BUILD.items():
        config = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
            "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
            "transformer": "MinMaxScaler"}}}}
        X = sensor_rows(rng, BUILD_ROWS, tags)
        tag_list = [f"TAG-{i:03d}" for i in range(tags)]
        started = time.perf_counter()
        model, metadata = build_model(name, config, X, device=device,
                                      dataset_metadata={"tag_list": tag_list})
        dump(model, os.path.join(models_dir, name), metadata=metadata)
        written = load_metadata(os.path.join(models_dir, name))
        cv = written["model"]["cross_validation"]
        print(f"build {name}: {time.perf_counter() - started:.2f} s (cv {cv['cv_duration_s']:.2f}"
              f" s, fit {written['model']['model_training_duration_s']:.2f} s); fold scores "
              + json.dumps([{k: round(v, 4) for k, v in s["scores"].items()} for s in cv["splits"]])
              + f"; total threshold {model.total_threshold_:.4f}, tag thresholds "
              f"{np.round(model.tag_thresholds_[:5], 4).tolist()}...")
        detector_meta = written["model"]["model_builder_metadata"]
        if (not BUILD_METADATA_KEYS <= set(written) or set(written["model"]) != BUILD_MODEL_KEYS
                or set(detector_meta) != BUILD_DETECTOR_KEYS or len(cv["splits"]) != 3
                or len(detector_meta["tag_thresholds"]) != tags):
            fail(f"build {name}: the metadata lacks the reference's keys: {sorted(written)}, "
                 f"{sorted(written['model'])}, {sorted(detector_meta)}")
    launches = {n: _kernels.LAUNCHES[n] for n in KERNELS}
    if any(launches.values()):
        fail(f"build: the zoo's fits launched flash kernels: {launches}")

    httpd = make_server(models_dir, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{httpd.server_address[1]}"
    try:
        for name, (_, _, tags) in BUILD.items():
            X = sensor_rows(rng, 1008, tags)
            status, payload, ms = post(f"{base}/gordo/v0/project/{name}/anomaly/prediction", X)
            if status != 200:
                fail(f"build {name}: HTTP {status}")
            cpu = ServingEngine({name: load(os.path.join(models_dir, name), device="cpu")},
                                device="cpu")
            plain = dict(zip(wire.SCORE_FIELDS, cpu.anomaly(name, X)))
            cpu.close()
            w = len(plain["model-output"])
            worst = compare_scores(f"build {name}", w, payload, plain, SERVE_RTOL, tags)
            print(f"build {name}: served 1008 rows over HTTP in {ms:.1f} ms, vs the CPU plain "
                  f"path {worst:.3g} (limit {SERVE_RTOL})")
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("no CUDA device is available; this script measures the card")
    try:
        from gordo_components_tpu_torch.utils.backend import resolve_device
    except ImportError as exc:
        fail(f"run from the root of a checkout: {exc}")
    device = resolve_device(None)
    card = phase_environment()
    kernels = phase_kernels(torch, device)
    with tempfile.TemporaryDirectory(prefix="chip-smoke-") as tmp:
        launches = phase_serve(torch, device, tmp)
        launches["flash_fwd_bf16"] = phase_serve_bf16(torch, device, tmp)["flash_fwd_bf16"]
        phase_zoo(torch, device, tmp)
        launches["flash_fwd_f32"] += phase_fleet(torch, device, tmp)["flash_fwd_f32"]
        launches["flash_fwd_f32"] += phase_int8(torch, device, tmp)["flash_fwd_f32"]
        phase_surface(torch, device, tmp)
        trained = phase_train(torch, device, tmp)["launches"]
        trained_bf16 = phase_train_bf16(torch, device)
        for name in KERNELS:
            launches[name] += trained[name] + trained_bf16[name]
        phase_build(torch, device, tmp)
    print(json.dumps({"kernels": [{
        "name": name,
        "route": "cuda",
        "source": source,
        "replaces": REPLACES[name],
        "launches": launches[name],
        **{key: kernels[name][key] for key in (
            "max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "library")},
    } for name, (_, source) in KERNELS.items()]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
