#!/usr/bin/env python3
"""Drive the PyTorch port on one CUDA card, end to end.

    python3 chip_smoke.py        # from the root of a checkout, one card

Phases; any failure exits non-zero before the result line:

1. environment: torch/CUDA versions, the card's name and power limit, and
   a build of every CUDA kernel from ``gordo_components_tpu_torch/csrc``
   (one ``nvcc`` per source, all started together);
2. each kernel against its plain PyTorch version on the card, at the
   shapes the main path gives it, with its time, the plain version's time
   and one PyTorch library call's time as a yardstick (timed only; the
   port never calls it);
3. the main path: a full-width long-window PatchTST anomaly machine
   (d_model 512, 8 heads, 3 layers, 64 tags, lookback 1440 = 179 patches,
   random weights from a seed in the flax layout, scalers fitted on seeded
   data) is dumped as an artifact, served by the port's HTTP server on the
   card, and asked a few ``POST /anomaly/prediction`` requests. The launch
   counts are zeroed just before and read just after; every request must
   launch the flash kernel once per layer, and every response must match
   the same artifact scored by the port with ``device="cpu"`` (its plain
   path).

The line before last is ``nvidia-smi``'s name and power limit; the one
before that the kernels' JSON record; the last line is the result.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import threading
import time
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
# served scores, GPU vs CPU plain path, relative to the array's magnitude:
# float32 on both sides, GEMMs and the online softmax sum in other orders
# (1e-6 .. 1e-5 relative); a wrong mask or layout is an O(1) error
SERVE_RTOL = 1e-4


def fail(message: str) -> None:
    print(f"chip_smoke: FAILED: {message}", file=sys.stderr, flush=True)
    sys.exit(1)


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


def phase_kernels(torch, device) -> dict:
    """flash_fwd against flash_fwd_reference on the card."""
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

    slice_shape = (16 * N_TAGS * SLICE["n_heads"], (LOOKBACK - 16) // 8 + 1, 64)
    cases = [
        (slice_shape, torch.float32),
        (slice_shape, torch.bfloat16),
        ((12, 129, 16), torch.float32),
        ((3, 37, 8), torch.float32),
    ]
    max_err = 0.0
    for shape, dtype in cases:
        q, k, v = qkv(shape, dtype)
        scale = shape[-1] ** -0.5
        out, lse = _kernels.flash_fwd_cuda(q, k, v, scale)
        ref_out, ref_lse = flash_fwd_reference(q, k, v, scale)
        torch.cuda.synchronize()
        atol = FP32_ATOL if dtype == torch.float32 else BF16_ATOL
        err = (out.float() - ref_out.float()).abs().max().item()
        lse_err = (lse - ref_lse).abs().max().item()
        print(f"flash_fwd {tuple(shape)} {str(dtype)[6:]}: max|out-plain| {err:.3g} "
              f"(atol {atol}), max|lse-plain| {lse_err:.3g} (atol {FP32_ATOL * 5})")
        if not (err <= atol and lse_err <= FP32_ATOL * 5):
            fail(f"flash_fwd disagrees with its plain version at {shape} {dtype}")
        if dtype == torch.float32:
            max_err = max(max_err, err)
    # the public entry with small blocks: (B, S, H, D) layout into the kernel
    q, k, v = qkv((1, 37, 3, 8), torch.float32)
    before = _kernels.LAUNCHES["flash_fwd"]
    out = flash_attention(q, k, v, block_q=8, block_k=8)
    ref = flash_attention(*(t.cpu() for t in (q, k, v)), block_q=8, block_k=8)
    err = (out.cpu() - ref).abs().max().item()
    print(f"flash_attention (1, 37, 3, 8) blocks 8: max|cuda-cpu| {err:.3g}")
    if err > FP32_ATOL or _kernels.LAUNCHES["flash_fwd"] != before + 1:
        fail("flash_attention on the card did not match the CPU path through the kernel")

    record = {}
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = qkv(slice_shape, dtype)
        scale = slice_shape[-1] ** -0.5
        ms = timed_ms(lambda: _kernels.flash_fwd_cuda(q, k, v, scale))
        plain_ms = timed_ms(lambda: flash_fwd_reference(q, k, v, scale), iters=3)
        library_ms = timed_ms(lambda: F.scaled_dot_product_attention(q, k, v, scale=scale))
        bound = attention_bound(*slice_shape, dtype)
        print(f"flash_fwd {slice_shape} {str(dtype)[6:]}: kernel {ms:.4f} ms, plain "
              f"{plain_ms:.4f} ms, sdpa {library_ms:.4f} ms, bound {bound['bound_ms']:.4f} ms "
              f"({bound['bound_by']}: {bound['gflop']:.1f} GFLOP, {bound['gbytes']:.3f} GB)")
        record[str(dtype)[6:]] = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms, **bound)
        del q, k, v
    torch.cuda.empty_cache()
    return {"max_abs_err": max_err, "timings": record}


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


def sensor_rows(rng: np.random.Generator, n: int) -> np.ndarray:
    """Seeded plant-like signals: per-tag level and scale, slow drift, noise."""
    t = np.arange(n)[:, None]
    level = rng.uniform(-50, 150, size=N_TAGS)
    scale = rng.uniform(0.5, 20, size=N_TAGS)
    phase = rng.uniform(0, 2 * np.pi, size=N_TAGS)
    wave = np.sin(2 * np.pi * t / 720 + phase)
    return (level + scale * (wave + 0.3 * rng.normal(size=(n, N_TAGS)))).astype(np.float32)


def build_artifact(dest: str, device) -> list:
    from gordo_components_tpu_torch.serializer import dump, pipeline_from_definition

    rng = np.random.default_rng(SEED)
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
                                    "attention_impl": "flash", "compute_dtype": "float32",
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
    dump(model, dest, metadata={"dataset": {"tag_list": tags}})
    return tags


def phase_serve(torch, device, tmp: str) -> int:
    from gordo_components_tpu_torch import wire
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import make_server

    artifact = os.path.join(tmp, "turbine-long-window")
    started = time.perf_counter()
    build_artifact(artifact, device)
    print(f"artifact written in {time.perf_counter() - started:.1f} s: {sorted(os.listdir(artifact))}")

    httpd = make_server(artifact, port=0, device=device)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    url = (f"http://127.0.0.1:{httpd.server_address[1]}"
           "/gordo/v0/project/turbine-long-window/anomaly/prediction")
    rng = np.random.default_rng(SEED + 1)
    requests, responses, launches = [], [], []
    try:
        _kernels.reset_launches()
        for w in WINDOWS:
            X = sensor_rows(rng, LOOKBACK + w - 1)
            body = json.dumps({"X": X.tolist()}).encode()
            before = _kernels.LAUNCHES["flash_fwd"]
            t0 = time.perf_counter()
            req = urllib.request.Request(url, data=body, method="POST",
                                         headers={"Content-Type": "application/json"})
            with urllib.request.urlopen(req, timeout=300) as resp:
                status, payload = resp.status, json.loads(resp.read())
            ms = (time.perf_counter() - t0) * 1e3
            launches.append(_kernels.LAUNCHES["flash_fwd"] - before)
            print(f"POST W={w} ({len(X)} rows): HTTP {status}, {ms:.1f} ms, "
                  f"flash_fwd launches {launches[-1]}")
            if status != 200:
                fail(f"HTTP {status} for W={w}")
            requests.append(X)
            responses.append(payload)
        main_path_launches = dict(_kernels.LAUNCHES)
    finally:
        httpd.shutdown()
        httpd.server_close()
        thread.join(timeout=30)
    if any(n != SLICE["n_layers"] for n in launches):
        fail(f"flash_fwd launches per request {launches}, expected {SLICE['n_layers']} each")

    cpu_engine = ServingEngine({"m": load(artifact, device="cpu")}, device="cpu")
    for w, X, payload in zip(WINDOWS, requests, responses):
        data = payload["data"]
        expected = {"model-input": (w, N_TAGS), "model-output": (w, N_TAGS),
                    "tag-anomaly-scores": (w, N_TAGS), "total-anomaly-score": (w,)}
        started = time.perf_counter()
        plain = dict(zip(wire.SCORE_FIELDS, cpu_engine.anomaly("m", X)))
        cpu_s = time.perf_counter() - started
        worst = 0.0
        for field, shape in expected.items():
            got = np.asarray(data[field], np.float64)
            if got.shape != shape or not np.isfinite(got).all():
                fail(f"W={w}: {field} has shape {got.shape} (want {shape}) or non-finite values")
            ref = plain[field].astype(np.float64)
            rel = np.abs(got - ref).max() / max(1.0, np.abs(ref).max())
            worst = max(worst, rel)
            if rel > SERVE_RTOL:
                fail(f"W={w}: {field} differs from the CPU plain path by {rel:.3g} (relative)")
        if len(payload["tag-thresholds"]) != N_TAGS:
            fail("thresholds missing from the response")
        print(f"W={w}: card vs CPU plain path, worst relative difference {worst:.3g} "
              f"(limit {SERVE_RTOL}); CPU scoring took {cpu_s:.1f} s")
    return main_path_launches["flash_fwd"]


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
        total_launches = phase_serve(torch, device, tmp)
    t32 = kernels["timings"]["float32"]
    print(json.dumps({"kernels": [{
        "name": "flash_fwd",
        "route": "cuda",
        "source": "gordo_components_tpu_torch/csrc/flash_fwd.cu",
        "replaces": "gordo_components_tpu/ops/flash_attention.py:157",
        "launches": total_launches,
        "max_abs_err": kernels["max_abs_err"],
        "ms": t32["ms"],
        "plain_ms": t32["plain_ms"],
        "bound_ms": t32["bound_ms"],
        "bound_by": t32["bound_by"],
        "library_ms": t32["library_ms"],
    }]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
