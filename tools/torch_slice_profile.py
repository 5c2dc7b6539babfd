#!/usr/bin/env python3
"""Where a request's time goes on the card, for the port's slice machine.

    python3 tools/torch_slice_profile.py [--windows 16] [--iters 5]

Builds the same seeded long-window PatchTST artifact as ``chip_smoke.py``,
loads it on the card and scores ``--windows``-window requests:

- host wall time of ``ServingEngine.anomaly`` (one dispatch of the stacked
  engine and its fetch) and of ``ModelServer.handle`` (JSON parse + validation + scoring
  + JSON encode), median of ``--iters``;
- a ``torch.profiler`` trace of ``--iters`` engine calls: device time
  summed by kernel name, and the device's busy share of the traced wall
  time. The table goes to ``chiprun_out/torch_slice_profile.txt``.

Prints one JSON summary line. Needs one CUDA card.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def main() -> None:
    parser = argparse.ArgumentParser()
    parser.add_argument("--windows", type=int, default=16)
    parser.add_argument("--iters", type=int, default=5)
    args = parser.parse_args()

    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    import chip_smoke
    from gordo_components_tpu_torch.serializer import load
    from gordo_components_tpu_torch.server.engine import ServingEngine
    from gordo_components_tpu_torch.server.server import ModelServer
    from gordo_components_tpu_torch.utils.backend import resolve_device

    device = resolve_device(None)
    rng = np.random.default_rng(chip_smoke.SEED + 2)
    with tempfile.TemporaryDirectory() as tmp:
        artifact = os.path.join(tmp, "m")
        chip_smoke.build_artifact(artifact, device)
        engine = ServingEngine({"m": load(artifact, device="cpu")}, device=device)
        app = ModelServer(artifact, device=device)
    X = chip_smoke.sensor_rows(rng, chip_smoke.LOOKBACK + args.windows - 1)
    body = json.dumps({"X": X.tolist()}).encode()
    path = "/gordo/v0/project/m/anomaly/prediction"
    for _ in range(2):  # warm-up: cuBLAS handles, allocator, kernel library load
        engine.anomaly("m", X)
        app.handle("POST", path, {}, body)

    def wall_ms(fn):
        times = []
        for _ in range(args.iters):
            t0 = time.perf_counter()
            fn()
            times.append((time.perf_counter() - t0) * 1e3)
        return float(np.median(times))

    engine_ms = wall_ms(lambda: engine.anomaly("m", X))
    server_ms = wall_ms(lambda: app.handle("POST", path, {}, body))

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(args.iters):
            engine.anomaly("m", X)
        torch.cuda.synchronize()
        traced_ms = (time.perf_counter() - t0) * 1e3
    # device-side events only (kernels, copies): the operator rows above
    # them carry the same time again
    device_us = {
        evt.key: evt.self_device_time_total
        for evt in prof.key_averages()
        if evt.device_type == DeviceType.CUDA and evt.self_device_time_total
    }
    busy_ms = sum(device_us.values()) / 1e3
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "torch_slice_profile.txt"), "w") as fh:
        fh.write(prof.key_averages().table(sort_by="self_device_time_total", row_limit=40))
    top = sorted(device_us.items(), key=lambda kv: -kv[1])[:6]
    print(json.dumps({
        "card": torch.cuda.get_device_name(0),
        "windows": args.windows,
        "engine_ms_median": engine_ms,
        "server_ms_median": server_ms,
        "traced_ms_per_request": traced_ms / args.iters,
        "device_busy_ms_per_request": busy_ms / args.iters,
        "device_idle_share": 1 - busy_ms / traced_ms if traced_ms else None,
        "top_device_ms_per_request": {k[:60]: v / 1e3 / args.iters for k, v in top},
    }))


if __name__ == "__main__":
    main()
