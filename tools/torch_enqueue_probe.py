"""Where a serving dispatch's enqueue spends its host time, on the card.

The engine's ``dispatch`` stage times the enqueue of a bucket's program
(``_Bucket._enqueue``) and ``device_execute`` + ``fetch`` time what follows
until the outputs are on the host. This probe says what can make the
enqueue itself take the device's time:

* part A times, behind about 100 ms of queued device work, each host call
  the enqueue makes that could wait for the device (a fresh pinned host
  block, ``pin_memory``, a non-blocking copy to the host, a fresh device
  block) and reports whether the stream had drained when it returned;
* part B runs ``chip_smoke.phase_seams`` (the request-seams phase, its
  traffic and checks unchanged) with ``_Bucket._enqueue`` wrapped for the
  PatchTST bucket: per dispatch, the wall and thread CPU ms of the input
  copy, of the program's launches and of the output copy, and whether the
  device had finished the dispatch when the enqueue returned.

Run on the card from the root of a checkout (it builds the kernels):

    python3 tools/torch_enqueue_probe.py [--out chiprun_out/enqueue_probe.json]
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def timed(fn):
    wall, cpu = time.perf_counter(), time.thread_time()
    out = fn()
    return out, (time.perf_counter() - wall) * 1e3, (time.thread_time() - cpu) * 1e3


def part_a(torch) -> dict:
    """Host ms of each call behind queued work, and whether it drained."""
    device = torch.device("cuda")
    a = torch.randn(8192, 8192, device=device)
    torch.cuda.synchronize()
    stream = torch.cuda.current_stream()

    def behind_work(name, call, results):
        for _ in range(6):  # ~100 ms of fp32 products queued
            torch.mm(a, a)
        _, wall, cpu = timed(call)
        drained = stream.query()
        torch.cuda.synchronize()
        results[name] = {"wall_ms": wall, "cpu_ms": cpu, "stream_drained": drained}

    results = {}
    behind_work("launch one kernel", lambda: a.add_(0.0), results)
    sizes = iter(range(1, 1000))
    behind_work("pinned host block, fresh size",
                lambda: torch.empty((3 << 20) + next(sizes), dtype=torch.uint8, pin_memory=True),
                results)
    cached = torch.empty(5 << 20, dtype=torch.uint8, pin_memory=True)
    del cached
    behind_work("pinned host block, cached size",
                lambda: torch.empty(5 << 20, dtype=torch.uint8, pin_memory=True), results)
    host = torch.from_numpy(np.ones((7 << 18) + 13, np.float32))
    behind_work("pin_memory of a fresh size", lambda: host.pin_memory(), results)
    small = torch.ones((11 << 16) + 7, device=device)
    behind_work("to('cpu', non_blocking=True) of a fresh size",
                lambda: small.to("cpu", non_blocking=True), results)
    behind_work("device block, fresh size",
                lambda: torch.empty((97 << 20) + 5, dtype=torch.uint8, device=device), results)
    return results


def part_b(torch, out: dict) -> None:
    import chip_smoke
    from gordo_components_tpu_torch.server import engine as engine_mod

    records = []
    original_enqueue = engine_mod._Bucket._enqueue
    original_to_device = engine_mod._to_device
    local = {"to_device": []}

    def to_device(array, device):
        result, wall, cpu = timed(lambda: original_to_device(array, device))
        local["to_device"].append((wall, cpu))
        return result

    def enqueue(self, idxs, xs):
        if not set(self.names) & set(chip_smoke.SEAMS_PATCHTST) or self.device.type != "cuda":
            return original_enqueue(self, idxs, xs)
        local["to_device"] = []
        outputs, program_wall, program_cpu = timed(lambda: self._program(idxs, xs))
        host, tail_wall, tail_cpu = timed(lambda: (
            tuple(t.to("cpu", non_blocking=True) for t in outputs)))
        done = torch.cuda.Event(blocking=True)
        done.record(torch.cuda.current_stream(self.device))
        finished = done.query()
        copy_wall = sum(w for w, _ in local["to_device"])
        copy_cpu = sum(c for _, c in local["to_device"])
        records.append({"k": len(idxs), "input_copy_wall_ms": copy_wall,
                        "input_copy_cpu_ms": copy_cpu,
                        "launch_wall_ms": program_wall - copy_wall,
                        "launch_cpu_ms": program_cpu - copy_cpu,
                        "output_copy_wall_ms": tail_wall, "output_copy_cpu_ms": tail_cpu,
                        "device_done_at_return": finished})
        return host, done

    engine_mod._Bucket._enqueue = enqueue
    engine_mod._to_device = to_device
    card = chip_smoke.phase_environment()
    kernels = {"flash_fwd_f32": {"ms": 0.0}}
    try:
        with tempfile.TemporaryDirectory(prefix="enqueue-probe-") as tmp:
            chip_smoke.phase_seams(torch, torch.device("cuda"), tmp, kernels, card)
            out["phase_seams"] = "passed"
    except SystemExit as exc:
        out["phase_seams"] = f"exited {exc.code}"
    finally:
        engine_mod._Bucket._enqueue = original_enqueue
        engine_mod._to_device = original_to_device
    out["card"] = card
    out["patchtst_enqueues"] = records
    keys = [k for k in records[0] if k.endswith("_ms")] if records else []
    out["summary"] = {
        "dispatches": len(records),
        "device_done_at_return": sum(r["device_done_at_return"] for r in records),
        **{key: {q: float(np.percentile([r[key] for r in records], q)) for q in (50, 90, 99, 100)}
           for key in keys},
    }


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--out", default="chiprun_out/enqueue_probe.json")
    args = parser.parse_args()
    import torch

    if not torch.cuda.is_available():
        sys.exit("no CUDA device is available; this probe measures the card")
    out = {"part_a": part_a(torch)}
    print("part A (behind ~100 ms of queued work): " + json.dumps(out["part_a"]))
    part_b(torch, out)
    print("part B: " + json.dumps(out["summary"]))
    slow = sorted(out["patchtst_enqueues"], key=lambda r: -r["launch_wall_ms"])[:5]
    print("part B, the five slowest launches: " + json.dumps(slow))
    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    with open(args.out, "w") as f:
        json.dump(out, f, indent=1)


if __name__ == "__main__":
    main()
