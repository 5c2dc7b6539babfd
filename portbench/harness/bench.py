"""One run of one cell: set-up, the measured window, the comparison with
the reference, and the result line.

Set-up makes the fleet's rows and weights from the seed, starts the load
generator (``loadgen.py``, a child process) with the request bodies, writes
one artifact per machine through the program's serializer, boots the
program's HTTP server in this process (``make_server``, as ``run-server``
builds it, its kernel-library store inside the checkout) and warms it up
with the fused batch sizes the window dispatches. The window is the
generator's traffic for ``seconds``; a traced run profiles it. Then the
server is closed and its memory freed, and the plain reference scores a
sample of the answered requests, drawn from the seed, on the same device.
"""

from __future__ import annotations

import gc
import json
import logging
import math
import os
import shutil
import subprocess
import sys
import tempfile
import threading
import time
import urllib.request
from typing import Dict, List, Optional

import numpy as np

from . import compare, data, manifest as manifest_mod, traffic as traffic_mod
from .readings import Run, parse_prometheus

FOREIGN = ("jax", "jaxlib", "flax", "gordo_components_tpu")
GRACE_S = 60.0
LOADGEN = os.path.join(os.path.dirname(os.path.abspath(__file__)), "loadgen.py")


class RunError(Exception):
    """A run that cannot give a result."""


def foreign_modules(names=None) -> List[str]:
    """Top-level names among ``names`` (default: ``sys.modules``) that are
    JAX or the JAX package, each compared whole."""
    return sorted({name.split(".")[0] for name in list(names or sys.modules)} & set(FOREIGN))


class LoadGen:
    """The child process and its line protocol (see ``loadgen.py``)."""

    def __init__(self, plan: Dict, bodies: List[np.ndarray]):
        self.proc = subprocess.Popen([sys.executable, "-I", "-S", LOADGEN],
                                     stdin=subprocess.PIPE, stdout=subprocess.PIPE)
        self.proc.stdin.write(json.dumps(plan).encode() + b"\n")
        for rows in bodies:
            self.proc.stdin.write(rows.astype("<i8").tobytes())
        self.proc.stdin.flush()

    def expect(self, word: str) -> str:
        line = self.proc.stdout.readline().decode()
        if not line.startswith(word):
            raise RunError(f"load generator said {line!r}, expected {word!r}")
        return line[len(word):].strip()

    def command(self, **cmd) -> None:
        self.proc.stdin.write(json.dumps(cmd).encode() + b"\n")
        self.proc.stdin.flush()

    def close(self) -> None:
        if self.proc.poll() is None:
            try:
                self.proc.stdin.close()
                self.proc.wait(timeout=30)
            except (OSError, subprocess.TimeoutExpired):
                self.proc.kill()
                self.proc.wait()


def _get(url: str) -> str:
    with urllib.request.urlopen(url, timeout=60) as resp:
        return resp.read().decode()


def run_cell(root: str, manifest: Dict, workload: str, seed: int, seconds: float,
             traced: bool, device, started: float, bench_dir: str = manifest_mod.BENCH_DIR,
             rate: Optional[float] = None) -> Dict:
    """One run; returns the result line's object. ``started`` is the
    process's start on ``time.monotonic()``; ``rate`` overrides an open
    loop's rate (the knee sweep)."""
    import torch

    cell = manifest_mod.cell(manifest, workload)
    config = manifest_mod.config(manifest, root, cell["config"])
    traffic = manifest_mod.traffic(cell["traffic"], bench_dir)
    model, tags = config["model"], config["n_tags"]
    device = torch.device(device)
    n_rows = traffic_mod.rows_per_request(traffic, model["lookback_window"])
    names = [f"{cell['config']}-m{i:03d}" for i in range(traffic["fleet"])]
    seed = int(seed) % 2 ** 63
    history, residuals = data.machine_data(seed, traffic["fleet"], tags,
                                           traffic["bodies_per_machine"], n_rows)
    plan = traffic_mod.plan(traffic, seed, seconds, rate)
    bodies = [history[m][j * n_rows:(j + 1) * n_rows]
              for m in range(traffic["fleet"]) for j in range(traffic["bodies_per_machine"])]
    gen = LoadGen({"shapes": [list(b.shape) for b in bodies], "machines": plan["bodies"],
                   "paths": [f"/gordo/v0/project/{names[m]}/{traffic['route']}"
                             for m in plan["bodies"]],
                   "order": plan["order"], "due": plan["due"],
                   "clients": traffic.get("clients", 1), "threads": traffic.get("threads", 1)},
                  bodies)
    tmp = tempfile.mkdtemp(prefix="portbench-")
    httpd = thread = None
    marks = {"data": time.monotonic()}
    try:
        served = torch.bfloat16 if config["precision"] == "bf16" else torch.float32
        weights = data.make_weights(model, traffic["fleet"], seed, device, served).cpu().numpy()
        marks["weights"] = time.monotonic()
        models_dir = os.path.join(tmp, "models")
        data.write_artifacts(models_dir, names, model, config["precision"], weights, history,
                             residuals)
        marks["artifacts"] = time.monotonic()
        from gordo_components_tpu_torch.server.server import make_server

        # the kernel-library store: a fixed directory in the checkout; a
        # run that finds it empty builds the libraries (a checkout's first)
        store = os.path.join(bench_dir, ".cache", "kernels")
        compiled = not (os.path.isdir(store) and os.listdir(store))
        httpd = make_server(models_dir, port=0, device=device, compile_cache_store=store)
        port = httpd.server_address[1]
        thread = threading.Thread(target=httpd.serve_forever, daemon=True)
        thread.start()
        marks["boot"] = time.monotonic()
        gen.expect("ready")
        gen.command(cmd="warmup", port=port, rounds=traffic["warmup_rounds"])
        warm = json.loads(gen.expect("warm"))
        if any(status != 200 for batch in warm for status in batch):
            raise RunError(f"warm-up answered {warm}")
        marks["warmup"] = time.monotonic()
        cuda = device.type == "cuda"
        base = f"http://127.0.0.1:{port}"
        trace = None
        prom = {"before": parse_prometheus(_get(base + "/metrics?format=prometheus"))}
        if traced:
            from .trace import Trace

            trace = Trace()
            time.sleep(0.5)
        if cuda:
            # the device's peak is the window's own, not the warm-up's
            torch.cuda.synchronize(device)
            torch.cuda.reset_peak_memory_stats(device)
        t0 = time.monotonic() + 0.05
        t1 = t0 + seconds
        gen.command(cmd="run", port=port, t0=t0, seconds=seconds, grace=GRACE_S)
        time.sleep(max(0.0, t1 - time.monotonic()))
        window_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        prom["after"] = parse_prometheus(_get(base + "/metrics?format=prometheus"))
        if traced:
            trace = trace.stop(t0, t1)
        size = int(gen.expect("done"))
        blob = gen.proc.stdout.read(size)
        collected = time.monotonic()
        head, payload = blob.split(b"\n", 1)
        raw = json.loads(head)
        # the window's peak, with the requests that were out at its close
        memory_peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        foreign = foreign_modules()
        if foreign:
            raise RunError(f"the window loaded {foreign}")
    finally:
        gen.close()
        if httpd is not None:
            if thread is not None:
                httpd.shutdown()
                thread.join(timeout=60)
            httpd.server_close()
        httpd = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        shutil.rmtree(tmp, ignore_errors=True)

    records, bodies_out, at = [], [], 0
    for body, due, sent, done, status, nbytes, error in raw:
        records.append({"body": body, "due": due, "sent": sent, "done": done,
                        "status": status, "error": error,
                        "windows": traffic["windows_per_request"]})
        bodies_out.append(payload[at:at + nbytes])
        at += nbytes
    run = Run(cell=cell, config=config, traffic=traffic, t0=t0, t1=t1,
              setup_s=t0 - started, collected=collected, records=records,
              memory_window_bytes=window_peak, prom=prom, trace=trace)
    checks = check(run, bodies_out, plan, weights, history, residuals, seed, device,
                   traffic["compare_sample"])
    due = run.due_in_window()
    result = {
        "correct": compare.judge(checks, config["limits"]) and not run.extra.get("unanswered"),
        "attempted": len(due),
        "failed": sum(1 for r in due if not run.ok(r)),
        "metrics": {},
        "device": {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(memory_peak)},
    }
    for metric in manifest_mod.metrics_of(manifest, workload, traced):
        value = manifest_mod.reader(metric["name"], bench_dir)(run)
        if value is not None:
            result["metrics"][metric["name"]] = {"value": float(value), "unit": metric["unit"]}
    if traced:
        result["device"]["busy_s"] = trace["busy_s"]
        result["device"]["window_s"] = trace["window_s"]
        result["breakdown"] = trace["breakdown"]
    lateness = [r["sent"] - r["due"] for r in due if r["due"] is not None and r["sent"]]
    run.extra["generator_late_ms"] = {
        "p50": 1e3 * float(np.median(lateness)) if lateness else 0.0,
        "max": 1e3 * max(lateness) if lateness else 0.0}
    run.extra.update(_backlog(run, due))
    run.extra["compiled"] = compiled
    run.extra["dispatch_batch_le"] = {
        le: run.prom_delta("gordo_engine_dispatch_batch_size_bucket", le=le)
        for le in ("1", "2", "4", "8", "16", "+Inf")}
    steps, last = {}, started
    for step in ("data", "weights", "artifacts", "boot", "warmup"):
        steps[step], last = marks[step] - last, marks[step]
    steps["to_window"] = t0 - last
    run.extra["setup_split_s"] = steps
    result["checks"] = {name: {"value": _finite(checks[name]), "limit": config["limits"][name]}
                        for name in compare.NUMBERS}
    result["checks"]["unanswered_in_sample"] = {"value": run.extra.get("unanswered", 0),
                                                "limit": 0}
    result["_extra"] = run.extra
    return result


def _backlog(run: Run, due: List[Dict]) -> Dict[str, float]:
    """Whether a backlog grew through the window: the median latency of the
    first and the last quarter of the requests due, and the answers'
    rate."""
    latencies = [1e3 * run.latency_s(r) for r in due]
    quarter = max(1, len(latencies) // 4)
    answered = sum(1 for r in due if run.ok(r))
    return {"latency_p50_ms": float(np.median(latencies)) if latencies else 0.0,
            "latency_first_quarter_ms": float(np.median(latencies[:quarter])) if latencies else 0.0,
            "latency_last_quarter_ms": float(np.median(latencies[-quarter:])) if latencies else 0.0,
            "answered_per_s": answered / run.window_s}


def _finite(value: float) -> float:
    """JSON has no infinity: a missing or malformed answer reads 1e30."""
    return value if math.isfinite(value) else 1e30


def check(run: Run, bodies_out: List[bytes], plan: Dict, weights: np.ndarray,
          history: List[np.ndarray], residuals: List[np.ndarray], seed: int, device,
          sample: int) -> Dict[str, float]:
    """Score a sample of the window's requests, drawn from the seed, with
    the plain reference, and compare: the worst of each number."""
    import torch

    from reference import patchtst

    cfg = run.config
    model = cfg["model"]
    owed = {id(r) for r in run.due_in_window()}
    due = [i for i, r in enumerate(run.records) if id(r) in owed]
    rng = np.random.default_rng([seed, 3])
    picked = sorted(rng.choice(due, size=min(sample, len(due)), replace=False).tolist()) if due else []
    run.extra["compared"] = len(picked)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    n_rows = traffic_mod.rows_per_request(run.traffic, model["lookback_window"])
    per = run.traffic["bodies_per_machine"]
    readings, unanswered = [], 0
    started = time.monotonic()
    for i in picked:
        rec = run.records[i]
        if rec["status"] != 200:
            unanswered += 1
            continue
        m = plan["bodies"][rec["body"]]
        j = rec["body"] - m * per
        rows = torch.from_numpy(data.as_float(history[m][j * n_rows:(j + 1) * n_rows])).to(device)
        machine_rows = torch.from_numpy(data.as_float(history[m])).to(device)
        scalers = {"x": patchtst.minmax(machine_rows), "y": patchtst.minmax(machine_rows),
                   "e": patchtst.minmax(torch.from_numpy(residuals[m]).to(device))}
        tree = data.tree_of(torch.from_numpy(weights[m]).to(device), model)
        with torch.no_grad():
            ref = patchtst.score(tree, scalers, rows, model, "fp32")
        ref = {k: v.cpu().numpy() for k, v in ref.items()}
        readings.append(compare.gaps(compare.decode(bodies_out[i]), ref))
    run.extra["unanswered"] = unanswered
    run.extra["reference_s"] = time.monotonic() - started
    return compare.worst(readings) if readings else dict.fromkeys(compare.NUMBERS, math.inf)


def main(argv: Optional[List[str]] = None, started: Optional[float] = None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description="One run of one benchmark cell.")
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    parser.add_argument("--rate", type=float, default=None,
                        help="an open loop's offered rate, requests/s (the knee sweep)")
    args = parser.parse_args(argv)
    started = time.monotonic() if started is None else started
    root = os.getcwd()
    if not (os.path.isdir(os.path.join(root, "gordo_components_tpu_torch"))
            and os.path.exists(os.path.join(root, "BENCHMARK.json"))):
        print("portbench: run from the root of a checkout that holds the program "
              "(gordo_components_tpu_torch/) and BENCHMARK.json", file=sys.stderr)
        return 2
    manifest = manifest_mod.load(root)
    chips = manifest_mod.cell(manifest, args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"portbench: {args.workload} needs {chips} CUDA device(s); "
              f"available: {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 3
    logging.basicConfig(level=logging.WARNING)
    try:
        result = run_cell(root, manifest, args.workload, args.seed, args.seconds,
                          bool(args.trace), "cuda:0", started, rate=args.rate)
    except RunError as exc:
        print(f"portbench: {exc}", file=sys.stderr)
        return 1
    extra = result.pop("_extra")
    foreign = foreign_modules()
    if foreign:
        print(f"portbench: the process loaded {foreign}", file=sys.stderr)
        return 1
    print(json.dumps({"portbench_run": extra}))
    for name, entry in result["checks"].items():
        print(f"check {name} {entry['value']!r} limit {entry['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
