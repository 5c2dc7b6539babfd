"""``BENCHMARK.json`` and the files it names, found by name: a cell's
configuration in ``configs/<name>.json``, its traffic mix in
``traffic/<name>.json`` and each metric's reader in ``metrics/<name>.py``.
A later cell, mix or metric is a new file and a new entry; no file here
changes for it."""

from __future__ import annotations

import importlib.util
import json
import os
import re
from typing import Callable, Dict, List

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def load(root: str) -> Dict:
    with open(os.path.join(root, "BENCHMARK.json")) as fh:
        return json.load(fh)


def cell(manifest: Dict, name: str) -> Dict:
    for workload in manifest["workloads"]:
        if workload["name"] == name:
            return workload
    raise KeyError(f"no workload {name!r} in BENCHMARK.json")


def config(manifest: Dict, root: str, name: str) -> Dict:
    for entry in manifest["configs"]:
        if entry["name"] == name:
            with open(os.path.join(root, entry["file"])) as fh:
                return json.load(fh)
    raise KeyError(f"no configuration {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: str = BENCH_DIR) -> Dict:
    with open(os.path.join(bench_dir, "traffic", f"{name}.json")) as fh:
        return json.load(fh)


def reader(name: str, bench_dir: str = BENCH_DIR) -> Callable:
    """``metrics/<name>.py``'s ``read(run)``."""
    path = os.path.join(bench_dir, "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(f"portbench_metric_{name}", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module.read


def metrics_of(manifest: Dict, workload: str, traced: bool) -> List[Dict]:
    """The cell's end-to-end metrics (untraced) or its per-layer ones
    (traced): an entry with ``workloads`` names the cells; a per-layer one
    without it goes wherever the metric it moves is reported."""
    e2e = [m for m in manifest["end_to_end"]
           if "workloads" not in m or workload in m["workloads"]]
    if not traced:
        return e2e
    moved = {m["name"] for m in e2e}
    return [m for m in manifest["per_layer"]
            if workload in m.get("workloads", [workload] if m["moves"] in moved else [])]


def problems(manifest: Dict) -> List[str]:
    """What breaks the manifest's naming rules, or names a file that is not
    there."""
    out = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        seen = set()
        for entry in manifest[group]:
            name = entry["name"]
            if not NAME.match(name) or name in seen:
                out.append(f"{group}: bad or repeated name {name!r}")
            seen.add(name)
            if "unit" in entry and not UNIT.match(entry["unit"]):
                out.append(f"{group}: bad unit {entry['unit']!r} of {name!r}")
    for entry in manifest["configs"]:
        out += [f"configs: bad reduced key {k!r}" for k in entry["reduced"] if not NAME.match(k)]
    for entry in manifest["workloads"]:
        for key in ("config", "traffic"):
            if not NAME.match(entry[key]):
                out.append(f"workloads: bad {key} {entry[key]!r}")
        if not os.path.exists(os.path.join(BENCH_DIR, "traffic", f"{entry['traffic']}.json")):
            out.append(f"workloads: no traffic file for {entry['traffic']!r}")
    for entry in manifest["end_to_end"] + manifest["per_layer"]:
        if not os.path.exists(os.path.join(BENCH_DIR, "metrics", f"{entry['name']}.py")):
            out.append(f"metrics: no reader for {entry['name']!r}")
    return out
