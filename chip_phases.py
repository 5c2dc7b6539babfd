"""Time chosen phases of ``chip_smoke.py`` in two checkouts on one card.

    python3 chip_phases.py OTHER_ROOT [PHASE ...]

Runs the named phases (default ``6 8b``: int8 serving and bf16 training)
of OTHER_ROOT's ``chip_smoke.py`` and of this checkout's, each in a fresh
process and in the order other, this, this, other, so that a drift of the
host shows as a difference within one side. Each process builds every
kernel first (not timed), as phases 1 and 2 would, and runs the phases
with the kernel-library store off, as ``chip_smoke.py`` runs them. A phase
must take ``(torch, device)`` and optionally a scratch directory
(``tmp``). Prints the card, then each run's walls in seconds as
``<label> WALLS {"phase": s, ...}``; exits non-zero if a run failed.
"""

from __future__ import annotations

import inspect
import json
import os
import subprocess
import sys
import tempfile
import time

# phase name -> chip_smoke.py function
PHASES = {"3": "phase_serve", "3b": "phase_serve_bf16", "4": "phase_zoo", "5": "phase_fleet",
          "6": "phase_int8", "7": "phase_surface", "8": "phase_train", "8b": "phase_train_bf16",
          "9": "phase_build", "9b": "phase_cli_build", "10": "phase_fleet_build"}


def child(root: str, label: str, names: list) -> None:
    """Run ``names`` of ``root``'s chip_smoke.py in this process."""
    root = os.path.abspath(root)
    sys.path.insert(0, root)
    os.chdir(root)
    os.environ.update({"GORDO_COMPILE_CACHE_STORE": "off", "GORDO_COMPILE_CACHE": "off"})
    import torch

    import chip_smoke
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.utils.backend import resolve_device

    if not chip_smoke.__file__.startswith(root):
        raise SystemExit(f"{label}: imported {chip_smoke.__file__}, not {root}'s")
    device = resolve_device(None)
    _kernels.build_all()
    walls = {}
    with tempfile.TemporaryDirectory(prefix=f"chip-phases-{label}-") as tmp:
        for name in names:
            fn = getattr(chip_smoke, PHASES[name])
            args = (torch, device, tmp) if "tmp" in inspect.signature(fn).parameters else (
                torch, device)
            started = time.perf_counter()
            fn(*args)
            walls[name] = round(time.perf_counter() - started, 1)
    print(f"{label} WALLS {json.dumps(walls)}", flush=True)


def main(argv: list) -> int:
    if len(argv) > 1 and argv[1] == "--child":
        child(argv[2], argv[3], argv[4:])
        return 0
    if len(argv) < 2:
        print(__doc__, file=sys.stderr)
        return 2
    other, names = argv[1], argv[2:] or ["6", "8b"]
    unknown = [name for name in names if name not in PHASES]
    if unknown:
        print(f"unknown phases {unknown}; known: {sorted(PHASES)}", file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True).stdout.strip())
    failed = 0
    for label, root in (("other", other), ("this", here), ("this-2", here), ("other-2", other)):
        run = subprocess.run([sys.executable, os.path.abspath(__file__), "--child", root, label,
                              *names], capture_output=True, text=True)
        walls = [line for line in run.stdout.splitlines() if " WALLS " in line]
        print(walls[-1] if walls else f"{label} exit {run.returncode}: {run.stderr[-2000:]}",
              flush=True)
        failed += run.returncode != 0
    return 1 if failed else 0


if __name__ == "__main__":
    sys.exit(main(sys.argv))
