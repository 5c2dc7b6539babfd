"""How the HTTP front's writes move the single-server phases, on the card.

The port's HTTP front (``server/httpd.py``) sends a response's head and
body in one write. Written apart, on a kept-alive connection Nagle holds
the body back until the peer's delayed ACK of the head (up to 40 ms on
Linux); TCP_NODELAY is the other cure. This A/B runs ``chip_smoke.py``'s
single-server phases under the front's variants, each run in a process of
its own, in the order given (``--order``; the default ``two,one,one,two``,
so that a drift of the host shows as a difference between the two runs of
one variant):

* ``one``: the front as it is (one write, Nagle on);
* ``two``: head and body in two writes, Nagle on;
* ``two-nodelay``: two writes, TCP_NODELAY set.

The phases, with their checks as ``chip_smoke.py`` runs them:

* phase 5 (``phase_fleet``): the dense, LSTM and PatchTST fleets' rounds,
  JSON and npz (req/s, p50, p99 a round);
* phase 11 (``phase_seams``): the request-seams traffic, recorder on and
  off (req/s and p50 a run, p99 a tenant class), given the fp32 flash
  kernel's time at the slice shape, measured in the run;
* phase 13 (``phase_control``): the skewed dense stage, loops off and on
  (req/s, p50, p99).

The clients open a connection per request (``urllib``), as in
``chip_smoke.py``. Run on the card from the root of a checkout (it builds
the kernels):

    python3 tools/torch_http_writes_ab.py [--order two,one,one,two]
        [--out chiprun_out/http_writes_ab.json]
"""
from __future__ import annotations

import argparse
import contextlib
import json
import os
import re
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

VARIANTS = ("one", "two", "two-nodelay")
# the printed lines whose JSON an arm keeps, by their prefix
KEPT = ("fleet dense round", "fleet lstm round", "fleet patchtst round",
        "seams: recorder on vs off", "seams: per class, recorder on",
        "seams: per class, recorder off", "control: the skewed dense stage")


class _Tee:
    def __init__(self):
        self.lines = []
        self._part = ""

    def write(self, text: str) -> int:
        sys.__stdout__.write(text)
        self._part += text
        *done, self._part = self._part.split("\n")
        self.lines.extend(done)
        return len(text)

    def flush(self) -> None:
        sys.__stdout__.flush()


def kept_records(lines: list) -> list:
    """(label, JSON) of each printed line that ``KEPT`` names; the card's
    bracketed name is dropped from the label."""
    records = []
    for line in lines:
        head, brace, rest = line.partition("{")
        label = re.sub(r"\s*\[[^\]]*\]", "", head).strip().rstrip(":").strip()
        if brace and label.startswith(KEPT):
            try:
                records.append((label, json.loads(brace + rest)))
            except ValueError:
                continue
    return records


def _two_writes(self, method: str) -> None:
    """``AppHandler._route`` with the head and the body written apart."""
    response = self.server.app.handle(method, self.path, self.headers, self.rfile.read(
        int(self.headers.get("Content-Length") or 0)))
    self.send_response(response.status)
    self.send_header("Content-Type", response.content_type)
    self.send_header("Content-Length", str(len(response.body)))
    for key, value in response.headers.items():
        self.send_header(key, value)
    self.end_headers()
    self.wfile.write(response.body)


def run_arm(arm: str, out: str) -> None:
    import torch

    import chip_smoke as cs
    from gordo_components_tpu_torch.ops import _kernels
    from gordo_components_tpu_torch.server import httpd
    from gordo_components_tpu_torch.utils.backend import resolve_device

    if arm.startswith("two"):
        httpd.AppHandler._route = _two_writes
    httpd.AppHandler.disable_nagle_algorithm = arm == "two-nodelay"
    device = resolve_device(None)
    card = cs.phase_environment()
    gen = torch.Generator(device=device).manual_seed(cs.SEED)
    q, k, v = (0.5 * torch.randn(cs.SLICE_SHAPE, generator=gen, device=device) for _ in range(3))
    scale = cs.SLICE_SHAPE[-1] ** -0.5
    flash_ms = cs.timed_ms(lambda: _kernels.flash_fwd_cuda(q, k, v, scale))
    del q, k, v
    torch.cuda.empty_cache()
    tee = _Tee()
    started = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="http-writes-ab-") as tmp, contextlib.redirect_stdout(tee):
        cs.phase_fleet(torch, device, tmp)
        cs.phase_seams(torch, device, tmp, {"flash_fwd_f32": {"ms": flash_ms}}, card)
        cs.phase_control(torch, device, tmp, card)
    with open(out, "w") as fh:
        json.dump({"arm": arm, "card": card, "flash_fwd_f32_ms": flash_ms,
                   "wall_s": time.perf_counter() - started,
                   "records": kept_records(tee.lines)}, fh)


def summary(arms: list) -> dict:
    """Per series and key: the values of each arm, in run order (a fleet's
    three rounds one after another)."""
    table = {}
    for arm in arms:
        for label, record in arm["records"]:
            if label.startswith("fleet"):
                rows = [(f"{re.sub(r' round \d+', '', label)} {record.get('wire')}", record)]
            else:
                rows = [(f"{label} {side}", r) for side, r in record.items()
                        if isinstance(r, dict)]
            for name, r in rows:
                for key in ("req_per_s", "p50_ms", "p99_ms"):
                    if key in r:
                        cell = table.setdefault(f"{name} {key}", {})
                        cell.setdefault(arm["arm"], []).append(r[key])
    return table


def main() -> None:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--out", default=os.path.join(ROOT, "chiprun_out", "http_writes_ab.json"))
    parser.add_argument("--order", default="two,one,one,two",
                        help=f"the runs' variants, comma-separated, of {', '.join(VARIANTS)}")
    parser.add_argument("--arm", choices=VARIANTS, help=argparse.SUPPRESS)
    parser.add_argument("--arm-out", help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.arm:
        run_arm(args.arm, args.arm_out)
        return
    order = args.order.split(",")
    if not set(order) <= set(VARIANTS):
        parser.error(f"--order: variants are {', '.join(VARIANTS)}")
    os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
    arms = []
    with tempfile.TemporaryDirectory(prefix="http-writes-ab-runs-") as tmp:
        for run, arm in enumerate(order):
            path = os.path.join(tmp, f"arm-{run}.json")
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--arm", arm,
                                   "--arm-out", path], cwd=ROOT)
            if proc.returncode != 0:
                sys.exit(f"arm {run} ({arm}) exited {proc.returncode}")
            with open(path) as fh:
                arms.append(json.load(fh))
    table = summary(arms)
    with open(args.out, "w") as fh:
        json.dump({"order": order, "arms": arms, "summary": table}, fh, indent=1)
    print(f"the HTTP front's variants, runs in the order {', '.join(order)} "
          f"[{arms[0]['card']}]; run walls {[round(a['wall_s'], 1) for a in arms]} s")
    for name, cell in table.items():
        print(f"{name}: " + " ".join(f"{variant} {values}" for variant, values in cell.items()))


if __name__ == "__main__":
    main()
