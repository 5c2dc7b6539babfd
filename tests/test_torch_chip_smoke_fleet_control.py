"""How ``chip_smoke.py`` sets up phase 16 (fleet control), on the CPU.

- The plan's design: the hot and paced machines ``FC_HOT`` and
  ``FC_PACED`` are the first pair (sorted) for which the port's layout
  compiler, over every rate combination of ``FC_RATES`` at cap
  ``FC_CAP``, keeps them the two residents, hints both lazy machines and
  moves both off the worker that holds them after the warm-up; the
  reference's compiler plans the same. The documents the design compiles
  are valid layout-input documents in both packages.
- ``FLEET_RUNNER``: ``cli run-fleet-server`` under it answers, exits 0 on
  SIGTERM, and leaves one launch record per worker process.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import time
from itertools import product
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402
import test_torch_server_seams as dense  # noqa: E402

from gordo_components_tpu.layout import compile_plan as ref_compile_plan  # noqa: E402
from gordo_components_tpu.observability.telemetry import (  # noqa: E402
    validate_layout_input as ref_validate_input,
)
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu_torch.layout import compile_plan  # noqa: E402
from gordo_components_tpu_torch.observability.telemetry import validate_layout_input  # noqa: E402
from gordo_components_tpu_torch.router.placement import HashRing  # noqa: E402
from gordo_components_tpu_torch.utils import http  # noqa: E402


def _rates(hot, paced, combo):
    h, p, sl, lz = combo
    return {hot: h, paced: p, chip_smoke.FC_SLICE: sl,
            **dict.fromkeys(chip_smoke.FC_LAZY.values(), lz)}


def test_the_design_moves_both_lazy_machines_in_every_combination():
    home, moved, combos = chip_smoke.fc_design(chip_smoke.FC_HOT, chip_smoke.FC_PACED)
    assert moved == combos == 54
    ring = HashRing(chip_smoke.FC_WORKERS, vnodes=64)
    assert ring.primary(chip_smoke.FC_HOT) == home != ring.primary(chip_smoke.FC_PACED)
    # the lazy machines sort after the eager ones: GORDO_BOOT_EAGER leaves
    # exactly them lazy
    names = sorted([*chip_smoke.FC_DENSE, chip_smoke.FC_SLICE, chip_smoke.FC_EAGER,
                    *chip_smoke.FC_LAZY.values()])
    assert sorted(names[chip_smoke.FC_EAGER_N:]) == sorted(chip_smoke.FC_LAZY.values())


def test_the_design_pair_is_the_first_that_moves_in_every_combination():
    ring = HashRing(chip_smoke.FC_WORKERS, vnodes=64)
    home = ring.primary(next(iter(chip_smoke.FC_LAZY.values())))
    first = None
    for hot in chip_smoke.FC_DENSE:
        if ring.primary(hot) != home:
            continue
        for paced in chip_smoke.FC_DENSE:
            if ring.primary(paced) == home:
                continue
            design = chip_smoke.fc_design(hot, paced)
            if design is not None and design[1] == design[2]:
                first = (hot, paced)
                break
        if first:
            break
    assert first == (chip_smoke.FC_HOT, chip_smoke.FC_PACED)


@pytest.mark.parametrize("combo", list(product(*chip_smoke.FC_RATES.values()))[::5])
def test_the_design_documents_are_valid_and_plan_alike_in_both_packages(combo):
    doc = chip_smoke.fc_layout_doc(_rates(chip_smoke.FC_HOT, chip_smoke.FC_PACED, combo))
    assert validate_layout_input(doc) == [] == ref_validate_input(doc)
    ours = compile_plan(doc, residency_cap=chip_smoke.FC_CAP, parity_budget=0.0)
    theirs = ref_compile_plan(doc, residency_cap=chip_smoke.FC_CAP, parity_budget=0.0)
    assert json.dumps(ours, sort_keys=True) == json.dumps(theirs, sort_keys=True)
    hinted, resident = chip_smoke.fc_plan_outcome(ours)
    assert set(hinted.values()) == {HashRing(chip_smoke.FC_WORKERS).primary(chip_smoke.FC_PACED)}
    assert sorted(sum(resident.values(), [])) == sorted([chip_smoke.FC_HOT, chip_smoke.FC_PACED])


def test_plan_outcome_reads_hints_and_residents():
    plan = {"prefetch": {"w1": ["x", chip_smoke.FC_LAZY["float32"]]},
            "residency": {"workers": {"w0": {"resident": ["a"]}, "w1": {"resident": []}}}}
    hinted, resident = chip_smoke.fc_plan_outcome(plan)
    assert hinted == {chip_smoke.FC_LAZY["float32"]: "w1", chip_smoke.FC_LAZY["bfloat16"]: None}
    assert resident == {"w0": ["a"], "w1": []}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def test_fleet_runner_records_each_worker_process(tmp_path):
    models = tmp_path / "models"
    ref_dump(dense._fit(0), str(models / "dn"), metadata={"dataset": {"tag_list": dense.TAGS}})
    records = tmp_path / "records"
    records.mkdir()
    port, worker_port = _free_port(), _free_port()
    base = f"http://127.0.0.1:{port}"
    log = open(tmp_path / "fleet.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-c", chip_smoke.FLEET_RUNNER, str(records), chip_smoke.CLI_RUNNER,
         "run-fleet-server", "--models-dir", str(models), "--workers", "1", "--host",
         "127.0.0.1", "--port", str(port), "--worker-base-port", str(worker_port),
         "--probe-interval", "0.5", "--device", "cpu"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "GORDO_LEDGER_DIR": str(tmp_path / "l")})
    try:
        end = time.monotonic() + 180
        while time.monotonic() < end:
            assert proc.poll() is None, (tmp_path / "fleet.log").read_text()[-3000:]
            try:
                if http.get(f"{base}/healthz", timeout=2.0).status_code == 200:
                    break
            except http.TransportError:
                pass
            time.sleep(0.3)
        reply = http.Session().post(f"{base}/gordo/v0/project/dn/anomaly/prediction",
                                    dense.BODY, timeout=60,
                                    headers={"Content-Type": "application/json"})
        assert reply.status_code == 200
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()
    assert sorted(os.listdir(records)) == ["worker-0-0.json"]
    record = json.loads((records / "worker-0-0.json").read_text())
    assert record["launches"] == dict.fromkeys(chip_smoke.KERNELS, 0)  # CPU calls launch none
