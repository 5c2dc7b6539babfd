"""How ``chip_smoke.py`` counts the fleet tier's kernel launches, on the CPU.

Phase 14's workers are processes: each runs the port's ``run-server``
through ``CLI_RUNNER``, which writes the process's launch counts at exit, and
the phase banks each worker's PatchTST dispatches off its ``/metrics``
before every engine swap. Here a real worker process (``--device cpu``)
started by the port's ``SubprocessWorker`` through that runner writes its
record when SIGTERM drains it, and ``/metrics`` counts the dispatches of
each bucket shape and compute dtype; then ``tier_launch_sums`` adds records that hold 3 launches per
PatchTST dispatch, leaves a SIGKILLed worker out, and names a record that
disagrees or is missing.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402

from gordo_components_tpu_torch.router import SubprocessWorker, WorkerSpec, server_worker_argv  # noqa: E402,E501
from gordo_components_tpu_torch.utils import http  # noqa: E402

LAYERS = chip_smoke.SLICE["n_layers"]


def test_a_worker_process_writes_its_launch_record_when_drained(tmp_path):
    from gordo_components_tpu.serializer import dump as ref_dump
    from test_torch_router import _free_port
    from test_torch_server_seams import BODY, TAGS, _fit

    root = tmp_path / "models"
    ref_dump(_fit(0), str(root / "dense-a"), metadata={"dataset": {"tag_list": TAGS}})
    record = tmp_path / "record.json"
    spec = WorkerSpec("worker-3", 3, "127.0.0.1", _free_port())
    argv = server_worker_argv(spec, str(root), device="cpu",
                              launcher=[sys.executable, "-c", chip_smoke.CLI_RUNNER, str(record)])
    assert argv[-2:] == ["--device", "cpu"] and "--worker-id" in argv
    log = open(tmp_path / "worker.log", "wb")
    worker = SubprocessWorker(spec, argv, env={"PYTHONPATH": str(ROOT),
                                               "GORDO_LEDGER_DIR": str(tmp_path / "ledger")},
                              stdout=log, stderr=subprocess.STDOUT)
    worker.start()
    try:
        end = time.monotonic() + 120
        while True:
            assert worker.alive(), (tmp_path / "worker.log").read_text()[-2000:]
            try:
                if http.get(spec.base_url + "/healthz", timeout=2).status_code == 200:
                    break
            except http.TransportError:
                pass
            assert time.monotonic() < end, "the worker did not boot"
            time.sleep(0.2)
        reply = http.Session().post(f"{spec.base_url}/gordo/v0/project/dense-a/anomaly/prediction",
                                    BODY, headers={"Content-Type": "application/json"})
        assert reply.status_code == 200 and reply.headers["X-Gordo-Worker"] == "3"
        engine = http.get(spec.base_url + "/metrics", timeout=10).json()["engine"]
        # the warm-up and the request: the bucket's dispatches, by shape and
        # compute dtype
        assert engine["bucket_dispatches"] == {f"L1f{len(TAGS)}/float32": {"dispatches": 2,
                                                                           "requests": 2}}
        worker.terminate(grace=60)
    finally:
        worker.kill()
        log.close()
    counts = json.loads(record.read_text())
    # CPU calls are no kernel launches: every count is there, and zero
    assert counts["launches"] == dict.fromkeys(chip_smoke.KERNELS, 0)
    assert counts["peak_bytes"] == 0


def _incarnation(tmp_path, name, launches, f32, bf16, killed=False):
    record = tmp_path / f"{name}.json"
    if launches is not None:
        record.write_text(json.dumps({"launches": launches, "peak_bytes": 0}))
    return {"name": name, "record": str(record), "banked": {"f32": f32, "bf16": bf16},
            "killed": killed}


def test_tier_launch_sums_add_the_records_of_the_drained_workers(tmp_path):
    zero = dict.fromkeys(chip_smoke.KERNELS, 0)
    good = [
        _incarnation(tmp_path, "worker-0-0", {**zero, "flash_fwd_f32": LAYERS * 7,
                                              "flash_fwd_bf16": LAYERS * 2}, 7, 2),
        _incarnation(tmp_path, "worker-1-1", {**zero, "flash_fwd_f32": LAYERS * 5}, 5, 0),
        # SIGKILLed: no record, and left out whatever its dispatches
        _incarnation(tmp_path, "worker-1-2", None, 40, 9, killed=True),
    ]
    sums, problems = chip_smoke.tier_launch_sums(good)
    assert problems == []
    assert sums == {**zero, "flash_fwd_f32": LAYERS * 12, "flash_fwd_bf16": LAYERS * 2}

    bad = good + [
        _incarnation(tmp_path, "worker-2-3", {**zero, "flash_fwd_f32": LAYERS * 3 + 1}, 3, 0),
        _incarnation(tmp_path, "worker-0-4", {**zero, "flash_bwd_f32": 3}, 0, 0),
        _incarnation(tmp_path, "worker-1-5", None, 1, 0),
    ]
    sums, problems = chip_smoke.tier_launch_sums(bad)
    assert [p.split(" ")[0] for p in problems] == ["worker-2-3", "worker-0-4", "worker-1-5:"]
    assert "no launch record" in problems[-1]
    # what the records say is still summed, so the kernels line shows it
    assert sums["flash_fwd_f32"] == LAYERS * 15 + 1 and sums["flash_bwd_f32"] == 3
