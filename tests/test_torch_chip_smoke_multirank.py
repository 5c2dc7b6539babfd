"""How ``chip_smoke.py`` drives phase 19 (the fleet build as two ranks),
rehearsed on the CPU at a tiny size.

``FLEET_BUILD`` is shrunk (narrow dense, LSTM and PatchTST machines, few
rows), phase 19's fleet to 4 dense, 2 LSTM and 2 PatchTST machines in
slices of 2, and every fleet-build gets ``--device cpu``. The whole phase
then runs: the one-rank build, the two ranks (their manifests must
partition the fleet as ``mr_owners`` says, contiguous spans of each
slice), the wedge drill (the journal poll stops rank 1 once both ranks
committed their share of dense slice 0; rank 0 exits 75 with the
watchdog's line within its budget), the re-run (the committed machines
resumed, every machine equal to the one-rank build, no checkpoint left).
The only checks that fail here are the flash launch counts: a CPU call is
no kernel launch.
"""

import os
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


class _Failed(Exception):
    pass


def _tiny_fleet():
    patchtst = dict(kind="patchtst", lookback_window=64, attention_impl="flash", batch_size=8,
                    epochs=1, patch_length=16, stride=8, d_model=16, n_heads=2, n_layers=1,
                    ff_dim=32)
    return {
        "dense": (16, "DenseAutoEncoder", dict(kind="feedforward_hourglass", batch_size=32,
                                               epochs=1), 3, 144, {"n_splits": 2}),
        "lstm": (4, "LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[4], lookback_window=6,
                                            batch_size=32, epochs=1), 2, 72, {"n_splits": 1}),
        "patchtst": (2, "PatchTSTAutoEncoder", patchtst, 2, 64 + 31,
                     {"n_splits": 1, "cv_parallel": False}),
    }


def test_owners_are_contiguous_blocks_of_each_slice():
    config = chip_smoke.fleet_build_config(chip_smoke.MR_COUNTS, chip_smoke.MR_PREFIX)
    owners = chip_smoke.mr_owners(config)
    dense = [owners[f"mr-dense-{i:03d}"] for i in range(16)]
    assert dense == [0] * 4 + [1] * 4 + [0] * 4 + [1] * 4
    assert [owners[f"mr-lstm-{i:03d}"] for i in range(4)] == [0, 0, 1, 1]
    assert [owners[f"mr-patchtst-{i:03d}"] for i in range(2)] == [0, 1]


def test_phase_19_rehearses_on_the_cpu(tmp_path, monkeypatch):
    failures = []

    def record(message):
        failures.append(message)
        if "launch" not in message:
            raise _Failed(message)

    monkeypatch.setattr(chip_smoke, "fail", record)
    monkeypatch.setattr(chip_smoke, "FLEET_BUILD", _tiny_fleet())
    monkeypatch.setattr(chip_smoke, "MR_COUNTS", {"dense": 4, "lstm": 2, "patchtst": 2})
    monkeypatch.setattr(chip_smoke, "MR_SLICE", 2)
    monkeypatch.setattr(chip_smoke, "LOOKBACK", 64)
    # a slice here takes well under a second; the floor allows for a loaded host
    monkeypatch.setattr(chip_smoke, "MR_WATCHDOG_FLOOR_S", 15.0)
    monkeypatch.setattr(chip_smoke, "MR_DEVICE_ARGS", ("--device", "cpu"))
    monkeypatch.setattr(chip_smoke.sensor_rows, "__defaults__", (2,))
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda: None)
    monkeypatch.setattr(torch.cuda, "memory_reserved", lambda: 0)
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda: 0)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    launches = chip_smoke.phase_multirank(torch, torch.device("cpu"), str(tmp_path), "cpu")
    assert launches == dict.fromkeys(chip_smoke.KERNELS, 0)
    # the one-rank build, each rank of B and of the re-run: their launch
    # checks, and nothing else
    assert len(failures) == 5 and all("launch" in f for f in failures), failures
    owned = {r: sorted(m["machines"]) for r, m in
             enumerate(chip_smoke.mr_manifests(str(tmp_path / "mr-B")))}
    assert owned == {0: ["mr-dense-000", "mr-dense-002", "mr-lstm-000", "mr-patchtst-000"],
                     1: ["mr-dense-001", "mr-dense-003", "mr-lstm-001", "mr-patchtst-001"]}
    with open(tmp_path / "mr-wedge-rank0.log") as fh:
        log = fh.read()
    assert "Fleet slice watchdog" in log and "exiting 75" in log
    assert not os.path.isdir(tmp_path / "mr-C" / ".slice_checkpoints")
