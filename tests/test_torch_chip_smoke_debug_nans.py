"""How ``chip_smoke.py`` drives phase 23 (the numeric sanitizer,
``--debug-nans``), rehearsed on the CPU at a tiny size.

The slice machine is shrunk (d_model 16, 2 heads, 1 layer, 4 tags,
lookback 64) and written at fp32 and bf16 as phases 3 and 3b write it. The
whole phase then runs: the NaN-weight machine raises ``FloatingPointError``
from scoring and from an Adam step, a NaN born in a backward raises, an
``inf`` in q raises at ``gordo::flash_fwd`` (and without the flag the
operator marks the plain version's rows NaN), a ``run-server`` process with
``GORDO_DEBUG_NANS=1`` answers the clean machine 200 and the NaN one 503,
and the flagged fp32 and bf16 answers and Adam step give the unflagged
bytes. The only checks that fail here are the card's: the launch counts (a
CPU call is no kernel launch) and autograd's device thread (a CPU backward
runs on the calling thread).
"""

import os
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from gordo_components_tpu_torch.utils import backend  # noqa: E402


class _Failed(Exception):
    pass


def test_phase_23_rehearses_on_the_cpu(tmp_path, monkeypatch, capsys):
    failures = []

    def record(message):
        failures.append(message)
        if "launched" not in message and "device thread" not in message:
            raise _Failed(message)

    monkeypatch.setattr(chip_smoke, "fail", record)
    monkeypatch.setattr(chip_smoke, "SLICE", dict(patch_length=16, stride=8, d_model=16,
                                                  n_heads=2, n_layers=1, ff_dim=32))
    monkeypatch.setattr(chip_smoke, "N_TAGS", 4)
    monkeypatch.setattr(chip_smoke, "LOOKBACK", 64)
    monkeypatch.setattr(chip_smoke, "DN_DEVICE_ARGS", ("--device", "cpu"))
    monkeypatch.setattr(chip_smoke.sensor_rows, "__defaults__", (4,))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a, **k: None)
    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("GORDO_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")
    cpu = torch.device("cpu")
    chip_smoke.build_artifact(str(tmp_path / "turbine-long-window"), cpu)
    chip_smoke.build_artifact(str(tmp_path / "turbine-long-window-bf16"), cpu,
                              compute_dtype="bfloat16")

    launches = chip_smoke.phase_debug_nans(torch, cpu, str(tmp_path), "cpu")
    assert launches == dict.fromkeys(chip_smoke.KERNELS, 0)
    assert not backend.debug_nans_enabled()
    # the fp32 and bf16 answers' and the Adam step's launch checks, and the
    # backward's device thread: nothing else
    assert len(failures) == 4, failures
    assert sum("launched" in f for f in failures) == 3
    assert sum("device thread" in f for f in failures) == 1
    out = capsys.readouterr().out
    assert "scoring the NaN machine raised FloatingPointError: invalid value (nan)" in out
    assert "a fit step of the NaN machine raised FloatingPointError" in out
    assert "a NaN born in a CUDA backward raised FloatingPointError" in out
    assert "encountered in gordo::flash_fwd" in out
    assert "the NaN one 503" in out
    assert "unflagged -> flagged" in out
    assert os.path.islink(tmp_path / "debug-nans" / chip_smoke.DN_CLEAN)
