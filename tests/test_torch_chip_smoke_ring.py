"""How ``chip_smoke.py`` drives phase 22 (ring attention over two gloo
ranks), rehearsed on the CPU at a tiny size.

The slice machine is shrunk (d_model 16, 2 heads, 1 layer, 4 tags) and
the ring's kernel-level inputs to 2 windows; the ring's lookback is 1048
(130 patches, 65 a rank: past one tile, so that ``flash_attention`` takes
the kernel's plain version, as it takes the kernel on the card). The
whole phase then runs: two rank processes of the script join one gloo
group through a ``file://`` store, run ``ring`` and
``ring_flash`` at fp32 and ``ring_flash`` at bf16 against
``flash_attention`` and the plain version, time a K/V hop, fit the machine
at ``ring_flash`` for two Adam steps (equal losses on both ranks, within
TRAIN_RTOL of the one-process ``flash`` fit), and the engine scores the
``ring_flash`` machine at one rank as the ``flash`` one. The only checks
that fail here are the launch counts: a CPU call is no kernel launch.
"""

import json
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


class _Failed(Exception):
    pass


def test_phase_22_rehearses_on_the_cpu(tmp_path, monkeypatch):
    failures = []

    def record(message):
        failures.append(message)
        if "launch" not in message:
            raise _Failed(message)

    monkeypatch.setattr(chip_smoke, "fail", record)
    monkeypatch.setattr(chip_smoke, "SLICE", dict(patch_length=16, stride=8, d_model=16,
                                                  n_heads=2, n_layers=1, ff_dim=32))
    monkeypatch.setattr(chip_smoke, "N_TAGS", 4)
    monkeypatch.setattr(chip_smoke, "LOOKBACK", 64)
    monkeypatch.setattr(chip_smoke, "RING_LOOKBACK", 1048)
    monkeypatch.setattr(chip_smoke, "RING_WINDOWS", 2)
    monkeypatch.setattr(chip_smoke, "RING_TIMEOUT_S", 120.0)
    monkeypatch.setattr(chip_smoke.sensor_rows, "__defaults__", (4,))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    launches = chip_smoke.phase_ring(torch, torch.device("cpu"), str(tmp_path), "cpu")
    assert launches == dict.fromkeys(chip_smoke.KERNELS, 0)
    # each rank's two ring_flash calls and its fit, and the engine's two
    # machines: their launch checks, and nothing else
    assert len(failures) == 8 and all("launch" in f for f in failures), failures
    config = json.loads((tmp_path / "ring" / chip_smoke.RING_CONFIG).read_text())
    assert config["shape"] == [8, 130, 2, 8]
    for rank in range(chip_smoke.RING_WORLD):
        ranked = json.loads((tmp_path / "ring" / f"ring-rank{rank}.json").read_text())
        assert set(ranked["calls"]) == {label for label, _, _ in chip_smoke.RING_CALLS}
        assert len(ranked["fit"]["history"]) == chip_smoke.RING_TRAIN_STEPS
        for call in ranked["calls"].values():
            assert call["errors"] and all(err <= atol for err, atol in call["errors"].values())
