"""How ``chip_smoke.py`` drives phase 21 (the host-sharded capacity mode and
the partial residency tier), rehearsed on the CPU at a tiny size.

- The phase's sources: every machine is a phase 14 or 15 artifact that
  those phases leave as built (phase 14's generation root and its slowed
  machine are left out), and the names give the buckets the phase counts.
- The phase itself at tiny widths (``SLICE`` d_model 16, 2 heads, 1 layer;
  ``LOOKBACK`` 64; 4 tags), with phase 14's and 15's roots absent so that it
  builds its machines, and the shard server on ``--device cpu``. Every
  check runs but the store's (``cache warm`` and the no-``nvcc`` boot need
  the card's toolkit, and a CPU engine resolves no kernel library); the
  only ones that fail here are the two launch counts (a CPU call is no
  kernel launch).
"""

import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402


class _Failed(Exception):
    pass


def test_the_sources_are_artifacts_their_phases_leave_as_built():
    sources = chip_smoke.SHARD_SOURCES
    names = [*chip_smoke.SHARD_DENSE, *chip_smoke.SHARD_SLICE.values(), chip_smoke.SHARD_INT8,
             chip_smoke.SHARD_ADDED]
    assert sorted(sources) == sorted(names) and len(set(names)) == len(names)
    tier = [source for phase, source in sources.values() if phase == "tier"]
    assert len(set(tier)) == len(tier)
    assert set(tier) <= set(chip_smoke.TIER_MACHINES) - {chip_smoke.TIER_RELOAD,
                                                         chip_smoke.TIER_SLOW}
    assert sources[chip_smoke.SHARD_INT8] == ("spill", chip_smoke.SPILL_INT8)
    assert sources[chip_smoke.SHARD_SLICE["bfloat16"]] == ("tier", chip_smoke.TIER_BF16)
    assert sources[chip_smoke.SHARD_SLICE["float32"]][1] in chip_smoke.TIER_PATCHTST
    # the partial bucket is partial, and the resize grows it
    assert len(chip_smoke.SHARD_DENSE) > chip_smoke.SHARD_RESIZED > chip_smoke.SHARD_RESIDENCY
    assert chip_smoke.SIDE_PHASES[-1] == "21 shard"
    assert chip_smoke.SIDE_PHASES.index("21 shard") > chip_smoke.SIDE_PHASES.index("15 spill")


def test_phase_21_rehearses_on_the_cpu(tmp_path, monkeypatch):
    failures = []

    def record(message):
        failures.append(message)
        if "launch" not in message:
            raise _Failed(message)

    monkeypatch.setattr(chip_smoke, "fail", record)
    monkeypatch.setattr(chip_smoke, "SLICE", dict(patch_length=16, stride=8, d_model=16,
                                                  n_heads=2, n_layers=1, ff_dim=32))
    monkeypatch.setattr(chip_smoke, "LOOKBACK", 64)
    monkeypatch.setattr(chip_smoke, "N_TAGS", 4)
    monkeypatch.setattr(chip_smoke.sensor_rows, "__defaults__", (4,))
    monkeypatch.setattr(torch.cuda, "synchronize", lambda: None)
    for name in ("GORDO_MESH_SHARDS", "GORDO_MESH_SHARD", "GORDO_LEDGER_DIR", "GORDO_FAULTS",
                 "GORDO_BOOT_EAGER", "GORDO_HOST_CACHE_MB", "GORDO_LAZY_BOOT",
                 "GORDO_MEGABATCH", "GORDO_MEGABATCH_RESIDENCY", "GORDO_SERVE_HOT_CACHE"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    launches = chip_smoke.phase_shard(torch, torch.device("cpu"), str(tmp_path), "cpu")
    assert launches == dict.fromkeys(chip_smoke.KERNELS, 0)
    # the shard server's launch check and part (b)'s, and nothing else
    assert len(failures) == 2 and all("launch" in f for f in failures), failures
    assert (tmp_path / "shard-server.json").exists() or (
        tmp_path / "shard" / "shard-server.json").exists()
