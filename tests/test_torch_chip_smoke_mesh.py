"""How ``chip_smoke.py`` drives phase 20 (the fleet-sharded serving mesh),
rehearsed on the CPU at a tiny size.

- The names: the shard plan is a pure function of the machine names, so
  ``MESH_SLICE`` and ``MESH_DENSE`` are pinned. ``mesh-slice-f32-a`` is the
  first of ``mesh-slice-f32``, ``-a``, ``-b``, … that puts the fp32 slice
  machine on another shard than ``mesh-slice-bf16``; with the four dense
  machines each of the two shards then owns one slice machine and two
  dense ones, and the six machines are enough for the sharded policy. The
  reference's plan lays them out alike.
- The phase itself at tiny widths (``SLICE`` d_model 16, 2 heads, 1 layer;
  ``LOOKBACK`` 64; 4 tags), with phase 14's root absent so that it builds
  its machines, and the workers on ``--device cpu``. Every check runs; the
  only one that fails here is the launch count (a CPU call is no kernel
  launch), and the router's process maps no libtorch here as on the card.
"""

import string
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

from gordo_components_tpu.parallel.shard_plan import FleetShardPlan as RefPlan  # noqa: E402
from gordo_components_tpu_torch.parallel.shard_plan import FleetShardPlan  # noqa: E402


class _Failed(Exception):
    pass


def _names():
    return sorted([*chip_smoke.MESH_SLICE.values(), *chip_smoke.MESH_DENSE])


def test_the_pinned_names_give_each_shard_a_slice_machine():
    plan = FleetShardPlan(chip_smoke.MESH_SHARDS)
    bf16 = chip_smoke.MESH_SLICE["bfloat16"]
    first = next(name for name in ["mesh-slice-f32"] + [f"mesh-slice-f32-{c}" for c in
                                                        string.ascii_lowercase]
                 if plan.shard_of(name) != plan.shard_of(bf16))
    assert first == chip_smoke.MESH_SLICE["float32"]
    names = _names()
    assert plan.policy(len(names)) == "sharded"
    for shard in range(chip_smoke.MESH_SHARDS):
        owned = plan.owned(names, shard)
        assert len(set(owned) & set(chip_smoke.MESH_SLICE.values())) == 1
        assert len(set(owned) & set(chip_smoke.MESH_DENSE)) == 2
    assert plan.assign(names) == RefPlan(chip_smoke.MESH_SHARDS).assign(names)
    # each machine's artifact comes from phase 14's root: the fp32 and bf16
    # slice machines and dense machines that phase 14 leaves as built
    assert set(chip_smoke.MESH_SOURCES) == set(names)
    assert chip_smoke.MESH_SOURCES[chip_smoke.MESH_SLICE["bfloat16"]] == chip_smoke.TIER_BF16
    assert chip_smoke.MESH_SOURCES[chip_smoke.MESH_SLICE["float32"]] in chip_smoke.TIER_PATCHTST
    dense_sources = [chip_smoke.MESH_SOURCES[n] for n in chip_smoke.MESH_DENSE]
    assert set(dense_sources) <= set(chip_smoke.TIER_DENSE) - {chip_smoke.TIER_RELOAD,
                                                               chip_smoke.TIER_SLOW}


def test_phase_20_rehearses_on_the_cpu(tmp_path, monkeypatch):
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
                 "GORDO_BOOT_EAGER", "GORDO_HOST_CACHE_MB", "GORDO_LAZY_BOOT"):
        monkeypatch.delenv(name, raising=False)
    monkeypatch.setenv("OMP_NUM_THREADS", "1")

    launches = chip_smoke.phase_mesh(torch, torch.device("cpu"), str(tmp_path), "cpu")
    assert launches == dict.fromkeys(chip_smoke.KERNELS, 0)
    # the two workers' records and the respawned one's: their launch check
    # (a CPU call launches nothing), and nothing else
    assert len(failures) == 1 and "launch" in failures[0], failures
    victim = FleetShardPlan(chip_smoke.MESH_SHARDS).shard_of(chip_smoke.MESH_SLICE["float32"])
    # the SIGKILLed worker wrote no record, its respawn did
    first = {"worker-0-0.json", "worker-1-1.json"} - {f"worker-{victim}-{victim}.json"}
    assert sorted(p.name for p in (tmp_path / "mesh-records").iterdir()) == sorted(
        [*first, f"worker-{victim}-2.json"])
