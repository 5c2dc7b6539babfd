"""Phase 18 of ``chip_smoke.py`` (the lint and the lock witness), on the CPU.

The phase's tree is built at small widths (the slice machine one layer
deep over 64 rows, as the other rehearsals shrink it) and served by the phase's own child process
(``LW_CHILD``) with the witness on, on the CPU: its JSON line says the
run saw no violation and an empty report, every answer a 200, the two lazy
machines evicting each other, the reload refreshing the touched machine
into a second engine; and the phase's check then fails on the launches, as
every rehearsal does (a CPU call is no kernel launch). A line that reports
a violation, a cycle, a non-200, a launch count off by one or a missing
edge makes the check fail; a good one passes and returns the launches.
"""

import json
import os
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402

# narrow and shallow, yet wide enough that a bundle is megabytes: the host
# cache is sized in MiB to hold one bundle and not two
TINY = dict(patch_length=16, stride=8, d_model=256, n_heads=2, n_layers=1, ff_dim=1024)


@pytest.fixture
def tiny(monkeypatch):
    monkeypatch.setattr(chip_smoke, "SLICE", TINY)
    monkeypatch.setattr(chip_smoke, "LOOKBACK", 64)
    monkeypatch.setattr(chip_smoke, "N_TAGS", 4)
    monkeypatch.setattr(chip_smoke.sensor_rows, "__defaults__", (4,))
    monkeypatch.setattr(chip_smoke, "LW_SECONDS", 3.0)
    monkeypatch.setattr(chip_smoke, "LW_CLIENTS", 4)


def _good_report():
    n = chip_smoke.SLICE["n_layers"]
    return {
        "violations": [], "report": [],
        "edges": [[a, b, 1] for a, b in chip_smoke.LW_REQUIRED],
        "launches": {"flash_fwd_f32": 5 * n, "flash_fwd_bf16": 2 * n, "flash_bwd_f32": 0,
                     "flash_bwd_bf16": 0, "flash_fwd": 7 * n, "flash_bwd": 0},
        "dispatches": {"float32": 5, "bfloat16": 2},
        "statuses": {"200": 40}, "reads": 9, "engines": 2,
        "cache": {"hits": 3, "misses": 4, "evictions": 3, "loads": 4, "prefetches": 1},
        "prefetch": {"queued": 1, "skipped": 0, "unknown": 0},
        "reload": {"added": [], "removed": [], "refreshed": [chip_smoke.LW_RELOAD],
                   "errors": {}, "total": 12},
    }


def test_a_good_line_passes_and_gives_the_launches():
    launches = chip_smoke.lw_check(_good_report())
    assert launches == {"flash_fwd_f32": 15, "flash_fwd_bf16": 6, "flash_bwd_f32": 0,
                        "flash_bwd_bf16": 0}


@pytest.mark.parametrize("damage, words", [
    (lambda r: r["violations"].append("lock-order violation on thread 'x'"), "violation"),
    (lambda r: r["report"].append("cycle in observed lock-acquisition graph: a -> b -> a"),
     "violation"),
    (lambda r: r["statuses"].update({"503": 1}), "status"),
    (lambda r: r["launches"].update(flash_fwd_f32=r["launches"]["flash_fwd_f32"] - 1),
     "flash_fwd_f32"),
    (lambda r: r["launches"].update(flash_fwd_bf16=r["launches"]["flash_fwd_bf16"] + 1),
     "flash_fwd_bf16"),
    (lambda r: r["dispatches"].update(bfloat16=0), "bfloat16"),
    (lambda r: r["launches"].update(flash_bwd_f32=1), "backward"),
    (lambda r: r["cache"].update(evictions=0), "host cache"),
    (lambda r: r.update(prefetch={"queued": 0, "skipped": 0, "unknown": 1}), "prefetch"),
    (lambda r: r["reload"].update(refreshed=[]), "reload"),
    (lambda r: r.update(engines=1), "reload"),
    (lambda r: r["edges"].pop(0), "not observed"),
])
def test_a_bad_line_fails_the_phase(damage, words, capsys):
    report = _good_report()
    damage(report)
    with pytest.raises(SystemExit):
        chip_smoke.lw_check(report)
    assert words in capsys.readouterr().err


def test_the_child_serves_under_the_witness_on_the_cpu(tiny, tmp_path, capsys):
    """The phase's tree and child at tiny widths: the run is clean, and only
    the launch check fails (CPU calls are no launches)."""
    device = torch.device("cpu")
    models_dir = str(tmp_path / "lock-witness")
    tags = chip_smoke.lw_build(models_dir, str(tmp_path), device)
    assert set(os.listdir(models_dir)) == {*tags, "FLEET_INDEX.json"}
    cap_mb = chip_smoke.lw_cap_mb(models_dir, device)
    rng = np.random.default_rng(0)
    bodies = {}
    for name, n in tags.items():
        rows = chip_smoke.sensor_rows(rng, chip_smoke.LOOKBACK + chip_smoke.LW_WINDOWS - 1
                                      if n == chip_smoke.N_TAGS else chip_smoke.SEAMS_ROWS, n)
        bodies[name] = str(tmp_path / f"{name}.json")
        Path(bodies[name]).write_text(json.dumps({"X": rows.tolist()}))
    config = {"models_dir": models_dir, "device": "cpu", "bodies": bodies,
              "dense": chip_smoke.LW_DENSE, "slice": [chip_smoke.LW_F32, chip_smoke.LW_BF16],
              "lazy": chip_smoke.LW_LAZY, "reload": chip_smoke.LW_RELOAD,
              "prefetch": chip_smoke.LW_LAZY[1], "seconds": chip_smoke.LW_SECONDS,
              "clients": chip_smoke.LW_CLIENTS,
              "shape": f"L{chip_smoke.LOOKBACK}a0f{chip_smoke.N_TAGS}",
              "fields": list(chip_smoke.LW_FIELDS),
              "check": {"machine": chip_smoke.LW_F32, "out": str(tmp_path / "check.npz")}}
    env = {key: value for key, value in os.environ.items()
           if not key.startswith("GORDO_") and key != "JAX_PLATFORMS"}
    env.update(chip_smoke.LW_ENV, PYTHONPATH=str(ROOT), GORDO_HOST_CACHE_MB=str(cap_mb))
    report = chip_smoke.lw_run_child(config, env, timeout=240)
    assert report["violations"] == [] and report["report"] == []
    assert set(report["statuses"]) == {"200"} and report["statuses"]["200"] > 20
    assert report["engines"] == 2 and chip_smoke.LW_RELOAD in report["reload"]["refreshed"]
    assert report["cache"]["evictions"] > 0 and report["prefetch"]["unknown"] == 0
    assert report["dispatches"]["float32"] > 0 and report["dispatches"]["bfloat16"] > 0
    edges = {(a, b) for a, b, _ in report["edges"]}
    assert ("server.reload", "engine.bucket_cond") in edges
    assert ("server.admission", "observability.series") in edges
    with np.load(config["check"]["out"]) as check:
        assert sorted(check.files) == sorted(chip_smoke.LW_FIELDS)
        assert check["model-output"].shape == (chip_smoke.LW_WINDOWS, chip_smoke.N_TAGS)
    with pytest.raises(SystemExit):
        chip_smoke.lw_check(report)
    assert "launches for" in capsys.readouterr().err


def test_the_lint_step_passes_on_this_tree(capsys):
    out = chip_smoke.lw_lint("cpu")
    assert out["baselined"] >= 1 and "lock-discipline" in out["timings"]
    assert "lint [cpu]: 0 findings" in capsys.readouterr().out
