"""``correct`` end to end on the CPU at a small size: a whole run of the
harness (the look for a card skipped) with the program sound, then with
its timed path broken underneath, and the control in the program's
place. Each broken run has to read not correct."""

import json
import os
import shutil
import time

import pytest
import torch

from conftest import BENCH, ROOT
from harness import bench, control, manifest

# the cells' own widths and depth over a short lookback (7 patches), so
# that rounding grows through the layers as it does in a cell
TINY = {"lookback_window": 64}


@pytest.fixture(scope="module")
def tiny(tmp_path_factory):
    """A bench directory of one small cell per real configuration: the
    configuration's own widths, limits and control; a short lookback, few
    tags and small mixes."""
    root = tmp_path_factory.mktemp("bench")
    shutil.copytree(os.path.join(BENCH, "metrics"), root / "metrics")
    (root / "traffic").mkdir()
    (root / "configs").mkdir()
    man = manifest.load(ROOT)
    cells = []
    for entry in man["configs"]:
        config = manifest.config(man, ROOT, entry["name"])
        config["model"].update(TINY)
        config["n_tags"] = 4
        path = root / "configs" / f"{entry['name']}.json"
        path.write_text(json.dumps(config))
        entry["file"] = str(path)
    for cell in man["workloads"]:
        mix = manifest.traffic(cell["traffic"])
        mix.update(fleet=3, windows_per_request=6, compare_sample=4, threads=4,
                   warmup_rounds=[1, 2])
        if mix["loop"] == "open":
            mix["rate_per_s"] = 20.0
        (root / "traffic" / f"{cell['traffic']}.json").write_text(json.dumps(mix))
        cells.append(cell["name"])
    return man, str(root), cells


def run(tiny, cell, seed=2 ** 31 + 5):
    man, root, _ = tiny
    return bench.run_cell(ROOT, man, cell, seed, 1.5, False, "cpu", time.monotonic(),
                          bench_dir=root)


def test_sound_runs_are_correct(tiny):
    for cell in tiny[2]:
        result = run(tiny, cell)
        assert result["correct"], (cell, result["checks"])
        assert result["attempted"] > 0 and result["failed"] == 0
        assert list(result)[-1] == "_extra" and list(result)[-2] == "checks"


def broken(kind):
    """The engine's scoring closure with a fault planted where an answer is
    produced."""
    from gordo_components_tpu_torch.server import engine

    original = engine._make_machine_score

    def make(*args, **kwargs):
        score = original(*args, **kwargs)

        def machine_score(machine, x):
            x_tail, pred, scaled, total = score(machine, x)
            if kind == "altered":
                # one window's answer off by a quarter of the largest
                pred = torch.cat([pred[:-1], pred[-1:] + 0.25 * pred.abs().max()])
            else:
                # half of the windows left out, the rest answered twice
                half = (pred.shape[0] + 1) // 2
                pred = torch.cat([pred[:half], pred[:pred.shape[0] - half]])
            return x_tail, pred, scaled, total

        return machine_score

    return make


@pytest.mark.parametrize("kind", ["altered", "half_left_out"])
def test_a_broken_timed_path_is_not_correct(tiny, kind, monkeypatch):
    from gordo_components_tpu_torch.server import engine

    monkeypatch.setattr(engine, "_make_machine_score", broken(kind))
    for cell in tiny[2]:
        result = run(tiny, cell)
        assert not result["correct"], (cell, kind, result["checks"])


@pytest.mark.parametrize("config_name", ["patchtst64-f32", "patchtst64-bf16"])
def test_the_control_is_not_correct(config_name):
    """The control at the configuration's own widths, depth, lookback and
    tags, over 4 requests of 4 windows (a run compares 12 of 240 or 48 of
    60): not correct on every seed."""
    man = manifest.load(ROOT)
    config = manifest.config(man, ROOT, config_name)
    mix = dict(manifest.traffic("backfill"), windows_per_request=4)
    for seed in (1, 2, 3):
        reading = control.readings(config, mix, seed, "cpu", sample=4)
        assert not bench.compare.judge(reading, config["limits"]), (config_name, seed, reading)


@pytest.mark.gpu
def test_the_control_fails_at_the_cells_own_size(cuda_device):
    """On the card: the control over one request at each cell's own sizes."""
    man = manifest.load(ROOT)
    for cell in man["workloads"]:
        config = manifest.config(man, ROOT, cell["config"])
        reading = control.readings(config, manifest.traffic(cell["traffic"]), 3, cuda_device,
                                   sample=1)
        assert not bench.compare.judge(reading, config["limits"]), (cell["name"], reading)
