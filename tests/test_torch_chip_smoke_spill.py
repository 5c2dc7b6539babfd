"""How ``chip_smoke.py`` predicts the host cache's counts in phase 15, on
the CPU.

Phase 15 holds the host cache's hit, miss, store and evict counts over a
request schedule to what ``spill_lru_prediction`` says an LRU of the cap
does. Here the helper is held to hand-counted schedules, then to the
port's own server: three lazy machines fitted by the JAX package behind a
lazily booted ``ModelServer`` (``device="cpu"``) whose host cache holds
two of their bundles but not three, sized from the bundle bytes the engine
reports, as the phase sizes its cap; phase 15's own schedule, asked over
the server's HTTP handler, moves the cache's counters exactly as
predicted. Last, the rows phases 3, 14 and 15 hold against the CPU plain
path: a windowed score over the first and last windows' rows equals the
whole answer at the rows ``end_rows`` picks.
"""

import json
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(Path(__file__).resolve().parent))

import chip_smoke  # noqa: E402

from gordo_components_tpu_torch.observability import ledger  # noqa: E402
from gordo_components_tpu_torch.server.host_cache import HostTierCache  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402
from gordo_components_tpu_torch.store.generations import (  # noqa: E402
    build_fleet_index,
    write_fleet_index,
)
from test_torch_lazy_boot import DENSE, X, _commit, _config, _fit  # noqa: E402

SIZES = {"a": 100, "b": 100, "c": 100}
CASES = {  # name -> (schedule, cap, counts)
    # phase 15's schedule, two of three held: each request of a machine
    # not held is a miss and a store, then the engine's hit
    "two-of-three": ([("a", "b", "c")[i] for i in chip_smoke.SPILL_SCHEDULE], 250,
                     {"hit": 10, "miss": 8, "store": 8, "evict": 6}),
    "all-held": (["a", "b", "c", "a", "b", "c"], 300,
                 {"hit": 6, "miss": 3, "store": 3, "evict": 0}),
    "one-held": (["a", "a", "b", "a"], 150, {"hit": 4, "miss": 3, "store": 3, "evict": 2}),
    # an entry larger than the cap is never cached: both lookups miss
    "oversize": (["a", "a"], 99, {"hit": 0, "miss": 4, "store": 4, "evict": 0}),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lru_prediction_counts_as_the_server_counts(case):
    schedule, cap, counts = CASES[case]
    assert chip_smoke.spill_lru_prediction(schedule, SIZES, cap) == counts


@pytest.fixture
def lazy_root(tmp_path, monkeypatch):
    root = tmp_path / "models"
    for seed, name in enumerate(("spill-a", "spill-b", "spill-c")):
        _commit(root, name, _fit(_config(*DENSE), seed + 1), "f32")
    write_fleet_index(str(root), build_fleet_index(str(root)))
    monkeypatch.setenv("GORDO_TELEMETRY", "0")
    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ledger"))
    # another file's fixture may have left these in the process's
    # environment (tools/capacity_harness sets GORDO_BOOT_EAGER and
    # GORDO_HOST_CACHE_MB without restoring them)
    monkeypatch.delenv("GORDO_BOOT_EAGER", raising=False)
    monkeypatch.delenv("GORDO_HOST_CACHE_MB", raising=False)
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    yield str(root)
    shutil.rmtree(root, ignore_errors=True)


def test_the_phase_schedule_moves_a_lazy_servers_cache_as_predicted(lazy_root):
    server = ModelServer(lazy_root, device="cpu", lazy_boot=True)
    try:
        engine = server.engine
        names = sorted(server._state.lazy_names)
        assert names == ["spill-a", "spill-b", "spill-c"]
        sizes = {name: engine._build_bundle(name, engine._lazy[name])[1] for name in names}
        cap = int(2.5 * max(sizes.values()))
        assert 2 * max(sizes.values()) <= cap < sum(sizes.values())
        engine.host_cache = HostTierCache(cap)
        schedule = [names[i] for i in chip_smoke.SPILL_SCHEDULE]
        before = chip_smoke.spill_cache_counts(engine)
        body = json.dumps({"X": X.tolist()}).encode()
        for name in schedule:
            reply = server.handle("POST", f"/gordo/v0/project/{name}/anomaly/prediction",
                                  {"Content-Type": "application/json"}, body)
            assert reply.status == 200
        moved = chip_smoke.spill_delta(chip_smoke.spill_cache_counts(engine), before)
        assert moved == chip_smoke.spill_lru_prediction(schedule, sizes, cap)
        assert moved == {"hit": 10, "miss": 8, "store": 8, "evict": 6}
    finally:
        server.close()


def _windowed(lookback):
    """A score with one row per window of ``lookback`` rows, each from its
    window alone (as a PatchTST answer's), in the four answer fields."""

    def score(rows):
        sums = np.cumsum(np.vstack([np.zeros((1, rows.shape[1])), rows]), axis=0)
        out = sums[lookback:] - sums[:-lookback]
        return {field: out * (k + 1) for k, field in enumerate(
            ("model-input", "model-output", "tag-anomaly-scores", "total-anomaly-score"))}

    return score


@pytest.mark.parametrize("lookback,rows", [
    *[(chip_smoke.LOOKBACK, chip_smoke.LOOKBACK + w - 1) for w in (1, 3, 4, 5, 16, 64)],
    (1, chip_smoke.SEAMS_ROWS),  # a dense request, shorter than a lookback: whole
])
def test_the_cpu_plain_path_holds_the_answers_first_and_last_windows(lookback, rows):
    windows = rows - lookback + 1
    # integers: the window sums are exact whichever row they start from
    X = np.random.default_rng(rows).integers(-50, 50, size=(rows, 2)).astype(np.float64)
    score = _windowed(lookback)
    whole = score(X)
    plain = chip_smoke.cpu_plain_answer(score, X)
    held = len(plain["model-output"])
    picked = chip_smoke.end_rows(whole, held)
    for field, array in plain.items():
        assert np.array_equal(array, picked[field])
    answer = len(whole["model-output"])
    if windows <= chip_smoke.CPU_PLAIN_WINDOWS or rows < chip_smoke.LOOKBACK:
        assert held == answer
    else:
        assert held < answer
        half = held // 2
        assert np.array_equal(picked["model-output"][:half], whole["model-output"][:half])
        assert np.array_equal(picked["model-output"][half:], whole["model-output"][-half:])
