"""The port's fleet builder (``gordo_components_tpu_torch.parallel.
build_fleet``), its ``fleet-build`` command and its fleet-config
normalization, against the JAX package, on the CPU.

- ``build_fleet`` buckets machines by model config, widths, CV depth and
  fold mode (other ``n_splits`` land in other buckets) and commits every
  machine as its own verified generation with the single-machine build's
  metadata keys plus the fleet block, a registry key and journal records;
- ``fleet_manifest.json`` holds the reference's fields, statuses, buckets
  and journal counts for the same fleet built by the reference;
- a ``--precision-map`` naming a machine outside the fleet fails before
  anything is built; an int8 pin writes the sidecar under another key;
- resume: from the registry, from the journal alone, a torn artifact
  redone and counted ``torn`` — the same counts as the reference's drill;
- a ``FlakyDataProvider`` machine is retried, then fails and is recorded
  ``failed`` while the rest build; one that recovers on a retry builds;
- a port-built fleet machine loads in the reference's ``serializer`` and
  predicts what the port predicts within 1e-5 of the predictions'
  magnitude (float32 both sides, products summed in other orders);
- ``python -m gordo_components_tpu_torch.cli fleet-build --device cpu`` in
  a subprocess: a build, a cached re-run, ``GORDO_FAULTS='store-commit:
  <machine>:error'`` stopping the build with a non-zero exit, and a re-run
  that resumes with the reference's journal counts for the same drill;
- ``NormalizedConfig`` gives the reference's machines on the same YAML and
  refuses what it refuses.
"""

import importlib
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.parallel import FleetMachineConfig as RefMachine  # noqa: E402
from gordo_components_tpu.resilience import faults as ref_faults  # noqa: E402
from gordo_components_tpu.serializer import load as ref_load  # noqa: E402
from gordo_components_tpu.workflow.config_elements import (  # noqa: E402
    NormalizedConfig as RefNormalizedConfig,
)

from gordo_components_tpu_torch.observability.registry import REGISTRY  # noqa: E402
from gordo_components_tpu_torch.parallel import FleetMachineConfig  # noqa: E402
from gordo_components_tpu_torch.precision import QUANT_INT8_FILE  # noqa: E402
from gordo_components_tpu_torch.resilience import faults  # noqa: E402
from gordo_components_tpu_torch.serializer import load, load_metadata  # noqa: E402
from gordo_components_tpu_torch.store import journal as store_journal  # noqa: E402
from gordo_components_tpu_torch.store.generations import (  # noqa: E402
    current_generation,
    list_generations,
)
from gordo_components_tpu_torch.store.manifest import verify_artifact  # noqa: E402
from gordo_components_tpu_torch.workflow import NormalizedConfig  # noqa: E402

# the packages export a function named build_fleet over the module's name
ref_builder = importlib.import_module("gordo_components_tpu.parallel.build_fleet")
builder = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")

ROOT = Path(__file__).resolve().parents[1]
PREDICT_RTOL = 1e-5


@pytest.fixture(autouse=True)
def _no_faults():
    faults._rules[:] = []
    faults._configured = False
    saved = (list(ref_faults._rules), ref_faults._configured)
    yield
    faults._rules[:] = []
    faults._configured = False
    ref_faults._rules[:], ref_faults._configured = saved


def _data(tags, seed, provider=None, days=2):
    return {
        "type": "TimeSeriesDataset",
        "train_start_date": "2023-01-01T00:00:00+00:00",
        "train_end_date": f"2023-01-{1 + days:02d}T00:00:00+00:00",
        "tag_list": [f"TAG-{i}" for i in range(tags)],
        "data_provider": provider or {"type": "RandomDataProvider", "min_size": 300,
                                      "max_size": 400, "seed": seed},
    }


def _detector(estimator, kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
        "transformer": "MinMaxScaler"}}}}


DENSE = _detector("DenseAutoEncoder", {"kind": "feedforward_hourglass", "batch_size": 64,
                                       "epochs": 1})
LSTM = _detector("LSTMAutoEncoder", {"kind": "lstm_symmetric", "dims": [4],
                                     "lookback_window": 6, "batch_size": 64, "epochs": 1})


def _fleet():
    """Three dense machines at 2 folds, two at 1 fold (another bucket), one
    LSTM machine (a third)."""
    machines = [dict(name=f"dense-{i}", model_config=DENSE, data_config=_data(3, i))
                for i in range(3)]
    machines += [dict(name=f"dense-k1-{i}", model_config=DENSE, data_config=_data(3, 10 + i),
                      evaluation={"n_splits": 1}) for i in range(2)]
    machines.append(dict(name="lstm-0", model_config=LSTM, data_config=_data(2, 20),
                         metadata={"owner": "ops"}))
    return machines


def _build(machines, out, registry=None, **kwargs):
    return builder.build_fleet([FleetMachineConfig(**m) for m in machines], str(out),
                               model_register_dir=None if registry is None else str(registry),
                               device="cpu", n_splits=2, **kwargs)


def _ref_build(machines, out, registry=None, **kwargs):
    return ref_builder.build_fleet([RefMachine(**m) for m in machines], str(out),
                                   model_register_dir=None if registry is None else str(registry),
                                   n_splits=2, **kwargs)


def _manifest(out):
    with open(os.path.join(out, builder.MANIFEST_FILE)) as fh:
        return json.load(fh)


def _counter(name):
    return dict(REGISTRY.counter(name, labels=("outcome",)).collect())


def test_fleet_build_buckets_commits_and_matches_the_reference_manifest(tmp_path):
    out, registry = tmp_path / "out", tmp_path / "reg"
    before = _counter("gordo_fleet_machines_total").get(("completed",), 0)
    results = _build(_fleet(), out, registry)
    assert sorted(results) == sorted(m["name"] for m in _fleet())
    buckets = {}
    for name, model_dir in results.items():
        assert model_dir == str(out / name)
        assert list_generations(model_dir) == ["gen-0001"]
        assert current_generation(model_dir) == "gen-0001"
        verify_artifact(os.path.join(model_dir, "gen-0001"))
        meta = load_metadata(model_dir)
        assert {"name", "gordo_components_tpu_torch_version", "model", "dataset",
                "build_duration_s", "build_phases", "user_defined", "precision"} <= set(meta)
        assert {"model_config", "model_builder_metadata", "cross_validation",
                "model_training_duration_s", "model_creation_date", "cache_key",
                "fleet"} == set(meta["model"])
        fleet_meta = meta["model"]["fleet"]
        buckets[name] = fleet_meta["bucket"]
        assert fleet_meta["cv_parallel"] is True and meta["precision"] == "f32"
        cv = meta["model"]["cross_validation"]
        assert cv["n_splits"] == (1 if "k1" in name else 2) == len(cv["splits"])
        detector = meta["model"]["model_builder_metadata"]
        assert len(detector["tag_thresholds"]) == meta["dataset"]["x_shape"][1]
        with open(registry / f"{meta['model']['cache_key']}.md5") as fh:
            assert fh.read() == model_dir
    assert load_metadata(results["lstm-0"])["user_defined"] == {"owner": "ops"}
    assert len({buckets[n] for n in ("dense-0", "dense-1", "dense-2")}) == 1
    assert len({buckets["dense-0"], buckets["dense-k1-0"], buckets["lstm-0"]}) == 3
    states = store_journal.replay(str(out))
    assert {n: r["event"] for n, r in states.items()} == dict.fromkeys(results, "committed")
    assert _counter("gordo_fleet_machines_total")[("completed",)] == before + len(results)

    ref_out = tmp_path / "ref-out"
    _ref_build(_fleet(), ref_out)
    ours, theirs = _manifest(out), _manifest(ref_out)
    assert set(ours) == set(theirs)
    assert ours["journal"] == theirs["journal"] == {"resumed": 0, "torn": 0, "rebuilt": 6}
    for key in ("n_completed", "n_pending", "pending"):
        assert ours[key] == theirs[key]
    for name, entry in ours["machines"].items():
        ref_entry = theirs["machines"][name]
        assert set(entry) == set(ref_entry)
        assert {k: v for k, v in entry.items() if k != "model_dir"} == \
            {k: v for k, v in ref_entry.items() if k != "model_dir"}
        assert os.path.basename(entry["model_dir"]) == os.path.basename(ref_entry["model_dir"])


def test_a_port_built_fleet_machine_loads_and_predicts_in_the_reference(tmp_path):
    results = _build([m for m in _fleet() if m["name"] in ("dense-0", "lstm-0")], tmp_path)
    rows = np.random.default_rng(3).normal(size=(50, 3)).astype(np.float32)
    for name, width in (("dense-0", 3), ("lstm-0", 2)):
        ours = load(results[name], device="cpu").predict(rows[:, :width])
        theirs = np.asarray(ref_load(results[name]).predict(rows[:, :width]))
        scale = np.abs(ours).max()
        np.testing.assert_allclose(theirs, ours, atol=PREDICT_RTOL * scale, rtol=0)


def test_precision_map_is_validated_and_pins_the_rung(tmp_path):
    machines = _fleet()[:2]
    with pytest.raises(ValueError, match="not in this fleet"):
        _build(machines, tmp_path / "a", precision_map={"dense-9": "int8"})
    with pytest.raises(ValueError):
        _build(machines, tmp_path / "a", precision_map={"dense-0": "int4"})
    assert not (tmp_path / "a" / "dense-0").exists()
    registry = tmp_path / "reg"
    _build(machines, tmp_path / "b", registry)
    _build(machines, tmp_path / "b", registry, precision_map={"dense-0": "int8"})
    manifest = _manifest(tmp_path / "b")
    assert manifest["journal"] == {"resumed": 1, "torn": 0, "rebuilt": 1}
    meta = load_metadata(str(tmp_path / "b" / "dense-0"))
    assert meta["precision"] == "int8"
    assert os.path.isfile(tmp_path / "b" / "dense-0" / "gen-0002" / QUANT_INT8_FILE)
    assert len(os.listdir(registry)) == 3  # the int8 build has a key of its own


def test_resume_from_the_registry_then_the_journal(tmp_path):
    machines = _fleet()[:3]
    out, registry = tmp_path / "out", tmp_path / "reg"
    _build(machines, out, registry)
    again = _build(machines, out, registry)
    assert _manifest(out)["journal"] == {"resumed": 3, "torn": 0, "rebuilt": 0}
    assert all(list_generations(d) == ["gen-0001"] for d in again.values())
    _build(machines, out)  # no registry: the journal's committed records
    assert _manifest(out)["journal"] == {"resumed": 3, "torn": 0, "rebuilt": 0}
    changed = [dict(m) for m in machines]
    changed[1]["model_config"] = _detector("DenseAutoEncoder", {"kind": "feedforward_hourglass",
                                                                "batch_size": 64, "epochs": 2})
    _build(changed, out)  # another key: that machine alone rebuilds
    assert _manifest(out)["journal"] == {"resumed": 2, "torn": 0, "rebuilt": 1}
    assert list_generations(str(out / "dense-1")) == ["gen-0001", "gen-0002"]


def test_a_torn_artifact_is_rebuilt_with_the_reference_counts(tmp_path):
    machines = _fleet()[:3]
    counts = {}
    for side, build, fault_module in (("port", _build, faults), ("ref", _ref_build, ref_faults)):
        out, registry = tmp_path / side, tmp_path / f"{side}-reg"
        fault_module.configure("store-commit:dense-1:truncate")  # hashed, then cut in half
        build(machines, out, registry)
        fault_module.clear()
        build(machines, out, registry)
        counts[side] = _manifest(out)["journal"]
    assert counts["port"] == counts["ref"] == {"resumed": 2, "torn": 1, "rebuilt": 1}
    verify_artifact(str(tmp_path / "port" / "dense-1" / "gen-0002"))


def test_a_flaky_machine_is_retried_then_isolated(tmp_path):
    def flaky(fail_times):
        return {"type": "FlakyDataProvider", "fail_after": 0, "fail_times": fail_times,
                "min_size": 300, "max_size": 400, "seed": 5}

    machines = _fleet()[:2] + [
        dict(name="flaky-dead", model_config=DENSE, data_config=_data(3, 5, flaky(10))),
        dict(name="flaky-once", model_config=DENSE, data_config=_data(3, 6, flaky(1))),
    ]
    before = _counter("gordo_resilience_build_fetch_total")
    results = _build(machines, tmp_path, fetch_retries=2, fetch_backoff=0.0)
    after = _counter("gordo_resilience_build_fetch_total")

    def delta(outcome):
        return after.get((outcome,), 0) - before.get((outcome,), 0)

    assert sorted(results) == ["dense-0", "dense-1", "flaky-once"]
    assert (delta("retry"), delta("failed"), delta("ok")) == (3, 1, 3)
    manifest = _manifest(tmp_path)
    entry = manifest["machines"]["flaky-dead"]
    assert entry["status"] == "failed" and "Injected provider failure" in entry["error"]
    assert manifest["machines"]["flaky-once"]["status"] == "completed"
    assert not (tmp_path / "flaky-dead").exists()
    assert store_journal.replay(str(tmp_path))["flaky-dead"]["event"] == "failed"


def test_multi_process_builds_are_not_ported_yet(tmp_path, monkeypatch):
    """Ported since: inside a group of 2 ranks (its collectives stubbed as
    a peer that agrees), rank 1 builds only its block of the slice (3 dense
    machines pad to 4: rank 1 owns dense-2 and a padding machine) and
    writes its own manifest and journal; a bad slice size still fails
    first."""
    monkeypatch.setattr(torch.distributed, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.distributed, "get_world_size", lambda *a: 2)
    monkeypatch.setattr(torch.distributed, "get_rank", lambda *a: 1)
    dist = importlib.import_module("gordo_components_tpu_torch.parallel.distributed")
    monkeypatch.setattr(dist, "allgather_ints", lambda values: np.asarray([values, values]))
    monkeypatch.setattr(dist, "barrier", lambda: None)
    results = _build(_fleet()[:3], tmp_path)
    assert results == {"dense-2": str(tmp_path / "dense-2")}
    assert not (tmp_path / builder.MANIFEST_FILE).exists()
    with open(tmp_path / "fleet_manifest.p1.json") as fh:
        assert sorted(json.load(fh)["machines"]) == ["dense-2"]
    assert os.path.exists(store_journal.journal_path(str(tmp_path), 1))
    monkeypatch.undo()
    with pytest.raises(ValueError, match="slice_size"):
        _build(_fleet()[:1], tmp_path, slice_size=0)


def test_slices_pad_to_one_machine_count(tmp_path):
    results = _build(_fleet()[:3], tmp_path, slice_size=2)
    slices = {n: load_metadata(d)["model"]["fleet"] for n, d in results.items()}
    assert sorted(s["slice"] for s in slices.values()) == [0, 0, 1]
    assert {s["bucket_size"] for s in slices.values()} == {3}


def _fleet_file(tmp_path, machines):
    path = tmp_path / "fleet.json"
    path.write_text(json.dumps({"machines": [
        {"name": m["name"], "model": m["model_config"], "dataset": m["data_config"],
         **({"evaluation": m["evaluation"]} if "evaluation" in m else {})} for m in machines]}))
    return str(path)


def _cli(*args, env=None):
    return subprocess.run(
        [sys.executable, "-m", "gordo_components_tpu_torch.cli", "--log-level", "WARNING",
         "fleet-build", *args, "--device", "cpu"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "PYTHONPATH": str(ROOT), **(env or {})})


def test_cli_fleet_build_cache_and_fault_drill_match_the_reference(tmp_path):
    machines = _fleet()[:3]
    fleet_file = _fleet_file(tmp_path, machines)
    out, registry = tmp_path / "out", tmp_path / "reg"
    args = ["--machine-config", fleet_file, "--output-dir", str(out), "--model-register-dir",
            str(registry), "--n-splits", "2"]
    first = _cli(*args)
    assert first.returncode == 0, first.stderr
    printed = json.loads(first.stdout)
    assert printed == {m["name"]: str(out / m["name"]) for m in machines}
    cached = _cli(*args)
    assert cached.returncode == 0, cached.stderr
    assert json.loads(cached.stdout) == printed
    assert _manifest(out)["journal"] == {"resumed": 3, "torn": 0, "rebuilt": 0}

    drill_out = tmp_path / "drill"
    drill = ["--machine-config", fleet_file, "--output-dir", str(drill_out), "--n-splits", "2"]
    crashed = _cli(*drill, env={"GORDO_FAULTS": "store-commit:dense-1:error"})
    assert crashed.returncode != 0 and "FaultInjected" in crashed.stderr
    resumed = _cli(*drill)
    assert resumed.returncode == 0, resumed.stderr
    ours = _manifest(drill_out)["journal"]

    ref_out = tmp_path / "ref-drill"
    ref_faults.configure("store-commit:dense-1:error")
    with pytest.raises(ref_faults.FaultInjected):
        _ref_build(machines, ref_out)
    ref_faults.clear()
    _ref_build(machines, ref_out)
    assert ours == _manifest(ref_out)["journal"] == {"resumed": 1, "torn": 0, "rebuilt": 2}


@pytest.mark.parametrize("extra,code", [
    (["--precision-map", "nobody=int8"], 64),
    (["--precision-map", "dense-0=int3"], 64),
])
def test_cli_fleet_build_exit_codes(tmp_path, extra, code):
    result = _cli("--machine-config", _fleet_file(tmp_path, _fleet()[:1]), "--output-dir",
                  str(tmp_path / "out"), *extra)
    assert result.returncode == code, result.stderr


FLEET_YAML = """
project-name: plant-a
machines:
  - name: m1
    dataset:
      tag_list: [a, b]
      data_provider: {seed: 3}
  - name: m2
    model: {DenseAutoEncoder: {kind: feedforward_symmetric}}
    metadata: {site: x}
    evaluation: {n_splits: 1}
globals:
  model: {DenseAutoEncoder: {kind: feedforward_hourglass}}
  dataset:
    tag_list: [c]
    resolution: 10min
    data_provider: {type: RandomDataProvider, seed: 1}
  metadata: {owner: ops}
  evaluation: {n_splits: 3, cv_parallel: false}
"""
CRD_YAML = """
apiVersion: equinor.com/v1
kind: Gordo
metadata: {name: crd-project}
spec:
  config:
    machines:
      - {name: only, dataset: {tag_list: [t]}, model: {DenseAutoEncoder: {}}}
"""
BAD_CONFIGS = [
    "[1, 2]",
    "machines: []",
    "machines: [{name: a, dataset: {tag_list: [t]}}]",
    "machines: [{name: a, model: {X: {}}, dataset: {t: 1}}, {name: a, model: {X: {}}, "
    "dataset: {t: 1}}]",
    "kind: Gordo\nmachines: []",
    "kind: Other\nspec: {config: {}}",
]


@pytest.mark.parametrize("text", [FLEET_YAML, CRD_YAML])
def test_normalized_config_equals_the_reference(text):
    ours, theirs = NormalizedConfig(text), RefNormalizedConfig(text)
    assert ours.project_name == theirs.project_name
    assert [m.to_dict() for m in ours.machines] == [m.to_dict() for m in theirs.machines]


@pytest.mark.parametrize("text", BAD_CONFIGS)
def test_normalized_config_refuses_what_the_reference_refuses(text):
    with pytest.raises(ValueError):
        RefNormalizedConfig(text)
    with pytest.raises(ValueError):
        NormalizedConfig(text)
