"""The port's lazy fleet boot, ``/prefetch`` and host scoring path against
the reference server, on the CPU.

A models root of machines fitted by the JAX package (two dense
autoencoders of one architecture, an LSTM autoencoder and a dense machine
behind a ``FeatureUnion``, which the engine cannot lift) with a
``FLEET_INDEX.json`` written by the port's ``write_fleet_index``. The port's
``ModelServer`` (``device="cpu"``) boots it eagerly and lazily
(``GORDO_BOOT_EAGER=1``: one machine eager, the rest behind the spill
tier); the reference's WSGI app (werkzeug's test client) boots it lazily.
A lazy boot answers what an eager boot answers, to the bit, and the
reference's lazy boot within atol 1e-4 in raw tag units (the bound of
``tests/test_torch_server_surface.py``). Without an index, or with a damaged
one, the boot scans. ``POST /reload`` drops a lazy machine's cached bundle
when its index generation moves. ``POST /prefetch`` answers 405, 400 and
the engine's counts, and a prefetched machine's first request is a cache
hit. A lazy machine's ``/healthz`` loads nothing. A ``model-load`` fault on
a lazy machine quarantines it with a 503 until a probe after the cooldown
loads it.

The host path: the ``FeatureUnion`` machine answers ``/anomaly/prediction``
and ``/prediction`` with 200 from the port, eager and lazy, equal to the
reference server's answers within atol 1e-4 (before the host path was
ported the port answered 503). On a server whose device is a card that is
not there, the host path raises and never scores on the CPU.
"""

import json
import os
import shutil
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from werkzeug.test import Client  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))

from gordo_components_tpu.observability import ledger as ref_ledger  # noqa: E402
from gordo_components_tpu.serializer import pipeline_from_definition as ref_from_definition  # noqa: E402
from gordo_components_tpu.serializer.persistence import (  # noqa: E402
    write_artifact_files as ref_write_artifact_files,
)
from gordo_components_tpu.server import build_app  # noqa: E402
from gordo_components_tpu.store import commit_generation  # noqa: E402

from gordo_components_tpu_torch.observability import ledger  # noqa: E402
from gordo_components_tpu_torch.resilience import faults  # noqa: E402
from gordo_components_tpu_torch.serializer.persistence import estimators  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402
from gordo_components_tpu_torch.store.generations import (  # noqa: E402
    FLEET_INDEX_FILE,
    build_fleet_index,
    read_fleet_index,
    write_fleet_index,
)

ROOT = Path(__file__).resolve().parents[1]
TAGS = [f"tag-{i}" for i in range(4)]
LOOKBACK = 6
DENSE = ("DenseAutoEncoder", dict(kind="feedforward_hourglass"))
LSTM = ("LSTMAutoEncoder", dict(kind="lstm_symmetric", dims=[6], lookback_window=LOOKBACK))
X = (np.random.default_rng(9).normal(size=(70, len(TAGS))) * 3 + 5).astype(np.float32)


def _config(estimator, kwargs, steps=None):
    steps = steps or ["MinMaxScaler"]
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": [
            *steps, {estimator: {**kwargs, "epochs": 1, "batch_size": 16}}]}},
        "transformer": "MinMaxScaler",
    }}}}


def _fit(config, seed):
    rows = (np.random.default_rng(seed).normal(size=(96, len(TAGS))) * 3 + 5).astype(np.float32)
    model = ref_from_definition(config)
    model.fit(rows, rows)
    pred = model.predict(rows)
    model.scaler.fit(np.abs(rows[len(rows) - len(pred):] - pred))
    return model


def _commit(root, name, model, precision):
    metadata = {"dataset": {"tag_list": TAGS}, "precision": precision}
    commit_generation(str(root / name), lambda staging: ref_write_artifact_files(
        model, staging, metadata=metadata, precision=precision))
    return str(root / name)


_M = "/gordo/v0/project"
NAMES = ("dense-a", "dense-b", "lstm-ae", "union")
UNION = {"FeatureUnion": {"transformer_list": ["MinMaxScaler", "StandardScaler"]}}
BODY = json.dumps({"X": X.tolist()}).encode()
FIELDS = ("model-input", "model-output", "tag-anomaly-scores", "total-anomaly-score")


@pytest.fixture(scope="module")
def fleet_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("lazy") / "models"
    _commit(root, "dense-a", _fit(_config(*DENSE), 1), "f32")
    _commit(root, "dense-b", _fit(_config(*DENSE), 2), "f32")
    _commit(root, "lstm-ae", _fit(_config(*LSTM), 5), "f32")
    _commit(root, "union", _fit(_config(*DENSE, steps=[UNION]), 7), "f32")
    write_fleet_index(str(root), build_fleet_index(str(root)))
    return str(root)


@pytest.fixture
def root(fleet_root, tmp_path, monkeypatch):
    """A fresh copy of the fleet per test, the telemetry warehouse off and
    fresh ledgers in both packages."""
    copy = tmp_path / "models"
    shutil.copytree(fleet_root, copy)
    monkeypatch.setenv("GORDO_TELEMETRY", "0")
    monkeypatch.setenv("GORDO_HOST_CACHE_MB", "64")
    monkeypatch.delenv("GORDO_LAZY_BOOT", raising=False)
    # a module of another file that ran earlier in this process may have
    # left its own eager count behind (tools/capacity_harness sets it
    # without restoring it): the index's first names would then boot eagerly
    monkeypatch.delenv("GORDO_BOOT_EAGER", raising=False)
    monkeypatch.delenv("GORDO_FAULTS", raising=False)
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    monkeypatch.setattr(ref_ledger, "LEDGER", ref_ledger.ControlLedger())
    faults.clear()
    yield str(copy)
    faults.clear()


def _port(root, monkeypatch, tag, **options):
    monkeypatch.setenv("GORDO_LEDGER_DIR", os.path.join(os.path.dirname(root), f"ledger-{tag}"))
    return ModelServer(root, device="cpu", **options)


def _reference(root, monkeypatch, lazy_boot):
    monkeypatch.setenv("GORDO_LEDGER_DIR", os.path.join(os.path.dirname(root), "ledger-ref"))
    if lazy_boot:
        return build_app({}, project="project", models_root=root, lazy_boot=True)
    app = build_app({n: os.path.join(root, n) for n in NAMES}, project="project",
                    models_root=root)
    app._pinned = {}  # as the port: every machine comes from the scan
    return app


def ask(server, method, path, body=b""):
    r = server.handle(method, path, {"Content-Type": "application/json"}, body)
    return r.status, json.loads(r.body)


def ask_ref(client, method, path, body=b""):
    r = client.open(path, method=method, data=body,
                    headers={"Content-Type": "application/json"})
    return r.status_code, r.get_json()


def _close_all(*servers):
    for server in servers:
        if isinstance(server, ModelServer):
            server.close()
        else:
            server._state.engine.quiesce()


def _assert_close(ours, theirs, fields=FIELDS):
    for field in fields:
        a, b = np.asarray(ours["data"][field]), np.asarray(theirs["data"][field])
        assert a.shape == b.shape, field
        np.testing.assert_allclose(a, b, atol=1e-4, rtol=0, err_msg=field)


def _counters(server):
    stats = server.engine.host_cache.stats()
    return {key: stats[key] for key in ("hits", "misses", "loads", "prefetches")}


def test_lazy_boot_serves_what_the_eager_boot_and_the_reference_serve(root, monkeypatch):
    monkeypatch.setenv("GORDO_BOOT_EAGER", "1")
    eager = _port(root, monkeypatch, "eager")
    lazy = _port(root, monkeypatch, "lazy", lazy_boot=True)
    app = _reference(root, monkeypatch, lazy_boot=True)
    client = Client(app)
    try:
        assert sorted(eager.machines) == list(NAMES)
        assert sorted(lazy.machines) == ["dense-a"]
        assert sorted(lazy._state.lazy_names) == sorted(app._state.lazy_names) == list(NAMES[1:])
        assert ask(lazy, "GET", "/models")[1]["models"] == list(NAMES)
        health = ask(lazy, "GET", "/healthz")[1]
        assert health["ready"] and health["store"]["lazy"] == 3 and health["store"]["verified"] == 1
        for name in NAMES:
            for endpoint in ("anomaly/prediction", "prediction"):
                path = f"{_M}/{name}/{endpoint}"
                want = ask(eager, "POST", path, BODY)
                got = ask(lazy, "POST", path, BODY)
                ref = ask_ref(client, "POST", path, BODY)
                assert want[0] == got[0] == ref[0] == 200, (name, endpoint, got, ref)
                assert got[1] == want[1], (name, endpoint)
                _assert_close(got[1], ref[1], FIELDS if endpoint != "prediction"
                              else ("model-input", "model-output"))
        # each lazy machine loaded once, then scored from the host cache
        assert _counters(lazy)["loads"] == 3
        assert lazy.engine.stats()["spill"]["lazy_machines"] == 3
        assert lazy.engine.cost_ledger()["host_path_machines"] == 1
    finally:
        _close_all(eager, lazy, app)


@pytest.mark.parametrize("damage", ["absent", "unreadable", "other-version"])
def test_lazy_boot_without_a_readable_index_scans(root, monkeypatch, damage):
    path = os.path.join(root, FLEET_INDEX_FILE)
    if damage == "absent":
        os.unlink(path)
    elif damage == "unreadable":
        Path(path).write_text("{not json")
    else:
        Path(path).write_text(json.dumps({"format_version": 999, "machines": {}}))
    server = _port(root, monkeypatch, "scan", lazy_boot=True)
    try:
        assert server.lazy_boot is False
        assert sorted(server.machines) == list(NAMES) and not server._state.lazy_names
        assert ask(server, "POST", f"{_M}/dense-b/anomaly/prediction", BODY)[0] == 200
    finally:
        server.close()


def test_reload_drops_a_stale_bundle_when_the_index_generation_moves(root, monkeypatch):
    monkeypatch.setenv("GORDO_BOOT_EAGER", "1")
    server = _port(root, monkeypatch, "reload", lazy_boot=True)
    try:
        engine = server.engine
        path = f"{_M}/dense-b/anomaly/prediction"
        first = ask(server, "POST", path, BODY)
        assert first[0] == 200 and "dense-b" in engine.host_cache.resident()
        # nothing moved: nothing to do
        assert server.reload() == {"added": [], "removed": [], "refreshed": [], "errors": {},
                                   "total": len(NAMES)}
        index = read_fleet_index(root)
        index["dense-b"]["generation"] = "gen-9999"
        write_fleet_index(root, index)
        status, body = ask(server, "POST", "/reload")
        assert status == 200 and body["refreshed"] == ["dense-b"] and body["total"] == len(NAMES)
        assert "dense-b" not in engine.host_cache.resident()
        loads = _counters(server)["loads"]
        again = ask(server, "POST", path, BODY)
        assert again == first and _counters(server)["loads"] == loads + 1
        # membership: a machine leaves the index, then comes back
        del index["lstm-ae"]
        write_fleet_index(root, index)
        assert server.reload()["removed"] == ["lstm-ae"]
        assert ask(server, "POST", f"{_M}/lstm-ae/anomaly/prediction", BODY)[0] == 404
        write_fleet_index(root, build_fleet_index(root))
        body = server.reload()
        assert body["added"] == ["lstm-ae"] and body["total"] == len(NAMES)
        assert ask(server, "POST", f"{_M}/lstm-ae/anomaly/prediction", BODY)[0] == 200
    finally:
        server.close()


def test_prefetch_endpoint(root, monkeypatch):
    monkeypatch.setenv("GORDO_BOOT_EAGER", "1")
    server = _port(root, monkeypatch, "prefetch", lazy_boot=True)
    app = _reference(root, monkeypatch, lazy_boot=True)
    client = Client(app)
    try:
        for method, body in (("GET", b""), ("POST", b"{not json"),
                             ("POST", json.dumps({"machines": "dense-b"}).encode())):
            status = ask(server, method, "/prefetch", body)[0]
            assert status == ask_ref(client, method, "/prefetch", body)[0]
            assert status == (405 if method == "GET" else 400)
        hint = json.dumps({"machines": ["dense-b", "lstm-ae", "dense-a", "ghost"]}).encode()
        status, body = ask(server, "POST", "/prefetch", hint)
        assert (status, body) == ask_ref(client, "POST", "/prefetch", hint)
        assert body == {"queued": 2, "skipped": 0, "unknown": 2}
        server.engine.quiesce()
        assert set(server.engine.host_cache.resident()) == {"dense-b", "lstm-ae"}
        before = _counters(server)
        assert before["prefetches"] == 2 and before["loads"] == 0
        # the first request of a prefetched machine is a hit
        assert ask(server, "POST", f"{_M}/dense-b/anomaly/prediction", BODY)[0] == 200
        after = _counters(server)
        assert (after["hits"] - before["hits"], after["misses"] - before["misses"]) == (1, 0)
    finally:
        _close_all(server, app)


def test_a_lazy_machines_healthz_loads_nothing(root, monkeypatch):
    monkeypatch.setenv("GORDO_BOOT_EAGER", "1")
    server = _port(root, monkeypatch, "healthz", lazy_boot=True)
    app = _reference(root, monkeypatch, lazy_boot=True)
    client = Client(app)
    try:
        before = _counters(server)
        status, body = ask(server, "GET", f"{_M}/lstm-ae/healthz")
        assert (status, body) == ask_ref(client, "GET", f"{_M}/lstm-ae/healthz")
        assert body["status"] == "lazy" and body["resident"] is False
        assert _counters(server) == before and not server.engine.host_cache.resident()
        assert ask(server, "POST", f"{_M}/lstm-ae/anomaly/prediction", BODY)[0] == 200
        touched = _counters(server)
        status, body = ask(server, "GET", f"{_M}/lstm-ae/healthz")
        assert status == 200 and body["resident"] is True and body["verified"] is True
        assert body["generation"] == "gen-0001" and body["precision"] == "f32"
        assert _counters(server) == touched
        assert ask(server, "GET", "/gordo/v0/other/lstm-ae/healthz")[0] == 404
    finally:
        _close_all(server, app)


def test_a_model_load_fault_on_a_lazy_machine_quarantines_it_until_a_probe(root, monkeypatch):
    monkeypatch.setenv("GORDO_BOOT_EAGER", "1")
    server = _port(root, monkeypatch, "fault", lazy_boot=True, quarantine_cooldown=0.2)
    try:
        faults.configure("model-load:dense-b:error")
        path = f"{_M}/dense-b/anomaly/prediction"
        status, body = ask(server, "POST", path, BODY)
        assert status == 503 and "FaultInjected" in body["error"]
        health = ask(server, "GET", "/healthz")[1]
        assert health["status"] == "degraded" and health["quarantined"]["dense-b"]["phase"] == "load"
        assert ask(server, "GET", f"{_M}/dense-b/healthz")[0] == 503
        # the rest of the fleet serves
        assert ask(server, "POST", f"{_M}/lstm-ae/anomaly/prediction", BODY)[0] == 200
        faults.clear()
        assert ask(server, "POST", path, BODY)[0] == 503  # still cooling down
        time.sleep(0.3)
        assert ask(server, "POST", path, BODY)[0] == 200  # the probe loads it
        assert ask(server, "GET", "/healthz")[1]["status"] == "ok"
    finally:
        server.close()


@pytest.mark.parametrize("lazy_boot", [False, True], ids=["eager", "lazy"])
def test_a_machine_the_engine_cannot_lift_is_scored_on_the_host_path(root, monkeypatch,
                                                                    lazy_boot):
    """A ``FeatureUnion`` pipeline: the port answered 503 before the host
    path; the reference scores it on its host path and answers 200."""
    # (no lazy_boot keyword for an eager server: the parent's server, which
    # answered this machine 503, takes none)
    server = _port(root, monkeypatch, "host", **({"lazy_boot": True} if lazy_boot else {}))
    app = _reference(root, monkeypatch, lazy_boot=lazy_boot)
    client = Client(app)
    try:
        dispatches = server.engine.stats()["dispatches"]
        for endpoint, fields in (("anomaly/prediction", FIELDS),
                                 ("prediction", ("model-input", "model-output"))):
            path = f"{_M}/union/{endpoint}"
            ours, theirs = ask(server, "POST", path, BODY), ask_ref(client, "POST", path, BODY)
            assert ours[0] == theirs[0] == 200, (ours, theirs)
            _assert_close(ours[1], theirs[1], fields)
        assert "union" in server.engine.host_path_machines()
        est = next(estimators(server.machines["union"].model if not lazy_boot
                              else server.engine.host_cache.peek("union")["context"].model))
        assert est.device == server.device
        # the host path dispatches nothing through the engine
        stats = server.engine.stats()
        assert stats["dispatches"] == dispatches and stats["spill"]["requests"] == 0
    finally:
        _close_all(server, app)


def test_a_cuda_servers_host_path_never_scores_on_the_cpu(root, monkeypatch):
    server = _port(root, monkeypatch, "cuda")
    try:
        model = server.machines["union"].model
        est = next(estimators(model))
        # the engine of a CUDA server places the machine on the card, which
        # is not there: that raises rather than leaving it on the CPU
        server.engine.device = torch.device("cuda")
        with pytest.raises(RuntimeError, match="CUDA"):
            server.engine._place_for_host_path(model)
        # a machine placed on the card: its request raises (quarantine,
        # 503) and no forward runs on the CPU
        est.device = torch.device("cuda")
        forwards = []
        est.module_.register_forward_hook(lambda *args: forwards.append(1))
        status, body = ask(server, "POST", f"{_M}/union/anomaly/prediction", BODY)
        assert status == 503 and "CUDA" in body["error"] and forwards == []
    finally:
        server.close()


def test_the_joint_forecaster_still_answers_503_on_the_host_path(root, monkeypatch):
    """A joint multi-step forecast predicts horizon x F values per window,
    which no path compares one row per timestamp."""
    from test_torch_zoo_serving import TAGS as JOINT_TAGS
    from test_torch_zoo_serving import _multi_step_artifact

    rows = (np.random.default_rng(3).normal(size=(40, len(JOINT_TAGS))) * 3 + 5).astype(np.float32)
    _multi_step_artifact(os.path.join(root, "joint"), rows)
    body = json.dumps({"X": rows.tolist()}).encode()
    server = _port(root, monkeypatch, "joint")
    try:
        status, answer = ask(server, "POST", f"{_M}/joint/anomaly/prediction", body)
        assert status == 503 and "one row per timestamp" in answer["error"]
        assert not server.quarantine.is_quarantined("joint")
    finally:
        server.close()


def test_cli_lazy_boot_needs_a_models_dir(tmp_path):
    env = {**os.environ, "PYTHONPATH": str(ROOT), "GORDO_LAZY_BOOT": "0"}
    out = subprocess.run(
        [sys.executable, "-m", "gordo_components_tpu_torch.cli", "run-server", "--model-dir",
         str(tmp_path), "--lazy-boot", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=120)
    assert out.returncode == 2 and "--models-dir" in out.stderr
