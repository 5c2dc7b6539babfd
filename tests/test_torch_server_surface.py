"""The port's serving surface against the reference server, on the CPU.

Artifacts are fitted by the JAX package: a dense anomaly detector, the same
architecture committed as an int8 generation (``quant_int8.npz`` beside
``state.npz``), an LSTM autoencoder, and a bare ``Pipeline([MinMaxScaler,
DenseAutoEncoder])`` that is no anomaly detector. The reference's WSGI app
(werkzeug's test client) and the port's ``ModelServer.handle`` serve the
same models directory; every route must answer the same status, the same
structured error fields and ``Retry-After``, and 200s the same arrays within
atol 1e-4 in raw tag units (the bound of ``tests/test_torch_zoo_serving.py``).
The reference pins the machines it booted with; the port's server pins
none (every machine comes from the scan), so the reference app is compared
with its pins cleared. Below those: the npz codec across both packages,
Prometheus text across both parsers, and the resilience pieces (deadline
header, admission watermarks, quarantine ledger, ``Retry-After``) against
their reference twins.
"""

import json
import os
import shutil
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from werkzeug.test import Client  # noqa: E402

from gordo_components_tpu import wire as ref_wire  # noqa: E402
from gordo_components_tpu.observability import exposition as ref_exposition  # noqa: E402
from gordo_components_tpu.observability.registry import Registry as RefRegistry  # noqa: E402
from gordo_components_tpu.resilience import deadline as ref_deadline  # noqa: E402
from gordo_components_tpu.resilience import qos as ref_qos  # noqa: E402
from gordo_components_tpu.resilience.admission import (  # noqa: E402
    AdmissionController as RefAdmission,
)
from gordo_components_tpu.resilience.quarantine import Quarantine as RefQuarantine  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.serializer import pipeline_from_definition as ref_from_definition  # noqa: E402
from gordo_components_tpu.serializer.persistence import (  # noqa: E402
    write_artifact_files as ref_write_artifact_files,
)
from gordo_components_tpu.server import build_app  # noqa: E402
from gordo_components_tpu.server.server import _retry_after as ref_retry_after  # noqa: E402
from gordo_components_tpu.store import commit_generation  # noqa: E402
from gordo_components_tpu.store import current_generation as ref_current_generation  # noqa: E402

from gordo_components_tpu_torch import wire  # noqa: E402
from gordo_components_tpu_torch.observability import exposition  # noqa: E402
from gordo_components_tpu_torch.observability.registry import Registry  # noqa: E402
from gordo_components_tpu_torch.resilience import deadline  # noqa: E402
from gordo_components_tpu_torch.resilience.admission import (  # noqa: E402
    AdmissionController,
    AdmissionRejected,
)
from gordo_components_tpu_torch.resilience.quarantine import Quarantine  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer, _retry_after  # noqa: E402
from gordo_components_tpu_torch.store.generations import current_generation  # noqa: E402
from gordo_components_tpu_torch.store.manifest import ArtifactIncomplete  # noqa: E402

TAGS = [f"tag-{i}" for i in range(5)]
LOOKBACK = 8
COOLDOWN = 0.3


def _detector(estimator, kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": [
            "MinMaxScaler", {estimator: {**kwargs, "epochs": 1, "batch_size": 16}}]}},
        "transformer": "MinMaxScaler",
    }}}}


MACHINES = {  # name -> (definition, int8 generation)
    "dense": (_detector("DenseAutoEncoder", {"kind": "feedforward_hourglass"}), False),
    "dense-int8": (_detector("DenseAutoEncoder", {"kind": "feedforward_hourglass"}), True),
    "lstm": (_detector("LSTMAutoEncoder", {"kind": "lstm_symmetric", "dims": [6],
                                           "lookback_window": LOOKBACK}), False),
    "bare": ({"Pipeline": {"steps": ["MinMaxScaler", {"DenseAutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 1, "batch_size": 16}}]}}, False),
}


def _fit(definition, seed):
    X = (np.random.default_rng(seed).normal(size=(60, len(TAGS))) * 3 + 5).astype(np.float32)
    model = ref_from_definition(definition)
    model.fit(X, X)
    if hasattr(model, "scaler"):  # the detector's error scaler and thresholds
        pred = model.predict(X)
        residual = np.abs(X[len(X) - len(pred):] - pred)
        model.scaler.fit(residual)
        scaled = model.scaler.transform(residual)
        model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
        model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    return model


def _write(root, name, seed):
    definition, int8 = MACHINES.get(name, MACHINES["dense"])
    model = _fit(definition, seed)
    metadata = {"dataset": {"tag_list": TAGS}}
    if int8:
        metadata["precision"] = "int8"
        commit_generation(os.path.join(root, name), lambda staging: ref_write_artifact_files(
            model, staging, metadata=metadata, precision="int8"))
    else:
        ref_dump(model, os.path.join(root, name), metadata=metadata)


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("surface") / "models")
    for seed, name in enumerate(MACHINES):
        _write(root, name, seed)
    return root


def _servers(root, **options):
    """(port server, reference client, reference app) over ``root``."""
    ours = ModelServer(root, device="cpu", **options)
    app = build_app({n: os.path.join(root, n) for n in sorted(os.listdir(root))
                     if not n.startswith(".")}, project="project", models_root=root,
                    **options)
    app._pinned = {}  # as the port: every machine comes from the scan
    return ours, Client(app), app


@pytest.fixture(scope="module")
def servers(models_root):
    ours, theirs, app = _servers(models_root)
    yield ours, theirs, app
    ours.close()
    app.engine.close()


def _ask_ours(app, method, path, body=b"", headers=None):
    r = app.handle(method, path, {"Content-Type": "application/json", **(headers or {})}, body)
    return r.status, {**r.headers, "Content-Type": r.content_type}, r.body


def _ask_theirs(client, method, path, body=b"", headers=None):
    r = client.open(path, method=method, data=body,
                    headers={"Content-Type": "application/json", **(headers or {})})
    return r.status_code, dict(r.headers), r.get_data()


X = (np.random.default_rng(42).normal(size=(40, len(TAGS))) * 3 + 5).astype(np.float32)
_BODY = json.dumps({"X": X.tolist()}).encode()
_M = "/gordo/v0/project"
CASES = {  # name -> (method, path, body, headers)
    "healthz": ("GET", "/healthz", b"", None),
    "healthz-f32": ("GET", f"{_M}/dense/healthz", b"", None),
    "healthz-int8": ("GET", f"{_M}/dense-int8/healthz", b"", None),
    "healthz-unknown": ("GET", f"{_M}/nope/healthz", b"", None),
    "models": ("GET", "/models", b"", None),
    "metadata": ("GET", f"{_M}/dense-int8/metadata", b"", None),
    "metadata-fleet": ("GET", "/metadata", b"", None),
    "prediction-bare": ("POST", f"{_M}/bare/prediction", _BODY, None),
    "prediction-detector": ("POST", f"{_M}/dense/prediction", _BODY, None),
    "anomaly": ("POST", f"{_M}/dense/anomaly/prediction", _BODY, None),
    "anomaly-int8": ("POST", f"{_M}/dense-int8/anomaly/prediction", _BODY, None),
    "anomaly-lstm": ("POST", f"{_M}/lstm/anomaly/prediction", _BODY, None),
    "anomaly-npz": ("POST", f"{_M}/dense-int8/anomaly/prediction", _BODY,
                    {"Accept": f"text/html, {wire.NPZ_CONTENT_TYPE};q=0.9"}),
    "prediction-npz": ("POST", f"{_M}/bare/prediction", _BODY,
                       {"Accept": wire.NPZ_CONTENT_TYPE}),
    "anomaly-records": ("POST", f"{_M}/dense/anomaly/prediction",
                        json.dumps({"X": [dict(zip(TAGS, r)) for r in X.tolist()]}).encode(), None),
    "anomaly-bare": ("POST", f"{_M}/bare/anomaly/prediction", _BODY, None),
    "anomaly-get": ("GET", f"{_M}/dense/anomaly/prediction", b"", None),
    "prediction-get": ("GET", f"{_M}/bare/prediction", b"", None),
    "reload-get": ("GET", "/reload", b"", None),
    "bad-json": ("POST", f"{_M}/dense/anomaly/prediction", b"{not json", None),
    "missing-X": ("POST", f"{_M}/dense/anomaly/prediction", b'{"Y": 1}', None),
    "ragged-X": ("POST", f"{_M}/dense/anomaly/prediction", b'{"X": [[1, 2], [3]]}', None),
    "missing-tag": ("POST", f"{_M}/dense/anomaly/prediction", b'{"X": [{"tag-0": 1}]}', None),
    "wrong-width": ("POST", f"{_M}/dense/anomaly/prediction",
                    json.dumps({"X": X[:, :3].tolist()}).encode(), None),
    "non-finite": ("POST", f"{_M}/dense/anomaly/prediction",
                   json.dumps({"X": [[1, 2, float("nan"), 4, 5]] * 3}).encode(), None),
    "too-short": ("POST", f"{_M}/lstm/anomaly/prediction",
                  json.dumps({"X": X[:3].tolist()}).encode(), None),
    "unknown-machine": ("POST", f"{_M}/nope/anomaly/prediction", _BODY, None),
    "unknown-project": ("POST", "/gordo/v0/other/dense/anomaly/prediction", _BODY, None),
    "bare-path-fleet": ("POST", "/anomaly/prediction", _BODY, None),
    "deadline-spent": ("POST", f"{_M}/bare/prediction", _BODY, {"X-Gordo-Deadline": "0"}),
    "deadline-junk": ("POST", f"{_M}/bare/prediction", _BODY, {"X-Gordo-Deadline": "soon"}),
    "trace-id": ("GET", "/models", b"", {"X-Gordo-Trace-Id": "abc123"}),
}
_STRUCTURED = ("expected_features", "got_features", "non_finite_columns")


def _payload(headers, raw):
    if wire.content_type_of(headers.get("Content-Type")) == wire.NPZ_CONTENT_TYPE:
        return wire.payload_from_npz(raw)
    return json.loads(raw)


@pytest.mark.parametrize("case", sorted(CASES))
def test_route_answers_as_the_reference_server(servers, case):
    ours, theirs, _ = servers
    method, path, body, headers = CASES[case]
    status, our_headers, our_raw = _ask_ours(ours, method, path, body, headers)
    ref_status, ref_headers, ref_raw = _ask_theirs(theirs, method, path, body, headers)
    assert status == ref_status, (our_raw[:300], ref_raw[:300])
    assert our_headers.get("Retry-After") == ref_headers.get("Retry-After")
    trace = our_headers["X-Gordo-Trace-Id"]
    assert trace and (headers or {}).get("X-Gordo-Trace-Id", trace) == trace
    assert wire.content_type_of(our_headers["Content-Type"]) == wire.content_type_of(
        ref_headers["Content-Type"])
    if wire.content_type_of(ref_headers["Content-Type"]) not in (
            "application/json", wire.NPZ_CONTENT_TYPE):
        return
    ours_p, ref_p = _payload(our_headers, our_raw), _payload(ref_headers, ref_raw)
    if status != 200:
        assert "error" in ours_p
        for key in _STRUCTURED:
            assert ours_p.get(key) == ref_p.get(key)
        return
    if "data" in ref_p:
        assert sorted(ours_p["data"]) == sorted(ref_p["data"])
        for field, ref_value in ref_p["data"].items():
            np.testing.assert_allclose(np.asarray(ours_p["data"][field]), np.asarray(ref_value),
                                       atol=1e-4, rtol=0, err_msg=field)
        extras = {k: v for k, v in ref_p.items() if k != "data"}
        assert sorted(k for k in ours_p if k != "data") == sorted(extras)
        for key, value in extras.items():
            np.testing.assert_allclose(ours_p[key], value, rtol=1e-6)
    elif case == "healthz":
        for key in ("ok", "status", "live", "ready", "quarantined", "suspect"):
            assert ours_p[key] == ref_p[key], key
        for key in ("generations", "precisions", "unverified"):
            assert ours_p["store"][key] == ref_p["store"][key], key
    else:
        assert ours_p == ref_p


def test_spent_deadline_never_reaches_the_engine_and_marks_the_machine_suspect(models_root):
    ours, theirs, app = _servers(models_root)
    try:
        for ask, server in ((_ask_ours, ours), (_ask_theirs, theirs)):
            engine = ours.engine if server is ours else app.engine
            before = engine.stats()["dispatches"]
            status, headers, _ = ask(server, "POST", f"{_M}/dense/anomaly/prediction", _BODY,
                                     {"X-Gordo-Deadline": "-5"})
            assert status == 504 and headers["Retry-After"] == "1"
            assert engine.stats()["dispatches"] == before
            health = json.loads(ask(server, "GET", "/healthz")[2])
            assert health["status"] == "degraded" and list(health["suspect"]) == ["dense"]
            assert ask(server, "POST", f"{_M}/dense/anomaly/prediction", _BODY)[0] == 200
            assert json.loads(ask(server, "GET", "/healthz")[2])["status"] == "ok"
    finally:
        ours.close()
        app.engine.close()


def test_admission_sheds_with_retry_after_as_the_reference(models_root):
    ours, theirs, app = _servers(models_root, max_inflight=1)
    try:
        for ask, server, gate in ((_ask_ours, ours, ours.admission),
                                  (_ask_theirs, theirs, app.admission)):
            gate.max_queue = 0
            held = gate.admit()
            status, headers, raw = ask(server, "POST", f"{_M}/bare/prediction", _BODY)
            assert status == 503 and int(headers["Retry-After"]) >= 1
            assert "overloaded" in json.loads(raw)["error"]
            held.release()
            assert ask(server, "POST", f"{_M}/bare/prediction", _BODY)[0] == 200
    finally:
        ours.close()
        app.engine.close()


def test_a_scoring_fault_quarantines_one_machine_and_a_probe_recovers_it(models_root):
    ours, theirs, app = _servers(models_root, quarantine_cooldown=COOLDOWN)
    try:
        for ask, server, engine in ((_ask_ours, ours, ours.engine),
                                    (_ask_theirs, theirs, app.engine)):
            healthy = engine.anomaly

            def broken(name, X, **kwargs):
                if name == "dense-int8":
                    raise RuntimeError("device fault")
                return healthy(name, X, **kwargs)

            engine.anomaly = broken
            path = f"{_M}/dense-int8/anomaly/prediction"
            status, headers, raw = ask(server, "POST", path, _BODY)
            assert status == 503 and int(headers["Retry-After"]) >= 1
            assert "quarantined" in json.loads(raw)["error"]
            health = json.loads(ask(server, "GET", "/healthz")[2])
            assert health["status"] == "degraded" and list(health["quarantined"]) == ["dense-int8"]
            assert health["quarantined"]["dense-int8"]["phase"] == "score"
            assert ask(server, "GET", f"{_M}/dense-int8/healthz")[0] == 503
            assert ask(server, "POST", f"{_M}/dense/anomaly/prediction", _BODY)[0] == 200
            assert ask(server, "POST", path, _BODY)[0] == 503  # inside the cooldown
            engine.anomaly = healthy
            time.sleep(COOLDOWN + 0.05)
            assert ask(server, "POST", path, b"{bad")[0] == 400  # a client error keeps the probe
            assert ask(server, "POST", path, _BODY)[0] == 200  # the probe recovers it
            assert json.loads(ask(server, "GET", "/healthz")[2])["status"] == "ok"
    finally:
        ours.close()
        app.engine.close()


def test_metrics_json_and_prometheus_parse_in_both_packages(servers):
    ours, theirs, _ = servers
    _ask_ours(ours, "POST", f"{_M}/dense-int8/anomaly/prediction", _BODY)
    status, headers, raw = _ask_ours(ours, "GET", "/metrics")
    view = json.loads(raw)
    assert status == 200 and sorted(view) == sorted(
        json.loads(_ask_theirs(theirs, "GET", "/metrics")[2]))
    assert view["engine"]["precision"]["machines"] == {"f32": 3, "int8": 1}
    assert view["resilience"]["admission"]["max_inflight"] == 64
    assert "gordo_server_requests_total" in view["registry"]
    status, headers, raw = _ask_ours(ours, "GET", "/metrics?format=prometheus")
    assert status == 200 and headers["Content-Type"] == exposition.CONTENT_TYPE
    samples = ref_exposition.parse_prometheus_text(raw.decode())
    assert samples == exposition.parse_prometheus_text(raw.decode())
    served = {tuple(sorted(labels.items())): value
              for labels, value in samples["gordo_server_requests_total"]}
    assert served[(("endpoint", "anomaly"), ("status", "200"))] >= 1
    int8 = [v for labels, v in samples["gordo_engine_precision_total"]
            if labels == {"precision": "int8"}]
    assert int8 and int8[0] >= 1
    for name in ("gordo_server_request_duration_seconds_bucket",
                 "gordo_server_wire_format_total", "gordo_engine_requests_total",
                 "gordo_engine_dispatch_batch_size_count", "gordo_resilience_admission_total"):
        assert name in samples, name


@pytest.mark.parametrize("kind", ["counter", "gauge", "histogram"])
def test_exposition_of_each_kind_matches_the_reference(kind):
    """The same observations in a port and a reference registry render to
    the same text, and each package parses the other's."""
    texts = []
    for registry in (Registry(), RefRegistry()):
        make = getattr(registry, kind)
        metric = make("gordo_test_total", 'help with "quotes"\nand a newline', labels=("k",))
        for value in (0.003, 0.2, 7.0):
            bound = metric.labels('v"\\1')
            if kind == "histogram":
                bound.observe(value)
            elif kind == "gauge":
                bound.set(value)
            else:
                bound.inc(value)
        text = (exposition.render_prometheus(registry) if isinstance(registry, Registry)
                else ref_exposition.render_prometheus(registry))
        texts.append(text)
    assert texts[0] == texts[1]
    assert exposition.parse_prometheus_text(texts[1]) == ref_exposition.parse_prometheus_text(
        texts[0])


@pytest.mark.parametrize("text", [
    "gordo_x{a=\"1\"} one\n", "# TYPE gordo_x wibble\n", "gordo_x{a=1} 2\n",
    "# TYPE h histogram\nh_bucket{le=\"+Inf\"} 2\nh_count 3\nh_sum 1\n"])
def test_prometheus_parser_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError):
        ref_exposition.parse_prometheus_text(text)
    with pytest.raises(ValueError):
        exposition.parse_prometheus_text(text)


# -- reload ----------------------------------------------------------------------
def test_reload_swaps_adds_removes_and_reports_a_bad_artifact(models_root, tmp_path):
    root = str(tmp_path / "models")
    shutil.copytree(models_root, root, ignore=shutil.ignore_patterns(".*"))
    ours, theirs, app = _servers(root)
    try:
        before = {ask.__name__: _payload(*ask(server, "POST", f"{_M}/dense/anomaly/prediction",
                                               _BODY)[1:])
                  for ask, server in ((_ask_ours, ours), (_ask_theirs, theirs))}
        time.sleep(0.05)  # a new mtime for the rewrite
        _write(root, "dense", seed=99)  # rewritten in place
        _write(root, "dense-new", seed=7)  # added
        shutil.rmtree(os.path.join(root, "lstm"))  # removed
        os.makedirs(os.path.join(root, "broken"))  # half-written: no manifest
        with open(os.path.join(root, "broken", "definition.json"), "w") as fh:
            fh.write("{}")
        reports = {}
        for ask, server in ((_ask_ours, ours), (_ask_theirs, theirs)):
            status, _, raw = ask(server, "POST", "/reload")
            assert status == 200
            reports[ask.__name__] = json.loads(raw)
        ours_r, ref_r = reports["_ask_ours"], reports["_ask_theirs"]
        assert ours_r["added"] == ref_r["added"] == ["dense-new"]
        assert ours_r["removed"] == ref_r["removed"] == ["lstm"]
        assert ours_r["refreshed"] == ref_r["refreshed"] == ["dense"]
        assert sorted(ours_r["errors"]) == sorted(ref_r["errors"]) == ["broken"]
        assert ours_r["total"] == ref_r["total"] == 4
        for ask, server in ((_ask_ours, ours), (_ask_theirs, theirs)):
            after = _payload(*ask(server, "POST", f"{_M}/dense/anomaly/prediction", _BODY)[1:])
            assert not np.allclose(after["data"]["model-output"],
                                   before[ask.__name__]["data"]["model-output"])
            assert ask(server, "POST", f"{_M}/lstm/anomaly/prediction", _BODY)[0] == 404
            assert ask(server, "POST", f"{_M}/broken/anomaly/prediction", _BODY)[0] == 503
            assert ask(server, "POST", f"{_M}/dense-new/anomaly/prediction", _BODY)[0] == 200
            health = json.loads(ask(server, "GET", "/healthz")[2])
            assert health["store"]["unverified"] == ["broken"]
            assert list(health["quarantined"]) == ["broken"]
        np.testing.assert_allclose(
            np.asarray(after["data"]["model-output"]),
            np.asarray(_payload(*_ask_ours(ours, "POST", f"{_M}/dense/anomaly/prediction",
                                           _BODY)[1:])["data"]["model-output"]), atol=1e-4)
        shutil.rmtree(os.path.join(root, "broken"))  # decommissioned: no longer sick
        assert _ask_ours(ours, "POST", "/reload")[0] == 200
        assert json.loads(_ask_ours(ours, "GET", "/healthz")[2])["status"] == "ok"
    finally:
        ours.close()
        app.engine.close()


def test_boot_quarantines_a_bad_artifact_and_serves_the_rest(models_root, tmp_path):
    root = str(tmp_path / "models")
    shutil.copytree(models_root, root, ignore=shutil.ignore_patterns(".*"))
    with open(os.path.join(root, "dense", "state.npz"), "ab") as fh:
        fh.write(b"torn")
    ours, theirs, app = _servers(root)
    try:
        for ask, server in ((_ask_ours, ours), (_ask_theirs, theirs)):
            health = json.loads(ask(server, "GET", "/healthz")[2])
            assert health["status"] == "degraded" and list(health["quarantined"]) == ["dense"]
            assert health["quarantined"]["dense"]["phase"] == "load"
            assert ask(server, "POST", f"{_M}/dense/anomaly/prediction", _BODY)[0] == 503
            assert ask(server, "POST", f"{_M}/dense-int8/anomaly/prediction", _BODY)[0] == 200
    finally:
        ours.close()
        app.engine.close()


def test_reload_drains_in_flight_requests_before_closing_the_old_engine(models_root, tmp_path):
    root = str(tmp_path / "models")
    shutil.copytree(models_root, root, ignore=shutil.ignore_patterns(".*"))
    ours = ModelServer(root, device="cpu")
    old = ours._state
    scoring = old.engine.anomaly
    started = threading.Event()

    def slow(name, X):
        started.set()
        time.sleep(0.3)
        return scoring(name, X)

    old.engine.anomaly = slow
    closed_with = []
    close = old.engine.close
    old.engine.close = lambda: (closed_with.append(old._inflight), close())
    statuses = []
    clients = [threading.Thread(target=lambda: statuses.append(_ask_ours(
        ours, "POST", f"{_M}/dense/anomaly/prediction", _BODY)[0])) for _ in range(4)]
    for c in clients:
        c.start()
    assert started.wait(30)
    _write(root, "dense-new", seed=5)
    report = ours.reload()
    for c in clients:
        c.join(timeout=60)
    assert not any(c.is_alive() for c in clients)
    assert report["added"] == ["dense-new"] and ours._state is not old
    assert statuses == [200] * 4 and closed_with == [0]
    assert _ask_ours(ours, "POST", f"{_M}/dense-new/anomaly/prediction", _BODY)[0] == 200
    ours.close()


def test_one_artifact_server_serves_bare_paths_and_refuses_reload(models_root):
    ours = ModelServer(os.path.join(models_root, "dense-int8"), device="cpu")
    app = build_app(os.path.join(models_root, "dense-int8"))
    theirs = Client(app)
    try:
        for path, method in (("/anomaly/prediction", "POST"), ("/prediction", "POST"),
                             ("/metadata", "GET"), ("/healthz", "GET"), ("/reload", "POST")):
            status = _ask_ours(ours, method, path, _BODY if method == "POST" else b"")[0]
            assert status == _ask_theirs(theirs, method, path,
                                         _BODY if method == "POST" else b"")[0], path
        assert _ask_ours(ours, "POST", "/reload")[0] == 422
        health = json.loads(_ask_ours(ours, "GET", f"{_M}/dense-int8/healthz")[2])
        assert health["generation"] == "gen-0001" and health["precision"] == "int8"
    finally:
        ours.close()
        app.engine.close()


# -- wire -------------------------------------------------------------------------
_ARRAYS = {"model-input": X, "model-output": X[:, :3] * 2,
           "total-anomaly-score": np.linalg.norm(X, axis=1).astype(np.float32)}


@pytest.mark.parametrize("header", [None, {}, {"tag-thresholds": [0.5, 1.5],
                                               "total-threshold": 2.0, "timestamps": ["t0"]}])
@pytest.mark.parametrize("direction", ["port-to-reference", "reference-to-port"])
def test_npz_codec_across_port_and_reference(direction, header):
    encode, decode = ((wire.encode_npz, ref_wire) if direction == "port-to-reference"
                      else (ref_wire.encode_npz, wire))
    blob = encode(_ARRAYS, header)
    arrays, got_header = decode.decode_npz(blob)
    assert got_header == (header or {})
    for name, value in _ARRAYS.items():
        assert arrays[name].dtype == value.dtype
        np.testing.assert_array_equal(arrays[name], value)
    payload = decode.payload_from_npz(blob)
    twin = (ref_wire if decode is wire else wire).payload_from_npz(blob)
    assert sorted(payload) == sorted(twin) and sorted(payload["data"]) == sorted(twin["data"])


@pytest.mark.parametrize("blob", [b"", b"not a zip", b"PK\x03\x04broken"])
def test_npz_decode_refuses_garbage_as_the_reference(blob):
    with pytest.raises(ValueError):
        ref_wire.decode_npz(blob)
    with pytest.raises(ValueError):
        wire.decode_npz(blob)


@pytest.mark.parametrize("accept", [None, "", "application/json", "application/x-gordo-npz",
                                    "text/html, Application/X-Gordo-Npz; q=0.1", "*/*"])
def test_npz_negotiation_follows_the_reference(accept):
    assert wire.wants_npz(accept) == ref_wire.wants_npz(accept)
    assert wire.content_type_of(accept) == ref_wire.content_type_of(accept)


# -- resilience pieces ------------------------------------------------------------
@pytest.mark.parametrize("value", [None, "", "soon", "nan", "inf", "-1", "0", "0.25", "1e9"])
def test_deadline_header_parses_as_the_reference(value):
    assert deadline.parse_header(value) == ref_deadline.parse_header(value)


def test_deadline_check_raises_only_once_expired():
    deadline.check("nothing bound")
    with deadline.deadline_scope(10.0):
        deadline.check("in time")
        assert 9.0 < deadline.remaining() <= 10.0
    with deadline.deadline_scope(0.0):
        with pytest.raises(deadline.DeadlineExceeded, match="checked at here"):
            deadline.check("here")
    assert deadline.remaining() is None


@pytest.mark.parametrize("seconds", [0, 0.2, 1.0, 1.5, 29.9])
def test_retry_after_is_the_reference_hint(seconds):
    assert _retry_after(seconds) == ref_retry_after(seconds)


@pytest.mark.parametrize("max_queue", [0, 1, 3, 32])
@pytest.mark.parametrize("max_inflight", [1, 2, 64])
def test_admission_watermarks_are_the_reference_default_class(max_inflight, max_queue):
    gate = AdmissionController(max_inflight=max_inflight, max_queue=max_queue)
    assert gate.inflight_limit == ref_qos.class_limit(max_inflight, ref_qos.DEFAULT_CLASS)
    assert gate.queue_limit == ref_qos.queue_limit(max_queue, ref_qos.DEFAULT_CLASS)
    ref = RefAdmission(max_inflight=max_inflight, max_queue=max_queue, queue_timeout=0.01)
    gate.queue_timeout = 0.01
    admitted = []
    outcomes = []
    for controller in (gate, ref):
        got = 0
        for _ in range(max_inflight + 1):
            try:
                admitted.append(controller.admit())
                got += 1
            except Exception as exc:  # noqa: BLE001 - the shed is the outcome
                assert type(exc).__name__ == "AdmissionRejected" and exc.retry_after > 0
        outcomes.append(got)
    assert outcomes[0] == outcomes[1] == max_inflight
    for slot in admitted:
        slot.release()


def test_admission_queue_waits_for_a_slot_and_close_drains():
    gate = AdmissionController(max_inflight=1, max_queue=2, queue_timeout=5.0)
    held = gate.admit()
    got = []
    waiter = threading.Thread(target=lambda: got.append(gate.admit()))
    waiter.start()
    while gate.stats()["queue_depth"] == 0:
        time.sleep(0.001)
    held.release()
    waiter.join(timeout=10)
    assert len(got) == 1 and gate.stats()["inflight"] == 1
    gate.close("draining")
    with pytest.raises(AdmissionRejected, match="draining"):
        gate.admit()
    assert not gate.drain(0.05)  # one still in flight
    got[0].release()
    assert gate.drain(1.0) and gate.closed == "draining"
    with deadline.deadline_scope(0.0):
        fresh = AdmissionController(max_inflight=1, max_queue=2)
        slot = fresh.admit()
        with pytest.raises(AdmissionRejected, match="deadline"):
            fresh.admit()
        slot.release()


def test_quarantine_ledger_follows_the_reference():
    now = [100.0]
    ours, ref = Quarantine(cooldown=5, clock=lambda: now[0]), RefQuarantine(
        cooldown=5, clock=lambda: now[0])
    for q in (ours, ref):
        q.quarantine("m", "boom", "score")
        q.mark_suspect("s", "slow")
        q.mark_suspect("m", "ignored: already quarantined")
    strip = lambda view: {k: {f: v for f, v in e.items() if f != "at"}  # noqa: E731
                          for k, e in view.items()}
    trace = []
    for step in range(4):
        now[0] += 2.0
        row = []
        for q in (ours, ref):
            row.append((q.is_quarantined("m"), q.retry_after("m"), q.probe_allowed("m"),
                        strip(q.quarantined()), strip(q.suspects()), q.last_error("m")))
            if step == 2:
                q.release_probe("m")
        assert row[0] == row[1], step
        trace.append(row[0][2])
    assert trace == [False, False, True, True]  # the released probe reopens at once
    for q in (ours, ref):
        q.clear_suspect("s")
        assert q.recover("m") and not q.recover("m") and not q.suspects()


def test_current_generation_reads_as_the_reference(models_root, tmp_path):
    assert current_generation(os.path.join(models_root, "dense")) is None
    gen_root = os.path.join(models_root, "dense-int8")
    assert current_generation(gen_root) == ref_current_generation(gen_root) == "gen-0001"
    (tmp_path / "CURRENT").write_text("not-a-gen")
    with pytest.raises(ArtifactIncomplete):
        current_generation(str(tmp_path))
    with pytest.raises(Exception, match="not a generation name"):
        ref_current_generation(str(tmp_path))
