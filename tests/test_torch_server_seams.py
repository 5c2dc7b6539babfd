"""The port's request seams against the reference server, on the CPU.

Dense anomaly detectors are fitted and dumped by the JAX package. The
reference's WSGI app (werkzeug's test client, JAX on the CPU) and the port's
``ModelServer.handle`` (``device="cpu"``) serve the same models directory
under the same ``GORDO_TENANTS`` table, with each side's token buckets on
one injected clock. Both must answer ``/tenants`` alike, refuse a metered
tenant past its burst with 429 and the same ``Retry-After``, fold an unknown
tenant into ``default``, score ``/bulk/anomaly/prediction`` to the bit as
``/anomaly/prediction``, list the same stages on a request's
``/debug/requests/<id>`` (``?format=chrome`` parses as trace events), turn a
``model-load`` error fault into one quarantined machine while the rest
serve, show an ``engine-dispatch`` latency fault in the ``dispatch`` stage,
and write the same control-ledger records (less ``ts``). Arrays are held to
each other at atol 1e-4 (``tests/test_torch_server_surface.py``'s bound);
everything else exactly.

Below those, the engine: a mixed-class fused dispatch orders its slots as
``qos.weighted_interleave`` does (the reference's function) and scores each
request to the bit as the FIFO order does; two request threads and the
collector thread record every stage into the right timeline; and the CLI's
``run-server``, ``trace`` and ``tenants`` against a port server on
127.0.0.1.
"""

import json
import os
import shutil
import signal
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from werkzeug.test import Client  # noqa: E402

from gordo_components_tpu.observability import flightrec as ref_flightrec  # noqa: E402
from gordo_components_tpu.observability import ledger as ref_ledger  # noqa: E402
from gordo_components_tpu.resilience import faults as ref_faults  # noqa: E402
from gordo_components_tpu.resilience import qos as ref_qos  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.serializer import pipeline_from_definition as ref_from_definition  # noqa: E402
from gordo_components_tpu.server import build_app  # noqa: E402

from gordo_components_tpu_torch.observability import flightrec, ledger, spans, tracing  # noqa: E402
from gordo_components_tpu_torch.resilience import faults, qos  # noqa: E402
from gordo_components_tpu_torch.serializer import load  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
TAGS = [f"tag-{i}" for i in range(4)]
NAMES = ("dense-a", "dense-b", "dense-c")
TENANTS = "ops:interactive;batch:bulk;metered:standard:1:2:s3cret"
DEFINITION = {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
    "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {"DenseAutoEncoder": {
        "kind": "feedforward_hourglass", "epochs": 1, "batch_size": 16}}]}},
    "transformer": "MinMaxScaler",
}}}}
_M = "/gordo/v0/project"
X = (np.random.default_rng(42).normal(size=(24, len(TAGS))) * 3 + 5).astype(np.float32)
BODY = json.dumps({"X": X.tolist()}).encode()


def _fit(seed):
    rows = (np.random.default_rng(seed).normal(size=(48, len(TAGS))) * 3 + 5).astype(np.float32)
    model = ref_from_definition(DEFINITION)
    model.fit(rows, rows)
    pred = model.predict(rows)
    model.scaler.fit(np.abs(rows[len(rows) - len(pred):] - pred))
    return model


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("seams") / "models"
    for seed, name in enumerate(NAMES):
        ref_dump(_fit(seed), str(root / name), metadata={"dataset": {"tag_list": TAGS}})
    return str(root)


class _Clock:
    """One monotonic clock for both sides' token buckets."""

    def __init__(self):
        self.now = 1000.0

    def __call__(self):
        return self.now


@pytest.fixture
def clean_process_state(monkeypatch):
    """Fresh memory ledgers, no fault plan, the recorder on and empty, and
    the tenant table, in both packages."""
    monkeypatch.setenv("GORDO_TENANTS", TENANTS)
    monkeypatch.delenv("GORDO_LEDGER_DIR", raising=False)
    monkeypatch.delenv("GORDO_FAULTS", raising=False)
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    monkeypatch.setattr(ref_ledger, "LEDGER", ref_ledger.ControlLedger())
    for module in (faults, ref_faults):
        module.clear()
    for recorder in (flightrec.RECORDER, ref_flightrec.RECORDER):
        recorder.set_enabled(True)
        recorder.clear()
    yield
    for module in (faults, ref_faults):
        module.clear()
    for module in (ledger, ref_ledger):
        module.LEDGER.close()


def _servers(root, ledger_root, monkeypatch, clock=None):
    """(port server, reference client, reference app) over ``root``, each
    with its own ledger directory and, given ``clock``, token buckets on
    it."""
    monkeypatch.setenv("GORDO_LEDGER_DIR", os.path.join(ledger_root, "port"))
    ours = ModelServer(root, device="cpu")
    monkeypatch.setenv("GORDO_LEDGER_DIR", os.path.join(ledger_root, "ref"))
    app = build_app({n: os.path.join(root, n) for n in sorted(os.listdir(root))
                     if not n.startswith(".")}, project="project", models_root=root)
    app._pinned = {}  # as the port: every machine comes from the scan
    if clock is not None:
        ours.tenants = ours.admission.tenants = qos.TenantTable(
            qos.parse_tenants(TENANTS), clock=clock)
        app.tenants = app.admission.tenants = ref_qos.TenantTable(
            ref_qos.parse_tenants(TENANTS), clock=clock)
    return ours, Client(app), app


def _close(ours, app):
    ours.close()
    app.engine.close()


def _ask_ours(app, method, path, body=b"", headers=None):
    r = app.handle(method, path, {"Content-Type": "application/json", **(headers or {})}, body)
    return r.status, dict(r.headers), r.body


def _ask_theirs(client, method, path, body=b"", headers=None):
    r = client.open(path, method=method, data=body,
                    headers={"Content-Type": "application/json", **(headers or {})})
    return r.status_code, dict(r.headers), r.get_data()


def _both(ours, theirs):
    return ((_ask_ours, ours), (_ask_theirs, theirs))


def _ledger_records(directory):
    events = []
    for name in sorted(n for n in os.listdir(directory) if n.startswith("seg-")):
        with open(os.path.join(directory, name)) as fh:
            events += [json.loads(line) for line in fh if line.strip()]
    return events


def _without_timing(stats):
    return {k: v for k, v in stats.items() if k != "drain_rate_rps"}


# -- tenants and quotas ----------------------------------------------------------
def test_tenants_quota_and_unknown_tenant_answer_as_the_reference(
        models_root, tmp_path, monkeypatch, clean_process_state):
    clock = _Clock()
    ours, theirs, app = _servers(models_root, str(tmp_path), monkeypatch, clock)
    try:
        views = {}
        for ask, server in _both(ours, theirs):
            path = f"{_M}/dense-a/anomaly/prediction"
            statuses, retry = [], []
            # two within the burst, by name and by API key, then refused
            for header in ("metered", "s3cret", "metered"):
                status, headers, raw = ask(server, "POST", path, BODY, {"X-Gordo-Tenant": header})
                statuses.append(status)
                retry.append(headers.get("Retry-After"))
            assert statuses == [200, 200, 429]
            refused = json.loads(raw)
            assert refused["tenant"] == "metered" and "quota exhausted" in refused["error"]
            # unmetered tenants and unknown names are never refused
            for header in ("batch", "ops", "nobody", "nobody", None):
                headers = {"X-Gordo-Tenant": header} if header else {}
                assert ask(server, "POST", path, BODY, headers)[0] == 200
            clock.now += 1.0  # one token refilled
            assert ask(server, "POST", path, BODY, {"X-Gordo-Tenant": "metered"})[0] == 200
            status, _, raw = ask(server, "GET", "/tenants")
            assert status == 200
            views[ask.__name__] = (json.loads(raw), retry)
            clock.now -= 1.0  # the other side sees the same clock
        ours_v, ref_v = views["_ask_ours"], views["_ask_theirs"]
        assert ours_v[1] == ref_v[1] and ours_v[1][2] is not None
        ours_t, ref_t = ours_v[0], ref_v[0]
        assert _without_timing(ours_t.pop("admission")) == _without_timing(ref_t.pop("admission"))
        assert ours_t == ref_t
        seen = {row["value"]: row["count"] for row in ours_t["header_values_seen"]}
        assert seen["nobody"] == 2 and seen["metered"] == 4
    finally:
        _close(ours, app)


def test_bulk_scores_as_anomaly_to_the_bit(models_root, tmp_path, monkeypatch,
                                           clean_process_state):
    ours, theirs, app = _servers(models_root, str(tmp_path), monkeypatch)
    try:
        payloads = {}
        for ask, server in _both(ours, theirs):
            bodies = []
            for path in (f"{_M}/dense-b/anomaly/prediction",
                         f"{_M}/dense-b/bulk/anomaly/prediction"):
                for tenant in ("ops", "batch"):
                    status, _, raw = ask(server, "POST", path, BODY, {"X-Gordo-Tenant": tenant})
                    assert status == 200
                    bodies.append(raw)
            assert len(set(bodies)) == 1, "bulk and anomaly bodies differ"
            payloads[ask.__name__] = json.loads(bodies[0])
        for field, value in payloads["_ask_theirs"]["data"].items():
            np.testing.assert_allclose(np.asarray(payloads["_ask_ours"]["data"][field]),
                                       np.asarray(value), atol=1e-4, rtol=0, err_msg=field)
        # the bare bulk path of a fleet is the reference's 404
        for ask, server in _both(ours, theirs):
            assert ask(server, "POST", "/bulk/anomaly/prediction", BODY)[0] == 404
    finally:
        _close(ours, app)


# -- timelines ---------------------------------------------------------------------
def _stages(timeline_dict):
    return {span["name"] for span in timeline_dict["spans"]}


def test_debug_requests_list_the_reference_stages(models_root, tmp_path, monkeypatch,
                                                  clean_process_state):
    ours, theirs, app = _servers(models_root, str(tmp_path), monkeypatch)
    try:
        stages = {}
        for i, (ask, server) in enumerate(_both(ours, theirs)):
            trace_id = f"{i}ace0000feed0000"
            status, headers, _ = ask(server, "POST", f"{_M}/dense-c/anomaly/prediction", BODY,
                                     {"X-Gordo-Trace-Id": trace_id, "X-Gordo-Tenant": "ops"})
            assert status == 200 and headers["X-Gordo-Trace-Id"] == trace_id
            listing = json.loads(ask(server, "GET", "/debug/requests?limit=5")[2])
            assert listing["enabled"] and listing["requests"][0]["trace_id"] == trace_id
            assert listing["requests"][0]["tenant"] == "ops"
            status, _, raw = ask(server, "GET", f"/debug/requests/{trace_id}")
            assert status == 200
            timeline = json.loads(raw)
            assert timeline["status"] == "200" and timeline["meta"]["endpoint"] == "anomaly"
            stages[ask.__name__] = _stages(timeline)
            chrome = json.loads(ask(server, "GET", f"/debug/requests/{trace_id}?format=chrome")[2])
            complete = [e for e in chrome["traceEvents"] if e["ph"] == "X"]
            assert {e["name"] for e in complete} == stages[ask.__name__]
            assert all(e["dur"] >= 0 and e["ts"] > 0 for e in complete)
            assert chrome["otherData"]["trace_id"] == trace_id
            assert ask(server, "GET", "/debug/requests/ffffffffffffffff")[0] == 404
            # probe and scrape endpoints are not recorded; the 404 above is
            ask(server, "GET", "/healthz")
            assert json.loads(ask(server, "GET", "/debug/requests")[2])["recorded"] == 2
        assert stages["_ask_ours"] == stages["_ask_theirs"]
        assert {"admission", "queue_wait", "dispatch", "device_execute", "fetch", "score",
                "encode"} <= stages["_ask_ours"]
    finally:
        _close(ours, app)


def test_negotiated_timeline_header_and_recorder_off(models_root, tmp_path, monkeypatch,
                                                      clean_process_state):
    from gordo_components_tpu_torch.observability import stitch

    ours, theirs, app = _servers(models_root, str(tmp_path), monkeypatch)
    try:
        path = f"{_M}/dense-a/anomaly/prediction"
        status, headers, on_body = _ask_ours(ours, "POST", path, BODY, {"X-Gordo-Timeline": "1"})
        assert status == 200
        remote = stitch.decode_timeline(headers[stitch.TIMELINE_HEADER])
        assert {"dispatch", "fetch", "encode"} <= _stages(remote)
        assert stitch.TIMELINE_HEADER not in _ask_ours(ours, "POST", path, BODY)[1]
        flightrec.RECORDER.set_enabled(False)
        status, headers, off_body = _ask_ours(ours, "POST", path, BODY, {"X-Gordo-Timeline": "1"})
        assert status == 200 and stitch.TIMELINE_HEADER not in headers
        assert off_body == on_body  # the recorder changes no byte
    finally:
        _close(ours, app)


# -- faults and the ledger ----------------------------------------------------------
def test_model_load_fault_quarantines_one_machine_and_ledgers_agree(
        models_root, tmp_path, monkeypatch, clean_process_state):
    root = str(tmp_path / "models")
    shutil.copytree(models_root, root, ignore=shutil.ignore_patterns(".*"))
    spec = "model-load:dense-b:error"
    faults.configure(spec)
    ref_faults.configure(spec)
    ours, theirs, app = _servers(root, str(tmp_path), monkeypatch)
    try:
        for ask, server in _both(ours, theirs):
            health = json.loads(ask(server, "GET", "/healthz")[2])
            assert health["status"] == "degraded" and list(health["quarantined"]) == ["dense-b"]
            assert health["quarantined"]["dense-b"]["phase"] == "load"
            assert "FaultInjected" in health["quarantined"]["dense-b"]["error"]
            assert ask(server, "POST", f"{_M}/dense-b/anomaly/prediction", BODY)[0] == 503
            assert ask(server, "POST", f"{_M}/dense-a/anomaly/prediction", BODY)[0] == 200
        records = {side: _ledger_records(str(tmp_path / side / "worker-0"))
                   for side in ("port", "ref")}
        strip = [[{k: v for k, v in e.items() if k != "ts"} for e in records[side]]
                 for side in ("port", "ref")]
        assert strip[0] == strip[1]
        assert [(e["actor"], e["action"], e["target"]) for e in strip[0]] == [
            ("faults", "inject-plan", "model-load:dense-b"),
            ("quarantine", "quarantine", "dense-b"),
        ]
        for event in records["port"]:
            assert ledger.validate_event(event) == [] == ref_ledger.validate_event(event)
    finally:
        _close(ours, app)


def test_dispatch_latency_fault_shows_in_the_dispatch_stage(models_root, tmp_path, monkeypatch,
                                                            clean_process_state):
    ours, theirs, app = _servers(models_root, str(tmp_path), monkeypatch)
    spec = "engine-dispatch:dense-c:latency:0.05"
    faults.configure(spec)
    ref_faults.configure(spec)
    try:
        for i, (ask, server) in enumerate(_both(ours, theirs)):
            recorder = flightrec.RECORDER if ask is _ask_ours else ref_flightrec.RECORDER
            for machine, slow in (("dense-c", True), ("dense-a", False)):
                trace_id = f"{i}{int(slow)}1a7e000000000"[:16]
                assert ask(server, "POST", f"{_M}/{machine}/anomaly/prediction", BODY,
                           {"X-Gordo-Trace-Id": trace_id})[0] == 200
                timeline = recorder.get(trace_id)
                seams = [s for s in timeline.spans if s.name == "dispatch"
                         and s.attrs.get("machine") == machine]
                assert len(seams) == 1
                assert (seams[0].duration >= 0.05) == slow, seams[0].duration
    finally:
        _close(ours, app)


def test_quarantine_and_recovery_reach_the_ledger(tmp_path):
    from gordo_components_tpu_torch.resilience.quarantine import Quarantine

    sink = ledger.ControlLedger(str(tmp_path))
    original, ledger.LEDGER = ledger.LEDGER, sink
    try:
        q = Quarantine(cooldown=0)
        q.quarantine("m", "boom", "score")
        q.recover("m")
        assert not q.recover("m")  # nothing to recover: no record
    finally:
        ledger.LEDGER = original
        sink.close()
    events = _ledger_records(str(tmp_path))
    assert [(e["actor"], e["action"], e["target"], e.get("reason")) for e in events] == [
        ("quarantine", "quarantine", "m", "score: boom"), ("quarantine", "recover", "m", None)]


# -- the engine ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def engine_models(models_root):
    return {name: load(os.path.join(models_root, name), device="cpu") for name in NAMES}


def _held_submits(bucket, submits):
    """Queue ``submits`` [(machine idx, rows, class)] behind a held leader
    latch in that order, each from its own thread bound to its class, then
    let one of them lead. Returns (threads' results by position, the
    dispatches' item orders)."""
    dispatched = []
    original = bucket._dispatch

    def recording(rows, items, defer):
        dispatched.append([it.klass for it in items])
        return original(rows, items, defer)

    bucket._dispatch = recording
    results = [None] * len(submits)
    with bucket._cond:
        bucket._busy = True  # a leader is "busy": every submit queues

    def submit(i, idx, rows, klass):
        token = qos.set_current(qos.TenantSpec(f"t-{klass}", klass=klass))
        try:
            results[i] = bucket.submit(idx, rows, len(rows))
        finally:
            qos.reset(token)

    threads = []
    try:
        for i, (idx, rows, klass) in enumerate(submits):
            t = threading.Thread(target=submit, args=(i, idx, rows, klass))
            t.start()
            threads.append(t)
            deadline_at = time.monotonic() + 30
            while sum(map(len, bucket._pending.values())) < i + 1:
                assert time.monotonic() < deadline_at, "a submit never queued"
                time.sleep(0.001)
    finally:
        with bucket._cond:
            bucket._busy = False
            bucket._cond.notify_all()
        for t in threads:
            t.join(timeout=60)
        del bucket._dispatch
    assert not any(t.is_alive() for t in threads)
    return results, dispatched


CLASSES = ["bulk"] * 5 + ["interactive", "bulk", "standard", "interactive", "bulk", "standard"]


def test_mixed_class_dispatch_orders_slots_by_weighted_interleave_and_keeps_every_byte(
        engine_models, monkeypatch):
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "0")
    engine = ServingEngine(engine_models, device="cpu", max_batch=64)
    try:
        bucket, _ = engine._by_name[NAMES[0]]
        rng = np.random.default_rng(7)
        submits = [(i % len(NAMES),
                    (rng.normal(size=(64, len(TAGS))) * 3 + 5).astype(np.float32), klass)
                   for i, klass in enumerate(CLASSES)]
        fair, dispatched = _held_submits(bucket, submits)
        # one fused dispatch, its slots in the reference's weighted order
        assert dispatched == [ref_qos.weighted_interleave(CLASSES, lambda k: k)]
        assert dispatched[0] != CLASSES
        fifo, dispatched = _held_submits(bucket, [(i, x, "standard") for i, x, _ in submits])
        assert dispatched == [["standard"] * len(CLASSES)]
        for a, b in zip(fair, fifo):
            for field_a, field_b in zip(a, b):
                np.testing.assert_array_equal(field_a, field_b)
    finally:
        engine.close()


def test_two_request_threads_and_the_collector_record_into_the_right_timelines(
        engine_models, monkeypatch):
    tracing.install_log_record_factory()
    monkeypatch.setenv("GORDO_FILL_WINDOW_US", "0")
    monkeypatch.setenv("GORDO_DISPATCH_DEPTH", "2")
    engine = ServingEngine(engine_models, device="cpu")
    try:
        bucket, _ = engine._by_name[NAMES[0]]
        seen = []  # (thread, trace id) at each fetch
        original_fetch = bucket._fetch

        def fetch(job):
            seen.append((threading.current_thread().name, tracing.get_trace_id(),
                         [it.ctx.trace_id for it in job.items]))
            return original_fetch(job)

        monkeypatch.setattr(bucket, "_fetch", fetch)
        timelines = {}
        rng = np.random.default_rng(3)
        # two row buckets: the leader's first dispatch goes to the collector
        rows = {"aaaa": 40, "bbbb": 100}
        with bucket._cond:
            bucket._busy = True

        def request(tag):
            trace_id = tag * 4
            with tracing.trace(trace_id):
                timeline, token = spans.begin(trace_id)
                try:
                    engine.anomaly(NAMES[1], (rng.normal(size=(rows[tag], len(TAGS))) * 3 + 5)
                                   .astype(np.float32))
                finally:
                    spans.end(token)
            timelines[trace_id] = timeline

        threads = [threading.Thread(target=request, args=(tag,)) for tag in rows]
        for i, t in enumerate(threads):
            t.start()
            deadline_at = time.monotonic() + 30
            while sum(map(len, bucket._pending.values())) < i + 1:
                assert time.monotonic() < deadline_at
                time.sleep(0.001)
        with bucket._cond:
            bucket._busy = False
            bucket._cond.notify_all()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        engine.quiesce()
    finally:
        engine.close()
    assert sorted(timelines) == ["aaaaaaaaaaaaaaaa", "bbbbbbbbbbbbbbbb"]
    for trace_id, timeline in timelines.items():
        stages = [s.name for s in timeline.spans]
        for stage in ("queue_wait", "dispatch", "device_execute", "fetch"):
            assert stages.count(stage) == (2 if stage == "dispatch" else 1), (trace_id, stages)
    # the leader's first dispatch (at least) was fetched on the collector,
    # bound to its first request's trace id; each fetch span names the
    # thread that really fetched it
    collector = [entry for entry in seen if entry[0] == "gordo-bucket-collector"]
    assert collector and all(bound == ids[0] for _, bound, ids in collector)
    fetched_by = {timeline.trace_id: next(s.thread for s in timeline.spans if s.name == "fetch")
                  for timeline in timelines.values()}
    assert {trace_id: thread for thread, _, ids in seen for trace_id in ids} == fetched_by


def test_corrupt_fault_poisons_the_payload_as_the_reference(monkeypatch):
    for module in (faults, ref_faults):
        module.configure("engine-dispatch:m:corrupt")
    try:
        ours = faults.corrupt("engine-dispatch", "m", X)
        ref = ref_faults.corrupt("engine-dispatch", "m", X)
        np.testing.assert_array_equal(ours, ref)
        assert np.isnan(ours[:, 0]).all() and not np.isnan(X).any()
        assert faults.corrupt("engine-dispatch", "other", X) is X
        assert faults.corrupt("engine-dispatch", "m", "not an array") == "not an array"
    finally:
        for module in (faults, ref_faults):
            module.clear()


# -- the CLI -------------------------------------------------------------------------
def _cli(*args, **kwargs):
    return subprocess.run([sys.executable, "-m", "gordo_components_tpu_torch.cli", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)}, **kwargs)


def test_run_server_trace_and_tenants_verbs(models_root, tmp_path):
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        port = sock.getsockname()[1]
    base = f"http://127.0.0.1:{port}"
    env = {**os.environ, "PYTHONPATH": str(ROOT), "GORDO_LEDGER_DIR": str(tmp_path / "ledger")}
    server = subprocess.Popen(
        [sys.executable, "-m", "gordo_components_tpu_torch.cli", "run-server",
         "--models-dir", models_root, "--host", "127.0.0.1", "--port", str(port),
         "--device", "cpu", "--tenants", TENANTS],
        cwd=ROOT, env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    try:
        log = []
        while not any(f"on {base}" in line for line in log):
            line = server.stdout.readline()
            assert line, "".join(log)
            log.append(line)
        request = urllib.request.Request(
            f"{base}{_M}/dense-a/anomaly/prediction", data=BODY, method="POST",
            headers={"Content-Type": "application/json", "X-Gordo-Trace-Id": "c11c11c11c11c11c",
                     "X-Gordo-Tenant": "ops"})
        with urllib.request.urlopen(request, timeout=60) as response:
            assert response.status == 200
        listing = _cli("trace", "list", "--base-url", base, "--limit", "3")
        assert listing.returncode == 0, listing.stderr
        assert json.loads(listing.stdout)["requests"][0]["trace_id"] == "c11c11c11c11c11c"
        dumped = _cli("trace", "dump", "c11c11c11c11c11c", "--base-url", base, "--format", "json")
        assert dumped.returncode == 0, dumped.stderr
        assert {"dispatch", "fetch", "encode"} <= _stages(json.loads(dumped.stdout))
        out = tmp_path / "trace.json"
        chrome = _cli("trace", "dump", "c11c11c11c11c11c", "--base-url", base, "-o", str(out))
        assert chrome.returncode == 0 and chrome.stdout.strip() == str(out)
        assert json.loads(out.read_text())["traceEvents"]
        missing = _cli("trace", "dump", "0000000000000000", "--base-url", base)
        assert missing.returncode == 1 and "not in the flight recorder" in missing.stderr
        table = _cli("tenants", "--base-url", base)
        assert table.returncode == 0, table.stderr
        body = json.loads(table.stdout)
        assert {t["name"] for t in body["tenants"]} == {"batch", "default", "metered", "ops"}
        assert body["admission"]["max_inflight"] == 64
    finally:
        server.send_signal(signal.SIGTERM)
        try:
            rc = server.wait(timeout=60)
        finally:
            server.kill()
            server.stdout.close()
    assert rc == 0
    unreachable = _cli("tenants", "--base-url", base)
    assert unreachable.returncode == 1


@pytest.mark.parametrize("args, message", [
    (["--tenants", "x:nope"], "Bad --tenants"),
    (["--faults", "model-load:x"], "Bad --faults"),
    ([], "Provide --model-dir"),
])
def test_run_server_refuses_a_bad_command_line(args, message, monkeypatch):
    monkeypatch.delenv("MODEL_LOCATION", raising=False)
    result = _cli("run-server", "--device", "cpu", *args)
    assert result.returncode == 2 and message in result.stderr
