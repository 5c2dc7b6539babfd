"""The port's watchman (``watchman/server.py``) and the ``probe`` fault point
against the reference, on the CPU.

The reference's own cases (``tests/test_observability.py``: probe duration
and a sticky last error, the fleet-wide engine sums of ``/metrics``, a
failed scrape counted as a target down, the Prometheus exposition of the
watchman's own series; ``tests/test_resilience.py``: the probe breaker's
full cycle on an injected clock, driven by a ``probe`` fault), with the
probes' GET injected (``http_get=``) where the reference monkeypatches
``requests.get``. Then ``read_build_progress`` of a manifest written by
the port's fleet build equals the reference's reading of it (the union
with a sibling ``.p1`` manifest too), ``watch_build_progress`` follows it
to completion, and the control plane's ``probe`` fault fails one worker's
probe while the other stays healthy.
"""

import importlib
import json
import os
import socket
from types import SimpleNamespace

import pytest

from gordo_components_tpu.watchman import server as ref_watchman

from gordo_components_tpu_torch.observability.exposition import parse_prometheus_text
from gordo_components_tpu_torch.resilience import faults
from gordo_components_tpu_torch.router import WorkerSpec, WorkerSupervisor
from gordo_components_tpu_torch.utils import http
from gordo_components_tpu_torch.watchman import (
    ControlPlane,
    WatchmanServer,
    make_watchman_server,
    read_build_progress,
    watch_build_progress,
)


class FakeClock:
    def __init__(self, t: float = 1000.0):
        self.t = t

    def __call__(self) -> float:
        return self.t

    def advance(self, seconds: float) -> None:
        self.t += seconds


class _FakeResponse:
    def __init__(self, status_code=200, body=None):
        self.status_code = status_code
        self._body = body

    def raise_for_status(self):
        if self.status_code >= 400:
            raise http.TransportError(f"HTTP {self.status_code}")

    def json(self):
        if self._body is None:
            raise ValueError("no JSON")
        return self._body


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def test_watchman_status_surfaces_probe_duration_and_last_error():
    calls = {"n": 0}

    def fake_get(url, timeout=None):
        # status() also scrapes each base URL's /debug/requests for the
        # slowest-request summary; only the healthz probes count here
        if "/healthz" in url:
            calls["n"] += 1
        if "m-dead" in url:
            raise ConnectionRefusedError("refused")
        return _FakeResponse(200)

    getter = {"fn": fake_get}
    watchman = WatchmanServer("proj", {"m-ok": "http://a", "m-dead": "http://b"},
                              http_get=lambda url, timeout=None: getter["fn"](url, timeout))
    body = watchman.status()
    assert calls["n"] == 2 and not body["ok"]
    assert body["slow-requests"] == {}  # fake targets expose no recorder
    by_target = {e["target"]: e for e in body["endpoints"]}
    ok, dead = by_target["m-ok"], by_target["m-dead"]
    assert ok["healthy"] and ok["error"] == "" and ok["last_error"] == ""
    assert not dead["healthy"]
    assert "refused" in dead["error"]
    assert "refused" in dead["last_error"]  # timestamped copy
    assert dead["latency_ms"] >= 0

    # the machine recovers: current error clears, last_error persists
    getter["fn"] = lambda url, timeout=None: _FakeResponse(200)
    recovered = {e["target"]: e for e in watchman.status()["endpoints"]}["m-dead"]
    assert recovered["healthy"] and recovered["error"] == ""
    assert "refused" in recovered["last_error"]


def test_watchman_metrics_aggregates_fleet_wide():
    bodies = {
        "http://a/metrics": {
            "engine": {"machines": 2, "dispatches": 10,
                       "host_path_machines": {"m2": "no scaler"}},
            "latency": {},
        },
        "http://b/metrics": {
            "engine": {"machines": 1, "dispatches": 5,
                       "host_path_machines": {}},
            "latency": {},
        },
    }
    watchman = WatchmanServer(
        "proj", {"m1": "http://a", "m2": "http://a", "m3": "http://b"},
        http_get=lambda url, timeout=None: _FakeResponse(200, bodies[url]),
    )
    out = watchman.metrics()
    # two distinct base URLs scraped once each, summed into the fleet block
    assert out["targets-total"] == 2 and out["targets-up"] == 2
    assert out["fleet"]["machines"] == 3
    assert out["fleet"]["dispatches"] == 15
    # host-path machines keep WHICH machine, target-prefixed (>1 server)
    assert out["fleet"]["host_path_machines"] == {"http://a/m2": "no scaler"}


def test_watchman_metrics_scrape_failure_counts_target_down():
    def fake_get(url, timeout=None):
        raise http.TransportError("down")

    watchman = WatchmanServer("proj", {"m1": "http://a"}, http_get=fake_get)
    out = watchman.metrics()
    assert out["targets-up"] == 0 and out["targets-total"] == 1
    assert "error" in out["targets"]["http://a"]
    assert out["fleet"]["dispatches"] == 0


def test_watchman_metrics_prometheus():
    watchman = WatchmanServer("proj", {"m1": "http://a"},
                              http_get=lambda url, timeout=None: _FakeResponse(200))
    watchman.status()  # record at least one probe into the registry
    response = watchman.handle("GET", "/metrics?format=prometheus", {}, b"")
    assert response.status == 200
    assert response.content_type.startswith("text/plain")
    samples = parse_prometheus_text(response.body.decode())
    assert "gordo_watchman_probes_total" in samples
    assert "gordo_watchman_probe_seconds_count" in samples
    assert watchman.handle("GET", "/nope", {}, b"").status == 404


def test_watchman_breaker_full_cycle():
    """Breaker open → half-open → closed on watchman probes, driven by
    probe faults and an injected clock: a dead target stops costing a
    timeout per scrape, and ONE successful probe re-closes the circuit."""
    clock = FakeClock()
    calls = {"n": 0}

    def fake_get(url, timeout=None):
        # status() also scrapes /debug/requests per base URL for the
        # slowest-request summary; only health probes count here
        if "/debug/requests" not in url:
            calls["n"] += 1
        return SimpleNamespace(status_code=200)

    watchman = WatchmanServer(
        "proj", {"m1": "http://fleet.example"},
        breaker_recovery=30.0, breaker_clock=clock, http_get=fake_get,
    )
    faults.configure("probe:m1:error:target down")
    for _ in range(3):  # min_calls failures trip the circuit
        body = watchman.status()
        assert body["endpoints"][0]["healthy"] is False
    # keyed by HOST: a dead host is one circuit however many machines
    # it serves
    breaker = watchman._breakers.get("http://fleet.example")
    assert breaker.state == "open"
    assert calls["n"] == 0  # fault fires BEFORE the HTTP hop

    # open: probes short-circuit from state, no HTTP attempted
    body = watchman.status()
    entry = body["endpoints"][0]
    assert entry["healthy"] is False and "circuit open" in entry["error"]
    assert body["open-circuits"] == {"http://fleet.example": "open"}
    assert "target down" in entry["last_error"]
    assert calls["n"] == 0

    # recovery window elapses while the target is STILL down: the single
    # half-open probe fails and the circuit re-opens
    clock.advance(30.1)
    watchman.status()
    assert breaker.state == "open"

    # target comes back: next window's probe succeeds and closes it
    faults.clear()
    clock.advance(30.1)
    body = watchman.status()
    assert calls["n"] == 1  # exactly the one recovery probe went out
    assert body["endpoints"][0]["healthy"] is True
    assert breaker.state == "closed"
    assert body["open-circuits"] == {}


def test_probe_fault_names_one_machine_over_http():
    """The watchman over a live HTTP target: a ``probe`` fault on one
    machine reports it unhealthy with the fault's message, the rest
    healthy, and the watchman's own front serves the view."""
    class _Target:
        def handle(self, method, path, headers, body):
            from gordo_components_tpu_torch.server.httpd import Response

            return Response(200, json.dumps({"ok": True, "generation": "gen-0001",
                                             "verified": True}).encode(),
                            "application/json", {})

        def close(self):
            pass

    import threading

    server = make_watchman_server(_Target(), "127.0.0.1", 0)  # a tiny HTTP target
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    base = f"http://127.0.0.1:{server.server_address[1]}"
    try:
        faults.configure("probe:m-1:error:the lake is down")
        watchman = WatchmanServer("proj", ["m-0", "m-1", "m-2"], target_url=base)
        front = make_watchman_server(watchman, "127.0.0.1", 0)
        front_thread = threading.Thread(target=front.serve_forever, daemon=True)
        front_thread.start()
        try:
            body = http.get(f"http://127.0.0.1:{front.server_address[1]}/", timeout=10).json()
        finally:
            front.shutdown()
            front.server_close()
            front_thread.join(timeout=5)
        by_target = {e["target"]: e for e in body["endpoints"]}
        assert not body["ok"]
        assert [by_target[m]["healthy"] for m in ("m-0", "m-1", "m-2")] == [True, False, True]
        assert "the lake is down" in by_target["m-1"]["error"]
        assert by_target["m-0"]["generation"] == "gen-0001"
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=5)


# -- build progress -----------------------------------------------------------

def test_read_build_progress_equals_the_reference(tmp_path):
    write = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")._write_manifest
    out = str(tmp_path / "fleet")
    completed = {f"m-{i:02d}": {"status": "completed", "model_dir": f"/x/m-{i:02d}"}
                 for i in range(5)}
    pending = [f"m-{i:02d}" for i in range(5, 70)]
    write(out, completed, pending, {"resumed": 1, "torn": 0, "rebuilt": 4})
    path = os.path.join(out, "fleet_manifest.json")
    assert read_build_progress(path) == ref_watchman.read_build_progress(path)
    assert read_build_progress(path)["n_pending"] == 65
    assert len(read_build_progress(path)["pending"]) == 50  # capped
    # a sibling manifest of another process: the union
    with open(os.path.join(out, "fleet_manifest.p1.json"), "w") as fh:
        json.dump({"updated": "2099-01-01 00:00:00+0000",
                   "machines": {m: {"status": "completed"} for m in pending[:60]},
                   "pending": pending[60:]}, fh)
    assert read_build_progress(path) == ref_watchman.read_build_progress(path)
    assert read_build_progress(path)["n_pending"] == 5
    # unreadable and wrong-shaped manifests degrade to an error record
    missing = str(tmp_path / "nope.json")
    assert "error" in read_build_progress(missing)
    assert read_build_progress(missing).keys() == ref_watchman.read_build_progress(missing).keys()
    wrong = str(tmp_path / "wrong.json")
    with open(wrong, "w") as fh:
        json.dump([1, 2], fh)
    assert read_build_progress(wrong) == ref_watchman.read_build_progress(wrong)


def test_watch_build_progress_follows_to_completion(tmp_path):
    write = importlib.import_module("gordo_components_tpu_torch.parallel.build_fleet")._write_manifest
    out = str(tmp_path / "fleet")
    write(out, {}, ["a", "b"])
    lines, steps = [], iter([({"a": {}}, ["b"]), ({"a": {}, "b": {}}, [])])

    def sleep(_):
        completed, pending = next(steps)
        write(out, completed, pending)

    path = os.path.join(out, "fleet_manifest.json")
    assert watch_build_progress(path, interval_s=1.0, emit=lines.append, sleep=sleep) is True
    assert [json.loads(line)["n_pending"] for line in lines] == [2, 1, 0]
    assert watch_build_progress(str(tmp_path / "gone.json"), emit=lines.append,
                                sleep=lambda _: None, max_iterations=2) is False


# -- the control plane's probe fault -------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _AliveWorker:
    def __init__(self, spec):
        self.spec = spec

    def start(self):
        pass

    pid = None

    def alive(self):
        return True

    def terminate(self, grace=5.0):
        pass

    kill = terminate


def test_control_plane_probe_fault_fails_one_worker():
    """``probe:<worker>:error`` stands in for a wedged worker: its probe
    fails before any HTTP (booting inside the grace, then unreachable and
    counted against its breaker), while the other worker's probe answers."""
    import threading

    class _Healthy:
        def handle(self, method, path, headers, body):
            from gordo_components_tpu_torch.server.httpd import Response

            return Response(200, b'{"ok": true, "status": "ok", "ready": true}',
                            "application/json", {})

        def close(self):
            pass

    servers = []
    specs = []
    for i in range(2):
        server = make_watchman_server(_Healthy(), "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        servers.append(server)
        specs.append(WorkerSpec(f"worker-{i}", i, "127.0.0.1", server.server_address[1]))
    clock = FakeClock()
    supervisor = WorkerSupervisor(specs, _AliveWorker)
    supervisor.start_all()
    control = ControlPlane(supervisor, respawn=False, boot_grace=5.0, clock=clock)
    try:
        faults.configure("probe:worker-1:error:wedged")
        first = control.probe_once()
        assert first["worker-0"]["state"] == "ok"
        assert first["worker-1"]["state"] == "booting" and "wedged" in first["worker-1"]["error"]
        clock.advance(10.0)  # past the boot grace: a real failure now
        for _ in range(3):
            later = control.probe_once()
        assert later["worker-0"]["state"] == "ok"
        assert later["worker-1"]["state"] == "unreachable"
        assert control.breakers.get("worker-1").state == "open"
        assert control.quarantine.is_quarantined("worker-1")
        assert control.routable("worker-0") and not control.routable("worker-1")
    finally:
        control.stop()
        for server in servers:
            server.shutdown()
            server.server_close()
