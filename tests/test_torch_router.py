"""The port's fleet router, supervisor, control plane and rollout, on the CPU.

The reference's own cases (``tests/test_router.py``) on the port's classes:
routing and control run against thread-backed scripted workers (the port's
``AppHTTPServer`` over a small scripted app: real HTTP over loopback, no
models) through the same supervisor + control-plane + router code paths the
subprocess tier runs — routes by placement, reroutes around a dead worker,
``/healthz`` degrades, a rolling reload canaries then sweeps, a failing
canary aborts, a concurrent rollout is refused, the control plane ejects and
respawns a dead worker, a respawn keeps its slot, and the admission gate's
close sheds, drains and wakes its waiters. The truncated-stitch pull of
``tests/test_slo.py`` runs the same way. Then the graceful-drain end to end
of the reference with two REAL port workers (``make_server(...,
device="cpu")`` in threads): a quiesced worker answers ``/healthz`` 503
``draining`` with ``X-Gordo-Draining: 1`` and every later request lands on
the survivor, 200. Last the parts the port adds or leaves out: a stale
kept-alive connection is replayed once without counting against the
breaker, ``/fleet`` equals the reference's disabled snapshot and
and ``/fleet/apply`` answers 409. The mesh router's cases are in
``tests/test_torch_mesh_serving.py``.
"""

import json
import socket
import sys
import threading
import time
from pathlib import Path

import pytest

from gordo_components_tpu.fleet import reconciler as ref_reconciler

from gordo_components_tpu_torch.observability import stitch
from gordo_components_tpu_torch.router import (
    WorkerSpec,
    assemble_fleet,
    make_router_server,
)
from gordo_components_tpu_torch.server.httpd import AppHandler, AppHTTPServer, Response
from gordo_components_tpu_torch.utils import http

pytestmark = pytest.mark.usefixtures("thread_hygiene")
sys.path.insert(0, str(Path(__file__).resolve().parent))


# -- harness ---------------------------------------------------------------------

def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class _ThreadWorker:
    """A thread-backed HTTP server satisfying the worker protocol
    (start/alive/pid/terminate/kill): the seam for the supervisor, control
    plane and router. ``app`` answers ``handle(method, path, headers,
    body)``; ``make`` (instead) builds the whole server for the spec."""

    def __init__(self, spec: WorkerSpec, app=None, make=None):
        self.spec = spec
        self._app = app
        self._make = make
        self._server = None
        self._thread = None

    def start(self):
        if self._make is not None:
            self._server = self._make(self.spec)
        else:
            self._server = AppHTTPServer((self.spec.host, self.spec.port), self._app)
        self._thread = threading.Thread(target=self._server.serve_forever, daemon=True)
        self._thread.start()

    @property
    def pid(self):
        return None

    @property
    def server(self):
        return self._server

    def alive(self):
        return self._server is not None

    def terminate(self, grace: float = 5.0):
        if self._server is not None:
            self._server.shutdown()
            self._server.server_close()
            self._thread.join(timeout=5)
            self._server = None

    kill = terminate


class _FakeWorkerState:
    """Per-worker scripted behavior + request record."""

    def __init__(self, name):
        self.name = name
        self.requests = []
        self.reloads = 0
        self.fail_reload = False
        self.generation = "gen-0000"
        self.lock = threading.Lock()


class _FakeApp:
    def __init__(self, state: _FakeWorkerState):
        self.state = state

    def close(self):
        pass

    def handle(self, method, raw_path, headers, body):
        state = self.state
        path = raw_path.split("?", 1)[0]

        def reply(payload, status=200, extra=None):
            return Response(status, json.dumps(payload).encode(), "application/json",
                            {"X-Gordo-Worker": state.name, **(extra or {})})

        if path == "/healthz":
            return reply({
                "ok": True, "status": "ok", "live": True, "ready": True,
                "store": {"generations": {"m": state.generation}},
            })
        if path == "/models":
            return reply({"models": ["machine-000", "machine-001"]})
        if path == "/reload":
            with state.lock:
                if state.fail_reload:
                    return reply({"error": "injected reload failure"}, status=500)
                state.reloads += 1
                state.generation = "gen-0001"
            return reply({"added": [], "refreshed": ["m"], "errors": {}})
        with state.lock:
            state.requests.append(path)
        return reply({"worker": state.name, "path": path})


def _build_fleet(n=3, respawn=False, app=_FakeApp, **kwargs):
    """A router over n scripted thread-backed workers, started and ready."""
    states = {}
    specs = [WorkerSpec(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(n)]

    def factory(spec):
        state = states.get(spec.name)
        if state is None:
            state = states[spec.name] = _FakeWorkerState(spec.name)
        return _ThreadWorker(spec, app(state))

    router = assemble_fleet(
        specs, factory, project="proj", respawn=respawn,
        breaker_recovery=0.5, **kwargs,
    )
    router.supervisor.start_all()
    assert router.supervisor.wait_ready(timeout=10) == sorted(s.name for s in specs)
    return router, states


class _Front:
    """The router's HTTP front in a thread."""

    def __init__(self, router):
        self.router = router
        self.server = make_router_server(router, "127.0.0.1", 0)
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()
        self.base = f"http://127.0.0.1:{self.server.server_address[1]}"

    def close(self):
        self.server.shutdown()
        self.server.server_close()
        self.thread.join(timeout=5)
        self.router.control.stop()
        self.router.supervisor.stop_all()


def _score(base, machine, project="proj", body=b'{"X": [[0.0]]}'):
    return _post(f"{base}/gordo/v0/{project}/{machine}/prediction", body)


def _post(url, body, headers=None):
    session = http.Session()
    try:
        return session.post(url, body, timeout=30,
                            headers={"Content-Type": "application/json", **(headers or {})})
    finally:
        session.close()


@pytest.fixture(scope="module")
def port_models_root(tmp_path_factory):
    """A models root with one dense anomaly machine fitted and dumped by the
    reference; (root, machine, a JSON body of its rows)."""
    from gordo_components_tpu.serializer import dump as ref_dump
    from test_torch_server_seams import BODY, TAGS, _fit

    root = tmp_path_factory.mktemp("router") / "models"
    ref_dump(_fit(0), str(root / "mach-1"), metadata={"dataset": {"tag_list": TAGS}})
    return str(root), "mach-1", BODY


@pytest.fixture
def router_base():
    """A live router over 3 scripted workers; yields (base_url, router,
    states) and tears the tier down."""
    router, states = _build_fleet(3)
    front = _Front(router)
    try:
        yield front.base, router, states
    finally:
        front.close()


# -- routing -------------------------------------------------------------------------

def test_router_routes_by_placement(router_base):
    """Every request for a machine lands on its PLACED worker — sticky
    (residency stays warm), verified via the X-Gordo-Worker echo."""
    base, router, states = router_base
    for machine in ("machine-000", "machine-001", "machine-777"):
        expected = router.placement.replica_set(machine)[0]
        for _ in range(3):
            response = _score(base, machine)
            assert response.status_code == 200
            assert response.headers["X-Gordo-Worker"] == expected
    # and the forwards actually spread by machine, not all to one worker
    owners = {router.placement.replica_set(f"machine-{i:03d}")[0] for i in range(30)}
    assert len(owners) > 1


def test_router_reroutes_around_dead_worker(router_base):
    """Killing a worker mid-fleet re-routes its machines to survivors
    with zero client-visible errors; the untouched machines keep their
    placement."""
    base, router, states = router_base
    machine = "machine-000"
    owner = router.placement.replica_set(machine)[0]
    survivor_machine = next(
        f"machine-{i:03d}" for i in range(100)
        if router.placement.replica_set(f"machine-{i:03d}")[0] != owner
    )
    router.supervisor.worker(owner).terminate()  # hard down, no respawn
    for _ in range(5):
        response = _score(base, machine)
        assert response.status_code == 200
        assert response.headers["X-Gordo-Worker"] != owner
    untouched = router.placement.replica_set(survivor_machine)[0]
    assert _score(base, survivor_machine).headers["X-Gordo-Worker"] == untouched


def test_router_healthz_degrades_not_dies(router_base):
    base, router, states = router_base
    assert http.get(f"{base}/healthz", timeout=5).json()["status"] == "ok"
    router.supervisor.worker("worker-1").terminate()
    body = http.get(f"{base}/healthz", timeout=5).json()
    assert body["status"] == "degraded"
    assert body["ready"] is True
    assert body["workers"]["worker-1"]["routable"] is False


def test_rolling_reload_canary_then_sweep(router_base):
    """POST /reload canaries ONE worker, verifies it, then sweeps the
    rest — every worker reloads exactly once, canary first."""
    base, router, states = router_base
    result = _post(f"{base}/reload", b"").json()
    assert result["aborted"] is False
    assert result["canary"] in states
    assert all(state.reloads == 1 for state in states.values())
    assert all(entry["ok"] for entry in result["workers"].values())
    # generations adopted fleet-wide, reported per worker by the verify
    for entry in result["workers"].values():
        assert entry["verified"]["generations"] == {"m": "gen-0001"}


def test_rolling_reload_canary_abort(router_base):
    """A failing canary ABORTS the rollout: no other worker reloads, the
    fleet keeps serving the old generation."""
    base, router, states = router_base
    canary = sorted(states)[0]
    states[canary].fail_reload = True
    result = _post(f"{base}/reload", b"").json()
    assert result["aborted"] is True
    assert result["canary"] == canary
    assert all(state.reloads == 0 for state in states.values())
    assert all(state.generation == "gen-0000" for state in states.values())


def test_rollout_refuses_concurrent_runs(router_base):
    """A second rollout while one is in progress answers busy instead of
    interleaving — two sweeps at once would reload several workers
    simultaneously and break the 1/N capacity contract."""
    base, router, states = router_base
    rollout = router.rollout
    assert rollout._op_lock.acquire(blocking=False)  # simulate in-flight
    try:
        result = rollout.rolling_reload()
        assert result["aborted"] is True and result.get("busy") is True
    finally:
        rollout._op_lock.release()
    assert all(state.reloads == 0 for state in states.values())
    # lock released: the next rollout proceeds normally
    result = rollout.rolling_reload()
    assert result["aborted"] is False


def test_control_plane_ejects_and_respawns_dead_worker():
    """A dead worker process is quarantined and respawned by the probe
    sweep; a healthy probe then recovers it into routability."""
    router, states = _build_fleet(2, respawn=True)
    try:
        control, supervisor = router.control, router.supervisor
        control.probe_once()
        assert control.routable("worker-0")
        supervisor.worker("worker-1").terminate()
        results = control.probe_once()  # sees the corpse: eject+respawn
        assert results["worker-1"]["state"] == "dead"
        assert supervisor.respawn_counts()["worker-1"] == 1
        assert control.quarantine.is_quarantined("worker-1")
        deadline = time.monotonic() + 10
        while time.monotonic() < deadline:
            if control.probe_once()["worker-1"]["state"] == "ok":
                break
            time.sleep(0.1)
        assert not control.quarantine.is_quarantined("worker-1")
        assert control.routable("worker-1")
    finally:
        control.stop()
        router.supervisor.stop_all()
        router.close()


def test_supervisor_respawn_preserves_slot():
    """Respawn keeps the spec (name, port): the ring, placement table,
    and cached base URLs survive a worker restart untouched."""
    router, states = _build_fleet(2)
    try:
        supervisor = router.supervisor
        old = supervisor.worker("worker-0")
        spec_before = old.spec
        old.terminate()
        fresh = supervisor.respawn("worker-0")
        assert fresh is not old
        assert fresh.spec == spec_before
        assert supervisor.alive("worker-0")
    finally:
        router.supervisor.stop_all()
        router.close()


class _OneShotHandler(AppHandler):
    """Answers HTTP/1.1 without ``Connection: close`` and then closes the
    socket anyway: every kept-alive connection the client pools is stale
    by its next use."""

    def _route(self, method):
        super()._route(method)
        self.close_connection = True


class _OneShotServer(AppHTTPServer):
    handler_class = _OneShotHandler


def test_stale_keepalive_connection_is_replayed_not_counted():
    """A forward on a pooled connection the worker has closed replays once
    on a fresh connection: 200 from the placed worker, and the breaker
    records no failure (a stale socket is not a dead worker)."""
    states = {}
    specs = [WorkerSpec(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(2)]

    def factory(spec):
        state = states.setdefault(spec.name, _FakeWorkerState(spec.name))
        return _ThreadWorker(spec, make=lambda s: _OneShotServer((s.host, s.port),
                                                                 _FakeApp(state)))

    router = assemble_fleet(specs, factory, project="proj", respawn=False)
    router.supervisor.start_all()
    assert len(router.supervisor.wait_ready(timeout=10)) == 2
    front = _Front(router)
    try:
        machine = "machine-001"
        owner = router.placement.replica_set(machine)[0]
        for _ in range(4):
            response = _score(front.base, machine)
            assert response.status_code == 200
            assert response.headers["X-Gordo-Worker"] == owner
        assert len(states[owner].requests) == 4
        breaker = router.control.breakers.get(owner)
        assert breaker.state == "closed" and 0 not in breaker._outcomes
    finally:
        front.close()


class _CountingHandler(AppHandler):
    writes = []

    def setup(self):
        super().setup()
        raw = self.wfile

        class _Counted:
            def write(_, data):
                self.writes.append(len(data))
                return raw.write(data)

            def __getattr__(_, name):
                return getattr(raw, name)

        self.wfile = _Counted()


class _CountingServer(AppHTTPServer):
    handler_class = _CountingHandler


def test_kept_alive_answers_go_out_in_one_write():
    """The front writes each answer's head and body at once: written apart
    on a kept-alive connection (a router's pool), Nagle holds the body back
    until the peer's delayed ACK of the head, some 40 ms an answer."""

    class _App:
        def handle(self, method, path, headers, body):
            return Response(200, b"x" * 20000, "application/json", {"X-Gordo-Worker": "0"})

        def close(self):
            pass

    _CountingHandler.writes = []
    server = _CountingServer(("127.0.0.1", 0), _App())
    threading.Thread(target=server.serve_forever, daemon=True).start()
    session = http.Session()
    try:
        url = f"http://127.0.0.1:{server.server_address[1]}/score"
        walls = []
        for _ in range(20):
            started = time.perf_counter()
            reply = session.post(url, b"y" * 1500)
            walls.append(time.perf_counter() - started)
            assert reply.status_code == 200 and len(reply.content) == 20000
            assert reply.headers["X-Gordo-Worker"] == "0"
    finally:
        session.close()
        server.shutdown()
        server.server_close()
    assert len(_CountingHandler.writes) == 20 and min(_CountingHandler.writes) > 20000
    assert sorted(walls)[10] < 0.02


# -- graceful drain (server-side)-------------------------------------------------------

def test_admission_close_sheds_and_drains():
    from gordo_components_tpu_torch.resilience.admission import (
        AdmissionController,
        AdmissionRejected,
    )

    gate = AdmissionController(max_inflight=2, max_queue=2)
    held = gate.admit()
    gate.close("draining for shutdown")
    with pytest.raises(AdmissionRejected) as excinfo:
        gate.admit()
    assert "draining" in str(excinfo.value)
    assert gate.drain(0.05) is False  # one still in flight
    held.release()
    assert gate.drain(1.0) is True
    assert gate.stats()["closed"] == "draining for shutdown"


def test_admission_close_wakes_queued_waiters():
    """close() must wake a queued waiter immediately — not leave it
    burning its full queue timeout against a gate that can never admit."""
    from gordo_components_tpu_torch.resilience.admission import (
        AdmissionController,
        AdmissionRejected,
    )

    gate = AdmissionController(max_inflight=1, max_queue=2, queue_timeout=30.0)
    held = gate.admit()
    outcome = {}

    def waiter():
        started = time.monotonic()
        try:
            gate.admit()
            outcome["result"] = "admitted"
        except AdmissionRejected:
            outcome["result"] = "shed"
        outcome["waited"] = time.monotonic() - started

    thread = threading.Thread(target=waiter)
    thread.start()
    time.sleep(0.2)  # let it queue
    gate.close("bye")
    thread.join(timeout=5)
    assert outcome["result"] == "shed"
    assert outcome["waited"] < 5.0  # nowhere near the 30s queue timeout
    held.release()


def test_router_e2e_real_workers_and_graceful_drain(port_models_root, monkeypatch):
    """Full stack: two REAL port workers behind the router — scoring
    routes to the placed worker (verified via X-Gordo-Worker), and a
    graceful drain of that worker (admission close → in-flight drain →
    engine quiesce) re-routes every subsequent request to the survivor
    with zero client-visible errors."""
    from gordo_components_tpu_torch.server.server import make_server

    monkeypatch.delenv("GORDO_LEDGER_DIR", raising=False)
    root, machine, body = port_models_root
    specs = [WorkerSpec(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(2)]
    workers = {}

    def factory(spec):
        worker = workers[spec.name] = _ThreadWorker(spec, make=lambda s: make_server(
            root, s.host, s.port, device="cpu", project="proj", worker_id=s.worker_id))
        return worker

    router = assemble_fleet(specs, factory, project="proj", respawn=False)
    router.supervisor.start_all()
    assert len(router.supervisor.wait_ready(timeout=60)) == 2
    front = _Front(router)
    try:
        owner = router.placement.replica_set(machine)[0]
        url = f"{front.base}/gordo/v0/proj/{machine}/prediction"
        response = _post(url, body)
        assert response.status_code == 200
        owner_id = str(router.supervisor.specs[owner].worker_id)
        assert response.headers["X-Gordo-Worker"] == owner_id
        assert "model-output" in response.json()["data"]

        # graceful drain of the owner: every later request must land on
        # the survivor, 200, no errors — the zero-drop restart contract
        assert workers[owner].server.model_server.quiesce(drain_timeout=5.0) is True
        drained = http.get(f"{router.supervisor.specs[owner].base_url}/healthz", timeout=5)
        assert drained.status_code == 503
        assert drained.headers.get("X-Gordo-Draining") == "1"
        assert drained.json()["status"] == "draining"
        for _ in range(4):
            response = _post(url, body)
            assert response.status_code == 200
            assert response.headers["X-Gordo-Worker"] != owner_id
    finally:
        front.close()


# -- stitching: the pull fallback ------------------------------------------------------

class _ScriptedWorkerState:
    def __init__(self, name):
        self.name = name
        self.timelines = {}
        self.debug_hits = 0


class _ScriptedApp:
    """Scoring always answers truncated (the header was too big); the full
    timeline waits in this worker's ``/debug/requests/<id>``."""

    def __init__(self, state):
        self.state = state

    def close(self):
        pass

    def handle(self, method, raw_path, headers, body):
        state = self.state
        path = raw_path.split("?", 1)[0]

        def reply(payload, status=200, extra=None):
            return Response(status, json.dumps(payload).encode(), "application/json",
                            {"X-Gordo-Worker": state.name, **(extra or {})})

        if path == "/healthz":
            return reply({"ok": True, "status": "ok", "live": True, "ready": True})
        if path == "/models":
            return reply({"models": ["mach-x"]})
        if path.startswith("/debug/requests/"):
            state.debug_hits += 1
            trace_id = path.rsplit("/", 1)[1]
            if trace_id not in state.timelines:
                return reply({"error": "rotated"}, status=404)
            return reply(state.timelines[trace_id])
        trace_id = headers.get("X-Gordo-Trace-Id", "")
        state.timelines[trace_id] = {
            "trace_id": trace_id,
            "started": time.time(),
            "duration_ms": 8.0,
            "spans": [{"name": "device_execute", "start_ms": 1.0, "duration_ms": 5.0,
                       "thread": "collector"}],
            "events": [],
        }
        extra = {}
        if headers.get(stitch.TIMELINE_HEADER):
            extra[stitch.TIMELINE_TRUNCATED_HEADER] = "99999"
        return reply({"worker": state.name}, extra=extra)


def test_truncated_stitch_pulls_from_worker_on_debug_read():
    states = {}
    specs = [WorkerSpec(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(2)]

    def factory(spec):
        state = states.setdefault(spec.name, _ScriptedWorkerState(spec.name))
        return _ThreadWorker(spec, _ScriptedApp(state))

    router = assemble_fleet(specs, factory, project="proj", respawn=False)
    router.supervisor.start_all()
    assert len(router.supervisor.wait_ready(timeout=10)) == 2
    front = _Front(router)
    try:
        response = _post(f"{front.base}/gordo/v0/proj/mach-x/prediction", b'{"X": [[0.0]]}')
        assert response.status_code == 200
        trace_id = response.headers["X-Gordo-Trace-Id"]
        owner = response.headers["X-Gordo-Worker"]
        full = http.get(f"{front.base}/debug/requests/{trace_id}", timeout=10).json()
        merged_names = {s["name"] for s in full["spans"]}
        assert "route" in merged_names
        # the pull fallback fetched the worker's full timeline ON READ
        assert "device_execute" in merged_names
        worker_span = [s for s in full["spans"] if s["name"] == "device_execute"][0]
        assert worker_span["process"] == owner
        assert states[owner].debug_hits == 1
        # second read does NOT pull again (claimed once)
        http.get(f"{front.base}/debug/requests/{trace_id}", timeout=10)
        assert states[owner].debug_hits == 1
        chrome = http.get(f"{front.base}/debug/requests/{trace_id}?format=chrome",
                          timeout=10).json()
        assert len({e["pid"] for e in chrome["traceEvents"] if e.get("ph") == "X"}) >= 2
    finally:
        front.close()


# -- what the port leaves out ------------------------------------------------------------

def test_fleet_answers_the_reference_disabled_snapshot(router_base):
    base, router, states = router_base
    assert router.fleet is None
    response = http.get(f"{base}/fleet", timeout=5)
    assert response.status_code == 200
    assert response.json() == ref_reconciler.disabled_snapshot()
    applied = _post(f"{base}/fleet/apply", b"{}")
    assert applied.status_code == 409
    assert applied.json()["enabled"] is False and "not constructed" in applied.json()["error"]
    assert http.get(f"{base}/fleet/status", timeout=5).status_code == 409

