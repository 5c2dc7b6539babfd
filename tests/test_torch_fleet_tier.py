"""The port's fleet tier end to end, on the CPU, against the reference's tier.

- Two repairs a router exposes. ``run-server``'s SIGTERM drains before its
  listener stops: while a request is in flight, ``/healthz`` answers 503
  ``draining`` with ``X-Gordo-Draining: 1``, the request finishes 200 and
  the process exits 0 (a server that stops listening first reads as dead).
  Two servers with worker ids 0 and 1 over one models root write two ledger
  trees and two warehouse trees and stamp ``X-Gordo-Worker`` on every
  answer.
- Parity: the reference tier (its router over reference ``build_app``
  workers in threads) and the port tier (the port's router over port
  workers with ``device="cpu"`` in threads) serve copies of one models root
  (two small PatchTST detectors fitted by the reference, whose side runs the
  Pallas kernel in interpret mode, and two dense ones). The same requests
  get the same routed worker, the same status codes and scores within
  ``SERVE_RTOL``; each side's routed trace holds ``route`` and the worker's
  stages, stitched into the worker's lane, inside the route's window.
- ``python -m gordo_components_tpu_torch.cli run-fleet-server --device cpu
  --workers 2`` as a subprocess: it boots, scores, maps no ``libtorch`` into
  the router's process, exits 0 on SIGTERM and leaves no worker behind.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from werkzeug.serving import make_server as werkzeug_server  # noqa: E402

from gordo_components_tpu import router as ref_router  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.server import build_app  # noqa: E402
from gordo_components_tpu.server.server import scan_models_root  # noqa: E402

from gordo_components_tpu_torch import router  # noqa: E402
from gordo_components_tpu_torch.observability import ledger  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer, make_server  # noqa: E402
from gordo_components_tpu_torch.utils import http  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_serving as patchtst  # noqa: E402
import test_torch_server_seams as dense  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVE_RTOL = 1e-4
PATCHTST = ("pt-a", "pt-b")
DENSE = ("dn-a", "dn-b")
pytestmark = pytest.mark.usefixtures("thread_hygiene")


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


@pytest.fixture(scope="module")
def fleet_root(tmp_path_factory):
    """Two PatchTST and two dense detectors fitted and dumped by the
    reference into one models root; (root, {machine: request body})."""
    root = tmp_path_factory.mktemp("fleet-tier") / "models"
    rng = np.random.default_rng(7)
    bodies = {}
    for i, name in enumerate(PATCHTST):
        X = (rng.normal(size=(72, len(patchtst.TAGS))) * 3 + 5).astype(np.float32)
        ref_dump(patchtst._fit(X), str(root / name),
                 metadata={"dataset": {"tag_list": patchtst.TAGS}})
        rows = X[i:i + patchtst.LOOKBACK + 3]
        bodies[name] = json.dumps({"X": rows.tolist()}).encode()
    for i, name in enumerate(DENSE):
        ref_dump(dense._fit(i), str(root / name), metadata={"dataset": {"tag_list": dense.TAGS}})
        bodies[name] = dense.BODY
    return str(root), bodies


@pytest.fixture
def quiet_process_state(monkeypatch):
    """Memory-only ledgers and warehouses in this process, a fresh ledger
    after the test."""
    monkeypatch.delenv("GORDO_LEDGER_DIR", raising=False)
    monkeypatch.delenv("GORDO_TELEMETRY_DIR", raising=False)
    monkeypatch.delenv("GORDO_WORKER_ID", raising=False)
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    yield
    ledger.LEDGER.close()


# -- repair 1: the graceful drain of run-server ----------------------------------

def _wait_healthy(url: str, timeout: float, proc=None) -> None:
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        if proc is not None and proc.poll() is not None:
            raise AssertionError(f"process exited {proc.returncode} before it was ready")
        try:
            if http.get(url, timeout=2.0).status_code == 200:
                return
        except http.TransportError:
            pass
        time.sleep(0.2)
    raise AssertionError(f"{url} not healthy within {timeout}s")


def test_sigterm_answers_draining_until_the_inflight_request_finishes(fleet_root, tmp_path):
    root, bodies = fleet_root
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    log = open(tmp_path / "server.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gordo_components_tpu_torch.cli", "run-server",
         "--models-dir", root, "--host", "127.0.0.1", "--port", str(port), "--device", "cpu",
         "--faults", f"engine-dispatch:{DENSE[0]}:latency:3"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT), "GORDO_DRAIN_TIMEOUT": "20",
             "GORDO_LEDGER_DIR": str(tmp_path / "ledger")})
    try:
        _wait_healthy(f"{base}/healthz", 120, proc)
        answered = {}

        def inflight():
            reply = http.Session().post(f"{base}/gordo/v0/project/{DENSE[0]}/anomaly/prediction",
                                        bodies[DENSE[0]], timeout=60,
                                        headers={"Content-Type": "application/json"})
            answered["status"] = reply.status_code

        thread = threading.Thread(target=inflight)
        thread.start()
        time.sleep(1.0)  # the request now sleeps in its dispatch's fault
        proc.send_signal(signal.SIGTERM)
        time.sleep(0.3)
        drained = http.get(f"{base}/healthz", timeout=2.0)
        assert drained.status_code == 503
        assert drained.headers.get("X-Gordo-Draining") == "1"
        assert drained.json()["status"] == "draining"
        shed = http.Session().post(f"{base}/gordo/v0/project/{DENSE[1]}/anomaly/prediction",
                                   bodies[DENSE[1]], timeout=10,
                                   headers={"Content-Type": "application/json"})
        assert shed.status_code == 503 and shed.headers.get("X-Gordo-Draining") == "1"
        thread.join(timeout=30)
        assert answered.get("status") == 200
        assert proc.wait(timeout=60) == 0
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        log.close()


# -- repair 2: worker identity ---------------------------------------------------

@pytest.mark.parametrize("ledger_env", [False, True], ids=["models-root", "GORDO_LEDGER_DIR"])
def test_two_worker_ids_write_two_trees_and_stamp_their_answers(
        fleet_root, tmp_path, monkeypatch, quiet_process_state, ledger_env):
    import shutil

    root = str(tmp_path / "models")
    shutil.copytree(fleet_root[0], root)
    ledger_root = tmp_path / "ledgers"
    if ledger_env:
        monkeypatch.setenv("GORDO_LEDGER_DIR", str(ledger_root))
    servers = [ModelServer(root, device="cpu", worker_id=i) for i in (0, 1)]
    try:
        for i, server in enumerate(servers):
            for path in ("/healthz", f"/gordo/v0/project/{DENSE[0]}/anomaly/prediction"):
                response = server.handle("POST" if "prediction" in path else "GET", path,
                                         {"Content-Type": "application/json"},
                                         fleet_root[1][DENSE[0]])
                assert response.status == 200
                assert response.headers["X-Gordo-Worker"] == str(i)
            assert json.loads(server.handle("GET", "/healthz", {}, b"").body)["worker_id"] == i
            assert server.incidents.role == f"worker-{i}"
            assert server.telemetry.worker == str(i)
        telemetry = Path(root) / ".telemetry"
        assert sorted(p.name for p in telemetry.iterdir() if p.name.startswith("worker-")) == [
            "worker-0", "worker-1"]
        if ledger_env:
            assert sorted(p.name for p in ledger_root.iterdir()) == ["worker-0", "worker-1"]
        else:
            assert sorted(p.name for p in telemetry.iterdir() if p.name.startswith("ledger-")) == [
                "ledger-worker-0", "ledger-worker-1"]
        # the timelines name their worker
        for i, server in enumerate(servers):
            server.handle("POST", f"/gordo/v0/project/{DENSE[1]}/anomaly/prediction",
                          {"Content-Type": "application/json",
                           "X-Gordo-Trace-Id": f"named-{i}"}, fleet_root[1][DENSE[1]])
            timeline = json.loads(server.handle("GET", f"/debug/requests/named-{i}", {},
                                                b"").body)
            assert timeline["meta"]["worker"] == i
    finally:
        for server in servers:
            server.close()
    # unset: worker 0's paths, and no header
    unnamed = ModelServer(root, device="cpu")
    try:
        assert "X-Gordo-Worker" not in unnamed.handle("GET", "/healthz", {}, b"").headers
        assert unnamed.incidents.role == "worker-0"
    finally:
        unnamed.close()


# -- parity: the reference tier and the port tier ----------------------------------

class _Worker:
    """A thread-backed worker (the worker protocol's seam)."""

    def __init__(self, spec, make):
        self.spec, self._make, self.server, self._thread = spec, make, None, None

    def start(self):
        self.server = self._make(self.spec)
        self._thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self._thread.start()

    pid = None

    def alive(self):
        return self.server is not None

    def terminate(self, grace=5.0):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self._thread.join(timeout=5)
            self.server = None

    kill = terminate


def _reference_tier(root, specs):
    def make(spec):
        app = build_app(scan_models_root(root), project="proj", models_root=root,
                        worker_id=spec.worker_id)
        return werkzeug_server(spec.host, spec.port, app, threaded=True)

    tier = ref_router.assemble_fleet(specs, lambda s: _Worker(s, make), project="proj",
                                     respawn=False)
    return tier, lambda: werkzeug_server("127.0.0.1", 0, tier, threaded=True)


def _port_tier(root, specs):
    def make(spec):
        return make_server(root, spec.host, spec.port, device="cpu", project="proj",
                           worker_id=spec.worker_id)

    tier = router.assemble_fleet(specs, lambda s: _Worker(s, make), project="proj",
                                 respawn=False)
    return tier, lambda: router.make_router_server(tier, "127.0.0.1", 0)


def _serve_tier(build, root, tmp_path, label):
    import shutil

    copy = str(tmp_path / label)
    shutil.copytree(root, copy)
    specs = [router.WorkerSpec(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(2)]
    tier, front = build(copy, specs)
    tier.supervisor.start_all()
    assert len(tier.supervisor.wait_ready(timeout=120)) == 2
    server = front()
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    port = getattr(server, "server_port", None) or server.server_address[1]
    return tier, server, thread, f"http://127.0.0.1:{port}"


def _ask(base, bodies):
    session = http.Session()
    answers = {}
    try:
        for name, body in bodies.items():
            reply = session.post(f"{base}/gordo/v0/proj/{name}/anomaly/prediction", body,
                                 timeout=120, headers={"Content-Type": "application/json"})
            trace_id = reply.headers["X-Gordo-Trace-Id"]
            timeline = session.get(f"{base}/debug/requests/{trace_id}", timeout=30).json()
            answers[name] = (reply.status_code, reply.headers.get("X-Gordo-Worker"),
                             reply.json(), timeline)
        bad = session.post(f"{base}/gordo/v0/proj/{DENSE[0]}/anomaly/prediction", b"{}",
                           timeout=30, headers={"Content-Type": "application/json"})
        missing = session.post(f"{base}/gordo/v0/proj/nope/anomaly/prediction", dense.BODY,
                               timeout=30, headers={"Content-Type": "application/json"})
        answers["statuses"] = (bad.status_code, missing.status_code,
                               session.get(f"{base}/healthz", timeout=10).status_code)
    finally:
        session.close()
    return answers


def _stitched(timeline, worker_name):
    spans = timeline["spans"]
    route = next(s for s in spans if s["name"] == "route")
    lane = [s for s in spans if s.get("process") == worker_name]
    names = {s["name"] for s in lane}
    end = route["start_ms"] + route["duration_ms"]
    inside = all(route["start_ms"] - 2.0 <= s["start_ms"]
                 and s["start_ms"] + s["duration_ms"] <= end + 2.0 for s in lane)
    return names, inside


def test_port_tier_routes_and_scores_as_the_reference_tier(fleet_root, tmp_path,
                                                            quiet_process_state):
    root, bodies = fleet_root
    tiers = {}
    try:
        for label, build in (("reference", _reference_tier), ("port", _port_tier)):
            tiers[label] = _serve_tier(build, root, tmp_path, label)
        theirs = _ask(tiers["reference"][3], bodies)
        ours = _ask(tiers["port"][3], bodies)
        assert ours["statuses"] == theirs["statuses"] == (400, 404, 200)
        port_tier = tiers["port"][0]
        for name in bodies:
            status, worker, payload, timeline = ours[name]
            ref_status, ref_worker, ref_payload, ref_timeline = theirs[name]
            assert status == ref_status == 200
            # the same placement: both rings hash the worker names with SHA-1
            owner = port_tier.placement.replica_set(name)[0]
            assert worker == ref_worker == str(port_tier.supervisor.specs[owner].worker_id)
            assert sorted(payload["data"]) == sorted(ref_payload["data"])
            for field, value in ref_payload["data"].items():
                np.testing.assert_allclose(np.asarray(payload["data"][field]), np.asarray(value),
                                           rtol=SERVE_RTOL, atol=SERVE_RTOL, err_msg=field)
            # one stitched trace on each side: the route stage and the
            # worker's lane inside it
            for trace in (timeline, ref_timeline):
                names, inside = _stitched(trace, owner)
                assert {"device_execute", "score"} <= names, names
                assert inside
            assert timeline["meta"]["stitched"] == [owner]
    finally:
        for tier, server, thread, _ in tiers.values():
            server.shutdown()
            server.server_close()
            thread.join(timeout=5)
            tier.supervisor.stop_all()
            tier.close()


# -- run-fleet-server as a process --------------------------------------------------

def _children(pid: int):
    found = []
    for entry in os.listdir("/proc"):
        if not entry.isdigit():
            continue
        try:
            with open(f"/proc/{entry}/stat") as fh:
                fields = fh.read().rsplit(")", 1)[1].split()
        except OSError:
            continue
        if int(fields[1]) == pid:
            found.append(int(entry))
    return found


def _consecutive_free_ports(n: int) -> int:
    for _ in range(50):
        base = _free_port()
        try:
            socks = []
            for i in range(n):
                sock = socket.socket()
                socks.append(sock)
                sock.bind(("127.0.0.1", base + i))
            return base
        except OSError:
            continue
        finally:
            for sock in socks:
                sock.close()
    raise RuntimeError("no run of free ports")


def test_run_fleet_server_boots_scores_and_leaves_no_worker(fleet_root, tmp_path):
    root, bodies = fleet_root
    port = _free_port()
    base = f"http://127.0.0.1:{port}"
    log = open(tmp_path / "fleet.log", "wb")
    proc = subprocess.Popen(
        [sys.executable, "-m", "gordo_components_tpu_torch.cli", "run-fleet-server",
         "--models-dir", root, "--workers", "2", "--host", "127.0.0.1", "--port", str(port),
         "--worker-base-port", str(_consecutive_free_ports(2)), "--probe-interval", "0.5",
         "--device", "cpu"],
        cwd=ROOT, stdout=log, stderr=subprocess.STDOUT,
        env={**os.environ, "PYTHONPATH": str(ROOT),
             "GORDO_LEDGER_DIR": str(tmp_path / "ledger")})
    workers = []
    try:
        end = time.monotonic() + 180
        while time.monotonic() < end:
            assert proc.poll() is None, (tmp_path / "fleet.log").read_text()[-3000:]
            try:
                health = http.get(f"{base}/healthz", timeout=2.0)
                if health.status_code == 200 and health.json()["status"] == "ok":
                    break
            except http.TransportError:
                pass
            time.sleep(0.3)
        else:
            raise AssertionError("the fleet did not come up")
        workers = _children(proc.pid)
        assert len(workers) == 2
        answered = set()
        for name, body in bodies.items():
            reply = http.Session().post(f"{base}/gordo/v0/project/{name}/anomaly/prediction",
                                        body, timeout=60,
                                        headers={"Content-Type": "application/json"})
            assert reply.status_code == 200
            answered.add(reply.headers["X-Gordo-Worker"])
        assert answered <= {"0", "1"}
        # the router maps no torch: only the workers touch the card
        with open(f"/proc/{proc.pid}/maps") as fh:
            assert "libtorch" not in fh.read()
        with open(f"/proc/{workers[0]}/maps") as fh:
            assert "libtorch" in fh.read()
        proc.send_signal(signal.SIGTERM)
        assert proc.wait(timeout=90) == 0
        for pid in workers:
            assert not os.path.exists(f"/proc/{pid}"), f"worker {pid} outlived the router"
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
        for pid in workers:
            try:
                os.kill(pid, signal.SIGKILL)
            except ProcessLookupError:
                pass
        log.close()
