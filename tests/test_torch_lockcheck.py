"""The port's runtime lock-order witness (``analysis/lockcheck.py``) against
the reference's, and the port run under it.

Parity: the same acquisition scripts (nesting, a condition's wait, a
guarded mutation with and without its lock, an inversion, a cycle, an
undeclared name) run through both packages' witness, on lock names both
declare, and leave the same violations, edges and report.

Off by default: with ``GORDO_LOCKCHECK`` unset every factory returns a plain
``threading`` object, and so does every declared lock site of the port;
with it set, each is tracked under its declared name. Every lock in
``LOCK_RANKS`` is created through ``named_lock``/``named_condition`` at
the site ``LOCK_ATTRS`` maps it to, and the port creates no other lock
but the two ``analysis/locks.py`` names as local.

The port under the witness: a child process with ``GORDO_LOCKCHECK=1``
serves, on the CPU, a lazily booted tree under concurrent requests, a
``/prefetch``, a ``/reload`` of a machine rebuilt in place and the control
reads; then a router over two real workers in threads routes requests,
rolls a reload out, applies a fleet spec pinning an older generation and
rolls it back, while the control plane's probe loop runs. The run ends
with no violation, an empty report, and the edges named in ``EDGES`` seen
(so the witness watched the paths, and is not vacuous).
"""

import ast
import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from gordo_components_tpu.analysis import lockcheck as ref_lockcheck  # noqa: E402

from gordo_components_tpu_torch.analysis import lockcheck, locks  # noqa: E402

PORT = ROOT / "gordo_components_tpu_torch"


# -- parity with the reference's witness --------------------------------------------


def _nesting(lc):
    with lc.TrackedLock("server.reload"):
        with lc.TrackedLock("engine.bucket_cond"):
            with lc.TrackedLock("engine.collector"):
                pass


def _condition_wait(lc):
    cond = threading.Condition(lc.TrackedLock("engine.bucket_cond"))
    flag = {"set": False}

    def notifier():
        with lc.TrackedLock("engine.collector"):
            pass  # unrelated higher-rank work on the other thread
        with cond:
            flag["set"] = True
            cond.notify_all()

    thread = threading.Thread(target=notifier, name="parity-notifier")
    with lc.TrackedLock("server.reload"):
        with cond:
            thread.start()
            while not flag["set"]:
                cond.wait(timeout=5.0)
    thread.join(timeout=5.0)


def _guard(lc):
    with lc.TrackedLock("server.reload"):
        with lc.TrackedLock("server.admission"):
            lc.assert_guard("server.admission")
        lc.assert_guard("server.admission")  # not held: a violation


def _inversion(lc):
    with lc.TrackedLock("engine.bucket_cond"):
        with lc.TrackedLock("server.reload"):
            pass


def _cycle(lc):
    _nesting(lc)
    with lc.TrackedLock("engine.collector"):
        with lc.TrackedLock("server.reload"):
            pass


SCRIPTS = {"nesting": _nesting, "condition-wait": _condition_wait, "guard": _guard,
           "inversion": _inversion, "cycle": _cycle}


def _witnessed(lc, script, monkeypatch):
    monkeypatch.setattr(lc, "enabled", True)
    lc.reset()
    try:
        script(lc)
        return lc.violations(), lc.observed_edges(), lc.report()
    finally:
        lc.reset()


@pytest.mark.parametrize("name", sorted(SCRIPTS))
def test_the_witness_sees_what_the_references_sees(name, monkeypatch):
    ours = _witnessed(lockcheck, SCRIPTS[name], monkeypatch)
    theirs = _witnessed(ref_lockcheck, SCRIPTS[name], monkeypatch)
    assert ours == theirs
    violations, edges, report = ours
    assert edges
    if name in ("guard", "inversion", "cycle"):
        assert violations
    if name == "cycle":
        assert report[-1].startswith("cycle in observed lock-acquisition graph")


@pytest.mark.parametrize("lc", [lockcheck, ref_lockcheck], ids=["port", "reference"])
def test_an_undeclared_name_is_refused_alike(lc, monkeypatch):
    monkeypatch.setattr(lc, "enabled", True)
    with pytest.raises(ValueError, match="not declared"):
        lc.TrackedLock("engine.no_such_lock")
    with pytest.raises(ValueError, match="not declared"):
        lc.assert_guard("engine.no_such_lock")


def test_both_packages_declare_the_parity_names():
    from gordo_components_tpu.analysis import locks as ref_locks

    for name in ("server.reload", "server.admission", "engine.bucket_cond",
                 "engine.collector"):
        assert locks.LOCK_RANKS[name] == ref_locks.LOCK_RANKS[name]


# -- off by default; every declared lock through the factories ---------------------------


_SITES = """
import json, threading
from gordo_components_tpu_torch.analysis import lockcheck, locks
from gordo_components_tpu_torch.observability.registry import Registry
from gordo_components_tpu_torch.ops import _kernels
from gordo_components_tpu_torch.compile_cache import store
from gordo_components_tpu_torch.resilience import admission, faults
from gordo_components_tpu_torch.server.host_cache import HostTierCache
from gordo_components_tpu_torch.utils.http import Session

objects = {
    "kernels.launch": _kernels._LAUNCH_LOCK, "kernels.load": _kernels._LOAD_LOCK,
    "compile_cache.private": store._PRIVATE_LOCK, "resilience.faults": faults._lock,
    "observability.registry": Registry()._table_lock,
    "engine.host_cache": HostTierCache(0)._lock,
    "utils.http": Session()._lock,
    "server.admission": admission.AdmissionController(max_inflight=1, max_queue=1)._cond,
}
factories = {name: lockcheck.named_lock(name) for name in locks.LOCK_RANKS}
conditions = {name: lockcheck.named_condition(name) for name in locks.LOCK_RANKS}


def kind(obj):
    inner = obj._lock if type(obj).__name__ == "Condition" else obj
    return (type(obj).__name__, type(inner).__name__, getattr(inner, "_name", None))


print(json.dumps({"enabled": lockcheck.enabled,
                  "objects": {k: kind(v) for k, v in objects.items()},
                  "factories": {k: kind(v) for k, v in factories.items()},
                  "conditions": {k: kind(v) for k, v in conditions.items()}}))
"""


def _sites(knob):
    env = {key: value for key, value in os.environ.items() if key != "GORDO_LOCKCHECK"}
    if knob is not None:
        env["GORDO_LOCKCHECK"] = knob
    result = subprocess.run([sys.executable, "-c", _SITES], cwd=ROOT, capture_output=True,
                            text=True, timeout=120, env={**env, "PYTHONPATH": str(ROOT)})
    assert result.returncode == 0, result.stderr
    return json.loads(result.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("knob", [None, "0", "off"])
def test_off_every_lock_is_a_plain_threading_object(knob):
    out = _sites(knob)
    assert out["enabled"] is False
    plain_lock = type(threading.Lock()).__name__
    plain_condition = ("Condition", type(threading.Condition()._lock).__name__)
    assert {v[0] for v in out["factories"].values()} == {plain_lock}
    assert {tuple(v[:2]) for v in out["conditions"].values()} == {plain_condition}
    for name, (outer, inner, _) in out["objects"].items():
        assert (outer, inner) in ((plain_lock, plain_lock), plain_condition), name


def test_on_every_lock_is_tracked_under_its_declared_name():
    out = _sites("1")
    assert out["enabled"] is True
    for name, (outer, inner, tracked) in out["factories"].items():
        assert (outer, tracked) == ("TrackedLock", name)
    for name, (outer, inner, tracked) in out["conditions"].items():
        assert (outer, inner, tracked) == ("Condition", "TrackedLock", name)
    for name, (outer, inner, tracked) in out["objects"].items():
        assert tracked == name, (name, outer, inner)


def _factory_sites():
    """(file relative to the package, attribute or global name, lock name,
    factory) for every named_lock/named_condition call of the port, and
    every threading lock it creates directly."""
    named, direct = [], []
    for path in sorted(PORT.rglob("*.py")):
        rel = path.relative_to(PORT).as_posix()
        if rel.startswith("analysis/"):
            continue
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Assign) and isinstance(node.value, ast.Call)):
                continue
            func = node.value.func
            target = node.targets[0]
            attr = target.attr if isinstance(target, ast.Attribute) else getattr(
                target, "id", None)
            if isinstance(func, ast.Attribute) and func.attr in ("named_lock",
                                                                 "named_condition"):
                named.append((rel, attr, node.value.args[0].value, func.attr))
            elif isinstance(func, ast.Attribute) and func.attr in ("Lock", "RLock",
                                                                   "Condition"):
                direct.append((rel, attr))
    return named, direct


def test_every_declared_lock_is_made_by_the_factories_at_its_mapped_site():
    named, direct = _factory_sites()
    assert {name for _, _, name, _ in named} == set(locks.LOCK_RANKS)
    for rel, attr, name, _ in named:
        assert locks.LOCK_ATTRS[(rel, attr)] == name, (rel, attr)
    # the two locks analysis/locks.py names as local, and nothing else
    assert sorted(direct) == [("dataset/data_provider/ncs_iroc.py", "_readers_lock"),
                              ("observability/ledger.py", "_configure_lock")]


# -- the port under the witness -----------------------------------------------------------


TAGS = 4
DENSE = ("d0", "d1", "d2", "d3")  # d0, d1 eager under lazy boot; the rest lazy
PINNED = "gm"  # a generation root: gen-0001, gen-0002 (CURRENT)
# edges the scenario must make, read from the code: a reload warms its new
# engine (a bucket's leader latch and program) and drains the old state;
# admission counts its answers; the supervisor boots in-process workers,
# which warm up, under its slot table; the rollout reads the supervisor,
# marks the control plane and posts reloads under its operation lock; the
# reconciler adopts a generation through a rollout and probes the workers;
# a spec commit passes its fault seam under the journal lock
EDGES = (
    ("server.reload", "engine.bucket_cond"),
    ("server.reload", "engine.template"),
    ("server.reload", "server.state_cond"),
    ("server.admission", "observability.series"),
    ("router.workers", "engine.bucket_cond"),
    ("router.op", "router.workers"),
    ("router.op", "watchman.control"),
    ("router.op", "utils.http"),
    ("fleet.reconcile", "router.op"),
    ("fleet.reconcile", "utils.http"),
    ("fleet.spec", "resilience.faults"),
    ("observability.slo", "observability.series"),
)

SCENARIO = r"""
import json
import os
import socket
import sys
import threading
import time

root, out = sys.argv[1], sys.argv[2]
from gordo_components_tpu_torch.analysis import lockcheck

assert lockcheck.enabled, "GORDO_LOCKCHECK was not set before the import"
from gordo_components_tpu_torch.router import WorkerSpec, assemble_fleet, make_router_server
from gordo_components_tpu_torch.server.server import ModelServer, make_server
from gordo_components_tpu_torch.utils import http

body = open(os.path.join(root, "..", "body.json"), "rb").read()
HEADERS = {"Content-Type": "application/json"}
statuses = {}
tally = threading.Lock()


def count(status):
    with tally:
        statuses[str(status)] = statuses.get(str(status), 0) + 1


def in_threads(n, work):
    threads = [threading.Thread(target=work, args=(i,)) for i in range(n)]
    for thread in threads:
        thread.start()
    for thread in threads:
        thread.join()


# -- one server: lazy boot, concurrent requests, /prefetch, /reload, reads
server = ModelServer(root, device="cpu", lazy_boot=True)
machines = ["d0", "d1", "d2", "d3", "gm"]


def client(i):
    for k in range(12):
        name = machines[(i + k) % len(machines)]
        count(server.handle("POST", f"/gordo/v0/project/{name}/anomaly/prediction",
                            HEADERS, body).status)


threads = [threading.Thread(target=client, args=(i,)) for i in range(6)]
for thread in threads:
    thread.start()
count(server.handle("POST", "/prefetch", HEADERS, json.dumps({"machines": ["d3"]}).encode())
      .status)
later = time.time() + 10
for entry in os.scandir(os.path.join(root, "d0")):
    if entry.is_file():
        os.utime(entry.path, (later, later))
reload = json.loads(server.handle("POST", "/reload", HEADERS, b"").body)
for path in ("/slo", "/telemetry", "/autopilot", "/metrics"):
    count(server.handle("GET", path, HEADERS, b"").status)
for thread in threads:
    thread.join()
server.close()


# -- a router over two real workers in threads
def free_port():
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ThreadWorker:
    def __init__(self, spec):
        self.spec = spec
        self.server = None

    def start(self):
        self.server = make_server(root, host=self.spec.host, port=self.spec.port, device="cpu")
        self.thread = threading.Thread(target=self.server.serve_forever, daemon=True)
        self.thread.start()

    pid = None

    def alive(self):
        return self.server is not None

    def terminate(self, grace=5.0):
        if self.server is not None:
            self.server.shutdown()
            self.server.server_close()
            self.thread.join(timeout=5)
            self.server = None

    kill = terminate


specs = [WorkerSpec(f"worker-{i}", i, "127.0.0.1", free_port()) for i in range(2)]
tier = assemble_fleet(specs, ThreadWorker, models_root=root, respawn=False)
tier.supervisor.start_all()
assert len(tier.supervisor.wait_ready(timeout=60)) == 2
front = make_router_server(tier, "127.0.0.1", 0)
threading.Thread(target=front.serve_forever, daemon=True).start()
base = f"http://127.0.0.1:{front.server_address[1]}"
session = http.Session()


def routed(i):
    for k in range(8):
        name = machines[(i + k) % len(machines)]
        count(session.post(f"{base}/gordo/v0/project/{name}/anomaly/prediction", body,
                           headers=HEADERS, timeout=60).status_code)


tier.control.start(interval=0.1)
in_threads(4, routed)
rollout = session.post(f"{base}/reload", b"", timeout=120).json()


def converge():
    end = time.monotonic() + 60
    while time.monotonic() < end:
        count(session.get(f"{base}/metrics", timeout=60).status_code)
        diff = session.get(f"{base}/fleet/diff", timeout=60).json()
        if not diff["divergences"]:
            return True
        time.sleep(0.05)
    return False


def current():
    with open(os.path.join(root, "gm", "CURRENT")) as fh:
        return fh.read().strip()


# pin the older generation, then the newer, then roll back to the older
converged, generations = [], []
for generation in ("gen-0001", "gen-0002", None):
    if generation is None:
        reply = session.post(f"{base}/fleet/rollback", b"", timeout=60)
    else:
        reply = session.post(f"{base}/fleet/apply", json.dumps(
            {"machines": {"gm": {"generation": generation}}}).encode(), timeout=60)
    converged.append(reply.status_code == 200 and converge())
    generations.append(current())
    in_threads(2, routed)
tier.control.stop()
front.shutdown()
front.server_close()
tier.supervisor.stop_all()
tier.close()
session.close()
with open(out, "w") as fh:
    json.dump({
        "violations": lockcheck.violations(), "report": lockcheck.report(),
        "edges": [[a, b, n] for (a, b), n in sorted(lockcheck.observed_edges().items())],
        "statuses": statuses, "reload": reload, "rollout": rollout,
        "converged": converged, "generations": generations,
    }, fh)
"""


@pytest.fixture(scope="module")
def witnessed(tmp_path_factory):
    import chip_smoke

    from gordo_components_tpu_torch.serializer import load, load_metadata, write_artifact_files
    from gordo_components_tpu_torch.store.generations import (
        build_fleet_index,
        commit_generation,
        write_fleet_index,
    )

    base = tmp_path_factory.mktemp("witness")
    root = base / "models"
    cpu = torch.device("cpu")
    kind = ("DenseAutoEncoder", dict(kind="feedforward_hourglass"))
    for i, name in enumerate(DENSE):
        chip_smoke.build_zoo_artifact(str(root / name), *kind, TAGS, cpu,
                                      np.random.default_rng(i))
    for seed in (10, 11):
        flat = base / f"flat-{seed}"
        chip_smoke.build_zoo_artifact(str(flat), *kind, TAGS, cpu, np.random.default_rng(seed))
        model, metadata = load(str(flat), device="cpu"), load_metadata(str(flat))
        commit_generation(str(root / PINNED), lambda staging, m=model, md=metadata:
                          write_artifact_files(m, staging, md))
    write_fleet_index(str(root), build_fleet_index(str(root)))
    rows = np.random.default_rng(5).normal(size=(40, TAGS)).astype(np.float32) * 3 + 5
    (base / "body.json").write_text(json.dumps({"X": rows.tolist()}))
    env = {key: value for key, value in os.environ.items() if not key.startswith("GORDO_")}
    env.update(GORDO_LOCKCHECK="1", GORDO_BOOT_EAGER="2", GORDO_FLEET_INTERVAL="0",
               GORDO_FLEET_COOLDOWN="0.2", GORDO_AUTOPILOT_WORKER_BOUNDS="2:2",
               GORDO_LAYOUT_REDERIVE="0", GORDO_TELEMETRY_INTERVAL="0",
               GORDO_SLO_EVAL_INTERVAL="0", GORDO_AUTOPILOT_INTERVAL="0",
               GORDO_LEDGER_DIR=str(base / "ledger"), PYTHONPATH=str(ROOT))
    out = base / "witness.json"
    result = subprocess.run([sys.executable, "-c", SCENARIO, str(root), str(out)], cwd=ROOT,
                            env=env, capture_output=True, text=True, timeout=120)
    assert result.returncode == 0, result.stderr[-4000:]
    return json.loads(out.read_text())


def test_the_port_runs_clean_under_the_witness(witnessed):
    assert witnessed["violations"] == []
    assert witnessed["report"] == []
    assert set(witnessed["statuses"]) == {"200"}, witnessed["statuses"]


def test_the_scenario_did_what_it_says(witnessed):
    assert witnessed["reload"]["refreshed"] == ["d0"]
    assert witnessed["converged"] == [True, True, True]
    assert witnessed["generations"] == ["gen-0001", "gen-0002", "gen-0001"]


@pytest.mark.parametrize("edge", EDGES, ids=["->".join(e) for e in EDGES])
def test_the_witness_watched_the_paths(witnessed, edge):
    assert list(edge) in [e[:2] for e in witnessed["edges"]], witnessed["edges"]
