"""The port's declarative fleet control end to end, on the CPU.

- The slice: the port's router with a ``models_root`` over two port
  worker processes (``run-server --device cpu``) serving a small PatchTST
  (2 layers, narrow widths) with two generations and two dense machines,
  all fitted and committed by the reference. A spec pinning the older
  generation is applied with ``cli fleet apply``: the reconciler pins
  ``CURRENT``, the workers adopt it canary first, and the routed answer
  is within ``SERVE_RTOL`` of the reference's scoring of that
  generation's artifact (its flash attention in interpret mode, as the
  reference's tests run it). Then skewed traffic, ``cli layout plan``,
  ``explain`` and ``apply``: the plan's fingerprint lands on both workers'
  ``/healthz`` and ``/layout``, its weights on the router's ring; ``cli
  fleet rollback`` clears both. ``cli fleet status`` and ``diff`` answer
  throughout, and ``GORDO_FLEET=0`` gives the disabled snapshot.
- ``/layout`` on one server: the port's ``GET``, ``POST`` and ``POST
  {"clear": true}`` answers equal the reference server's over copies of
  one fully resident models root, its bad requests too, and the plan's
  resident set survives a reload.
"""

import contextlib
import io
import json
import os
import shutil
import socket
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from werkzeug.test import Client  # noqa: E402

from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.serializer import load as ref_load  # noqa: E402
from gordo_components_tpu.serializer.persistence import write_artifact_files as ref_write  # noqa: E402
from gordo_components_tpu.server import build_app  # noqa: E402
from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402
from gordo_components_tpu.store.generations import commit_generation as ref_commit  # noqa: E402
from gordo_components_tpu_torch import router, wire  # noqa: E402
from gordo_components_tpu_torch.cli import cli  # noqa: E402
from gordo_components_tpu_torch.layout import validate_layout_plan  # noqa: E402
from gordo_components_tpu_torch.observability import ledger  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402
from gordo_components_tpu_torch.utils import http  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
import test_torch_server_seams as dense  # noqa: E402
import test_torch_serving as patchtst  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
SERVE_RTOL = 1e-4
PT = "pt-gens"  # a generation root: gen-0001 and gen-0002 of other fits
HOT, COLD = "dn-a", "dn-b"
LAYERS = 2
pytestmark = pytest.mark.usefixtures("thread_hygiene")
ENV = {
    "GORDO_FLEET_INTERVAL": "0",
    "GORDO_FLEET_COOLDOWN": "0.2",
    "GORDO_TELEMETRY_INTERVAL": "0",
    # the autopilot's envelope and the spec's default bounds agree on the
    # two workers this fleet has: no bounds or scaling repair interferes
    "GORDO_AUTOPILOT_WORKER_BOUNDS": "2:2",
    # the rates move while the test runs: a committed plan stays as applied
    # (test_torch_fleet_spec holds the re-derive)
    "GORDO_LAYOUT_REDERIVE": "0",
}


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _fit_patchtst(X):
    """The serving tests' small detector at LAYERS layers."""
    import gordo_components_tpu.serializer as ref_serializer

    config = patchtst._config()
    est = (config["DiffBasedAnomalyDetector"]["base_estimator"]["TransformedTargetRegressor"]
           ["regressor"]["Pipeline"]["steps"][1]["PatchTSTAutoEncoder"])
    est["n_layers"] = LAYERS
    model = ref_serializer.from_definition(config)
    model.fit(X, X)
    pred = model.predict(X)
    residual = np.abs(X[len(X) - len(pred):] - pred)
    model.scaler.fit(residual)
    scaled = model.scaler.transform(residual)
    model.tag_thresholds_ = np.percentile(scaled, 99, axis=0).astype(np.float32)
    model.total_threshold_ = float(np.percentile(np.linalg.norm(scaled, axis=1), 99))
    return model


@pytest.fixture(scope="module")
def control_root(tmp_path_factory):
    """(models root, {machine: request rows}): ``PT`` with two generations
    (CURRENT on the newer), and the two dense machines, all written by the
    reference."""
    root = tmp_path_factory.mktemp("fleet-control") / "models"
    rng = np.random.default_rng(11)
    metadata = {"dataset": {"tag_list": patchtst.TAGS}}
    for seed in (0, 1):
        X = (rng.normal(size=(72, len(patchtst.TAGS))) * 3 + 5 + seed).astype(np.float32)
        model = _fit_patchtst(X)
        ref_commit(str(root / PT), lambda staging, m=model: ref_write(m, staging, metadata))
    for i, name in enumerate((HOT, COLD)):
        ref_dump(dense._fit(i), str(root / name), metadata={"dataset": {"tag_list": dense.TAGS}})
    rows = {PT: (rng.normal(size=(patchtst.LOOKBACK + 5, len(patchtst.TAGS))) * 3 + 5
                 ).astype(np.float32)}
    return str(root), rows


@pytest.fixture
def quiet_ledger(monkeypatch):
    monkeypatch.delenv("GORDO_LEDGER_DIR", raising=False)
    monkeypatch.delenv("GORDO_TELEMETRY_DIR", raising=False)
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    yield
    ledger.LEDGER.close()


def _cli(*argv) -> tuple:
    """One CLI command in this process: (exit code, stdout)."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = cli.main(list(argv))
    return code, out.getvalue()


def _converge(base: str, timeout: float = 120.0) -> dict:
    """Scrape the router's /metrics (each scrape ticks the reconciler)
    until a fresh diff is empty; returns that diff."""
    end = time.monotonic() + timeout
    while time.monotonic() < end:
        assert http.get(f"{base}/metrics", timeout=120).status_code == 200
        diff = http.get(f"{base}/fleet/diff", timeout=30).json()
        if not diff["divergences"]:
            return diff
        time.sleep(0.1)
    raise AssertionError(f"the fleet did not converge: {diff}")


def _post(url: str, body: bytes) -> http.Reply:
    return http.Session().post(url, body, timeout=120,
                               headers={"Content-Type": "application/json"})


def test_spec_pins_a_generation_and_a_plan_lands_then_rolls_back(
        control_root, tmp_path, monkeypatch, quiet_ledger):
    src, rows = control_root
    root = str(tmp_path / "models")
    shutil.copytree(src, root)
    for key, value in ENV.items():
        monkeypatch.setenv(key, value)
    env = {**os.environ, "PYTHONPATH": str(ROOT), "GORDO_LEDGER_DIR": str(tmp_path / "ledger")}
    specs = [router.WorkerSpec(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(2)]
    logs = []

    def factory(spec):
        log = open(tmp_path / f"{spec.name}.log", "ab")
        logs.append(log)
        return router.SubprocessWorker(
            spec, router.server_worker_argv(spec, root, device="cpu"), env=env, stdout=log,
            stderr=log)

    tier = router.assemble_fleet(specs, factory, models_root=root, respawn=False)
    tier.supervisor.start_all()
    server = None
    try:
        assert len(tier.supervisor.wait_ready(timeout=180)) == 2
        server = router.make_router_server(tier, "127.0.0.1", 0)
        threading.Thread(target=server.serve_forever, daemon=True).start()
        base = f"http://127.0.0.1:{server.server_address[1]}"
        assert tier.fleet is not None

        # no spec yet: enabled, revision 0, an empty diff
        code, out = _cli("fleet", "status", "--base-url", base)
        status = json.loads(out)
        assert code == 0 and status["enabled"] and status["revision"] == 0
        assert json.loads(_cli("fleet", "diff", "--base-url", base)[1])["divergences"] == []

        # a spec pinning the older generation
        spec_file = tmp_path / "spec.json"
        spec_file.write_text(json.dumps({"machines": {PT: {"generation": "gen-0001"}}}))
        code, out = _cli("fleet", "apply", str(spec_file), "--base-url", base)
        assert code == 0 and json.loads(out)["record"]["revision"] == 1
        _converge(base)
        with open(os.path.join(root, PT, "CURRENT")) as fh:
            assert fh.read().strip() == "gen-0001"
        for spec in specs:
            health = http.get(f"{spec.base_url}/healthz", timeout=10).json()
            assert health["store"]["generations"][PT] == "gen-0001"
        repairs = json.loads(_cli("fleet", "status", "--base-url", base)[1])["repairs"]
        steps = [(r["class"], r["target"], r["outcome"]) for r in repairs]
        assert steps == [("generation", PT, "applied"), ("adoption", "worker-0", "applied"),
                         ("adoption", "worker-1", "applied")], steps
        # the routed answer is the reference's scoring of gen-0001
        reply = _post(f"{base}/gordo/v0/project/{PT}/anomaly/prediction",
                      json.dumps({"X": rows[PT].tolist()}).encode())
        assert reply.status_code == 200
        data = reply.json()["data"]
        ref_model = ref_load(os.path.join(root, PT, "gen-0001"))
        scored = RefEngine({PT: ref_model}).anomaly(PT, rows[PT])
        for field, value in zip(wire.SCORE_FIELDS, scored):
            np.testing.assert_allclose(np.asarray(data[field]).reshape(np.shape(value)), value,
                                       rtol=SERVE_RTOL, atol=SERVE_RTOL, err_msg=field)
        newer = RefEngine({PT: ref_load(os.path.join(root, PT, "gen-0002"))}).anomaly(
            PT, rows[PT])
        assert not np.allclose(np.asarray(data["model-output"]), newer[1], atol=SERVE_RTOL)

        # skewed traffic, then a plan compiled, explained and applied
        for _ in range(24):
            assert _post(f"{base}/gordo/v0/project/{HOT}/anomaly/prediction",
                         dense.BODY).status_code == 200
        for _ in range(2):
            assert _post(f"{base}/gordo/v0/project/{PT}/anomaly/prediction",
                         json.dumps({"X": rows[PT].tolist()}).encode()).status_code == 200
        plan_file = tmp_path / "plan.json"
        code, out = _cli("layout", "plan", "--base-url", base, "--window", "1m", "--cap", "1",
                         "--parity-budget", "0", "-o", str(plan_file))
        assert code == 0 and out.strip() == str(plan_file)
        plan = json.loads(plan_file.read_text())
        assert validate_layout_plan(plan) == [] and plan["precision"] == {}
        assert plan["source"]["rates"][HOT] > plan["source"]["rates"].get(PT, 0.0) > 0.0
        code, out = _cli("layout", "explain", str(plan_file))
        assert code == 0 and out.startswith(f"layout plan {plan['fingerprint']}")
        code, out = _cli("layout", "apply", str(plan_file), "--base-url", base)
        assert code == 0 and json.loads(out)["record"]["revision"] == 2
        code, out = _cli("layout", "explain", "--base-url", base)
        assert code == 0 and plan["fingerprint"] in out
        _converge(base)
        for spec in specs:
            assert http.get(f"{spec.base_url}/healthz", timeout=10).json()["layout"] == \
                plan["fingerprint"]
            applied = http.get(f"{spec.base_url}/layout", timeout=10).json()
            assert applied["fingerprint"] == plan["fingerprint"]
            assert applied["resident"] == plan["residency"]["workers"][spec.name]["resident"]
            assert applied["cap"] == 1
        assert {w: round(v, 6) for w, v in tier.placement.worker_weights().items()} == \
            {w: round(v, 6) for w, v in plan["weights"].items() if v != 1.0}

        # rollback: revision 3 re-applies revision 1, the plan clears
        code, out = _cli("fleet", "rollback", "--base-url", base)
        record = json.loads(out)["record"]
        assert code == 0 and (record["revision"], record["reverted_to"]) == (3, 1)
        _converge(base)
        for spec in specs:
            assert http.get(f"{spec.base_url}/healthz", timeout=10).json()["layout"] is None
            assert http.get(f"{spec.base_url}/layout", timeout=10).json()["fingerprint"] is None
        assert tier.placement.worker_weights() == {}
        with open(os.path.join(root, PT, "CURRENT")) as fh:
            assert fh.read().strip() == "gen-0001"
        # the journal on disk is the reference's format: it loads there
        from gordo_components_tpu.fleet.spec import SpecStore as RefSpecStore

        assert [r["op"] for r in RefSpecStore(root).history()] == ["apply", "apply", "rollback"]
        # a bad spec is refused loudly, and commits nothing
        spec_file.write_text(json.dumps({"machines": {"ghost": {}}}))
        assert _cli("fleet", "apply", str(spec_file), "--base-url", base)[0] == 1
        assert http.get(f"{base}/fleet", timeout=30).json()["revision"] == 3
    finally:
        if server is not None:
            server.shutdown()
            server.server_close()
        tier.supervisor.stop_all()
        tier.close()
        for log in logs:
            log.close()


def test_hard_off_builds_no_reconciler(control_root, tmp_path, monkeypatch, quiet_ledger):
    monkeypatch.setenv("GORDO_FLEET", "0")
    specs = [router.WorkerSpec("worker-0", 0, "127.0.0.1", _free_port())]
    tier = router.assemble_fleet(specs, lambda spec: None, models_root=str(tmp_path),
                                 respawn=False)
    try:
        assert tier.fleet is None
        body = json.loads(tier.handle("GET", "/fleet", {}, b"").body)
        assert body == {"enabled": False, "hard_off": True,
                        "reason": "GORDO_FLEET=0 (hard kill switch; restart without it to "
                                  "construct the reconciler)"}
        assert tier.handle("POST", "/fleet/apply", {}, b"{}").status == 409
    finally:
        tier.close()


# -- /layout on one server, against the reference ---------------------------------

def _ask_ours(server, method, path, body=b""):
    r = server.handle(method, path, {"Content-Type": "application/json"}, body)
    return r.status, json.loads(r.body)


def _ask_theirs(client, method, path, body=b""):
    r = client.open(path, method=method, data=body,
                    headers={"Content-Type": "application/json"})
    return r.status_code, json.loads(r.get_data())


LAYOUT_CASES = [
    ("GET", b""),
    ("POST", json.dumps({"fingerprint": "f00d", "resident": [HOT, "ghost", HOT],
                         "cap": 4, "prefetch": [COLD, "ghost"]}).encode()),
    ("GET", b""),
    ("POST", json.dumps({"fingerprint": "beef", "resident": [COLD]}).encode()),
    ("GET", b""),
    ("POST", json.dumps({"clear": True}).encode()),
    ("GET", b""),
    ("POST", b"{not json"),
    ("POST", json.dumps({"resident": [HOT]}).encode()),
    ("POST", json.dumps({"fingerprint": "f00d", "resident": HOT}).encode()),
]


def test_layout_route_answers_as_the_reference(control_root, tmp_path, quiet_ledger,
                                               monkeypatch):
    src = control_root[0]
    roots = {}
    for label in ("ours", "ref"):
        roots[label] = str(tmp_path / label)
        shutil.copytree(src, roots[label])
    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ledger-ours"))
    ours = ModelServer(roots["ours"], device="cpu")
    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ledger-ref"))
    app = build_app({n: os.path.join(roots["ref"], n) for n in sorted(os.listdir(roots["ref"]))
                     if not n.startswith(".")}, project="project", models_root=roots["ref"])
    app._pinned = {}  # as the port: every machine comes from the scan
    theirs = Client(app)
    try:
        for method, body in LAYOUT_CASES:
            got = _ask_ours(ours, method, "/layout", body)
            want = _ask_theirs(theirs, method, "/layout", body)
            assert got[0] == want[0], (method, body, got, want)
            if got[0] == 200:
                assert got[1] == want[1], (method, body)
            else:
                assert got[1]["error"] == want[1]["error"]
        # /healthz names the applied plan, and a reload keeps its pins
        ours.handle("POST", "/layout", {}, json.dumps(
            {"fingerprint": "cafe", "resident": [HOT]}).encode())
        assert json.loads(ours.handle("GET", "/healthz", {}, b"").body)["layout"] == "cafe"
        assert ours.incidents.layout_fingerprint() == "cafe"
        shutil.rmtree(os.path.join(roots["ours"], COLD))
        assert json.loads(ours.handle("POST", "/reload", {}, b"").body)["removed"] == [COLD]
        assert ours.engine.residency_pins == (HOT,)
        assert _ask_ours(ours, "GET", "/layout")[1]["fingerprint"] == "cafe"
        events = [(e["actor"], e["action"]) for e in ledger.LEDGER.recent()
                  if e["actor"] == "layout"]
        assert events == [("layout", "apply-plan"), ("layout", "apply-plan"),
                          ("layout", "clear-plan"), ("layout", "apply-plan")]
    finally:
        ours.close()
        app.engine.close()
