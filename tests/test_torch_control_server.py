"""The control loops' routes of the port's server against the reference's,
on the CPU.

Dense anomaly detectors fitted and dumped by the JAX package are served by
the reference's WSGI app (werkzeug's test ``Client``) and by the port's
``ModelServer.handle`` (``device="cpu"``), each with its own ledger and
telemetry directory, and asked the same request sequence. The request
series both SLO evaluators read start empty in both packages. Then
``/slo``, ``/autopilot`` (GET, and POST enable/disable, 409 under
``GORDO_AUTOPILOT=0``), ``/telemetry`` (and ``?view=export``),
``/incidents`` and ``/incidents/<id>`` must give the same status codes and
keys, and ``/slo`` the same objective names and attainment; a ``/metrics``
scrape ticks the SLO evaluator, the autopilot and the warehouse; a breach
under an ``engine-dispatch`` latency fault opens an incident naming the
fault plan first. Last, the CLI's ``slo``, ``autopilot``, ``telemetry`` and
``incidents`` verbs against a running port server.
"""

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from werkzeug.test import Client  # noqa: E402

from gordo_components_tpu.observability import flightrec as ref_flightrec  # noqa: E402
from gordo_components_tpu.observability import ledger as ref_ledger  # noqa: E402
from gordo_components_tpu.observability import telemetry as ref_telemetry  # noqa: E402
from gordo_components_tpu.observability import traffic as ref_traffic  # noqa: E402
from gordo_components_tpu.resilience import faults as ref_faults  # noqa: E402
from gordo_components_tpu.resilience import qos as ref_qos  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.server import build_app  # noqa: E402
from gordo_components_tpu.server import server as ref_server_mod  # noqa: E402

from gordo_components_tpu_torch.observability import flightrec, ledger, telemetry, traffic  # noqa: E402,E501
from gordo_components_tpu_torch.resilience import faults, qos  # noqa: E402
from gordo_components_tpu_torch.server import server as server_mod  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer, make_server  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_server_seams import BODY, NAMES, TAGS, _fit  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
_M = "/gordo/v0/project"
ROUTES = ("/slo", "/autopilot", "/telemetry", "/telemetry?view=export&window=600",
          "/incidents", "/incidents?view=ledger&limit=5", "/incidents/no-such-id")


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("control") / "models"
    for seed, name in enumerate(NAMES):
        ref_dump(_fit(seed), str(root / name), metadata={"dataset": {"tag_list": TAGS}})
    return str(root)


def _empty_series(monkeypatch):
    """The request series the evaluators read, and the traffic sketches,
    start empty in both packages (they are process-wide)."""
    for module in (server_mod, ref_server_mod):
        monkeypatch.setattr(module._M_REQUEST_SECONDS, "_series", {})
        monkeypatch.setattr(module._M_REQUESTS, "_values", {})
    for module in (qos, ref_qos):
        monkeypatch.setattr(module._M_TENANT, "_values", {})
    for module in (traffic, ref_traffic):
        monkeypatch.setattr(module, "ACCOUNTANT", module.TrafficAccountant())


@pytest.fixture
def clean_process_state(monkeypatch):
    for key in ("GORDO_TENANTS", "GORDO_FAULTS", "GORDO_AUTOPILOT", "GORDO_SLO",
                "GORDO_TELEMETRY"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GORDO_SLO_EVAL_INTERVAL", "0")
    monkeypatch.setenv("GORDO_AUTOPILOT_INTERVAL", "0")
    monkeypatch.setenv("GORDO_TELEMETRY_INTERVAL", "0")
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    monkeypatch.setattr(ref_ledger, "LEDGER", ref_ledger.ControlLedger())
    _empty_series(monkeypatch)
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


def _servers(root, tmp_path, monkeypatch):
    """(port server, reference client, reference app), each with its own
    ledger and telemetry directories."""
    for side in ("port", "ref"):
        monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / side / "ledger"))
        monkeypatch.setenv("GORDO_TELEMETRY_DIR", str(tmp_path / side / "telemetry"))
        if side == "port":
            ours = ModelServer(root, device="cpu")
        else:
            app = build_app({n: os.path.join(root, n) for n in NAMES}, project="project",
                            models_root=root)
            app._pinned = {}
    return ours, Client(app), app


def _get(ours, client, path, method="GET", body=b""):
    mine = ours.handle(method, path, {"Content-Type": "application/json"}, body)
    if method == "GET":
        theirs = client.get(path)
    else:
        theirs = client.post(path, data=body, content_type="application/json")
    return (mine.status, json.loads(mine.body)), (theirs.status_code, theirs.get_json())


def _traffic(ours, client, n=12):
    for i in range(n):
        path = f"{_M}/{NAMES[i % len(NAMES)]}/anomaly/prediction"
        (s1, _), (s2, _) = _get(ours, client, path, "POST", BODY)
        assert s1 == s2 == 200


def _keys(value, depth=2):
    if not isinstance(value, dict) or depth == 0:
        return type(value).__name__
    return {key: _keys(v, depth - 1) for key, v in value.items()}


def test_control_routes_answer_as_the_reference(models_root, tmp_path, monkeypatch,
                                                clean_process_state):
    # a latency objective no request misses, so attainment is not a matter
    # of this host's timing (the reference compiles at its first request)
    monkeypatch.setenv("GORDO_SLO_LATENCY_MS", "60000")
    ours, client, app = _servers(models_root, tmp_path, monkeypatch)
    try:
        _traffic(ours, client)
        for path in ROUTES:
            (s1, mine), (s2, theirs) = _get(ours, client, path)
            assert s1 == s2, path
            assert set(mine) == set(theirs), (path, set(mine) ^ set(theirs))
        (_, slo_ours), (_, slo_ref) = _get(ours, client, "/slo")
        assert [(o["name"], o["attainment"], o["good"], o["total"], o["target"])
                for o in slo_ours["objectives"]] == \
            [(o["name"], o["attainment"], o["good"], o["total"], o["target"])
             for o in slo_ref["objectives"]]
        assert slo_ours["objectives"][0]["attainment"] == 1.0
        assert slo_ours["objectives"][0]["total"] == 12
        assert _keys(slo_ours["objectives"][0]) == _keys(slo_ref["objectives"][0])
        (_, pilot_ours), (_, pilot_ref) = _get(ours, client, "/autopilot")
        assert sorted(pilot_ours["actuators"]) == sorted(pilot_ref["actuators"])
        assert pilot_ours["enabled"] is pilot_ref["enabled"] is False  # built frozen
        for action, enabled in (("enable", True), ("disable", False)):
            (s1, mine), (s2, theirs) = _get(ours, client, f"/autopilot/{action}", "POST")
            assert s1 == s2 == 200 and mine["enabled"] is theirs["enabled"] is enabled
        (s1, _), (s2, _) = _get(ours, client, "/autopilot/reboot", "POST")
        assert s1 == s2 == 404
        (_, tel_ours), (_, tel_ref) = _get(ours, client, "/telemetry")
        # the families differ with what each package records; the shape and
        # the request series both record do not
        assert set(tel_ours["window"]) == set(tel_ref["window"])
        for family in ("gordo_server_request_duration_seconds",):
            assert set(tel_ours["window"]["histograms"][family]) == \
                set(tel_ref["window"]["histograms"][family])
        assert set(tel_ours["window"]["rates"]["gordo_server_requests_total"]["series"]) == \
            set(tel_ref["window"]["rates"]["gordo_server_requests_total"]["series"])
        assert set(tel_ours["warehouse"]) == set(tel_ref["warehouse"])
        assert set(tel_ours["costs"]["engine"]) == set(tel_ref["costs"]["engine"])
        # the same machines counted alike (the reference's warm-up notes too)
        assert [(m["machine"], m["count"]) for m in tel_ours["traffic"]["machines"]] == \
            [(m["machine"], m["count"]) for m in tel_ref["traffic"]["machines"]]
        (_, export_ours), (_, export_ref) = _get(ours, client, "/telemetry?view=export")
        assert telemetry.validate_layout_input(export_ours) == []
        assert ref_telemetry.validate_layout_input(export_ours) == []
        assert set(export_ours["rungs"]["f32"]) == set(export_ref["rungs"]["f32"])
        assert export_ours["rungs"]["f32"]["device_bytes"] == \
            ours.engine.cost_ledger()["rungs"]["f32"]["device_bytes"] > 0
    finally:
        ours.close()
        app.engine.close()


def test_the_hard_kill_switch_answers_as_the_reference(models_root, tmp_path, monkeypatch,
                                                       clean_process_state):
    monkeypatch.setenv("GORDO_AUTOPILOT", "0")
    ours, client, app = _servers(models_root, tmp_path, monkeypatch)
    try:
        assert ours.autopilot is None
        (s1, mine), (s2, theirs) = _get(ours, client, "/autopilot")
        assert s1 == s2 == 200 and mine == theirs and mine["hard_off"] is True
        for action in ("enable", "disable"):
            (s1, mine), (s2, theirs) = _get(ours, client, f"/autopilot/{action}", "POST")
            assert s1 == s2 == 409 and mine == theirs
    finally:
        ours.close()
        app.engine.close()


@pytest.mark.parametrize("knob,path", [("GORDO_SLO", "/slo"), ("GORDO_TELEMETRY", "/telemetry")])
def test_loops_switched_off_answer_disabled(models_root, tmp_path, monkeypatch,
                                            clean_process_state, knob, path):
    monkeypatch.setenv(knob, "0")
    ours, client, app = _servers(models_root, tmp_path, monkeypatch)
    try:
        (s1, mine), (s2, theirs) = _get(ours, client, path)
        assert s1 == s2 == 200 and mine == theirs == {"enabled": False}
        (s1, _), (s2, _) = _get(ours, client, "/incidents")
        assert s1 == s2 == 200
    finally:
        ours.close()
        app.engine.close()


def test_a_metrics_scrape_ticks_the_loops(models_root, tmp_path, monkeypatch,
                                          clean_process_state):
    monkeypatch.setenv("GORDO_AUTOPILOT", "1")
    ours, client, app = _servers(models_root, tmp_path, monkeypatch)
    app.engine.close()
    try:
        _traffic_port = [ours.handle("POST", f"{_M}/{NAMES[0]}/anomaly/prediction", {}, BODY)
                         for _ in range(3)]
        assert all(r.status == 200 for r in _traffic_port)
        before = (ours.slo.ticks, ours.autopilot.ticks, ours.telemetry.ticks)
        for query in ("", "?format=prometheus"):
            assert ours.handle("GET", "/metrics" + query, {}, b"").status == 200
        after = (ours.slo.ticks, ours.autopilot.ticks, ours.telemetry.ticks)
        assert [b - a for a, b in zip(before, after)] == [2, 2, 2]
        text = ours.handle("GET", "/metrics?format=prometheus", {}, b"").body.decode()
        for series in ("gordo_slo_burn_rate", "gordo_autopilot_enabled",
                       "gordo_telemetry_ticks_total"):
            assert series in text
        # scrapes of the control routes stay out of the flight recorder
        recorded = {row.get("endpoint") for row in flightrec.RECORDER.summaries()["requests"]}
        assert recorded == {"anomaly"}
    finally:
        ours.close()


def test_a_breach_opens_an_incident_naming_the_fault_plan(models_root, tmp_path, monkeypatch,
                                                          clean_process_state):
    monkeypatch.setenv("GORDO_SLO_LATENCY_MS", "10")
    monkeypatch.setenv("GORDO_SLO_FAST_WINDOW", "60")
    monkeypatch.setenv("GORDO_AUTOPILOT", "1")
    monkeypatch.setenv("GORDO_AUTOPILOT_CONFIRM", "1")
    monkeypatch.setenv("GORDO_AUTOPILOT_COOLDOWN", "0")
    ours, client, app = _servers(models_root, tmp_path, monkeypatch)
    app.engine.close()
    try:
        faults.configure(f"engine-dispatch:{NAMES[1]}:latency:0.03")
        for i in range(8):
            r = ours.handle("POST", f"{_M}/{NAMES[1]}/anomaly/prediction", {}, BODY)
            assert r.status == 200
        listing = json.loads(ours.handle("GET", "/incidents", {}, b"").body)
        assert listing["incidents"], listing
        incident_id = listing["incidents"][-1]["id"]
        report = json.loads(ours.handle("GET", f"/incidents/{incident_id}", {}, b"").body)
        assert report["trigger"]["objective"] == "scoring-latency"
        top = report["candidates"][0]
        assert (top["actor"], top["action"]) == ("faults", "inject-plan")
        on_disk = tmp_path / "port" / "ledger" / "worker-0" / "incidents" / \
            f"incident-{incident_id}.json"
        assert json.loads(on_disk.read_text()) == report
        slo = json.loads(ours.handle("GET", "/slo", {}, b"").body)
        latency = slo["objectives"][0]
        assert latency["windows"]["fast"]["breaches"] == 1
        assert slo["attribution"]["scoring-latency"]["dominant_stage"] == "dispatch"
        events = json.loads(ours.handle("GET", "/incidents?view=ledger", {}, b"").body)["events"]
        assert ("slo", "breach", "scoring-latency") in {
            (e["actor"], e["action"], e["target"]) for e in events}
        # the autopilot acted on the burn and journaled it in the ledger
        pilot = json.loads(ours.handle("GET", "/autopilot", {}, b"").body)
        assert any(d["direction"] != "hold" for d in pilot["decisions"])
        assert ("autopilot", "decision") in {(e["actor"], e["action"])
                                             for e in ledger.LEDGER.recent()}
    finally:
        faults.clear()
        ours.close()


def _cli(*args):
    return subprocess.run([sys.executable, "-m", "gordo_components_tpu_torch.cli", *args],
                          cwd=ROOT, capture_output=True, text=True, timeout=120,
                          env={**os.environ, "PYTHONPATH": str(ROOT)})


@pytest.fixture(scope="module")
def running_server(models_root, tmp_path_factory):
    """A port server on 127.0.0.1 with an incident on record."""
    tmp = tmp_path_factory.mktemp("control-cli")
    env = {"GORDO_LEDGER_DIR": str(tmp / "ledger"), "GORDO_TELEMETRY_DIR": str(tmp / "tel"),
           "GORDO_TELEMETRY_INTERVAL": "0", "GORDO_SLO_EVAL_INTERVAL": "0"}
    saved = {key: os.environ.get(key) for key in env}
    os.environ.update(env)
    saved_ledger = ledger.LEDGER
    try:
        httpd = make_server(models_root, host="127.0.0.1", port=0, device="cpu")
    finally:
        for key, value in saved.items():
            if value is None:
                os.environ.pop(key)
            else:
                os.environ[key] = value
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    server = httpd.model_server
    for name in NAMES:
        server.handle("POST", f"{_M}/{name}/anomaly/prediction", {}, BODY)
    report = server.incidents.on_breach({"objective": "scoring-latency", "window": "fast",
                                         "burn_rate": 20.0, "threshold": 14.4})
    yield f"http://127.0.0.1:{httpd.server_address[1]}", report["id"], tmp
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=30)
    ledger.LEDGER.close()
    ledger.LEDGER = saved_ledger


@pytest.mark.parametrize("args,check", [
    (["slo"], lambda body: body["objectives"][0]["name"] == "scoring-latency"),
    (["autopilot", "status"], lambda body: body["enabled"] is False),
    (["autopilot", "enable"], lambda body: body["enabled"] is True),
    (["autopilot", "disable"], lambda body: body["enabled"] is False),
    (["telemetry", "traffic"], lambda body: {m["machine"] for m in body["traffic"]["machines"]}
     >= set(NAMES)),
    (["telemetry", "costs", "--window", "60"],
     lambda body: body["costs"]["engine"]["rungs"]["f32"]["machines"] == len(NAMES)),
    (["telemetry", "export", "--window", "10m"],
     lambda body: body["schema"] == "gordo-layout-input/v1" and body["horizon"] == "10m"),
    (["incidents", "list"], lambda body: len(body["incidents"]) == 1),
    (["incidents", "ledger", "--limit", "3"], lambda body: len(body["events"]) <= 3),
])
def test_cli_verbs_against_a_running_server(running_server, args, check):
    base, _, _ = running_server
    result = _cli(*args, "--base-url", base)
    assert result.returncode == 0, result.stderr
    assert check(json.loads(result.stdout))


def test_cli_incidents_show_and_export_to_a_file(running_server):
    base, incident_id, tmp = running_server
    shown = _cli("incidents", "show", incident_id, "--base-url", base)
    assert shown.returncode == 0, shown.stderr
    assert json.loads(shown.stdout)["id"] == incident_id
    missing = _cli("incidents", "show", "no-such-id", "--base-url", base)
    assert missing.returncode == 1 and "404" in missing.stderr
    out = tmp / "layout.json"
    exported = _cli("telemetry", "export", "--base-url", base, "-o", str(out))
    assert exported.returncode == 0 and exported.stdout.strip() == str(out)
    assert ref_telemetry.validate_layout_input(json.loads(out.read_text())) == []
    bad_window = _cli("telemetry", "export", "--base-url", base, "--window", "soon")
    assert bad_window.returncode == 1 and "not a duration" in bad_window.stderr
    unreachable = _cli("slo", "--base-url", "http://127.0.0.1:9")
    assert unreachable.returncode == 1
