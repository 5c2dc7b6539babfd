"""The port's incident correlator against the reference's, on the CPU.

The same seeded control-ledger events, emitted into each package's own
memory ledger on one injected wall clock, give the same
``rank_candidates`` order and the same incident report (apart from its id
and wall times, which both also agree on here), with the same metric
deltas from warehouses fed the same series. Reports are durable (one file
each), a cooldown suppresses a flapping objective, ``keep`` bounds them,
a restart reloads them, and a correlator whose sources raise does not
break the SLO tick.
"""

import json
import os

import numpy as np
import pytest

from gordo_components_tpu.observability import incidents as ref_incidents
from gordo_components_tpu.observability import ledger as ref_ledger
from gordo_components_tpu.observability import registry as ref_registry
from gordo_components_tpu.observability import telemetry as ref_telemetry
from gordo_components_tpu.observability import traffic as ref_traffic

from gordo_components_tpu_torch.observability import (
    incidents,
    ledger,
    registry,
    telemetry,
    traffic,
)

PACKAGES = ((incidents, ledger, registry, telemetry, traffic),
            (ref_incidents, ref_ledger, ref_registry, ref_telemetry, ref_traffic))
ACTIONS = [("faults", "inject-plan", "engine-dispatch:*"), ("autopilot", "decision", "shed"),
           ("autopilot", "decision", "dispatch_depth"), ("quarantine", "quarantine", "m-03"),
           ("breaker", "breaker-open", "scoring"), ("qos", "shed-level", "bulk"),
           ("slo", "breach", "scoring-latency"), ("operator", "unknown-thing", "x"),
           ("quarantine", "recover", "m-03"), ("autopilot", "enable", "server")]
CROSSING = {"objective": "scoring-latency", "window": "fast", "burn_rate": 31.5,
            "threshold": 14.4}


class FakeClock:
    def __init__(self, now=1_700_000_000.0):
        self.now = now

    def __call__(self):
        return self.now


def _events(seed, clock, ledgers, n=40):
    """Seeded events emitted into every ledger at the same wall times."""
    rng = np.random.default_rng(seed)
    for _ in range(n):
        actor, action, target = ACTIONS[int(rng.integers(0, len(ACTIONS)))]
        clock.now += float(rng.uniform(0.5, 60.0))
        reason = ["latency", "scoring burn", "", "operator"][int(rng.integers(0, 4))]
        for led in ledgers:
            led.emit(actor, action, target=target, before=1, after=2, reason=reason)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_rank_candidates_matches_the_reference(seed):
    clock = FakeClock()
    ledgers = [ledger.ControlLedger(wall=clock), ref_ledger.ControlLedger(wall=clock)]
    _events(seed, clock, ledgers)
    events = ledgers[0].recent()
    assert [{k: v for k, v in e.items() if k != "schema"} for e in events] == \
        [{k: v for k, v in e.items() if k != "schema"} for e in ledgers[1].recent()]
    for breach_ts in (clock.now, clock.now + 120.0, clock.now - 300.0):
        ours = incidents.rank_candidates(events, CROSSING, breach_ts)
        assert ours == ref_incidents.rank_candidates(events, CROSSING, breach_ts)
        assert all(c["action"] != "breach" for c in ours)
        assert [c["score"] for c in ours] == sorted((c["score"] for c in ours), reverse=True)


def _side(package, clock, directory, seed, **kwargs):
    inc_mod, led_mod, reg_mod, tel_mod, tra_mod = package
    reg = reg_mod.Registry()
    counter = reg.counter("gordo_t_requests_total", "requests", labels=("status",))
    warehouse = tel_mod.TelemetryWarehouse(
        registry=reg, accountant=tra_mod.TrafficAccountant(clock=clock), clock=clock,
        wall=clock, min_interval=0.0)
    led = led_mod.ControlLedger(wall=clock)
    rng = np.random.default_rng(seed)
    for i in range(20):
        clock.now += 30.0
        # the error rate climbs over the last minutes
        counter.labels("200").inc(float(rng.integers(10, 50)))
        counter.labels("503").inc(float(rng.integers(0, 3) + (8 if i > 16 else 0)))
        warehouse.tick()
        if i % 2:
            _events(seed + i, clock, [led], n=1)
    correlator = inc_mod.IncidentCorrelator(
        ledger=led, directory=directory, warehouse=warehouse, role="worker-0",
        lookback=600.0, cooldown=120.0, keep=3, wall=clock,
        spec_revision=lambda: 7, layout_fingerprint=lambda: "abc")
    return correlator, led


@pytest.mark.parametrize("seed", [0, 1])
def test_reports_match_the_reference(tmp_path, seed):
    start = 1_700_000_000.0
    sides = []
    for package, name in zip(PACKAGES, ("port", "ref")):
        clock = FakeClock(start)
        correlator, led = _side(package, clock, str(tmp_path / name), seed)
        sides.append((correlator, led, clock))
    assert sides[0][2].now == sides[1][2].now
    reports = [correlator.on_breach(dict(CROSSING)) for correlator, _, _ in sides]
    drop = ("id", "ts")
    ours, ref = ({k: v for k, v in r.items() if k not in drop} for r in reports)
    assert ours == ref
    assert reports[0]["schema"] == "gordo-incident/v1"
    assert ours["candidates"] and ours["metric_deltas"]["movers"]
    assert ours["spec_revision"] == 7 and ours["layout"] == "abc"
    # durable: one file per report, which is the report
    path = tmp_path / "port" / f"incident-{reports[0]['id']}.json"
    assert json.loads(path.read_text()) == reports[0]
    assert sides[0][0].list() and sides[0][0].get(reports[0]["id"]) == reports[0]
    summary = {k: v for k, v in sides[0][0].list()[0].items() if k not in drop}
    assert summary == {k: v for k, v in sides[1][0].list()[0].items() if k not in drop}


def test_cooldown_keep_and_reload_match_the_reference(tmp_path):
    outcomes = []
    for package, name in zip(PACKAGES, ("port", "ref")):
        clock = FakeClock()
        correlator, led = _side(package, clock, str(tmp_path / name), 4)
        seen = []
        for step, objective in enumerate(["a", "a", "b", "a", "c", "d", "a"]):
            clock.now += 50.0 if step % 2 else 130.0
            led.emit("faults", "inject-plan", target=f"engine-dispatch:{objective}")
            report = correlator.on_breach({**CROSSING, "objective": objective})
            seen.append(None if report is None else report["n"])
        files = sorted(os.listdir(tmp_path / name))
        snapshot = correlator.snapshot()
        reloaded = package[0].IncidentCorrelator(directory=str(tmp_path / name), keep=3,
                                                 wall=clock)
        outcomes.append((seen, files, snapshot["suppressed"], snapshot["reports"],
                         [r["id"] for r in reloaded.list()]))
    assert outcomes[0] == outcomes[1]
    seen, files, suppressed, retained, reloaded_ids = outcomes[0]
    assert None in seen and suppressed == seen.count(None)
    assert retained == len(files) == len(reloaded_ids) == 3


def test_a_failing_source_gives_no_report_and_never_raises():
    class Broken:
        def recent(self, **kwargs):
            raise OSError("disk gone")

        def window_view(self, *args):
            raise RuntimeError("warehouse gone")

    correlator = incidents.IncidentCorrelator(ledger=Broken(), warehouse=Broken())
    assert correlator.on_breach(dict(CROSSING)) is None
    assert incidents.metric_deltas(Broken(), 600.0) == {}
    assert incidents.metric_deltas(None, 600.0) == {}


@pytest.mark.parametrize("env,value", [("GORDO_INCIDENT_LOOKBACK", "30"),
                                       ("GORDO_INCIDENT_COOLDOWN", "x"),
                                       ("GORDO_INCIDENT_KEEP", "0")])
def test_knobs_match_the_reference(monkeypatch, env, value):
    monkeypatch.setenv(env, value)
    for fn in ("lookback_seconds", "cooldown_seconds", "keep_reports"):
        assert getattr(incidents, fn)() == getattr(ref_incidents, fn)()
