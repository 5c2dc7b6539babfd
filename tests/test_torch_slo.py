"""The port's SLO engine against the reference's, on the CPU.

Each package's evaluator reads a private registry of its own package,
holding the series the servers record under the reference's names
(``gordo_server_request_duration_seconds``, ``gordo_server_requests_total``
and ``gordo_tenant_requests_total``). The same seeded observations, made on
one injected clock, give both evaluators equal ``burn_snapshot`` and
``snapshot`` (floats within 1e-12), the same crossing edges, the same
``slo``/``breach`` ledger events and breach-hook calls; ``attribute_stages``
names the same stages over the same recorded timelines; ``GORDO_SLO=0``
answers disabled in both.
"""

import numpy as np
import pytest

from gordo_components_tpu.observability import flightrec as ref_flightrec
from gordo_components_tpu.observability import ledger as ref_ledger
from gordo_components_tpu.observability import registry as ref_registry
from gordo_components_tpu.observability import slo as ref_slo
from gordo_components_tpu.observability import spans as ref_spans
from gordo_components_tpu.resilience import qos as ref_qos

from gordo_components_tpu_torch.observability import flightrec, ledger, registry, slo, spans
from gordo_components_tpu_torch.resilience import qos

ATOL = 1e-12
TENANTS = "ops:interactive;batch:bulk;metered:standard:5:5"
PACKAGES = ((registry, slo, flightrec, ledger, qos),
            (ref_registry, ref_slo, ref_flightrec, ref_ledger, ref_qos))


class FakeClock:
    def __init__(self, now=1000.0):
        self.now = now

    def __call__(self):
        return self.now


def _close(a, b, path="snapshot"):
    if isinstance(a, dict):
        assert set(a) == set(b), (path, sorted(set(a) ^ set(b)))
        for key in a:
            _close(a[key], b[key], f"{path}.{key}")
    elif isinstance(a, (list, tuple)):
        assert len(a) == len(b), path
        for i, (x, y) in enumerate(zip(a, b)):
            _close(x, y, f"{path}[{i}]")
    elif isinstance(a, float) and isinstance(b, float):
        assert abs(a - b) <= ATOL * max(1.0, abs(b)), (path, a, b)
    else:
        assert a == b, (path, a, b)


class _Side:
    """One package's registry with the server's series, a memory ledger,
    a recorder and the server's objectives, on ``clock``."""

    def __init__(self, package, clock, monkeypatch, **kwargs):
        reg_mod, slo_mod, rec_mod, led_mod, qos_mod = package
        self.reg = reg_mod.Registry()
        self.latency = self.reg.histogram("gordo_server_request_duration_seconds", "latency",
                                          labels=("endpoint",))
        self.requests = self.reg.counter("gordo_server_requests_total", "requests",
                                         labels=("endpoint", "status"))
        self.tenants = self.reg.counter("gordo_tenant_requests_total", "tenants",
                                        labels=("tenant", "class", "outcome"))
        self.ledger = led_mod.ControlLedger(wall=clock)
        monkeypatch.setattr(led_mod, "LEDGER", self.ledger)
        self.recorder = rec_mod.FlightRecorder(enabled=True)
        self.crossings = []
        objectives = (slo_mod.server_objectives()
                      + slo_mod.tenant_objectives(qos_mod.parse_tenants(TENANTS)))
        self.evaluator = slo_mod.SLOEvaluator(
            objectives, registry=self.reg, clock=clock, recorder=self.recorder,
            breach_hook=self.crossings.append, **kwargs)


def _sides(clock, monkeypatch, **kwargs):
    kwargs = {"fast_window": 60.0, "slow_window": 600.0, "min_interval": 0.0, **kwargs}
    return [_Side(package, clock, monkeypatch, **kwargs) for package in PACKAGES]


def _observe(sides, rng, n, slow_share, error_share, shed_share):
    for _ in range(n):
        endpoint = rng.choice(["anomaly", "prediction", "metrics"])
        seconds = float(rng.uniform(0.3, 2.0) if rng.random() < slow_share
                        else rng.uniform(0.001, 0.2))
        status = "503" if rng.random() < error_share else "200"
        tenant, klass = [("ops", "interactive"), ("batch", "bulk"),
                         ("metered", "standard")][int(rng.integers(0, 3))]
        outcome = "shed" if rng.random() < shed_share else "ok"
        for side in sides:
            side.latency.labels(endpoint).observe(seconds)
            side.requests.labels(endpoint, status).inc()
            side.tenants.labels(tenant, klass, outcome).inc()


# (requests, slow share, 5xx share, shed share) per step: healthy, a burn,
# recovery, a second burn: each crossing is an edge, not a level
SCRIPT = [(200, 0.0, 0.0, 0.0)] * 3 + [(200, 0.4, 0.05, 0.2)] * 4 + \
    [(300, 0.0, 0.0, 0.0)] * 12 + [(200, 0.6, 0.1, 0.3)] * 3


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_burn_rates_and_crossings_match_the_reference(monkeypatch, seed):
    clock = FakeClock()
    sides = _sides(clock, monkeypatch)
    rng = np.random.default_rng(seed)
    all_crossings = [[], []]
    for n, slow, error, shed in SCRIPT:
        _observe(sides, rng, n, slow, error, shed)
        clock.now += 10.0
        for side, into in zip(sides, all_crossings):
            into.append(side.evaluator.tick()["crossings"])
        _close(sides[0].evaluator.burn_snapshot(), sides[1].evaluator.burn_snapshot())
    assert all_crossings[0] == all_crossings[1]
    edges = [c for step in all_crossings[0] for c in step]
    fast = [c for c in edges if c["objective"] == "scoring-latency" and c["window"] == "fast"]
    assert len(fast) == 2  # two burns, two edges
    ours, ref = (side.evaluator.snapshot() for side in sides)
    _close(ours, ref)
    assert ours["attribution"] == {"scoring-latency": {"violations": 0, "dominant_stage": None,
                                                       "stages": {}}}
    # one breach event and one hook call per edge, alike in both
    events = [[(e["actor"], e["action"], e["target"], e["after"], e["reason"])
               for e in side.ledger.recent()] for side in sides]
    assert events[0] == events[1]
    assert [e[:2] for e in events[0]] == [("slo", "breach")] * len(edges)
    assert sides[0].crossings == sides[1].crossings == edges
    # the crossings reach the recorder as errored timelines
    assert len(sides[0].recorder.summaries()["errors"]) == len(edges)


def test_a_raising_breach_hook_does_not_break_the_tick(monkeypatch):
    clock = FakeClock()
    sides = _sides(clock, monkeypatch)

    def broken(crossing):
        raise RuntimeError("correlator down")

    rng = np.random.default_rng(3)
    for side in sides:
        side.evaluator.breach_hook = broken
    _observe(sides, rng, 200, 1.0, 0.0, 0.0)
    clock.now += 10.0
    results = [side.evaluator.tick() for side in sides]
    assert results[0] == results[1] and results[0]["crossings"]
    assert len(sides[0].ledger.recent()) == len(results[0]["crossings"])


def test_maybe_tick_honours_the_interval_as_the_reference(monkeypatch):
    clock = FakeClock()
    sides = _sides(clock, monkeypatch, min_interval=10.0)
    for step in (0.0, 5.0, 5.0, 3.0, 20.0):
        clock.now += step
        assert sides[0].evaluator.maybe_tick() == sides[1].evaluator.maybe_tick()
    assert sides[0].evaluator.ticks == sides[1].evaluator.ticks == 3


@pytest.mark.parametrize("threshold_ms", ["100", "250", "260", "99999"])
def test_effective_threshold_and_knobs_match_the_reference(monkeypatch, threshold_ms):
    monkeypatch.setenv("GORDO_SLO_LATENCY_MS", threshold_ms)
    clock = FakeClock()
    sides = _sides(clock, monkeypatch)
    for side, module in zip(sides, (slo, ref_slo)):
        side.latency.labels("anomaly").observe(0.01)
    objective = [s.evaluator.objectives[0] for s in sides]
    assert sides[0].evaluator.effective_threshold(objective[0]) == \
        sides[1].evaluator.effective_threshold(objective[1])
    assert slo.knob_summary() == ref_slo.knob_summary()
    assert slo.latency_knobs() == ref_slo.latency_knobs()


def test_objectives_match_the_reference():
    def shape(objectives):
        return [(o.name, o.kind, o.metric, o.target, o.threshold_s, o.description,
                 sorted((o.label_filter or {}).keys()), sorted((o.bad_filter or {}).keys()))
                for o in objectives]

    specs = qos.parse_tenants(TENANTS)
    assert shape(slo.server_objectives()) == shape(ref_slo.server_objectives())
    assert shape(slo.tenant_objectives(specs)) == \
        shape(ref_slo.tenant_objectives(ref_qos.parse_tenants(TENANTS)))
    assert shape(slo.router_objectives()) == shape(ref_slo.router_objectives())


def _timelines(spans_mod, rng):
    """Recorded requests: stage spans and a duration each, some over the
    threshold, some on another endpoint, one without stages."""
    rows = []
    for i in range(30):
        endpoint = "anomaly" if i % 4 else "reload"
        duration = float(rng.uniform(0.05, 0.9))
        stages = {"queue_wait": float(rng.uniform(0, 0.1)),
                  "device_execute": float(rng.uniform(0, 0.4)),
                  "fetch": float(rng.uniform(0, 0.3)), "score": duration}
        if i == 7:
            stages = {}
        rows.append((f"t-{i:03d}", endpoint, duration, stages))
    return rows


@pytest.mark.parametrize("seed", [0, 1])
def test_attribute_stages_matches_the_reference(seed):
    objective = {}
    recorders = []
    for spans_mod, rec_mod, slo_mod in ((spans, flightrec, slo),
                                        (ref_spans, ref_flightrec, ref_slo)):
        recorder = rec_mod.FlightRecorder(enabled=True)
        for trace_id, endpoint, duration, stages in _timelines(spans_mod,
                                                               np.random.default_rng(seed)):
            timeline = spans_mod.Timeline(trace_id, endpoint=endpoint)
            start = 0.0
            for name, seconds in stages.items():
                timeline.add_span_at(name, 0.0 if name == "score" else start, seconds)
                start += 0.0 if name == "score" else seconds
            timeline.finish(status="200")
            timeline.finished = timeline.started + duration
            recorder.record(timeline)
        recorders.append(recorder)
        objective[slo_mod] = slo_mod.server_objectives()[0]
    ours = slo.attribute_stages(recorders[0], objective[slo])
    ref = ref_slo.attribute_stages(recorders[1], objective[ref_slo])
    assert ours == ref
    assert ours["violations"] > 0 and "score" not in ours["stages"]
    assert ours["dominant_stage"] in ("device_execute", "fetch", "queue_wait")


@pytest.mark.parametrize("value,expected", [("0", False), ("off", False), ("1", True),
                                            ("", True), ("no", False)])
def test_slo_knob_answers_as_the_reference(monkeypatch, value, expected):
    monkeypatch.setenv("GORDO_SLO", value)
    assert slo.enabled() is ref_slo.enabled() is expected
