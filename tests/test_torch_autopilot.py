"""The port's autopilot against the reference's, on the CPU.

For every decision rule (dispatch depth, fill window, in-flight bound,
residency, the shed ladder, the worker count), a seeded script of
observations drives both packages' controllers on one injected clock: the
decision journals (less their wall-clock ``at``), the actuator values and
the status views must be equal, through AIMD steps, hard bounds,
hysteresis, cooldowns, the oscillation guard and the runtime kill switch.
Below that: the admission gate's live resize wakes a queued waiter; the
signal reader's extras on a port engine equal the reference's on the same
fleet (the ``megabatch`` keys the fill and residency rules read); the
engine's ``apply_tuning`` scores to the bit as before; a reload keeps the
applied tuning; and the server's controller wires the reference's five
actuators with the same bounds. Last the router's actuator, the elastic
worker count (the reference's cases of ``tests/test_autopilot.py`` over
thread-backed workers): a scale-up adds a slot and then a ring member, a
retire leaves the ring first and never drops the last worker, the
controller drives a scale through ``workers_rule`` (confirm ticks, ±1, the
bounds' ceiling), and the router's controller wires the same actuator as
the reference's (bounds, ``GORDO_AUTOPILOT_SCALE_TICKS``, cooldown).
"""

import json
import os
import shutil
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from gordo_components_tpu.autopilot import controller as ref_controller  # noqa: E402
from gordo_components_tpu.autopilot import policy as ref_policy  # noqa: E402
from gordo_components_tpu.autopilot import signals as ref_signals  # noqa: E402
from gordo_components_tpu.observability import flightrec as ref_flightrec  # noqa: E402
from gordo_components_tpu.observability import ledger as ref_ledger  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.serializer import load as ref_load  # noqa: E402
from gordo_components_tpu.server.engine import ServingEngine as RefEngine  # noqa: E402

from gordo_components_tpu_torch.autopilot import controller, policy, signals  # noqa: E402
from gordo_components_tpu_torch.observability import flightrec, ledger  # noqa: E402
from gordo_components_tpu_torch.resilience.admission import AdmissionController  # noqa: E402
from gordo_components_tpu_torch.serializer import load  # noqa: E402
from gordo_components_tpu_torch.server.engine import ServingEngine  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_server_seams import NAMES, TAGS, X, _fit  # noqa: E402

PACKAGES = ((controller, policy, signals, flightrec), (ref_controller, ref_policy, ref_signals,
                                                       ref_flightrec))
RULES = {  # actuator: (rule, bounds, start value)
    "dispatch_depth": ("depth_rule", (1, 8), 2),
    "fill_window": ("fill_rule", (0, 4000), 250),
    "max_inflight": ("inflight_rule", (8, 256), 64),
    "residency": ("residency_rule", (16, 1024), 64),
    "shed": ("shed_rule", (0, 8), 0),
    "workers": ("workers_rule", (1, 8), 2),
}


class FakeClock:
    def __init__(self, now=0.0):
        self.now = now

    def __call__(self):
        return self.now


class _Scripted:
    def __init__(self, observation):
        self.observation = observation

    def read(self, now=None):
        return self.observation


def _observation_script(seed, n=300):
    """Regimes of 1-5 ticks, each an observation dict that may push any
    rule up, down or nowhere."""
    rng = np.random.default_rng(seed)
    script = []
    while len(script) < n:
        obs = {
            "burn_fast": float(rng.choice([0.0, 0.1, 0.5, 2.0, 20.0])),
            "burn_slow": float(rng.choice([0.0, 0.1, 0.3, 3.0])),
            "device_share": float(rng.choice([0.1, 0.6, 0.9])),
            "queue_share": float(rng.choice([0.0, 0.4, 0.7])),
            "fill_share": float(rng.choice([0.0, 0.2])),
            "sampled_requests": int(rng.choice([0, 3, 20])),
            "inflight_frac": float(rng.choice([0.2, 0.95])),
            "queue_depth": int(rng.choice([0, 0, 4])),
            "rps": float(rng.choice([0.2, 50.0])),
            "extras": {
                "mega_enabled": bool(rng.random() < 0.8),
                "residency_cap": int(rng.choice([32, 64])),
                "resident_machines": int(rng.choice([10, 64])),
                "machines": int(rng.choice([20, 300])),
                "elastic_busy": bool(rng.random() < 0.1),
            },
        }
        script += [obs] * int(rng.integers(1, 6))
    return script[:n]


def _strip_at(value):
    if isinstance(value, dict):
        return {k: _strip_at(v) for k, v in value.items() if k != "at"}
    if isinstance(value, list):
        return [_strip_at(v) for v in value]
    return value


def _run(package, actuator_name, script, clock_step=1.0, kill_at=(150, 170)):
    ctl_mod, pol_mod, sig_mod, rec_mod = package
    rule, (lo, hi), start = RULES[actuator_name]
    value = {"v": start}
    actuator = pol_mod.Actuator(
        name=actuator_name, read=lambda: value["v"], apply=lambda v: value.update(v=v),
        decide=getattr(pol_mod, rule)(pol_mod.Thresholds()), bounds=pol_mod.Bounds(lo, hi),
        aimd=pol_mod.AIMD(step=0.5, backoff=0.5), cooldown=3.0, confirm=2)
    clock = FakeClock()
    reader = _Scripted(sig_mod.Observation())
    pilot = ctl_mod.Autopilot(reader, [actuator], role="test", min_interval=1.0, clock=clock,
                              recorder=rec_mod.FlightRecorder(enabled=True), enabled=True)
    values, applied = [], []
    for i, obs in enumerate(script):
        if i == kill_at[0]:
            pilot.disable("scripted freeze")
        if i == kill_at[1]:
            pilot.enable()
        reader.observation = sig_mod.Observation(**{**obs, "extras": dict(obs["extras"])})
        clock.now += clock_step
        applied.append(_strip_at(pilot.tick()))
        values.append(value["v"])
    return values, applied, _strip_at(pilot.snapshot())


@pytest.mark.parametrize("actuator_name", sorted(RULES))
@pytest.mark.parametrize("seed", [0, 1])
def test_decision_journal_matches_the_reference(monkeypatch, actuator_name, seed):
    for module in (ledger, ref_ledger):
        monkeypatch.setattr(module, "LEDGER", module.ControlLedger())
    script = _observation_script(seed)
    ours, ref = (_run(package, actuator_name, script) for package in PACKAGES)
    assert ours[0] == ref[0]
    assert ours[1] == ref[1]
    assert ours[2] == ref[2]
    lo, hi = RULES[actuator_name][1]
    assert all(lo <= v <= hi for v in ours[0])
    # the freeze: nothing applied between disable and enable
    assert not any(ours[1][150:170])
    journal = ours[2]["decisions"]
    assert journal, "the script moved nothing"
    assert [(e["actor"], e["action"]) for e in ledger.LEDGER.recent()] == \
        [(e["actor"], e["action"]) for e in ref_ledger.LEDGER.recent()]


def test_every_rule_and_guard_is_exercised(monkeypatch):
    """Across the scripts, decisions go up and down, hold on the
    oscillation guard and stop at the bounds."""
    for module in (ledger, ref_ledger):
        monkeypatch.setattr(module, "LEDGER", module.ControlLedger())
    directions, reasons = set(), set()
    for name in RULES:
        for seed in (0, 1):
            _, _, snapshot = _run(PACKAGES[0], name, _observation_script(seed))
            for decision in snapshot["decisions"]:
                directions.add(decision["direction"])
                reasons.add((name, decision["reason"]))
    assert directions == {"up", "down", "hold"}
    assert ("dispatch_depth", "burn_device") in reasons and ("shed", "sustained_burn") in reasons
    assert any(reason == "oscillation_guard" for _, reason in reasons)


@pytest.mark.parametrize("value", [1, 2, 3, 7, 8, 13, 64, 255, 256])
def test_aimd_matches_the_reference(value):
    for step, backoff in ((0.5, 0.5), (0.0, 0.99), (1.0, 0.1)):
        ours, ref = policy.AIMD(step, backoff), ref_policy.AIMD(step, backoff)
        for lo, hi in ((1, 8), (8, 256), (0, 4000)):
            for direction in (policy.UP, policy.HOLD, policy.DOWN):
                assert ours.next_value(value, direction, policy.Bounds(lo, hi)) == \
                    ref.next_value(value, direction, ref_policy.Bounds(lo, hi))


@pytest.mark.parametrize("env", ["", "0", "1", "off", "yes"])
def test_kill_switches_match_the_reference(monkeypatch, env):
    monkeypatch.setenv("GORDO_AUTOPILOT", env)
    assert controller.hard_off() is ref_controller.hard_off()
    assert controller.enabled_at_boot() is ref_controller.enabled_at_boot()
    assert controller.disabled_snapshot() == ref_controller.disabled_snapshot()
    for spec in (None, "2:5", "junk", "9:2"):
        assert policy.parse_bounds(spec, policy.Bounds(1, 8)) == \
            tuple(ref_policy.parse_bounds(spec, ref_policy.Bounds(1, 8)))


def test_set_max_inflight_wakes_a_queued_waiter():
    gate = AdmissionController(max_inflight=1, max_queue=4, queue_timeout=30.0)
    first = gate.admit()
    admitted = threading.Event()

    def waiter():
        with gate.admit():
            admitted.set()

    thread = threading.Thread(target=waiter)
    thread.start()
    try:
        deadline = time.monotonic() + 10.0
        while gate.queue_depth != 1 and time.monotonic() < deadline:
            time.sleep(0.005)
        assert gate.queue_depth == 1 and not admitted.is_set()
        # a raise admits the waiter with no release
        assert gate.set_max_inflight(2) == 2
        assert admitted.wait(timeout=10.0)
    finally:
        first.release()
        thread.join(timeout=10)
    # a cut sheds no one admitted: two in flight stay under a bound of 1
    a, b = gate.admit(), None
    gate.set_max_inflight(2)
    b = gate.admit()
    assert gate.set_max_inflight(0) == 1 and gate.inflight == 2
    a.release()
    b.release()
    assert gate.inflight == 0 and gate.stats()["max_inflight"] == 1


@pytest.fixture(scope="module")
def models_root(tmp_path_factory):
    root = tmp_path_factory.mktemp("autopilot") / "models"
    for seed, name in enumerate(NAMES):
        ref_dump(_fit(seed), str(root / name), metadata={"dataset": {"tag_list": TAGS}})
    return root


def test_signal_extras_match_the_reference_engine(models_root):
    ours = ServingEngine({n: load(str(models_root / n), device="cpu") for n in NAMES},
                         device="cpu")
    ref = RefEngine({n: ref_load(str(models_root / n)) for n in NAMES})
    try:
        extras = []
        for engine, sig_mod in ((ours, signals), (ref, ref_signals)):
            for name in NAMES + NAMES[:1]:
                engine.anomaly(name, X)
            engine.quiesce()
            extras.append(sig_mod.SignalReader(engine_stats=engine.stats).read(0.0).extras)
        assert extras[0] == extras[1]
        assert extras[0]["mega_enabled"] is True
        assert extras[0]["resident_machines"] == len(NAMES) <= extras[0]["residency_cap"]
        assert ours.cost_ledger()["rungs"].keys() == ref.cost_ledger()["rungs"].keys()
        for key in ("machines", "buckets", "requests"):
            assert ours.cost_ledger()["rungs"]["f32"][key] == ref.cost_ledger()["rungs"]["f32"][key]
        assert set(ours.cost_ledger()) == set(ref.cost_ledger())
        assert set(ours.cost_ledger()["host_cache"]) == set(ref.cost_ledger()["host_cache"])
        assert set(ours.cost_ledger()["spill"]) == set(ref.cost_ledger()["spill"])
    finally:
        ours.close()
        ref.close()


def _bits(result):
    return [np.asarray(field).tobytes() for field in result]


def test_engine_apply_tuning_scores_identically(models_root):
    engine = ServingEngine({n: load(str(models_root / n), device="cpu") for n in NAMES},
                           device="cpu")
    try:
        before = [_bits(engine.anomaly(n, X)) for n in NAMES]
        applied = engine.apply_tuning(dispatch_depth=4, fill_window_us=2000,
                                      megabatch_residency=8)
        assert applied == {"dispatch_depth": 4, "fill_window_us": 2000,
                           "megabatch_residency": None}
        assert [_bits(engine.anomaly(n, X)) for n in NAMES] == before
        engine.apply_tuning(dispatch_depth=1, fill_window_us=0)
        # the window closed, the fused path on: drain-only fusion, as the
        # reference's engine reports it
        mega = engine.stats()["megabatch"]
        assert mega["enabled"] is True and mega["fill_window_us"] == 0
        assert [_bits(engine.anomaly(n, X)) for n in NAMES] == before
        seconds = engine.cost_ledger()["rungs"]["f32"]["dispatch_seconds_total"]
        assert seconds > 0.0
    finally:
        engine.close()


@pytest.fixture
def fresh_state(monkeypatch, tmp_path):
    for key in ("GORDO_AUTOPILOT", "GORDO_FAULTS", "GORDO_TENANTS"):
        monkeypatch.delenv(key, raising=False)
    monkeypatch.setenv("GORDO_LEDGER_DIR", str(tmp_path / "ledger"))
    monkeypatch.setenv("GORDO_TELEMETRY_DIR", str(tmp_path / "telemetry"))
    monkeypatch.setattr(ledger, "LEDGER", ledger.ControlLedger())
    yield
    ledger.LEDGER.close()


def test_a_reload_keeps_the_applied_tuning(models_root, tmp_path, fresh_state):
    root = tmp_path / "models"
    for name in NAMES[:2]:
        shutil.copytree(models_root / name, root / name)
    server = ModelServer(str(root), device="cpu")
    try:
        applied = server.apply_tuning(dispatch_depth=3, fill_window_us=777, max_inflight=9,
                                      shed_level=2, megabatch_residency=5)
        assert applied == {"max_inflight": 9, "shed_level": 2, "dispatch_depth": 3,
                           "fill_window_us": 777, "megabatch_residency": None}
        old_engine = server.engine
        shutil.copytree(models_root / NAMES[2], root / NAMES[2])
        assert server.reload()["added"] == [NAMES[2]]
        assert server.engine is not old_engine
        tuning = server.engine.current_tuning()
        assert (tuning["dispatch_depth"], tuning["fill_window_us"]) == (3, 777)
        assert server.admission.max_inflight == 9 and server.admission.shed_level == 2
        response = server.handle("POST", f"/gordo/v0/project/{NAMES[2]}/anomaly/prediction",
                                 {}, json.dumps({"X": X.tolist()}).encode())
        assert response.status == 200
    finally:
        server.close()


@pytest.mark.parametrize("bounds_env", [{}, {"GORDO_AUTOPILOT_DEPTH_BOUNDS": "2:4",
                                             "GORDO_AUTOPILOT_SHED_BOUNDS": "0:3"}])
def test_server_controller_wires_the_reference_actuators(models_root, tmp_path, fresh_state,
                                                         monkeypatch, bounds_env):
    for key, value in bounds_env.items():
        monkeypatch.setenv(key, value)
    server = ModelServer(str(models_root / NAMES[0]), device="cpu")
    try:
        pilot = server.autopilot
        assert pilot is not None and pilot.enabled is False  # built frozen
        ref_bounds = {
            "dispatch_depth": ref_policy.bounds_knob("GORDO_AUTOPILOT_DEPTH_BOUNDS",
                                                     ref_policy.Bounds(1, 8)),
            "fill_window": ref_policy.bounds_knob("GORDO_AUTOPILOT_FILL_BOUNDS",
                                                  ref_policy.Bounds(0, 4000)),
            "max_inflight": ref_policy.bounds_knob("GORDO_AUTOPILOT_INFLIGHT_BOUNDS",
                                                   ref_policy.Bounds(8, 256)),
            "shed": ref_policy.bounds_knob("GORDO_AUTOPILOT_SHED_BOUNDS",
                                           ref_policy.Bounds(0, 8)),
            "residency": ref_policy.bounds_knob("GORDO_AUTOPILOT_RESIDENCY_BOUNDS",
                                                ref_policy.Bounds(16, 1024)),
        }
        assert {n: tuple(a.bounds) for n, a in pilot.actuators.items()} == \
            {n: tuple(b) for n, b in ref_bounds.items()}
        assert pilot.actuators["residency"].skip_on_none is True
        # the residency seam answers not-applicable: nothing journaled
        assert pilot.actuators["residency"].apply(64) is None
        snapshot = pilot.snapshot()
        assert snapshot["actuators"]["residency"]["value"] == 128
        assert snapshot["actuators"]["max_inflight"]["value"] == server.admission.max_inflight
    finally:
        server.close()
    monkeypatch.setenv("GORDO_AUTOPILOT", "0")
    server = ModelServer(str(models_root / NAMES[0]), device="cpu")
    try:
        assert server.autopilot is None
    finally:
        server.close()


# -- the router's elastic worker count ------------------------------------------

def _elastic_fleet(n=2):
    from test_torch_router import _free_port, _ThreadWorker

    from gordo_components_tpu_torch.router import WorkerSpec, assemble_fleet
    from gordo_components_tpu_torch.server.httpd import Response

    class _Ok:
        def handle(self, method, path, headers, body):
            return Response(200, b'{"ok": true, "status": "ok", "live": true, "ready": true}',
                            "application/json", {})

        def close(self):
            pass

    specs = [WorkerSpec(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(n)]
    router = assemble_fleet(specs, lambda spec: _ThreadWorker(spec, _Ok()), project="proj",
                            respawn=False)
    router.supervisor.start_all()
    assert len(router.supervisor.wait_ready(timeout=10)) == n
    return router, _free_port


def _stop(router):
    router.control.stop()
    router.supervisor.stop_all(grace=5)
    router.close()


def test_elastic_scale_up_adds_slot_and_ring_member(monkeypatch):
    from gordo_components_tpu_torch.autopilot.elastic import ElasticWorkers

    monkeypatch.setenv("GORDO_AUTOPILOT", "1")
    router, free_port = _elastic_fleet(2)
    try:
        elastic = ElasticWorkers(router.supervisor, router.control, router.placement,
                                 port_allocator=free_port, ready_timeout=10.0)
        assert elastic.count() == 2
        name = elastic.scale_up()
        assert name == "worker-2"
        assert elastic.join(timeout=30)
        assert elastic.last_op()["state"] == "spawned"
        assert sorted(router.supervisor.specs) == ["worker-0", "worker-1", "worker-2"]
        assert "worker-2" in router.placement.workers()
        assert router.supervisor.alive("worker-2")
        assert elastic.busy() is False
    finally:
        _stop(router)


def test_elastic_retire_leaves_ring_first_and_never_drops_last(monkeypatch):
    from gordo_components_tpu_torch.autopilot.elastic import ElasticWorkers

    monkeypatch.setenv("GORDO_AUTOPILOT", "1")
    router, free_port = _elastic_fleet(2)
    try:
        elastic = ElasticWorkers(router.supervisor, router.control, router.placement,
                                 port_allocator=free_port)
        name = elastic.scale_down()
        assert name == "worker-1"  # newest slot retires first
        # off the ring synchronously — BEFORE the drain completes
        assert "worker-1" not in router.placement.workers()
        assert elastic.join(timeout=30)
        assert sorted(router.supervisor.specs) == ["worker-0"]
        assert elastic.last_op()["state"] == "retired"
        # the floor: a single-worker fleet refuses to retire
        assert elastic.scale_down() is None
        assert sorted(router.supervisor.specs) == ["worker-0"]
    finally:
        _stop(router)


def test_controller_drives_elastic_scale_through_workers_rule(monkeypatch):
    """Sustained burn observed by the controller spawns a worker through
    the full policy path (confirm ticks, cooldown, AIMD ±1)."""
    from gordo_components_tpu_torch.autopilot.elastic import ElasticWorkers

    monkeypatch.setenv("GORDO_AUTOPILOT", "1")
    router, free_port = _elastic_fleet(2)
    try:
        elastic = ElasticWorkers(router.supervisor, router.control, router.placement,
                                 port_allocator=free_port, ready_timeout=10.0)
        clock = [0.0]
        actuator = policy.Actuator(
            name="workers",
            read=elastic.count,
            apply=elastic.apply_target,
            decide=policy.workers_rule(policy.Thresholds()),
            bounds=policy.Bounds(1, 3),
            aimd=policy.AIMD(step=0.0, backoff=0.99),
            cooldown=1.0,
            confirm=2,
        )
        reader = _Scripted(signals.Observation(burn_fast=5.0))
        pilot = controller.Autopilot(reader, [actuator], role="test", clock=lambda: clock[0],
                                     min_interval=1.0, enabled=True,
                                     recorder=flightrec.FlightRecorder(enabled=True))
        clock[0] += 2
        pilot.tick()
        assert elastic.count() == 2  # hysteresis: one tick is not enough
        clock[0] += 2
        pilot.tick()
        assert elastic.join(timeout=30)
        assert elastic.count() == 3
        decision = pilot.snapshot()["decisions"][-1]
        assert (decision["actuator"], decision["direction"], decision["reason"]) == (
            "workers", "up", "sustained_burn")
        # ceiling: at 3 with bounds 1:3 nothing more fires
        for _ in range(2):
            clock[0] += 5
            pilot.tick()
        elastic.join(timeout=30)
        assert elastic.count() == 3
    finally:
        _stop(router)


@pytest.mark.parametrize("env", [{}, {"GORDO_AUTOPILOT_WORKER_BOUNDS": "2:5",
                                      "GORDO_AUTOPILOT_SCALE_TICKS": "5",
                                      "GORDO_AUTOPILOT_COOLDOWN": "7"}])
def test_router_controller_wires_the_reference_actuator(monkeypatch, env):
    from test_torch_router import _free_port

    from gordo_components_tpu import router as ref_router

    from gordo_components_tpu_torch import router

    for key, value in env.items():
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("GORDO_AUTOPILOT", raising=False)
    specs = [(f"worker-{i}", i, "127.0.0.1", _free_port()) for i in range(2)]
    ours = router.assemble_fleet([router.WorkerSpec(*s) for s in specs], lambda spec: None)
    theirs = ref_router.assemble_fleet([ref_router.WorkerSpec(*s) for s in specs],
                                       lambda spec: None)
    try:
        for pilot in (ours.autopilot, theirs.autopilot):
            assert pilot is not None and pilot.enabled is False  # built frozen
            assert list(pilot.actuators) == ["workers"]
        a, b = ours.autopilot.actuators["workers"], theirs.autopilot.actuators["workers"]
        assert tuple(a.bounds) == tuple(b.bounds)
        assert (a.confirm, a.cooldown, a.skip_on_none) == (b.confirm, b.cooldown, b.skip_on_none)
        assert (a.aimd.step, a.aimd.backoff) == (b.aimd.step, b.aimd.backoff)
        assert ours.autopilot.elastic.count() == theirs.autopilot.elastic.count() == 2
    finally:
        ours.close()
        theirs.close()
    monkeypatch.setenv("GORDO_AUTOPILOT", "0")
    off = router.assemble_fleet([router.WorkerSpec(*specs[0])], lambda spec: None)
    try:
        assert off.autopilot is None
    finally:
        off.close()
