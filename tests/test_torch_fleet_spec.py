"""The port's fleet spec, diff engine, reconciler and capacity feed
against the reference's, on the CPU.

- ``FleetSpec``: the same payloads parse to the same canonical dict in
  both packages, and the same bad payloads raise ``SpecError`` with the
  same message.
- ``diff_spec``: seeded ``Observed`` states (made with numpy) give the
  same divergences, in repair order, over every class.
- ``SpecStore``: one journal under one models root; a revision committed
  by either package loads in the other, the journal's bytes are the
  same for the same commits, and the torn-tail fsck under ``spec-commit``
  repairs both alike.
- ``Reconciler``: repair budget, per-class cooldown, oscillation hold,
  ``unwired``, the canary's revert and WAL resume exactly once under
  ``reconcile-apply``, each driven through both packages on the same
  injected clock, the journals compared entry by entry (their wall-clock
  ``at`` aside).
- ``Autopilot.set_bounds`` journals the same decision in both.
"""

import json
import os
import shutil
import sys
from pathlib import Path

import numpy as np
import pytest

from gordo_components_tpu.autopilot import controller as ref_controller
from gordo_components_tpu.autopilot import policy as ref_policy
from gordo_components_tpu.autopilot import signals as ref_signals
from gordo_components_tpu.fleet import capacity as ref_capacity
from gordo_components_tpu.fleet import reconciler as ref_reconciler
from gordo_components_tpu.fleet import spec as ref_spec
from gordo_components_tpu.observability import flightrec as ref_flightrec
from gordo_components_tpu.observability import ledger as ref_ledger
from gordo_components_tpu.resilience import faults as ref_faults
from gordo_components_tpu_torch.autopilot import controller, policy, signals
from gordo_components_tpu_torch.fleet import capacity, reconciler, spec
from gordo_components_tpu_torch.observability import flightrec, ledger
from gordo_components_tpu_torch.layout import compile_plan, plan_fingerprint
from gordo_components_tpu_torch.resilience import faults

sys.path.insert(0, str(Path(__file__).resolve().parent))
from test_torch_layout import _doc as layout_doc  # noqa: E402

PACKAGES = {
    "ours": (spec, reconciler, faults, flightrec),
    "ref": (ref_spec, ref_reconciler, ref_faults, ref_flightrec),
}


@pytest.fixture(autouse=True)
def _fresh(monkeypatch):
    for module in (ledger, ref_ledger):
        monkeypatch.setattr(module, "LEDGER", module.ControlLedger())
    for module in (faults, ref_faults):
        module.clear()
    yield
    for module in (faults, ref_faults):
        module.clear()


class _Clock:
    def __init__(self, t=1000.0):
        self.t = t

    def __call__(self):
        return self.t

    def advance(self, dt):
        self.t += dt
        return self.t


def _strip_at(value):
    if isinstance(value, dict):
        return {k: _strip_at(v) for k, v in value.items() if k != "at"}
    if isinstance(value, list):
        return [_strip_at(v) for v in value]
    return value


# -- FleetSpec ------------------------------------------------------------------

GOOD_SPECS = [
    {},
    {"machines": {"m-1": {"generation": "gen-0002", "precision": "bf16"},
                  "m-2": {"generation": "current"}, "m-3": {}},
     "workers": {"floor": 2, "ceiling": 4}, "mesh_shards": 2, "canary_fraction": 0.5,
     "residency_cap": 16, "slo": {"p99_ms": 250, "availability": 0.999},
     "tenants": "ops:interactive;batch:bulk"},
    {"workers": {"floor": 3}, "canary_fraction": 1},
]

BAD_SPECS = [
    [],
    {"machine": {}},
    {"machines": ["m-1"]},
    {"machines": {"m": "gen-0001"}},
    {"machines": {"m": {"gen": "gen-0001"}}},
    {"machines": {"ghost": {}}},
    {"machines": {"m-1": {"generation": "latest"}}},
    {"machines": {"m-1": {"precision": "fp8"}}},
    {"workers": {"floor": 0, "ceiling": 2}},
    {"workers": {"floor": 4, "ceiling": 2}},
    {"workers": {"floor": "x"}},
    {"workers": {"min": 1}},
    {"mesh_shards": -1},
    {"canary_fraction": 0.0},
    {"residency_cap": 0},
    {"slo": {"p50_ms": 10}},
    {"slo": {"p99_ms": -1}},
    {"slo": [1]},
    {"tenants": 3},
    {"tenants": "ops:nonsense-class"},
    {"layout": {"schema": "gordo-layout-plan/v1"}},
]


@pytest.mark.parametrize("payload", GOOD_SPECS, ids=range(len(GOOD_SPECS)))
def test_spec_parses_to_the_same_canonical_dict(payload):
    known = ["m-1", "m-2", "m-3"]
    ours = spec.FleetSpec.parse(payload, known_machines=known)
    theirs = ref_spec.FleetSpec.parse(payload, known_machines=known)
    assert ours.to_dict() == theirs.to_dict()
    # the round trip is a fixed point in both
    assert spec.FleetSpec.parse(ours.to_dict()).to_dict() == ours.to_dict()


@pytest.mark.parametrize("payload", BAD_SPECS, ids=range(len(BAD_SPECS)))
def test_bad_specs_fail_with_the_references_message(payload):
    known = ["m-1", "m-2"]
    with pytest.raises(spec.SpecError) as ours:
        spec.FleetSpec.parse(payload, known_machines=known)
    with pytest.raises(ref_spec.SpecError) as theirs:
        ref_spec.FleetSpec.parse(payload, known_machines=known)
    assert str(ours.value) == str(theirs.value)


# -- diff_spec --------------------------------------------------------------------

def _random_state(seed: int):
    """A seeded (spec payload, Observed fields, default bounds) triple
    with divergences of most classes."""
    rng = np.random.default_rng(seed)
    machines = [f"m-{i}" for i in range(6)]
    workers = [f"worker-{i}" for i in range(int(rng.integers(2, 5)))]
    dead = [w for w in workers if rng.random() < 0.25]
    ready = [w for w in workers if w not in dead and rng.random() < 0.9]
    gens = {m: f"gen-{int(rng.integers(1, 4)):04d}" for m in machines}
    gens[machines[-1]] = None
    rungs = ("f32", "bf16", "int8")
    payload = {"machines": {}}
    for m in machines:
        entry = {}
        if rng.random() < 0.5:
            entry["generation"] = (f"gen-{int(rng.integers(1, 4)):04d}"
                                   if rng.random() < 0.8 else "current")
        if rng.random() < 0.4:
            entry["precision"] = rungs[int(rng.integers(3))]
        payload["machines"][m] = entry
    if rng.random() < 0.7:
        floor = int(rng.integers(1, 4))
        payload["workers"] = {"floor": floor, "ceiling": floor + int(rng.integers(0, 2))}
    if rng.random() < 0.5:
        payload["mesh_shards"] = int(rng.integers(0, 3))
    if rng.random() < 0.6:
        payload["layout"] = {
            "schema": "gordo-layout-plan/v1", "generated_t": 1.0,
            "workers": workers, "weights": {w: float(rng.choice([0.5, 1.0, 2.0]))
                                            for w in workers},
            "residency": {"cap": None, "workers": {w: {"resident": machines[:2]}
                                                   for w in workers}},
            "precision": {machines[1]: rungs[int(rng.integers(1, 3))]},
            "prefetch": {},
        }
        payload["layout"]["fingerprint"] = plan_fingerprint(payload["layout"])
    observed = dict(
        workers_total=len(workers),
        workers_ready=ready,
        workers_dead=dead,
        worker_generations={w: {m: f"gen-{int(rng.integers(1, 4)):04d}" for m in machines}
                            for w in ready},
        disk_generations=gens,
        disk_precisions={m: rungs[int(rng.integers(3))] for m in machines},
        mesh_shards=int(rng.integers(0, 3)) if rng.random() < 0.5 else None,
        elastic_busy=bool(rng.random() < 0.2),
        autopilot_bounds=(1, int(rng.integers(2, 9))) if rng.random() < 0.8 else None,
        placement_weights={w: float(rng.choice([1.0, 2.0])) for w in workers},
        worker_layouts={w: (None if rng.random() < 0.5 else "f" * 16) for w in ready},
    )
    default = (1, int(rng.integers(2, 6))) if rng.random() < 0.5 else None
    return payload, observed, default


def _divergences(package, payload, observed, default):
    spec_mod, rec_mod = PACKAGES[package][:2]
    parsed = spec_mod.FleetSpec.parse(payload)
    return [(d.cls, d.target, d.desired, d.actual, d.detail, d.key(3))
            for d in rec_mod.diff_spec(parsed, rec_mod.Observed(**observed), default)]


@pytest.mark.parametrize("seed", range(12))
def test_diff_spec_agrees_in_repair_order(seed):
    payload, observed, default = _random_state(seed)
    ours = _divergences("ours", payload, observed, default)
    assert ours == _divergences("ref", payload, observed, default)
    order = [reconciler.CLASSES.index(d[0]) for d in ours]
    assert order == sorted(order)


def test_diff_spec_covers_every_class_in_order():
    """One state diverging in every class the port can observe: bounds,
    workers, generation, precision, adoption, mesh and layout."""
    payload = {
        "machines": {"m": {"generation": "gen-0003", "precision": "bf16"}},
        "workers": {"floor": 2, "ceiling": 3},
        "mesh_shards": 4,
    }
    observed = dict(
        workers_total=2, workers_ready=["w1"], workers_dead=["w0"],
        worker_generations={"w1": {"m": "gen-0001"}},
        disk_generations={"m": "gen-0002"}, disk_precisions={"m": "f32"},
        mesh_shards=2, autopilot_bounds=(1, 8),
        placement_weights={"w1": 2.0}, worker_layouts={"w1": "abc"},
    )
    ours = _divergences("ours", payload, observed, None)
    assert ours == _divergences("ref", payload, observed, None)
    assert [d[0] for d in ours] == ["bounds", "workers", "generation", "precision",
                                    "adoption", "mesh", "layout", "layout"]


# -- SpecStore across packages ----------------------------------------------------

def _history(payloads, package, root, clock):
    store = PACKAGES[package][0].SpecStore(root, clock=clock)
    for payload in payloads:
        store.commit(PACKAGES[package][0].FleetSpec.parse(payload), op="apply")
        clock.advance(1.5)
    store.rollback(reason="drill")
    with open(store.journal_path, "rb") as fh:
        return fh.read()


def test_spec_journal_bytes_are_the_references(tmp_path):
    payloads = GOOD_SPECS[:1] + [{"machines": {"m-1": {"generation": "gen-0001"}}},
                                 GOOD_SPECS[2]]
    ours = _history(payloads, "ours", str(tmp_path / "ours"), _Clock())
    theirs = _history(payloads, "ref", str(tmp_path / "ref"), _Clock())
    assert ours == theirs
    with open(tmp_path / "ours" / ".fleet" / "SPEC_CURRENT") as fh:
        assert fh.read() == "4\n"


@pytest.mark.parametrize("first", ["ours", "ref"])
def test_a_journal_committed_by_one_package_loads_in_the_other(tmp_path, first):
    second = "ref" if first == "ours" else "ours"
    root = str(tmp_path)
    clock = _Clock()
    a = PACKAGES[first][0].SpecStore(root, clock=clock)
    a.commit(PACKAGES[first][0].FleetSpec.parse({"machines": {"m": {"generation": "gen-0002"}}}))
    clock.advance(1.0)
    b = PACKAGES[second][0].SpecStore(root, clock=clock)
    assert b.load() == a.load()
    b.commit(PACKAGES[second][0].FleetSpec.parse({"canary_fraction": 0.5}))
    clock.advance(1.0)
    PACKAGES[first][0].SpecStore(root, clock=clock).rollback(reason="back")
    c = PACKAGES[second][0].SpecStore(root, clock=clock)
    record = c.load()
    assert (record["revision"], record["op"], record["reverted_to"]) == (3, "rollback", 1)
    assert c.current_spec()[1].to_dict() == \
        PACKAGES[first][0].SpecStore(root).current_spec()[1].to_dict()
    assert [r["revision"] for r in c.history()] == [1, 2, 3]


@pytest.mark.parametrize("kind", ["error", "torn-write"])
def test_spec_commit_fault_and_torn_tail_fsck_agree(tmp_path, kind):
    outcomes = {}
    for package, (spec_mod, _, faults_mod, _) in PACKAGES.items():
        root = str(tmp_path / package)
        clock = _Clock()
        store = spec_mod.SpecStore(root, clock=clock)
        store.commit(spec_mod.FleetSpec.parse({}))
        faults_mod.configure(f"spec-commit:2:{kind}")
        try:
            store.commit(spec_mod.FleetSpec.parse({"canary_fraction": 0.5}))
            raised = None
        except faults_mod.FaultInjected as exc:
            raised = str(exc)
        faults_mod.clear()
        fresh = spec_mod.SpecStore(root, clock=clock)
        record = fresh.load()
        with open(fresh.journal_path, "rb") as fh:
            journal = fh.read()
        with open(fresh.pointer_path) as fh:
            pointer = fh.read()
        # the next commit lands on a clean line after the fsck
        fresh.commit(spec_mod.FleetSpec.parse({"residency_cap": 4}))
        with open(fresh.journal_path, "rb") as fh:
            after = fh.read()
        outcomes[package] = (raised, record, journal, pointer, after)
    assert outcomes["ours"] == outcomes["ref"]
    raised, record, _, pointer, after = outcomes["ours"]
    assert record["revision"] == 1 and pointer == "1\n"
    assert (raised is not None) == (kind == "error")
    assert [json.loads(line)["revision"] for line in after.splitlines()] == [1, 2]


# -- the reconciler ---------------------------------------------------------------

class _Seams:
    """Every seam of a RepairSeams recorded; reload and verify answer ok
    unless told otherwise."""

    def __init__(self, rec_mod, fail_reload=False, busy_op=False):
        self.calls = []
        names = ("respawn", "scale", "pin_generation", "rebuild", "reload_worker",
                 "verify_worker", "retune", "set_worker_bounds", "set_placement_weights",
                 "apply_worker_layout")
        kwargs = {name: self._record(name) for name in names}
        if fail_reload:
            kwargs["reload_worker"] = lambda name: (
                self.calls.append(("reload_worker", (name,))) or {"ok": False, "error": "boom"})
        if busy_op:
            kwargs["acquire_op"] = lambda: False
        self.seams = rec_mod.RepairSeams(**kwargs)

    def _record(self, name):
        def seam(*args):
            self.calls.append((name, args))
            return {"ok": True} if name in ("reload_worker", "verify_worker") else None
        return seam


def _observed(**kwargs):
    base = dict(workers_total=2, workers_ready=["w0", "w1"], workers_dead=[],
                worker_generations={}, disk_generations={"m": "gen-0002"},
                disk_precisions={"m": "f32"}, mesh_shards=None, elastic_busy=False,
                autopilot_bounds=(1, 8))
    base.update(kwargs)
    return base


def _drive(package, root, steps, observed, wire=True, fail_reload=False, **kwargs):
    """Run ``steps`` through one package's reconciler; each step is
    ``(clock advance, spec payload to commit or None, observed overrides
    or None, fault spec or None, fresh reconciler?)``. Returns the tick
    entries, the seam calls, the WAL's records, the spec journal, the
    last snapshot's posture."""
    spec_mod, rec_mod, faults_mod, rec_flight = PACKAGES[package]
    clock = _Clock()
    store = spec_mod.SpecStore(root, clock=clock)
    holder = {"observed": rec_mod.Observed(**observed)}
    seams = _Seams(rec_mod, fail_reload=fail_reload)
    kwargs = {"min_interval": 1.0, "cooldown": 30.0, "repair_budget": 2, **kwargs}

    def build():
        return rec_mod.Reconciler(store, lambda: holder["observed"],
                                  seams.seams if wire else rec_mod.RepairSeams(),
                                  clock=clock, recorder=rec_flight.FlightRecorder(enabled=True),
                                  **kwargs)

    rec = build()
    entries = []
    for advance, payload, overrides, fault, fresh in steps:
        clock.advance(advance)
        if payload is not None:
            store.commit(spec_mod.FleetSpec.parse(payload))
        if overrides is not None:
            holder["observed"] = rec_mod.Observed(**{**observed, **overrides})
        if fresh:
            rec = build()
        if fault:
            faults_mod.configure(fault)
        entries.append(_strip_at(rec.tick()))
        faults_mod.clear()
    wal_path = os.path.join(store.dir, rec_mod.RECONCILE_JOURNAL_FILE)
    wal = []
    if os.path.exists(wal_path):  # unwired and skipped steps write none
        with open(wal_path) as fh:
            wal = [json.loads(line) for line in fh if line.strip()]
    with open(store.journal_path) as fh:
        journal = [json.loads(line) for line in fh if line.strip()]
    snap = rec.snapshot()
    posture = {key: snap[key] for key in ("divergence", "frozen", "cooling", "wal_steps",
                                          "revision", "ticks")}
    return entries, seams.calls, wal, journal, posture, _strip_at(snap["repairs"])


SCENARIOS = {
    # four divergences, budget 2: two repairs, one deferred entry
    "budget": dict(
        observed=_observed(workers_ready=["w1"], workers_dead=["w0"],
                           disk_generations={"m": "gen-0001"}),
        steps=[(0.0, {"machines": {"m": {"generation": "gen-0002", "precision": "bf16"}},
                      "workers": {"floor": 2, "ceiling": 3}}, None, None, False)],
    ),
    # a repaired class rests; past the cooldown it repairs again
    "cooldown": dict(
        observed=_observed(workers_ready=["w1"], workers_dead=["w0"]),
        steps=[(0.0, {}, None, None, False), (1.0, None, None, None, False),
               (30.0, None, None, None, False)],
        kwargs={"repair_budget": 4},
    ),
    # disk keeps swinging back: two pins, then a hold, then silence
    "oscillation": dict(
        observed=_observed(disk_generations={"m": "gen-0001"}),
        steps=[(0.0, {"machines": {"m": {"generation": "gen-0002"}}}, None, None, False),
               (1.0, None, None, None, False), (1.0, None, None, None, False),
               (1.0, None, None, None, False)],
        kwargs={"cooldown": 0.0},
    ),
    # no seam bound: the precision class (no rebuild seam in a router)
    # and everything else journal unwired
    "unwired": dict(
        observed=_observed(mesh_shards=2, disk_precisions={"m": "f32"}),
        steps=[(0.0, {"mesh_shards": 4, "machines": {"m": {"precision": "bf16"}}},
                None, None, False)],
        wire=False,
    ),
    # the adoption canary fails: the spec reverts, adoption freezes
    "canary": dict(
        observed=_observed(worker_generations={"w0": {"m": "gen-0002"},
                                               "w1": {"m": "gen-0002"}}),
        steps=[(0.0, {"canary_fraction": 0.5}, None, None, False),
               (1.0, {"canary_fraction": 0.25},
                {"worker_generations": {"w0": {"m": "gen-0001"}, "w1": {"m": "gen-0001"}}},
                None, False),
               (1.0, None, None, None, False)],
        fail_reload=True,
    ),
    # a canary that passes, then the sweep one cooldown later
    "adoption": dict(
        observed=_observed(worker_generations={"w0": {"m": "gen-0001"},
                                               "w1": {"m": "gen-0001"}}),
        steps=[(0.0, {}, None, None, False),
               (5.0, None, {"worker_generations": {"w0": {"m": "gen-0002"},
                                                   "w1": {"m": "gen-0001"}}}, None, False),
               (30.0, None, {"worker_generations": {"w0": {"m": "gen-0002"},
                                                    "w1": {"m": "gen-0001"}}}, None, False)],
    ),
    # killed between the WAL's applying and the repair: re-executed once
    # when the divergence persists, recovered without re-running when it
    # is gone
    "wal_resume": dict(
        observed=_observed(workers_ready=["w1"], workers_dead=["w0"]),
        steps=[(0.0, {}, None, "reconcile-apply:workers/w0:error", False),
               (60.0, None, None, None, True),
               (60.0, None, None, "reconcile-apply:workers/w0:error", False),
               (60.0, None, {"workers_ready": ["w0", "w1"], "workers_dead": []}, None, True)],
    ),
    # a committed plan's weights and per-worker fingerprints, then no plan
    "layout": dict(
        observed=_observed(placement_weights={"w0": 2.0}, worker_layouts={"w0": None,
                                                                          "w1": "stale"}),
        steps=[(0.0, {}, None, None, False),
               (30.0, None, {"placement_weights": {},
                             "worker_layouts": {"w0": None, "w1": "stale"}}, None, False),
               (30.0, None, {"placement_weights": {}, "worker_layouts": {}}, None, False)],
        kwargs={"repair_budget": 3},
    ),
}


@pytest.mark.parametrize("name", sorted(SCENARIOS))
def test_reconciler_journal_matches_the_reference(tmp_path, name):
    scenario = SCENARIOS[name]
    runs = {}
    for package in PACKAGES:
        runs[package] = _drive(package, str(tmp_path / package), scenario["steps"],
                               scenario["observed"], wire=scenario.get("wire", True),
                               fail_reload=scenario.get("fail_reload", False),
                               **scenario.get("kwargs", {}))
    ours, theirs = runs["ours"], runs["ref"]
    for i, label in enumerate(("tick entries", "seam calls", "WAL", "spec journal", "posture",
                               "repair ring")):
        assert ours[i] == theirs[i], label
    outcomes = [[(e["class"], e["outcome"]) for e in tick] for tick in ours[0]]
    expected = {
        "budget": [[("bounds", "applied"), ("workers", "applied"), ("generation", "deferred")]],
        "cooldown": [[("workers", "applied")], [], [("workers", "applied")]],
        "oscillation": [[("generation", "applied")], [("generation", "applied")],
                        [("generation", "hold")], []],
        "unwired": [[("precision", "unwired"), ("mesh", "unwired")]],
        "canary": [[], [("adoption", "canary_failed")], []],
        "adoption": [[("adoption", "applied")], [], [("adoption", "applied")]],
        "wal_resume": [[("workers", "aborted")], [("workers", "applied")],
                       [("workers", "aborted")], [("workers", "resumed")]],
        "layout": [[("layout", "applied")], [("layout", "applied")], []],
    }[name]
    assert outcomes == expected
    if name == "canary":
        # the revert is a journaled rollback to the previous revision, and
        # adoption stays frozen through the next tick
        assert ours[3][-1]["op"] == "rollback" and ours[3][-1]["reverted_to"] == 1
        assert "adoption" in ours[4]["frozen"]
    if name == "wal_resume":
        assert [c for c in ours[1] if c[0] == "respawn"] == [("respawn", ("w0",))]


def test_maybe_tick_and_diff_now_agree(tmp_path):
    for package, (spec_mod, rec_mod, _, rec_flight) in PACKAGES.items():
        clock = _Clock()
        store = spec_mod.SpecStore(str(tmp_path / package), clock=clock)
        rec = rec_mod.Reconciler(store, lambda: rec_mod.Observed(**_observed(mesh_shards=2)),
                                 rec_mod.RepairSeams(), clock=clock, min_interval=10.0,
                                 recorder=rec_flight.FlightRecorder(enabled=True))
        assert rec.diff_now() == {"revision": 0, "spec": None, "divergences": []}
        store.commit(spec_mod.FleetSpec.parse({"mesh_shards": 4}))
        assert rec.maybe_tick() is True and rec.maybe_tick() is False
        clock.advance(10.0)
        assert rec.maybe_tick() is True
        diff = rec.diff_now()
        if package == "ours":
            ours = diff
        else:
            assert diff == ours
    assert [d["class"] for d in ours["divergences"]] == ["mesh"]
    assert reconciler.disabled_snapshot() == ref_reconciler.disabled_snapshot()


# -- the capacity feed and the autopilot's bounds ---------------------------------

def _view(requests=1000, seconds=10.0, demand=25.0):
    return {"costs": {"engine": {"rungs": {"f32": {"requests": requests,
                                                   "dispatch_seconds_total": seconds}}}},
            "window": {"rates": {"gordo_server_requests_total": {"total": demand}}}}


@pytest.mark.parametrize("requests,seconds,demand,hard", [
    (1000, 10.0, 250.0, (1, 8)), (1000, 10.0, 250.0, (1, 4)), (3, 10.0, 250.0, (1, 8)),
    (5000, 2.0, 10.0, (2, 6)), (60, 0.1, 5.0, (1, 8)),
])
def test_capacity_feed_agrees(requests, seconds, demand, hard):
    view = _view(requests, seconds, demand)
    for fn in ("worker_capacity_rps", "observed_demand_rps"):
        assert getattr(capacity, fn)(view) == getattr(ref_capacity, fn)(view)
    assert capacity.derive_worker_bounds(view, hard) == \
        ref_capacity.derive_worker_bounds(view, hard)
    assert capacity.measured_idle_rps(view, 1.0) == ref_capacity.measured_idle_rps(view, 1.0)

    class _Thresholds:
        idle_rps = 1.0

    class _Pilot:
        static_idle_rps = 1.0

    results = []
    for module in (capacity, ref_capacity):
        pilot = _Pilot()
        pilot.thresholds = _Thresholds()
        results.append((module.calibrate_autopilot(pilot, view), pilot.thresholds.idle_rps))
    assert results[0] == results[1]


def _bounded_pilot(ctl_mod, pol_mod, sig_mod, rec_mod, clock):
    class _Reader:
        def observe(self):
            return sig_mod.Observation()

    actuator = pol_mod.Actuator(
        name="workers", read=lambda: 2, apply=lambda v: v,
        decide=pol_mod.workers_rule(pol_mod.Thresholds()), bounds=pol_mod.Bounds(1, 8),
        aimd=pol_mod.AIMD(step=0.0, backoff=0.99), cooldown=3.0, confirm=2)
    return ctl_mod.Autopilot(_Reader(), [actuator], role="router", min_interval=1.0,
                             clock=clock, recorder=rec_mod.FlightRecorder(enabled=True))


def test_set_bounds_journals_as_the_reference():
    results = []
    for modules in ((controller, policy, signals, flightrec),
                    (ref_controller, ref_policy, ref_signals, ref_flightrec)):
        clock = _Clock()
        pilot = _bounded_pilot(*modules, clock)
        changed = [pilot.set_bounds("workers", 2, 4), pilot.set_bounds("workers", 2, 4)]
        clock.advance(5.0)
        changed.append(pilot.set_bounds("workers", 1, 3))
        with pytest.raises(KeyError):
            pilot.set_bounds("depth", 1, 2)
        snap = _strip_at(pilot.snapshot())
        results.append((changed, snap["decisions"], snap["actuators"]["workers"]["bounds"]))
    assert results[0] == results[1]
    changed, decisions, bounds = results[0]
    assert changed == [True, False, True] and bounds == [1, 3]
    assert [(d["reason"], d["bounds_from"], d["bounds_to"]) for d in decisions] == [
        ("fleet_spec", [1, 8], [2, 4]), ("fleet_spec", [2, 4], [1, 3])]
    assert [(e["actor"], e["action"]) for e in ledger.LEDGER.recent()] == \
        [(e["actor"], e["action"]) for e in ref_ledger.LEDGER.recent()]


def test_spec_store_leaves_no_stray_files(tmp_path):
    """The store writes its journal and pointer only under .fleet/ (the
    models root's scan skips dot-directories)."""
    store = spec.SpecStore(str(tmp_path))
    store.commit(spec.FleetSpec.parse({}))
    assert sorted(os.listdir(tmp_path)) == [".fleet"]
    assert sorted(os.listdir(tmp_path / ".fleet")) == ["SPEC_CURRENT", "spec_journal.jsonl"]
    shutil.rmtree(tmp_path / ".fleet")
    assert spec.SpecStore(str(tmp_path)).load() is None


def test_a_stale_plan_is_rederived_as_a_new_revision_in_both(tmp_path, monkeypatch):
    """The layout class's staleness seam: a re-derived plan lands as an
    ``op: layout`` revision and the same tick converges toward it; under
    ``GORDO_LAYOUT_REDERIVE=0`` nothing is authored."""
    monkeypatch.delenv("GORDO_LAYOUT_REDERIVE", raising=False)
    stale = compile_plan(layout_doc(0, workers=("w0", "w1")))
    fresh = compile_plan(layout_doc(1, workers=("w0", "w1")))
    assert stale["fingerprint"] != fresh["fingerprint"]
    runs = {}
    for package, (spec_mod, rec_mod, _, rec_flight) in PACKAGES.items():
        clock = _Clock()
        store = spec_mod.SpecStore(str(tmp_path / package), clock=clock)
        store.commit(spec_mod.FleetSpec.parse({"layout": stale}))
        seams = _Seams(rec_mod)
        seams.seams.rederive_layout = lambda committed: fresh
        rec = rec_mod.Reconciler(store, lambda: rec_mod.Observed(**_observed()), seams.seams,
                                 clock=clock, min_interval=0.0, cooldown=0.0, repair_budget=10,
                                 recorder=rec_flight.FlightRecorder(enabled=True))
        entries = _strip_at(rec.tick())
        monkeypatch.setenv("GORDO_LAYOUT_REDERIVE", "0")
        clock.advance(1.0)
        rec.tick()
        monkeypatch.delenv("GORDO_LAYOUT_REDERIVE")
        with open(store.journal_path) as fh:
            journal = [json.loads(line) for line in fh]
        runs[package] = (entries, seams.calls, journal)
    assert runs["ours"] == runs["ref"]
    entries, calls, journal = runs["ours"]
    assert [(r["revision"], r["op"]) for r in journal] == [(1, "apply"), (2, "layout")]
    assert journal[-1]["spec"]["layout"]["fingerprint"] == fresh["fingerprint"]
    applied = [args for name, args in calls if name == "apply_worker_layout"]
    assert applied and all(plan["fingerprint"] == fresh["fingerprint"] for _, plan in applied)
