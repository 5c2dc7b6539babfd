"""The fleet reconciler: diff declared state against observed, repair
(the port's copy of ``gordo_components_tpu/fleet/reconciler.py``).

Scrape-driven like the SLO engine, autopilot, and telemetry warehouse
(``maybe_tick`` piggybacks on ``/metrics`` and ``/fleet`` reads, min-
interval-gated, clock-injectable — no thread). Each tick loads the
committed :class:`~.spec.FleetSpec`, observes the fleet (worker slots,
per-worker served generations/precisions, on-disk ``CURRENT`` pointers,
mesh layout, autopilot bounds), and folds the two into an ordered list
of :class:`Divergence` records. Repairs go through the EXISTING seams —
supervisor respawn, elastic scale, ``pin_generation``, per-worker
reload+verify (canary→sweep; a failed canary is a journaled revert to
the previous spec revision), precision rebuild requests, mesh
re-layout, autopilot bound ownership — never through private state.

Safety model (the autopilot's, re-used):

- **Repair budget** — at most ``GORDO_FLEET_REPAIR_BUDGET`` repairs per
  tick; a degraded fleet gets nudged, never stormed.
- **Per-class cooldown** — after a repair of one divergence class, that
  class rests ``GORDO_FLEET_COOLDOWN`` seconds (seeded from the WAL on
  restart, so a resumed reconciler does not burst).
- **Oscillation guard** — a divergence key repaired repeatedly within
  the hold window (4 cooldowns) freezes its class for the window and
  journals the hold: spec-vs-reality fights are surfaced, not replayed.
- **Three-way journal** — every repair lands as a
  ``gordo_fleet_repairs_total{kind,outcome}`` series, a synthetic
  flight-recorder timeline (``fleet-*`` trace ids), and a bounded ring
  the ``/fleet`` endpoint serves.

Crash consistency is WAL-shaped: each step appends ``applying`` (fsync)
before touching the fleet and ``applied``/``failed`` after. On resume,
a step whose divergence is GONE but whose last record is ``applying``
is marked ``applied (resumed)`` WITHOUT re-executing — the effect
landed, only the marker was lost — and a step whose divergence is still
present re-executes (the effect never landed). Idempotence keys scope
per spec revision, so a rollback re-opens repairs under the new
revision instead of replaying the old one's ledger.
"""

from __future__ import annotations

import json
import logging
import os
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis import lockcheck
from ..observability import flightrec
from ..observability import ledger as control_ledger
from ..observability.registry import REGISTRY
from ..observability.spans import Timeline
from ..resilience import faults
from .spec import FleetSpec, SpecError, SpecStore

logger = logging.getLogger(__name__)

RECONCILE_JOURNAL_FILE = "reconcile_journal.jsonl"

#: divergence classes, in repair order: ownership first (bounds are
#: metadata), then capacity (dead/missing workers), then disk truth
#: (generation pointers, precision rungs), then adoption of disk truth,
#: then mesh layout, then the committed layout plan (last on
#: purpose: ring weights and residency pins assume the fleet the
#: earlier classes just repaired)
CLASSES = (
    "bounds", "workers", "generation", "precision", "adoption", "mesh",
    "layout",
)

_OSCILLATION_HOLD_COOLDOWNS = 4.0

_M_TICKS = REGISTRY.counter(
    "gordo_fleet_ticks_total",
    "Reconciler evaluations (scrape-driven; no spec committed still "
    "counts — the diff is what it skips)",
)
_M_DIVERGENCE = REGISTRY.gauge(
    "gordo_fleet_divergence",
    "Divergences between the committed spec and observed fleet state "
    "at the last reconciler tick, by divergence class",
    labels=("kind",),
)
_M_REPAIRS = REGISTRY.counter(
    "gordo_fleet_repairs_total",
    "Reconciler repair steps by divergence class and outcome (applied / "
    "failed / resumed = WAL marker recovered without re-executing / "
    "canary_failed = adoption canary aborted, spec reverted / hold = "
    "oscillation guard / deferred = repair budget exhausted / unwired = "
    "no seam bound / aborted = injected crash mid-apply)",
    labels=("kind", "outcome"),
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, "") or default)
    except ValueError:
        return default


def _env_int(name: str, default: int) -> int:
    try:
        return int(os.environ.get(name, "") or default)
    except ValueError:
        return default


@dataclass(frozen=True)
class Divergence:
    """One observed difference from the declared state. ``target`` is
    the repair unit (a worker name, machine name, or pseudo-target like
    ``scale-up``); ``desired``/``actual`` are the evidence."""

    cls: str
    target: str
    desired: Any
    actual: Any
    detail: Dict[str, Any] = field(default_factory=dict)

    def key(self, revision: int) -> str:
        token = json.dumps(self.desired, sort_keys=True, default=str)
        return f"r{revision}:{self.cls}:{self.target}:{token}"


@dataclass
class Observed:
    """The fleet as it IS, from the router's vantage point. Tests build
    these synthetically; production fills them from the supervisor,
    control plane, worker ``/healthz`` bodies, and the models root."""

    workers_total: int = 0
    workers_ready: List[str] = field(default_factory=list)
    workers_dead: List[str] = field(default_factory=list)
    worker_generations: Dict[str, Dict[str, str]] = field(default_factory=dict)
    disk_generations: Dict[str, Optional[str]] = field(default_factory=dict)
    disk_precisions: Dict[str, str] = field(default_factory=dict)
    mesh_shards: Optional[int] = None
    elastic_busy: bool = False
    autopilot_bounds: Optional[Tuple[int, int]] = None
    # the ring's declared weight overrides (non-1.0 entries only)
    # and each ready worker's /healthz-reported layout-plan fingerprint
    # (None = the worker runs no plan)
    placement_weights: Dict[str, float] = field(default_factory=dict)
    worker_layouts: Dict[str, Optional[str]] = field(default_factory=dict)


@dataclass
class RepairSeams:
    """The actuation surface, all optional: an unwired seam journals
    ``unwired`` instead of failing, so a partially-assembled fleet (or a
    unit test) reconciles what it can."""

    respawn: Optional[Callable[[str], Any]] = None
    scale: Optional[Callable[[int], Any]] = None
    pin_generation: Optional[Callable[[str, str], Any]] = None
    rebuild: Optional[Callable[[str, str], Any]] = None
    reload_worker: Optional[Callable[[str], Dict[str, Any]]] = None
    verify_worker: Optional[Callable[[str], Dict[str, Any]]] = None
    retune: Optional[Callable[[str], Any]] = None
    mesh_refresh: Optional[Callable[[], Any]] = None
    set_worker_bounds: Optional[Callable[[int, int], Any]] = None
    # router.op claim: adoption must not interleave with an operator
    # rollout; non-blocking — busy skips the step, never queues it
    acquire_op: Optional[Callable[[], bool]] = None
    release_op: Optional[Callable[[], None]] = None
    # measured-capacity feed (telemetry → spec): refresh autopilot thresholds /
    # derived bounds from the telemetry cost ledger, once per tick
    calibrate: Optional[Callable[[], Any]] = None
    default_worker_bounds: Optional[
        Callable[[], Optional[Tuple[int, int]]]
    ] = None
    # layout plan application: install the plan's ring weights
    # atomically ({} clears them); land one worker's slice of the plan
    # (None = clear that worker back to LRU residency); and re-derive a
    # committed plan against fresh telemetry (returns a NEW plan when
    # the old one went stale, None while it stands)
    set_placement_weights: Optional[
        Callable[[Dict[str, float]], Any]
    ] = None
    apply_worker_layout: Optional[
        Callable[[str, Optional[Dict[str, Any]]], Any]
    ] = None
    rederive_layout: Optional[
        Callable[[Dict[str, Any]], Optional[Dict[str, Any]]]
    ] = None


def diff_spec(
    spec: FleetSpec,
    observed: Observed,
    default_workers: Optional[Tuple[int, int]] = None,
) -> List[Divergence]:
    """The pure diff engine: spec × observed → ordered divergences.
    ``default_workers`` backfills the worker floor/ceiling when the spec
    does not pin one (measured capacity, or the autopilot knob)."""
    divergences: List[Divergence] = []
    bounds = spec.workers or default_workers

    # bounds: the reconciler owns the autopilot's workers envelope
    if bounds is not None and observed.autopilot_bounds is not None:
        if tuple(observed.autopilot_bounds) != tuple(bounds):
            divergences.append(Divergence(
                "bounds", "workers",
                list(bounds), list(observed.autopilot_bounds),
            ))

    # workers: respawn named dead slots first (cheapest capacity back),
    # then scale toward the declared envelope
    for name in sorted(observed.workers_dead):
        divergences.append(Divergence(
            "workers", name, "alive", "dead", {"action": "respawn"},
        ))
    if bounds is not None and not observed.workers_dead:
        floor, ceiling = bounds
        ready = len(observed.workers_ready)
        if ready < floor:
            divergences.append(Divergence(
                "workers", "scale-up", floor, ready,
                {"action": "scale", "to": min(floor, ready + 1)},
            ))
        elif observed.workers_total > ceiling:
            divergences.append(Divergence(
                "workers", "scale-down", ceiling, observed.workers_total,
                {"action": "scale", "to": max(ceiling,
                                              observed.workers_total - 1)},
            ))

    # generation: disk CURRENT must match an explicit pin
    for machine, entry in sorted(spec.machines.items()):
        pinned = entry.get("generation")
        if pinned in (None, "current"):
            continue
        actual = observed.disk_generations.get(machine)
        if actual is not None and actual != pinned:
            divergences.append(Divergence(
                "generation", machine, pinned, actual,
            ))

    # precision: the artifact's built rung must match the declared one.
    # Explicit spec pins first; the layout plan's chosen rungs fill the
    # gaps (spec-vs-plan ownership boundary: a machine the operator
    # pinned is NEVER re-rung by a plan). Machines gone from the disk
    # index are skipped — a stale plan degrades, it never wedges.
    plan_precisions = (
        (spec.layout or {}).get("precision") or {}
    )
    for machine in sorted(
        set(spec.machines) | set(plan_precisions)
    ):
        entry = spec.machines.get(machine) or {}
        rung = entry.get("precision")
        source = "spec"
        if rung is None:
            rung = plan_precisions.get(machine)
            source = "layout"
        if rung is None:
            continue
        actual = observed.disk_precisions.get(machine)
        if actual is not None and actual != rung:
            divergences.append(Divergence(
                "precision", machine, rung, actual,
                {"source": source},
            ))

    # adoption: every ready worker must serve what disk CURRENT says
    for worker in sorted(observed.workers_ready):
        served = observed.worker_generations.get(worker)
        if not served:
            continue
        stale: Dict[str, str] = {}
        actual: Dict[str, Optional[str]] = {}
        for machine, disk_gen in sorted(observed.disk_generations.items()):
            if disk_gen is None:
                continue
            worker_gen = served.get(machine)
            if worker_gen is not None and worker_gen != disk_gen:
                stale[machine] = disk_gen
                actual[machine] = worker_gen
        if stale:
            divergences.append(Divergence(
                "adoption", worker, stale, actual,
            ))

    # mesh: declared shard count vs the live layout
    if (
        spec.mesh_shards is not None
        and observed.mesh_shards is not None
        and spec.mesh_shards != observed.mesh_shards
    ):
        divergences.append(Divergence(
            "mesh", "layout", spec.mesh_shards, observed.mesh_shards,
        ))

    # layout: the committed plan's ring weights and per-worker
    # application fingerprints. Plan entries for workers that left the
    # fleet are DROPPED from the desired state (degrade, never wedge);
    # with no plan committed, lingering weights/fingerprints diverge
    # toward empty — which is exactly how `gordo fleet rollback`
    # converges a plan away.
    plan = spec.layout
    ready = set(observed.workers_ready)
    if plan is not None:
        desired_weights = {
            worker: round(float(weight), 6)
            for worker, weight in (plan.get("weights") or {}).items()
            if worker in ready and float(weight) != 1.0
        }
    else:
        desired_weights = {}
    actual_weights = {
        worker: round(float(weight), 6)
        for worker, weight in observed.placement_weights.items()
        if float(weight) != 1.0
    }
    if (plan is not None or actual_weights) and (
        desired_weights != actual_weights
    ):
        divergences.append(Divergence(
            "layout", "weights", desired_weights, actual_weights,
        ))
    fingerprint = plan.get("fingerprint") if plan is not None else None
    for worker in sorted(ready):
        actual_fp = observed.worker_layouts.get(worker)
        if fingerprint is not None and actual_fp != fingerprint:
            divergences.append(Divergence(
                "layout", worker, fingerprint, actual_fp,
                {"action": "apply"},
            ))
        elif fingerprint is None and actual_fp is not None:
            divergences.append(Divergence(
                "layout", worker, None, actual_fp,
                {"action": "clear"},
            ))

    order = {cls: index for index, cls in enumerate(CLASSES)}
    divergences.sort(key=lambda d: (order[d.cls], d.target))
    return divergences


class _WAL:
    """The reconciler's step ledger: fsync-per-append JSONL, torn-tail
    tolerant replay to ``{key: last_record}``. Only ever touched under
    the reconciler's lock."""

    def __init__(self, path: str, clock: Callable[[], float]):
        self.path = path
        self._clock = clock

    def replay(self) -> Dict[str, Dict[str, Any]]:
        states: Dict[str, Dict[str, Any]] = {}
        if not os.path.isfile(self.path):
            return states
        try:
            with open(self.path) as fh:
                lines = fh.readlines()
        except OSError as exc:
            logger.warning("Reconcile WAL unreadable: %s", exc)
            return states
        for i, line in enumerate(lines):
            line = line.strip()
            if not line:
                continue
            try:
                record = json.loads(line)
            except ValueError:
                level = logging.INFO if i == len(lines) - 1 else logging.WARNING
                logger.log(level, "Reconcile WAL %s: dropping line %d "
                           "(torn or unparseable)", self.path, i + 1)
                continue
            key = record.get("k")
            if isinstance(key, str) and isinstance(record.get("ev"), str):
                states[key] = record
        return states

    def append(self, key: str, cls: str, target: str, ev: str,
               revision: int, **fields: Any) -> Dict[str, Any]:
        record = {
            "k": key, "cls": cls, "target": target, "ev": ev,
            "rev": revision, "t": round(float(self._clock()), 3),
            **fields,
        }
        os.makedirs(os.path.dirname(self.path), exist_ok=True)
        with open(self.path, "a+b") as fh:
            # a crash can leave a torn (newline-less) tail; appending
            # straight after it would corrupt THIS record too
            fh.seek(0, os.SEEK_END)
            if fh.tell():
                fh.seek(-1, os.SEEK_END)
                if fh.read(1) != b"\n":
                    fh.write(b"\n")
            fh.write(
                (json.dumps(record, sort_keys=True) + "\n").encode("utf-8")
            )
            fh.flush()
            os.fsync(fh.fileno())
        return record


class Reconciler:
    """Scrape-driven spec-vs-fleet convergence over injected seams."""

    def __init__(
        self,
        spec_store: SpecStore,
        observe: Callable[[], Observed],
        seams: Optional[RepairSeams] = None,
        clock: Callable[[], float] = time.time,
        min_interval: Optional[float] = None,
        repair_budget: Optional[int] = None,
        cooldown: Optional[float] = None,
        recorder: Optional[flightrec.FlightRecorder] = None,
        history: int = 64,
    ):
        self.spec_store = spec_store
        self._observe = observe
        self.seams = seams or RepairSeams()
        self._clock = clock
        self.min_interval = (
            min_interval if min_interval is not None
            else _env_float("GORDO_FLEET_INTERVAL", 10.0)
        )
        self.repair_budget = (
            repair_budget if repair_budget is not None
            else max(1, _env_int("GORDO_FLEET_REPAIR_BUDGET", 2))
        )
        self.cooldown = (
            cooldown if cooldown is not None
            else max(0.0, _env_float("GORDO_FLEET_COOLDOWN", 30.0))
        )
        self._recorder = recorder
        self._lock = lockcheck.named_lock("fleet.reconcile")
        self._wal = _WAL(
            os.path.join(spec_store.dir, RECONCILE_JOURNAL_FILE), clock,
        )
        self._ring: "deque[Dict[str, Any]]" = deque(maxlen=history)
        self._steps: Dict[str, Dict[str, Any]] = {}
        self._class_last: Dict[str, float] = {}
        self._frozen_until: Dict[str, float] = {}
        self._key_exec: Dict[str, List[float]] = {}
        self._last_tick: Optional[float] = None
        self._last_divergence: Dict[str, int] = {}
        self.ticks = 0
        self._resumed = False

    # -- WAL resume ----------------------------------------------------------
    def _resume_locked(self) -> None:
        """Seed step states and class cooldowns from the on-disk WAL —
        a restarted reconciler must neither replay finished steps nor
        burst through cooldowns it already spent."""
        if self._resumed:
            return
        self._resumed = True
        self._steps = self._wal.replay()
        for record in self._steps.values():
            if record.get("ev") in ("applied", "failed"):
                cls = record.get("cls")
                t = record.get("t")
                if isinstance(cls, str) and isinstance(t, (int, float)):
                    self._class_last[cls] = max(
                        self._class_last.get(cls, 0.0), float(t)
                    )

    # -- evaluation ----------------------------------------------------------
    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Scrape-path entry: tick when the min interval elapsed. The
        tick is CLAIMED inside the lock so concurrent scrapes cannot
        double-tick (and double-spend the repair budget)."""
        now = self._clock() if now is None else now
        with self._lock:
            due = (
                self._last_tick is None
                or now - self._last_tick >= self.min_interval
            )
            if due:
                self._last_tick = now
        if due:
            self.tick(now)
        return due

    def tick(self, now: Optional[float] = None) -> List[Dict[str, Any]]:
        """One reconcile pass: load spec, observe, diff, repair within
        budget/cooldown/oscillation gates. Returns the journal entries
        this tick produced."""
        now = self._clock() if now is None else now
        with self._lock:
            self._last_tick = now
            self.ticks += 1
            self._resume_locked()
        _M_TICKS.inc()
        try:
            loaded = self.spec_store.current_spec()
        except SpecError as exc:
            logger.error("Reconciler: committed spec does not parse: %s", exc)
            return []
        if loaded is None:
            for cls in CLASSES:
                _M_DIVERGENCE.labels(cls).set(0.0)
            return []
        revision, spec = loaded
        if self.seams.calibrate is not None:
            try:
                self.seams.calibrate()
            except Exception:
                logger.exception("Reconciler: capacity calibration failed")
        # layout staleness: a committed plan is re-judged against
        # fresh telemetry each tick; when the seam returns a NEW plan
        # (age or rate-distribution drift crossed the knobs), it is
        # committed as a new revision — rollback-able like any other —
        # and THIS tick reconciles toward the new plan immediately.
        if (
            spec.layout is not None
            and self.seams.rederive_layout is not None
            and _env_int("GORDO_LAYOUT_REDERIVE", 1)
        ):
            try:
                fresh_plan = self.seams.rederive_layout(spec.layout)
            except Exception:
                logger.exception("Reconciler: layout re-derive failed")
                fresh_plan = None
            if fresh_plan is not None and fresh_plan.get(
                "fingerprint"
            ) != spec.layout.get("fingerprint"):
                payload = spec.to_dict()
                payload["layout"] = fresh_plan
                try:
                    new_spec = FleetSpec.parse(payload)
                    record = self.spec_store.commit(
                        new_spec, op="layout", parent=revision,
                        reason="stale layout plan re-derived",
                    )
                except SpecError as exc:
                    logger.error(
                        "Reconciler: re-derived layout plan does not "
                        "parse: %s", exc,
                    )
                else:
                    revision, spec = record["revision"], new_spec
                    logger.info(
                        "Reconciler: layout plan re-derived -> revision "
                        "%d (fingerprint %s)",
                        revision, fresh_plan.get("fingerprint"),
                    )
        try:
            observed = self._observe()
        except Exception:
            logger.exception("Reconciler: observing the fleet failed")
            return []
        default_bounds = None
        if self.seams.default_worker_bounds is not None:
            try:
                default_bounds = self.seams.default_worker_bounds()
            except Exception:
                logger.exception("Reconciler: derived worker bounds failed")
        divergences = diff_spec(spec, observed, default_bounds)
        counts: Dict[str, int] = {cls: 0 for cls in CLASSES}
        for divergence in divergences:
            counts[divergence.cls] += 1
        for cls, count in counts.items():
            _M_DIVERGENCE.labels(cls).set(float(count))
        with self._lock:
            self._last_divergence = {
                cls: count for cls, count in counts.items() if count
            }
            return self._reconcile_locked(
                revision, spec, observed, divergences, now
            )

    # -- the repair loop -----------------------------------------------------
    def _reconcile_locked(
        self,
        revision: int,
        spec: FleetSpec,
        observed: Observed,
        divergences: List[Divergence],
        now: float,
    ) -> List[Dict[str, Any]]:
        entries: List[Dict[str, Any]] = []
        live_keys = {d.key(revision) for d in divergences}
        # resume sweep: a step left `applying` whose divergence is GONE
        # completed before the crash — recover the marker, never re-run
        for key, record in sorted(self._steps.items()):
            if (
                record.get("ev") == "applying"
                and record.get("rev") == revision
                and key not in live_keys
            ):
                self._steps[key] = self._wal.append(
                    key, record.get("cls", "?"), record.get("target", "?"),
                    "applied", revision, resumed=True,
                )
                entries.append(self._journal_locked(
                    record.get("cls", "?"), record.get("target", "?"),
                    "resumed", revision, now,
                    desired=None, actual=None,
                ))
        budget = self.repair_budget
        hold_window = max(
            self.cooldown * _OSCILLATION_HOLD_COOLDOWNS,
            self.min_interval * _OSCILLATION_HOLD_COOLDOWNS,
        )
        canary_passed = self._canary_passed_locked(revision)
        deferred = 0
        first_deferred: Optional[Divergence] = None
        for divergence in divergences:
            cls = divergence.cls
            frozen = self._frozen_until.get(cls)
            if frozen is not None and now < frozen:
                continue
            last = self._class_last.get(cls)
            if last is not None and now - last < self.cooldown:
                continue
            if budget <= 0:
                deferred += 1
                if first_deferred is None:
                    first_deferred = divergence
                continue
            # a key already `applied` whose divergence RE-APPEARED is
            # legitimate healing and executes again — but repeated
            # round-trips inside the hold window are an oscillation
            key = divergence.key(revision)
            history = self._key_exec.setdefault(key, [])
            history[:] = [t for t in history if now - t < hold_window]
            if len(history) >= 2:
                self._frozen_until[cls] = now + hold_window
                entries.append(self._journal_locked(
                    cls, divergence.target, "hold", revision, now,
                    desired=divergence.desired, actual=divergence.actual,
                    reason="oscillation_guard",
                    hold_seconds=round(hold_window, 3),
                ))
                continue
            outcome = self._execute_locked(
                divergence, key, revision, spec, observed,
                canary_passed, now,
            )
            if outcome is None:
                continue  # skipped without spending budget (busy seam)
            entries.append(self._journal_locked(
                cls, divergence.target, outcome, revision, now,
                desired=divergence.desired, actual=divergence.actual,
            ))
            if outcome == "aborted":
                # injected crash mid-apply: the tick dies here, the WAL
                # keeps the bare `applying` for the resume sweep
                break
            if outcome in ("applied", "failed", "canary_failed"):
                budget -= 1
                history.append(now)
                self._class_last[cls] = now
            if outcome == "applied" and cls == "adoption":
                canary_passed = True
            if outcome == "canary_failed":
                break  # the sweep is over; the spec just rolled back
        if deferred and first_deferred is not None:
            entries.append(self._journal_locked(
                first_deferred.cls, first_deferred.target, "deferred",
                revision, now,
                desired=self.repair_budget, actual=deferred,
                reason="repair_budget",
            ))
        return entries

    def _canary_passed_locked(self, revision: int) -> bool:
        for record in self._steps.values():
            if (
                record.get("rev") == revision
                and record.get("cls") == "adoption"
                and record.get("ev") == "applied"
            ):
                return True
        return False

    def _execute_locked(
        self,
        divergence: Divergence,
        key: str,
        revision: int,
        spec: FleetSpec,
        observed: Observed,
        canary_passed: bool,
        now: float,
    ) -> Optional[str]:
        """Run one repair step through its seam, WAL-bracketed. Returns
        the journal outcome, or None for a no-cost skip."""
        cls, target = divergence.cls, divergence.target
        seam_missing = {
            "bounds": self.seams.set_worker_bounds is None,
            "workers": (
                self.seams.respawn is None
                if divergence.detail.get("action") == "respawn"
                else self.seams.scale is None
            ),
            "generation": self.seams.pin_generation is None,
            "precision": self.seams.rebuild is None,
            "adoption": self.seams.reload_worker is None,
            "mesh": self.seams.mesh_refresh is None,
            "layout": (
                self.seams.set_placement_weights is None
                if target == "weights"
                else self.seams.apply_worker_layout is None
            ),
        }[cls]
        if seam_missing:
            return "unwired"
        if cls == "workers" and divergence.detail.get(
            "action"
        ) == "scale" and observed.elastic_busy:
            return None  # an op is in flight; its result is next tick's diff
        op_claimed = False
        if cls == "adoption" and self.seams.acquire_op is not None:
            if not self.seams.acquire_op():
                return None  # operator rollout in progress: never interleave
            op_claimed = True
        try:
            self._steps[key] = self._wal.append(
                key, cls, target, "applying", revision,
            )
            try:
                # the reconcile-apply fault seam: an `error` here is the
                # drill for a reconciler killed between the WAL's
                # `applying` and the repair itself
                # target is `cls/target` ("/" — a ":" would collide with
                # the fault-spec grammar's field separator)
                faults.inject("reconcile-apply", f"{cls}/{target}")
            except faults.FaultInjected:
                logger.error(
                    "Reconciler: injected crash mid-apply at %s:%s "
                    "(tick aborted; WAL holds the open step)", cls, target,
                )
                return "aborted"
            try:
                return self._apply_locked(
                    divergence, key, revision, spec, canary_passed,
                )
            except Exception as exc:
                logger.exception(
                    "Reconciler: repair %s:%s failed", cls, target,
                )
                self._steps[key] = self._wal.append(
                    key, cls, target, "failed", revision, error=repr(exc),
                )
                return "failed"
        finally:
            if op_claimed and self.seams.release_op is not None:
                self.seams.release_op()

    def _apply_locked(
        self,
        divergence: Divergence,
        key: str,
        revision: int,
        spec: FleetSpec,
        canary_passed: bool,
    ) -> str:
        cls, target = divergence.cls, divergence.target
        if cls == "bounds":
            lo, hi = divergence.desired
            self.seams.set_worker_bounds(int(lo), int(hi))
        elif cls == "workers":
            if divergence.detail.get("action") == "respawn":
                self.seams.respawn(target)
            else:
                self.seams.scale(int(divergence.detail["to"]))
        elif cls == "generation":
            self.seams.pin_generation(target, str(divergence.desired))
        elif cls == "precision":
            self.seams.rebuild(target, str(divergence.desired))
        elif cls == "adoption":
            result = self.seams.reload_worker(target) or {}
            verified: Dict[str, Any] = {"ok": bool(result.get("ok"))}
            if verified["ok"] and self.seams.verify_worker is not None:
                verified = self.seams.verify_worker(target) or {}
            if not verified.get("ok"):
                error = result.get("error") or verified.get("error")
                self._steps[key] = self._wal.append(
                    key, cls, target, "failed", revision,
                    error=str(error),
                )
                if not canary_passed:
                    # the canary rejected the sweep: journaled revert to
                    # the previous spec revision, then freeze adoption
                    # for a hold window so the re-diff settles first
                    try:
                        self.spec_store.rollback(
                            reason=f"adoption canary {target} failed: "
                                   f"{error}"
                        )
                    except SpecError as exc:
                        logger.error(
                            "Reconciler: canary failed and rollback "
                            "impossible: %s", exc,
                        )
                    self._frozen_until["adoption"] = (
                        self._clock() + max(
                            self.cooldown * _OSCILLATION_HOLD_COOLDOWNS,
                            self.min_interval,
                        )
                    )
                    return "canary_failed"
                return "failed"
            if self.seams.retune is not None:
                # autopilot/spec boundary: a reload rebuilt the worker's engine
                # from env defaults — re-assert the spec-owned tuning
                try:
                    self.seams.retune(target)
                except Exception:
                    logger.exception(
                        "Reconciler: post-reload retune of %s failed",
                        target,
                    )
        elif cls == "mesh":
            self.seams.mesh_refresh()
        elif cls == "layout":
            if target == "weights":
                self.seams.set_placement_weights(
                    dict(divergence.desired or {})
                )
            elif divergence.detail.get("action") == "clear":
                self.seams.apply_worker_layout(target, None)
            else:
                self.seams.apply_worker_layout(target, spec.layout)
        self._steps[key] = self._wal.append(
            key, cls, target, "applied", revision,
        )
        return "applied"

    # -- the three-way journal -----------------------------------------------
    def _journal_locked(
        self,
        cls: str,
        target: str,
        outcome: str,
        revision: int,
        now: float,
        desired: Any = None,
        actual: Any = None,
        **extra: Any,
    ) -> Dict[str, Any]:
        entry = {
            "at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            "tick": self.ticks,
            "class": cls,
            "target": target,
            "outcome": outcome,
            "revision": revision,
            "desired": desired,
            "actual": actual,
        }
        if extra:
            entry.update(extra)
        lockcheck.assert_guard("fleet.reconcile")
        self._ring.append(entry)
        _M_REPAIRS.labels(cls, outcome).inc()
        logger.info(
            "Reconciler: %s %s -> %s (revision %d, desired %s, actual %s)",
            cls, target, outcome, revision, desired, actual,
        )
        recorder = (
            self._recorder if self._recorder is not None
            else flightrec.RECORDER
        )
        timeline = Timeline(
            f"fleet-{cls}-{int(time.time() * 1000)}", endpoint="fleet",
        )
        timeline.add_event("fleet_repair", **entry)
        timeline.finish(status="fleet")
        try:
            recorder.record(timeline)
        except Exception:  # journaling must never break the repair loop
            logger.exception("Reconciler: flight-recorder journal failed")
        # every repair attempt is a control event (emit never raises)
        control_ledger.emit(
            actor="reconciler", action="repair",
            target=f"{cls}:{target}",
            before=actual, after=desired, reason=outcome,
            revision=revision,
        )
        return entry

    # -- views ---------------------------------------------------------------
    def diff_now(self) -> Dict[str, Any]:
        """The ``/fleet/diff`` body: a fresh spec-vs-observed diff,
        read-only — no repairs, no budget spent, no journal entries."""
        try:
            loaded = self.spec_store.current_spec()
        except SpecError as exc:
            return {
                "error": f"committed spec does not parse: {exc}",
                "divergences": [],
            }
        if loaded is None:
            return {"revision": 0, "spec": None, "divergences": []}
        revision, spec = loaded
        observed = self._observe()
        default_bounds = None
        if self.seams.default_worker_bounds is not None:
            try:
                default_bounds = self.seams.default_worker_bounds()
            except Exception:
                logger.exception("Reconciler: derived worker bounds failed")
        return {
            "revision": revision,
            "spec": spec.to_dict(),
            "divergences": [
                {
                    "class": d.cls,
                    "target": d.target,
                    "desired": d.desired,
                    "actual": d.actual,
                    "detail": d.detail,
                }
                for d in diff_spec(spec, observed, default_bounds)
            ],
        }

    def snapshot(self) -> Dict[str, Any]:
        """The ``/fleet`` body: the committed spec record, last-tick
        divergence counts, budget/cooldown posture, frozen classes, and
        the repair ring."""
        now = self._clock()
        with self._lock:
            self._resume_locked()
            frozen = {
                cls: round(until - now, 3)
                for cls, until in self._frozen_until.items()
                if until > now
            }
            cooldowns = {
                cls: round(max(0.0, self.cooldown - (now - last)), 3)
                for cls, last in self._class_last.items()
                if now - last < self.cooldown
            }
            body = {
                "enabled": True,
                "interval_s": self.min_interval,
                "repair_budget": self.repair_budget,
                "cooldown_s": self.cooldown,
                "ticks": self.ticks,
                "divergence": dict(self._last_divergence),
                "frozen": frozen,
                "cooling": cooldowns,
                "repairs": list(self._ring),
                "wal_steps": len(self._steps),
            }
        record = self.spec_store.load()
        body["spec"] = record
        body["revision"] = record["revision"] if record else 0
        return body


def disabled_snapshot() -> Dict[str, Any]:
    """What ``/fleet`` answers under the hard kill switch."""
    return {
        "enabled": False,
        "hard_off": True,
        "reason": "GORDO_FLEET=0 (hard kill switch; restart without it "
                  "to construct the reconciler)",
    }
