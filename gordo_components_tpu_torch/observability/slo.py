"""The SLO engine (the port's copy of
``gordo_components_tpu/observability/slo.py``): declared objectives,
evaluated by multi-window burn rate.

- An :class:`Objective` declares a **latency** target ("99 % of scoring
  requests under 250 ms", read from the request histogram's buckets; the
  threshold snaps to the nearest bucket bound, reported as
  ``effective_threshold_s``) or an **availability** target (an error ratio,
  read from status-labeled counters).
- The :class:`SLOEvaluator` keeps a bounded ring of cumulative ``(t, good,
  total)`` samples per objective and computes the **burn rate**, bad ratio
  over error budget, on a fast (~5 min) and a slow (~1 h) window. Burn 1.0
  spends exactly the budget; the thresholds (fast 14.4, slow 6) page on a
  budget gone in hours, not on one slow request.
- Every evaluation publishes ``gordo_slo_*`` series into the registry the
  raw signal lives in. A threshold CROSSING (an edge, not a level)
  increments ``gordo_slo_breaches_total``, records a synthetic errored
  timeline into the flight recorder, writes an ``slo``/``breach`` event
  to the control ledger and calls ``breach_hook`` (the incident
  correlator).
- :func:`attribute_stages` says which span stage ate the budget: over the
  recorder's violating requests, each leaf stage's share of stage time.

Evaluation is scrape-driven: ``maybe_tick`` runs on ``/metrics`` and
``/slo`` reads, gated by a minimum interval; no thread. The clock is
injectable end to end.
"""

from __future__ import annotations

import logging
import math
import os
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional, Tuple

from ..analysis import lockcheck
from . import flightrec
from . import ledger as control_ledger
from .registry import REGISTRY, Histogram, Registry
from .spans import Timeline

logger = logging.getLogger(__name__)

_M_ATTAINMENT = REGISTRY.gauge(
    "gordo_slo_attainment",
    "Good-event fraction since boot per objective (1.0 = every request "
    "met the objective)",
    labels=("name",),
)
_M_TARGET = REGISTRY.gauge(
    "gordo_slo_target",
    "Declared good-event-fraction objective (the SLO itself)",
    labels=("name",),
)
_M_BURN_RATE = REGISTRY.gauge(
    "gordo_slo_burn_rate",
    "Error-budget burn rate per objective and window (1.0 = spending "
    "exactly the declared budget; fast/slow window sizes are knobs)",
    labels=("name", "window"),
)
_M_BREACHES = REGISTRY.counter(
    "gordo_slo_breaches_total",
    "Burn-rate threshold CROSSINGS (edge-triggered) per objective and "
    "window — each one also lands in the flight recorder",
    labels=("name", "window"),
)


def _env_float(name: str, default: float) -> float:
    try:
        return float(os.environ.get(name, default))
    except (TypeError, ValueError):
        return default


def enabled() -> bool:
    """GORDO_SLO=0 disables the evaluator (endpoints answer disabled)."""
    return os.environ.get("GORDO_SLO", "1").strip().lower() not in (
        "0", "false", "off", "no",
    )


@dataclass(frozen=True)
class Objective:
    """One declared objective over already-collected registry series.

    ``kind="latency"``: ``metric`` names a histogram; good events are
    observations ≤ ``threshold_s`` (snapped to a bucket bound) in series
    matching ``label_filter``.

    ``kind="availability"``: good = ``metric``/``label_filter`` counter
    sum minus ``bad_filter``-matching counts of ``bad_metric`` (default:
    same family); total = all ``label_filter`` matches (plus the bad
    family's matches when it is a different family).

    Filter values: exact string, tuple/set of options, or a predicate
    callable — enough to say ``status startswith "5"`` declaratively in
    code without a mini-language.
    """

    name: str
    kind: str                      # "latency" | "availability"
    metric: str
    target: float                  # good fraction objective in (0, 1]
    threshold_s: Optional[float] = None
    label_filter: Optional[Dict[str, Any]] = None
    bad_metric: Optional[str] = None
    bad_filter: Optional[Dict[str, Any]] = None
    description: str = ""


def _value_matches(have: str, want: Any) -> bool:
    if callable(want):
        return bool(want(have))
    if isinstance(want, (tuple, list, set, frozenset)):
        return have in want
    return have == str(want)


def _matches(
    labelnames: Tuple[str, ...],
    values: Tuple[str, ...],
    label_filter: Optional[Dict[str, Any]],
) -> bool:
    if not label_filter:
        return True
    labels = dict(zip(labelnames, values))
    for key, want in label_filter.items():
        have = labels.get(key)
        if have is None or not _value_matches(have, want):
            return False
    return True


class SLOEvaluator:
    """Windowed burn-rate evaluation over a registry's cumulative series.

    One instance per process role (server / router), sharing the
    process registry. ``clock`` is any monotonic float source — tests
    inject a fake; ``recorder`` defaults to the process flight recorder.
    """

    def __init__(
        self,
        objectives: List[Objective],
        registry: Registry = REGISTRY,
        fast_window: Optional[float] = None,
        slow_window: Optional[float] = None,
        fast_burn: Optional[float] = None,
        slow_burn: Optional[float] = None,
        min_interval: Optional[float] = None,
        clock: Callable[[], float] = time.monotonic,
        recorder: Optional[flightrec.FlightRecorder] = None,
        breach_hook: Optional[Callable[[Dict[str, Any]], Any]] = None,
    ):
        self.objectives = list(objectives)
        self.registry = registry
        self.fast_window = (
            fast_window if fast_window is not None
            else _env_float("GORDO_SLO_FAST_WINDOW", 300.0)
        )
        self.slow_window = (
            slow_window if slow_window is not None
            else _env_float("GORDO_SLO_SLOW_WINDOW", 3600.0)
        )
        self.fast_burn = (
            fast_burn if fast_burn is not None
            else _env_float("GORDO_SLO_FAST_BURN", 14.4)
        )
        self.slow_burn = (
            slow_burn if slow_burn is not None
            else _env_float("GORDO_SLO_SLOW_BURN", 6.0)
        )
        self.min_interval = (
            min_interval if min_interval is not None
            else _env_float("GORDO_SLO_EVAL_INTERVAL", 10.0)
        )
        self._clock = clock
        self._recorder = recorder
        # called once per breach EDGE with the crossing dict —
        # the incident correlator's entry point (set post-construction
        # by server/router wiring; never called under the SLO lock)
        self.breach_hook = breach_hook
        self._lock = lockcheck.named_lock("observability.slo")
        # per objective: ring of (t, good, total) cumulative samples,
        # pruned past the slow window — bounded by construction
        self._history: Dict[str, List[Tuple[float, float, float]]] = {
            objective.name: [] for objective in self.objectives
        }
        self._last_tick: Optional[float] = None
        self._breached: Dict[Tuple[str, str], bool] = {}
        self._breach_counts: Dict[Tuple[str, str], int] = {}
        self.ticks = 0
        for objective in self.objectives:
            _M_TARGET.labels(objective.name).set(objective.target)
        # baseline sample: burn rates are deltas, and the first tick
        # needs something to delta against
        self.tick()

    # -- cumulative totals off the registry ----------------------------------
    def _metric(self, name: str):
        for metric in self.registry.metrics():
            if metric.name == name:
                return metric
        return None

    def _latency_totals(self, objective: Objective) -> Tuple[float, float]:
        metric = self._metric(objective.metric)
        if not isinstance(metric, Histogram):
            return 0.0, 0.0
        good = total = 0.0
        threshold = objective.threshold_s or 0.0
        for values, data in metric.collect().items():
            if not _matches(
                metric.labelnames, values, objective.label_filter
            ):
                continue
            cumulative = 0.0
            for le, cum in data["buckets"]:
                if le >= threshold - 1e-12:
                    cumulative = cum
                    break
            good += cumulative
            total += data["count"]
        return good, total

    def effective_threshold(self, objective: Objective) -> Optional[float]:
        """The bucket bound the threshold snapped UP to (counts below it
        are observable; anything between it and the raw threshold is
        not) — reported so the objective is honest about its resolution."""
        metric = self._metric(objective.metric)
        if not isinstance(metric, Histogram) or objective.threshold_s is None:
            return objective.threshold_s
        for le in metric.buckets:
            if le >= objective.threshold_s - 1e-12:
                return None if math.isinf(le) else le
        return None

    def _availability_totals(
        self, objective: Objective
    ) -> Tuple[float, float]:
        metric = self._metric(objective.metric)
        if metric is None:
            return 0.0, 0.0
        base = 0.0
        for values, value in metric.collect().items():
            if _matches(metric.labelnames, values, objective.label_filter):
                base += value
        bad_name = objective.bad_metric or objective.metric
        bad_metric = self._metric(bad_name)
        bad = 0.0
        if bad_metric is not None:
            for values, value in bad_metric.collect().items():
                if _matches(
                    bad_metric.labelnames, values, objective.bad_filter
                ):
                    bad += value
        if bad_name == objective.metric:
            # bad is a SUBSET of the base counts
            total = base
            good = max(0.0, base - bad)
        else:
            # separate failure family (e.g. unroutable): base counts are
            # the good ones, the other family adds the bad
            total = base + bad
            good = base
        return good, total

    def _totals(self, objective: Objective) -> Tuple[float, float]:
        if objective.kind == "latency":
            return self._latency_totals(objective)
        return self._availability_totals(objective)

    # -- evaluation ----------------------------------------------------------
    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Scrape-path entry: tick when ``min_interval`` has elapsed."""
        now = self._clock() if now is None else now
        with self._lock:
            due = (
                self._last_tick is None
                or now - self._last_tick >= self.min_interval
            )
        if due:
            self.tick(now)
        return due

    def tick(self, now: Optional[float] = None) -> Dict[str, Any]:
        """One evaluation: sample cumulative totals, compute windowed
        burn rates, publish gauges, fire edge-triggered crossings."""
        now = self._clock() if now is None else now
        crossings: List[Dict[str, Any]] = []
        with self._lock:
            lockcheck.assert_guard("observability.slo")
            self._last_tick = now
            self.ticks += 1
            for objective in self.objectives:
                good, total = self._totals(objective)
                history = self._history[objective.name]
                history.append((now, good, total))
                horizon = now - self.slow_window * 1.5
                while len(history) > 1 and history[0][0] < horizon:
                    history.pop(0)
                attainment = good / total if total > 0 else 1.0
                _M_ATTAINMENT.labels(objective.name).set(attainment)
                for window_name, window, threshold in (
                    ("fast", self.fast_window, self.fast_burn),
                    ("slow", self.slow_window, self.slow_burn),
                ):
                    burn = self._burn_locked(objective, window, now)
                    _M_BURN_RATE.labels(
                        objective.name, window_name
                    ).set(burn)
                    key = (objective.name, window_name)
                    above = burn >= threshold
                    if above and not self._breached.get(key, False):
                        self._breach_counts[key] = (
                            self._breach_counts.get(key, 0) + 1
                        )
                        _M_BREACHES.labels(*key).inc()
                        crossings.append({
                            "objective": objective.name,
                            "window": window_name,
                            "burn_rate": round(burn, 3),
                            "threshold": threshold,
                        })
                    self._breached[key] = above
        for crossing in crossings:
            self._record_crossing(crossing)
            # the breach edge itself is a control event (outside
            # the SLO lock — the ledger fsyncs), then the incident
            # correlator snapshots its report
            control_ledger.emit(
                actor="slo", action="breach",
                target=crossing["objective"],
                after={"burn_rate": crossing["burn_rate"],
                       "window": crossing["window"]},
                reason="burn {} >= {} ({} window)".format(
                    crossing["burn_rate"], crossing["threshold"],
                    crossing["window"],
                ),
            )
            if self.breach_hook is not None:
                try:
                    self.breach_hook(crossing)
                except Exception:
                    logger.exception(
                        "slo: breach hook failed for %s", crossing
                    )
        return {"ticks": self.ticks, "crossings": crossings}

    def _burn_locked(
        self, objective: Objective, window: float, now: float
    ) -> float:
        """Burn rate = bad-ratio over the window ÷ error budget. The
        window's baseline is the OLDEST sample still inside it (short
        uptimes measure what they have, like Prometheus's increase())."""
        history = self._history[objective.name]
        if not history:
            return 0.0
        start = now - window
        # baseline = the newest sample at-or-before the window start
        # (Prometheus increase() semantics); all-inside-window uptimes
        # fall back to the oldest sample — measure what exists
        baseline = history[0]
        for sample in history:
            if sample[0] <= start + 1e-9:
                baseline = sample
            else:
                break
        good_now, total_now = history[-1][1], history[-1][2]
        delta_total = total_now - baseline[2]
        if delta_total <= 0:
            return 0.0
        delta_good = good_now - baseline[1]
        bad_ratio = min(1.0, max(0.0, 1.0 - delta_good / delta_total))
        budget = 1.0 - objective.target
        if budget <= 0:
            return math.inf if bad_ratio > 0 else 0.0
        return bad_ratio / budget

    def _record_crossing(self, crossing: Dict[str, Any]) -> None:
        recorder = (
            self._recorder
            if self._recorder is not None
            else flightrec.RECORDER
        )
        logger.warning(
            "SLO burn-rate crossing: objective %(objective)s %(window)s "
            "window at %(burn_rate).1fx (threshold %(threshold).1fx)",
            crossing,
        )
        # synthetic errored timeline: the crossing shows up in
        # /debug/requests' error ring next to the requests that burned
        # the budget, and survives fast healthy traffic (error ring)
        timeline = Timeline(
            f"slo-{crossing['objective']}-{crossing['window']}"
            f"-{int(time.time() * 1000)}",
            endpoint="slo",
        )
        timeline.add_event("slo_burn_crossing", **crossing)
        timeline.finish(
            status="slo_breach",
            error=(
                f"SLO {crossing['objective']}: {crossing['window']}-window "
                f"burn {crossing['burn_rate']}x >= "
                f"{crossing['threshold']}x"
            ),
        )
        recorder.record(timeline)

    # -- views ---------------------------------------------------------------
    def burn_snapshot(
        self, now: Optional[float] = None
    ) -> Dict[str, Dict[str, Any]]:
        """Lightweight per-objective burn view for programmatic consumers
        (the autopilot's signals layer): fast/slow window burn and
        since-boot attainment, no recorder scan, no attribution."""
        now = self._clock() if now is None else now
        out: Dict[str, Dict[str, Any]] = {}
        with self._lock:
            for objective in self.objectives:
                history = self._history[objective.name]
                good, total = (
                    (history[-1][1], history[-1][2])
                    if history else (0.0, 0.0)
                )
                out[objective.name] = {
                    "kind": objective.kind,
                    "fast": self._burn_locked(
                        objective, self.fast_window, now
                    ),
                    "slow": self._burn_locked(
                        objective, self.slow_window, now
                    ),
                    "attainment": good / total if total > 0 else None,
                }
        return out

    def snapshot(
        self, recorder: Optional[flightrec.FlightRecorder] = None
    ) -> Dict[str, Any]:
        """The ``/slo`` body: per-objective attainment, windowed burn
        rates, breach counts — plus per-stage budget attribution when a
        recorder is available."""
        now = self._clock()
        out: Dict[str, Any] = {
            "enabled": True,
            "ticks": self.ticks,
            "windows": {
                "fast": {
                    "seconds": self.fast_window,
                    "burn_threshold": self.fast_burn,
                },
                "slow": {
                    "seconds": self.slow_window,
                    "burn_threshold": self.slow_burn,
                },
            },
            "objectives": [],
        }
        with self._lock:
            for objective in self.objectives:
                history = self._history[objective.name]
                good, total = (
                    (history[-1][1], history[-1][2])
                    if history else (0.0, 0.0)
                )
                windows = {}
                for window_name, window, threshold in (
                    ("fast", self.fast_window, self.fast_burn),
                    ("slow", self.slow_window, self.slow_burn),
                ):
                    burn = self._burn_locked(objective, window, now)
                    key = (objective.name, window_name)
                    windows[window_name] = {
                        "burn_rate": round(burn, 4),
                        "breached": self._breached.get(key, False),
                        "breaches": self._breach_counts.get(key, 0),
                    }
                entry = {
                    "name": objective.name,
                    "kind": objective.kind,
                    "metric": objective.metric,
                    "target": objective.target,
                    "attainment": (
                        round(good / total, 6) if total > 0 else None
                    ),
                    "good": good,
                    "total": total,
                    "windows": windows,
                    "description": objective.description,
                }
                if objective.kind == "latency":
                    entry["threshold_s"] = objective.threshold_s
                    entry["effective_threshold_s"] = (
                        self.effective_threshold(objective)
                    )
                out["objectives"].append(entry)
        recorder = (
            recorder if recorder is not None else self._recorder
        ) or flightrec.RECORDER
        out["attribution"] = {
            objective.name: attribute_stages(recorder, objective)
            for objective in self.objectives
            if objective.kind == "latency"
        }
        return out


# parent stages contain their children's time — attributing to them
# would always blame the wrapper (same rule as Timeline.dominant_stage,
# route included once stitching makes it a parent)
_PARENT_STAGES = ("score", "route")


def _row_in_objective(row: Dict[str, Any], objective: Objective) -> bool:
    """Whether a recorded-request summary row is the kind of traffic the
    objective declares over — without this, a deliberately-slow /reload
    sitting in the slow reservoir would count as a latency violation
    forever. ``endpoint`` filters match the row's endpoint meta; a
    ``stage`` filter requires the named stage in the row's timeline
    (the router's route objective)."""
    for key, want in (objective.label_filter or {}).items():
        if key == "stage":
            stages = row.get("stages_ms") or {}
            if not any(_value_matches(name, want) for name in stages):
                return False
            continue
        if not _value_matches(str(row.get(key, "")), want):
            return False
    return True


def attribute_stages(
    recorder: flightrec.FlightRecorder, objective: Objective
) -> Dict[str, Any]:
    """Which span stage ate the SLO: over the recorder's requests that
    VIOLATED the latency objective, each leaf stage's share of total
    stage time. The flight recorder's slow reservoir makes this robust
    to ring churn — the pathological traces are exactly the kept ones."""
    if objective.threshold_s is None:
        return {"violations": 0, "stages": {}}
    threshold_ms = objective.threshold_s * 1000.0
    rows = recorder.summaries(limit=100)
    seen = set()
    totals: Dict[str, float] = {}
    violations = 0
    for row in rows.get("requests", []) + rows.get("slow", []):
        trace_id = row.get("trace_id")
        if trace_id in seen:
            continue
        seen.add(trace_id)
        if row.get("duration_ms", 0.0) <= threshold_ms:
            continue
        if not _row_in_objective(row, objective):
            continue
        violations += 1
        for stage_name, ms in (row.get("stages_ms") or {}).items():
            if stage_name in _PARENT_STAGES:
                continue
            totals[stage_name] = totals.get(stage_name, 0.0) + ms
    grand = sum(totals.values())
    stages = {
        name: {
            "ms": round(ms, 3),
            "share": round(ms / grand, 4) if grand > 0 else 0.0,
        }
        for name, ms in sorted(
            totals.items(), key=lambda kv: -kv[1]
        )
    }
    dominant = next(iter(stages), None)
    return {
        "violations": violations,
        "dominant_stage": dominant,
        "stages": stages,
    }


# -- default objective sets ---------------------------------------------------


def latency_knobs() -> Tuple[float, float]:
    """``(threshold_seconds, target_fraction)`` as the knobs resolve —
    THE one place the latency-objective defaults live (bench history
    rows and custom objective builders read these instead of
    re-hardcoding the literals)."""
    threshold_s = _env_float("GORDO_SLO_LATENCY_MS", 250.0) / 1000.0
    target = _env_float("GORDO_SLO_LATENCY_TARGET", 0.99)
    return threshold_s, target


def availability_target() -> float:
    return _env_float("GORDO_SLO_AVAILABILITY_TARGET", 0.999)


def knob_summary() -> Dict[str, Any]:
    """The resolved GORDO_SLO_* knob values, for effective-env blocks."""
    threshold_s, target = latency_knobs()
    return {
        "enabled": enabled(),
        "latency_ms": threshold_s * 1000.0,
        "latency_target": target,
        "availability_target": availability_target(),
        "fast_window": _env_float("GORDO_SLO_FAST_WINDOW", 300.0),
        "slow_window": _env_float("GORDO_SLO_SLOW_WINDOW", 3600.0),
    }


def server_objectives() -> List[Objective]:
    """The worker defaults: scoring latency + scoring availability over
    the histograms and counters the server already records."""
    threshold_s, target = latency_knobs()
    availability = availability_target()
    scoring = ("anomaly", "prediction")
    return [
        Objective(
            name="scoring-latency",
            kind="latency",
            metric="gordo_server_request_duration_seconds",
            target=target,
            threshold_s=threshold_s,
            label_filter={"endpoint": scoring},
            description=(
                f"{target:.0%} of scoring requests under "
                f"{threshold_s * 1000:.0f} ms"
            ),
        ),
        Objective(
            name="scoring-availability",
            kind="availability",
            metric="gordo_server_requests_total",
            target=availability,
            label_filter={"endpoint": scoring},
            bad_filter={
                "endpoint": scoring,
                "status": lambda status: status.startswith("5"),
            },
            description=(
                f"error ratio under {1 - availability:.2%} on scoring "
                "endpoints"
            ),
        ),
    ]


def tenant_objectives(tenants: Any = ()) -> List[Objective]:
    """Per-class and per-declared-tenant availability objectives over
    the bounded ``gordo_tenant_requests_total`` family: bad events
    are overload sheds and server errors at the admission seam — quota
    rejections are deliberately NOT bad (a tenant spending its own
    declared budget is the system working). Cardinality is bounded by
    construction: three classes plus the closed declared table.

    ``tenants`` duck-types ``qos.TenantSpec`` (``.name``/``.klass``) so
    this module never imports the resilience layer."""
    # class targets step down the ladder: bulk is the class the shed
    # actuator squeezes on purpose, so holding it to the interactive
    # availability target would page on intended behavior
    class_targets = {
        "interactive": availability_target(),
        "standard": 0.99,
        "bulk": 0.95,
    }
    bad_outcomes = ("shed", "error")
    out = [
        Objective(
            name=f"class-{klass}-availability",
            kind="availability",
            metric="gordo_tenant_requests_total",
            target=target,
            label_filter={"class": klass},
            bad_filter={"class": klass, "outcome": bad_outcomes},
            description=(
                f"shed+error ratio under {1 - target:.2%} for the "
                f"{klass} class at the admission seam"
            ),
        )
        for klass, target in class_targets.items()
    ]
    for spec in tenants:
        name = getattr(spec, "name", None)
        if not name or name == "default":
            continue
        target = class_targets.get(
            getattr(spec, "klass", "standard"), 0.99
        )
        out.append(
            Objective(
                name=f"tenant-{name}-availability",
                kind="availability",
                metric="gordo_tenant_requests_total",
                target=target,
                label_filter={"tenant": name},
                bad_filter={"tenant": name, "outcome": bad_outcomes},
                description=(
                    f"shed+error ratio under {1 - target:.2%} for "
                    f"tenant {name}"
                ),
            )
        )
    return out


def router_objectives() -> List[Objective]:
    """The router defaults: end-to-end route latency (the ``route``
    stage wraps placement + forward + re-route walks) and fleet
    routability (forwarded vs candidate-exhausted)."""
    threshold_s, target = latency_knobs()
    availability = availability_target()
    return [
        Objective(
            name="route-latency",
            kind="latency",
            metric="gordo_stage_seconds",
            target=target,
            threshold_s=threshold_s,
            label_filter={"stage": "route"},
            description=(
                f"{target:.0%} of routed requests under "
                f"{threshold_s * 1000:.0f} ms end to end"
            ),
        ),
        Objective(
            name="route-availability",
            kind="availability",
            metric="gordo_router_requests_total",
            target=availability,
            label_filter={"outcome": "ok"},
            bad_metric="gordo_router_unroutable_total",
            description=(
                f"unroutable ratio under {1 - availability:.2%}"
            ),
        ),
    ]
