"""The incident correlator (the port's copy of
``gordo_components_tpu/observability/incidents.py``): SLO breach edges
become durable root-cause reports.

When a burn-rate crossing fires, this module snapshots:

- every control-ledger event in a lookback window (the ledger all the
  control loops emit into);
- metric deltas from the telemetry warehouse's window queries: the recent
  window against the lookback baseline, largest movers first;
- the fleet-spec revision and layout fingerprint at breach time, where the
  caller provides them;
- a **ranked root-cause candidate list**: each ledger event scored by
  temporal proximity x target overlap x action weight, so a fault plan
  becoming active or a breaker opening outranks an autopilot decision that
  happened to land nearby.

Reports are durable JSON documents (``gordo-incident/v1``, one file per
incident, written by tmp + fsync + rename) with a bounded keep
(``GORDO_INCIDENT_KEEP``); a per-objective cooldown
(``GORDO_INCIDENT_COOLDOWN``) stops a flapping objective from writing a
report per tick. ``on_breach`` gathers from the ledger and the warehouse
without holding the correlator's lock, which guards only the report ring
and the cooldown map.
"""

from __future__ import annotations

import json
import logging
import os
import re
import time
from typing import Any, Callable, Dict, List, Optional

from ..analysis import lockcheck
from . import ledger as ledger_mod
from .registry import REGISTRY

logger = logging.getLogger(__name__)

SCHEMA = "gordo-incident/v1"

_M_REPORTS = REGISTRY.counter(
    "gordo_incident_reports_total",
    "Durable incident reports written on SLO breach edges",
)
_M_SUPPRESSED = REGISTRY.counter(
    "gordo_incident_suppressed_total",
    "Breach edges that did NOT open a report (per-objective cooldown)",
)
_M_OPEN = REGISTRY.gauge(
    "gordo_incident_reports",
    "Incident reports currently retained (bounded by "
    "GORDO_INCIDENT_KEEP)",
)

# relative blame priors per ledger action: how likely this *kind* of
# change is to break an SLO, before proximity/overlap evidence. Fault
# plans and failure-path transitions sit on top; read-mostly or
# self-reporting actions at the bottom. Unknown actions get 1.0.
ACTION_WEIGHTS: Dict[str, float] = {
    "inject-plan": 5.0,    # faults: deliberately breaking the data plane
    "breaker-open": 4.0,
    "quarantine": 4.0,
    "rollback": 3.5,       # something was already bad enough to revert
    "shed-level": 3.0,
    "apply-plan": 2.5,     # layout: residency/pins just moved
    "canary": 2.5,
    "repair": 2.0,
    "sweep": 2.0,
    "commit": 2.0,         # spec revision edge
    "clear-plan": 2.0,
    "recover": 1.5,
    "breaker-close": 1.0,
    "decision": 1.0,       # autopilot up/down/hold inside bounds
    "enable": 0.8,
    "disable": 0.8,
    "breach": 0.0,         # SLO events describe the symptom, not a cause
}

_TOKEN_RE = re.compile(r"[a-z0-9]+")


def lookback_seconds() -> float:
    """``GORDO_INCIDENT_LOOKBACK``: seconds of ledger history and
    warehouse baseline captured in each incident report."""
    try:
        return float(os.environ.get("GORDO_INCIDENT_LOOKBACK", "600"))
    except ValueError:
        return 600.0


def cooldown_seconds() -> float:
    """``GORDO_INCIDENT_COOLDOWN``: minimum seconds between reports for
    the SAME objective (a flapping burn rate writes one report, not one
    per tick)."""
    try:
        return float(os.environ.get("GORDO_INCIDENT_COOLDOWN", "120"))
    except ValueError:
        return 120.0


def keep_reports() -> int:
    """``GORDO_INCIDENT_KEEP``: newest reports retained (older report
    files are deleted with their ring entries)."""
    try:
        return max(1, int(os.environ.get("GORDO_INCIDENT_KEEP", "32")))
    except ValueError:
        return 32


def _tokens(text: str) -> set:
    return set(_TOKEN_RE.findall(str(text).lower()))


def rank_candidates(
    events: List[Dict[str, Any]],
    crossing: Dict[str, Any],
    breach_ts: float,
) -> List[Dict[str, Any]]:
    """Score every ledger event as a root-cause candidate.

    score = action_weight × temporal proximity × target overlap.
    Temporal proximity decays hyperbolically with age (an event 1 min
    old scores ~3× one 5 min old); overlap multiplies 1.5 when the
    event's target/reason shares a token with the breached objective.
    SLO breach events themselves (weight 0) never make the list.
    """
    objective_tokens = _tokens(crossing.get("objective", ""))
    candidates: List[Dict[str, Any]] = []
    for event in events:
        weight = ACTION_WEIGHTS.get(str(event.get("action")), 1.0)
        if weight <= 0.0:
            continue
        ts = event.get("ts")
        if not isinstance(ts, (int, float)) or ts > breach_ts + 1.0:
            continue
        age = max(0.0, breach_ts - ts)
        temporal = 1.0 / (1.0 + age / 60.0)
        event_tokens = (
            _tokens(event.get("target", ""))
            | _tokens(event.get("reason", ""))
            | _tokens(event.get("action", ""))
        )
        overlap = 1.5 if objective_tokens & event_tokens else 1.0
        score = weight * temporal * overlap
        candidates.append({
            "score": round(score, 4),
            "seq": event.get("seq"),
            "ts": ts,
            "actor": event.get("actor"),
            "action": event.get("action"),
            "target": event.get("target"),
            "reason": event.get("reason", ""),
            "age_s": round(age, 1),
        })
    candidates.sort(key=lambda c: (-c["score"], -(c["ts"] or 0.0)))
    return candidates


def metric_deltas(
    warehouse: Any,
    lookback: float,
    now: Optional[float] = None,
    top: int = 12,
) -> Dict[str, Any]:
    """Largest counter-rate movers: recent short window vs the full
    lookback baseline, from ONE warehouse each (its own lock, not
    ours). Degrades to an empty dict on any failure — less context is a
    degraded report, never a failed one."""
    if warehouse is None:
        return {}
    try:
        recent_w = max(30.0, lookback / 5.0)
        baseline = warehouse.window_view(lookback, now)
        recent = warehouse.window_view(recent_w, now)
        movers: List[Dict[str, Any]] = []
        base_rates = baseline.get("rates") or {}
        for name, rate in (recent.get("rates") or {}).items():
            recent_total = float(rate.get("total") or 0.0)
            base_total = float(
                (base_rates.get(name) or {}).get("total") or 0.0
            )
            if recent_total == 0.0 and base_total == 0.0:
                continue
            ratio = (
                recent_total / base_total if base_total > 0 else float("inf")
            )
            movers.append({
                "metric": name,
                "recent_rate": round(recent_total, 4),
                "baseline_rate": round(base_total, 4),
                "ratio": (
                    round(ratio, 3) if ratio != float("inf") else None
                ),
            })
        movers.sort(
            key=lambda m: -abs((m["ratio"] or 1e9) - 1.0)
        )
        return {
            "recent_window_s": recent_w,
            "baseline_window_s": lookback,
            "movers": movers[:top],
        }
    except Exception:
        logger.exception("incidents: warehouse delta query failed")
        return {}


class IncidentCorrelator:
    """Breach-edge → durable incident report, for one process.

    ``directory=None`` keeps reports memory-only (tests). Providers are
    injected callables so server and router wire their own: a telemetry
    warehouse (or None), a FleetSpec-revision callable, a layout-
    fingerprint callable.
    """

    def __init__(
        self,
        ledger: Optional[ledger_mod.ControlLedger] = None,
        directory: Optional[str] = None,
        warehouse: Any = None,
        spec_revision: Optional[Callable[[], Any]] = None,
        layout_fingerprint: Optional[Callable[[], Any]] = None,
        role: str = "",
        lookback: Optional[float] = None,
        cooldown: Optional[float] = None,
        keep: Optional[int] = None,
        wall: Callable[[], float] = time.time,
    ):
        self._ledger = ledger
        self.directory = directory
        self.warehouse = warehouse
        self.spec_revision = spec_revision
        self.layout_fingerprint = layout_fingerprint
        self.role = role
        self.lookback = lookback if lookback is not None else lookback_seconds()
        self.cooldown = cooldown if cooldown is not None else cooldown_seconds()
        self.keep = keep if keep is not None else keep_reports()
        self._wall = wall
        self._lock = lockcheck.named_lock("observability.incident")
        self._reports: List[Dict[str, Any]] = []  # oldest-first ring
        self._last_fired: Dict[str, float] = {}
        self._counter = 0
        self.suppressed = 0
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            with self._lock:
                self._reload_locked()

    # -- durability -----------------------------------------------------------
    def _report_path(self, incident_id: str) -> str:
        assert self.directory is not None
        return os.path.join(self.directory, f"incident-{incident_id}.json")

    def _reload_locked(self) -> None:
        """Reload durable reports (newest ``keep``), tolerating corrupt
        files loudly — a half-written report from a crash mid-rename
        cannot exist (atomic rename), but a truncated disk can."""
        assert self.directory is not None
        names = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith("incident-") and n.endswith(".json")
        )
        for name in names:
            path = os.path.join(self.directory, name)
            try:
                with open(path, "r") as fh:
                    report = json.load(fh)
            except (OSError, ValueError) as exc:
                logger.warning("incidents: skipping unreadable %s: %s",
                               path, exc)
                continue
            self._reports.append(report)
            self._counter = max(
                self._counter, int(report.get("n", 0)) + 1
            )
        self._reports.sort(key=lambda r: r.get("ts", 0.0))
        self._trim_locked()
        _M_OPEN.set(float(len(self._reports)))

    def _write_report(self, report: Dict[str, Any]) -> None:
        if self.directory is None:
            return
        path = self._report_path(report["id"])
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump(report, fh, separators=(",", ":"))
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, path)

    def _trim_locked(self) -> None:
        while len(self._reports) > self.keep:
            oldest = self._reports.pop(0)
            if self.directory is not None:
                try:
                    os.unlink(self._report_path(oldest["id"]))
                except OSError:
                    pass

    # -- the breach hook ------------------------------------------------------
    def on_breach(
        self, crossing: Dict[str, Any], now: Optional[float] = None
    ) -> Optional[Dict[str, Any]]:
        """SLOEvaluator breach-edge hook. NEVER raises into the SLO
        tick; returns the report (or None when suppressed/failed)."""
        try:
            return self._on_breach(crossing, now)
        except Exception:
            logger.exception("incidents: report for %s failed", crossing)
            return None

    def _on_breach(
        self, crossing: Dict[str, Any], now: Optional[float]
    ) -> Optional[Dict[str, Any]]:
        now = self._wall() if now is None else now
        objective = str(crossing.get("objective", ""))
        with self._lock:
            lockcheck.assert_guard("observability.incident")
            last = self._last_fired.get(objective)
            if last is not None and now - last < self.cooldown:
                self.suppressed += 1
                _M_SUPPRESSED.inc()
                return None
            # claim the slot BEFORE the (slow) gather, so a concurrent
            # breach of the same objective cannot double-report
            self._last_fired[objective] = now
            self._counter += 1
            n = self._counter
        # gather lock-free: each provider takes its own lock
        ledger = self._ledger if self._ledger is not None else ledger_mod.LEDGER
        events = ledger.recent(window=self.lookback, now=now)
        candidates = rank_candidates(events, crossing, now)
        deltas = metric_deltas(self.warehouse, self.lookback, now)
        revision = None
        if self.spec_revision is not None:
            try:
                revision = self.spec_revision()
            except Exception:
                logger.exception("incidents: spec revision probe failed")
        layout = None
        if self.layout_fingerprint is not None:
            try:
                layout = self.layout_fingerprint()
            except Exception:
                logger.exception("incidents: layout probe failed")
        incident_id = "{}-{:04d}".format(int(now), n)
        report = {
            "schema": SCHEMA,
            "id": incident_id,
            "n": n,
            "ts": round(now, 3),
            "role": self.role,
            "trigger": dict(crossing),
            "lookback_s": self.lookback,
            "spec_revision": revision,
            "layout": layout,
            "events": events,
            "candidates": candidates,
            "metric_deltas": deltas,
        }
        self._write_report(report)
        with self._lock:
            self._reports.append(report)
            self._trim_locked()
            retained = len(self._reports)
        _M_REPORTS.inc()
        _M_OPEN.set(float(retained))
        top = candidates[0] if candidates else None
        logger.warning(
            "INCIDENT %s: %s/%s burn breach — top candidate: %s",
            incident_id, objective, crossing.get("window"),
            ("{actor}/{action} {target} (score {score})".format(**top)
             if top else "none"),
        )
        return report

    # -- queries --------------------------------------------------------------
    @staticmethod
    def summarize(report: Dict[str, Any]) -> Dict[str, Any]:
        top = (report.get("candidates") or [None])[0]
        return {
            "id": report.get("id"),
            "ts": report.get("ts"),
            "role": report.get("role", ""),
            "objective": (report.get("trigger") or {}).get("objective"),
            "window": (report.get("trigger") or {}).get("window"),
            "burn_rate": (report.get("trigger") or {}).get("burn_rate"),
            "events": len(report.get("events") or ()),
            "top_candidate": top,
        }

    def list(self) -> List[Dict[str, Any]]:
        """Newest-first summaries."""
        with self._lock:
            reports = list(self._reports)
        return [self.summarize(r) for r in reversed(reports)]

    def get(self, incident_id: str) -> Optional[Dict[str, Any]]:
        with self._lock:
            for report in self._reports:
                if report.get("id") == incident_id:
                    return report
        return None

    def snapshot(self) -> Dict[str, Any]:
        with self._lock:
            return {
                "enabled": True,
                "durable": self.directory is not None,
                "reports": len(self._reports),
                "suppressed": self.suppressed,
                "lookback_s": self.lookback,
                "cooldown_s": self.cooldown,
                "keep": self.keep,
            }
