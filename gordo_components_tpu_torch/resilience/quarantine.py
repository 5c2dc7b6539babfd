"""Per-machine quarantine: one broken machine costs ONE machine (the port's
copy of ``gordo_components_tpu/resilience/quarantine.py``).

Every quarantine and recovery is also a control-ledger record
(``observability/ledger.py``), emitted after the lock is released.

One process serves the whole fleet, so a machine that fails to load, or
throws a non-client error while scoring, is QUARANTINED: its requests
answer 503 + ``Retry-After`` and its last error is kept, while the rest of
the fleet keeps serving. After ``cooldown`` seconds the next request is let
through as a probe: success clears the quarantine, failure re-arms the
cooldown. A machine replaced on disk recovers at once through ``/reload``.

Two tiers: **quarantined** (hard-failed, refused until a probe succeeds)
and **suspect** (deadline expiries at dispatch: still served, but named by
``/healthz``; cleared by the next success).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

from ..analysis import lockcheck
from ..observability import ledger as control_ledger
from ..observability.registry import REGISTRY

_M_EVENTS = REGISTRY.counter(
    "gordo_resilience_quarantine_events_total",
    "Machine quarantine lifecycle (quarantine / probe / recover / "
    "suspect / clear_suspect)",
    labels=("event",),
)
_M_QUARANTINED = REGISTRY.gauge(
    "gordo_resilience_quarantined_machines",
    "Machines currently quarantined (hard-failed, refusing requests)",
)


class Quarantine:
    """Thread-safe two-tier machine health ledger."""

    def __init__(self, cooldown: float = 30.0, clock=time.monotonic):
        self.cooldown = cooldown
        self._clock = clock
        self._lock = lockcheck.named_lock("resilience.quarantine")
        self._hard: Dict[str, Dict[str, Any]] = {}
        self._soft: Dict[str, Dict[str, Any]] = {}

    # -- hard quarantine -----------------------------------------------------
    def quarantine(self, name: str, error: str, phase: str) -> None:
        """Record a hard failure (``phase``: 'load' or 'score')."""
        with self._lock:
            entry = self._hard.setdefault(
                name, {"error": "", "phase": phase, "count": 0, "at": ""}
            )
            entry["error"] = error
            entry["phase"] = phase
            entry["count"] += 1
            entry["at"] = time.strftime("%Y-%m-%d %H:%M:%S%z")
            entry["_since"] = self._clock()
            _M_EVENTS.labels("quarantine").inc()
            _M_QUARANTINED.set(len(self._hard))
        # after releasing the lock: the ledger's fsync must not lengthen a
        # request path's critical section
        control_ledger.emit(
            actor="quarantine", action="quarantine", target=name,
            reason=f"{phase}: {error}",
        )

    def is_quarantined(self, name: str) -> bool:
        with self._lock:
            return name in self._hard

    def probe_allowed(self, name: str) -> bool:
        """True when the cooldown has elapsed and the caller may make ONE
        recovery probe (it re-arms the cooldown, so concurrent requests do
        not all pile onto a broken machine)."""
        with self._lock:
            entry = self._hard.get(name)
            if entry is None:
                return True
            now = self._clock()
            if now - entry["_since"] < self.cooldown:
                return False
            entry["_since"] = now
            _M_EVENTS.labels("probe").inc()
            return True

    def release_probe(self, name: str) -> None:
        """Give back a probe window whose request never exercised the
        machine (bad payload, shed, expired deadline)."""
        with self._lock:
            entry = self._hard.get(name)
            if entry is not None:
                entry["_since"] = self._clock() - self.cooldown

    def retry_after(self, name: str) -> float:
        with self._lock:
            entry = self._hard.get(name)
            if entry is None:
                return 0.0
            return max(0.0, self.cooldown - (self._clock() - entry["_since"]))

    def recover(self, name: str) -> bool:
        """Clear a hard quarantine (successful probe or fresh reload)."""
        with self._lock:
            entry = self._hard.pop(name, None)
            self._soft.pop(name, None)
            if entry is not None:
                _M_EVENTS.labels("recover").inc()
                _M_QUARANTINED.set(len(self._hard))
        if entry is not None:
            control_ledger.emit(actor="quarantine", action="recover", target=name)
        return entry is not None

    # -- soft (suspect) tier -------------------------------------------------
    def mark_suspect(self, name: str, error: str) -> None:
        with self._lock:
            if name in self._hard:
                return  # already worse than suspect
            entry = self._soft.get(name)
            if entry is None:
                entry = self._soft[name] = {"error": "", "count": 0, "at": ""}
                _M_EVENTS.labels("suspect").inc()
            entry["error"] = error
            entry["count"] += 1
            entry["at"] = time.strftime("%Y-%m-%d %H:%M:%S%z")

    def clear_suspect(self, name: str) -> None:
        with self._lock:
            if self._soft.pop(name, None) is not None:
                _M_EVENTS.labels("clear_suspect").inc()

    # -- views ---------------------------------------------------------------
    def quarantined(self) -> Dict[str, Dict[str, Any]]:
        """Hard-quarantined machines, internal clock fields stripped."""
        with self._lock:
            return {
                name: {k: v for k, v in entry.items() if not k.startswith("_")}
                for name, entry in sorted(self._hard.items())
            }

    def suspects(self) -> Dict[str, Dict[str, Any]]:
        with self._lock:
            return {name: dict(entry) for name, entry in sorted(self._soft.items())}

    def last_error(self, name: str) -> Optional[str]:
        with self._lock:
            entry = self._hard.get(name)
            return entry["error"] if entry else None
