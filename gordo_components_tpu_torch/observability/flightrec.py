"""Flight recorder: a bounded buffer of completed request timelines (the
port's copy of ``gordo_components_tpu/observability/flightrec.py``).

When an operator asks why trace 3f2a... took 900 ms, the histograms have
averaged the answer away. The recorder keeps (1) a ring of the last
``keep`` completed timelines, (2) a reservoir of the ``slow_keep`` slowest
requests since boot, and (3) a ring of the last ``error_keep`` errored or
shed requests, so a burst of fast healthy traffic never flushes the one
pathological trace out of memory. Everything is bounded: at the defaults
(256 + 32 + 64 timelines) well under a megabyte whatever the uptime.

``GORDO_FLIGHTREC=0`` disables recording (then the server binds no
timeline at all); ``GORDO_FLIGHTREC_KEEP`` / ``_SLOW_KEEP`` /
``_ERROR_KEEP`` size the buffers.
"""

from __future__ import annotations

import os
from collections import deque
from typing import Any, Dict, List, Optional

from ..analysis import lockcheck
from .spans import Timeline


def _env_int(name: str, default: int) -> int:
    try:
        return max(1, int(os.environ.get(name, default)))
    except (TypeError, ValueError):
        return default


class FlightRecorder:
    def __init__(
        self,
        keep: Optional[int] = None,
        slow_keep: Optional[int] = None,
        error_keep: Optional[int] = None,
        enabled: Optional[bool] = None,
    ):
        self.keep = keep if keep is not None else _env_int(
            "GORDO_FLIGHTREC_KEEP", 256
        )
        self.slow_keep = slow_keep if slow_keep is not None else _env_int(
            "GORDO_FLIGHTREC_SLOW_KEEP", 32
        )
        self.error_keep = error_keep if error_keep is not None else _env_int(
            "GORDO_FLIGHTREC_ERROR_KEEP", 64
        )
        self._enabled = (
            enabled
            if enabled is not None
            else os.environ.get("GORDO_FLIGHTREC", "1") != "0"
        )
        self._lock = lockcheck.named_lock("observability.flightrec")
        self._ring: "deque[Timeline]" = deque(maxlen=self.keep)
        # slowest-since-boot reservoir, kept sorted ascending by duration
        # (insertion is bisect-free: slow_keep is tiny)
        self._slow: List[Timeline] = []
        self._errors: "deque[Timeline]" = deque(maxlen=self.error_keep)
        self.recorded = 0

    # -- enablement ----------------------------------------------------------
    @property
    def enabled(self) -> bool:
        return self._enabled

    def set_enabled(self, enabled: bool) -> None:
        """Runtime toggle (perf comparisons, tests). Does not clear."""
        self._enabled = bool(enabled)

    # -- recording -----------------------------------------------------------
    def record(self, timeline: Timeline) -> None:
        if not self._enabled:
            return
        if timeline.finished is None:
            timeline.finish()
        duration = timeline.duration
        with self._lock:
            self.recorded += 1
            self._ring.append(timeline)
            if timeline.error:
                self._errors.append(timeline)
            if len(self._slow) < self.slow_keep:
                self._slow.append(timeline)
                self._slow.sort(key=lambda t: t.duration)
            elif self._slow and duration > self._slow[0].duration:
                self._slow[0] = timeline
                self._slow.sort(key=lambda t: t.duration)

    # -- views ---------------------------------------------------------------
    def _all(self) -> List[Timeline]:
        """Ring + reservoirs, deduped by identity, newest ring entries
        first (callers hold no lock; the copies are taken under it)."""
        with self._lock:
            ring = list(self._ring)
            slow = list(self._slow)
            errors = list(self._errors)
        seen: set = set()
        out: List[Timeline] = []
        for timeline in reversed(ring):
            if id(timeline) not in seen:
                seen.add(id(timeline))
                out.append(timeline)
        for timeline in sorted(slow, key=lambda t: -t.duration) + list(errors):
            if id(timeline) not in seen:
                seen.add(id(timeline))
                out.append(timeline)
        return out

    def get(self, trace_id: str) -> Optional[Timeline]:
        for timeline in self._all():
            if timeline.trace_id == trace_id:
                return timeline
        return None

    def slowest(self) -> Optional[Timeline]:
        with self._lock:
            return self._slow[-1] if self._slow else None

    def summaries(self, limit: int = 50) -> Dict[str, Any]:
        """The /debug/requests body: recent rows, the slow reservoir, and
        recent errors — each a :meth:`Timeline.summary` dict."""
        with self._lock:
            ring = list(self._ring)
            slow = list(self._slow)
            errors = list(self._errors)
            recorded = self.recorded
        slowest = slow[-1] if slow else None
        limit = max(0, limit)
        # limit bounds ALL three views: a watchman polling ?limit=1 per
        # status tick must not make the server serialize the full slow +
        # error reservoirs (~100 summary builds) just to read "slowest"
        return {
            "enabled": self._enabled,
            "recorded": recorded,
            "kept": len(ring),
            "slowest": slowest.summary() if slowest is not None else None,
            "requests": [
                t.summary() for t in list(reversed(ring))[:limit]
            ],
            "slow": [t.summary() for t in sorted(
                slow, key=lambda t: -t.duration
            )[:limit]],
            "errors": [t.summary() for t in list(reversed(errors))[:limit]],
        }

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()
            self._slow.clear()
            self._errors.clear()
            self.recorded = 0


# THE process-wide recorder (like observability.REGISTRY): the server
# records into it, /debug/requests reads from it, tests may clear() it.
RECORDER = FlightRecorder()
