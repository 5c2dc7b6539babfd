"""The autopilot's eyes (the port's copy of
``gordo_components_tpu/autopilot/signals.py``): one normalized observation
per evaluation tick.

A :class:`SignalReader` snapshots the signal plane into one flat
:class:`Observation` the policy rules read, so no rule touches a registry,
a recorder or an evaluator:

- **burn**: the largest fast and slow burn rate over the SLO evaluator's
  objectives (``SLOEvaluator.burn_snapshot``), and the worst attainment;
- **span shares**: over the flight recorder's recent requests, the share of
  stage time spent queueing (``queue_wait`` + ``admission``), on the device
  side (``dispatch`` + ``device_execute``), fetching (``fetch`` +
  ``data_fetch``) or in the megabatch fill window;
- **gate occupancy**: the admission gate's in-flight fraction and queue;
- **rate**: requests per second from a cumulative counter's delta.

Every source is an injected callable and the clock is injectable; a source
that raises reads neutral (and counts in
``gordo_autopilot_dark_sources_total``), so the controller keeps ticking.
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional

from ..observability.registry import REGISTRY, Registry

# leaf stages folded into each share (parents like ``score``/``route``
# contain their children and would always dominate — same exclusion rule
# as slo.attribute_stages)
_QUEUE_STAGES = ("queue_wait", "admission")
_DEVICE_STAGES = ("dispatch", "device_execute")
_FETCH_STAGES = ("fetch", "data_fetch", "chunk_fetch")
_FILL_STAGES = ("megabatch",)

# a raising source reads neutral (the controller must keep ticking),
# but the failure itself must not vanish: a persistently dark source
# starves the policy layer, and this counter is how ops sees it
_M_DARK = REGISTRY.counter(
    "gordo_autopilot_dark_sources_total",
    "Signal-source reads that raised and fell back to neutral values",
    labels=("kind",),
)


@dataclass
class Observation:
    """One tick's normalized view of the serving system."""

    at: float = 0.0
    # SLO engine (max across objectives; 0.0 when no evaluator is wired)
    burn_fast: float = 0.0
    burn_slow: float = 0.0
    attainment: Optional[float] = None     # worst since-boot attainment
    # flight-recorder span shares over recent requests (sum <= 1.0)
    queue_share: float = 0.0
    device_share: float = 0.0
    fetch_share: float = 0.0
    fill_share: float = 0.0
    sampled_requests: int = 0              # rows behind the shares
    # admission gate
    inflight_frac: float = 0.0
    queue_depth: int = 0
    # cumulative-counter delta between reads
    rps: float = 0.0
    # source-specific extras (engine stats slices, worker counts, ...)
    extras: Dict[str, Any] = field(default_factory=dict)

    def summary(self) -> Dict[str, Any]:
        return {
            "burn_fast": round(self.burn_fast, 4),
            "burn_slow": round(self.burn_slow, 4),
            "attainment": (
                round(self.attainment, 6)
                if self.attainment is not None else None
            ),
            "queue_share": round(self.queue_share, 4),
            "device_share": round(self.device_share, 4),
            "fetch_share": round(self.fetch_share, 4),
            "fill_share": round(self.fill_share, 4),
            "sampled_requests": self.sampled_requests,
            "inflight_frac": round(self.inflight_frac, 4),
            "queue_depth": self.queue_depth,
            "rps": round(self.rps, 3),
            "extras": dict(self.extras),
        }


def registry_counter_total(
    name: str,
    label_filter: Optional[Dict[str, Any]] = None,
    registry: Registry = REGISTRY,
) -> float:
    """Cumulative sum of a counter's matching series — the rate source
    for :class:`SignalReader` (filter values: exact string, a tuple of
    options, or a predicate)."""
    for metric in registry.metrics():
        if metric.name != name:
            continue
        total = 0.0
        for values, value in metric.collect().items():
            labels = dict(zip(metric.labelnames, values))
            matched = True
            for key, want in (label_filter or {}).items():
                have = labels.get(key)
                if have is None:
                    matched = False
                elif callable(want):
                    matched = bool(want(have))
                elif isinstance(want, (tuple, list, set, frozenset)):
                    matched = have in want
                else:
                    matched = have == str(want)
                if not matched:
                    break
            if matched:
                total += value
        return total
    return 0.0


class SignalReader:
    """Snapshot the signal plane into one :class:`Observation`.

    Every source is optional: ``slo`` (an ``SLOEvaluator`` with
    ``burn_snapshot``), ``recorder`` (a ``FlightRecorder`` with
    ``summaries``), ``admission_stats`` / ``engine_stats`` /
    ``request_count`` callables. ``sample`` bounds the recorder rows a
    read scans."""

    def __init__(
        self,
        slo=None,
        recorder=None,
        admission_stats: Optional[Callable[[], Dict[str, Any]]] = None,
        engine_stats: Optional[Callable[[], Dict[str, Any]]] = None,
        request_count: Optional[Callable[[], float]] = None,
        extras: Optional[Callable[[], Dict[str, Any]]] = None,
        clock: Callable[[], float] = time.monotonic,
        sample: int = 40,
    ):
        self.slo = slo
        self.recorder = recorder
        self.admission_stats = admission_stats
        self.engine_stats = engine_stats
        self.request_count = request_count
        self.extras = extras
        self.sample = sample
        self._clock = clock
        self._last_count: Optional[float] = None
        self._last_at: Optional[float] = None

    def read(self, now: Optional[float] = None) -> Observation:
        now = self._clock() if now is None else now
        obs = Observation(at=now)
        self._read_burn(obs, now)
        self._read_shares(obs)
        self._read_admission(obs)
        self._read_engine(obs)
        self._read_rate(obs, now)
        if self.extras is not None:
            try:
                obs.extras.update(self.extras() or {})
            except Exception:
                _M_DARK.labels("extras").inc()
        return obs

    # -- sources (each guarded: a dark source yields neutral values) ---------
    def _read_burn(self, obs: Observation, now: float) -> None:
        if self.slo is None:
            return
        try:
            snapshot = self.slo.burn_snapshot(now)
        except Exception:
            _M_DARK.labels("burn").inc()
            return
        for row in snapshot.values():
            obs.burn_fast = max(obs.burn_fast, float(row.get("fast") or 0.0))
            obs.burn_slow = max(obs.burn_slow, float(row.get("slow") or 0.0))
            attainment = row.get("attainment")
            if attainment is not None:
                obs.attainment = (
                    attainment if obs.attainment is None
                    else min(obs.attainment, attainment)
                )

    def _read_shares(self, obs: Observation) -> None:
        if self.recorder is None:
            return
        try:
            rows = self.recorder.summaries(limit=self.sample)
        except Exception:
            _M_DARK.labels("shares").inc()
            return
        totals = {"queue": 0.0, "device": 0.0, "fetch": 0.0, "fill": 0.0}
        sampled = 0
        for row in rows.get("requests", []):
            stages = row.get("stages_ms") or {}
            if not stages:
                continue
            sampled += 1
            for name, ms in stages.items():
                if name in _QUEUE_STAGES:
                    totals["queue"] += ms
                elif name in _DEVICE_STAGES:
                    totals["device"] += ms
                elif name in _FETCH_STAGES:
                    totals["fetch"] += ms
                elif name in _FILL_STAGES:
                    totals["fill"] += ms
        grand = sum(totals.values())
        obs.sampled_requests = sampled
        if grand > 0:
            obs.queue_share = totals["queue"] / grand
            obs.device_share = totals["device"] / grand
            obs.fetch_share = totals["fetch"] / grand
            obs.fill_share = totals["fill"] / grand

    def _read_admission(self, obs: Observation) -> None:
        if self.admission_stats is None:
            return
        try:
            stats = self.admission_stats()
        except Exception:
            _M_DARK.labels("admission").inc()
            return
        max_inflight = max(1, int(stats.get("max_inflight") or 1))
        obs.inflight_frac = float(stats.get("inflight") or 0) / max_inflight
        obs.queue_depth = int(stats.get("queue_depth") or 0)
        obs.extras["max_inflight"] = max_inflight

    def _read_engine(self, obs: Observation) -> None:
        if self.engine_stats is None:
            return
        try:
            stats = self.engine_stats()
        except Exception:
            _M_DARK.labels("engine").inc()
            return
        mega = stats.get("megabatch") or {}
        obs.extras.update(
            {
                "dispatch_depth": stats.get("dispatch_depth"),
                "machines": stats.get("machines"),
                "mega_enabled": mega.get("enabled"),
                "fill_window_us": mega.get("fill_window_us"),
                "residency_cap": mega.get("residency_cap"),
                "resident_machines": mega.get("resident_machines"),
                "fusion_ratio": mega.get("fusion_ratio"),
            }
        )

    def _read_rate(self, obs: Observation, now: float) -> None:
        if self.request_count is None:
            return
        try:
            count = float(self.request_count())
        except Exception:
            _M_DARK.labels("rate").inc()
            return
        if self._last_count is not None and self._last_at is not None:
            dt = now - self._last_at
            if dt > 0:
                obs.rps = max(0.0, (count - self._last_count) / dt)
        self._last_count = count
        self._last_at = now
        obs.extras["request_count"] = count
