"""Measured capacity: the telemetry cost ledger feeding the fleet spec's
defaults (the port's copy of ``gordo_components_tpu/fleet/capacity.py``).

The autopilot's worker bounds and idle thresholds were hardcoded
guesses (``Bounds(1, 8)``, ``idle_rps=1.0``); the telemetry warehouse
MEASURES the real numbers — per-rung served
requests and accumulated device dispatch seconds, merged fleet-wide by
the router's ``/telemetry`` view. This module folds that ledger into
control inputs:

- :func:`worker_capacity_rps` — sustained per-worker throughput, read
  as total served requests over total busy device seconds (both summed
  across the fleet by ``merge_views``, so the ratio is the average
  dispatch-saturated rate one worker achieves).
- :func:`derive_worker_bounds` — the spec's DEFAULT floor/ceiling when
  no ``workers`` block is declared: enough workers for the observed
  demand at measured capacity (floor), with headroom (ceiling), clamped
  inside the operator's hard knob bounds.
- :func:`measured_idle_rps` — the autopilot's scale-down threshold as a
  fraction of measured capacity instead of a constant: a fleet whose
  workers each sustain 400 req/s is "idle" well above 1 req/s.

Everything degrades to None (→ caller keeps its static default) while
the ledger is dark: too few requests or too little dispatch time is a
measurement, not a capacity of zero.
"""

from __future__ import annotations

import logging
import math
from typing import Any, Dict, Optional, Tuple

logger = logging.getLogger(__name__)

#: below these, the ledger is noise, not a measurement
MIN_REQUESTS = 50
MIN_DISPATCH_SECONDS = 0.2

#: ceiling = demand-derived floor × headroom
HEADROOM = 2.0

#: "idle" = observed demand under this fraction of ONE worker's capacity
IDLE_FRACTION = 0.05


def worker_capacity_rps(view: Dict[str, Any]) -> Optional[float]:
    """Measured per-worker sustained throughput from a ``/telemetry``
    view (single worker or fleet-merged), or None while dark."""
    costs = (view or {}).get("costs") or {}
    rungs = (costs.get("engine") or {}).get("rungs") or {}
    requests = 0.0
    seconds = 0.0
    for entry in rungs.values():
        requests += float(entry.get("requests") or 0)
        seconds += float(entry.get("dispatch_seconds_total") or 0.0)
    if requests < MIN_REQUESTS or seconds < MIN_DISPATCH_SECONDS:
        return None
    return requests / seconds


def observed_demand_rps(view: Dict[str, Any]) -> Optional[float]:
    """Fleet-wide request arrival rate from the warehouse's windowed
    rates (worker request series summed by ``merge_views``)."""
    window = (view or {}).get("window") or {}
    rates = window.get("rates") or {}
    best: Optional[float] = None
    for name, rate in rates.items():
        if "requests_total" not in name:
            continue
        total = float(rate.get("total") or 0.0)
        best = total if best is None else max(best, total)
    return best


def derive_worker_bounds(
    view: Dict[str, Any],
    hard_bounds: Tuple[int, int],
    headroom: float = HEADROOM,
) -> Optional[Tuple[int, int]]:
    """Measured default worker floor/ceiling: workers needed to serve
    the observed demand at measured capacity, with ``headroom`` above
    it, clamped inside ``hard_bounds`` (the operator's knob stays the
    outer envelope). None while either measurement is dark."""
    capacity = worker_capacity_rps(view)
    demand = observed_demand_rps(view)
    if capacity is None or demand is None or capacity <= 0:
        return None
    lo, hi = int(hard_bounds[0]), int(hard_bounds[1])
    need = max(1, int(math.ceil(demand / capacity)))
    floor = min(max(lo, need), hi)
    ceiling = min(max(floor, int(math.ceil(need * headroom))), hi)
    return floor, ceiling


def measured_idle_rps(
    view: Dict[str, Any], static_default: float
) -> Optional[float]:
    """The workers rule's idle threshold, measured: a fixed fraction of
    one worker's capacity (never below the static knob — operators can
    still raise the floor)."""
    capacity = worker_capacity_rps(view)
    if capacity is None:
        return None
    return round(max(static_default, IDLE_FRACTION * capacity), 3)


def calibrate_autopilot(pilot: Any, view: Dict[str, Any]) -> bool:
    """Fold the measured ledger into a live router autopilot: the
    thresholds object is SHARED by closure with every decision rule, so
    updating it in place re-aims the running rules without rebuilding
    actuators. Returns whether anything changed."""
    thresholds = getattr(pilot, "thresholds", None)
    if thresholds is None:
        return False
    static_default = getattr(pilot, "static_idle_rps", thresholds.idle_rps)
    idle = measured_idle_rps(view, static_default)
    if idle is None or idle == thresholds.idle_rps:
        return False
    logger.info(
        "Measured capacity: autopilot idle_rps %.3f -> %.3f",
        thresholds.idle_rps, idle,
    )
    thresholds.idle_rps = idle
    return True
