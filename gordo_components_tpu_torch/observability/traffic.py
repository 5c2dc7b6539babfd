"""Per-machine traffic accounting (the port's copy of
``gordo_components_tpu/observability/traffic.py``): which machines are
served, and how fast.

Two bounded structures behind one request-path lock:

- :class:`SpaceSaving`: the top-K heavy-hitter sketch (Metwally et al.). At
  most ``capacity`` tracked keys whatever the fleet size; O(1) for a tracked
  key, O(log K) when an untracked key evicts the minimum. Every key with a
  true count above N/capacity is tracked, and ``estimate - error <=
  true_count <= estimate``.
- :class:`TrafficAccountant`: the sketch plus EWMA rates over the 1m, 10m
  and 1h horizons per tracked machine, per engine shape bucket and per
  precision rung. Rates fold on ``tick`` (the telemetry warehouse's
  scrape-driven tick; no thread, an injectable clock); ``note`` on the
  scoring path only increments dicts.

The module-level :data:`ACCOUNTANT` is process-wide like ``REGISTRY``: the
engine notes into it, every server and warehouse reads it, and
``registry.bound_machine_cardinality`` keeps the machines it nominates
while ``GORDO_TELEMETRY`` is on (the per-family recount otherwise).
"""

from __future__ import annotations

import heapq
import math
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..analysis import lockcheck
from .registry import REGISTRY, set_traffic_topk_provider

# EWMA horizons: label -> seconds. The 1m rate answers "now", the 1h
# rate is what the layout compiler should plan on.
HORIZONS: Tuple[Tuple[str, float], ...] = (
    ("1m", 60.0), ("10m", 600.0), ("1h", 3600.0),
)

_M_TRACKED = REGISTRY.gauge(
    "gordo_telemetry_tracked_machines",
    "Machines currently tracked by the Space-Saving traffic sketch "
    "(bounded by GORDO_TELEMETRY_TOPK whatever the fleet size)",
)


def enabled() -> bool:
    """GORDO_TELEMETRY=0 disables traffic accounting and the telemetry
    warehouse (requests pay zero accounting cost)."""
    return os.environ.get("GORDO_TELEMETRY", "1").strip().lower() not in (
        "0", "false", "off", "no",
    )


def sketch_capacity() -> int:
    """``GORDO_TELEMETRY_TOPK``: tracked-machine capacity of the traffic
    sketch (default 512 — comfortably above the default top-64 metric
    cardinality cap it feeds, so the kept set is never error-bound)."""
    try:
        return max(8, int(os.environ.get("GORDO_TELEMETRY_TOPK", "512")))
    except ValueError:
        return 512


class SpaceSaving:
    """Space-Saving top-K sketch: bounded counts with per-key error.

    NOT thread-safe on its own — the owning :class:`TrafficAccountant`
    (or a test) serializes access. ``_counts`` maps key -> [count,
    error]; ``_heap`` is a lazy min-heap of (count, key) used only to
    find the eviction victim (stale entries are skipped on pop, the
    standard lazy-deletion trick — amortized O(log K) per eviction).
    Evictions are the only place stale tuples get popped, so a fleet
    that never fills ``capacity`` would leak one tuple per offer;
    :meth:`_compact_heap` rebuilds the heap from live counts whenever
    it exceeds 4x capacity, keeping it bounded at amortized O(1).
    """

    def __init__(self, capacity: int):
        self.capacity = max(1, int(capacity))
        self._counts: Dict[str, List[float]] = {}
        self._heap: List[Tuple[float, str]] = []

    def _compact_heap(self) -> None:
        self._heap = [(v[0], k) for k, v in self._counts.items()]
        heapq.heapify(self._heap)

    def __len__(self) -> int:
        return len(self._counts)

    def __contains__(self, key: str) -> bool:
        return key in self._counts

    def offer(self, key: str, amount: float = 1.0) -> None:
        if len(self._heap) > 4 * self.capacity:
            self._compact_heap()
        entry = self._counts.get(key)
        if entry is not None:
            entry[0] += amount
            heapq.heappush(self._heap, (entry[0], key))
            return
        if len(self._counts) < self.capacity:
            self._counts[key] = [amount, 0.0]
            heapq.heappush(self._heap, (amount, key))
            return
        # evict the true minimum: pop until the heap top reflects a
        # live entry's CURRENT count (stale tuples from earlier
        # increments are skipped)
        while self._heap:
            count, victim = self._heap[0]
            live = self._counts.get(victim)
            if live is not None and live[0] == count:
                break
            heapq.heappop(self._heap)
        count, victim = heapq.heappop(self._heap)
        del self._counts[victim]
        # the newcomer inherits the victim's count as its error bound:
        # true_count <= estimate, estimate - error <= true_count
        self._counts[key] = [count + amount, count]
        heapq.heappush(self._heap, (count + amount, key))

    def estimate(self, key: str) -> Optional[Tuple[float, float]]:
        entry = self._counts.get(key)
        return None if entry is None else (entry[0], entry[1])

    def items(self) -> List[Tuple[str, float, float]]:
        """(key, estimated_count, error), heaviest first (count desc,
        then name — deterministic for tests and operators)."""
        return sorted(
            ((k, v[0], v[1]) for k, v in self._counts.items()),
            key=lambda row: (-row[1], row[0]),
        )

    def top(self, k: int) -> List[Tuple[str, float, float]]:
        return self.items()[: max(0, int(k))]

    def to_list(self) -> List[List[Any]]:
        """JSON-able serialization (the /telemetry aggregation wire
        shape): [[key, count, error], ...] heaviest first."""
        return [[k, c, e] for k, c, e in self.items()]

    @classmethod
    def merged(
        cls,
        lists: Sequence[Sequence[Sequence[Any]]],
        capacity: int,
        source_capacities: Optional[Sequence[Optional[int]]] = None,
    ) -> "SpaceSaving":
        """Merge serialized sketches (router aggregating per-worker
        accountants) with the mergeable-summaries rule: per key, SUM the
        estimates of sketches that track it, and for each sketch that
        does NOT, add that sketch's minimum count to both estimate and
        error — a key a full sketch dropped can have seen at most its
        minimum there. A sketch below its OWN capacity never evicted,
        so its missing-mass bound is exactly zero — "full" is judged
        against ``source_capacities[i]`` (the capacity that sketch
        actually ran with, which under heterogeneous GORDO_TELEMETRY_TOPK
        differs from the merge ``capacity``; unknown defaults to
        ``capacity``). This keeps the sketch's bound sound across the
        merge: estimate - error <= true <= estimate."""
        parsed: List[Dict[str, Tuple[float, float]]] = [
            {
                str(row[0]): (float(row[1]), float(row[2]))
                for row in rows
            }
            for rows in lists
        ]
        caps: List[int] = [
            int(cap) if cap else capacity
            for cap in (source_capacities or [None] * len(parsed))
        ]
        caps += [capacity] * (len(parsed) - len(caps))
        missing_mass = [
            (min(c for c, _ in rows.values())
             if rows and len(rows) >= cap else 0.0)
            for rows, cap in zip(parsed, caps)
        ]
        combined: Dict[str, List[float]] = {}
        all_keys = set()
        for rows in parsed:
            all_keys.update(rows)
        for key in all_keys:
            entry = combined.setdefault(key, [0.0, 0.0])
            for rows, bound in zip(parsed, missing_mass):
                count, error = rows.get(key, (bound, bound))
                entry[0] += count
                entry[1] += error
        sketch = cls(capacity)
        kept = sorted(
            combined.items(), key=lambda kv: (-kv[1][0], kv[0])
        )[:capacity]
        # keys trimmed here were below every kept key on every worker;
        # their mass is bounded by the kept minimum by construction
        for key, (count, error) in kept:
            sketch._counts[key] = [count, error]
            heapq.heappush(sketch._heap, (count, key))
        return sketch


def _ewma_fold(
    rates: Dict[str, float], inst: float, alphas: Dict[str, float]
) -> Dict[str, float]:
    out = {}
    for label, alpha in alphas.items():
        prev = rates.get(label)
        out[label] = (
            inst if prev is None else prev + alpha * (inst - prev)
        )
    return out


class TrafficAccountant:
    """Bounded per-machine / per-bucket / per-rung traffic rates.

    ``note()`` is the request-path entry (dict increments under one HOT
    lock); ``tick(now)`` folds accumulated counts into EWMA rates at
    each horizon — driven by the telemetry warehouse's scrape-driven
    tick, so rates cost nothing while nobody scrapes. ``clock`` is
    injectable; tests run hours of horizon arithmetic in microseconds.
    """

    def __init__(
        self,
        capacity: Optional[int] = None,
        horizons: Tuple[Tuple[str, float], ...] = HORIZONS,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.horizons = tuple(horizons)
        self._clock = clock
        self._lock = lockcheck.named_lock("observability.traffic")
        self._sketch = SpaceSaving(
            capacity if capacity is not None else sketch_capacity()
        )
        # counts since the last tick; _pending is pruned to the sketch's
        # tracked set every tick and hard-capped between ticks so an all-new-
        # machines flood cannot grow it past a few multiples of capacity
        self._pending: Dict[str, float] = {}
        self._group_pending: Dict[Tuple[str, str], float] = {}
        self._total_pending = 0.0
        self._total_count = 0.0
        self._rates: Dict[str, Dict[str, float]] = {}
        self._group_rates: Dict[Tuple[str, str], Dict[str, float]] = {}
        self._group_counts: Dict[Tuple[str, str], float] = {}
        self._total_rates: Dict[str, float] = {}
        self._last_tick: Optional[float] = None
        self.ticks = 0

    # -- request path ---------------------------------------------------------
    def note(
        self, machine: str, bucket: str = "", precision: str = "",
        n: float = 1.0,
    ) -> None:
        """One served request for ``machine`` (scored by ``bucket`` at
        ``precision``). Dict increments only — rate math waits for the
        next tick."""
        group = (bucket, precision)
        with self._lock:
            lockcheck.assert_guard("observability.traffic")
            self._sketch.offer(machine, n)
            if (
                machine in self._pending
                or len(self._pending) < 8 * self._sketch.capacity
            ):
                self._pending[machine] = self._pending.get(machine, 0.0) + n
            self._group_pending[group] = (
                self._group_pending.get(group, 0.0) + n
            )
            self._group_counts[group] = (
                self._group_counts.get(group, 0.0) + n
            )
            self._total_pending += n
            self._total_count += n

    # -- tick-driven rate folding ---------------------------------------------
    def tick(self, now: Optional[float] = None) -> None:
        """Fold counts-since-last-tick into the EWMA rate table. The
        first tick only establishes the baseline timestamp."""
        now = self._clock() if now is None else now
        with self._lock:
            lockcheck.assert_guard("observability.traffic")
            last = self._last_tick
            self._last_tick = now
            if last is None or now <= last:
                self._pending.clear()
                self._group_pending.clear()
                self._total_pending = 0.0
                return
            dt = now - last
            alphas = {
                label: 1.0 - math.exp(-dt / horizon)
                for label, horizon in self.horizons
            }
            tracked = set(self._sketch._counts)
            for machine in tracked:
                inst = self._pending.get(machine, 0.0) / dt
                self._rates[machine] = _ewma_fold(
                    self._rates.get(machine, {}), inst, alphas
                )
            # machines evicted from the sketch drop their rate state —
            # both tables stay bounded by the sketch capacity
            for machine in list(self._rates):
                if machine not in tracked:
                    del self._rates[machine]
            for group in set(self._group_counts):
                inst = self._group_pending.get(group, 0.0) / dt
                self._group_rates[group] = _ewma_fold(
                    self._group_rates.get(group, {}), inst, alphas
                )
            self._total_rates = _ewma_fold(
                self._total_rates, self._total_pending / dt, alphas
            )
            self._pending.clear()
            self._group_pending.clear()
            self._total_pending = 0.0
            self.ticks += 1
            tracked_n = len(tracked)
        _M_TRACKED.set(tracked_n)

    # -- views ----------------------------------------------------------------
    def top(self, k: int) -> List[Tuple[str, float, float]]:
        with self._lock:
            return self._sketch.top(k)

    def topk_names(self, k: int) -> List[str]:
        """The sketch's current heaviest ``k`` machine names — what
        ``registry.bound_machine_cardinality`` keeps when telemetry is
        the authority."""
        return [name for name, _, _ in self.top(k)]

    def snapshot(self) -> Dict[str, Any]:
        """JSON-able full view (the worker's /telemetry ``traffic``
        block, and the unit the router merges)."""
        with self._lock:
            machines = [
                {
                    "machine": name,
                    "count": count,
                    "error": error,
                    "rates": dict(self._rates.get(name, {})),
                }
                for name, count, error in self._sketch.items()
            ]
            groups = [
                {
                    "bucket": bucket,
                    "precision": precision,
                    "count": count,
                    "rates": dict(
                        self._group_rates.get((bucket, precision), {})
                    ),
                }
                for (bucket, precision), count in sorted(
                    self._group_counts.items()
                )
            ]
            return {
                "capacity": self._sketch.capacity,
                "ticks": self.ticks,
                "total": {
                    "count": self._total_count,
                    "rates": dict(self._total_rates),
                },
                "machines": machines,
                "groups": groups,
            }

    def reset(self) -> None:
        """Tests only: drop all accounting (the module singleton is
        process-wide, and smoke phases must not see each other)."""
        with self._lock:
            lockcheck.assert_guard("observability.traffic")
            self._sketch = SpaceSaving(self._sketch.capacity)
            self._pending.clear()
            self._group_pending.clear()
            self._total_pending = 0.0
            self._total_count = 0.0
            self._rates.clear()
            self._group_rates.clear()
            self._group_counts.clear()
            self._total_rates = {}
            self._last_tick = None
            self.ticks = 0


def merge_snapshots(
    snapshots: Sequence[Dict[str, Any]], capacity: Optional[int] = None
) -> Dict[str, Any]:
    """Merge per-worker ``TrafficAccountant.snapshot()`` dicts into one
    fleet view (the router's /telemetry aggregation): sketch counts
    merge via :meth:`SpaceSaving.merged`, rates SUM per horizon (each
    worker's rate is its own served share — fleet rate is the sum),
    groups merge by (bucket, precision)."""
    capacity = capacity if capacity is not None else sketch_capacity()
    sketch = SpaceSaving.merged(
        [
            [[m["machine"], m["count"], m["error"]]
             for m in snap.get("machines", ())]
            for snap in snapshots
        ],
        capacity,
        # each worker's fullness is judged against ITS capacity, not
        # the router's — a smaller-TOPK worker can be full (and owe a
        # missing-mass bound) while looking sparse to the router
        source_capacities=[
            int(snap.get("capacity") or 0) or None for snap in snapshots
        ],
    )
    machine_rates: Dict[str, Dict[str, float]] = {}
    groups: Dict[Tuple[str, str], Dict[str, Any]] = {}
    total_count = 0.0
    total_rates: Dict[str, float] = {}
    ticks = 0
    for snap in snapshots:
        ticks = max(ticks, int(snap.get("ticks") or 0))
        total = snap.get("total") or {}
        total_count += float(total.get("count") or 0.0)
        for label, rate in (total.get("rates") or {}).items():
            total_rates[label] = total_rates.get(label, 0.0) + float(rate)
        for m in snap.get("machines", ()):
            rates = machine_rates.setdefault(m["machine"], {})
            for label, rate in (m.get("rates") or {}).items():
                rates[label] = rates.get(label, 0.0) + float(rate)
        for g in snap.get("groups", ()):
            key = (g.get("bucket", ""), g.get("precision", ""))
            into = groups.setdefault(
                key, {"bucket": key[0], "precision": key[1],
                      "count": 0.0, "rates": {}}
            )
            into["count"] += float(g.get("count") or 0.0)
            for label, rate in (g.get("rates") or {}).items():
                into["rates"][label] = (
                    into["rates"].get(label, 0.0) + float(rate)
                )
    return {
        "capacity": capacity,
        "ticks": ticks,
        "total": {"count": total_count, "rates": total_rates},
        "machines": [
            {
                "machine": name,
                "count": count,
                "error": error,
                "rates": machine_rates.get(name, {}),
            }
            for name, count, error in sketch.items()
        ],
        "groups": [groups[key] for key in sorted(groups)],
    }


# THE process-wide accountant (REGISTRY pattern): the engine records
# into it without plumbing; servers, warehouses, and the registry's
# cardinality bound all read the same accounting. Tests construct their
# own TrafficAccountant for isolation.
ACCOUNTANT = TrafficAccountant()


def note(
    machine: str, bucket: str = "", precision: str = "", n: float = 1.0
) -> None:
    """Scoring-path entry: account one request when telemetry is on
    (the disabled path is one env read — the overhead gate's floor)."""
    if not enabled():
        return
    ACCOUNTANT.note(machine, bucket=bucket, precision=precision, n=n)


def _topk_provider(cap: int) -> Optional[List[str]]:
    """Satellite hook: nominate the sketch's heaviest machines as the
    kept set for metric cardinality bounding. None (telemetry off, or
    an empty sketch) falls back to the registry's per-family recount."""
    if not enabled():
        return None
    names = ACCOUNTANT.topk_names(cap)
    return names or None


set_traffic_topk_provider(_topk_provider)
