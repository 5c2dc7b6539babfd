"""The telemetry warehouse (the port's copy of
``gordo_components_tpu/observability/telemetry.py``): durable, bounded,
scrape-driven metrics history, plus the measured-cost ledger.

- **Tick, don't thread**: ``maybe_tick`` runs on the scrape path with an
  injectable clock pair (``clock`` monotonic for intervals, ``wall`` for
  durable timestamps). An unwatched server does no telemetry work.
- **Deltas, not totals**: each tick appends one JSONL record of counter
  increments, gauge values and per-bucket histogram increments since the
  previous tick, so history survives a restart (a counter reset cannot
  give a negative window) and merges across workers by addition.
- **Durable like a journal**: every record is flushed and fsync'd; reload
  tolerates a torn final line silently and skips corrupt mid-file lines
  loudly.
- **Bounded**: segments rotate at ``GORDO_TELEMETRY_SEGMENT_KB`` and the
  oldest go past the ``GORDO_TELEMETRY_MB`` budget; machine-labeled series
  collapse through the registry's top-K bound before they are written.

Window queries (rate over a window, percentiles from bucket increments)
read an in-memory index rebuilt from the segments at boot, so
``/telemetry?window=...`` still sees history from before a restart.
``build_export`` renders the ledger and traffic view as the versioned
layout-input document (``gordo-layout-input/v1``).

The warehouse reads a registry through its public surface only:
``metrics()``, ``isinstance`` of ``Counter``/``Gauge``/``Histogram``,
``collect()``, ``labelnames`` and ``buckets``.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..analysis import lockcheck
from . import traffic as traffic_mod
from .registry import (
    REGISTRY,
    Counter,
    Gauge,
    Histogram,
    Registry,
    _label_key,
    bound_machine_cardinality,
)

logger = logging.getLogger(__name__)

EXPORT_SCHEMA = "gordo-layout-input/v1"

enabled = traffic_mod.enabled  # one knob (GORDO_TELEMETRY) rules both

_M_TICKS = REGISTRY.counter(
    "gordo_telemetry_ticks_total",
    "Telemetry warehouse snapshot ticks taken",
)
_M_ROTATIONS = REGISTRY.counter(
    "gordo_telemetry_segment_rotations_total",
    "Telemetry warehouse segment files rotated (opened after the "
    "previous segment crossed GORDO_TELEMETRY_SEGMENT_KB)",
)
_M_BYTES = REGISTRY.gauge(
    "gordo_telemetry_warehouse_bytes",
    "Bytes currently held by the telemetry warehouse across all "
    "segments (bounded by GORDO_TELEMETRY_MB)",
)
_M_SEGMENTS = REGISTRY.gauge(
    "gordo_telemetry_segments",
    "Telemetry warehouse segment files currently on disk",
)
_M_APPEND_SECONDS = REGISTRY.histogram(
    "gordo_telemetry_append_seconds",
    "Wall seconds to serialize + fsync one telemetry record",
)


def tick_interval() -> float:
    """``GORDO_TELEMETRY_INTERVAL``: minimum seconds between warehouse
    ticks (scrape-driven; scraping faster than this is free)."""
    try:
        return float(os.environ.get("GORDO_TELEMETRY_INTERVAL", "15"))
    except ValueError:
        return 15.0


def byte_budget() -> int:
    """``GORDO_TELEMETRY_MB``: hard byte budget across all warehouse
    segments; the oldest segments are deleted to stay under it."""
    try:
        mb = float(os.environ.get("GORDO_TELEMETRY_MB", "64"))
    except ValueError:
        mb = 64.0
    return max(1 << 16, int(mb * (1 << 20)))


def segment_bytes() -> int:
    """``GORDO_TELEMETRY_SEGMENT_KB``: rotate the active segment once it
    crosses this many KiB (retention granularity: the budget deletes
    whole segments)."""
    try:
        kb = float(os.environ.get("GORDO_TELEMETRY_SEGMENT_KB", "256"))
    except ValueError:
        kb = 256.0
    return max(1 << 12, int(kb * 1024))


def _le_list(bounds: Sequence[float]) -> List[Optional[float]]:
    """Histogram bucket bounds as strict-JSON values: +Inf becomes None
    (json.dumps would emit the non-standard ``Infinity`` literal)."""
    return [None if b == float("inf") else b for b in bounds]


def _bucket_percentile(
    le: Sequence[Optional[float]], deltas: Sequence[float], q: float
) -> Optional[float]:
    """Linear-interpolated percentile from per-bucket increment counts —
    the standard Prometheus ``histogram_quantile`` estimate. The +Inf
    bucket has no upper bound, so a quantile landing there reports the
    last finite bound (an honest floor, like Prometheus)."""
    total = float(sum(deltas))
    if total <= 0:
        return None
    target = q * total
    acc = 0.0
    lower = 0.0
    for bound, n in zip(le, deltas):
        if acc + n >= target and n > 0:
            if bound is None:
                return lower
            return lower + (bound - lower) * ((target - acc) / n)
        acc += n
        if bound is not None:
            lower = bound
    return lower


class TelemetryWarehouse:
    """Append-only JSONL metric history + cost ledger for one process.

    ``directory=None`` runs memory-only (same queries, no durability) —
    the mode a bare ``ServingEngine`` test gets. All byte accounting,
    rotation, and budget trimming is identical either way; memory-only
    simply never touches disk.
    """

    def __init__(
        self,
        directory: Optional[str] = None,
        registry: Registry = REGISTRY,
        accountant: Optional[traffic_mod.TrafficAccountant] = None,
        cost_sampler: Optional[Callable[[], Dict[str, Any]]] = None,
        worker: str = "",
        clock: Callable[[], float] = time.monotonic,
        wall: Callable[[], float] = time.time,
        min_interval: Optional[float] = None,
        budget: Optional[int] = None,
        segment_limit: Optional[int] = None,
    ):
        self.directory = directory
        self.registry = registry
        self.accountant = (
            accountant if accountant is not None else traffic_mod.ACCOUNTANT
        )
        self.cost_sampler = cost_sampler
        self.worker = worker
        self._clock = clock
        self._wall = wall
        self.min_interval = (
            min_interval if min_interval is not None else tick_interval()
        )
        self.budget = budget if budget is not None else byte_budget()
        self.segment_limit = (
            segment_limit if segment_limit is not None else segment_bytes()
        )
        self._lock = lockcheck.named_lock("observability.telemetry")
        # (segment_seq, record_bytes, record) oldest-first; the query
        # index and the byte ledger share one list so budget trims are
        # exact on both sides
        self._index: List[Tuple[int, int, Dict[str, Any]]] = []
        self._seg_bytes: Dict[int, int] = {}  # on-disk bytes per segment
        self._seg_seq = 0
        self._active_fh = None
        self._active_bytes = 0
        self._last_tick: Optional[float] = None
        self._tick_pending = False
        self._last_wall: Optional[float] = None
        self._prev_counters: Dict[str, Dict[Tuple[str, ...], float]] = {}
        self._prev_hist: Dict[
            str, Dict[Tuple[str, ...], Tuple[Tuple[int, ...], float, int]]
        ] = {}
        self._costs: Dict[str, Any] = {}
        self.ticks = 0
        self.rotations = 0
        if directory is not None:
            os.makedirs(directory, exist_ok=True)
            with self._lock:
                self._reload()
        # baseline tick: establishes delta baselines and timestamps so
        # the first real tick reports honest increments (slo.py pattern)
        self.tick()

    # -- durable segments -----------------------------------------------------
    def _seg_path(self, seq: int) -> str:
        assert self.directory is not None
        return os.path.join(self.directory, f"seg-{seq:08d}.jsonl")

    def _reload(self) -> None:
        """Rebuild the in-memory index from on-disk segments, WAL-style:
        a torn FINAL line (crash mid-append) resumes silently one record
        short; corrupt mid-file lines are skipped loudly."""
        assert self.directory is not None
        names = sorted(
            n for n in os.listdir(self.directory)
            if n.startswith("seg-") and n.endswith(".jsonl")
        )
        for name in names:
            path = os.path.join(self.directory, name)
            try:
                seq = int(name[len("seg-"):-len(".jsonl")])
            except ValueError:
                logger.warning("telemetry: ignoring alien file %s", path)
                continue
            self._seg_seq = max(self._seg_seq, seq + 1)
            try:
                with open(path, "r") as fh:
                    lines = fh.readlines()
            except OSError as exc:
                logger.warning("telemetry: unreadable segment %s: %s",
                               path, exc)
                continue
            kept = 0
            for i, line in enumerate(lines):
                if not line.strip():
                    continue
                try:
                    record = json.loads(line)
                except ValueError:
                    final = (name == names[-1] and i == len(lines) - 1)
                    if final:
                        logger.info(
                            "telemetry: ignoring torn final line in %s "
                            "(crash mid-append)", path,
                        )
                    else:
                        logger.warning(
                            "telemetry: skipping corrupt line %d in %s",
                            i + 1, path,
                        )
                    continue
                nbytes = len(line.encode("utf-8"))
                self._index.append((seq, nbytes, record))
                kept += 1
            self._seg_bytes[seq] = os.path.getsize(path)
            logger.info("telemetry: reloaded %d record(s) from %s",
                        kept, path)
        self._trim_locked()

    def _append_locked(self, record: Dict[str, Any]) -> None:
        line = json.dumps(record, separators=(",", ":")) + "\n"
        nbytes = len(line.encode("utf-8"))
        if self.directory is not None:
            started = time.perf_counter()
            if self._active_fh is None:
                seq = self._seg_seq
                self._seg_seq += 1
                self._active_fh = open(self._seg_path(seq), "a")
                self._active_seq = seq
                self._active_bytes = 0
                self._seg_bytes[seq] = 0
            self._active_fh.write(line)
            self._active_fh.flush()
            os.fsync(self._active_fh.fileno())
            _M_APPEND_SECONDS.observe(time.perf_counter() - started)
            self._active_bytes += nbytes
            self._seg_bytes[self._active_seq] += nbytes
            self._index.append((self._active_seq, nbytes, record))
            if self._active_bytes >= self.segment_limit:
                self._active_fh.close()
                self._active_fh = None
                self.rotations += 1
                _M_ROTATIONS.inc()
        else:
            # memory-only: same ledger, records ARE the segments
            seq = self._seg_seq
            self._index.append((seq, nbytes, record))
            self._seg_bytes[seq] = self._seg_bytes.get(seq, 0) + nbytes
            if self._seg_bytes[seq] >= self.segment_limit:
                self._seg_seq += 1
        self._trim_locked()

    def _trim_locked(self) -> None:
        """Enforce the byte budget by deleting whole oldest segments
        (never the active one — a budget smaller than one segment still
        keeps the tail of live history)."""
        while len(self._seg_bytes) > 1 and self.total_bytes() > self.budget:
            oldest = min(self._seg_bytes)
            active = getattr(self, "_active_seq", None)
            if self._active_fh is not None and oldest == active:
                break
            del self._seg_bytes[oldest]
            self._index = [
                entry for entry in self._index if entry[0] != oldest
            ]
            if self.directory is not None:
                try:
                    os.unlink(self._seg_path(oldest))
                except OSError as exc:
                    logger.warning(
                        "telemetry: could not delete segment %d: %s",
                        oldest, exc,
                    )

    def total_bytes(self) -> int:
        return sum(self._seg_bytes.values())

    def close(self) -> None:
        with self._lock:
            lockcheck.assert_guard("observability.telemetry")
            if self._active_fh is not None:
                self._active_fh.close()
                self._active_fh = None

    # -- tick: registry deltas + cost sample into one record ------------------
    def maybe_tick(self, now: Optional[float] = None) -> bool:
        """Scrape-path entry: tick when ``min_interval`` has elapsed.
        The interval check and the claim happen in ONE critical section
        (``_tick_pending``), so concurrent scrapes (/metrics and
        /telemetry racing) cannot both pass the check and double-tick —
        the loser returns False instead of appending a zero-dt record
        and double-folding the accountant EWMAs."""
        now = self._clock() if now is None else now
        with self._lock:
            last = self._last_tick
            if self._tick_pending or (
                last is not None and now - last < self.min_interval
            ):
                return False
            self._tick_pending = True
        try:
            self.tick(now)
        finally:
            with self._lock:
                self._tick_pending = False
        return True

    def tick(self, now: Optional[float] = None) -> None:
        now = self._clock() if now is None else now
        wall_now = self._wall()
        # fold traffic EWMAs first: the accountant's lock (rank 95) nests
        # above this warehouse's (67), and the ledger sampled below
        # should see rates from THIS tick's fold
        self.accountant.tick(now)
        costs = {}
        if self.cost_sampler is not None:
            try:
                costs = self.cost_sampler() or {}
            except Exception as exc:  # noqa: BLE001 - a broken sampler must not take down the scrape; the gap shows as an empty costs block
                logger.warning("telemetry: cost sampler failed: %s", exc)
        with self._lock:
            lockcheck.assert_guard("observability.telemetry")
            last = self._last_tick
            self._last_tick = now
            self._last_wall = wall_now
            if costs:
                self._costs = costs
            record = self._snapshot_deltas_locked(
                wall_now, 0.0 if last is None else max(0.0, now - last)
            )
            if costs:
                record["costs"] = costs
            if last is not None:
                # the baseline tick only establishes prev-values; an
                # empty zero-dt record would pollute window coverage
                self._append_locked(record)
                self.ticks += 1
        if last is not None:
            _M_TICKS.inc()
        _M_BYTES.set(self.total_bytes())
        _M_SEGMENTS.set(len(self._seg_bytes))

    def _snapshot_deltas_locked(
        self, wall_now: float, dt: float
    ) -> Dict[str, Any]:
        counters: Dict[str, Dict[str, float]] = {}
        gauges: Dict[str, Dict[str, float]] = {}
        hists: Dict[str, Dict[str, Any]] = {}
        for metric in self.registry.metrics():
            if isinstance(metric, Counter):
                collected = metric.collect()
                prev = self._prev_counters.get(metric.name, {})
                deltas = {}
                for key, value in collected.items():
                    before = prev.get(key, 0.0)
                    # a shrunk counter means the series was reset
                    # (fresh Registry in tests); its full value is the
                    # honest increment
                    d = value - before if value >= before else value
                    if d > 0:
                        deltas[key] = d
                self._prev_counters[metric.name] = collected
                if deltas:
                    counters[metric.name] = {
                        _label_key(metric.labelnames, k): v
                        for k, v in bound_machine_cardinality(
                            metric, deltas
                        ).items()
                    }
            elif isinstance(metric, Gauge):
                collected = bound_machine_cardinality(
                    metric, metric.collect()
                )
                if collected:
                    gauges[metric.name] = {
                        _label_key(metric.labelnames, k): v
                        for k, v in collected.items()
                    }
            elif isinstance(metric, Histogram):
                collected = metric.collect()
                prev = self._prev_hist.get(metric.name, {})
                keep_prev: Dict[
                    str, Tuple[Tuple[int, ...], float, int]
                ] = {}
                series_deltas: Dict[str, Dict[str, Any]] = {}
                for key, data in collected.items():
                    cumulative = tuple(n for _, n in data["buckets"])
                    keep_prev[key] = (
                        cumulative, data["sum"], data["count"]
                    )
                    pcum, psum, pcount = prev.get(
                        key, ((0,) * len(cumulative), 0.0, 0)
                    )
                    if len(pcum) != len(cumulative):
                        pcum, psum, pcount = (0,) * len(cumulative), 0.0, 0
                    if data["count"] < pcount:  # series reset
                        pcum, psum, pcount = (0,) * len(cumulative), 0.0, 0
                    dcount = data["count"] - pcount
                    if dcount <= 0:
                        continue
                    # per-bucket (non-cumulative) increments
                    per_bucket, last_c, last_p = [], 0, 0
                    for c, p in zip(cumulative, pcum):
                        per_bucket.append((c - last_c) - (p - last_p))
                        last_c, last_p = c, p
                    series_deltas[key] = {
                        "d": per_bucket,
                        "sum": data["sum"] - psum,
                        "n": dcount,
                    }
                self._prev_hist[metric.name] = keep_prev
                if series_deltas:
                    bounded = self._bound_hist_deltas(
                        metric, series_deltas
                    )
                    hists[metric.name] = {
                        "le": _le_list(metric.buckets),
                        "s": {
                            _label_key(metric.labelnames, k): v
                            for k, v in bounded.items()
                        },
                    }
        record: Dict[str, Any] = {"v": 1, "t": wall_now, "dt": dt}
        if self.worker:
            record["w"] = self.worker
        if counters:
            record["c"] = counters
        if gauges:
            record["g"] = gauges
        if hists:
            record["h"] = hists
        return record

    def _bound_hist_deltas(
        self, metric: Histogram, series_deltas: Dict[Any, Dict[str, Any]]
    ) -> Dict[Any, Dict[str, Any]]:
        """Apply the registry's machine-cardinality bound to per-tick histogram
        increments by dressing them in ``collect()``'s shape (cumulative
        pairs + empty samples) so ``bound_machine_cardinality`` merges
        them with the exact same top-K + ``other`` semantics, then
        undressing back to per-bucket increments."""
        from .registry import MACHINE_LABEL

        if MACHINE_LABEL not in metric.labelnames:
            return series_deltas
        dressed = {}
        for key, payload in series_deltas.items():
            acc, cumulative = 0.0, []
            for bound, n in zip(metric.buckets, payload["d"]):
                acc += n
                cumulative.append((bound, acc))
            dressed[key] = {
                "buckets": cumulative,
                "sum": payload["sum"],
                "count": payload["n"],
                "samples": [],
                "exemplars": {},
            }
        bounded = bound_machine_cardinality(metric, dressed)
        out = {}
        for key, data in bounded.items():
            per_bucket, last = [], 0.0
            for _, acc in data["buckets"]:
                per_bucket.append(acc - last)
                last = acc
            out[key] = {
                "d": per_bucket, "sum": data["sum"], "n": data["count"],
            }
        return out

    # -- window queries --------------------------------------------------------
    def _window_records(
        self, window: float, now_wall: Optional[float] = None
    ) -> Tuple[List[Dict[str, Any]], float]:
        now_wall = self._wall() if now_wall is None else now_wall
        cutoff = now_wall - window
        records = [r for _, _, r in self._index if r.get("t", 0) > cutoff]
        covered = float(sum(r.get("dt", 0.0) for r in records))
        return records, covered

    def rate(
        self, metric: str, window: float,
        now_wall: Optional[float] = None,
    ) -> Dict[str, Any]:
        """Per-second increase rate of counter family ``metric`` over the
        trailing ``window`` seconds: summed per-tick deltas over covered
        tick time (Prometheus ``rate()`` over an increment store —
        counter resets cannot bite because increments were computed at
        write time)."""
        with self._lock:
            records, covered = self._window_records(window, now_wall)
        series: Dict[str, float] = {}
        for record in records:
            for key, delta in (record.get("c", {}).get(metric) or {}).items():
                series[key] = series.get(key, 0.0) + delta
        if covered <= 0:
            return {"total": 0.0, "series": {}, "coverage_s": 0.0}
        return {
            "total": sum(series.values()) / covered,
            "series": {k: v / covered for k, v in sorted(series.items())},
            "coverage_s": covered,
        }

    def histogram_window(
        self, metric: str, window: float,
        now_wall: Optional[float] = None,
    ) -> Optional[Dict[str, Any]]:
        """Merged per-bucket increments for histogram family ``metric``
        over the window (all series of the family summed), plus the
        interpolated p50/p90/p99 — the exact merge unit the router
        aggregates across workers."""
        with self._lock:
            records, covered = self._window_records(window, now_wall)
        le: Optional[List[Optional[float]]] = None
        deltas: Optional[List[float]] = None
        total_sum, total_n = 0.0, 0
        for record in records:
            payload = record.get("h", {}).get(metric)
            if not payload:
                continue
            if le is None:
                le = list(payload["le"])
                deltas = [0.0] * len(le)
            if list(payload["le"]) != le:
                continue  # bucket bounds changed across a restart
            for series in payload["s"].values():
                for i, d in enumerate(series["d"]):
                    deltas[i] += d
                total_sum += series["sum"]
                total_n += series["n"]
        if le is None or total_n <= 0:
            return None
        return {
            "le": le,
            "d": deltas,
            "sum": total_sum,
            "count": total_n,
            "coverage_s": covered,
            "p50": _bucket_percentile(le, deltas, 0.50),
            "p90": _bucket_percentile(le, deltas, 0.90),
            "p99": _bucket_percentile(le, deltas, 0.99),
        }

    def window_view(
        self, window: float, now_wall: Optional[float] = None
    ) -> Dict[str, Any]:
        """Every counter family's windowed rate + every histogram
        family's windowed buckets/percentiles, in ONE pass over the
        window's records (the per-request /telemetry path must not walk
        the index once per family)."""
        with self._lock:
            records, covered = self._window_records(window, now_wall)
        rate_series: Dict[str, Dict[str, float]] = {}
        hist_acc: Dict[str, Dict[str, Any]] = {}
        for record in records:
            for name, series in record.get("c", {}).items():
                into = rate_series.setdefault(name, {})
                for key, delta in series.items():
                    into[key] = into.get(key, 0.0) + delta
            for name, payload in record.get("h", {}).items():
                into = hist_acc.get(name)
                if into is None:
                    into = hist_acc[name] = {
                        "le": list(payload["le"]),
                        "d": [0.0] * len(payload["le"]),
                        "sum": 0.0,
                        "count": 0,
                    }
                if list(payload["le"]) != into["le"]:
                    continue  # bucket bounds changed across a restart
                for series in payload["s"].values():
                    for i, d in enumerate(series["d"]):
                        into["d"][i] += d
                    into["sum"] += series["sum"]
                    into["count"] += series["n"]
        view: Dict[str, Any] = {
            "window_s": window,
            "records": len(records),
            "coverage_s": covered,
            "rates": {},
            "histograms": {},
        }
        for name in sorted(rate_series):
            series = rate_series[name]
            if covered <= 0:
                continue
            view["rates"][name] = {
                "total": sum(series.values()) / covered,
                "series": {
                    k: v / covered for k, v in sorted(series.items())
                },
                "coverage_s": covered,
            }
        for name in sorted(hist_acc):
            merged = hist_acc[name]
            if merged["count"] <= 0:
                continue
            merged["coverage_s"] = covered
            for q, key in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99")):
                merged[key] = _bucket_percentile(
                    merged["le"], merged["d"], q
                )
            view["histograms"][name] = merged
        return view

    # -- the /telemetry payload ------------------------------------------------
    def view(
        self, window: float = 300.0, now_wall: Optional[float] = None
    ) -> Dict[str, Any]:
        with self._lock:
            oldest = self._index[0][2]["t"] if self._index else None
            newest = self._index[-1][2]["t"] if self._index else None
            warehouse = {
                "dir": self.directory,
                "segments": len(self._seg_bytes),
                "bytes": self.total_bytes(),
                "budget_bytes": self.budget,
                "segment_limit_bytes": self.segment_limit,
                "records": len(self._index),
                "oldest_t": oldest,
                "newest_t": newest,
                "ticks": self.ticks,
                "rotations": self.rotations,
            }
            costs = dict(self._costs)
        return {
            "v": 1,
            "enabled": True,
            "worker": self.worker,
            "now": self._wall() if now_wall is None else now_wall,
            "interval_s": self.min_interval,
            "warehouse": warehouse,
            "window": self.window_view(window, now_wall),
            "traffic": self.accountant.snapshot(),
            "costs": costs,
        }


# -- router-side aggregation (aggregate.py's scrape-of-scrapes, in JSON) ------

def _merge_costs(costs_list: List[Dict[str, Any]]) -> Dict[str, Any]:
    """Recursively merge per-worker cost ledgers: numeric leaves SUM
    (bytes, counts, seconds totals are additive across workers) except
    latency/percentile fields, which take MAX — summing two workers'
    p99s would fabricate a latency nobody measured; the worst worker is
    the honest fleet scalar (the registry's gauge rule)."""

    def is_latency_key(key: str) -> bool:
        return (
            "latency" in key
            or key.endswith(("_p50", "_p90", "_p99"))
            or key in ("p50", "p90", "p99")
        )

    def merge(into: Dict[str, Any], other: Dict[str, Any]) -> None:
        for key, value in other.items():
            current = into.get(key)
            if isinstance(value, dict):
                if not isinstance(current, dict):
                    current = into[key] = {}
                merge(current, value)
            elif isinstance(value, bool):
                into[key] = bool(current) or value
            elif isinstance(value, (int, float)):
                base = current if isinstance(current, (int, float)) else 0
                into[key] = (
                    max(base, value) if is_latency_key(key)
                    else base + value
                )
            elif current is None:
                into[key] = value

    out: Dict[str, Any] = {}
    for costs in costs_list:
        merge(out, costs or {})
    return out


def merge_views(views: Dict[str, Dict[str, Any]]) -> Dict[str, Any]:
    """Merge per-worker ``/telemetry`` payloads (keyed by worker name)
    into one fleet view with the same top-level shape, so the CLI and
    export renderer cannot tell a router from a worker. Increments are
    additive: rates and histogram bucket deltas SUM, percentiles are
    recomputed from the merged buckets."""
    ordered = [views[name] for name in sorted(views)]
    warehouse = {
        "segments": 0, "bytes": 0, "records": 0, "ticks": 0,
        "rotations": 0, "oldest_t": None, "newest_t": None,
    }
    window: Dict[str, Any] = {
        "window_s": 0.0, "records": 0, "coverage_s": 0.0,
        "rates": {}, "histograms": {},
    }
    for v in ordered:
        w = v.get("warehouse") or {}
        for key in ("segments", "bytes", "records", "ticks", "rotations"):
            warehouse[key] += int(w.get(key) or 0)
        for key, pick in (("oldest_t", min), ("newest_t", max)):
            if w.get(key) is not None:
                warehouse[key] = (
                    w[key] if warehouse[key] is None
                    else pick(warehouse[key], w[key])
                )
        wv = v.get("window") or {}
        window["window_s"] = max(window["window_s"],
                                 float(wv.get("window_s") or 0.0))
        window["records"] += int(wv.get("records") or 0)
        window["coverage_s"] = max(window["coverage_s"],
                                   float(wv.get("coverage_s") or 0.0))
        for name, rate in (wv.get("rates") or {}).items():
            into = window["rates"].setdefault(
                name, {"total": 0.0, "series": {}, "coverage_s": 0.0}
            )
            into["total"] += float(rate.get("total") or 0.0)
            into["coverage_s"] = max(into["coverage_s"],
                                     float(rate.get("coverage_s") or 0.0))
            for key, r in (rate.get("series") or {}).items():
                into["series"][key] = into["series"].get(key, 0.0) + r
        for name, merged in (wv.get("histograms") or {}).items():
            into = window["histograms"].get(name)
            if into is None:
                window["histograms"][name] = {
                    "le": list(merged["le"]),
                    "d": list(merged["d"]),
                    "sum": float(merged.get("sum") or 0.0),
                    "count": int(merged.get("count") or 0),
                    "coverage_s": float(merged.get("coverage_s") or 0.0),
                }
                continue
            if list(merged["le"]) != into["le"]:
                continue  # mixed bucket bounds across workers: keep first
            into["d"] = [a + b for a, b in zip(into["d"], merged["d"])]
            into["sum"] += float(merged.get("sum") or 0.0)
            into["count"] += int(merged.get("count") or 0)
            into["coverage_s"] = max(into["coverage_s"],
                                     float(merged.get("coverage_s") or 0.0))
    for merged in window["histograms"].values():
        for q, key in ((0.50, "p50"), (0.90, "p90"), (0.99, "p99")):
            merged[key] = _bucket_percentile(merged["le"], merged["d"], q)
    return {
        "v": 1,
        "enabled": True,
        "workers": sorted(views),
        "now": max(
            (float(v.get("now") or 0.0) for v in ordered), default=0.0
        ),
        "interval_s": max(
            (float(v.get("interval_s") or 0.0) for v in ordered),
            default=0.0,
        ),
        "warehouse": warehouse,
        "window": window,
        "traffic": traffic_mod.merge_snapshots(
            [v.get("traffic") or {} for v in ordered]
        ),
        "costs": _merge_costs([v.get("costs") or {} for v in ordered]),
    }


# -- the measured-cost ledger sample ------------------------------------------

def sample_costs(engine: Any, compile_store: Any = None) -> Dict[str, Any]:
    """One ledger sample from a live engine (and its compile-cache store):
    read from the serving process itself. Duck-typed on purpose:
    observability must not import the server package (the dependency
    points the other way). The ``compile`` block sums the store's entries:
    how many, their bytes, the build seconds they saved, and those seconds
    by the rung each library serves (``f32``, ``bf16``)."""
    costs: Dict[str, Any] = {}
    if engine is not None:
        costs["engine"] = engine.cost_ledger()
    if compile_store is not None:
        by_precision: Dict[str, float] = {}
        seconds_total = 0.0
        bytes_total = 0
        keys = 0
        for entry in compile_store.entries():
            keys += 1
            bytes_total += int(entry.get("bytes") or 0)
            seconds = float(entry.get("compile_seconds") or 0.0)
            seconds_total += seconds
            rung = str(entry.get("precision") or "")
            if rung:
                by_precision[rung] = by_precision.get(rung, 0.0) + seconds
        costs["compile"] = {
            "keys": keys,
            "bytes_total": bytes_total,
            "seconds_total": seconds_total,
            "by_precision": dict(sorted(by_precision.items())),
        }
    return costs


# -- the layout-input export (the layout compiler's input contract) ----------

def parse_window(value: Any) -> Optional[float]:
    """Parse a ``?window=`` / ``--window`` horizon into seconds. Accepts
    bare seconds (``"600"``, ``600``) and the warehouse horizon labels
    (``"1m"``, ``"10m"``, ``"1h"`` — :data:`traffic.HORIZONS`, plus the
    general ``<n>[s|m|h]`` suffix forms). Returns None on junk so
    callers can fall back to their default instead of 500ing."""
    if value is None:
        return None
    if isinstance(value, (int, float)) and not isinstance(value, bool):
        return float(value) if value > 0 else None
    text = str(value).strip().lower()
    if not text:
        return None
    scale = 1.0
    if text[-1] in ("s", "m", "h"):
        scale = {"s": 1.0, "m": 60.0, "h": 3600.0}[text[-1]]
        text = text[:-1]
    try:
        seconds = float(text) * scale
    except ValueError:
        return None
    return seconds if seconds > 0 else None


def resolve_horizon(window_s: Optional[float]) -> str:
    """The warehouse EWMA horizon label closest (in log-space) to the
    requested window — the layout compiler plans on this horizon's
    rates. No window requested → the middle horizon (``10m``): long
    enough to smooth burstiness, short enough to track a shifting
    fleet."""
    horizons = traffic_mod.HORIZONS
    if window_s is None or window_s <= 0:
        return horizons[min(1, len(horizons) - 1)][0]
    import math

    return min(
        horizons,
        key=lambda pair: abs(math.log(pair[1]) - math.log(window_s)),
    )[0]


def build_export(
    view: Dict[str, Any], window: Optional[float] = None
) -> Dict[str, Any]:
    """Render a ``/telemetry`` view (single worker or merged fleet) as
    the versioned layout-input document: machines × observed rate ×
    bytes × latency per rung. ``window`` selects the representative
    EWMA horizon (resolved to the nearest warehouse horizon and echoed
    as ``horizon``; each machine additionally carries the resolved
    scalar ``rate``). This is a CONTRACT — bump :data:`EXPORT_SCHEMA`
    on any shape change (the horizon/rate fields were ADDITIVE, so v1
    stands)."""
    traffic_view = view.get("traffic") or {}
    costs = view.get("costs") or {}
    engine_costs = costs.get("engine") or {}
    rung_costs = engine_costs.get("rungs") or {}
    window_view = view.get("window") or {}

    horizon = resolve_horizon(window)
    machines = [
        {
            "machine": m["machine"],
            "count": m["count"],
            "error": m["error"],
            "rates": dict(m.get("rates") or {}),
            "rate": float((m.get("rates") or {}).get(horizon) or 0.0),
        }
        for m in traffic_view.get("machines", ())
    ]
    # per-rung observed rates: traffic groups summed over shape buckets
    rung_rates: Dict[str, Dict[str, float]] = {}
    rung_counts: Dict[str, float] = {}
    for group in traffic_view.get("groups", ()):
        rung = group.get("precision") or ""
        if not rung:
            continue
        rates = rung_rates.setdefault(rung, {})
        for label, r in (group.get("rates") or {}).items():
            rates[label] = rates.get(label, 0.0) + float(r)
        rung_counts[rung] = (
            rung_counts.get(rung, 0.0) + float(group.get("count") or 0.0)
        )
    compile_by_rung = (costs.get("compile") or {}).get("by_precision") or {}
    rungs: Dict[str, Any] = {}
    for rung in sorted(set(rung_costs) | set(rung_rates)):
        entry = dict(rung_costs.get(rung) or {})
        requests = float(entry.get("requests") or 0.0)
        seconds = float(entry.get("dispatch_seconds_total") or 0.0)
        rungs[rung] = {
            "machines": int(entry.get("machines") or 0),
            "buckets": int(entry.get("buckets") or 0),
            "device_bytes": int(entry.get("device_bytes") or 0),
            "requests": requests,
            "count": rung_counts.get(rung, 0.0),
            "rates": rung_rates.get(rung, {}),
            "dispatch_seconds_total": seconds,
            "latency_s": seconds / requests if requests > 0 else None,
            "compile_seconds": float(compile_by_rung.get(rung) or 0.0),
        }
    total = traffic_view.get("total") or {}
    workers = view.get("workers")
    if workers is None:
        workers = [view.get("worker") or ""]
    return {
        "schema": EXPORT_SCHEMA,
        "generated_t": float(view.get("now") or 0.0),
        "window_s": float(
            window if window is not None
            else (window_view.get("window_s") or 0.0)
        ),
        "horizon": horizon,
        "source": {
            "workers": list(workers),
            "interval_s": float(view.get("interval_s") or 0.0),
            "coverage_s": float(window_view.get("coverage_s") or 0.0),
            "sketch_capacity": int(traffic_view.get("capacity") or 0),
        },
        "machines": machines,
        "rungs": rungs,
        "tiers": {
            "host_cache": dict(
                (engine_costs.get("host_cache") or {})
            ),
            "spill": dict((engine_costs.get("spill") or {})),
        },
        "totals": {
            "count": float(total.get("count") or 0.0),
            "rates": dict(total.get("rates") or {}),
            "machines_tracked": len(machines),
        },
    }


def validate_layout_input(doc: Any) -> List[str]:
    """Schema check for the layout-input document, dependency-free (no
    jsonschema in the image). Returns a list of problems — empty means
    the document honours the v1 contract."""
    problems: List[str] = []

    def num(value: Any) -> bool:
        return isinstance(value, (int, float)) and not isinstance(value, bool)

    if not isinstance(doc, dict):
        return ["document is not an object"]
    if doc.get("schema") != EXPORT_SCHEMA:
        problems.append(
            f"schema: expected {EXPORT_SCHEMA!r}, got {doc.get('schema')!r}"
        )
    for key in ("generated_t", "window_s"):
        if not num(doc.get(key)):
            problems.append(f"{key}: missing or not a number")
    if doc.get("horizon") is not None and not isinstance(
        doc.get("horizon"), str
    ):
        problems.append("horizon: not a string")
    source = doc.get("source")
    if not isinstance(source, dict) or not isinstance(
        source.get("workers"), list
    ):
        problems.append("source.workers: missing or not a list")
    machines = doc.get("machines")
    if not isinstance(machines, list):
        problems.append("machines: missing or not a list")
    else:
        for i, m in enumerate(machines):
            if not isinstance(m, dict) or not isinstance(
                m.get("machine"), str
            ):
                problems.append(f"machines[{i}].machine: missing or not a "
                                "string")
                continue
            for key in ("count", "error"):
                if not num(m.get(key)) or m[key] < 0:
                    problems.append(
                        f"machines[{i}].{key}: missing or negative"
                    )
            rates = m.get("rates")
            if not isinstance(rates, dict) or not all(
                num(r) for r in rates.values()
            ):
                problems.append(f"machines[{i}].rates: not a map of numbers")
            if m.get("rate") is not None and not num(m.get("rate")):
                problems.append(f"machines[{i}].rate: not a number")
    rungs = doc.get("rungs")
    if not isinstance(rungs, dict):
        problems.append("rungs: missing or not a map")
    else:
        for rung, entry in rungs.items():
            if not isinstance(entry, dict):
                problems.append(f"rungs[{rung}]: not an object")
                continue
            for key in ("machines", "device_bytes", "requests",
                        "compile_seconds"):
                if not num(entry.get(key)):
                    problems.append(
                        f"rungs[{rung}].{key}: missing or not a number"
                    )
            if entry.get("latency_s") is not None and not num(
                entry.get("latency_s")
            ):
                problems.append(f"rungs[{rung}].latency_s: not a number")
    tiers = doc.get("tiers")
    if not isinstance(tiers, dict) or not isinstance(
        tiers.get("host_cache"), dict
    ) or not isinstance(tiers.get("spill"), dict):
        problems.append("tiers: missing host_cache/spill objects")
    totals = doc.get("totals")
    if not isinstance(totals, dict) or not num(totals.get("count")):
        problems.append("totals.count: missing or not a number")
    return problems
