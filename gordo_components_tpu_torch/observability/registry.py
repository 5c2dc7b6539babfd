"""Process-wide labeled metrics: Counter, Gauge, Histogram (the port's copy
of ``gordo_components_tpu/observability/registry.py``, with its hook by
which the traffic sketch nominates the machines a scrape keeps).

One ``threading.Lock`` per metric, held only for dict/list mutation. A
histogram keeps cumulative buckets (the Prometheus exposition), a bounded
rolling sample window (the JSON p50/p99 view) and, per bucket, the last
observation made under a bound trace id: its exemplar, which links the
bucket to a request timeline in the flight recorder. Registration is
get-or-create: a second ``counter(name, ...)`` returns the existing
metric, and a kind, label or bucket mismatch raises.

Families labeled by ``machine`` render (JSON snapshot and exposition) as
the top ``GORDO_METRICS_MACHINE_CARDINALITY`` machines by traffic plus one
``machine="other"`` aggregate; the series in memory stay exact. While
traffic accounting is on (``observability/traffic.py``), its sketch names
the kept machines for every family, so one scrape shows one survivor set;
otherwise each family ranks its own series.
"""

from __future__ import annotations

import bisect
import os
import threading
import time
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

from ..analysis import lockcheck

INF = float("inf")

MACHINE_LABEL = "machine"
MACHINE_OTHER = "other"

# the one top-K-by-traffic selection: observability.traffic installs a
# callable (cap -> machine names, or None) at import, so the dependency
# points from traffic to the registry and never back
_traffic_topk_provider: Optional[Callable[[int], Optional[List[str]]]] = None


def set_traffic_topk_provider(provider: Optional[Callable[[int], Optional[List[str]]]]) -> None:
    global _traffic_topk_provider
    _traffic_topk_provider = provider


def machine_cardinality_cap() -> int:
    """``GORDO_METRICS_MACHINE_CARDINALITY``: distinct machine label values
    rendered per family before the top-K + ``other`` collapse (default 64;
    ``0`` disables the bound)."""
    try:
        return int(os.environ.get("GORDO_METRICS_MACHINE_CARDINALITY", "64"))
    except ValueError:
        return 64


def _merge_histogram_data(into: Dict[str, Any], data: Dict[str, Any]) -> None:
    """Bucket-wise merge (and sum, count, samples, exemplars) of two
    ``Histogram.collect`` series of one metric."""
    into["buckets"] = [
        (le, acc + other_acc)
        for (le, acc), (_, other_acc) in zip(into["buckets"], data["buckets"])
    ]
    into["sum"] += data["sum"]
    into["count"] += data["count"]
    into["samples"] = (into["samples"] + data["samples"])[-1000:]
    for i, exemplar in (data.get("exemplars") or {}).items():
        current = into["exemplars"].get(i)
        if current is None or exemplar[2] >= current[2]:  # the newest wins
            into["exemplars"][i] = exemplar


def bound_machine_cardinality(
    metric: "_Metric", collected: Dict[Tuple[str, ...], Any]
) -> Dict[Tuple[str, ...], Any]:
    """Collapse ``collected`` (a ``metric.collect()`` mapping) so that at
    most the cap's distinct machine label values survive; the rest
    aggregate into ``machine="other"``: counters sum, gauges take the max,
    histograms merge bucket-wise. The kept machines are those the traffic
    provider nominates that this family has, the slots left filled by this
    family's own ranking (counter or gauge value, histogram count); with
    no provider, or one that nominates nothing, that ranking alone. A real
    machine named ``other`` folds into the aggregate."""
    if MACHINE_LABEL not in metric.labelnames:
        return collected
    cap = machine_cardinality_cap()
    if cap <= 0:
        return collected
    idx = metric.labelnames.index(MACHINE_LABEL)
    is_hist = isinstance(metric, Histogram)

    def weight(data: Any) -> float:
        return float(data["count"]) if is_hist else float(data)

    totals: Dict[str, float] = {}
    for key, data in collected.items():
        totals[key[idx]] = totals.get(key[idx], 0.0) + weight(data)
    if len(totals) <= cap:
        return collected
    ranked = sorted(totals, key=lambda m: (-totals[m], m))
    nominated = None
    if _traffic_topk_provider is not None:
        try:
            nominated = _traffic_topk_provider(cap)
        except Exception:  # noqa: BLE001  # lint: allow-swallow(a broken traffic sketch must not break metric rendering; the family's own ranking below is the documented fallback)
            nominated = None
    if nominated:
        # the sketch ranks by traffic over every family (at most ``cap``
        # names); only machines of THIS family can be kept, and slots left
        # go to its own ranking
        keep = set(nominated) & set(totals)
        for m in ranked:
            if len(keep) >= cap:
                break
            keep.add(m)
    else:
        keep = set(ranked[:cap])
    keep.discard(MACHINE_OTHER)
    out: Dict[Tuple[str, ...], Any] = {}
    for key, data in collected.items():
        if key[idx] in keep:
            out[key] = data
            continue
        okey = key[:idx] + (MACHINE_OTHER,) + key[idx + 1:]
        current = out.get(okey)
        if current is None:
            if is_hist:
                data = {
                    "buckets": list(data["buckets"]),
                    "sum": data["sum"],
                    "count": data["count"],
                    "samples": list(data["samples"]),
                    "exemplars": dict(data.get("exemplars") or {}),
                }
            out[okey] = data
        elif is_hist:
            _merge_histogram_data(current, data)
        elif isinstance(metric, Counter):
            out[okey] = current + data
        else:
            out[okey] = max(current, data)
    return out


_get_trace_id = None


def _current_trace_id() -> str:
    # bound lazily: tracing imports this module inside span(), so a
    # module-level import here would be circular
    global _get_trace_id
    if _get_trace_id is None:
        from .tracing import get_trace_id

        _get_trace_id = get_trace_id
    return _get_trace_id()

# latency-oriented default buckets (seconds)
DEFAULT_BUCKETS = (
    0.0005, 0.001, 0.0025, 0.005, 0.01, 0.025, 0.05, 0.1,
    0.25, 0.5, 1.0, 2.5, 5.0, 10.0, 30.0, INF,
)


def _label_key(labelnames: Sequence[str], values: Sequence[str]) -> str:
    """Series key rendered as in the exposition: ``a="x",b="y"``."""
    return ",".join(f'{n}="{v}"' for n, v in zip(labelnames, values))


class _Metric:
    kind = "untyped"

    def __init__(self, name: str, help: str = "", labelnames: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.labelnames = tuple(labelnames)
        self._lock = lockcheck.named_lock("observability.series")

    def _check_values(self, values: Tuple[str, ...]) -> Tuple[str, ...]:
        if len(values) != len(self.labelnames):
            raise ValueError(
                f"{self.name} takes {len(self.labelnames)} label value(s) "
                f"{self.labelnames}, got {len(values)}"
            )
        return tuple(str(v) for v in values)


class Counter(_Metric):
    """Monotonically increasing float per label set."""

    kind = "counter"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def labels(self, *values: str) -> "_Bound":
        return _Bound(self, self._check_values(values))

    def inc(self, amount: float = 1.0) -> None:
        self._inc((), amount)

    def _inc(self, values: Tuple[str, ...], amount: float) -> None:
        if amount < 0:
            raise ValueError(f"counter {self.name} cannot decrease")
        with self._lock:
            self._values[values] = self._values.get(values, 0.0) + amount

    def collect(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)


class Gauge(_Metric):
    """Last-written float per label set."""

    kind = "gauge"

    def __init__(self, name, help="", labelnames=()):
        super().__init__(name, help, labelnames)
        self._values: Dict[Tuple[str, ...], float] = {}

    def labels(self, *values: str) -> "_Bound":
        return _Bound(self, self._check_values(values))

    def set(self, value: float) -> None:
        self._set((), value)

    def inc(self, amount: float = 1.0) -> None:
        self._inc((), amount)

    def _inc(self, values: Tuple[str, ...], amount: float) -> None:
        with self._lock:
            self._values[values] = self._values.get(values, 0.0) + amount

    def _set(self, values: Tuple[str, ...], value: float) -> None:
        with self._lock:
            self._values[values] = float(value)

    def collect(self) -> Dict[Tuple[str, ...], float]:
        with self._lock:
            return dict(self._values)


def _percentile(samples: Sequence[float], q: float) -> float:
    """Nearest-rank percentile over the bounded sample window."""
    if not samples:
        return 0.0
    ordered = sorted(samples)
    n = len(ordered)
    return ordered[min(n - 1, int(round(q * (n - 1))))]


class _HistSeries:
    __slots__ = ("bucket_counts", "sum", "count", "samples", "exemplars")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets  # per bucket, not cumulative
        self.sum = 0.0
        self.count = 0
        self.samples: List[float] = []  # bounded rolling window
        # bucket index -> (trace_id, value, unix ts) of the last traced
        # observation in that bucket: at most one per bucket
        self.exemplars: Dict[int, Tuple[str, float, float]] = {}


class Histogram(_Metric):
    """Cumulative-bucket histogram plus a ``keep``-bounded sample window per
    label set."""

    kind = "histogram"

    def __init__(self, name, help="", labelnames=(),
                 buckets: Sequence[float] = DEFAULT_BUCKETS, keep: int = 1000):
        super().__init__(name, help, labelnames)
        bounds = sorted(float(b) for b in buckets)
        if not bounds or bounds[-1] != INF:
            bounds.append(INF)
        self.buckets = tuple(bounds)
        self.keep = keep
        self._series: Dict[Tuple[str, ...], _HistSeries] = {}

    def labels(self, *values: str) -> "_Bound":
        return _Bound(self, self._check_values(values))

    def observe(self, value: float) -> None:
        self._observe((), value)

    def _observe(self, values: Tuple[str, ...], value: float) -> None:
        value = float(value)
        i = bisect.bisect_left(self.buckets, value)
        # one context-variable read; the wall clock only under a trace
        trace_id = _current_trace_id()
        exemplar = (trace_id, value, time.time()) if trace_id else None
        with self._lock:
            series = self._series.get(values)
            if series is None:
                series = self._series[values] = _HistSeries(len(self.buckets))
            series.bucket_counts[i] += 1
            series.sum += value
            series.count += 1
            series.samples.append(value)
            if len(series.samples) > self.keep:
                del series.samples[: -self.keep]
            if exemplar is not None:
                series.exemplars[i] = exemplar

    def collect(self) -> Dict[Tuple[str, ...], Dict[str, Any]]:
        """``{labelvalues: {"buckets": [(le, cumulative)], "sum", "count",
        "samples", "exemplars": {bucket_index: (trace_id, value, ts)}}}``,
        copied under the lock."""
        with self._lock:
            copied = {
                values: (list(s.bucket_counts), s.sum, s.count, list(s.samples),
                         dict(s.exemplars))
                for values, s in self._series.items()
            }
        out: Dict[Tuple[str, ...], Dict[str, Any]] = {}
        for values, (counts, total, count, samples, exemplars) in copied.items():
            cumulative, acc = [], 0
            for le, n in zip(self.buckets, counts):
                acc += n
                cumulative.append((le, acc))
            out[values] = {"buckets": cumulative, "sum": total, "count": count,
                           "samples": samples, "exemplars": exemplars}
        return out

    def stats(self) -> Dict[Tuple[str, ...], Dict[str, float]]:
        """p50/p99/mean over the sample window, count over the lifetime."""
        out = {}
        for values, data in self.collect().items():
            samples = data["samples"]
            out[values] = {
                "count": data["count"],
                "p50": _percentile(samples, 0.50),
                "p99": _percentile(samples, 0.99),
                "mean": sum(samples) / len(samples) if samples else 0.0,
            }
        return out


class _Bound:
    """A metric with its label values bound."""

    __slots__ = ("_metric", "_values")

    def __init__(self, metric: _Metric, values: Tuple[str, ...]):
        self._metric = metric
        self._values = values

    def inc(self, amount: float = 1.0) -> None:
        self._metric._inc(self._values, amount)

    def set(self, value: float) -> None:
        self._metric._set(self._values, value)

    def observe(self, value: float) -> None:
        self._metric._observe(self._values, value)


class Registry:
    """Named metric collection with get-or-create registration."""

    def __init__(self) -> None:
        self._metrics: Dict[str, _Metric] = {}
        self._table_lock = lockcheck.named_lock("observability.registry")

    def _get_or_create(self, cls, name, help, labelnames, **kwargs) -> Any:
        labelnames = tuple(labelnames)
        with self._table_lock:
            existing = self._metrics.get(name)
            if existing is not None:
                if not isinstance(existing, cls) or existing.labelnames != labelnames:
                    raise ValueError(
                        f"metric {name!r} already registered as "
                        f"{existing.kind} with labels {existing.labelnames}; "
                        f"requested {cls.kind} with labels {labelnames}"
                    )
                if isinstance(existing, Histogram):
                    requested = Histogram(name, help, labelnames, **kwargs)
                    if (existing.buckets, existing.keep) != (requested.buckets, requested.keep):
                        raise ValueError(
                            f"histogram {name!r} already registered with buckets "
                            f"{existing.buckets} / keep {existing.keep}; requested "
                            f"{requested.buckets} / keep {requested.keep}"
                        )
                return existing
            metric = cls(name, help, labelnames, **kwargs)
            self._metrics[name] = metric
            return metric

    def counter(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help, labels)

    def gauge(self, name: str, help: str = "", labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help, labels)

    def histogram(self, name: str, help: str = "", labels: Sequence[str] = (),
                  buckets: Sequence[float] = DEFAULT_BUCKETS, keep: int = 1000) -> Histogram:
        return self._get_or_create(Histogram, name, help, labels, buckets=buckets, keep=keep)

    def metrics(self) -> List[_Metric]:
        with self._table_lock:
            return sorted(self._metrics.values(), key=lambda m: m.name)

    def snapshot(self) -> Dict[str, Any]:
        """JSON view: counters and gauges as values, histograms as {count,
        sum, mean, p50, p99} per series, keyed ``label="value"``."""
        out: Dict[str, Any] = {}
        for metric in self.metrics():
            if isinstance(metric, Histogram):
                series = {
                    _label_key(metric.labelnames, values): {
                        "count": data["count"],
                        "sum": data["sum"],
                        "mean": (sum(data["samples"]) / len(data["samples"])
                                 if data["samples"] else 0.0),
                        "p50": _percentile(data["samples"], 0.50),
                        "p99": _percentile(data["samples"], 0.99),
                    }
                    for values, data in bound_machine_cardinality(
                        metric, metric.collect()).items()
                }
            else:
                series = {
                    _label_key(metric.labelnames, values): value
                    for values, value in bound_machine_cardinality(
                        metric, metric.collect()).items()
                }
            out[metric.name] = {"kind": metric.kind, "help": metric.help, "series": series}
        return out


# THE process-wide registry every layer of the port records to
REGISTRY = Registry()
