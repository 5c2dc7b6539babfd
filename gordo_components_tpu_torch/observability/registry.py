"""Process-wide labeled metrics: Counter, Gauge, Histogram (the port's copy
of ``gordo_components_tpu/observability/registry.py``, without the
machine-label cardinality bound and exemplars, which serve paths the port
does not have yet).

One ``threading.Lock`` per metric, held only for dict/list mutation. A
histogram keeps cumulative buckets (the Prometheus exposition) and a
bounded rolling sample window (the JSON p50/p99 view). Registration is
get-or-create: a second ``counter(name, ...)`` returns the existing
metric, and a kind, label or bucket mismatch raises.
"""

from __future__ import annotations

import bisect
import threading
from typing import Any, Dict, List, Sequence, Tuple

INF = float("inf")

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
        self._lock = threading.Lock()

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
    __slots__ = ("bucket_counts", "sum", "count", "samples")

    def __init__(self, n_buckets: int):
        self.bucket_counts = [0] * n_buckets  # per bucket, not cumulative
        self.sum = 0.0
        self.count = 0
        self.samples: List[float] = []  # bounded rolling window


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

    def collect(self) -> Dict[Tuple[str, ...], Dict[str, Any]]:
        """``{labelvalues: {"buckets": [(le, cumulative)], "sum", "count",
        "samples"}}``, copied under the lock."""
        with self._lock:
            copied = {
                values: (list(s.bucket_counts), s.sum, s.count, list(s.samples))
                for values, s in self._series.items()
            }
        out: Dict[Tuple[str, ...], Dict[str, Any]] = {}
        for values, (counts, total, count, samples) in copied.items():
            cumulative, acc = [], 0
            for le, n in zip(self.buckets, counts):
                acc += n
                cumulative.append((le, acc))
            out[values] = {"buckets": cumulative, "sum": total, "count": count,
                           "samples": samples}
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
        self._lock = threading.Lock()

    def _get_or_create(self, cls, name, help, labelnames, **kwargs) -> Any:
        labelnames = tuple(labelnames)
        with self._lock:
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
        with self._lock:
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
                    for values, data in metric.collect().items()
                }
            else:
                series = {
                    _label_key(metric.labelnames, values): value
                    for values, value in metric.collect().items()
                }
            out[metric.name] = {"kind": metric.kind, "help": metric.help, "series": series}
        return out


# THE process-wide registry every layer of the port records to
REGISTRY = Registry()
