"""Time-series dataset assembly in numpy: provider series → aligned
``(X, y)`` (the port's copy of ``gordo_components_tpu/dataset/
dataset.py:1-279``, which is pandas from end to end).

:func:`join_timeseries` reproduces ``resample(origin=start)`` (bins closed
and labelled left), the aggregations, ``interpolate(method="linear",
limit=n)`` / ``ffill(limit=n)``, ``dropna``, ``concat(join="inner")`` and
the ``[start, end)`` slice, on int64 UTC-nanosecond timestamps. The
aggregations follow pandas' own arithmetic: sum and mean add in bin order
with Kahan compensation, var and std run Welford's update (ddof 1), so a
bin's value is the same float64 pandas computes. Interpolation is
``np.interp`` over row positions, as pandas does for ``"linear"``.
Resolutions are fixed spans (``ns`` to ``D``); whole days bin from the
first point's midnight, where pandas ignores ``origin``. The aggregations
are those of :data:`AGGREGATIONS`; another raises ``ValueError``.
"""

from __future__ import annotations

import logging
import re
from datetime import datetime
from decimal import Decimal, InvalidOperation
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from . import query
from .base import GordoBaseDataset
from .data_provider.base import GordoBaseDataProvider, Series, datetime_to_ns
from .data_provider.providers import RandomDataProvider
from .sensor_tag import SensorTag, normalize_sensor_tags

logger = logging.getLogger(__name__)

_UNIT_NS = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000,
            "min": 60_000_000_000, "h": 3_600_000_000_000, "D": 86_400_000_000_000,
            "d": 86_400_000_000_000}
_SPAN_RE = re.compile(r"^\s*([0-9]+\.?[0-9]*|\.[0-9]+)\s*([A-Za-z]+)\s*$")
AGGREGATIONS = ("mean", "sum", "count", "min", "max", "std", "var", "median", "first", "last")


class InsufficientDataError(ValueError):
    """Raised when the assembled dataset has fewer rows than required."""


class Frame(NamedTuple):
    """A joined table: ``index`` int64 UTC ns (sorted, unique),
    ``columns`` names, ``values`` float64 of shape (rows, columns)."""

    index: np.ndarray
    columns: List[str]
    values: np.ndarray

    def take(self, names: List[str]) -> np.ndarray:
        return self.values[:, [self.columns.index(n) for n in names]]


def _normalize_resolution(resolution: str) -> str:
    """Legacy offsets ("10T", "1H", "30S") to modern spellings ("10min",
    "1h", "30s"); modern ones pass through."""
    legacy = {"T": "min", "H": "h", "S": "s", "L": "ms", "U": "us"}
    for suffix, modern in legacy.items():
        if resolution.endswith(suffix) and (resolution[:-1].isdigit() or resolution[:-1] == ""):
            return resolution[:-1] + modern
    return resolution


def _span_ns(text: str) -> int:
    """Nanoseconds of a fixed span ("10min", "8h", "1.5h", "1D"), as
    ``pd.Timedelta`` reads it."""
    match = _SPAN_RE.match(_normalize_resolution(text))
    unit = match and _UNIT_NS.get(match.group(2))
    if not unit:
        raise ValueError(f"unsupported resolution or span {text!r} (a number and one of "
                         f"{', '.join(_UNIT_NS)})")
    try:
        count = Decimal(match.group(1))
    except InvalidOperation as exc:
        raise ValueError(f"unsupported resolution or span {text!r}") from exc
    span = int(count * unit)
    if span <= 0:
        raise ValueError(f"resolution or span {text!r} must be positive")
    return span


def _parse_date(value: Union[str, datetime]) -> datetime:
    """A datetime from ISO 8601; a naive one stays naive (and is read as
    UTC wherever it becomes a timestamp)."""
    if isinstance(value, datetime):
        return value
    try:
        return datetime.fromisoformat(str(value).strip())
    except ValueError as exc:
        raise ValueError(f"{value!r} is not an ISO 8601 date") from exc


def _rank_groups(bins: np.ndarray) -> Iterable[np.ndarray]:
    """Row positions grouped by rank within their bin: the first point of
    every bin, then the second, ... (``bins`` sorted). Each group holds at
    most one point per bin, so a sequential per-bin update vectorizes."""
    counts = np.bincount(bins)
    rank = np.arange(len(bins)) - (np.cumsum(counts) - counts)[bins]
    order = np.argsort(rank, kind="stable")
    bounds = np.searchsorted(rank[order], np.arange(rank.max() + 2))
    for k in range(len(bounds) - 1):
        yield order[bounds[k]:bounds[k + 1]]


def _kahan_sum(bins: np.ndarray, values: np.ndarray, nbins: int) -> np.ndarray:
    total = np.zeros(nbins)
    compensation = np.zeros(nbins)
    for idx in _rank_groups(bins):
        b = bins[idx]
        y = values[idx] - compensation[b]
        t = total[b] + y
        c = (t - total[b]) - y
        compensation[b] = np.where(np.isnan(c), 0.0, c)  # an infinite value
        total[b] = t
    return total


def _welford_var(bins: np.ndarray, values: np.ndarray, nbins: int) -> np.ndarray:
    nobs = np.zeros(nbins)
    mean = np.zeros(nbins)
    m2 = np.zeros(nbins)
    for idx in _rank_groups(bins):
        b = bins[idx]
        val = values[idx]
        nobs[b] += 1
        old = mean[b]
        mean[b] = old + (val - old) / nobs[b]
        m2[b] += (val - mean[b]) * (val - old)
    with np.errstate(invalid="ignore", divide="ignore"):
        return np.where(nobs > 1, m2 / (nobs - 1), np.nan)


def _aggregate(method: str, bins: np.ndarray, values: np.ndarray, nbins: int) -> np.ndarray:
    """One aggregation per bin over the non-NaN points (``bins`` sorted);
    an empty bin gives NaN, or 0 for ``sum`` and ``count``."""
    counts = np.bincount(bins, minlength=nbins)
    if method == "count":
        return counts.astype(np.float64)
    if method in ("sum", "mean"):
        total = _kahan_sum(bins, values, nbins) if len(bins) else np.zeros(nbins)
        if method == "sum":
            return total
        with np.errstate(invalid="ignore", divide="ignore"):
            return total / counts
    if method in ("var", "std"):
        var = _welford_var(bins, values, nbins) if len(bins) else np.full(nbins, np.nan)
        return np.sqrt(var) if method == "std" else var
    out = np.full(nbins, np.nan)
    full = counts > 0
    starts = (np.cumsum(counts) - counts)[full]
    if not len(starts):
        return out
    if method == "min":
        out[full] = np.minimum.reduceat(values, starts)
    elif method == "max":
        out[full] = np.maximum.reduceat(values, starts)
    elif method == "first":
        out[full] = values[starts]
    elif method == "last":
        out[full] = values[starts + counts[full] - 1]
    elif method == "median":
        ordered = values[np.lexsort((values, bins))]
        n = counts[full]
        lo, hi = ordered[starts + (n - 1) // 2], ordered[starts + n // 2]
        out[full] = np.where(n % 2 == 1, hi, (hi + lo) / 2)
    else:
        raise ValueError(f"unsupported aggregation {method!r} (one of {', '.join(AGGREGATIONS)})")
    return out


def _last_valid(valid: np.ndarray) -> np.ndarray:
    """Position of the last valid row at or before each row (-1: none)."""
    return np.maximum.accumulate(np.where(valid, np.arange(len(valid)), -1))


def _interpolate(column: np.ndarray, limit: Optional[int]) -> np.ndarray:
    """``Series.interpolate(method="linear", limit=limit)``: every NaN after
    the first value is filled from its neighbours (the last value past the
    end), then NaNs more than ``limit`` rows after the last value, and the
    leading ones, are put back."""
    valid = ~np.isnan(column)
    if not valid.any() or valid.all():
        return column
    positions = np.arange(len(column))
    last = _last_valid(valid)
    keep_nan = ~valid & ((last < 0) | ((positions - last > limit) if limit is not None else False))
    out = column.copy()
    out[~valid] = np.interp(positions[~valid], positions[valid], column[valid])
    out[keep_nan] = np.nan
    return out


def _ffill(column: np.ndarray, limit: Optional[int]) -> np.ndarray:
    """``Series.ffill(limit=limit)``."""
    valid = ~np.isnan(column)
    last = _last_valid(valid)
    fill = ~valid & (last >= 0)
    if limit is not None:
        fill &= np.arange(len(column)) - last <= limit
    out = column.copy()
    out[fill] = column[last[fill]]
    return out


def _resample(timestamps: np.ndarray, values: np.ndarray, origin: int, step: int,
              methods: List[str]) -> Tuple[np.ndarray, np.ndarray]:
    """``resample(step, origin=origin)`` of one deduplicated, sorted series:
    bin labels (left edges from the bin of the first point to that of the
    last) and one column per method."""
    if step % _UNIT_NS["D"] == 0:
        # pandas resamples by whole days from the first point's midnight:
        # ``origin`` takes effect only for sub-day spans
        origin = int(timestamps[0]) // _UNIT_NS["D"] * _UNIT_NS["D"]
    bins = (timestamps - origin) // step  # floor: points before the origin too
    first = int(bins[0])
    nbins = int(bins[-1]) - first + 1
    labels = origin + (first + np.arange(nbins, dtype=np.int64)) * step
    valid = ~np.isnan(values)
    rel = (bins - first)[valid]
    kept = values[valid]
    return labels, np.stack([_aggregate(m, rel, kept, nbins) for m in methods], axis=1)


def join_timeseries(
    series_iterable: Iterable[Series],
    resampling_start: datetime,
    resampling_end: datetime,
    resolution: str,
    aggregation_methods: Union[str, List[str]] = "mean",
    interpolation_method: str = "linear_interpolation",
    interpolation_limit: Optional[str] = "8H",
) -> Tuple[Frame, Dict[str, Any]]:
    """Resample each ``(name, timestamps_ns, values)`` series onto a grid
    from ``resampling_start`` and inner-join them on the bin labels. Returns
    the joined :class:`Frame` and the per-tag metadata (original and
    resampled lengths, rows dropped by the join and by the range slice)."""
    step = _span_ns(resolution)
    if interpolation_method not in ("linear_interpolation", "ffill", "none"):
        raise ValueError(
            f"interpolation_method must be one of 'linear_interpolation', "
            f"'ffill', 'none'; got {interpolation_method!r}")
    single = isinstance(aggregation_methods, str)
    methods = [aggregation_methods] if single else list(aggregation_methods)
    for method in methods:
        if method not in AGGREGATIONS:
            raise ValueError(f"unsupported aggregation {method!r} "
                             f"(one of {', '.join(AGGREGATIONS)})")
    limit = None
    if interpolation_limit is not None:
        limit = max(1, int(_span_ns(interpolation_limit) / step))
    origin = datetime_to_ns(resampling_start)
    metadata: Dict[str, Any] = {}
    frames: List[Tuple[np.ndarray, List[str], np.ndarray]] = []

    for name, timestamps, values in series_iterable:
        timestamps = np.asarray(timestamps, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        original_count = len(timestamps)
        if original_count == 0:
            raise InsufficientDataError(f"Tag {name!r} has no data")
        timestamps, first = np.unique(timestamps, return_index=True)  # first of duplicates
        labels, table = _resample(timestamps, values[first], origin, step, methods)
        columns = [name] if single else [f"{name}_{m}" for m in methods]
        if interpolation_method != "none":
            fill = _interpolate if interpolation_method == "linear_interpolation" else _ffill
            table = np.stack([fill(table[:, j], limit) for j in range(table.shape[1])], axis=1)
        whole = ~np.isnan(table).any(axis=1)
        labels, table = labels[whole], table[whole]
        metadata.setdefault("tags", {})[str(name)] = {
            "original_length": original_count,
            "resampled_length": len(labels),
        }
        frames.append((labels, columns, table))

    if not frames:
        raise InsufficientDataError("No series to join (empty tag list?)")
    index = frames[0][0]
    for labels, _, _ in frames[1:]:
        index = np.intersect1d(index, labels, assume_unique=True)
    values = np.concatenate(
        [table[np.searchsorted(labels, index)] for labels, _, table in frames], axis=1)
    columns = [c for _, cols, _ in frames for c in cols]
    for name in metadata["tags"]:
        metadata["tags"][name]["dropped_by_join"] = (
            metadata["tags"][name]["resampled_length"] - len(index))
    before_slice = len(index)
    inside = (index >= origin) & (index < datetime_to_ns(resampling_end))
    joined = Frame(index[inside], columns, values[inside])
    metadata["dropped_by_range_slice"] = before_slice - len(joined.index)
    metadata["joined_length"] = len(joined.index)
    return joined, metadata


class TimeSeriesDataset(GordoBaseDataset):
    """Assemble per-tag provider series into aligned float32 ``(X, y)``.

    The parameters are the reference's: ``train_start_date`` /
    ``train_end_date`` (half-open), ``tag_list``, ``target_tag_list``
    (defaults to ``tag_list``), ``resolution`` (legacy "10T" accepted),
    ``row_filter`` (a ``DataFrame.query`` expression, :mod:`.query`),
    ``aggregation_methods``, ``row_threshold`` (fewer rows raise
    :class:`InsufficientDataError`), ``asset``, ``interpolation_method``
    and ``interpolation_limit``. After :meth:`get_data`, ``index`` holds
    the rows' int64 UTC-nanosecond timestamps and ``x_columns`` /
    ``y_columns`` the columns' names.
    """

    def __init__(
        self,
        train_start_date: Union[str, datetime],
        train_end_date: Union[str, datetime],
        tag_list: List,
        target_tag_list: Optional[List] = None,
        data_provider: Union[GordoBaseDataProvider, Dict[str, Any], None] = None,
        resolution: str = "10min",
        row_filter: Optional[str] = None,
        aggregation_methods: Union[str, List[str]] = "mean",
        row_threshold: int = 0,
        asset: Optional[str] = None,
        interpolation_method: str = "linear_interpolation",
        interpolation_limit: Optional[str] = "8H",
    ):
        self.train_start_date = _parse_date(train_start_date)
        self.train_end_date = _parse_date(train_end_date)
        if self.train_end_date <= self.train_start_date:
            raise ValueError(f"train_end_date ({self.train_end_date}) must be after "
                             f"train_start_date ({self.train_start_date})")
        self.tag_list = normalize_sensor_tags(tag_list, asset=asset)
        self.target_tag_list = (
            normalize_sensor_tags(target_tag_list, asset=asset)
            if target_tag_list else list(self.tag_list))
        if data_provider is None:
            data_provider = RandomDataProvider()
        elif isinstance(data_provider, dict):
            data_provider = GordoBaseDataProvider.from_dict(data_provider)
        self.data_provider = data_provider
        self.resolution = resolution
        self.row_filter = row_filter
        self.aggregation_methods = aggregation_methods
        self.row_threshold = row_threshold
        self.asset = asset
        self.interpolation_method = interpolation_method
        self.interpolation_limit = interpolation_limit
        self._metadata: Dict[str, Any] = {}
        self.index: Optional[np.ndarray] = None
        self.x_columns: List[str] = []
        self.y_columns: List[str] = []

        self._init_kwargs = {
            "train_start_date": self.train_start_date.isoformat(),
            "train_end_date": self.train_end_date.isoformat(),
            "tag_list": [t.to_dict() for t in self.tag_list],
            "target_tag_list": [t.to_dict() for t in self.target_tag_list],
            "data_provider": self.data_provider.to_dict(),
            "resolution": resolution,
            "row_filter": row_filter,
            "aggregation_methods": aggregation_methods,
            "row_threshold": row_threshold,
            "asset": asset,
            "interpolation_method": interpolation_method,
            "interpolation_limit": interpolation_limit,
        }

    def _columns_for(self, tags: List[SensorTag]) -> List[str]:
        if isinstance(self.aggregation_methods, str):
            return [t.name for t in tags]
        return [f"{t.name}_{m}" for t in tags for m in self.aggregation_methods]

    def get_data(self) -> Tuple[np.ndarray, np.ndarray]:
        # the union of feature and target tags, deduplicated by name: the
        # FIRST spelling wins, so a target never overrides a feature's asset
        seen: Dict[str, SensorTag] = {}
        for t in self.tag_list + self.target_tag_list:
            kept = seen.setdefault(t.name, t)
            if kept.asset != t.asset:
                logger.warning("Tag %r requested with conflicting assets %r and %r; "
                               "loading from %r", t.name, kept.asset, t.asset, kept.asset)
        series_iter = self.data_provider.load_series(
            self.train_start_date, self.train_end_date, list(seen.values()))
        joined, tag_metadata = join_timeseries(
            series_iter, self.train_start_date, self.train_end_date, self.resolution,
            aggregation_methods=self.aggregation_methods,
            interpolation_method=self.interpolation_method,
            interpolation_limit=self.interpolation_limit)
        filtered_count = 0
        if self.row_filter:
            keep = query.evaluate(self.row_filter, dict(zip(joined.columns, joined.values.T)))
            filtered_count = int((~keep).sum())
            joined = Frame(joined.index[keep], joined.columns, joined.values[keep])
        if len(joined.index) < self.row_threshold:
            raise InsufficientDataError(f"Only {len(joined.index)} rows after join/filter "
                                        f"(threshold {self.row_threshold})")
        self.x_columns = self._columns_for(self.tag_list)
        self.y_columns = self._columns_for(self.target_tag_list)
        self.index = joined.index
        X = joined.take(self.x_columns).astype(np.float32)
        y = joined.take(self.y_columns).astype(np.float32)
        self._metadata = {
            "tag_loading_metadata": tag_metadata,
            "rows_filtered": filtered_count,
            "x_shape": list(X.shape),
            "y_shape": list(y.shape),
            "tag_list": [t.name for t in self.tag_list],
            "target_tag_list": [t.name for t in self.target_tag_list],
            "resolution": self.resolution,
            "train_start_date": self.train_start_date.isoformat(),
            "train_end_date": self.train_end_date.isoformat(),
            "dataset_config": self.to_dict(),
        }
        return X, y

    def get_metadata(self) -> Dict[str, Any]:
        return dict(self._metadata)


class RandomDataset(TimeSeriesDataset):
    """:class:`TimeSeriesDataset` over a seeded :class:`RandomDataProvider`."""

    def __init__(
        self,
        train_start_date: Union[str, datetime] = "2023-01-01T00:00:00+00:00",
        train_end_date: Union[str, datetime] = "2023-02-01T00:00:00+00:00",
        tag_list: Optional[List] = None,
        **kwargs: Any,
    ):
        if tag_list is None:
            tag_list = ["tag-%d" % i for i in range(4)]
        kwargs.setdefault("data_provider", RandomDataProvider(min_size=600, max_size=900))
        kwargs.setdefault("resolution", "10min")
        super().__init__(train_start_date=train_start_date, train_end_date=train_end_date,
                         tag_list=tag_list, **kwargs)


# the closed table ``GordoBaseDataset.from_dict`` resolves through
DATASETS = {cls.__name__: cls for cls in (TimeSeriesDataset, RandomDataset)}
DATASET_MODULES = (
    "gordo_components_tpu.dataset",
    "gordo_components_tpu.dataset.dataset",
    "gordo_components_tpu_torch.dataset",
    __name__,
)
