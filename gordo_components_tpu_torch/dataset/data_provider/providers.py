"""The random, file, Influx, flaky and composite providers (the port's
copy of ``gordo_components_tpu/dataset/data_provider/providers.py:33-347``),
in numpy. The NCS, IROC and data-lake readers are in :mod:`.ncs_iroc`;
:data:`PROVIDERS` names them all.
"""

from __future__ import annotations

import csv
import hashlib
import json
import os
import re
from datetime import datetime
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..sensor_tag import SensorTag
from .base import GordoBaseDataProvider, Series, datetime_to_ns
# the lake readers import this module's helpers where they run, not here
from .ncs_iroc import DataLakeProvider, IrocReader, NcsReader


def provider_from_dict(config: Dict[str, Any]) -> GordoBaseDataProvider:
    return GordoBaseDataProvider.from_dict(config)


class RandomDataProvider(GordoBaseDataProvider):
    """Deterministic synthetic per-tag series: a seeded random walk plus a
    sinusoid and an offset, keyed by the md5 of the tag's name xor
    ``seed``. The same draws as the reference, and timestamps equal to
    ``pd.date_range(start, end, periods=n + 1)[:-1]`` to the nanosecond
    (``np.linspace`` over the span, in int64, as pandas computes it)."""

    def __init__(self, min_size: int = 100, max_size: int = 300, seed: int = 0):
        self._init_kwargs = {"min_size": min_size, "max_size": max_size, "seed": seed}
        self.min_size = min_size
        self.max_size = max_size
        self.seed = seed

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return True

    def _tag_seed(self, tag: SensorTag) -> int:
        digest = hashlib.md5(tag.name.encode()).digest()
        return (int.from_bytes(digest[:4], "little") ^ self.seed) & 0x7FFFFFFF

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        if train_end_date <= train_start_date:
            raise ValueError(f"train_end_date ({train_end_date}) must be after "
                             f"train_start_date ({train_start_date})")
        if dry_run:
            return
        start, end = datetime_to_ns(train_start_date), datetime_to_ns(train_end_date)
        for tag in tag_list:
            rng = np.random.default_rng(self._tag_seed(tag))
            n = int(rng.integers(self.min_size, self.max_size + 1))
            # n + 1 points, the last (== end) dropped: the range is half-open
            timestamps = (np.linspace(0, end - start, n + 1, dtype="int64") + start)[:-1]
            t = np.linspace(0.0, 8.0 * np.pi, n)
            values = (
                np.cumsum(rng.normal(scale=0.1, size=n))
                + np.sin(t + rng.uniform(0, 2 * np.pi))
                + rng.uniform(-5, 5)
            ).astype(np.float64)
            yield tag.name, timestamps, values


_OFFSET_RE = re.compile(r"^(.*?)(?:(Z)|([+-])(\d{2}):?(\d{2}))$")
_NA_STRINGS = {"", "nan", "NaN", "NAN", "NA", "N/A", "n/a", "null", "NULL", "None", "<NA>"}


def parse_timestamps(strings: List[str]) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """ISO 8601 strings → ``(wall-clock ns, UTC offset ns or None)``: the
    offset array is ``None`` when every string is naive. A file mixing
    naive and aware stamps raises ``ValueError``."""
    walls, offsets = [], []
    for text in strings:
        text = text.strip()
        match = _OFFSET_RE.match(text)
        if match and (match.group(2) or match.group(3)):
            walls.append(match.group(1))
            if match.group(2):
                offsets.append(0)
            else:
                sign = -1 if match.group(3) == "-" else 1
                offsets.append(sign * (int(match.group(4)) * 3600 + int(match.group(5)) * 60)
                               * 1_000_000_000)
        else:
            walls.append(text)
            offsets.append(None)
    try:
        wall_ns = np.array(walls, dtype="datetime64[ns]").astype(np.int64)
    except ValueError as exc:
        raise ValueError(f"unparseable timestamp: {exc}") from exc
    aware = [o is not None for o in offsets]
    if any(aware) and not all(aware):
        raise ValueError("timestamps mix naive and timezone-aware values")
    if not any(aware):
        return wall_ns, None
    return wall_ns, np.array(offsets, dtype=np.int64)


def utc_ns(strings: List[str]) -> np.ndarray:
    """ISO 8601 strings -> int64 UTC nanoseconds: aware ones converted,
    naive ones read as UTC (``pd.to_datetime(..., utc=True)``)."""
    wall, offsets = parse_timestamps(strings)
    return wall if offsets is None else wall - offsets


def pandas_index_columns(table) -> List[str]:
    """The columns a parquet table's pandas metadata names as its index
    (a RangeIndex is stored as metadata only, and is not one)."""
    meta = table.schema.metadata or {}
    if b"pandas" not in meta:
        return []
    return [c for c in json.loads(meta[b"pandas"]).get("index_columns", []) if isinstance(c, str)]


_POW10 = [float(f"1e{i}") for i in range(309)]
_DECIMAL = re.compile(r"^\s*([+-]?)(\d*)(?:\.(\d*))?(?:[eE]([+-]?\d+))?\s*$")


def _csv_float(text: str) -> float:
    """A CSV number as ``pd.read_csv`` reads it (its ``precise_xstrtod``):
    at most 17 significant digits accumulated in a double, then scaled by
    one power of ten. It can differ from Python's correctly rounded
    ``float`` in the last bit, so it is copied step for step; ``inf`` and
    the like go to ``float``."""
    match = _DECIMAL.match(text)
    if match is None or not (match.group(2) or match.group(3)):
        return float(text)
    sign, whole, frac, exp = match.groups()
    number, digits, exponent = 0.0, 0, 0
    for ch in whole:
        if digits < 17:
            number = number * 10.0 + (ord(ch) - 48)
            digits += 1
        else:
            exponent += 1
    for ch in frac or "":
        if digits >= 17:
            break
        number = number * 10.0 + (ord(ch) - 48)
        digits += 1
        exponent -= 1
    if sign == "-":
        number = -number
    if exp:
        exponent += int(exp)
    if exponent > 308:
        return float("inf") if number > 0 else float("-inf")
    if exponent > 0:
        return number * _POW10[exponent]
    if exponent < -616:
        return 0.0
    if exponent < -308:
        return number / _POW10[-308 - exponent] / _POW10[308]
    return number / _POW10[-exponent]


def _parse_values(strings: List[str]) -> np.ndarray:
    return np.array([np.nan if s.strip() in _NA_STRINGS else _csv_float(s) for s in strings],
                    dtype=np.float64)


def _read_csv(path: str) -> Tuple[np.ndarray, Optional[np.ndarray], np.ndarray]:
    """``(wall ns, offsets ns or None, values)`` of a ``timestamp,value``
    CSV file (the value is the ``value`` column, else the first other)."""
    with open(path, newline="") as fh:
        rows = list(csv.reader(fh))
    if not rows or "timestamp" not in rows[0]:
        raise ValueError(f"{path}: a CSV file needs a 'timestamp' column")
    header = rows[0]
    t_col = header.index("timestamp")
    others = [i for i in range(len(header)) if i != t_col]
    if not others:
        raise ValueError(f"{path}: no value column")
    v_col = header.index("value") if "value" in header else others[0]
    body = [row for row in rows[1:] if row]
    try:
        wall, offsets = parse_timestamps([row[t_col] for row in body])
    except ValueError as exc:
        raise ValueError(f"{path}: {exc}") from exc
    return wall, offsets, _parse_values([row[v_col] for row in body])


def _read_parquet(path: str, naive_start: bool) -> Tuple[np.ndarray, Optional[np.ndarray],
                                                         np.ndarray]:
    """The same triple from a parquet file, through pyarrow. A tz-aware
    column gives UTC nanoseconds, or its wall clock when the requested
    range is naive (as ``tz_localize(None)`` gives in the reference)."""
    try:
        import pyarrow as pa
        import pyarrow.compute as pc
        import pyarrow.parquet as pq
    except ImportError as exc:
        raise ImportError(f"reading {path} needs the 'pyarrow' package, which is not "
                          "installed") from exc
    table = pq.read_table(path)
    names = table.column_names
    index_cols = pandas_index_columns(table)
    t_name = "timestamp" if "timestamp" in names else next(iter(index_cols), None)
    if t_name is None:
        raise ValueError(f"{path}: a parquet file needs a 'timestamp' column or index")
    others = [n for n in names if n != t_name and n not in index_cols]
    if not others:
        raise ValueError(f"{path}: no value column")
    v_name = "value" if "value" in others else others[0]
    column = table.column(t_name)
    if pa.types.is_timestamp(column.type):
        aware = column.type.tz is not None
        if aware and naive_start:
            column = pc.local_timestamp(column)
        ns = column.cast(pa.timestamp("ns", tz=column.type.tz)).cast(pa.int64())
        ns = ns.to_numpy().astype(np.int64)
        offsets = np.zeros_like(ns) if aware and not naive_start else None
    else:
        ns, offsets = parse_timestamps([str(s) for s in column.to_pylist()])
    values = table.column(v_name).cast(pa.float64()).to_numpy().astype(np.float64)
    return ns, offsets, values


class FileDataProvider(GordoBaseDataProvider):
    """Per-tag files under ``<base_dir>/[<asset>/]<tag_name>.{parquet|csv}``,
    CSV with columns ``(timestamp, value)``. Naive file timestamps read as
    UTC against an aware range; aware ones against a naive range read as
    their wall clock, as in the reference."""

    def __init__(self, base_dir: str, assets: Optional[List[str]] = None):
        self._init_kwargs = {"base_dir": base_dir, "assets": assets}
        self.base_dir = base_dir
        self.assets = assets

    def _candidate_paths(self, tag: SensorTag) -> List[str]:
        stems = []
        if tag.asset:
            stems.append(os.path.join(self.base_dir, tag.asset, tag.name))
        stems.append(os.path.join(self.base_dir, tag.name))
        return [stem + ext for stem in stems for ext in (".parquet", ".csv")]

    def can_handle_tag(self, tag: SensorTag) -> bool:
        if self.assets and tag.asset not in self.assets:
            return False
        return any(os.path.exists(p) for p in self._candidate_paths(tag))

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        naive_start = train_start_date.tzinfo is None
        start, end = datetime_to_ns(train_start_date), datetime_to_ns(train_end_date)
        for tag in tag_list:
            path = next((p for p in self._candidate_paths(tag) if os.path.exists(p)), None)
            if path is None:
                raise FileNotFoundError(f"No file for tag {tag.name!r} under {self.base_dir!r}")
            if dry_run:
                continue
            if path.endswith(".parquet"):
                wall, offsets, values = _read_parquet(path, naive_start)
            else:
                wall, offsets, values = _read_csv(path)
            # aware stamps: UTC against an aware range, their wall clock
            # against a naive one
            ns = wall if offsets is None or naive_start else wall - offsets
            keep = (ns >= start) & (ns < end)
            yield tag.name, ns[keep], values[keep]


class InfluxDataProvider(GordoBaseDataProvider):
    """InfluxQL reads, one query per tag: ``SELECT "<value_name>" FROM
    "<measurement>" WHERE tag = '<tag>' AND time >= <start> AND time <
    <end>``, with the names quoted and escaped (tag names come from fleet
    configs, not code).

    The client is the injected ``client`` (tests, pre-authenticated
    sessions; never serialized), else :class:`~.influx_client.
    MinimalInfluxClient` over ``influx_config`` (``host``, ``port``,
    ``database``, ``username``, ``password``, ``ssl``, ...), with
    ``api_key`` in the ``api_key_header`` header
    (``Ocp-Apim-Subscription-Key`` by default). The reference prefers the
    ``influxdb`` package's ``DataFrameClient`` when it is installed and
    falls back to the same minimal client; the port always takes the
    minimal client, since the other is built on pandas. The API key and
    the password are never serialized: :meth:`to_dict` lands in served
    build metadata. ``dry_run`` asks each tag's query with ``LIMIT 1``.
    """

    def __init__(
        self,
        measurement: str = "sensor_data",
        value_name: str = "value",
        api_key: Optional[str] = None,
        api_key_header: Optional[str] = None,
        client: Any = None,
        **influx_config: Any,
    ):
        from .influx_client import MinimalInfluxClient

        self._init_kwargs = {
            "measurement": measurement,
            "value_name": value_name,
            **{k: v for k, v in influx_config.items() if k != "password"},
        }
        self.measurement = measurement
        self.value_name = value_name
        self.influx_config = influx_config
        if client is None:
            headers = ({api_key_header or "Ocp-Apim-Subscription-Key": api_key}
                       if api_key else None)
            client = MinimalInfluxClient(headers=headers, **influx_config)
        self._client = client

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return True

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        safe_measurement = self.measurement.replace('"', '\\"')
        safe_value = self.value_name.replace('"', '\\"')
        for tag in tag_list:
            safe_tag = tag.name.replace("\\", "\\\\").replace("'", "\\'")
            query = (
                f'SELECT "{safe_value}" FROM "{safe_measurement}" '
                f"WHERE tag = '{safe_tag}' "
                f"AND time >= '{train_start_date.isoformat()}' "
                f"AND time < '{train_end_date.isoformat()}'"
            )
            if dry_run:  # availability only: never the whole range
                self._client.query(query + " LIMIT 1")
                continue
            series = self._client.query(query).get(self.measurement)
            if series is None:
                yield tag.name, np.zeros(0, np.int64), np.zeros(0, np.float64)
                continue
            if self.value_name not in series.columns:
                raise ValueError(
                    f"Influx result for tag {tag.name!r} has no {self.value_name!r} column "
                    f"(columns: {list(series.columns)}); check value_name/measurement"
                )
            # the client's epoch=ns times are UTC; sorted as the reference sorts
            order = np.argsort(series.timestamps, kind="stable")
            values = np.asarray(series.columns[self.value_name], dtype=np.float64)
            yield tag.name, series.timestamps[order], values[order]


class FlakyDataProvider(GordoBaseDataProvider):
    """Fault injection for tests: delegates to ``provider`` (a
    :class:`RandomDataProvider` of ``provider_kwargs`` by default) but
    raises ``IOError`` after ``fail_after`` yielded series, on each of its
    first ``fail_times`` calls; it exercises the builders' retries and
    resume without a real outage."""

    def __init__(self, provider: Any = None, fail_after: int = 1, fail_times: int = 1,
                 **provider_kwargs: Any):
        if provider is None:
            provider = RandomDataProvider(**provider_kwargs)
        elif isinstance(provider, dict):
            provider = GordoBaseDataProvider.from_dict(provider)
        self.provider = provider
        self.fail_after = fail_after
        self.fail_times = fail_times
        self._failures = 0
        self._init_kwargs = {"provider": provider.to_dict(), "fail_after": fail_after,
                             "fail_times": fail_times}

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return self.provider.can_handle_tag(tag)

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        yielded = 0
        for series in self.provider.load_series(train_start_date, train_end_date, tag_list,
                                                dry_run=dry_run):
            if self._failures < self.fail_times and yielded >= self.fail_after:
                self._failures += 1
                raise IOError(f"Injected provider failure after {yielded} series "
                              f"(failure {self._failures}/{self.fail_times})")
            yielded += 1
            yield series


class CompositeDataProvider(GordoBaseDataProvider):
    """Each tag from the first sub-provider that can handle it; runs of
    consecutive tags that share a provider go in one ``load_series``."""

    def __init__(self, providers: List[Any]):
        self.providers = [
            p if isinstance(p, GordoBaseDataProvider) else GordoBaseDataProvider.from_dict(p)
            for p in providers
        ]
        self._init_kwargs = {"providers": [p.to_dict() for p in self.providers]}

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return any(p.can_handle_tag(tag) for p in self.providers)

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        assignments: List[GordoBaseDataProvider] = []
        for tag in tag_list:
            provider = next((p for p in self.providers if p.can_handle_tag(tag)), None)
            if provider is None:
                raise ValueError(f"No provider can handle tag {tag!r}")
            assignments.append(provider)
        i = 0
        while i < len(tag_list):
            provider = assignments[i]
            j = i
            while j < len(tag_list) and assignments[j] is provider:
                j += 1
            yield from provider.load_series(
                train_start_date, train_end_date, tag_list[i:j], dry_run=dry_run)
            i = j


# the closed table ``GordoBaseDataProvider.from_dict`` resolves through
PROVIDERS = {
    cls.__name__: cls for cls in (RandomDataProvider, FileDataProvider, InfluxDataProvider,
                                  FlakyDataProvider, CompositeDataProvider, NcsReader,
                                  IrocReader, DataLakeProvider)
}
PROVIDER_MODULES = (
    "gordo_components_tpu.dataset.data_provider",
    "gordo_components_tpu.dataset.data_provider.providers",
    "gordo_components_tpu.dataset.data_provider.ncs_iroc",
    "gordo_components_tpu_torch.dataset.data_provider",
    "gordo_components_tpu_torch.dataset.data_provider.ncs_iroc",
    __name__,
)
