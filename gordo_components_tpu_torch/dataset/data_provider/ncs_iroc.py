"""The data-lake readers (the port's copy of
``gordo_components_tpu/dataset/data_provider/ncs_iroc.py:82-450``), in
numpy: every series is ``(name, int64 UTC ns, float64 values)``.

- :class:`NcsReader`: yearly files per tag under per-asset directories,
  ``<base_dir>/<asset>/<tag>/<tag>_<year>.parquet`` (else ``.csv``). A
  parquet file holds a ``value`` column and a ``timestamp`` column or a
  datetime index; a CSV file ``timestamp,value`` rows. Years without a
  file are skipped (a tag that started mid-history).
- :class:`IrocReader`: many tags per CSV under the asset directory,
  ``<base_dir>/<asset>/<anything>.csv`` with ``tag,timestamp,value``
  columns (the older spellings ``item_name``/``sensor``, ``t``/``time`` and
  ``average_value``/``avg`` read as those). Each file is parsed once per
  modification time.
- :class:`DataLakeProvider`: routes each tag to the reader that claims it
  (NCS first, then IROC), over a mounted ``base_dir`` or Azure Data Lake
  (``storename`` and credentials, :mod:`.azure_utils`; the client is made
  at the first lake touch).

Naive timestamps read as UTC and aware ones convert to UTC, as
``pd.to_datetime(..., utc=True)`` gives in the reference. Parquet is read
through ``pyarrow``, imported where a file is read.
"""

from __future__ import annotations

import csv
import io
import logging
import os
import threading
from datetime import datetime, timedelta, timezone
from typing import Any, Dict, Iterable, List, Optional, Tuple

import numpy as np

from ..sensor_tag import SensorTag
from .azure_utils import LocalFileSystem, create_adl_filesystem, parse_dl_service_auth_str
from .base import GordoBaseDataProvider, Series, datetime_to_ns

logger = logging.getLogger(__name__)

_EPOCH = datetime(1970, 1, 1, tzinfo=timezone.utc)


def _year(ns: int) -> int:
    return (_EPOCH + timedelta(microseconds=ns // 1000)).year


def _utc_ns(strings: List[str], origin: str) -> np.ndarray:
    from .providers import utc_ns

    try:
        return utc_ns(strings)
    except ValueError as exc:
        raise ValueError(f"{origin}: {exc}") from exc


def _csv_rows(handle) -> Tuple[List[str], List[List[str]]]:
    text = io.TextIOWrapper(handle, encoding="utf-8", newline="")
    rows = [row for row in csv.reader(text) if row]
    if not rows:
        return [], []
    return rows[0], rows[1:]


def _pick(names: List[str], wanted: str) -> Optional[str]:
    """The name among ``names`` that is ``wanted`` in any case."""
    return next((n for n in names if n.lower() == wanted), None)


def _read_csv_series(handle, origin: str) -> Tuple[np.ndarray, np.ndarray]:
    """``timestamp,value`` CSV -> (UTC ns, values)."""
    from .providers import _parse_values

    header, rows = _csv_rows(handle)
    t_name = _pick(header, "timestamp")
    if t_name is None:
        raise ValueError(f"{origin}: expected a 'timestamp' column (have {header})")
    others = [n for n in header if n != t_name]
    v_name = _pick(others, "value") or (others[0] if len(others) == 1 else None)
    if v_name is None:
        raise ValueError(f"{origin}: expected a 'value' column (have {header})")
    t_col, v_col = header.index(t_name), header.index(v_name)
    return (_utc_ns([row[t_col] for row in rows], origin),
            _parse_values([row[v_col] for row in rows]))


def _read_parquet_series(handle, origin: str) -> Tuple[np.ndarray, np.ndarray]:
    """A parquet table of a ``value`` column beside a ``timestamp`` column
    or a pandas datetime index -> (UTC ns, values)."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as exc:
        raise ImportError(f"reading {origin} needs the 'pyarrow' package, which is not "
                          "installed") from exc
    from .providers import pandas_index_columns

    table = pq.read_table(handle)
    index_cols = pandas_index_columns(table)
    data = [n for n in table.column_names if n not in index_cols]
    t_name = _pick(data, "timestamp") or next(iter(index_cols), None)
    if t_name is None:
        raise ValueError(f"{origin}: expected a 'timestamp' column or a datetime index "
                         f"(have {table.column_names})")
    others = [n for n in data if n != t_name]
    v_name = _pick(data, "value") or (others[0] if len(others) == 1 else None)
    if v_name is None:
        raise ValueError(f"{origin}: expected a 'value' column (have {data})")
    column = table.column(t_name)
    if pa.types.is_timestamp(column.type):
        # stored as UTC for an aware column, as the wall clock (read as
        # UTC) for a naive one
        ns = column.cast(pa.timestamp("ns", tz=column.type.tz)).cast(pa.int64())
        ns = ns.to_numpy().astype(np.int64)
    else:
        ns = _utc_ns([str(s) for s in column.to_pylist()], origin)
    values = table.column(v_name).cast(pa.float64()).to_numpy(zero_copy_only=False)
    return ns, np.asarray(values, dtype=np.float64)


def _sorted(ns: np.ndarray, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    order = np.argsort(ns, kind="stable")
    return ns[order], values[order]


class NcsReader(GordoBaseDataProvider):
    """Yearly per-tag files under per-asset directories (the NCS layout).
    ``fs`` is a :class:`~.azure_utils.LocalFileSystem`-shaped backend."""

    def __init__(self, base_dir: str, assets: Optional[List[str]] = None, fs=None):
        self._init_kwargs = {"base_dir": base_dir, "assets": assets}
        self.base_dir = base_dir
        self.assets = assets
        self._fs = fs or LocalFileSystem()
        # found tag directories only (a miss is looked up again: tags
        # arrive late), bounded: over a remote lake each lookup is stats
        self._dir_cache: Dict[Tuple[Optional[str], str], str] = {}

    def _tag_dir(self, tag: SensorTag) -> Optional[str]:
        key = (tag.asset, tag.name)
        cached = self._dir_cache.get(key)
        if cached is not None:
            return cached
        roots = []
        if tag.asset:
            roots.append(os.path.join(self.base_dir, tag.asset, tag.name))
        roots.append(os.path.join(self.base_dir, tag.name))
        found = next((root for root in roots if self._fs.isdir(root)), None)
        if found is not None:
            while len(self._dir_cache) >= 4096:
                self._dir_cache.pop(next(iter(self._dir_cache)))
            self._dir_cache[key] = found
        return found

    def can_handle_tag(self, tag: SensorTag) -> bool:
        if self.assets and tag.asset not in self.assets:
            return False
        return self._tag_dir(tag) is not None

    def _read_year(self, tag_dir: str, tag: SensorTag,
                   year: int) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        stem = os.path.join(tag_dir, f"{tag.name}_{year}")
        for ext, read in ((".parquet", _read_parquet_series), (".csv", _read_csv_series)):
            path = stem + ext
            try:  # opened directly: an exists() first doubles remote round trips
                handle = self._fs.open(path, "rb")
            except FileNotFoundError:
                continue
            with handle:
                return read(handle, path)
        return None

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        start, end = datetime_to_ns(train_start_date), datetime_to_ns(train_end_date)
        for tag in tag_list:
            tag_dir = self._tag_dir(tag)
            if tag_dir is None:
                raise FileNotFoundError(
                    f"No NCS directory for tag {tag.name!r} "
                    f"(asset {tag.asset!r}) under {self.base_dir!r}"
                )
            if dry_run:
                continue
            pieces = []
            for year in range(_year(start), _year(end) + 1):
                piece = self._read_year(tag_dir, tag, year)
                if piece is None:
                    logger.debug("NCS tag %r has no file for year %d (normal for partial "
                                 "histories)", tag.name, year)
                    continue
                pieces.append(piece)
            if not pieces:
                raise FileNotFoundError(
                    f"NCS tag {tag.name!r}: no yearly files in "
                    f"[{_year(start)}, {_year(end)}] under {tag_dir!r}"
                )
            ns, values = _sorted(np.concatenate([p[0] for p in pieces]),
                                 np.concatenate([p[1] for p in pieces]))
            keep = (ns >= start) & (ns < end)
            yield tag.name, ns[keep], values[keep]


class _IrocTable:
    """One asset's rows from its concatenated CSVs."""

    __slots__ = ("tags", "ns", "values")

    def __init__(self, tags: np.ndarray, ns: np.ndarray, values: np.ndarray):
        self.tags, self.ns, self.values = tags, ns, values


class IrocReader(GordoBaseDataProvider):
    """Concatenated many-tags-per-file CSVs under asset directories (the
    IROC layout), parsed once per (path, mtime)."""

    _COLUMN_ALIASES = {
        "item_name": "tag",
        "sensor": "tag",
        "t": "timestamp",
        "time": "timestamp",
        "average_value": "value",
        "avg": "value",
    }

    def __init__(self, base_dir: str, assets: Optional[List[str]] = None, fs=None):
        self._init_kwargs = {"base_dir": base_dir, "assets": assets}
        self.base_dir = base_dir
        self.assets = assets
        self._fs = fs or LocalFileSystem()
        self._dir_cache: Dict[str, str] = {}
        self._cache: Dict[Tuple[str, float], _IrocTable] = {}
        # an asset's files together, keyed by their (path, mtime) pairs, so
        # per-tag dispatch does not concatenate again per tag
        self._asset_cache: Dict[tuple, _IrocTable] = {}

    def _asset_dir(self, tag: SensorTag) -> Optional[str]:
        if not tag.asset:
            return None
        cached = self._dir_cache.get(tag.asset)
        if cached is not None:
            return cached
        path = os.path.join(self.base_dir, tag.asset)
        if not self._fs.isdir(path):
            return None
        while len(self._dir_cache) >= 1024:
            self._dir_cache.pop(next(iter(self._dir_cache)))
        self._dir_cache[tag.asset] = path
        return path

    def _read_file(self, path: str) -> _IrocTable:
        from .providers import _parse_values

        with self._fs.open(path, "rb") as handle:
            header, rows = _csv_rows(handle)
        header = [self._COLUMN_ALIASES.get(c.lower(), c.lower()) for c in header]
        missing = {"tag", "timestamp", "value"} - set(header)
        if missing:
            raise ValueError(f"IROC file {path!r} lacks columns {sorted(missing)} "
                             f"(have {header})")
        tag_col, t_col, v_col = (header.index(c) for c in ("tag", "timestamp", "value"))
        return _IrocTable(np.asarray([row[tag_col] for row in rows], dtype=object),
                          _utc_ns([row[t_col] for row in rows], path),
                          _parse_values([row[v_col] for row in rows]))

    def _asset_table(self, asset_dir: str) -> _IrocTable:
        paths = [os.path.join(asset_dir, entry) for entry in self._fs.listdir(asset_dir)
                 if entry.lower().endswith(".csv")]
        asset_key = tuple((p, self._fs.mtime(p)) for p in paths)
        cached_asset = self._asset_cache.get(asset_key)
        if cached_asset is not None:
            return cached_asset
        tables = []
        for key in asset_key:
            table = self._cache.get(key)
            if table is None:
                table = self._read_file(key[0])
                for old in [k for k in self._cache if k[0] == key[0]]:
                    del self._cache[old]  # the file's older modification times
                self._cache[key] = table
            tables.append(table)
        if not tables:
            raise FileNotFoundError(f"No IROC CSV files under {asset_dir!r}")
        result = _IrocTable(*(np.concatenate([getattr(t, f) for t in tables])
                              for f in _IrocTable.__slots__))
        while len(self._asset_cache) >= 8:
            self._asset_cache.pop(next(iter(self._asset_cache)))
        self._asset_cache[asset_key] = result
        return result

    def can_handle_tag(self, tag: SensorTag) -> bool:
        if self.assets and tag.asset not in self.assets:
            return False
        return self._asset_dir(tag) is not None

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        start, end = datetime_to_ns(train_start_date), datetime_to_ns(train_end_date)
        # one freshness probe (listdir and mtimes) per asset per call
        call_tables: Dict[str, _IrocTable] = {}
        for tag in tag_list:
            asset_dir = self._asset_dir(tag)
            if asset_dir is None:
                raise FileNotFoundError(
                    f"No IROC asset directory for tag {tag.name!r} "
                    f"(asset {tag.asset!r}) under {self.base_dir!r}"
                )
            if dry_run:
                continue
            table = call_tables.get(asset_dir)
            if table is None:
                table = call_tables[asset_dir] = self._asset_table(asset_dir)
            keep = (table.tags == tag.name) & (table.ns >= start) & (table.ns < end)
            if not keep.any():
                raise ValueError(
                    f"IROC asset {tag.asset!r} has no rows for tag "
                    f"{tag.name!r} in [{train_start_date}, {train_end_date})"
                )
            ns, values = _sorted(table.ns[keep], table.values[keep])
            yield tag.name, ns, values


class DataLakeProvider(GordoBaseDataProvider):
    """Routes each tag by asset to the reader that claims it: NCS's
    per-tag directories first, then IROC's concatenated CSVs.

    ``base_dir`` reads a mounted lake. Without it, ``storename`` reaches
    Azure Data Lake: credentials come from ``dl_service_auth_str``, the
    ``DL_SERVICE_AUTH_STR`` environment variable or ``interactive``; a
    given auth string is checked at construction, a missing one at the
    first lake touch, where the client is made (under a lock) through
    ``client_factory`` (the SDK's by default). ``adl_root`` prefixes the
    asset directories on the lake. The secret and the factory are never
    serialized: :meth:`to_dict` lands in served build metadata."""

    def __init__(
        self,
        base_dir: Optional[str] = None,
        interactive: bool = False,
        storename: Optional[str] = None,
        dl_service_auth_str: Optional[str] = None,
        assets: Optional[List[str]] = None,
        adl_root: str = "",
        client_factory: Optional[Any] = None,
        **kwargs: Any,
    ):
        self._init_kwargs = {
            "base_dir": base_dir,
            "interactive": interactive,
            "storename": storename,
            "assets": assets,
            **({"adl_root": adl_root} if adl_root else {}),
            **kwargs,
        }
        if base_dir is None and storename is None:
            raise ValueError(
                "DataLakeProvider needs a transport: base_dir=<mounted "
                "lake path>, or storename=<ADL store> with credentials "
                "(dl_service_auth_str / DL_SERVICE_AUTH_STR / interactive)"
            )
        self.interactive = interactive
        self.storename = storename
        self._assets = assets
        self._readers: Optional[List[GordoBaseDataProvider]] = None
        self._readers_lock = threading.Lock()
        self._make_fs = None
        if base_dir is not None:
            self.base_dir = base_dir
        else:
            self.base_dir = adl_root
            if dl_service_auth_str is not None:
                parse_dl_service_auth_str(dl_service_auth_str)

            def _make_fs():
                return create_adl_filesystem(storename, dl_service_auth_str=dl_service_auth_str,
                                             interactive=interactive,
                                             client_factory=client_factory)

            self._make_fs = _make_fs

    def _get_readers(self) -> List[GordoBaseDataProvider]:
        with self._readers_lock:  # one client and one warm cache across racing requests
            if self._readers is None:
                fs = self._make_fs() if self._make_fs is not None else None
                self._readers = [NcsReader(self.base_dir, assets=self._assets, fs=fs),
                                 IrocReader(self.base_dir, assets=self._assets, fs=fs)]
            return self._readers

    def _reader_for(self, tag: SensorTag) -> GordoBaseDataProvider:
        for reader in self._get_readers():
            if reader.can_handle_tag(tag):
                return reader
        raise FileNotFoundError(
            f"No reader (NCS/IROC) can handle tag {tag.name!r} "
            f"(asset {tag.asset!r}) under {self.base_dir!r}"
        )

    def can_handle_tag(self, tag: SensorTag) -> bool:
        return any(r.can_handle_tag(tag) for r in self._get_readers())

    def load_series(
        self,
        train_start_date: datetime,
        train_end_date: datetime,
        tag_list: List[SensorTag],
        dry_run: bool = False,
    ) -> Iterable[Series]:
        # runs of tags on one reader go in one call (the readers memoize
        # per call), in the caller's tag order
        run: List[SensorTag] = []
        run_reader: Optional[GordoBaseDataProvider] = None
        for tag in tag_list:
            reader = self._reader_for(tag)
            if reader is not run_reader and run:
                yield from run_reader.load_series(train_start_date, train_end_date, run,
                                                  dry_run=dry_run)
                run = []
            run_reader = reader
            run.append(tag)
        if run:
            yield from run_reader.load_series(train_start_date, train_end_date, run,
                                              dry_run=dry_run)
