"""A minimal InfluxDB 1.x HTTP client on ``urllib`` (the port's copy of
``gordo_components_tpu/dataset/data_provider/influx_client.py:35-249``),
without pandas.

- :meth:`MinimalInfluxClient.write_points` takes the points as arrays: the
  field columns (a 2-D array, or one 1-D array per column, each of its own
  type), their names and int64 UTC-nanosecond timestamps. It writes them
  as line protocol (``POST /write?db=...&precision=ns``) with the
  reference's escaping and field rules: integer columns stay ``Ni``
  integer fields, a NaN or ``None`` field is left out, a row with no field
  left is skipped, strings are quoted, and a newline in an identifier or
  a string value raises ``ValueError`` (line protocol cannot carry one).
- :meth:`MinimalInfluxClient.query` runs one InfluxQL statement (``GET
  /query?db=...&q=...&epoch=ns``) and returns ``{series name:
  InfluxSeries}``: the points' int64 UTC nanoseconds and one array per
  column (int64 when every value is an integer, float64 when every value
  is a number or missing, else objects), as the reference's frames hold
  them.

Scope, as the reference's: HTTP(S) with basic or header auth, ns-precision
writes, single-statement queries; no UDP, no chunked responses, no
``GROUP BY`` tag keys. Transport options of the ``influxdb`` package that
this client cannot honour (``use_udp``, ``udp_port``, ``proxies``,
``cert``, ``verify_ssl=False``) raise instead of being dropped.
"""

from __future__ import annotations

import json
import urllib.error
import urllib.parse
import urllib.request
from base64 import b64encode
from typing import Any, Dict, List, NamedTuple, Optional, Sequence

import numpy as np


class InfluxQueryError(RuntimeError):
    """A non-2xx ``/query`` or ``/write`` response, with the server body."""


class InfluxSeries(NamedTuple):
    """One series of a query result: ``timestamps`` (int64 UTC ns) and
    ``columns`` (name -> array, in the server's column order)."""

    timestamps: np.ndarray
    columns: Dict[str, np.ndarray]


def _escape(value: str, *, chars: str) -> str:
    if "\n" in value or "\r" in value:
        # line protocol has no escape for a newline in an identifier: it
        # would split the point into a second, malformed line
        raise ValueError(
            f"newline in line-protocol identifier {value!r}; InfluxDB "
            "measurements/tags/field keys cannot contain line breaks"
        )
    out = value.replace("\\", "\\\\")
    for ch in chars:
        out = out.replace(ch, "\\" + ch)
    return out


def _escape_tag(value: str) -> str:
    # tag keys, tag values and field keys share one escape set
    return _escape(value, chars=",= ")


def _escape_measurement(value: str) -> str:
    return _escape(value, chars=", ")


def _field_value(value: Any) -> Optional[str]:
    """The line-protocol literal of one field, or ``None`` for a missing
    value (NaN, ``None``, NaT), which the line leaves out."""
    if value is None:
        return None
    if isinstance(value, (bool, np.bool_)):
        return "true" if value else "false"
    if isinstance(value, (int, np.integer)):
        return f"{int(value)}i"
    if isinstance(value, (float, np.floating)):
        if np.isnan(value):
            return None
        return repr(float(value))
    if isinstance(value, (np.datetime64, np.timedelta64)) and np.isnat(value):
        return None
    s = str(value)
    if "\n" in s or "\r" in s:
        raise ValueError(
            f"newline in string field value {s!r}; line protocol cannot "
            "represent line breaks"
        )
    s = s.replace("\\", "\\\\").replace('"', '\\"')
    return f'"{s}"'


def _column_literals(column: Any) -> List[Optional[str]]:
    # tolist() gives python scalars of the column's own type: an int64
    # column stays int (an 'Ni' field), never upcast to float by a row view
    values = column.tolist() if isinstance(column, np.ndarray) else list(column)
    return [_field_value(v) for v in values]


def _infer_column(values: List[Any]) -> np.ndarray:
    """The array a column's JSON values read as: int64 if all are integers,
    float64 if all are numbers or missing (``None`` -> NaN), else objects."""
    numbers = [v for v in values if v is not None]
    if all(isinstance(v, int) and not isinstance(v, bool) for v in numbers) and \
            len(numbers) == len(values) and values:
        return np.asarray(values, dtype=np.int64)
    if all(isinstance(v, (int, float)) and not isinstance(v, bool) for v in numbers):
        return np.asarray([np.nan if v is None else v for v in values], dtype=np.float64)
    return np.asarray(values, dtype=object)


class MinimalInfluxClient:
    """The reference's stdlib Influx client. Constructor keywords mirror
    the ``influxdb`` package's client so provider configs carry over;
    tuning keywords it has no use for (``pool_size``, ``retries``) are
    accepted and ignored."""

    def __init__(
        self,
        host: str = "localhost",
        port: int = 8086,
        username: Optional[str] = None,
        password: Optional[str] = None,
        database: Optional[str] = None,
        ssl: bool = False,
        timeout: Optional[float] = 30.0,
        headers: Optional[Dict[str, str]] = None,
        **_ignored: Any,
    ):
        # a keyword that selects another transport must not be dropped: the
        # client would then speak plain HTTP where UDP or unverified TLS
        # was configured
        for key in ("use_udp", "udp_port", "proxies", "cert"):
            if _ignored.get(key):
                raise ValueError(
                    f"MinimalInfluxClient does not support {key!r}; install "
                    "the optional 'influxdb' package for that transport"
                )
        if _ignored.get("verify_ssl") is False:
            raise ValueError(
                "MinimalInfluxClient always verifies TLS; install the "
                "optional 'influxdb' package for verify_ssl=False"
            )
        scheme = "https" if ssl else "http"
        self._base = f"{scheme}://{host}:{port}"
        self._database = database
        self._timeout = timeout
        self._headers = dict(headers or {})
        if username is not None:
            cred = b64encode(f"{username}:{password or ''}".encode()).decode("ascii")
            self._headers.setdefault("Authorization", f"Basic {cred}")

    def _request(self, path: str, params: Dict[str, str], body: Optional[bytes] = None) -> bytes:
        url = f"{self._base}{path}?{urllib.parse.urlencode(params)}"
        req = urllib.request.Request(
            url, data=body, headers=self._headers, method="POST" if body is not None else "GET"
        )
        try:
            with urllib.request.urlopen(req, timeout=self._timeout) as resp:
                return resp.read()
        except urllib.error.HTTPError as exc:
            detail = exc.read().decode("utf-8", "replace")
            raise InfluxQueryError(
                f"InfluxDB {path} returned HTTP {exc.code}: {detail[:500]}"
            ) from exc

    def query(self, q: str, database: Optional[str] = None) -> Dict[str, InfluxSeries]:
        """Run one InfluxQL statement; ``{series name: InfluxSeries}``
        (empty for an empty result)."""
        params = {"q": q, "epoch": "ns"}
        db = database or self._database
        if db:
            params["db"] = db
        payload = json.loads(self._request("/query", params).decode())
        out: Dict[str, InfluxSeries] = {}
        for result in payload.get("results", []):
            if "error" in result:
                raise InfluxQueryError(result["error"])
            for series in result.get("series", []):
                names = series["columns"]
                rows = series.get("values", [])
                columns = {
                    name: _infer_column([row[i] for row in rows])
                    for i, name in enumerate(names) if name != "time"
                }
                if "time" in names:
                    t = names.index("time")
                    timestamps = np.asarray([row[t] for row in rows], dtype=np.int64)
                else:
                    timestamps = np.zeros(0, dtype=np.int64)
                out[series["name"]] = InfluxSeries(timestamps, columns)
        return out

    def write_points(
        self,
        values: Any,
        columns: Sequence[str],
        timestamps: Any,
        measurement: str,
        tags: Optional[Dict[str, str]] = None,
        database: Optional[str] = None,
    ) -> bool:
        """Write one point per timestamp: ``columns`` name the fields,
        ``values`` holds them (rows x columns, or one array per column),
        ``timestamps`` are int64 UTC nanoseconds (or ``datetime64``), and
        ``tags`` apply to every point."""
        timestamps = np.asarray(timestamps)
        if np.issubdtype(timestamps.dtype, np.datetime64):
            timestamps = timestamps.astype("datetime64[ns]")
        timestamps = timestamps.astype(np.int64)
        if isinstance(values, np.ndarray) and values.ndim == 2:
            field_columns = [values[:, j] for j in range(values.shape[1])]
        else:
            field_columns = list(values)
        if len(field_columns) != len(columns):
            raise ValueError(f"{len(field_columns)} value columns for {len(columns)} names")
        tag_suffix = "".join(
            f",{_escape_tag(str(k))}={_escape_tag(str(v))}"
            for k, v in sorted((tags or {}).items())
        )
        prefix = _escape_measurement(measurement) + tag_suffix
        # serialized column by column, so each keeps its own type
        literals = [
            (_escape_tag(str(name)), _column_literals(column))
            for name, column in zip(columns, field_columns)
        ]
        for name, column in literals:
            if len(column) != len(timestamps):
                raise ValueError(f"column {name!r} holds {len(column)} values for "
                                 f"{len(timestamps)} timestamps")
        lines = []
        for i, ts in enumerate(timestamps.tolist()):
            fields = ",".join(
                f"{key}={column[i]}" for key, column in literals if column[i] is not None
            )
            if not fields:  # an all-missing row has no line-protocol form
                continue
            lines.append(f"{prefix} {fields} {ts}")
        if not lines:
            return True
        params = {"precision": "ns"}
        db = database or self._database
        if db:
            params["db"] = db
        self._request("/write", params, body="\n".join(lines).encode())
        return True

    def close(self) -> None:
        """Nothing to release: ``urllib`` keeps no pooled sockets."""
