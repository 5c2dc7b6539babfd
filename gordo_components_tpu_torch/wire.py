"""Scoring wire formats (the port's copy of ``gordo_components_tpu/wire.py``).

Negotiated per request, byte-compatible with the reference both ways:

- ``application/x-gordo-npz`` (listed in the request's ``Accept``): ONE
  ``np.savez`` blob holding the score arrays at their native float32 and a
  small JSON header (thresholds, timestamps) as a uint8 member. The
  decoder hands back numpy arrays: no per-element work on either side.
- JSON, the default: array blocks rendered row at a time with ``%.17g``
  (which round-trips float64, and so every float32 score) and spliced into
  the ``{"data": {...}, <extras>}`` template; non-finite values fall back
  to the generic encoder. Decoded and cast to float32, the values equal
  the npz path's.

Timestamps ride both formats as the reference writes them, pandas'
``Timestamp.isoformat()`` strings (:func:`iso_timestamps`).
"""

from __future__ import annotations

import io
import json
import re
from datetime import datetime, timedelta, timezone, tzinfo
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np

NPZ_CONTENT_TYPE = "application/x-gordo-npz"

SCORE_FIELDS = (
    "model-input",
    "model-output",
    "tag-anomaly-scores",
    "total-anomaly-score",
)

# npz member carrying the JSON header as utf-8 bytes
_HEADER_MEMBER = "__header__"


_EPOCH = datetime(1970, 1, 1)
_FIXED_OFFSET = re.compile(r"^([+-])(\d{2}):?(\d{2})$")


def _zone(tz: str) -> tzinfo:
    if tz.upper() in ("UTC", "Z", "ETC/UTC"):
        return timezone.utc
    fixed = _FIXED_OFFSET.match(tz)
    if fixed:
        sign = -1 if fixed.group(1) == "-" else 1
        return timezone(sign * timedelta(hours=int(fixed.group(2)), minutes=int(fixed.group(3))))
    from zoneinfo import ZoneInfo

    return ZoneInfo(tz)


def iso_timestamps(ns: Sequence[int], tz: Optional[str] = "UTC") -> List[str]:
    """int64 UTC nanoseconds as pandas' ``Timestamp.isoformat()`` gives
    them in the zone ``tz`` (``None``: naive wall clock, no offset): six
    fractional digits when the microseconds are not zero, nine when the
    nanoseconds are not."""
    zone = None if tz is None else _zone(tz)
    out = []
    for value in np.asarray(ns, dtype=np.int64).tolist():
        micros, nanos = divmod(value, 1000)
        stamp = _EPOCH + timedelta(microseconds=micros)
        if zone is not None:
            stamp = stamp.replace(tzinfo=timezone.utc).astimezone(zone)
        wall = stamp.replace(tzinfo=None).isoformat()
        offset = stamp.isoformat()[len(wall):]  # "" when naive, else "+HH:MM"
        if nanos:  # pandas prints the nanoseconds after the microseconds
            wall = (wall if "." in wall else wall + ".000000") + f"{nanos:03d}"
        text = wall + offset
        out.append(text)
    return out


def content_type_of(header: Optional[str]) -> str:
    """The media type of a ``Content-Type`` value: lowercase, parameters
    stripped."""
    return (header or "").split(";")[0].strip().lower()


def wants_npz(accept: Optional[str]) -> bool:
    """Whether an ``Accept`` header lists ``application/x-gordo-npz``
    (q-values are ignored: a client that lists the format speaks it)."""
    if not accept:
        return False
    return any(content_type_of(part) == NPZ_CONTENT_TYPE for part in accept.split(","))


def encode_npz(arrays: Dict[str, np.ndarray], header: Optional[Dict[str, Any]] = None) -> bytes:
    """One uncompressed ``np.savez`` blob: each array at its native dtype
    and ``header`` as a JSON uint8 member."""
    buf = io.BytesIO()
    members: Dict[str, np.ndarray] = {
        name: np.ascontiguousarray(arr) for name, arr in arrays.items()
    }
    members[_HEADER_MEMBER] = np.frombuffer(
        json.dumps(header or {}, default=str).encode("utf-8"), dtype=np.uint8
    )
    np.savez(buf, **members)
    return buf.getvalue()


def decode_npz(blob: bytes) -> Tuple[Dict[str, np.ndarray], Dict[str, Any]]:
    """``encode_npz`` inverse → ``(arrays, header)``. Never unpickles; any
    decode failure raises ``ValueError``."""
    try:
        with np.load(io.BytesIO(blob), allow_pickle=False) as archive:
            header: Dict[str, Any] = {}
            if _HEADER_MEMBER in archive.files:
                header = json.loads(archive[_HEADER_MEMBER].tobytes().decode("utf-8"))
            arrays = {name: archive[name] for name in archive.files if name != _HEADER_MEMBER}
    except ValueError:
        raise
    except Exception as exc:
        raise ValueError(f"not a readable npz payload: {exc}") from exc
    return arrays, header


def payload_from_npz(blob: bytes) -> Dict[str, Any]:
    """An npz response in the JSON payload's shape: ``{"data": {<arrays>,
    "timestamps": [...]}, <extras>}``, the arrays left as numpy arrays."""
    arrays, header = decode_npz(blob)
    data: Dict[str, Any] = dict(arrays)
    extras = {}
    for key, value in header.items():
        if key == "timestamps":
            data["timestamps"] = value
        else:
            extras[key] = value
    return {"data": data, **extras}


def format_float_array(arr: np.ndarray) -> str:
    arr = np.asarray(arr)
    if not np.isfinite(arr).all():
        return json.dumps(arr.tolist())
    if arr.ndim == 1:
        if arr.size == 0:
            return "[]"
        fmt = ",".join(["%.17g"] * arr.shape[0])
        return "[" + fmt % tuple(arr.tolist()) + "]"
    if arr.ndim != 2:
        return json.dumps(arr.tolist())
    if arr.shape[0] == 0:
        return "[]"
    fmt = ",".join(["%.17g"] * arr.shape[1])
    rows = (fmt % tuple(row) for row in arr.tolist())
    return "[[" + "],[".join(rows) + "]]"


def encode_scored_json(
    arrays: Dict[str, np.ndarray],
    timestamps: Optional[List[str]] = None,
    extras: Optional[Dict[str, Any]] = None,
) -> str:
    parts = ['{"data":{']
    for i, (name, arr) in enumerate(arrays.items()):
        if i:
            parts.append(",")
        parts.append(json.dumps(name))
        parts.append(":")
        parts.append(format_float_array(arr))
    if timestamps is not None:
        parts.append(',"timestamps":')
        parts.append(json.dumps(timestamps, default=str))
    parts.append("}")
    for key, value in (extras or {}).items():
        parts.append(",")
        parts.append(json.dumps(key))
        parts.append(":")
        parts.append(json.dumps(value, default=str))
    parts.append("}")
    return "".join(parts)
