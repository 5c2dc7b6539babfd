"""Client helpers (the port's copy of
``gordo_components_tpu/client/utils.py:16-42``), without pandas:
:func:`make_date_ranges` splits a prediction range into chunks, so a bulk
backfill streams as many small requests instead of one large one."""

from __future__ import annotations

import re
from datetime import datetime, timedelta, timezone
from typing import List, Tuple, Union

# the fixed-length units of pd.Timedelta that max_interval strings use
_UNITS = {"D": "days", "H": "hours", "h": "hours", "T": "minutes", "min": "minutes",
          "S": "seconds", "s": "seconds"}
_INTERVAL = re.compile(r"^\s*([+-]?\d+(?:\.\d*)?|[+-]?\.\d+)\s*(D|H|h|T|min|S|s)\s*$")


def parse_interval(text: str) -> timedelta:
    """``"<number><unit>"`` with a unit of ``D``, ``H``/``h``, ``T``/``min``
    or ``S``/``s`` -> a timedelta, as ``pd.Timedelta`` reads it. Anything
    else raises ``ValueError`` naming the string."""
    match = _INTERVAL.match(str(text))
    if match is None:
        raise ValueError(f"max_interval {text!r} is not a number followed by one of "
                         f"{', '.join(_UNITS)}")
    return timedelta(**{_UNITS[match.group(2)]: float(match.group(1))})


def parse_utc(value: Union[str, datetime]) -> datetime:
    """A datetime from ISO 8601 or a datetime; a naive one is UTC."""
    stamp = value if isinstance(value, datetime) else datetime.fromisoformat(str(value).strip())
    return stamp if stamp.tzinfo is not None else stamp.replace(tzinfo=timezone.utc)


def make_date_ranges(
    start: Union[str, datetime],
    end: Union[str, datetime],
    max_interval: str = "1D",
) -> List[Tuple[datetime, datetime]]:
    """Consecutive ``[start, end)`` chunks of at most ``max_interval``,
    tiling the range exactly (the last one ends at ``end``)."""
    start_ts, end_ts = parse_utc(start), parse_utc(end)
    if end_ts <= start_ts:
        raise ValueError(f"end ({end_ts}) must be after start ({start_ts})")
    delta = parse_interval(max_interval)
    if delta <= timedelta(0):
        raise ValueError(f"max_interval must be positive, got {max_interval!r}")
    ranges = []
    cursor = start_ts
    while cursor < end_ts:
        nxt = min(cursor + delta, end_ts)
        ranges.append((cursor, nxt))
        cursor = nxt
    return ranges
