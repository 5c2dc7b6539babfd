"""Time-series dataset assembly in numpy: provider series → aligned
``(X, y)`` (the port's copy of ``gordo_components_tpu/dataset/
dataset.py:1-279``, which is pandas from end to end).

:func:`join_timeseries` reproduces ``resample(origin=start)`` (bins closed
and labelled left), the aggregations, ``interpolate(method="linear",
limit=n)`` / ``ffill(limit=n)``, ``dropna``, ``concat(join="inner")`` and
the ``[start, end)`` slice, on int64 UTC-nanosecond timestamps. The
aggregations follow pandas' own arithmetic: sum and mean add in bin order
with Kahan compensation, var and std run Welford's update (ddof 1), so a
bin's value is the same float64 pandas computes; ``prod`` multiplies in
bin order, ``sem`` is the square root of the Welford variance over the
count, ``quantile`` pandas' linear interpolation at 0.5, ``size``
counts the bin's rows with their NaNs and ``nunique`` its distinct values.
Interpolation is ``np.interp`` over row positions, as pandas does for
``"linear"``.

Resolutions are fixed spans (``ns`` to ``D``, a bare unit reading as one)
or the calendar offsets ``W``/``W-<day>``, ``ME``, ``MS``,
``QE``/``QE-<month>``, ``QS``/``QS-<month>``, ``YE``/``YE-<month>``,
``YS``/``YS-<month>``, their business forms (``BME``, ``BMS``, ``CBME``,
``CBMS``, ``BQE``, ``BQS``, ``BYE``, ``BYS``), the business days ``B`` and
``C``, the semi-months ``SME``/``SME-<day>`` and ``SMS``/``SMS-<day>``,
the half years ``HYE``, ``HYS``, ``BHYE`` and ``BHYS`` (with month
anchors), the weeks of month ``WOM-<week><day>`` and ``LWOM-<day>``, the
52-53-week fiscal years ``RE-<N|L>-<month>-<day>`` and their quarters
``REQ-<N|L>-<month>-<day>-<quarter>``, and the business hours ``bh`` and
``cbh`` (09:00-17:00), each with an optional multiple (:class:`_Calendar`;
``C``, ``CBME``, ``CBMS`` and ``cbh`` with pandas' default week and no
holidays, where they equal the plain business forms): every offset
prefix pandas' ``to_offset`` reads. Whole days bin from the first point's midnight,
and calendar offsets from pandas' own edges
(``_get_timestamp_range_edges``, ``date_range``, ``_adjust_bin_edges``):
the end offsets (``W``, ``ME``, ``QE``, ``YE``, ``BME``, ``BQE``, ``BYE``)
close and label their bins on the right, the others on the left; pandas
ignores ``origin`` for all of them. An ``interpolation_limit`` divides by
the resolution read as ``pd.Timedelta`` reads it, which refuses every
calendar offset but a numbered week.

The aggregations are those of :data:`AGGREGATIONS`, and in a list also
the groupby reductions of :data:`LIST_REDUCTIONS` (one number per bin)
and the groupby methods of :data:`LIST_TRANSFORMS`, which answer per
point: their column is indexed by the points' timestamps, mixed with
reductions the index is the union in pandas' order, and the joined frame
keeps the first series' order (:func:`_resample`). Where the reference
raises (an alias pandas refuses, an unknown method, a groupby attribute
it cannot aggregate with, ``ohlc``'s four columns, a zero or negative
multiple, ``idxmin`` over a bin without a number, a linear interpolation
over a bool column that the union gave NaNs), the port raises the same
exception type; it raises ``TypeError`` too for ``hist``, ``plot`` and
``unique`` in a list, whose frame holds no numbers (objects per bin, which
pandas' interpolation refuses). The upsampling methods ``Resampler.agg``
takes by name alone (``ffill``, ``bfill``, ``nearest``, ``asfreq``,
``interpolate``) read the series at the bin labels (:func:`_upsample`).
"""

from __future__ import annotations

import calendar
import logging
import re
from datetime import date, datetime, time, timedelta
from decimal import Decimal
from typing import Any, Dict, Iterable, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from . import query
from .base import GordoBaseDataset
from .data_provider.base import GordoBaseDataProvider, Series, datetime_to_ns
from .data_provider.providers import RandomDataProvider
from .sensor_tag import SensorTag, normalize_sensor_tags

logger = logging.getLogger(__name__)

_EPOCH = date(1970, 1, 1)
_EPOCH_DT = datetime(1970, 1, 1)

_UNIT_NS = {"ns": 1, "us": 1_000, "ms": 1_000_000, "s": 1_000_000_000,
            "min": 60_000_000_000, "h": 3_600_000_000_000, "D": 86_400_000_000_000,
            "d": 86_400_000_000_000}
# what pd.Timedelta reads: a signed number and a unit, weeks among them
_TIMEDELTA_RE = re.compile(r"^\s*([+-]?)\s*([0-9]+\.?[0-9]*|\.[0-9]+)\s*([A-Za-z]+)\s*$")
# a fixed resampling span: an optional plus sign and number, and a unit
_TICK_RE = re.compile(r"^\s*(\+?)\s*([0-9]+\.?[0-9]*|\.[0-9]+)?\s*([A-Za-z]+)\s*$")
_CALENDAR_RE = re.compile(r"^\s*([+-]?[0-9]*)\s*(CBME|CBMS|BHYE|BHYS|BME|BMS|BQE|BQS|BYE|BYS|HYE|HYS|"
                          r"SME|SMS|LWOM|WOM|ME|MS|QE|QS|YE|YS|W|w|B|b|C|c|bh|cbh)"
                          r"(?:-([A-Za-z0-9]*))?\s*$")
# a 52-53-week fiscal year (RE) or its quarters (REQ): the variation, the
# month, the weekday and, for the quarters, the quarter given the extra week
_FISCAL_RE = re.compile(r"^\s*([+-]?[0-9]*)\s*(REQ|RE)-([NL])-([A-Z]{3})-([A-Z]{3})(?:-([0-9]+))?\s*$")
_WEEKDAYS = ("MON", "TUE", "WED", "THU", "FRI", "SAT", "SUN")
_MONTHS = ("JAN", "FEB", "MAR", "APR", "MAY", "JUN", "JUL", "AUG", "SEP", "OCT", "NOV", "DEC")
AGGREGATIONS = ("mean", "sum", "count", "min", "max", "std", "var", "median", "first", "last",
                "prod", "size", "nunique", "sem", "quantile")
# SeriesGroupBy reductions that the reference's list path (agg([...])) takes
# and that give one number per bin: any and all as 1.0/0.0 (pandas' bool),
# idxmin and idxmax as the point's UTC nanoseconds (pandas' timestamp read
# as float64)
LIST_REDUCTIONS = ("any", "all", "skew", "kurt", "idxmin", "idxmax")
# Resampler methods that agg() takes by name and that read the series at
# the bin labels instead of reducing a bin (alone, never in a list)
_UPSAMPLING = ("ffill", "bfill", "nearest", "asfreq", "interpolate")
# SeriesGroupBy methods that the reference's list path takes and that
# answer per point, not per bin (:func:`_transform`): their column is
# indexed by the points' timestamps
LIST_TRANSFORMS = ("ffill", "bfill", "cumsum", "cumprod", "cummin", "cummax", "cumcount", "diff",
                   "shift", "rank", "pct_change", "ngroup", "head", "tail", "nlargest",
                   "nsmallest")
# how many points of a bin head, tail, nlargest and nsmallest keep (pandas'
# default n)
_KEEP = 5
# the other SeriesGroupBy attributes, which the reference's agg refuses:
# with TypeError or ValueError in a list (``expanding``, ``AttributeError``),
# with TypeError alone (the rest alone, ``AttributeError``)
_LIST_TYPE_ERRORS = ("agg", "aggregate", "apply", "corr", "cov", "dtype", "exclusions", "filter",
                     "get_group", "groups", "indices", "is_monotonic_decreasing",
                     "is_monotonic_increasing", "keys", "level", "ndim", "ngroups", "nth",
                     "pipe", "resample", "rolling", "sample", "take", "transform",
                     "value_counts",
                     # objects per bin (arrays, plots): pandas' interpolation
                     # refuses them, and a frame of them holds no numbers
                     "hist", "plot", "unique")
_LIST_VALUE_ERRORS = ("describe", "ewm")
_SINGLE_TYPE_ERRORS = ("agg", "aggregate", "apply", "get_group", "keys", "level", "pipe",
                       "transform")


class InsufficientDataError(ValueError):
    """Raised when the assembled dataset has fewer rows than required."""


class Frame(NamedTuple):
    """A joined table: ``index`` int64 UTC ns (unique; sorted unless a
    list transform ordered it otherwise, as the reference's frame is),
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


def _timedelta_ns(text: str) -> int:
    """Nanoseconds of ``text`` as ``pd.Timedelta`` reads it (the reference's
    ``interpolation_limit`` arithmetic): a signed number and a unit, weeks
    (``W``) among them; a bare unit or a calendar offset raises
    ``ValueError``."""
    match = _TIMEDELTA_RE.match(_normalize_resolution(text))
    unit = match and {**_UNIT_NS, "W": 7 * _UNIT_NS["D"], "w": 7 * _UNIT_NS["D"]}.get(
        match.group(3))
    if not unit:
        raise ValueError(f"unsupported span {text!r}: pd.Timedelta reads a number and one of "
                         f"{', '.join(_UNIT_NS)}, W")
    span = int(Decimal(match.group(2)) * unit)
    return -span if match.group(1) == "-" else span


class _Calendar(NamedTuple):
    """A calendar offset: ``kind`` (``D``, ``W``, ``B``, ``C``, a month
    offset of :data:`_MONTH_DAY`, ``SME``, ``SMS``, ``WOM``, ``LWOM``, a
    quarter, half-year or year offset, or the business hours ``BH`` and
    ``CBH``), its multiple ``n`` and its anchor (the weekday, 0 = Monday,
    of a week or a last week of month; the month of a quarter's, a half
    year's or a year's offset; the day of month of a semi-month's; 7 x the
    week (0-3) + the weekday of a week of month's; a fiscal year's or
    quarter's :class:`_Fiscal`)."""

    kind: str
    n: int
    anchor: Any

    @property
    def end(self) -> bool:
        """An end offset: its bins are closed and labelled on the right
        (pandas' ``end_types``)."""
        return self.kind in ("W", "ME", "QE", "YE", "BME", "BQE", "BYE")


# the day of its month that each month, quarter and year offset falls on
_MONTH_DAY = {"ME": "end", "MS": "start", "BME": "business_end", "BMS": "business_start",
              "CBME": "business_end", "CBMS": "business_start"}
_QUARTER_DAY = {"QE": "end", "QS": "start", "BQE": "business_end", "BQS": "business_start"}
_HALF_YEAR_DAY = {"HYE": "end", "HYS": "start", "BHYE": "business_end", "BHYS": "business_start"}
_YEAR_DAY = {"YE": "end", "YS": "start", "BYE": "business_end", "BYS": "business_start"}
# a semi-month offset's default day and the least it takes (pandas')
_SEMI_MONTH_LEAST = {"SME": 1, "SMS": 2}


class _Fiscal(NamedTuple):
    """A 52-53-week fiscal year's shape (pandas' ``FY5253``): it ends on
    ``weekday`` last in ``month`` (``last``) or nearest its end, and in a
    53-week year quarter ``extra_week`` (``FY5253Quarter``) has 14 weeks."""

    month: int
    weekday: int
    last: bool
    extra_week: int


def _parse_fiscal(resolution: str) -> Optional[_Calendar]:
    """``RE-<N|L>-<month>-<weekday>`` or ``REQ-...-<quarter>``, or None."""
    match = _FISCAL_RE.match(resolution)
    if match is None:
        return None
    count, kind, variation, month, weekday, quarter = match.groups()
    if month not in _MONTHS or weekday not in _WEEKDAYS or (quarter is None) != (kind == "RE"):
        raise ValueError(f"Invalid frequency: {resolution}")
    n = int(count) if count not in ("", "+", "-") else (-1 if count == "-" else 1)
    if n == 0:
        raise ValueError(f"Invalid frequency: {resolution}")
    return _Calendar(kind, n, _Fiscal(_MONTHS.index(month) + 1, _WEEKDAYS.index(weekday),
                                      variation == "L", int(quarter or 0)))


def _parse_calendar(resolution: str) -> Optional[_Calendar]:
    """The calendar offset ``resolution`` names (pandas' spelling: ``W`` or
    ``w``, the weekday in any case; ``B`` or ``b``; the month anchors upper
    case; a semi-month's day in digits), or None for a fixed span. A
    misspelt anchor raises ``ValueError``."""
    fiscal = _parse_fiscal(resolution)
    if fiscal is not None:
        return fiscal
    match = _CALENDAR_RE.match(resolution)
    if match is None:
        return None
    count, kind, suffix = match.groups()
    kind = kind.upper() if kind in ("w", "b", "c", "bh", "cbh") else kind
    n = int(count) if count not in ("", "+", "-") else (-1 if count == "-" else 1)
    if suffix is None:
        if kind in ("WOM", "LWOM"):
            raise ValueError(f"Invalid frequency: {resolution}")
        anchor = {"W": 6, "QE": 12, "BQE": 12, "QS": 1, "BQS": 1, "HYE": 12, "BHYE": 12,
                  "HYS": 1, "BHYS": 1, "YE": 12, "BYE": 12, "YS": 1, "BYS": 1, "SME": 15,
                  "SMS": 15}.get(kind, 0)
    elif kind == "W" and suffix.upper() in _WEEKDAYS:
        anchor = _WEEKDAYS.index(suffix.upper())
    elif kind == "LWOM" and suffix in _WEEKDAYS:
        anchor = _WEEKDAYS.index(suffix)
    elif kind == "WOM" and len(suffix) == 4 and suffix[0] in "1234" and suffix[1:] in _WEEKDAYS:
        anchor = (int(suffix[0]) - 1) * 7 + _WEEKDAYS.index(suffix[1:])
    elif (kind in _QUARTER_DAY or kind in _HALF_YEAR_DAY or kind in _YEAR_DAY) and \
            suffix in _MONTHS:
        anchor = _MONTHS.index(suffix) + 1
    elif kind in _SEMI_MONTH_LEAST and suffix.isdigit() and \
            _SEMI_MONTH_LEAST[kind] <= int(suffix) <= 27:
        anchor = int(suffix)
    else:
        raise ValueError(f"Invalid frequency: {resolution}")
    if n == 0 and kind in ("WOM", "LWOM"):
        raise ValueError("N cannot be 0")  # as pandas' week-of-month offsets refuse
    return _Calendar(kind, n, anchor)


def _days_in_month(year: int, month: int) -> int:
    return calendar.monthrange(year, month)[1]


def _month_day(year: int, month: int, which: Union[str, Tuple[str, int]]) -> int:
    """The day of the month an offset falls on: its first, its last, its
    first or last weekday, or (``("week", anchor)``, ``("last week",
    weekday)``) a week of month's weekday."""
    if isinstance(which, tuple):
        kind, anchor = which
        if kind == "week":
            week, weekday = divmod(anchor, 7)
            return 1 + (weekday - date(year, month, 1).weekday()) % 7 + week * 7
        last = _days_in_month(year, month)
        return last - (date(year, month, last).weekday() - anchor) % 7
    if which == "start":
        return 1
    if which == "business_start":
        weekday = date(year, month, 1).weekday()
        return 1 if weekday < 5 else 8 - weekday
    last = _days_in_month(year, month)
    if which == "end":
        return last
    return last - max(0, date(year, month, last).weekday() - 4)


def _shift_month(day: date, months: int, which: Union[str, int, Tuple[str, int]]) -> date:
    """``day`` moved by ``months``, onto its month's day ``which`` (a
    :func:`_month_day` name, or a day number, clipped to the month)."""
    total = day.year * 12 + day.month - 1 + months
    year, month = divmod(total, 12)
    month += 1
    if isinstance(which, int):
        return date(year, month, min(which, _days_in_month(year, month)))
    return date(year, month, _month_day(year, month, which))


def _fiscal_year_end(fiscal: _Fiscal, year: int) -> date:
    """``FY5253.get_year_end``: the fiscal year's last day in ``year``."""
    target = date(year, fiscal.month, _days_in_month(year, fiscal.month))
    diff = fiscal.weekday - target.weekday()
    if diff == 0:
        return target
    if fiscal.last:
        return target + timedelta(days=diff % 7 - 7)
    forward = diff % 7
    return target + timedelta(days=forward if forward <= 3 else forward - 7)


def _fiscal_on_offset(fiscal: _Fiscal, day: date) -> bool:
    if _fiscal_year_end(fiscal, day.year) == day:
        return True
    # the nearest weekday may fall in the next calendar year's January
    return not fiscal.last and _fiscal_year_end(
        fiscal, day.year - 1 if day.month == 1 else day.year) == day


def _fiscal_apply(fiscal: _Fiscal, day: date, n: int) -> date:
    """``day + n`` fiscal years (``FY5253._apply``)."""
    prev, cur, nxt = (_fiscal_year_end(fiscal, day.year + k) for k in (-1, 0, 1))
    if day == prev:
        n -= 1
    elif day == cur:
        pass
    elif n > 0:
        if day < prev:
            n -= 2
        elif prev < day < cur:
            n -= 1
    elif cur < day < nxt:
        n += 1
    elif not prev < day < cur:
        if not (day.year == prev.year and day < prev and prev - day <= timedelta(days=6)):
            raise AssertionError(f"{day} is not within a fiscal year of {fiscal}")
        n -= 1
    return _fiscal_year_end(fiscal, day.year + n)


def _fiscal_roll(fiscal: _Fiscal, day: date, sign: int) -> date:
    """The fiscal year end at or before (``sign`` -1) or after (1) ``day``."""
    return day if _fiscal_on_offset(fiscal, day) else _fiscal_apply(fiscal, day, sign)


def _quarter_weeks(fiscal: _Fiscal, day: date) -> List[int]:
    """``FY5253Quarter.get_weeks``: the weeks of the fiscal year's quarters
    (13 each; 14 in the extra week's quarter of a 53-week year)."""
    weeks = [13] * 4
    span = _fiscal_roll(fiscal, day, 1) - _fiscal_apply(fiscal, day, -1)
    if span.days / 7 not in (52, 53):
        raise AssertionError(span.days / 7)
    if span.days == 53 * 7:
        weeks[fiscal.extra_week - 1] = 14
    return weeks


def _quarter_on_offset(fiscal: _Fiscal, day: date) -> bool:
    if _fiscal_on_offset(fiscal, day):
        return True
    current = _fiscal_apply(fiscal, day, -1)
    for weeks in _quarter_weeks(fiscal, day):
        current += timedelta(weeks=weeks)
        if current == day:
            return True
    return False


def _quarter_apply(fiscal: _Fiscal, day: date, n: int) -> date:
    """``day + n`` fiscal quarters (``FY5253Quarter._apply``): back to the
    year's start, the whole quarters since, then years and quarters."""
    start = _fiscal_roll(fiscal, day, -1)
    quarters, rest = 0, 0
    if start < day:
        rest = (day - start).days
        for weeks in _quarter_weeks(fiscal, day):
            if weeks * 7 > rest:
                break
            quarters += 1
            rest -= weeks * 7
    k = n + quarters + (1 if n <= 0 and rest > 0 else 0)
    years, k = k // 4, k % 4
    if years:
        start = _fiscal_apply(fiscal, start, years)
    return start + timedelta(weeks=sum(_quarter_weeks(fiscal, start + timedelta(days=1))[:k]))


def _on_offset(off: _Calendar, day: date) -> bool:
    if off.kind == "RE":
        return _fiscal_on_offset(off.anchor, day)
    if off.kind == "REQ":
        return _quarter_on_offset(off.anchor, day)
    if off.kind == "D":
        return True
    if off.kind == "W":
        return day.weekday() == off.anchor
    if off.kind in ("B", "C"):
        return day.weekday() < 5
    if off.kind in _SEMI_MONTH_LEAST:
        edge = _days_in_month(day.year, day.month) if off.kind == "SME" else 1
        return day.day in (off.anchor, edge)
    on_day = day.day == _month_day(day.year, day.month, _day_of(off))
    if off.kind in _MONTH_DAY or off.kind in ("WOM", "LWOM"):
        return on_day
    if off.kind in _QUARTER_DAY:
        return (day.month - off.anchor) % 3 == 0 and on_day
    if off.kind in _HALF_YEAR_DAY:
        return (day.month - off.anchor) % 6 == 0 and on_day
    return day.month == off.anchor and on_day


def _day_of(off: _Calendar) -> Union[str, Tuple[str, int]]:
    """Which day of its month a month-based offset falls on
    (:func:`_month_day`)."""
    if off.kind == "WOM":
        return ("week", off.anchor)
    if off.kind == "LWOM":
        return ("last week", off.anchor)
    return {**_MONTH_DAY, **_QUARTER_DAY, **_HALF_YEAR_DAY, **_YEAR_DAY}[off.kind]


def _business_days(day: date, n: int) -> date:
    """``day + n`` business days, as ``BusinessDay._apply`` computes it (a
    weekend day rolls forward, or back where ``n`` is 0 after the whole
    weeks)."""
    weekday = day.weekday()
    weeks = n // 5
    if n <= 0 and weekday > 4:
        n += 1
    n -= 5 * weeks
    if n == 0 and weekday > 4:
        days = 4 - weekday
    elif weekday > 4:
        days = (7 - weekday) + (n - 1)
    elif weekday + n <= 4:
        days = n
    else:
        days = n + 2
    return day + timedelta(days=7 * weeks + days)


def _roll(n: int, since: int, day: int, offset_day: int) -> int:
    """pandas' ``roll_convention``/``roll_qtrday``: ``n`` less one where a
    forward step starts before the offset (``since``: months past the
    anchor), more one where a backward step starts after it."""
    if n > 0:
        if since < 0 or (since == 0 and day < offset_day):
            n -= 1
    elif since > 0 or (since == 0 and day > offset_day):
        n += 1
    return n


def _apply(off: _Calendar, day: date, n: int) -> date:
    """``day + n * offset`` as pandas' offsets compute it (``Week._apply``,
    ``BusinessDay._apply``, the semi-month offsets, and the month, quarter
    and year offsets' roll conventions, the fiscal years and quarters)."""
    if off.kind == "RE":
        return _fiscal_apply(off.anchor, day, n)
    if off.kind == "REQ":
        return _quarter_apply(off.anchor, day, n)
    if off.kind == "D":
        return day + timedelta(days=n)
    if off.kind == "W":
        if day.weekday() != off.anchor:
            day = day + timedelta(days=(off.anchor - day.weekday()) % 7)
            if n > 0:
                n -= 1
        return day + timedelta(weeks=n)
    if off.kind in ("B", "C"):
        return _business_days(day, n)
    if off.kind in _SEMI_MONTH_LEAST:
        start = off.kind == "SMS"
        last = _days_in_month(day.year, day.month)
        k = _roll(n, 0, day.day, off.anchor)
        if start and n <= 0 and day.day == 1:
            k -= 1
        elif not start and n > 0 and day.day == last:
            k += 1
        if start:
            return _shift_month(day, k // 2 + k % 2, 1 if k % 2 else off.anchor)
        return _shift_month(day, k // 2, 31 if k % 2 else off.anchor)
    which = _day_of(off)
    if off.kind in _MONTH_DAY or off.kind in ("WOM", "LWOM"):
        return _shift_month(day, _roll(n, 0, day.day, _month_day(day.year, day.month, which)),
                            which)
    if off.kind in _QUARTER_DAY or off.kind in _HALF_YEAR_DAY:
        period = 3 if off.kind in _QUARTER_DAY else 6
        since = day.month % period - off.anchor % period
        n = _roll(n, since, day.day, _month_day(day.year, day.month, which))
        return _shift_month(day, n * period - since, which)
    n = _roll(n, day.month - off.anchor, day.day, _month_day(day.year, day.month, which))
    return _shift_month(day, n * 12 + off.anchor - day.month, which)


# BusinessHour's day (pandas' default, the only one an alias names)
_OPEN, _CLOSE = time(9), time(17)
_BUSINESS_HOURS = timedelta(hours=8)


def _bh_opening(moment: datetime, sign: int) -> datetime:
    """``BusinessHour._next_opening_time`` (``sign`` 1) or
    ``_prev_opening_time`` (-1) of a forward business-hour offset: the
    opening at or after (before) ``moment``, on a business day."""
    day = moment.date()
    if day.weekday() > 4 or (sign > 0 and moment.time() > _OPEN) or (
            sign < 0 and moment.time() < _OPEN):
        day = _business_days(day, sign)
    return datetime.combine(day, _OPEN)


def _bh_on_offset(moment: datetime) -> bool:
    return moment - _bh_opening(moment, -1) <= _BUSINESS_HOURS


def _bh_rollback(moment: datetime) -> datetime:
    """``BusinessHour.rollback``: off the hours, the previous closing."""
    if _bh_on_offset(moment):
        return moment
    return _bh_opening(moment, -1) + _BUSINESS_HOURS


def _bh_apply(moment: datetime, n: int) -> datetime:
    """``moment + n`` business hours (``n`` > 0), as
    ``BusinessHour._apply`` computes it: from the next opening where
    ``moment`` is a closing or off the hours, whole business days first,
    then the rest through the days' hours."""
    if moment.time() == _CLOSE or not _bh_on_offset(moment):
        moment = _bh_opening(moment, 1)
    days, minutes = divmod(n * 60, int(_BUSINESS_HOURS.total_seconds()) // 60)
    if days:
        moment = datetime.combine(_business_days(moment.date(), days), moment.time())
    remain = timedelta(minutes=minutes)
    while remain:
        left = _bh_opening(moment, -1) + _BUSINESS_HOURS - moment
        if remain < left:
            moment, remain = moment + remain, timedelta(0)
        else:
            remain -= left
            moment = _bh_opening(moment + left, 1)
    return moment


def _date_range(off: _Calendar, start: date, end: date) -> List[date]:
    """``pd.date_range(start, end, freq=off)``: the start rolled forward
    and the end back onto the offset, then steps of ``n`` offsets (dates,
    or for business hours datetimes)."""
    hours = off.kind in ("BH", "CBH")
    if hours:
        if not _bh_on_offset(start):
            start = _bh_opening(start, 1)
        end = _bh_rollback(end)
    else:
        if not _on_offset(off, start):
            start = _apply(off, start, 1)
        if not _on_offset(off, end):
            end = _apply(off, end, -1)
    out: List[date] = []
    cur = start
    forward = off.n >= 0
    while (cur <= end) if forward else (cur >= end):
        out.append(cur)
        if cur == end:
            break
        nxt = _bh_apply(cur, off.n) if hours else _apply(off, cur, off.n)
        if (nxt <= cur) if forward else (nxt >= cur):
            raise ValueError(f"Offset {off} did not {'in' if forward else 'de'}crement date")
        cur = nxt
    return out


def _day_ns(day: date) -> int:
    return (day - _EPOCH).days * _UNIT_NS["D"]


def _calendar_bins(timestamps: np.ndarray, off: _Calendar) -> Tuple[np.ndarray, np.ndarray]:
    """pandas' bins of a calendar offset over sorted unique ``timestamps``:
    ``(labels, bin of each point)``, from ``_get_timestamp_range_edges``,
    ``date_range``, ``_adjust_bin_edges`` and ``generate_bins_dt64``."""
    first = _EPOCH + timedelta(days=int(timestamps[0]) // _UNIT_NS["D"])
    last = _EPOCH + timedelta(days=int(timestamps[-1]) // _UNIT_NS["D"])
    if off.kind in ("BH", "CBH"):
        # from midnights, as any offset but a fixed span; pandas' edges for
        # a business hour that does not move forward end empty or unmoved
        if off.n < 0:
            raise ValueError("Invalid length for values or for binner")
        if off.n == 0:
            raise ValueError(f"Offset {off} did not increment date")
        first = _bh_rollback(datetime.combine(first, time(0)))
        last = _bh_apply(datetime.combine(last, time(0)), off.n)
        binner = np.asarray([(moment - _EPOCH_DT) // timedelta(microseconds=1) * 1000
                             for moment in _date_range(off, first, last)], np.int64)
    else:
        if off.end:
            first = _apply(off, first, -off.n)
        elif not _on_offset(off, first):
            first = _apply(off, first, -1)
        last = _apply(off, last, off.n)
        binner = np.asarray([_day_ns(d) for d in _date_range(off, first, last)], np.int64)
    edges = binner
    if off.end:
        # the right edge is the last moment of its day
        edges = binner + _UNIT_NS["D"] - 1
        if edges[-2] > timestamps[-1]:
            edges, binner = edges[:-1], binner[:-1]
    if len(edges) == 0:
        raise ValueError("Invalid length for values or for binner")
    if timestamps[0] < edges[0]:
        raise ValueError("Values falls before first bin")
    if timestamps[-1] > edges[-1]:
        raise ValueError("Values falls after last bin")
    side = "left" if off.end else "right"
    bins = np.searchsorted(edges[1:], timestamps, side=side)
    labels = binner[1:] if off.end else binner[:len(edges) - 1]
    return labels, bins


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


def _moments(bins: np.ndarray, values: np.ndarray, nbins: int) -> Tuple[np.ndarray, ...]:
    """Each bin's count and central moment sums ``M2``, ``M3``, ``M4``, by
    pandas' running update (``group_skew``, ``group_kurt``)."""
    nobs = np.zeros(nbins, np.int64)
    m1, m2, m3, m4 = (np.zeros(nbins) for _ in range(4))
    for idx in _rank_groups(bins) if len(bins) else ():
        b = bins[idx]
        n1 = nobs[b]
        n = n1 + 1
        nobs[b] = n
        delta = values[idx] - m1[b]
        delta_n = delta / n
        delta_n2 = delta_n * delta_n
        term1 = delta * delta_n * n1
        m1[b] += delta_n
        m4[b] += term1 * delta_n2 * (n * n - 3 * n + 3) + 6 * delta_n2 * m2[b] - 4 * delta_n * m3[b]
        m3[b] += term1 * delta_n * (n - 2) - 3 * delta_n * m2[b]
        m2[b] += term1
    return nobs, m2, m3, m4


def _skew_kurt(method: str, bins: np.ndarray, values: np.ndarray, nbins: int) -> np.ndarray:
    """pandas' bias-corrected skewness (NaN under 3 points) or excess
    kurtosis (under 4), 0 where the bin's points are all equal. The last
    step runs on Python floats: C's ``pow``, as pandas' own, where numpy's
    vector ``power`` may round otherwise."""
    nobs, m2, m3, m4 = _moments(bins, values, nbins)
    out = np.full(nbins, np.nan)
    least = 3 if method == "skew" else 4
    for b in np.flatnonzero(nobs >= least):
        ct, sq = float(nobs[b]), float(m2[b])
        if sq == 0:
            out[b] = 0.0
        elif method == "skew":
            out[b] = (ct * (ct - 1) ** 0.5 / (ct - 2)) * (float(m3[b]) / sq ** 1.5)
        else:
            out[b] = (ct * (ct + 1) * (ct - 1) * float(m4[b]) / ((ct - 2) * (ct - 3) * sq ** 2)
                      - 3.0 * (ct - 1) ** 2 / ((ct - 2) * (ct - 3)))
    return out


def _aggregate(method: str, bins: np.ndarray, values: np.ndarray, nbins: int,
               stamps: Optional[np.ndarray] = None) -> np.ndarray:
    """One aggregation per bin over the non-NaN points (``bins`` sorted,
    ``stamps`` their timestamps); an empty bin gives NaN, 0 for ``sum``,
    ``count``, ``nunique`` and ``any``, 1 for ``prod`` and ``all``, and
    raises ``ValueError`` for ``idxmin`` and ``idxmax``, as pandas does.
    (``size``, which counts the NaNs too, is the caller's.)"""
    counts = np.bincount(bins, minlength=nbins)
    if method in ("any", "all"):
        nonzero = np.bincount(bins, weights=values != 0, minlength=nbins)
        return (nonzero > 0 if method == "any" else nonzero == counts).astype(np.float64)
    if method in ("skew", "kurt"):
        return _skew_kurt(method, bins, values, nbins)
    if method in ("idxmin", "idxmax"):
        if (counts == 0).any():
            raise ValueError(f"{method} with skipna=True encountered all NA values in a group.")
        # stable: among equal values the earliest point, as pandas keeps
        order = np.lexsort((values if method == "idxmin" else -values, bins))
        return stamps[order[np.cumsum(counts) - counts]].astype(np.float64)
    if method == "count":
        return counts.astype(np.float64)
    if method in ("sum", "mean"):
        total = _kahan_sum(bins, values, nbins) if len(bins) else np.zeros(nbins)
        if method == "sum":
            return total
        with np.errstate(invalid="ignore", divide="ignore"):
            return total / counts
    if method in ("var", "std", "sem"):
        var = _welford_var(bins, values, nbins) if len(bins) else np.full(nbins, np.nan)
        if method == "var":
            return var
        if method == "std":
            return np.sqrt(var)
        with np.errstate(invalid="ignore", divide="ignore"):
            return np.sqrt(var / counts)
    if method == "prod":
        product = np.ones(nbins)
        for idx in _rank_groups(bins) if len(bins) else ():
            product[bins[idx]] *= values[idx]
        return product
    if method == "nunique":
        pairs = np.unique(np.stack([bins.astype(np.float64), values]), axis=1)
        return np.bincount(pairs[0].astype(np.int64), minlength=nbins).astype(np.float64)
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
    elif method in ("median", "quantile"):
        ordered = values[np.lexsort((values, bins))]
        n = counts[full]
        lo, hi = ordered[starts + (n - 1) // 2], ordered[starts + n // 2]
        if method == "median":
            out[full] = np.where(n % 2 == 1, hi, (hi + lo) / 2)
        else:  # pandas' group_quantile at 0.5, linear: val + (next - val) * frac
            out[full] = np.where(n % 2 == 1, lo, lo + (hi - lo) * 0.5)
    else:
        raise AttributeError(f"{method!r} is not a valid function for the resampler")
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


def _tick_ns(resolution: str) -> int:
    """A fixed resampling span in nanoseconds, as ``to_offset`` reads it: a
    bare unit is one of it. A zero span raises ``ZeroDivisionError``, as
    pandas' binning does; a spelling pandas refuses, ``ValueError``."""
    match = _TICK_RE.match(resolution)
    unit = match and _UNIT_NS.get(match.group(3))
    if not unit:
        if re.match(r"^\s*-", resolution):
            raise ValueError("Invalid length for values or for binner")
        raise ValueError(f"Invalid frequency: {resolution}")
    span = int(Decimal(match.group(2) or "1") * unit)
    if span == 0:
        raise ZeroDivisionError("integer modulo by zero")
    return span


def _transform(method: str, bins: np.ndarray, values: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """A groupby method of :data:`LIST_TRANSFORMS` over the bins of sorted
    points (NaNs included): ``(rows, column)``, the positions of the points
    it answers for, in pandas' order, and its value at each. Every point,
    in time order, but for ``head``/``tail`` (a bin's first or last
    :data:`_KEEP` points) and ``nlargest``/``nsmallest`` (a bin's numbers
    by value, ties in time order, then its NaNs, the first :data:`_KEEP`)."""
    n = len(values)
    counts = np.bincount(bins)
    starts = (np.cumsum(counts) - counts)[bins]
    place = np.arange(n) - starts  # each point's place in its bin
    valid = ~np.isnan(values)
    rows = np.arange(n)
    if method == "cumcount":
        return rows, place.astype(np.float64)
    if method == "ngroup":
        return rows, bins.astype(np.float64)
    if method == "head":
        rows = np.flatnonzero(place < _KEEP)
        return rows, values[rows]
    if method == "tail":
        rows = np.flatnonzero(place >= counts[bins] - _KEEP)
        return rows, values[rows]
    if method in ("nlargest", "nsmallest"):
        key = -values if method == "nlargest" else values
        # by bin, numbers before NaNs, by value, then in time order; a bin's
        # block starts where its points do
        order = np.lexsort((rows, np.where(valid, key, 0.0), ~valid, bins))
        rows = order[np.arange(n) - starts[order] < _KEEP]
        return rows, values[rows]
    if method in ("shift", "diff", "pct_change"):
        previous = np.full(n, np.nan)
        previous[place > 0] = values[np.flatnonzero(place > 0) - 1]
        if method == "shift":
            return rows, previous
        return rows, values - previous if method == "diff" else values / previous - 1
    if method == "ffill":
        last = _last_valid(valid)
        take = ~valid & (last >= starts)
        out = values.copy()
        out[take] = values[last[take]]
        return rows, out
    if method == "bfill":
        _, out = _transform("ffill", (bins.max() - bins)[::-1], values[::-1])
        return rows, out[::-1]
    if method == "rank":
        out = np.full(n, np.nan)
        at = np.flatnonzero(valid)
        order = at[np.lexsort((values[at], bins[at]))]
        b, v = bins[order], values[order]
        first = np.r_[True, (b[1:] != b[:-1])]
        position = np.arange(len(order)) - np.maximum.accumulate(
            np.where(first, np.arange(len(order)), 0))
        tie = np.r_[True, (b[1:] != b[:-1]) | (v[1:] != v[:-1])]
        group = np.cumsum(tie) - 1
        lowest = np.minimum.reduceat(position, np.flatnonzero(tie))
        highest = np.maximum.reduceat(position, np.flatnonzero(tie))
        out[order] = (lowest[group] + highest[group]) / 2 + 1  # the average rank
        return rows, out
    out = np.full(n, np.nan)
    accum = np.full(counts.shape, {"cumsum": 0.0, "cumprod": 1.0, "cummin": np.inf,
                                   "cummax": -np.inf}[method])
    compensation = np.zeros(counts.shape)
    for idx in _rank_groups(bins):
        idx = idx[valid[idx]]
        b, val = bins[idx], values[idx]
        if method == "cumsum":  # pandas' group_cumsum: Kahan-compensated
            y = val - compensation[b]
            t = accum[b] + y
            c = (t - accum[b]) - y
            compensation[b] = np.where(np.isnan(c), 0.0, c)
            accum[b] = t
        elif method == "cumprod":
            accum[b] *= val
        elif method == "cummin":
            accum[b] = np.where(val < accum[b], val, accum[b])
        else:
            accum[b] = np.where(val > accum[b], val, accum[b])
        out[idx] = accum[b]
    return rows, out


def _reindex(index: np.ndarray, stamps: np.ndarray, column: np.ndarray) -> np.ndarray:
    """``column`` (one value, or row, per unique ``stamps``) read at
    ``index``; NaN where ``index`` holds a stamp it lacks."""
    out = np.full((len(index),) + column.shape[1:], np.nan)
    if len(stamps):
        order = np.argsort(stamps, kind="stable")
        at = np.minimum(np.searchsorted(stamps[order], index), len(stamps) - 1)
        hit = stamps[order][at] == index
        out[hit] = column[order[at[hit]]]
    return out


def _resample(timestamps: np.ndarray, values: np.ndarray, origin: int,
              resolution: Union[int, _Calendar], methods: List[str],
              single: bool) -> Tuple[np.ndarray, np.ndarray]:
    """``resample(resolution, origin=origin).agg(methods)`` of one
    deduplicated, sorted series: its index and one column per method.
    ``resolution``: a fixed span in nanoseconds (bins closed and labelled
    left, from ``origin``) or a calendar offset (pandas' own edges, where
    ``origin`` takes no effect). A reduction's rows are the bin labels
    (every bin from the first point's to the last's), a transform's (in a
    list) the points' timestamps (:func:`_transform`); mixed, the index is
    their union in order of appearance, as pandas concatenates them, each
    column NaN where its own index lacks the row."""
    if isinstance(resolution, _Calendar):
        labels, bins = _calendar_bins(timestamps, resolution)
        nbins = len(labels)
    else:
        step = resolution
        bins = (timestamps - origin) // step  # floor: points before the origin too
        first = int(bins[0])
        nbins = int(bins[-1]) - first + 1
        labels = origin + (first + np.arange(nbins, dtype=np.int64)) * step
        bins = bins - first
    valid = ~np.isnan(values)
    rel = bins[valid]
    kept = values[valid]
    parts = []
    for m in methods:
        if m == "size":
            parts.append((labels, np.bincount(bins, minlength=nbins).astype(np.float64)))
        elif single and m in _UPSAMPLING:
            parts.append((labels, _upsample(m, timestamps, values, labels)))
        elif not single and m in LIST_TRANSFORMS:
            rows, column = _transform(m, bins, values)
            parts.append((timestamps[rows], column))
        else:
            parts.append((labels, _aggregate(m, rel, kept, nbins, timestamps[valid])))
    index = parts[0][0]
    for stamps, _ in parts[1:]:
        if stamps is not index:
            index = np.concatenate([index, stamps[~np.isin(stamps, index)]])
    return index, np.stack([column if stamps is index else _reindex(index, stamps, column)
                            for stamps, column in parts], axis=1)


def _upsample(method: str, timestamps: np.ndarray, values: np.ndarray,
              labels: np.ndarray) -> np.ndarray:
    """``Resampler.ffill|bfill|nearest|asfreq|interpolate()``: the series
    (NaNs included) read at the bin labels. ``ffill`` takes the last point
    at or before a label, ``bfill`` the first at or after, ``nearest`` the
    closer of the two (the later on a tie, as ``get_indexer`` does),
    ``asfreq`` a point exactly at the label; ``interpolate`` merges the
    labels' ``asfreq`` values with the points between them and
    interpolates linearly by position before reading the labels."""
    n = len(timestamps)
    before = np.searchsorted(timestamps, labels, side="right") - 1
    after = np.searchsorted(timestamps, labels, side="left")
    out = np.full(len(labels), np.nan)
    if method == "ffill":
        take = before >= 0
        out[take] = values[before[take]]
    elif method == "bfill":
        take = after < n
        out[take] = values[after[take]]
    elif method == "nearest":
        has_after = after < n
        left_gap = labels - timestamps[np.maximum(before, 0)]
        right_gap = timestamps[np.minimum(after, n - 1)] - labels
        pick = np.where((before >= 0) & ((left_gap < right_gap) | ~has_after), before, after)
        take = (pick >= 0) & (pick < n)
        out[take] = values[pick[take]]
    else:
        exact = (after < n) & (timestamps[np.minimum(after, n - 1)] == labels)
        out[exact] = values[after[exact]]
        if method == "interpolate":
            others = ~np.isin(timestamps, labels)
            merged_ts = np.concatenate([labels, timestamps[others]])
            merged = np.concatenate([out, values[others]])
            order = np.argsort(merged_ts, kind="stable")
            filled = _interpolate(merged[order], None)
            out = filled[np.argsort(order)[:len(labels)]]
    return out


def _parse_resolution(resolution: str) -> Union[int, _Calendar]:
    """A resolution as pandas' ``to_offset`` reads it: a calendar offset
    (:func:`_parse_calendar`), whole days (``D``: a calendar offset in
    pandas 3, binned from the first point's midnight whatever the
    ``origin``), or a fixed span in nanoseconds (:func:`_tick_ns`; ``24h``
    and ``1.5D`` are such spans, binned from the ``origin``)."""
    off = _parse_calendar(resolution)
    if off is not None:
        return off
    match = _TICK_RE.match(resolution)
    if match and match.group(3) in ("D", "d"):
        count = Decimal(match.group(2) or "1")
        if count == count.to_integral_value() and count != 0:
            return _Calendar("D", int(count), 0)
    return _tick_ns(resolution)


def _check_methods(methods: List[str], single: bool) -> None:
    """Refuse what the port does not aggregate with the exception type the
    reference raises: an unknown method ``AttributeError``, the groupby
    attributes pandas cannot aggregate with what pandas raises
    (``_LIST_TYPE_ERRORS``, ...); ``ohlc`` alone ``AttributeError``, in a
    list ``ValueError`` (its four columns do not fit one name each). An
    upsampling method is taken alone, a list reduction or transform in a
    list."""
    for method in methods:
        if method == "ohlc":
            if single:
                raise AttributeError("'DataFrame' object has no attribute 'to_frame' (ohlc "
                                     "makes four columns)")
            raise ValueError(f"Length mismatch: ohlc makes four columns, not one, among "
                             f"{methods}")
        if method in AGGREGATIONS or (not single and method in LIST_REDUCTIONS):
            continue
        if single and method in _UPSAMPLING:
            continue
        if not single and method in LIST_TRANSFORMS:
            continue
        if method in (_SINGLE_TYPE_ERRORS if single else _LIST_TYPE_ERRORS):
            raise TypeError(f"{method!r} is not an aggregation the resampler can name")
        if not single and method in _LIST_VALUE_ERRORS:
            raise ValueError(f"{method!r} does not aggregate to one column")
        raise AttributeError(f"{method!r} is not a valid function for the resampler "
                             f"(one of {', '.join(AGGREGATIONS)})")


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
    resampled lengths, rows dropped by the join and by the range slice).
    The errors come in the reference's order: the interpolation method,
    the limit's arithmetic, then, per series, the resolution and the
    aggregations."""
    resolution = _normalize_resolution(resolution)
    if interpolation_method not in ("linear_interpolation", "ffill", "none"):
        raise ValueError(
            f"interpolation_method must be one of 'linear_interpolation', "
            f"'ffill', 'none'; got {interpolation_method!r}")
    single = isinstance(aggregation_methods, str)
    methods = [aggregation_methods] if single else list(aggregation_methods)
    limit = None
    if interpolation_limit is not None:
        limit = max(1, int(_timedelta_ns(interpolation_limit) / _timedelta_ns(resolution)))
    origin = datetime_to_ns(resampling_start)
    offset: Union[int, _Calendar, None] = None
    metadata: Dict[str, Any] = {}
    frames: List[Tuple[np.ndarray, List[str], np.ndarray]] = []

    for name, timestamps, values in series_iterable:
        timestamps = np.asarray(timestamps, dtype=np.int64)
        values = np.asarray(values, dtype=np.float64)
        original_count = len(timestamps)
        if original_count == 0:
            raise InsufficientDataError(f"Tag {name!r} has no data")
        timestamps, first = np.unique(timestamps, return_index=True)  # first of duplicates
        if offset is None:
            offset = _parse_resolution(resolution)
            _check_methods(methods, single)
        labels, table = _resample(timestamps, values[first], origin, offset, methods, single)
        columns = [name] if single else [f"{name}_{m}" for m in methods]
        if interpolation_method == "linear_interpolation" and any(
                m in ("any", "all") and np.isnan(table[:, j]).any()
                for j, m in enumerate(methods)):
            # a bool column that the union gave NaNs is pandas' object dtype
            raise TypeError("DataFrame cannot interpolate with object dtype.")
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
    # the inner join keeps the first frame's order (sorted, unless a list
    # transform put the points after the labels or nlargest ordered them)
    index = frames[0][0]
    for labels, _, _ in frames[1:]:
        index = index[np.isin(index, labels)]
    values = np.concatenate([_reindex(index, labels, table) for labels, _, table in frames],
                            axis=1)
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
