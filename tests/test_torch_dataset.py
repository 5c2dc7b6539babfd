"""The port's numpy dataset layer against the JAX package's pandas one, on
the same seeded inputs, on the CPU.

Tolerances:

- ``RandomDataProvider``: timestamps equal to the nanosecond, values
  bitwise (the same draws in the same order);
- ``join_timeseries`` and ``TimeSeriesDataset.get_data``: every value
  within 1 float32 ulp after the float32 cast (the port adds in bin order
  with Kahan compensation and runs Welford's update as pandas does, so the
  values are expected equal; the ulp allows another order of the same
  float64 sums), the index equal to the nanosecond, column names and
  metadata dicts equal (the ``type`` module paths name each package's own
  classes);
- ``row_filter``: the same rows as ``DataFrame.query``.
"""

import csv
import json
from datetime import datetime, timedelta, timezone

import numpy as np
import pandas as pd
import pytest
from hypothesis import given, settings
from hypothesis import strategies as st

from gordo_components_tpu.dataset.base import GordoBaseDataset as RefBaseDataset
from gordo_components_tpu.dataset.data_provider.providers import (
    RandomDataProvider as RefRandomProvider,
)
from gordo_components_tpu.dataset.dataset import (
    InsufficientDataError as RefInsufficientDataError,
    TimeSeriesDataset as RefTimeSeriesDataset,
    join_timeseries as ref_join_timeseries,
)
from gordo_components_tpu.dataset.sensor_tag import (
    SensorTag as RefSensorTag,
    normalize_sensor_tags as ref_normalize_sensor_tags,
)

from gordo_components_tpu_torch.dataset import GordoBaseDataset
from gordo_components_tpu_torch.dataset import query
from gordo_components_tpu_torch.dataset.data_provider import (
    CompositeDataProvider,
    FileDataProvider,
    GordoBaseDataProvider,
    RandomDataProvider,
)
from gordo_components_tpu_torch.dataset.dataset import (
    InsufficientDataError,
    RandomDataset,
    TimeSeriesDataset,
    _ffill,
    _interpolate,
    _parse_date,
    join_timeseries,
)
from gordo_components_tpu_torch.dataset.sensor_tag import (
    SensorTag,
    normalize_sensor_tags,
    to_list_of_strings,
)

UTC = timezone.utc
START = datetime(2023, 1, 1, tzinfo=UTC)


def _ref_series(series):
    """The port's (name, ns, values) triples as the reference's pd.Series."""
    return [pd.Series(v, index=pd.DatetimeIndex(pd.to_datetime(ts, utc=True)), name=n)
            for n, ts, v in series]


def _ported_types(tree):
    """A metadata tree with every ``type`` path of the port spelled as the
    reference's (the one intended difference)."""
    if isinstance(tree, dict):
        return {k: (v.replace("gordo_components_tpu_torch.", "gordo_components_tpu.")
                    if k == "type" and isinstance(v, str) else _ported_types(v))
                for k, v in tree.items()}
    if isinstance(tree, list):
        return [_ported_types(v) for v in tree]
    return tree


def _assert_f32_close(ref, ours):
    ref = np.asarray(ref, np.float64).astype(np.float32)
    ours = np.asarray(ours, np.float64).astype(np.float32)
    assert ref.shape == ours.shape
    np.testing.assert_array_equal(np.isnan(ref), np.isnan(ours))
    finite = ~np.isnan(ref)
    np.testing.assert_array_max_ulp(ref[finite], ours[finite], maxulp=1)


def _assert_frames(ref_frame, ref_meta, frame, meta):
    assert meta == ref_meta
    assert frame.columns == list(ref_frame.columns)
    np.testing.assert_array_equal(frame.index, ref_frame.index.as_unit("ns").asi8)
    _assert_f32_close(ref_frame.to_numpy(np.float64), frame.values)


# -- RandomDataProvider ---------------------------------------------------------
@pytest.mark.parametrize("sizes,seed,span", [
    ((100, 300), 0, timedelta(days=31)),
    ((700, 700), 0, timedelta(days=31)),
    ((600, 900), 7, timedelta(days=7)),
    ((1, 5), 123, timedelta(hours=1)),
    ((2000, 4000), 2**20, timedelta(days=14, minutes=7)),
])
def test_random_provider_equals_the_reference(sizes, seed, span):
    tags = [f"tag-{i}" for i in range(4)] + ["GRA-TE-223", "1901.A-1"]
    end = START + span
    ref = list(RefRandomProvider(*sizes, seed=seed).load_series(
        START, end, [RefSensorTag(t) for t in tags]))
    ours = list(RandomDataProvider(*sizes, seed=seed).load_series(
        START, end, [SensorTag(t) for t in tags]))
    assert len(ours) == len(ref)
    for r, (name, ts, values) in zip(ref, ours):
        assert name == r.name
        assert ts.dtype == np.int64 and values.dtype == np.float64
        np.testing.assert_array_equal(ts, r.index.asi8)
        np.testing.assert_array_equal(values, r.values)


def test_random_provider_steps_are_not_uniform():
    """Over a month at n = 700 pandas' linspace steps differ by 1 ns here
    and there; the port reproduces each one."""
    [(_, ts, _)] = RandomDataProvider(700, 700).load_series(
        START, START + timedelta(days=31), [SensorTag("tag-0")])
    steps = set(np.diff(ts).tolist())
    assert steps == {3826285714285, 3826285714286}
    naive = list(RandomDataProvider(700, 700).load_series(
        START.replace(tzinfo=None), (START + timedelta(days=31)).replace(tzinfo=None),
        [SensorTag("tag-0")]))
    np.testing.assert_array_equal(naive[0][1], ts)


def test_random_provider_rejects_an_empty_range_and_dry_run_yields_nothing():
    with pytest.raises(ValueError, match="must be after"):
        list(RandomDataProvider().load_series(START, START, [SensorTag("a")]))
    assert list(RandomDataProvider().load_series(
        START, START + timedelta(days=1), [SensorTag("a")], dry_run=True)) == []


# -- join_timeseries -------------------------------------------------------------
AGGREGATIONS = ["mean", "sum", "count", "min", "max", "std", "var", "median", "first", "last"]


@st.composite
def series_sets(draw):
    """1-3 series of irregular, duplicated and clustered timestamps (gaps
    shorter and longer than the limit, points before the origin, leading
    and trailing gaps) with some NaN values."""
    series = []
    for i in range(draw(st.integers(1, 3))):
        n = draw(st.integers(1, 40))
        # seconds from the origin; clusters leave long gaps between them
        centres = draw(st.lists(st.integers(-1200, 6 * 3600), min_size=1, max_size=4))
        offsets = [draw(st.sampled_from(centres)) + draw(st.integers(0, 1800))
                   for _ in range(n)]
        if draw(st.booleans()) and n > 1:  # duplicated timestamps
            offsets[-1] = offsets[0]
        values = [draw(st.one_of(st.floats(-1e3, 1e3), st.just(float("nan"))))
                  if draw(st.integers(0, 9)) == 0 else draw(st.floats(-1e3, 1e3))
                  for _ in range(n)]
        ts = np.datetime64("2023-01-01T00:00:00", "ns").astype(np.int64) + \
            np.asarray(offsets, np.int64) * 1_000_000_000
        series.append((f"t{i}", ts, np.asarray(values, np.float64)))
    return series


@settings(max_examples=80, deadline=None)
@given(
    series=series_sets(),
    aggregation=st.one_of(st.sampled_from(AGGREGATIONS),
                          st.lists(st.sampled_from(AGGREGATIONS), min_size=1, max_size=3,
                                   unique=True)),
    interpolation=st.sampled_from(["linear_interpolation", "ffill", "none"]),
    limit=st.sampled_from([None, "10min", "30T", "1H", "8H", "45s"]),
    resolution=st.sampled_from(["10T", "10min", "5min", "1H", "1h", "30S", "7min", "90s",
                                "1D", "2D"]),
    hours=st.integers(1, 8),
)
def test_join_timeseries_equals_the_reference(series, aggregation, interpolation, limit,
                                              resolution, hours):
    end = START + timedelta(hours=hours)
    try:
        ref_frame, ref_meta = ref_join_timeseries(
            iter(_ref_series(series)), START, end, resolution, aggregation, interpolation, limit)
    except RefInsufficientDataError:
        with pytest.raises(InsufficientDataError):
            join_timeseries(iter(series), START, end, resolution, aggregation, interpolation,
                            limit)
        return
    frame, meta = join_timeseries(iter(series), START, end, resolution, aggregation,
                                  interpolation, limit)
    _assert_frames(ref_frame, ref_meta, frame, meta)


def test_interpolate_fills_the_first_limit_nans_of_a_longer_gap():
    """[1.5, NaN, NaN, NaN, 5] at limit 2: the first two NaNs from the
    line across the whole gap, the third left for dropna."""
    column = np.array([1.5, np.nan, np.nan, np.nan, 5.0])
    expected = np.array([1.5, 2.375, 3.25, np.nan, 5.0])
    np.testing.assert_array_equal(_interpolate(column, 2), expected)
    np.testing.assert_array_equal(
        pd.Series(column).interpolate(method="linear", limit=2).to_numpy(), expected)


def test_leading_nans_stay_and_trailing_nans_take_the_last_value():
    column = np.array([np.nan, 1.0, 2.0, 5.0, np.nan, np.nan, np.nan])
    for limit, expected in ((2, [np.nan, 1, 2, 5, 5, 5, np.nan]),
                            (None, [np.nan, 1, 2, 5, 5, 5, 5])):
        np.testing.assert_array_equal(_interpolate(column, limit), expected)
        np.testing.assert_array_equal(
            pd.Series(column).interpolate(method="linear", limit=limit).to_numpy(), expected)
        np.testing.assert_array_equal(_ffill(column, limit), expected)
        np.testing.assert_array_equal(pd.Series(column).ffill(limit=limit).to_numpy(),
                                      expected)
    gap = np.array([1.0, np.nan, np.nan, np.nan, 4.0])
    np.testing.assert_array_equal(_ffill(gap, 2), [1, 1, 1, np.nan, 4])


def test_empty_bins_give_nan_except_sum_and_count():
    """Points in bins 0, 2 and 3 (one point in bin 3): the empty bin 1 is
    NaN for mean, max and std and 0 for sum and count; a lone point's std
    is NaN (ddof 1)."""
    minutes = np.array([1, 2, 21, 33])
    ts = START.timestamp() * 1e9 + minutes * 60e9
    series = [("a", ts.astype(np.int64), np.array([1.0, 3.0, 4.0, 7.0]))]
    methods = ["mean", "max", "std", "sum", "count"]
    frame, meta = join_timeseries(iter(series), START, START + timedelta(hours=1), "10min",
                                  methods, "none", None)
    ref_frame, ref_meta = ref_join_timeseries(iter(_ref_series(series)), START,
                                              START + timedelta(hours=1), "10min", methods,
                                              "none", None)
    # bin 0 alone has every aggregation; the others hold a NaN
    _assert_frames(ref_frame, ref_meta, frame, meta)
    assert frame.values.shape == (1, 5)
    for method, expected in (("mean", [2, np.nan, 4, 7]), ("max", [3, np.nan, 4, 7]),
                             ("std", [np.sqrt(2), np.nan, np.nan, np.nan]),
                             ("sum", [4, 0, 4, 7]), ("count", [2, 0, 1, 1])):
        raw = pd.Series(series[0][2], index=pd.to_datetime(series[0][1], utc=True)).resample(
            "10min", origin=pd.Timestamp(START)).agg(method).to_numpy(np.float64)
        np.testing.assert_array_equal(raw, expected)
        ours = join_timeseries(iter(series), START, START + timedelta(hours=1), "10min",
                               method, "none", None)[0]
        kept = ~np.isnan(np.asarray(expected, np.float64))
        np.testing.assert_array_equal(ours.values[:, 0], np.asarray(expected)[kept])


@pytest.mark.parametrize("start", [START + timedelta(hours=5), START.replace(tzinfo=None)])
@pytest.mark.parametrize("resolution", ["1D", "2D", "3d"])
def test_day_resolutions_bin_from_midnight_as_pandas_does(start, resolution):
    """pandas ignores ``origin`` for whole days and bins from the first
    point's midnight; so does the port."""
    series = list(RandomDataProvider(3, 300, seed=2).load_series(
        start, start + timedelta(days=9, hours=3), [SensorTag("a"), SensorTag("b")]))
    ref_series = [pd.Series(v, index=pd.to_datetime(t, utc=start.tzinfo is not None), name=n)
                  for n, t, v in series]
    end = start + timedelta(days=9, hours=3)
    with pytest.warns(RuntimeWarning, match="origin"):
        ref_frame, ref_meta = ref_join_timeseries(iter(ref_series), start, end, resolution,
                                                  ["mean", "std", "count"],
                                                  "linear_interpolation", "3D")
    frame, meta = join_timeseries(iter(series), start, end, resolution, ["mean", "std", "count"],
                                  "linear_interpolation", "3D")
    _assert_frames(ref_frame, ref_meta, frame, meta)
    assert len(frame.index) > 0


def test_bins_start_at_the_origin_not_the_epoch():
    start = START + timedelta(minutes=3)
    ts = np.array([start.timestamp() + 60 * m for m in (0, 9, 10, 25)]) * 1e9
    frame, _ = join_timeseries(iter([("a", ts.astype(np.int64), np.ones(4))]), start,
                               start + timedelta(hours=1), "10min")
    labels = [datetime.fromtimestamp(t / 1e9, UTC).strftime("%H:%M") for t in frame.index]
    assert labels == ["00:03", "00:13", "00:23"]


def test_sums_and_means_are_pandas_kahan_sums():
    """A bin of 1000 values whose naive sum differs from pandas' compensated
    one: the port gives pandas' float64 mean and variance to the bit."""
    rng = np.random.default_rng(0)
    values = rng.normal(size=1000) * 1e3
    ts = (START.timestamp() * 1e9 + np.arange(1000) * 1e9).astype(np.int64)
    ref_series = pd.Series(values, index=pd.to_datetime(ts, utc=True))
    for method in ("mean", "sum", "var", "std"):
        ref = ref_series.resample("1h", origin=pd.Timestamp(START)).agg(method).iloc[0]
        frame, _ = join_timeseries(iter([("a", ts, values)]), START,
                                   START + timedelta(hours=1), "1h", method)
        assert frame.values[0, 0] == ref, method
    assert values.sum() / 1000 != ref_series.resample("1h").mean().iloc[0]


@pytest.mark.parametrize("legacy,modern", [("10T", "10min"), ("1H", "1h"), ("30S", "30s"),
                                           ("500L", "500ms"), ("100U", "100us"), ("T", "min")])
def test_legacy_resolutions(legacy, modern):
    """Legacy spellings normalize as the reference's; a span is read as
    ``pd.Timedelta`` reads it, which refuses a bare unit ("min") and a
    calendar offset ("ME", "W-SUN") and reads a numbered week ("1W")."""
    from gordo_components_tpu.dataset.dataset import _normalize_resolution as ref_normalize

    from gordo_components_tpu_torch.dataset.dataset import _normalize_resolution, _timedelta_ns

    assert _normalize_resolution(legacy) == ref_normalize(legacy) == modern
    if legacy == "T":
        with pytest.raises(ValueError):
            pd.Timedelta(modern)
        with pytest.raises(ValueError, match="unsupported"):
            _timedelta_ns(legacy)
    else:
        assert _timedelta_ns(legacy) == pd.Timedelta(modern).value
    for span in ("1.5h", "2D", "90s", "1W", "2w", "-3h", "+10min"):
        assert _timedelta_ns(span) == pd.Timedelta(span).value
    for calendar in ("ME", "W-SUN", "W"):
        with pytest.raises(ValueError):
            pd.Timedelta(calendar)
        with pytest.raises(ValueError, match="unsupported"):
            _timedelta_ns(calendar)


@pytest.mark.parametrize("text", ["2023-01-01T00:00:00+00:00", "2023-01-01T00:00:00Z",
                                  "2023-01-01", "2023-03-04T05:06:07.123456+01:30",
                                  "2023-01-01 12:00:00"])
def test_parse_date_gives_the_reference_isoformat(text):
    from gordo_components_tpu.dataset.dataset import _parse_date as ref_parse_date

    assert _parse_date(text).isoformat() == ref_parse_date(text).isoformat()
    assert _parse_date(text) == ref_parse_date(text)


# -- row_filter ----------------------------------------------------------------
FILTER_COLUMNS = ["a", "b", "GRA-TE-223", "c_mean"]
FILTERS = [
    "a > 0",
    "a > 0 & b < 1",
    "a > 0 | b < 1 & c_mean > 0.5",
    "(a > 0 | b < 1) & c_mean > 0.5",
    "a > 0 and b < 1",
    "a > 0 or not b < 1",
    "~(a > 0)",
    "0 < a < 2.5",
    "-1 <= b <= 1 & a != 0",
    "`GRA-TE-223` > 0",
    "`GRA-TE-223` > 0 & `a` < 1.5",
    "a + b * 2 > c_mean - 1",
    "a ** 2 > 1",
    "a / 2 >= -0.25",
    "-a > 0.1",
    "a == a",
    "b != 0.0",
    "a > 1e-1",
]


@pytest.mark.parametrize("expression", FILTERS)
def test_row_filter_matches_dataframe_query(expression):
    rng = np.random.default_rng(4)
    frame = pd.DataFrame(rng.normal(size=(200, 4)), columns=FILTER_COLUMNS)
    ours = query.evaluate(expression, {c: frame[c].to_numpy() for c in FILTER_COLUMNS})
    expected = frame.index.isin(frame.query(expression).index)
    np.testing.assert_array_equal(ours, expected)
    if expression not in ("a == a", "b != 0.0"):
        assert 0 < ours.sum() < 200


@pytest.mark.parametrize("expression", [
    "a > 0 &", "a.b > 0", "a in [1, 2]", "@x > 0", "a", "a > 'x'", "f(a) > 0", "missing > 0",
    "a[0] > 0", "a > 0 if b else c", "lambda: 1", "~a > 0",
])
def test_row_filter_outside_the_grammar_raises_naming_the_expression(expression):
    columns = {c: np.arange(5.0) for c in FILTER_COLUMNS}
    with pytest.raises(ValueError, match="row_filter"):
        query.evaluate(expression, columns)


def test_row_filter_precedence_differs_from_python():
    """pandas reads ``a > 0 & b < 1`` as ``(a > 0) & (b < 1)``; Python's own
    grammar would read ``a > (0 & b) < 1``."""
    a = np.array([1.0, 1.0, -1.0])
    b = np.array([0.0, 2.0, 0.0])
    np.testing.assert_array_equal(query.evaluate("a > 0 & b < 1", {"a": a, "b": b}),
                                  [True, False, False])


# -- TimeSeriesDataset -----------------------------------------------------------
def _dataset_pair(**config):
    ref = RefTimeSeriesDataset(**{**config, "data_provider": {
        **config["data_provider"],
        "type": config["data_provider"]["type"].replace("gordo_components_tpu_torch.",
                                                        "gordo_components_tpu.")}})
    return ref, TimeSeriesDataset(**config)


def _assert_datasets(ref, ours):
    rX, ry = ref.get_data()
    X, y = ours.get_data()
    assert X.dtype == y.dtype == np.float32
    assert ours.x_columns == list(rX.columns) and ours.y_columns == list(ry.columns)
    np.testing.assert_array_equal(ours.index, rX.index.as_unit("ns").asi8)
    _assert_f32_close(rX.to_numpy(), X)
    _assert_f32_close(ry.to_numpy(), y)
    assert _ported_types(ours.get_metadata()) == ref.get_metadata()
    assert _ported_types(ours.to_dict()) == ref.to_dict()
    return X


@pytest.mark.parametrize("case", [
    dict(),
    dict(resolution="30T", aggregation_methods=["mean", "max", "count"],
         row_filter="`tag-0_mean` > -10 & `tag-1_max` < 10"),
    dict(interpolation_method="ffill", interpolation_limit="20min", resolution="7min"),
    dict(interpolation_method="none", interpolation_limit=None,
         target_tag_list=["tag-2", "extra"], row_threshold=10),
    dict(train_start_date="2023-01-01", train_end_date="2023-01-05 12:00:00"),
])
def test_time_series_dataset_equals_the_reference(case):
    config = dict(train_start_date="2023-01-01T00:00:00+00:00",
                  train_end_date="2023-01-08T06:00:00+00:00",
                  tag_list=["tag-0", "tag-1", {"name": "tag-2", "asset": "plant"}],
                  data_provider={"type": "RandomDataProvider", "min_size": 300,
                                 "max_size": 1200, "seed": 5})
    config.update(case)
    _assert_datasets(*_dataset_pair(**config))


def _write_csv(path, stamps, values):
    with open(path, "w", newline="") as fh:
        writer = csv.writer(fh)
        writer.writerow(["timestamp", "value"])
        for stamp, value in zip(stamps, values):
            writer.writerow([stamp, "" if np.isnan(value) else repr(float(value))])


@pytest.mark.parametrize("zone,start", [
    ("", "2023-01-01T00:00:00+00:00"),       # naive file, aware range: UTC
    ("+00:00", "2023-01-01T00:00:00+00:00"),  # aware both
    ("+01:00", "2023-01-01T00:00:00+00:00"),  # another offset: the same instants
    ("", "2023-01-01T00:00:00"),              # naive both
    ("+01:00", "2023-01-01T00:00:00"),        # aware file, naive range: its wall clock
])
def test_file_provider_csv_equals_the_reference(tmp_path, zone, start):
    rng = np.random.default_rng(11)
    base = np.datetime64("2022-12-31T22:00:00")
    for name in ("TAG-A", "TAG-B"):
        seconds = np.sort(rng.integers(0, 3 * 86400, size=500))
        stamps = [str(base + np.timedelta64(int(s), "s")).replace("T", " ") + zone
                  for s in seconds]
        values = rng.normal(size=500)
        values[rng.integers(0, 500, size=10)] = np.nan
        _write_csv(tmp_path / f"{name}.csv", stamps, values)
    end = "2023-01-02T12:00:00" + ("+00:00" if start.endswith("+00:00") else "")
    provider = {"type": "FileDataProvider", "base_dir": str(tmp_path)}
    ref, ours = _dataset_pair(train_start_date=start, train_end_date=end,
                              tag_list=["TAG-A", "TAG-B"], data_provider=provider)
    X = _assert_datasets(ref, ours)
    assert len(X) > 100


def test_file_provider_csv_values_equal_pandas_to_the_bit(tmp_path):
    """The provider's float64 values are ``pd.read_csv``'s, bit for bit:
    pandas' parser rounds some decimal strings one ulp off Python's
    ``float`` (about 30 % of these), and the reference reads with pandas."""
    from datetime import datetime, timezone

    from gordo_components_tpu.dataset.data_provider import FileDataProvider as RefFile
    from gordo_components_tpu.dataset.sensor_tag import SensorTag as RefTag

    from gordo_components_tpu_torch.dataset.data_provider import FileDataProvider
    from gordo_components_tpu_torch.dataset.sensor_tag import SensorTag

    rng = np.random.default_rng(13)
    stamps = [f"2023-01-01 00:{m:02d}:00" for m in range(60)]
    values = np.concatenate([np.cos(np.arange(30) / 12) + 10,
                             rng.normal(size=30) * 10.0 ** rng.integers(-8, 8, size=30)])
    _write_csv(tmp_path / "T.csv", stamps, values)
    start, end = datetime(2023, 1, 1, tzinfo=timezone.utc), datetime(2023, 1, 2, tzinfo=timezone.utc)
    ((_, _, ours),) = FileDataProvider(str(tmp_path)).load_series(start, end, [SensorTag("T")])
    (ref,) = RefFile(str(tmp_path)).load_series(start, end, [RefTag("T", None)])
    np.testing.assert_array_equal(ours, ref.to_numpy(dtype=np.float64))


def test_file_provider_parquet_equals_the_reference(tmp_path):
    pytest.importorskip("pyarrow")
    rng = np.random.default_rng(12)
    (tmp_path / "site").mkdir()
    for name, tz in (("P-1", "UTC"), ("P-2", None)):
        index = pd.date_range("2023-01-01", periods=700, freq="7min", tz=tz, name="timestamp")
        frame = pd.DataFrame({"value": rng.normal(size=700)}, index=index)
        frame.to_parquet(tmp_path / "site" / f"{name}.parquet")
    ref, ours = _dataset_pair(
        train_start_date="2023-01-01T01:00:00+00:00", train_end_date="2023-01-03T00:00:00+00:00",
        tag_list=[{"name": "P-1", "asset": "site"}, ["P-2", "site"]],
        data_provider={"type": "FileDataProvider", "base_dir": str(tmp_path)})
    _assert_datasets(ref, ours)


def test_file_provider_missing_file_and_can_handle_tag(tmp_path):
    _write_csv(tmp_path / "X.csv", ["2023-01-01T00:00:00"], [1.0])
    provider = FileDataProvider(str(tmp_path), assets=["a"])
    assert not provider.can_handle_tag(SensorTag("X", "b"))
    assert provider.can_handle_tag(SensorTag("X", "a"))
    with pytest.raises(FileNotFoundError, match="Y"):
        list(provider.load_series(START, START + timedelta(days=1), [SensorTag("Y", "a")]))


def test_composite_provider_dispatches_by_tag(tmp_path):
    _write_csv(tmp_path / "FILE-1.csv", [f"2023-01-01T00:{m:02d}:00" for m in range(50)],
               np.arange(50.0))
    composite = CompositeDataProvider([
        {"type": "FileDataProvider", "base_dir": str(tmp_path)},
        {"type": "gordo_components_tpu.dataset.data_provider.providers.RandomDataProvider"},
    ])
    names = [s[0] for s in composite.load_series(
        START, START + timedelta(hours=1),
        [SensorTag("FILE-1"), SensorTag("r-1"), SensorTag("r-2")])]
    assert names == ["FILE-1", "r-1", "r-2"]
    assert composite.to_dict()["providers"][1]["type"] == (
        "gordo_components_tpu_torch.dataset.data_provider.providers.RandomDataProvider")


def test_tag_dedup_keeps_the_first_spelling(caplog):
    dataset = TimeSeriesDataset(
        "2023-01-01T00:00:00+00:00", "2023-01-03T00:00:00+00:00",
        tag_list=[["tag-1", "plant-a"], "tag-2"], target_tag_list=[["tag-1", "plant-b"]],
        data_provider=RandomDataProvider(400, 500))
    seen = []

    class Recording(RandomDataProvider):
        def load_series(self, start, end, tags, dry_run=False):
            seen.extend(tags)
            return super().load_series(start, end, tags, dry_run)

    dataset.data_provider = Recording(400, 500)
    X, y = dataset.get_data()
    assert seen == [SensorTag("tag-1", "plant-a"), SensorTag("tag-2", None)]
    assert X.shape[1] == 2 and y.shape[1] == 1
    np.testing.assert_array_equal(X[:, 0], y[:, 0])
    assert "conflicting assets" in caplog.text


def test_insufficient_data_is_raised_as_the_reference_raises():
    config = dict(train_start_date="2023-01-01T00:00:00+00:00",
                  train_end_date="2023-01-02T00:00:00+00:00", tag_list=["a", "b"],
                  data_provider={"type": "RandomDataProvider"}, row_threshold=10_000)
    ref, ours = _dataset_pair(**config)
    with pytest.raises(RefInsufficientDataError, match="threshold 10000"):
        ref.get_data()
    with pytest.raises(InsufficientDataError, match="threshold 10000"):
        ours.get_data()
    assert issubclass(InsufficientDataError, ValueError)
    with pytest.raises(InsufficientDataError, match="no data"):
        join_timeseries(iter([("a", np.zeros(0, np.int64), np.zeros(0))]), START,
                        START + timedelta(days=1), "10min")
    with pytest.raises(InsufficientDataError, match="No series"):
        join_timeseries(iter([]), START, START + timedelta(days=1), "10min")


# -- config types and tags -------------------------------------------------------
@pytest.mark.parametrize("type_name", [
    None, "TimeSeriesDataset", "gordo_components_tpu.dataset.dataset.TimeSeriesDataset",
    "gordo_components_tpu.dataset.TimeSeriesDataset",
    "gordo_components_tpu_torch.dataset.dataset.TimeSeriesDataset",
    "RandomDataset", "gordo_components_tpu.dataset.dataset.RandomDataset",
])
def test_from_dict_takes_every_spelling_of_the_type(type_name):
    config = {"train_start_date": "2023-01-01T00:00:00+00:00",
              "train_end_date": "2023-01-02T00:00:00+00:00", "tag_list": ["a"],
              "data_provider": {"type": "gordo_components_tpu.dataset.data_provider."
                                        "RandomDataProvider", "min_size": 200}}
    if type_name is not None:
        config["type"] = type_name
    ours = GordoBaseDataset.from_dict(config)
    ref = RefBaseDataset.from_dict(_ported_types(config))
    assert type(ours).__name__ == type(ref).__name__
    assert type(ours).__module__ == "gordo_components_tpu_torch.dataset.dataset"
    assert isinstance(ours.data_provider, RandomDataProvider)
    assert _ported_types(ours.to_dict()) == ref.to_dict()
    again = GordoBaseDataset.from_dict(ours.to_dict())
    assert again.to_dict() == ours.to_dict()


@pytest.mark.parametrize("type_name,match", [
    ("os.path.join", "resolves"),
    ("gordo_components_tpu.dataset.dataset.TimeSeriesDataset", "resolves"),
    ("NoSuchProvider", "Unknown"),
])
def test_provider_from_dict_refuses_what_it_does_not_have(type_name, match):
    with pytest.raises(ValueError, match=match):
        GordoBaseDataProvider.from_dict({"type": type_name})
    with pytest.raises(ValueError, match="'type'"):
        GordoBaseDataProvider.from_dict({})


@pytest.mark.parametrize("type_name,kwargs,cls_name", [
    ("InfluxDataProvider", {}, "InfluxDataProvider"),
    ("gordo_components_tpu.dataset.data_provider.providers.InfluxDataProvider",
     {"host": "h", "database": "db"}, "InfluxDataProvider"),
    ("gordo_components_tpu.dataset.data_provider.ncs_iroc.NcsReader", {"base_dir": "/lake"},
     "NcsReader"),
    ("IrocReader", {"base_dir": "/lake"}, "IrocReader"),
    ("DataLakeProvider", {"base_dir": "/lake"}, "DataLakeProvider"),
])
def test_provider_from_dict_resolves_the_influx_and_lake_providers(type_name, kwargs, cls_name):
    """The providers the reference's configs name, by every spelling, with
    the reference's serialized form."""
    from gordo_components_tpu.dataset.data_provider import GordoBaseDataProvider as RefProvider

    ours = GordoBaseDataProvider.from_dict({"type": type_name, **kwargs})
    assert type(ours).__name__ == cls_name
    ref = RefProvider.from_dict({"type": type_name, **kwargs})
    assert ({k: v for k, v in ours.to_dict().items() if k != "type"}
            == {k: v for k, v in ref.to_dict().items() if k != "type"})


def test_dataset_from_dict_refuses_other_modules():
    with pytest.raises(ValueError, match="resolves"):
        GordoBaseDataset.from_dict({"type": "collections.OrderedDict"})
    with pytest.raises(ValueError, match="Unknown"):
        GordoBaseDataset.from_dict({"type": "GordoBaseDataset"})


def test_random_dataset_defaults_equal_the_reference():
    from gordo_components_tpu.dataset.dataset import RandomDataset as RefRandomDataset

    ours, ref = RandomDataset(), RefRandomDataset()
    X = _assert_datasets(ref, ours)
    assert X.shape[1] == 4


TAG_SPECS = ["GRA-TE-223", "1901.A-1", "ASGBTAG", "GRADIENT.01", "plain", ["x", "site"],
             ["y", None], ["z"], {"name": "w", "asset": "a"}, {"name": "1125-V"},
             SensorTag("s", "t")]


def test_sensor_tags_normalize_as_the_reference():
    ref = ref_normalize_sensor_tags(
        [RefSensorTag(*t) if isinstance(t, SensorTag) else t for t in TAG_SPECS])
    ours = normalize_sensor_tags(TAG_SPECS)
    assert [tuple(t) for t in ours] == [tuple(t) for t in ref]
    assert to_list_of_strings(ours) == [t.name for t in ref]
    assert normalize_sensor_tags(["q"], asset="given") == [SensorTag("q", "given")]
    for bad in ([1, 2, 3], {"asset": "a"}, 3.5):
        with pytest.raises(ValueError):
            normalize_sensor_tags([bad])


def test_dataset_config_round_trips_through_json():
    dataset = RandomDataset(tag_list=["a", "b"], train_end_date="2023-01-03T00:00:00+00:00")
    dataset.get_data()
    config = json.loads(json.dumps(dataset.get_metadata()["dataset_config"]))
    again = GordoBaseDataset.from_dict(config)
    np.testing.assert_array_equal(again.get_data()[0], dataset.get_data()[0])


# -- calendar resolutions and the remaining aggregations -------------------------
CALENDARS = ["W", "w", "W-MON", "w-Mon", "W-sun", "W-THU", "2W", "3W-WED", "+2W", "2 W", "ME",
             "2ME", "12ME", "MS", "3MS", "QE", "QE-JAN", "QE-DEC", "2QE-FEB", "QS", "QS-FEB",
             "QS-OCT", "2QS", "YE", "YE-JUN", "2YE", "YS", "YS-MAR", "1YS-JAN", "D", "2D",
             "3d", "24h", "48h", "1.5D", "1440min", "h", "min", "+1D"]
NEW_AGGREGATIONS = ["prod", "size", "nunique", "sem", "quantile", "ffill", "bfill", "nearest",
                    "asfreq", "interpolate"]
REDUCTIONS = NEW_AGGREGATIONS[:5]


def _long_series(seed, n_series=2, dense=False):
    """Irregular points over 15 months with duplicates, NaNs, repeated
    values (so nunique differs from count) and a gap of weeks; ``dense``:
    over two days at whole minutes instead (points on the labels, and
    halfway between two, which ``nearest`` must break as pandas does)."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n_series):
        n = int(rng.integers(200, 600))
        if dense:
            seconds = np.sort(rng.integers(0, 2 * 1440, size=n)) * 60
            seconds[n // 2:] += 3 * 3600  # a gap of hours
        else:
            seconds = np.sort(rng.integers(0, 456 * 86400, size=n))
            seconds[n // 2:] += 40 * 86400  # a gap of weeks
        seconds[5] = seconds[4]  # a duplicated timestamp
        ts = np.datetime64("2023-01-03T05:17:00", "ns").astype(np.int64) + \
            seconds.astype(np.int64) * 1_000_000_000
        values = np.round(rng.normal(size=n) * 3, 1)  # repeats among the values
        values[rng.integers(0, n, size=n // 10)] = np.nan
        out.append((f"t{i}", ts, values))
    return out


def _exact_frames(ref_frame, ref_meta, frame, meta):
    """Frames equal exactly: the index to the nanosecond, every value as
    the reference's float64 (NaN where it is NaN)."""
    assert meta == ref_meta
    assert frame.columns == list(ref_frame.columns)
    np.testing.assert_array_equal(frame.index, ref_frame.index.as_unit("ns").asi8)
    np.testing.assert_array_equal(frame.values, ref_frame.to_numpy(np.float64))


def _both(series, *args):
    """The port's join and the reference's on the same series: both frames,
    or the exception type each raised (each package's
    ``InsufficientDataError`` read as the same)."""
    import warnings

    out = []
    for join, data in ((join_timeseries, series), (ref_join_timeseries, _ref_series(series))):
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                out.append(join(iter(data), *args))
        except (InsufficientDataError, RefInsufficientDataError):
            out.append(InsufficientDataError)
        except Exception as exc:  # noqa: BLE001 - the type is what is compared
            out.append(type(exc))
    return out


@pytest.mark.parametrize("resolution", CALENDARS)
@pytest.mark.parametrize("seed", [0, 1])
def test_calendar_resolutions_bin_and_label_as_pandas(resolution, seed):
    """Each calendar alias's bins, closed side, labels and values, and the
    range slice, exactly as the reference's; ``origin`` mid-day, where
    pandas ignores it for calendar offsets and days."""
    start = datetime(2023, 1, 2, 6, tzinfo=UTC)
    end = datetime(2024, 5, 1, tzinfo=UTC)
    # one series: a multiple's grid starts at each series' own first
    # point, so two series rarely share a label
    ours, theirs = _both(_long_series(seed, 1), start, end, resolution,
                         ["mean", "count", "max", "size"], "linear_interpolation", None)
    assert not isinstance(theirs, type), theirs
    _exact_frames(*theirs, *ours)
    assert len(ours[0].index) > 0


@pytest.mark.parametrize("aggregation", NEW_AGGREGATIONS + [REDUCTIONS, ["mean", "size"],
                                                           ["quantile", "median", "sem", "std"]])
@pytest.mark.parametrize("resolution", ["10min", "7h", "W", "ME", "QS"])
@pytest.mark.parametrize("interpolation", ["linear_interpolation", "ffill", "none"])
def test_the_remaining_aggregations_equal_the_reference(aggregation, resolution, interpolation):
    start = datetime(2023, 1, 1, tzinfo=UTC)
    end = datetime(2024, 6, 1, tzinfo=UTC)
    # 10min: several points per bin, some on the labels
    series = _long_series(3, dense=resolution == "10min")
    ours, theirs = _both(series, start, end, resolution, aggregation, interpolation,
                         None if resolution in ("W", "ME", "QS") else "8H")
    assert not isinstance(theirs, type), theirs
    _exact_frames(*theirs, *ours)


@pytest.mark.parametrize("resolution,limit", [
    ("W", "8H"), ("W-SUN", "8H"), ("ME", "8H"), ("2ME", "8H"), ("QE-JAN", "8H"),
    ("1W", "8H"), ("2W", "8H"), ("2w", "20D"), ("-2W", "8H"), ("-2W", None), ("0W", "8H"),
    ("0W", None), ("0ME", None), ("0ME", "8H"), ("-1ME", None), ("-1MS", None),
    ("-2QS", None), ("-1YS", None), ("-1W-MON", None), ("-1QE", None), ("-3YE", None),
    ("0QS", None), ("M", None), ("Q", None), ("Y", None), ("A", None), ("me", None),
    ("Me", None), ("Qe", None), ("qs", None), ("QE-dec", None), ("YE-Dec", None),
    ("ME-JAN", None), ("MS-FEB", None), ("W-MONDAY", None), ("W-", None), ("QE-XYZ", None),
    ("1.5W", None), ("0min", None), ("0min", "8H"), ("-10min", None), ("0D", None),
    ("-1D", None), ("D", "8H"), ("h", "8H"), ("10min", "0min"),
    ("SMS-1", None), ("SME-28", None), ("SME-X", None), ("B-MON", None), ("CBMS-JAN", None),
    ("bme", None), ("Bme", None), ("cbme", None), ("BM", None), ("BQ", None), ("BA", None),
    ("BY", None), ("SM", None), ("-1B", None), ("0B", None), ("0BME", None), ("-1SME", None),
    ("0SMS", None), ("-2BQS", None), ("B", "8H"), ("SME", "8H"), ("0bh", None),
    ("-1bh", None), ("0cbh", None), ("BH", None), ("CBH", None), ("Bh", None), ("1.5bh", None),
    ("bh-x", None), ("bh", "8H"), ("WOM-5MON", None), ("WOM-0MON", None), ("WOM-1mon", None),
    ("LWOM-X", None), ("LWOM", None), ("WOM", None), ("hye", None), ("HYE-X", None),
    ("0WOM-1MON", None), ("0HYE", None), ("-2HYS", None), ("lwom-MON", None), ("HYE", "8H"),
    ("RE", None), ("REQ", None), ("RE-N-JAN", None), ("REQ-N-JAN-MON", None),
    ("RE-X-JAN-MON", None), ("re-N-JAN-MON", None), ("0RE-N-JAN-MON", None),
    ("0REQ-N-JAN-MON-1", None), ("RE-N-jan-mon", None), ("RE-N-JAN-MON-1", None),
    ("REQ-N-JAN-MON-5", None), ("REQ-N-JAN-MON-0", None), ("RE-N-JAN-MON", "8H"),
    ("-1LWOM-MON", None), ("-1RE-L-JAN-MON", None), ("-1REQ-N-JAN-MON-1", None),
])
def test_a_resolution_the_reference_refuses_raises_the_same_type(resolution, limit):
    start = datetime(2023, 1, 2, tzinfo=UTC)
    end = datetime(2024, 5, 1, tzinfo=UTC)
    ours, theirs = _both(_long_series(5, 1), start, end, resolution, "mean",
                         "linear_interpolation", limit)
    if isinstance(theirs, type):
        assert ours is theirs, (ours, theirs)
    else:
        _exact_frames(*theirs, *ours)


LIST_REDUCTIONS = [["any", "all", "skew", "kurt"], ["skew"], ["kurt", "mean"], ["all"],
                   ["idxmin", "idxmax", "mean"], ["idxmax"]]


@pytest.mark.parametrize("aggregation", LIST_REDUCTIONS)
@pytest.mark.parametrize("resolution", ["10min", "2h", "D", "W", "ME"])
@pytest.mark.parametrize("interpolation", ["linear_interpolation", "ffill", "none"])
def test_the_list_reductions_equal_the_reference(aggregation, resolution, interpolation):
    """``any``/``all`` (pandas' bools as 1.0/0.0), ``skew``/``kurt`` (its
    running moments, to the bit) and ``idxmin``/``idxmax`` (the point's
    timestamp, read as float64; a bin without a number raises
    ``ValueError`` in both)."""
    start = datetime(2023, 1, 1, tzinfo=UTC)
    end = datetime(2024, 6, 1, tzinfo=UTC)
    series = _long_series(4, dense=resolution in ("10min", "2h", "D"))
    ours, theirs = _both(series, start, end, resolution, aggregation, interpolation, None)
    if isinstance(theirs, type):
        assert ours is theirs, (ours, theirs)
    else:
        _exact_frames(*theirs, *ours)


def test_idxmin_and_idxmax_give_the_points_timestamps_where_every_bin_has_one():
    start = datetime(2023, 1, 1, tzinfo=UTC)
    end = datetime(2024, 6, 1, tzinfo=UTC)
    ours, theirs = _both(_long_series(3, dense=True), start, end, "D", ["idxmin", "idxmax"],
                         "linear_interpolation", None)
    assert not isinstance(theirs, type), theirs
    _exact_frames(*theirs, *ours)
    stamps = {int(t) for _, ts, _ in _long_series(3, dense=True) for t in ts}
    assert len(ours[0].index) and {int(v) for v in ours[0].values.ravel()} <= stamps


def test_skew_and_kurt_are_pandas_running_moments_to_the_bit():
    """Large offsets and repeated values, where a two-pass formula and the
    running update differ in the last bits."""
    from gordo_components_tpu_torch.dataset.dataset import _aggregate

    rng = np.random.default_rng(12)
    for trial in range(60):
        n = int(rng.integers(4, 300))
        bins = np.sort(rng.integers(0, max(1, n // int(rng.integers(1, 30))), n))
        bins -= bins[0]
        values = rng.normal(size=n) * 1e3 + 1e6 if trial % 2 else np.round(rng.normal(size=n), 1)
        within = np.arange(n) - np.searchsorted(bins, bins)  # a point's place in its bin
        index = pd.Timestamp("2023-01-01", tz="UTC") + pd.to_timedelta(
            bins * 3_600_000 + within, "ms")
        grouped = pd.Series(values, index=index).resample("h")
        for method in ("skew", "kurt"):
            ref = grouped.agg([method])[method].to_numpy()
            ours = _aggregate(method, bins, values, int(bins[-1]) + 1)
            np.testing.assert_array_equal(ours, ref)


TRANSFORMS = ["ffill", "bfill", "cumsum", "cumprod", "cummin", "cummax", "cumcount", "diff",
              "shift", "rank", "pct_change", "ngroup", "head", "tail", "nlargest", "nsmallest"]


@pytest.mark.parametrize("aggregation", [[m] for m in TRANSFORMS] + [
    ["mean", "cumsum"], ["rank", "max"], ["nlargest", "nsmallest", "head"],
    ["cumsum", "skew", "rank"], ["any", "cumsum"], ["cumsum", "all"], ["idxmin", "cumsum"],
    ["diff", "pct_change", "size"]], ids=str)
@pytest.mark.parametrize("resolution", ["10min", "D", "W"])
@pytest.mark.parametrize("interpolation", ["linear_interpolation", "ffill", "none"])
def test_the_list_transforms_equal_the_reference(aggregation, resolution, interpolation):
    """The groupby methods that answer per point: their column at the
    points' timestamps, mixed with reductions the union in pandas' order
    (labels first, or points first), interpolated by position over that
    order, and the inner join keeping the first series' order; a bool
    column given NaNs by the union refuses the linear interpolation with
    ``TypeError`` in both."""
    start = datetime(2023, 1, 1, tzinfo=UTC)
    end = datetime(2024, 6, 1, tzinfo=UTC)
    series = _long_series(4, dense=resolution != "W")
    ours, theirs = _both(series, start, end, resolution, aggregation, interpolation,
                         None if resolution == "W" else "8H")
    if isinstance(theirs, type):
        assert ours is theirs, (ours, theirs)
    else:
        _exact_frames(*theirs, *ours)


BUSINESS = ["B", "b", "2B", "C", "c", "2C", "BME", "2BME", "BMS", "CBME", "CBMS", "2CBMS", "SME",
            "SMS", "SME-20", "SMS-3", "SME-1", "2SME", "3SMS-27", "BQE", "BQE-FEB", "BQS",
            "BQS-MAR", "2BQE", "BYE", "BYE-JUN", "BYS", "2BYS-MAR", "bh", "3bh", "8bh", "9bh",
            "cbh", "2cbh", "HYE", "HYS", "HYE-JAN", "2HYS-MAR", "BHYE", "BHYS-FEB", "WOM-1MON",
            "WOM-3FRI", "2WOM-4SUN", "LWOM-MON", "3LWOM-WED", "RE-N-JAN-MON", "RE-L-DEC-SUN",
            "2RE-N-MAR-FRI", "REQ-N-JAN-MON-1", "REQ-L-MAR-FRI-4", "2REQ-N-DEC-SUN-2"]


@pytest.mark.parametrize("resolution", BUSINESS)
@pytest.mark.parametrize("dense", [False, True])
def test_business_offsets_bin_and_label_as_pandas(resolution, dense):
    """The business, semi-month and business-hour offsets' bins, closed
    side, labels and values, over 15 months and, dense, over two days at
    whole minutes (points on the business hours' edges)."""
    start = datetime(2023, 1, 2, 6, tzinfo=UTC)
    end = datetime(2024, 5, 1, tzinfo=UTC)
    ours, theirs = _both(_long_series(1, 1, dense=dense), start, end, resolution,
                         ["mean", "count", "max", "size"], "linear_interpolation", None)
    assert not isinstance(theirs, type), theirs
    _exact_frames(*theirs, *ours)


OFFSET_ANCHORS = {
    "B": [0], "C": [0], "BME": [0], "BMS": [0], "CBME": [0], "CBMS": [0], "SME": [1, 15, 27],
    "SMS": [2, 15, 27], "BQE": [1, 2, 3, 12], "BQS": [1, 2, 3, 10], "BYE": [6, 12], "BYS": [1, 3],
    "HYE": [1, 3, 6, 12], "HYS": [1, 2, 7], "BHYE": [6, 12], "BHYS": [1, 3],
    "WOM": [0, 6, 9, 20, 27], "LWOM": [0, 3, 6],
}


# pandas' week-of-month offsets refuse n = 0 (the refusal test holds it)
@pytest.mark.parametrize("kind,anchors,n", [
    (kind, anchors, n) for kind, anchors in OFFSET_ANCHORS.items() for n in (-3, -1, 0, 1, 2, 5)
    if n or kind not in ("WOM", "LWOM")])
def test_business_offset_arithmetic_equals_pandas(kind, anchors, n):
    from gordo_components_tpu_torch.dataset.dataset import _apply, _Calendar, _on_offset

    offsets = pd.offsets
    days = pd.date_range("2023-01-01", "2024-12-31", freq="D")
    for anchor in anchors:
        off = _Calendar(kind, n, anchor)
        ref = {"B": lambda: offsets.BusinessDay(n), "C": lambda: offsets.CustomBusinessDay(n),
               "BME": lambda: offsets.BusinessMonthEnd(n),
               "BMS": lambda: offsets.BusinessMonthBegin(n),
               "CBME": lambda: offsets.CustomBusinessMonthEnd(n),
               "CBMS": lambda: offsets.CustomBusinessMonthBegin(n),
               "SME": lambda: offsets.SemiMonthEnd(n, day_of_month=anchor),
               "SMS": lambda: offsets.SemiMonthBegin(n, day_of_month=anchor),
               "BQE": lambda: offsets.BQuarterEnd(n, startingMonth=anchor),
               "BQS": lambda: offsets.BQuarterBegin(n, startingMonth=anchor),
               "BYE": lambda: offsets.BYearEnd(n, month=anchor),
               "BYS": lambda: offsets.BYearBegin(n, month=anchor),
               "HYE": lambda: offsets.HalfYearEnd(n, startingMonth=anchor),
               "HYS": lambda: offsets.HalfYearBegin(n, startingMonth=anchor),
               "BHYE": lambda: offsets.BHalfYearEnd(n, startingMonth=anchor),
               "BHYS": lambda: offsets.BHalfYearBegin(n, startingMonth=anchor),
               "WOM": lambda: offsets.WeekOfMonth(n, week=anchor // 7, weekday=anchor % 7),
               "LWOM": lambda: offsets.LastWeekOfMonth(n, weekday=anchor)}[kind]()
        for day in days:
            assert _apply(off, day.date(), n) == (day + ref).date(), (kind, anchor, n, day)
            assert _on_offset(off, day.date()) == ref.is_on_offset(day), (kind, anchor, day)


@pytest.mark.parametrize("kind,n", [("RE", n) for n in (-3, -1, 1, 2, 5)]
                         + [("REQ", n) for n in (-1, 1, 2, 5)])
def test_fiscal_year_and_quarter_arithmetic_equals_pandas(kind, n):
    """``FY5253`` and ``FY5253Quarter`` (nearest and last, two months, two
    weekdays, two quarters given the extra week) on every day of three
    years, a 53-week year among them."""
    from gordo_components_tpu_torch.dataset.dataset import _apply, _Calendar, _Fiscal, _on_offset

    days = pd.date_range("2021-12-01", "2025-02-10", freq="D")
    for month in (1, 12):
        for weekday in (0, 6):
            for last in (False, True):
                for quarter in ((0,) if kind == "RE" else (1, 4)):
                    variation = "last" if last else "nearest"
                    ref = (pd.offsets.FY5253(n, startingMonth=month, weekday=weekday,
                                             variation=variation) if kind == "RE" else
                           pd.offsets.FY5253Quarter(n, startingMonth=month, weekday=weekday,
                                                    variation=variation,
                                                    qtr_with_extra_week=quarter))
                    off = _Calendar(kind, n, _Fiscal(month, weekday, last, quarter))
                    for day in days:
                        assert _apply(off, day.date(), n) == (day + ref).date(), (ref, day)
                        assert _on_offset(off, day.date()) == ref.is_on_offset(day), (ref, day)


@pytest.mark.parametrize("n", [1, 2, 7, 8, 9, 16, 17, 40])
def test_business_hour_arithmetic_equals_pandas(n):
    from gordo_components_tpu_torch.dataset.dataset import _bh_apply, _bh_on_offset, _bh_rollback

    offset = pd.offsets.BusinessHour(n)
    moments = pd.date_range("2023-01-05", "2023-01-17", freq="17min").append(
        pd.date_range("2023-01-05", "2023-01-17", freq="h"))
    for moment in moments:
        dt = moment.to_pydatetime()
        assert _bh_apply(dt, n) == (moment + offset).to_pydatetime(), (n, moment)
        assert _bh_on_offset(dt) == offset.is_on_offset(moment), moment
        assert _bh_rollback(dt) == offset.rollback(moment).to_pydatetime(), moment


@pytest.mark.parametrize("aggregation", [
    "ohlc", ["mean", "ohlc"], ["ohlc"], "any", "skew", "idxmax", "cumsum", "nth",
    ["mean", "asfreq"], ["mean", "nearest"], ["mean", "interpolate"], ["mean", "nth"],
    ["mean", "no-such-method"], "no-such-method",
    *[[name] for name in ("agg", "apply", "corr", "describe", "ewm", "expanding", "exclusions",
                          "filter", "groups", "pipe", "rolling", "transform", "value_counts",
                          "hist", "unique")],
    "agg", "apply", "groups", "transform", "describe",
])
def test_an_aggregation_the_reference_refuses_raises_the_same_type(aggregation):
    start = datetime(2023, 1, 2, tzinfo=UTC)
    end = datetime(2024, 5, 1, tzinfo=UTC)
    ours, theirs = _both(_long_series(6, 1), start, end, "W", aggregation,
                         "linear_interpolation", None)
    assert isinstance(theirs, type) and ours is theirs, (ours, theirs)


def test_an_error_of_the_aggregation_waits_for_a_series_as_the_references_does():
    ours, theirs = _both([], START, START + timedelta(days=1), "NOPE", "no-such-method",
                         "linear_interpolation", None)
    assert ours is theirs is InsufficientDataError


@pytest.mark.parametrize("kind,anchors", [
    ("W", list(range(7))), ("ME", [0]), ("MS", [0]), ("QE", [1, 2, 3, 12]),
    ("QS", [1, 2, 3, 10]), ("YE", [6, 12]), ("YS", [1, 3]),
])
@pytest.mark.parametrize("n", [-3, -1, 1, 2, 5])
def test_offset_arithmetic_equals_pandas(kind, anchors, n):
    """``_apply`` and ``_on_offset`` against pandas' offsets, on every day
    of two years."""
    from gordo_components_tpu_torch.dataset.dataset import _apply, _Calendar, _on_offset

    days = pd.date_range("2023-01-01", "2024-12-31", freq="D")
    for anchor in anchors:
        off = _Calendar(kind, n, anchor)
        ref = {"W": lambda: pd.offsets.Week(n, weekday=anchor),
               "ME": lambda: pd.offsets.MonthEnd(n), "MS": lambda: pd.offsets.MonthBegin(n),
               "QE": lambda: pd.offsets.QuarterEnd(n, startingMonth=anchor),
               "QS": lambda: pd.offsets.QuarterBegin(n, startingMonth=anchor),
               "YE": lambda: pd.offsets.YearEnd(n, month=anchor),
               "YS": lambda: pd.offsets.YearBegin(n, month=anchor)}[kind]()
        for day in days:
            assert _apply(off, day.date(), n) == (day + ref).date(), (kind, anchor, n, day)
            assert _on_offset(off, day.date()) == ref.is_on_offset(day), (kind, anchor, day)
