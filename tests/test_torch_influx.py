"""The port's InfluxDB 1.x client and provider over real sockets against the
in-repo double (``tests/influx_double.py``), case for case as the
reference's ``tests/test_influx.py``, and across the packages: the same
points queried through either client give equal arrays, and a write
through either is read back through the other.

Everything here is exact: timestamps to the nanosecond, values to the bit
(the wire carries ``repr`` floats and ``Ni`` integers both ways).
"""

from datetime import datetime, timezone

import numpy as np
import pandas as pd
import pytest

from gordo_components_tpu.dataset.data_provider.influx_client import (
    MinimalInfluxClient as RefInfluxClient,
)
from gordo_components_tpu.dataset.data_provider import InfluxDataProvider as RefInfluxProvider
from gordo_components_tpu.dataset.sensor_tag import SensorTag as RefSensorTag

from gordo_components_tpu_torch.client.forwarders import ForwardPredictionsIntoInflux
from gordo_components_tpu_torch.dataset import TimeSeriesDataset
from gordo_components_tpu_torch.dataset.data_provider import InfluxDataProvider
from gordo_components_tpu_torch.dataset.data_provider.influx_client import (
    InfluxQueryError,
    MinimalInfluxClient,
    _field_value,
)
from gordo_components_tpu_torch.dataset.sensor_tag import SensorTag

from influx_double import InfluxDouble

START = datetime(2023, 1, 1, tzinfo=timezone.utc)
END = datetime(2023, 1, 2, tzinfo=timezone.utc)


def _ns(start, periods, freq):
    return pd.date_range(start, periods=periods, freq=freq, tz="UTC").as_unit("ns").asi8


def _seed_sensor_data(client, tags, periods=144, measurement="sensor_data"):
    """Per-tag series as an ingest job writes them: one measurement, the
    tag in the tag set, the reading in the ``value`` field."""
    for offset, tag in enumerate(tags):
        client.write_points([np.arange(periods, dtype=float) + 100 * offset], ["value"],
                            _ns("2023-01-01", periods, "10min"), measurement,
                            tags={"tag": tag})


def _client(server, cls=MinimalInfluxClient):
    return cls(host=server.host, port=server.port, database="db")


def _scores(ns, scale=1.0):
    """The client's score frame as the forwarder writes it."""
    from gordo_components_tpu_torch.client import ScoredFrame

    n = len(ns)
    scores = (np.arange(2 * n, dtype=np.float32).reshape(n, 2) / 7 * scale)
    return ScoredFrame(np.zeros((n, 2), np.float32), np.zeros((n, 2), np.float32), scores,
                       np.linalg.norm(scores, axis=1).astype(np.float32), np.asarray(ns),
                       None, None)


def test_client_write_query_round_trip():
    with InfluxDouble() as server:
        client = _client(server)
        _seed_sensor_data(client, ["t1"], periods=6)
        result = client.query(
            "SELECT \"value\" FROM \"sensor_data\" WHERE tag = 't1' "
            "AND time >= '2023-01-01T00:00:00+00:00' "
            "AND time < '2023-01-01T00:40:00+00:00'"
        )
        series = result["sensor_data"]
        assert series.columns["value"].tolist() == [0.0, 1.0, 2.0, 3.0]
        assert series.columns["value"].dtype == np.float64
        np.testing.assert_array_equal(np.diff(series.timestamps), 600 * 10**9)
        assert series.timestamps[0] == _ns("2023-01-01", 1, "10min")[0]


def test_client_escaping_survives_the_wire():
    with InfluxDouble() as server:
        client = _client(server)
        client.write_points([np.array([1.5, 2.5]), np.array(['say "hi", ok', "plain"], object)],
                            ["value", "note"], _ns("2023-01-01", 2, "1h"),
                            "odd, measurement", tags={"tag": "GRA we,ird=01"})
        result = client.query('SELECT "value" FROM "odd, measurement" '
                              "WHERE tag = 'GRA we,ird=01'")
        assert result["odd, measurement"].columns["value"].tolist() == [1.5, 2.5]
        notes = client.query('SELECT "note" FROM "odd, measurement"')
        assert notes["odd, measurement"].columns["note"].tolist() == ['say "hi", ok', "plain"]


def test_client_mixed_field_types_and_nan_rows():
    with InfluxDouble() as server:
        client = _client(server)
        client.write_points(
            [np.array([1.0, np.nan, 3.0]), np.array(["ok", "degraded", "ok"], object),
             np.array([1, 2, 3])],
            ["value", "status", "count"], _ns("2023-01-01", 3, "1h"), "m",
            tags={"machine": "x"})
        # an all-missing row has no line-protocol form and is skipped
        client.write_points([np.array([np.nan])], ["value"], _ns("2023-02-01", 1, "1h"), "m")
        result = client.query('SELECT * FROM "m"')["m"]
        assert result.columns["count"].tolist() == [1, 2, 3]
        assert result.columns["count"].dtype == np.int64
        assert np.isnan(result.columns["value"]).sum() == 1  # the NaN field left out
        assert result.columns["status"].tolist() == ["ok", "degraded", "ok"]
        assert server.point_count("db", "m") == 3


def test_client_int_fields_survive_numeric_columns():
    with InfluxDouble() as server:
        client = _client(server)
        client.write_points([np.array([1.5, 2.5]), np.array([1, 2])], ["value", "count"],
                            _ns("2023-01-01", 2, "1h"), "m")
        back = client.query('SELECT * FROM "m"')["m"]
        assert back.columns["count"].tolist() == [1, 2]
        assert back.columns["count"].dtype.kind == "i"
        # a 2-D float block keeps floats, an int block ints
        client.write_points(np.array([[7, 8]]), ["a", "b"], _ns("2023-03-01", 1, "1h"), "n")
        assert client.query('SELECT * FROM "n"')["n"].columns["a"].dtype.kind == "i"
    assert _field_value(None) is None
    assert _field_value(np.datetime64("NaT")) is None
    assert _field_value(np.float32(np.nan)) is None
    assert _field_value(True) == "true" and _field_value(np.int64(3)) == "3i"


def test_client_rejects_newline_injection():
    client = MinimalInfluxClient(host="localhost", port=1, database="db")
    ns = _ns("2023-01-01", 1, "1h")
    with pytest.raises(ValueError, match="newline"):
        client.write_points([np.array([1.0])], ["value"], ns, "m", tags={"machine": "evil\nname"})
    with pytest.raises(ValueError, match="newline"):
        client.write_points([np.array([1.0])], ["value"], ns, "bad\nmeasurement")
    with pytest.raises(ValueError, match="newline"):
        client.write_points([np.array(["degraded\nsee log"], object)], ["status"], ns, "m")


def test_client_rejects_unsupported_transport_kwargs():
    with pytest.raises(ValueError, match="use_udp"):
        MinimalInfluxClient(host="h", use_udp=True, udp_port=4444)
    with pytest.raises(ValueError, match="verify_ssl"):
        MinimalInfluxClient(host="h", ssl=True, verify_ssl=False)
    MinimalInfluxClient(host="h", pool_size=10, retries=3)


def test_client_error_surface():
    with InfluxDouble() as server:
        with pytest.raises(InfluxQueryError, match="cannot parse"):
            _client(server).query("DROP SERIES FROM everything")


def test_provider_speaks_http_end_to_end():
    """No injected client: the provider makes its minimal client and feeds
    the dataset over a real socket."""
    with InfluxDouble() as server:
        _seed_sensor_data(_client(server), ["t1", "t2"])
        provider = InfluxDataProvider(measurement="sensor_data", host=server.host,
                                      port=server.port, database="db")
        assert isinstance(provider._client, MinimalInfluxClient)
        ds = TimeSeriesDataset(data_provider=provider,
                               train_start_date="2023-01-01T00:00:00+00:00",
                               train_end_date="2023-01-02T00:00:00+00:00",
                               tag_list=["t1", "t2"], resolution="10min")
        X, _ = ds.get_data()
        assert ds.x_columns == ["t1", "t2"]
        assert len(X) == 144
        assert X[0, 1] == 100.0
        assert any(r.startswith("GET /query") for r in server.requests)


def test_provider_dry_run_limits_the_pull():
    with InfluxDouble() as server:
        _seed_sensor_data(_client(server), ["t1"])
        provider = InfluxDataProvider(measurement="sensor_data", host=server.host,
                                      port=server.port, database="db")
        list(provider.load_series(START, END, [SensorTag("t1", "asset")], dry_run=True))
        assert len([r for r in server.requests if r.startswith("GET /query")]) == 1


def test_provider_api_key_header_and_secrets_not_serialized():
    """The API key rides its header; neither it nor the password lands in
    ``to_dict`` (build metadata is served at ``GET /metadata``)."""
    provider = InfluxDataProvider(host="h", port=1, database="db", password="pw",
                                  api_key="k3y", api_key_header="X-Key")
    assert provider._client._headers["X-Key"] == "k3y"
    assert InfluxDataProvider(api_key="k")._client._headers == {
        "Ocp-Apim-Subscription-Key": "k"}
    serialized = str(provider.to_dict())
    assert "pw" not in serialized and "k3y" not in serialized
    injected = object()
    assert InfluxDataProvider(client=injected)._client is injected


def test_forwarder_round_trip():
    with InfluxDouble() as server:
        forwarder = ForwardPredictionsIntoInflux(measurement="anomaly", host=server.host,
                                                 port=server.port, database="db")
        assert isinstance(forwarder._client, MinimalInfluxClient)
        ns = _ns("2023-06-01", 4, "10min")
        forwarder.forward("machine-a", _scores(ns))
        forwarder.forward("machine-b", _scores(ns, 2.0))
        back = _client(server).query(
            "SELECT \"total-anomaly-score\" FROM \"anomaly\" WHERE machine = 'machine-a'"
        )["anomaly"]
        np.testing.assert_array_equal(back.columns["total-anomaly-score"],
                                      _scores(ns).values[:, -1])
        np.testing.assert_array_equal(back.timestamps, ns)
        assert len(_client(server).query('SELECT * FROM "anomaly"')["anomaly"].timestamps) == 8


def test_provider_to_forwarder_loop():
    with InfluxDouble() as server:
        _seed_sensor_data(_client(server), ["t1"])
        provider = InfluxDataProvider(measurement="sensor_data", host=server.host,
                                      port=server.port, database="db")
        ((name, ns, values),) = provider.load_series(START, END, [SensorTag("t1", "asset")])
        frame = _scores(ns)
        ForwardPredictionsIntoInflux(measurement="anomaly", host=server.host, port=server.port,
                                     database="db").forward("m1", frame)
        back = _client(server).query(
            "SELECT \"total-anomaly-score\" FROM \"anomaly\" WHERE machine = 'm1'")["anomaly"]
        assert name == "t1" and len(back.timestamps) == len(values) == 144


@pytest.mark.parametrize("query", [
    'SELECT * FROM "m"',
    "SELECT \"value\" FROM \"m\" WHERE machine = 'x' AND time >= '2023-01-01T01:00:00+00:00'",
    'SELECT "count" FROM "m" LIMIT 2',
])
def test_both_clients_read_the_same_points(query):
    """The reference's frames and the port's arrays from one store: the
    index nanoseconds, each column's values and dtype kind."""
    with InfluxDouble() as server:
        _client(server).write_points(
            [np.array([1.0, np.nan, 3.0, 0.1]), np.array([1, 2, 3, 4]),
             np.array(["ok", "bad", None, "ok"], object)],
            ["value", "count", "status"], _ns("2023-01-01", 4, "1h"), "m",
            tags={"machine": "x"})
        ours = _client(server).query(query)["m"]
        ref = _client(server, RefInfluxClient).query(query)["m"]
        np.testing.assert_array_equal(ours.timestamps, ref.index.as_unit("ns").asi8)
        assert list(ours.columns) == list(ref.columns)
        for name, column in ours.columns.items():
            expected = ref[name].to_numpy()
            if column.dtype == object:
                assert [None if v is None or v != v else v for v in expected] == column.tolist()
            else:
                assert column.dtype.kind == expected.dtype.kind
                np.testing.assert_array_equal(column, expected.astype(column.dtype))


def test_writes_cross_between_the_packages():
    """A frame the reference writes reads back through the port, and the
    port's arrays read back through the reference, point for point."""
    idx = pd.date_range("2023-01-01", periods=5, freq="10min", tz="UTC")
    frame = pd.DataFrame({"value": [0.5, 1.25, np.nan, 1e-7, 3.0], "count": [1, 2, 3, 4, 5]},
                         index=idx)
    with InfluxDouble() as server:
        _client(server, RefInfluxClient).write_points(frame, "ref", tags={"tag": "a"})
        _client(server).write_points([frame["value"].to_numpy(), frame["count"].to_numpy()],
                                     ["value", "count"], idx.as_unit("ns").asi8, "ours",
                                     tags={"tag": "a"})
        ours_read = _client(server).query('SELECT * FROM "ref"')["ref"]
        ref_read = _client(server, RefInfluxClient).query('SELECT * FROM "ours"')["ours"]
        np.testing.assert_array_equal(ours_read.timestamps, idx.as_unit("ns").asi8)
        np.testing.assert_array_equal(ours_read.columns["value"], frame["value"].to_numpy())
        np.testing.assert_array_equal(ours_read.columns["count"], frame["count"].to_numpy())
        np.testing.assert_array_equal(ref_read.index.as_unit("ns").asi8, idx.as_unit("ns").asi8)
        np.testing.assert_array_equal(ref_read["value"].to_numpy(), frame["value"].to_numpy())
        assert ref_read["count"].tolist() == [1, 2, 3, 4, 5]
        # both providers read the port's write as the same series
        ours = list(InfluxDataProvider(measurement="ours", host=server.host, port=server.port,
                                       database="db").load_series(START, END, [SensorTag("a")]))
        ref = list(RefInfluxProvider(measurement="ours", host=server.host, port=server.port,
                                     database="db").load_series(START, END, [RefSensorTag("a")]))
        ((name, ns, values),), (series,) = ours, ref
        assert name == series.name == "a"
        np.testing.assert_array_equal(ns, series.index.as_unit("ns").asi8)
        np.testing.assert_array_equal(values, series.to_numpy(dtype=float))
