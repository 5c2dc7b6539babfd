"""The server's ``?start&end`` fetches and parquet bodies: the port's
``ModelServer.handle`` (``device="cpu"``) against the reference's WSGI app
(werkzeug's test client, JAX on the CPU) on the same artifacts.

The artifacts are built by the JAX package from a data config naming
``InfluxDataProvider`` at the in-repo InfluxDB double
(``tests/influx_double.py``), which both servers then read: a PatchTST
detector (1 layer, d_model 16, lookback 32, the flash kernel; the
reference's runs its Pallas kernel in interpret mode, the port's the
kernel's plain version) and a dense one. Both servers answer the same
range with the same rows: model-input exactly, the other arrays within
``SERVE_RTOL`` (1e-4) of each array's magnitude (float32 both sides, the
products summed in other orders), the timestamps and thresholds exactly;
a PatchTST chunk of ``n`` rows scores ``n - 31`` of them, the count the
reference's tail alignment gives. Then the refusals (422, the 400s, the
``data-fetch`` fault point, a deadline spent before the provider), the
``data_fetch`` stage, and parquet bodies (column order, missing tags,
non-numeric data, timestamps in and out of UTC, the 415 without pyarrow).
"""

import io
import json
import sys

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from werkzeug.test import Client  # noqa: E402

from gordo_components_tpu.builder import build_model as ref_build_model  # noqa: E402
from gordo_components_tpu.resilience import faults as ref_faults  # noqa: E402
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.server import build_app  # noqa: E402

from gordo_components_tpu_torch import wire  # noqa: E402
from gordo_components_tpu_torch.dataset.data_provider.influx_client import (  # noqa: E402
    MinimalInfluxClient,
)
from gordo_components_tpu_torch.observability import flightrec  # noqa: E402
from gordo_components_tpu_torch.resilience import faults  # noqa: E402
from gordo_components_tpu_torch.server.server import ModelServer  # noqa: E402

from influx_double import InfluxDouble  # noqa: E402

SERVE_RTOL = 1e-4
TAGS = ["fetch-a", "fetch-b", "fetch-c"]
LOOKBACK = 32
ROWS = 6 * 24 * 3  # three days at 10 minutes
TRAIN = ("2023-01-01T00:00:00+00:00", "2023-01-03T00:00:00+00:00")
RANGE = ("2023-01-03T00:00:00+00:00", "2023-01-03T08:00:00+00:00")  # 48 rows
_M = "/gordo/v0/project"
NPZ = {"Accept": wire.NPZ_CONTENT_TYPE}


def _detector(estimator, **kwargs):
    return {"DiffBasedAnomalyDetector": {"base_estimator": {"TransformedTargetRegressor": {
        "regressor": {"Pipeline": {"steps": ["MinMaxScaler", {estimator: kwargs}]}},
        "transformer": "MinMaxScaler"}}}}


MACHINES = {
    "fetch-patchtst": (_detector("PatchTSTAutoEncoder", lookback_window=LOOKBACK,
                                 patch_length=8, stride=4, d_model=16, n_heads=2, n_layers=1,
                                 ff_dim=16, attention_impl="flash", epochs=1, batch_size=64),
                       {"cv_mode": "build_only"}),
    "fetch-dense": (_detector("DenseAutoEncoder", kind="feedforward_hourglass", epochs=2,
                              batch_size=32), {"n_splits": 2}),
}


def data_config(server, start=TRAIN[0], end=TRAIN[1]):
    return {"type": "TimeSeriesDataset", "train_start_date": start, "train_end_date": end,
            "tag_list": TAGS, "resolution": "10min",
            "data_provider": {"type": "InfluxDataProvider", "measurement": "sensor_data",
                              "host": server.host, "port": server.port, "database": "db"}}


def fill_lake(server, seed=0):
    client = MinimalInfluxClient(host=server.host, port=server.port, database="db")
    rng = np.random.default_rng(seed)
    ns = pd.date_range(TRAIN[0], periods=ROWS, freq="10min").as_unit("ns").asi8
    t = np.arange(ROWS)
    for i, tag in enumerate(TAGS):
        values = 10 * i + np.sin(t / 24 + i) + 0.1 * rng.normal(size=ROWS)
        client.write_points([values], ["value"], ns, "sensor_data", tags={"tag": tag})


@pytest.fixture(scope="module")
def lake():
    with InfluxDouble() as server:
        fill_lake(server)
        yield server


@pytest.fixture(scope="module")
def artifacts(lake, tmp_path_factory):
    root = tmp_path_factory.mktemp("fetch")
    dirs = {}
    for name, (config, evaluation) in MACHINES.items():
        model, metadata = ref_build_model(name, config, data_config(lake),
                                          evaluation_config=evaluation)
        dirs[name] = str(root / name)
        ref_dump(model, dirs[name], metadata=metadata)
    # a machine whose metadata names no dataset_config
    bare = str(root / "fetch-bare")
    ref_dump(model, bare, metadata={"dataset": {"tag_list": TAGS}})
    dirs["fetch-bare"] = bare
    return dirs


@pytest.fixture(scope="module")
def servers(artifacts):
    ours = ModelServer(artifacts, device="cpu")
    app = build_app(artifacts, project="project")
    yield ours, Client(app)
    ours.close()
    app.engine.close()


def ask(servers, method, path, body=b"", headers=None):
    """(port status, payload or body), (reference status, payload or body)."""
    ours, theirs = servers
    headers = dict(headers or {})
    mine = ours.handle(method, path, headers, body)
    ref = theirs.open(path, method=method, data=body, headers=headers)
    return _decode(mine.status, mine.content_type, mine.body), \
        _decode(ref.status_code, ref.headers.get("Content-Type"), ref.get_data())


def _decode(status, content_type, body):
    if wire.content_type_of(content_type) == wire.NPZ_CONTENT_TYPE:
        return status, wire.payload_from_npz(body)
    try:
        return status, json.loads(body)
    except ValueError:
        return status, body


def _query(start=RANGE[0], end=RANGE[1]):
    from urllib.parse import urlencode

    return "?" + urlencode({k: v for k, v in (("start", start), ("end", end)) if v})


def assert_same_scores(mine, ref):
    for field in wire.SCORE_FIELDS:
        got = np.asarray(mine["data"][field], np.float32)
        want = np.asarray(ref["data"][field], np.float32)
        assert got.shape == want.shape, field
        if field == "model-input":
            np.testing.assert_array_equal(got, want)
        else:
            scale = max(1.0, float(np.abs(want).max()))
            np.testing.assert_allclose(got, want, rtol=0, atol=SERVE_RTOL * scale, err_msg=field)
    assert mine["data"]["timestamps"] == ref["data"]["timestamps"]
    for key in ("tag-thresholds", "total-threshold"):
        assert mine.get(key) == ref.get(key)


@pytest.mark.parametrize("machine", sorted(MACHINES))
@pytest.mark.parametrize("fmt", ["npz", "json"])
def test_start_end_equals_the_reference(servers, machine, fmt):
    (status, mine), (ref_status, ref) = ask(
        servers, "POST", f"{_M}/{machine}/anomaly/prediction{_query()}",
        headers=NPZ if fmt == "npz" else None)
    assert status == ref_status == 200, (mine, ref)
    assert_same_scores(mine, ref)
    rows = 48 - (LOOKBACK - 1 if machine == "fetch-patchtst" else 0)
    assert len(mine["data"]["total-anomaly-score"]) == rows
    stamps = pd.date_range(RANGE[0], periods=48, freq="10min")[48 - rows:]
    assert mine["data"]["timestamps"] == [t.isoformat() for t in stamps]
    if machine == "fetch-dense":
        assert len(mine["tag-thresholds"]) == len(TAGS)


def test_start_end_on_the_bulk_endpoint_and_the_bare_path(artifacts):
    ours = ModelServer(artifacts["fetch-dense"], device="cpu")
    try:
        bare = ours.handle("POST", f"/anomaly/prediction{_query()}", NPZ, b"")
        bulk = ours.handle("POST", f"/bulk/anomaly/prediction{_query()}", NPZ, b"")
    finally:
        ours.close()
    assert bare.status == bulk.status == 200
    assert bare.body == bulk.body


def test_start_end_without_a_dataset_config_is_422(servers):
    (status, mine), (ref_status, _) = ask(servers, "POST",
                                          f"{_M}/fetch-bare/anomaly/prediction{_query()}")
    assert status == ref_status == 422
    assert "dataset_config" in mine["error"]


@pytest.mark.parametrize("start,end", [(RANGE[0], None), (None, RANGE[1])])
def test_start_end_needs_both_bounds(servers, start, end):
    (status, mine), (ref_status, _) = ask(
        servers, "POST", f"{_M}/fetch-dense/anomaly/prediction{_query(start, end)}")
    assert status == ref_status == 400
    assert "Both ?start and ?end" in mine["error"]


@pytest.mark.parametrize("start,end", [
    ("2024-01-01T00:00:00+00:00", "2024-01-01T06:00:00+00:00"),  # no data there
    ("not-a-date", RANGE[1]),
    (RANGE[1], RANGE[0]),  # end before start
])
def test_a_failed_fetch_is_400(servers, start, end):
    (status, mine), (ref_status, _) = ask(
        servers, "POST", f"{_M}/fetch-dense/anomaly/prediction{_query(start, end)}")
    assert status == ref_status == 400
    assert mine["error"].startswith("Data fetch failed: ")


def test_the_data_fetch_fault_point_is_a_400(servers):
    faults.configure("data-fetch:fetch-dense:error:lake down")
    ref_faults.configure("data-fetch:fetch-dense:error:lake down")
    try:
        (status, mine), (ref_status, ref) = ask(
            servers, "POST", f"{_M}/fetch-dense/anomaly/prediction{_query()}")
        (other, _), _ = ask(servers, "POST", f"{_M}/fetch-patchtst/anomaly/prediction{_query()}",
                            headers=NPZ)
    finally:
        faults.clear()
        ref_faults.clear()
    assert status == ref_status == 400
    assert mine["error"] == ref["error"] and "lake down" in mine["error"]
    assert other == 200


def test_an_expired_deadline_is_refused_before_the_provider(servers, lake):
    queries = sum(r.startswith("GET /query") for r in lake.requests)
    (status, _), (ref_status, _) = ask(servers, "POST",
                                       f"{_M}/fetch-dense/anomaly/prediction{_query()}",
                                       headers={"X-Gordo-Deadline": "0"})
    assert status == ref_status == 504
    assert sum(r.startswith("GET /query") for r in lake.requests) == queries
    ask(servers, "POST", f"{_M}/fetch-dense/anomaly/prediction{_query()}")
    # both servers asked the lake once per tag
    assert sum(r.startswith("GET /query") for r in lake.requests) == queries + 2 * len(TAGS)


def test_the_fetch_is_the_data_fetch_stage(servers):
    ours, _ = servers
    flightrec.RECORDER.set_enabled(True)
    response = ours.handle("POST", f"{_M}/fetch-patchtst/anomaly/prediction{_query()}",
                           {**NPZ, "X-Gordo-Trace-Id": "fe7c4000aa11bb22"}, b"")
    assert response.status == 200
    stages = flightrec.RECORDER.get("fe7c4000aa11bb22").to_dict()["stages_ms"]
    assert {"data_fetch", "admission", "score", "encode"} <= set(stages)


def test_a_body_without_timestamps_answers_as_before(servers):
    """A JSON request's answer is the pre-timestamp body byte for byte:
    the arrays of the npz answer through the same JSON encoder, no
    ``timestamps`` key."""
    ours, _ = servers
    X = np.random.default_rng(3).normal(size=(40, len(TAGS))).astype(np.float32) + 10
    body = json.dumps({"X": X.tolist()}).encode()
    path = f"{_M}/fetch-patchtst/anomaly/prediction"
    as_json = ours.handle("POST", path, {}, body)
    arrays, header = wire.decode_npz(ours.handle("POST", path, NPZ, body).body)
    assert as_json.status == 200 and "timestamps" not in header
    assert as_json.body == wire.encode_scored_json(
        {f: arrays[f] for f in wire.SCORE_FIELDS}, None, header).encode()


def _parquet(frame):
    buffer = io.BytesIO()
    frame.to_parquet(buffer)
    return buffer.getvalue()


def _frame(rows=40, tz="UTC", columns=TAGS, seed=5):
    index = pd.date_range("2023-03-01", periods=rows, freq="10min", tz=tz)
    values = np.random.default_rng(seed).normal(size=(rows, len(columns))).astype(np.float32)
    return pd.DataFrame(values + 10, index=index, columns=columns)


@pytest.mark.parametrize("tz", ["UTC", "Europe/Oslo", None])
@pytest.mark.parametrize("content_type", ["application/x-parquet",
                                          "application/vnd.apache.parquet",
                                          "application/octet-stream"])
def test_parquet_bodies_equal_the_reference(servers, tz, content_type):
    frame = _frame(tz=tz)[list(reversed(TAGS))]  # the file's column order is not the build's
    (status, mine), (ref_status, ref) = ask(
        servers, "POST", f"{_M}/fetch-patchtst/anomaly/prediction", _parquet(frame),
        {**NPZ, "Content-Type": content_type})
    assert status == ref_status == 200, (mine, ref)
    assert_same_scores(mine, ref)
    assert mine["data"]["timestamps"] == [t.isoformat() for t in frame.index[LOOKBACK - 1:]]
    json_body = json.dumps({"X": frame[TAGS].to_numpy().tolist()}).encode()
    (_, plain), _ = ask(servers, "POST", f"{_M}/fetch-patchtst/anomaly/prediction", json_body,
                        NPZ)
    for field in wire.SCORE_FIELDS:
        np.testing.assert_array_equal(mine["data"][field], plain["data"][field])


def test_parquet_without_a_datetime_index_has_no_timestamps(servers):
    frame = _frame().reset_index(drop=True)
    (status, mine), (ref_status, ref) = ask(
        servers, "POST", f"{_M}/fetch-dense/anomaly/prediction", _parquet(frame),
        {**NPZ, "Content-Type": "application/x-parquet"})
    assert status == ref_status == 200
    assert "timestamps" not in mine["data"] and "timestamps" not in ref["data"]


@pytest.mark.parametrize("case", ["missing-tag", "non-numeric", "not-parquet"])
def test_bad_parquet_bodies_are_400(servers, case):
    frame = _frame()
    if case == "missing-tag":
        body, match = _parquet(frame.drop(columns=[TAGS[1]])), "missing tag columns"
    elif case == "non-numeric":
        frame[TAGS[2]] = ["x"] * len(frame)
        body, match = _parquet(frame), "all-numeric"
    else:
        body, match = b"PAR1 but not a table", "not a readable parquet table"
    (status, mine), (ref_status, ref) = ask(
        servers, "POST", f"{_M}/fetch-dense/anomaly/prediction", body,
        {"Content-Type": "application/x-parquet"})
    assert status == ref_status == 400
    assert match in mine["error"] and match in ref["error"]


def test_octet_stream_json_is_still_json(servers):
    X = _frame().to_numpy().tolist()
    (status, _), (ref_status, _) = ask(
        servers, "POST", f"{_M}/fetch-dense/anomaly/prediction",
        json.dumps({"X": X}).encode(), {"Content-Type": "application/octet-stream"})
    assert status == ref_status == 200


def test_parquet_without_pyarrow_is_415_naming_it(servers, monkeypatch):
    ours, _ = servers
    body = _parquet(_frame())
    for name in ("pyarrow", "pyarrow.parquet"):
        monkeypatch.setitem(sys.modules, name, None)
    response = ours.handle("POST", f"{_M}/fetch-dense/anomaly/prediction",
                           {"Content-Type": "application/x-parquet"}, body)
    assert response.status == 415
    assert "'pyarrow'" in json.loads(response.body)["error"]
