"""The port's bulk client (``gordo_components_tpu_torch.client``) on the CPU.

Parity, across the packages: the JAX package's ``Client`` against the
port's server and the port's ``Client`` against the JAX server score the
same range of the same Influx-built artifacts (those of
``tests/test_torch_fetch.py``) with equal arrays (``SERVE_RTOL``, 1e-4 of
each array's magnitude: the two servers' float32 arithmetic), the same
timestamps and thresholds exactly; the forwarders write, from one server's
answers, the reference's CSV bytes and Influx points exactly; and
``make_date_ranges`` gives the reference's chunks to the nanosecond.

Then the contract, against a scripted stub server over real sockets: a 4xx
is permanent, retries run out on a dead server, the breaker trips and
recovers, a 429 honours ``Retry-After`` without opening the circuit, the
tenant, deadline and trace headers are stamped, the trace id reaches the
server's flight recorder per chunk, ``close()`` cancels work in flight, and
``cli client predict`` prints the row counts and exits 1 on failure.
"""

import json
import os
import socket
import threading
import time
from datetime import datetime, timezone
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from types import SimpleNamespace

import numpy as np
import pandas as pd
import pytest

torch = pytest.importorskip("torch")

from werkzeug.serving import make_server as werkzeug_server  # noqa: E402

from gordo_components_tpu.builder import build_model as ref_build_model  # noqa: E402
from gordo_components_tpu.client import Client as RefClient  # noqa: E402
from gordo_components_tpu.client import CsvForwarder as RefCsvForwarder  # noqa: E402
from gordo_components_tpu.client.forwarders import (  # noqa: E402
    ForwardPredictionsIntoInflux as RefInfluxForwarder,
)
from gordo_components_tpu.client.utils import make_date_ranges as ref_make_date_ranges  # noqa: E402,E501
from gordo_components_tpu.dataset.data_provider.influx_client import (  # noqa: E402
    MinimalInfluxClient as RefInfluxClient,
)
from gordo_components_tpu.serializer import dump as ref_dump  # noqa: E402
from gordo_components_tpu.server import build_app  # noqa: E402

from gordo_components_tpu_torch.cli import cli  # noqa: E402
from gordo_components_tpu_torch.client import (  # noqa: E402
    Client,
    ClientError,
    CsvForwarder,
    ForwardPredictionsIntoInflux,
    QuotaExceeded,
    make_date_ranges,
)
from gordo_components_tpu_torch.client import client as client_mod  # noqa: E402
from gordo_components_tpu_torch.observability import flightrec, spans, tracing  # noqa: E402
from gordo_components_tpu_torch.resilience import deadline  # noqa: E402
from gordo_components_tpu_torch.server.server import make_server  # noqa: E402

from influx_double import InfluxDouble  # noqa: E402
from test_torch_fetch import MACHINES, TAGS, data_config, fill_lake  # noqa: E402

pytestmark = pytest.mark.filterwarnings("ignore::ResourceWarning")

SERVE_RTOL = 1e-4
SPAN = ("2023-01-03T00:00:00+00:00", "2023-01-04T00:00:00+00:00")  # 144 rows at 10 minutes


@pytest.fixture(scope="module")
def lake():
    with InfluxDouble() as server:
        fill_lake(server)
        yield server


@pytest.fixture(scope="module")
def artifacts(lake, tmp_path_factory):
    root = tmp_path_factory.mktemp("client")
    dirs = {}
    for name, (config, evaluation) in MACHINES.items():
        model, metadata = ref_build_model(name, config, data_config(lake),
                                          evaluation_config=evaluation)
        dirs[name] = str(root / name)
        ref_dump(model, dirs[name], metadata=metadata)
    return dirs


def _serve(httpd):
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    return thread


@pytest.fixture(scope="module")
def port_url(artifacts):
    httpd = make_server(artifacts, port=0, device="cpu")
    _serve(httpd)
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


@pytest.fixture(scope="module")
def jax_url(artifacts):
    app = build_app(artifacts, project="project")
    httpd = werkzeug_server("127.0.0.1", 0, app, threaded=True)
    _serve(httpd)
    yield f"http://127.0.0.1:{httpd.server_port}"
    httpd.shutdown()
    app.engine.close()


# -- make_date_ranges -------------------------------------------------------

@pytest.mark.parametrize("start,end,interval,ref_interval", [
    ("2023-01-01", "2023-01-03T12:00:00", "1D", "1D"),
    ("2023-01-01T00:00:00+00:00", "2023-01-02T00:00:00+00:00", "12h", "12h"),
    ("2023-01-01T00:00:00+01:00", "2023-01-01T05:00:00+01:00", "2H", "2h"),
    ("2023-01-01", "2023-01-01T01:00:00", "7min", "7min"),
    ("2023-01-01", "2023-01-01T01:00:00", "30T", "30min"),
    ("2023-01-01", "2023-01-01T00:05:00", "90s", "90s"),
    ("2023-01-01", "2023-01-01T00:05:00", "45S", "45s"),
    ("2023-01-01", "2023-01-02", "1.5h", "1.5h"),
    (datetime(2023, 1, 1), datetime(2023, 1, 1, 3, tzinfo=timezone.utc), "1h", "1h"),
])
def test_make_date_ranges_equals_the_reference(start, end, interval, ref_interval):
    ours = make_date_ranges(start, end, interval)
    ref = ref_make_date_ranges(start, end, ref_interval)

    def ns(stamp):
        return int(pd.Timestamp(stamp).as_unit("ns").value)

    assert [(ns(a), ns(b)) for a, b in ours] == [(ns(a), ns(b)) for a, b in ref]
    assert [a.utcoffset() for a, _ in ours] == [a.utcoffset() for a, _ in ref]


@pytest.mark.parametrize("start,end,interval,match", [
    ("2023-01-02", "2023-01-01", "1D", "must be after"),
    ("2023-01-01", "2023-01-01", "1D", "must be after"),
    ("2023-01-01", "2023-01-02", "0s", "positive"),
    ("2023-01-01", "2023-01-02", "1W", "'1W'"),
    ("2023-01-01", "2023-01-02", "soon", "'soon'"),
    ("2023-01-01", "2023-01-02", "h", "'h'"),
])
def test_make_date_ranges_refuses(start, end, interval, match):
    with pytest.raises(ValueError, match=match):
        make_date_ranges(start, end, interval)


# -- parity across the packages --------------------------------------------

def _assert_frames(ours, ref_frame, tags=len(TAGS)):
    """A port ScoredFrame against a reference score DataFrame."""
    assert ours.columns == list(ref_frame.columns)
    assert ours.values.shape == ref_frame.shape == (len(ref_frame), tags + 1)
    np.testing.assert_array_equal(ours.timestamps, ref_frame.index.as_unit("ns").asi8)
    want = ref_frame.to_numpy()
    np.testing.assert_allclose(ours.values, want, rtol=0,
                               atol=SERVE_RTOL * max(1.0, float(np.abs(want).max())))


@pytest.mark.parametrize("machine,interval", [("fetch-dense", "4h"), ("fetch-patchtst", "8h")])
def test_each_client_against_the_other_server(port_url, jax_url, machine, interval):
    """JAX client -> port server, port client -> JAX server, and each
    client against its own server: the four agree. A PatchTST chunk of 48
    rows scores its last 48 - 31."""
    ref_on_port = RefClient(port_url, max_interval=interval).predict(
        *SPAN, machine_names=[machine])[machine]
    ref_on_jax = RefClient(jax_url, max_interval=interval).predict(
        *SPAN, machine_names=[machine])[machine]
    with Client(jax_url, max_interval=interval) as client:
        ours_on_jax = client.predict(*SPAN, machine_names=[machine])[machine]
    with Client(port_url, max_interval=interval) as client:
        ours_on_port = client.predict(*SPAN, machine_names=[machine])[machine]
    rows = 144 if machine == "fetch-dense" else 3 * (48 - 31)
    assert len(ref_on_port) == len(ref_on_jax) == len(ours_on_port) == rows
    _assert_frames(ours_on_jax, ref_on_jax)
    _assert_frames(ours_on_port, ref_on_port)
    _assert_frames(ours_on_port, ref_on_jax)
    assert ours_on_port.model_input.shape == ours_on_port.model_output.shape == (rows, len(TAGS))
    if machine == "fetch-dense":
        np.testing.assert_array_equal(ours_on_jax.tag_thresholds, ours_on_port.tag_thresholds)
        assert ours_on_jax.total_threshold == ours_on_port.total_threshold is not None


def test_a_chunk_shorter_than_the_lookback_is_refused(port_url, jax_url):
    """Four-hour chunks (24 rows) cannot fill a 32-row window: a 400, and so
    a permanent error from either client on either server."""
    for url in (port_url, jax_url):
        with pytest.raises(ClientError, match="HTTP 400"):
            with Client(url, max_interval="4h") as client:
                client.predict(*SPAN, machine_names=["fetch-patchtst"])
        with pytest.raises(Exception, match="HTTP 400"):
            RefClient(url, max_interval="4h").predict(*SPAN, machine_names=["fetch-patchtst"])


def test_machine_discovery_and_npz_vs_json(port_url):
    """The npz and JSON answers decode to the same arrays, to the bit; one
    chunk at a time, so that each dispatches alone both times (a dense
    request's bits depend on its batch mates)."""
    with Client(port_url, max_interval="6h", parallelism=1) as client:
        assert client.resolve_machines() == sorted(MACHINES)
        npz = client.predict(*SPAN, machine_names=["fetch-dense"])["fetch-dense"]
    json_client = Client(port_url, max_interval="6h", parallelism=1)
    plain_headers = json_client._headers
    json_client._headers = lambda: {**plain_headers(), "Accept": "application/json"}
    with json_client:
        as_json = json_client.predict(*SPAN, machine_names=["fetch-dense"])["fetch-dense"]
    for field in ("model_input", "model_output", "tag_anomaly_scores", "total_anomaly_score",
                  "timestamps"):
        np.testing.assert_array_equal(getattr(npz, field), getattr(as_json, field))


@pytest.mark.parametrize("fmt", ["parquet", "json"])
def test_predict_frame_equals_the_reference(port_url, jax_url, fmt):
    index = pd.date_range("2023-03-01", periods=40, freq="10min", tz="UTC")
    X = (np.random.default_rng(1).normal(size=(40, len(TAGS))) + 10).astype(np.float32)
    frame = pd.DataFrame(X, index=index, columns=TAGS)
    ref = RefClient(jax_url).predict_frame("fetch-patchtst", frame, fmt=fmt)
    with Client(port_url) as client:
        ours = client.predict_frame("fetch-patchtst", X, columns=TAGS,
                                    timestamps=index.as_unit("ns").asi8, fmt=fmt)
    assert len(ours) == len(ref) == 40 - 31
    np.testing.assert_allclose(ours.values, ref.to_numpy(), rtol=0,
                               atol=SERVE_RTOL * max(1.0, float(np.abs(ref.to_numpy()).max())))
    if fmt == "parquet":
        np.testing.assert_array_equal(ours.timestamps, ref.index.as_unit("ns").asi8)
    else:
        assert ours.timestamps is None


def test_forwarders_write_what_the_reference_writes(jax_url, tmp_path):
    """One server's answers through both packages' clients and forwarders:
    the CSVs byte for byte, the Influx points value for value (one chunk at
    a time, so that every answer is a lone dispatch's, the same bits)."""
    with InfluxDouble() as sink:
        config = dict(host=sink.host, port=sink.port, database="db")
        ref_client = RefClient(jax_url, max_interval="4h", parallelism=1, forwarders=[
            RefCsvForwarder(str(tmp_path / "ref")), RefInfluxForwarder("ref", **config)])
        ref_client.predict(*SPAN, machine_names=["fetch-dense"])
        ref_client.close()
        with Client(jax_url, max_interval="4h", parallelism=1, forwarders=[
                CsvForwarder(str(tmp_path / "ours")),
                ForwardPredictionsIntoInflux("ours", **config)]) as client:
            # twice, as the reference: the second call appends below the one header
            client.predict(*SPAN, machine_names=["fetch-dense"])
            client.predict(*SPAN, machine_names=["fetch-dense"])
        ref_client.predict(*SPAN, machine_names=["fetch-dense"])
        ref_client.close()
        reader = RefInfluxClient(**config)
        ref_points = reader.query('SELECT * FROM "ref"')["ref"]
        our_points = reader.query('SELECT * FROM "ours"')["ours"]
    ours = (tmp_path / "ours" / "fetch-dense.csv").read_bytes()
    ref = (tmp_path / "ref" / "fetch-dense.csv").read_bytes()
    assert ours == ref
    assert ours.count(b"total-anomaly-score") == 1 and len(ours.splitlines()) == 1 + 2 * 144
    pd.testing.assert_frame_equal(pd.read_csv(tmp_path / "ours" / "fetch-dense.csv",
                                              index_col=0),
                                  pd.read_csv(tmp_path / "ref" / "fetch-dense.csv", index_col=0))
    pd.testing.assert_frame_equal(our_points, ref_points)
    assert len(our_points) == 2 * 144 and set(our_points.columns) == {
        "tag-anomaly-score-0", "tag-anomaly-score-1", "tag-anomaly-score-2",
        "total-anomaly-score"}


# -- the contract, on a stub ------------------------------------------------

def _score_body():
    return json.dumps({"data": {"model-input": [[1.0, 2.0]], "model-output": [[1.0, 2.0]],
                                "tag-anomaly-scores": [[0.5, 0.25]],
                                "total-anomaly-score": [0.56]}}).encode()


class Stub:
    """A scripted HTTP server: each request takes the next ``(status,
    headers)`` of ``script`` (200 with a one-row score once it runs out)
    and is recorded with its headers."""

    def __init__(self, script=()):
        self.script = list(script)
        self.seen = []
        stub = self

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, *args):
                pass

            def do_POST(self):
                length = int(self.headers.get("Content-Length") or 0)
                self.rfile.read(length)
                stub.seen.append((self.path, dict(self.headers)))
                status, headers = stub.script.pop(0) if stub.script else (200, {})
                body = _score_body() if status == 200 else b'{"error": "scripted"}'
                self.send_response(status)
                for key, value in {"Content-Type": "application/json",
                                   "Content-Length": str(len(body)), **headers}.items():
                    self.send_header(key, value)
                self.end_headers()
                self.wfile.write(body)

        self.httpd = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
        self.httpd.daemon_threads = True
        _serve(self.httpd)
        self.url = f"http://127.0.0.1:{self.httpd.server_address[1]}"

    def close(self):
        self.httpd.shutdown()
        self.httpd.server_close()


@pytest.fixture
def stub():
    servers = []

    def make(script=()):
        servers.append(Stub(script))
        return servers[-1]

    yield make
    for server in servers:
        server.close()


@pytest.fixture
def slept(monkeypatch):
    """The client's sleeps, recorded instead of slept."""
    record = []
    monkeypatch.setattr(client_mod, "time", SimpleNamespace(
        monotonic=time.monotonic, sleep=record.append))
    return record


HOUR = ("2023-02-01T00:00:00+00:00", "2023-02-01T01:00:00+00:00")


def test_a_4xx_is_permanent_and_never_trips_the_circuit(stub, port_url):
    with Client(port_url, retries=2) as client:
        with pytest.raises(ClientError, match="HTTP 404"):
            client.predict(*HOUR, machine_names=["no-such"])
    server = stub([(400, {})] * 5)
    with Client(server.url, retries=3) as client:
        for _ in range(5):
            with pytest.raises(ClientError, match="HTTP 400"):
                client.predict(*HOUR, machine_names=["m"])
        assert client._breaker().state == "closed"
    assert len(server.seen) == 5  # one attempt each


def test_retries_run_out_on_a_dead_server():
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    with Client(f"http://127.0.0.1:{port}", retries=1, retry_backoff=0.01, timeout=2) as client:
        with pytest.raises(ClientError, match="retries exhausted"):
            client.predict(*HOUR, machine_names=["m"])


def test_the_breaker_trips_and_recovers(stub, slept):
    server = stub([(500, {})] * 3)
    with Client(server.url, retries=5, retry_backoff=0.001, breaker_recovery=0.2) as client:
        with pytest.raises(ClientError, match="circuit open"):
            client.predict(*HOUR, machine_names=["m"])
        assert len(server.seen) == 3 and client._breaker().state == "open"
        with pytest.raises(ClientError, match="circuit open"):
            client.predict(*HOUR, machine_names=["m"])
        assert len(server.seen) == 3  # failed fast: no request
        time.sleep(0.25)  # the recovery window: one probe goes through
        frames = client.predict(*HOUR, machine_names=["m"])
        assert len(frames["m"]) == 1 and client._breaker().state == "closed"


@pytest.mark.parametrize("status,headers,closed", [
    (504, {}, True),                      # our deadline: an answer
    (503, {"Retry-After": "1"}, True),    # a shed with a hint: an answer
    (503, {"X-Gordo-Draining": "1"}, True),
    (502, {}, False),                     # a dead proxy
])
def test_which_5xx_count_against_the_breaker(stub, slept, status, headers, closed):
    server = stub([(status, headers)] * 4)
    with Client(server.url, retries=3, retry_backoff=0.001) as client:
        try:
            client.predict(*HOUR, machine_names=["m"])
        except ClientError:
            pass
        assert (client._breaker().state == "closed") == closed


def test_a_429_honours_retry_after_without_opening_the_circuit(stub, slept):
    server = stub([(429, {"Retry-After": "3"})])
    with Client(server.url, retries=3, retry_backoff=0.001, tenant="metered") as client:
        frames = client.predict(*HOUR, machine_names=["m"])
        assert len(frames["m"]) == 1
        assert slept and slept[0] >= 3.0
        assert client._breaker().state == "closed"
        # the tenant is still inside its window (the sleeps were recorded,
        # not slept): the next call is refused without a request
        seen = len(server.seen)
        with pytest.raises(QuotaExceeded) as exc:
            client.predict(*HOUR, machine_names=["m"])
        assert exc.value.tenant == "metered" and len(server.seen) == seen
    quota_only = stub([(429, {"Retry-After": "1"})] * 3)
    with Client(quota_only.url, retries=2, retry_backoff=0.001) as client:
        with pytest.raises(QuotaExceeded):
            client.predict(*HOUR, machine_names=["m"])
        assert client._breaker().state == "closed"


def test_retry_budget_caps_the_backoff(stub, slept):
    server = stub([(503, {"Retry-After": "60"})] * 3)
    with Client(server.url, retries=5, retry_backoff=0.001, retry_budget=0.5) as client:
        with pytest.raises(ClientError, match="budget"):
            client.predict(*HOUR, machine_names=["m"])
    assert slept == [] and len(server.seen) == 1


def test_tenant_deadline_and_trace_headers_are_stamped(stub, slept):
    server = stub([(503, {})])
    with Client(server.url, retries=2, retry_backoff=0.001, tenant="ops") as client:
        with deadline.deadline_scope(12.0):
            client.predict(*HOUR, machine_names=["m"])
    (path1, first), (path2, second) = server.seen
    assert path1 == path2 and "start=2023-02-01T00%3A00%3A00%2B00%3A00" in path1
    for headers in (first, second):
        assert headers["X-Gordo-Tenant"] == "ops"
        assert 10.0 < float(headers["X-Gordo-Deadline"]) <= 12.0
        assert "application/x-gordo-npz" in headers["Accept"]
    assert first["X-Gordo-Trace-Id"] == second["X-Gordo-Trace-Id"]
    assert float(second["X-Gordo-Deadline"]) <= float(first["X-Gordo-Deadline"])


def test_the_trace_reaches_the_server_per_chunk(port_url):
    """A caller's trace id rides every chunk (the server's flight recorder,
    shared in this process, holds one anomaly timeline per chunk), the
    chunk_fetch and decode stages land in the caller's timeline, and a bare
    predict mints one id for all its chunks."""
    flightrec.RECORDER.set_enabled(True)
    trace_id = "c11e47000aa1bb2c"
    with tracing.trace(trace_id):
        timeline, token = spans.begin(trace_id)
        try:
            with Client(port_url, max_interval="6h") as client:
                client.predict(*SPAN, machine_names=["fetch-dense"])
        finally:
            spans.end(token)
    rows = flightrec.RECORDER.summaries(limit=200)["requests"]
    assert len([r for r in rows if r["trace_id"] == trace_id
                and r.get("endpoint") == "anomaly"]) == 4
    names = [s.name for s in timeline.spans]
    assert names.count("chunk_fetch") == names.count("decode") == 4
    assert all(s.thread.startswith("gordo-client-io") for s in timeline.spans
               if s.name == "chunk_fetch")
    with Client(port_url, max_interval="4h") as client:
        client.predict(*SPAN, machine_names=["fetch-dense"])
    rows = flightrec.RECORDER.summaries(limit=200)["requests"]
    minted = next(r for r in rows if r.get("kind") == "client.predict")["trace_id"]
    assert len([r for r in rows if r["trace_id"] == minted
                and r.get("endpoint") == "anomaly"]) == 6


def test_close_cancels_work_in_flight():
    srv = socket.socket()
    srv.bind(("127.0.0.1", 0))
    srv.listen(8)
    conns = []

    def sink():  # accept, never answer
        while True:
            try:
                conn, _ = srv.accept()
            except OSError:
                return
            conns.append(conn)

    threading.Thread(target=sink, daemon=True).start()
    client = Client(f"http://127.0.0.1:{srv.getsockname()[1]}", timeout=30, retries=0,
                    parallelism=1, max_interval="1h")
    outcome = {}

    def call():
        try:
            client.predict("2023-02-01", "2023-02-01T06:00:00", machine_names=["m"])
            outcome["result"] = "returned"
        except BaseException as exc:  # noqa: BLE001 - the outcome is the assertion
            outcome["result"] = exc

    thread = threading.Thread(target=call)
    thread.start()
    time.sleep(1.0)  # the first chunk parks on the silent socket, five wait
    try:
        started = time.monotonic()
        client.close()
        thread.join(timeout=15)
        assert not thread.is_alive(), "predict() hung after close()"
        assert isinstance(outcome["result"], ClientError)
        assert time.monotonic() - started < 10
        client.close()  # idempotent
    finally:
        srv.close()
        for conn in conns:
            conn.close()


def test_cli_client_predict(port_url, tmp_path, capsys):
    out = tmp_path / "scores"
    code = cli.main(["client", "predict", *SPAN, "--base-url", port_url,
                     "--machine", "fetch-dense", "--max-interval", "4h", "--output-dir",
                     str(out)])
    assert code == 0
    assert json.loads(capsys.readouterr().out) == {"fetch-dense": 144}
    assert os.listdir(out) == ["fetch-dense.csv"]
    sock = socket.socket()
    sock.bind(("127.0.0.1", 0))
    port = sock.getsockname()[1]
    sock.close()
    assert cli.main(["client", "predict", *HOUR, "--base-url", f"http://127.0.0.1:{port}",
                     "--machine", "m"]) == 1
    assert capsys.readouterr().out == ""
    with pytest.raises(SystemExit) as exc:
        cli.main(["client", "predict", *HOUR])  # no --base-url
    assert exc.value.code == 2
