"""The load generator against a small stdlib server: the closed and open
loops' records, and a request still out after the grace counted as never
answered, with the time it went out."""

import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import pytest

from harness import loadgen
from harness.readings import Run


class Slow(BaseHTTPRequestHandler):
    protocol_version = "HTTP/1.1"
    delay = 0.01

    def do_POST(self):
        self.rfile.read(int(self.headers["Content-Length"]))
        time.sleep(self.delay)
        self.send_response(200)
        self.send_header("Content-Length", "2")
        self.end_headers()
        self.wfile.write(b"ok")

    def log_message(self, *args):
        pass


@pytest.fixture
def server():
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), Slow)
    thread = threading.Thread(target=httpd.serve_forever, daemon=True)
    thread.start()
    yield httpd.server_address[1]
    httpd.shutdown()
    httpd.server_close()
    thread.join(timeout=10)
    assert not thread.is_alive()


def plan(**kw):
    return {"paths": ["/a", "/b"], "machines": [0, 1], "clients": 2, "threads": 2, **kw}


def test_closed_loop_records_every_request(server):
    t0 = time.monotonic() + 0.05
    records, payload = loadgen.run(plan(order=[0, 1] * 1000, due=None), [b"x", b"y"], server,
                                   t0, 0.3, 5.0)
    assert len(records) > 4 and payload == b"ok" * len(records)
    assert all(r[4] == 200 and t0 <= r[2] < r[3] for r in records)


def test_open_loop_and_a_request_out_past_the_grace(server):
    Slow.delay = 1.5
    try:
        t0 = time.monotonic() + 0.05
        records, _ = loadgen.run(plan(order=[0, 1], due=[0.0, 0.1]), [b"x", b"y"], server,
                                 t0, 0.2, 0.3)
    finally:
        Slow.delay = 0.01
    assert [r[4] for r in records] == [-1, -1]
    assert all(r[2] is not None and r[3] is None for r in records)
    run = Run(cell={}, config={}, traffic={}, t0=t0, t1=t0 + 0.2, setup_s=0.0,
              collected=t0 + 1.0, records=[
                  {"body": r[0], "due": r[1], "sent": r[2], "done": r[3], "status": r[4],
                   "windows": 1} for r in records])
    assert len(run.due_in_window()) == 2 and run.windows_scored() == 0.0
    assert min(run.latency_s(r) for r in run.records) > 1.0
