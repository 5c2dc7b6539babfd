"""The load generator: a child process on the standard library alone, so
that it loads nothing of the program and takes no lock of its process.

Over its standard input it reads a plan (one JSON line) and the bodies'
rows as little-endian int64 thousandths, which it renders as JSON
``{"X": rows}`` while the parent boots the server; it answers ``ready``.
Then it takes commands, one JSON line each, and answers one line each:

- ``{"cmd": "warmup", "port": p, "rounds": [k, ...]}``: for each round, k
  requests at once for k different machines; ``warm {...}``;
- ``{"cmd": "run", "port": p, "t0": t, "seconds": s, "grace": g}``: the
  window, from ``t0`` on ``time.monotonic()`` (the parent's clock too):
  a closed loop of ``clients`` threads that send the plan's order one
  after another until the window closes, or an open loop that sends each
  request when it is due on one of ``threads`` threads. Requests still
  out at the close are waited for ``g`` seconds more. It answers ``done
  <n>`` and n bytes: a JSON list of ``[body, due, sent, done, status,
  size, error]`` per request, a newline, then every response body in
  that order.
"""

import array
import http.client
import json
import queue
import sys
import threading
import time


def render(rows, tags):
    values = [v / 1000 for v in rows]
    return json.dumps({"X": [values[r:r + tags] for r in range(0, len(values), tags)]}).encode()


class Client:
    def __init__(self, port):
        self.port = port
        self.conn = None

    def post(self, path, body):
        """(status, response bytes, error text)."""
        try:
            if self.conn is None:
                self.conn = http.client.HTTPConnection("127.0.0.1", self.port, timeout=300)
            self.conn.request("POST", path, body=body, headers={
                "Content-Type": "application/json", "Accept": "application/x-gordo-npz"})
            resp = self.conn.getresponse()
            data = resp.read()
            if resp.getheader("Connection", "").lower() == "close":
                self.conn.close()
                self.conn = None
            return resp.status, data, ""
        except Exception as exc:  # noqa: BLE001 - any failure is the request's
            if self.conn is not None:
                self.conn.close()
            self.conn = None
            return 0, b"", f"{type(exc).__name__}: {exc}"[:200]


def send(out, line, payload=b""):
    out.write(line.encode() + b"\n" + payload)
    out.flush()


def warmup(plan, bodies, port, rounds):
    statuses = []
    first = {}
    for b, m in enumerate(plan["machines"]):
        first.setdefault(m, b)
    picks = list(first.values())
    for k in rounds:
        results = [None] * k

        def one(j):
            b = picks[j % len(picks)]
            results[j] = Client(port).post(plan["paths"][b], bodies[b])[0]

        threads = [threading.Thread(target=one, args=(j,)) for j in range(k)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        statuses.append(results)
    return statuses


def run(plan, bodies, port, t0, seconds, grace):
    t1 = t0 + seconds
    order, due = plan["order"], plan["due"]
    records = []
    sent_at = {}  # request -> when it went out, for one still out at the end
    lock = threading.Lock()
    cursor = [0]

    def post(client, i, b, due_at):
        sent = sent_at[i] = time.monotonic()
        status, data, error = client.post(plan["paths"][b], bodies[b])
        done = time.monotonic()
        with lock:
            records.append((i, [b, due_at, sent, done, status, len(data), error], data))

    def closed_client():
        client = Client(port)
        while True:
            with lock:
                if time.monotonic() >= t1:
                    return
                i = cursor[0]
                cursor[0] += 1
            post(client, i, order[i], None)

    def open_worker(jobs):
        client = Client(port)
        while True:
            i = jobs.get()
            if i is None:
                return
            post(client, i, order[i], t0 + due[i])

    while time.monotonic() < t0:
        time.sleep(max(0.0, min(0.01, t0 - time.monotonic())))
    if due is None:
        threads = [threading.Thread(target=closed_client, daemon=True)
                   for _ in range(plan["clients"])]
        for t in threads:
            t.start()
    else:
        jobs = queue.Queue()
        threads = [threading.Thread(target=open_worker, args=(jobs,), daemon=True)
                   for _ in range(plan["threads"])]
        for t in threads:
            t.start()
        for i, offset in enumerate(due):
            wait = t0 + offset - time.monotonic()
            if wait > 0:
                time.sleep(wait)
            jobs.put(i)
        for _ in threads:
            jobs.put(None)
    for t in threads:
        t.join(timeout=max(0.0, t1 + grace - time.monotonic()))
    with lock:
        done = sorted(records, key=lambda r: r[0])
        sent = {r[0] for r in done}
        count = cursor[0] if due is None else len(due)
        # a request still out after the grace never came
        missing = [(i, [order[i], None if due is None else t0 + due[i], sent_at.get(i), None,
                        -1, 0, "no answer by the close plus the grace"], b"")
                   for i in range(count) if i not in sent]
    rows = sorted(done + missing, key=lambda r: r[0])
    return [r[1] for r in rows], b"".join(r[2] for r in rows)


def main():
    stdin, stdout = sys.stdin.buffer, sys.stdout.buffer
    plan = json.loads(stdin.readline())
    raws = []
    for n_rows, tags in plan["shapes"]:
        raw = array.array("q")
        raw.frombytes(stdin.read(8 * n_rows * tags))
        if sys.byteorder != "little":
            raw.byteswap()
        raws.append((raw, tags))
    # every byte read before any is rendered: the parent's writes return
    # at once, and it boots the server while this renders
    bodies = [render(raw, tags) for raw, tags in raws]
    del raws
    send(stdout, "ready")
    for line in stdin:
        cmd = json.loads(line)
        if cmd["cmd"] == "warmup":
            send(stdout, "warm " + json.dumps(warmup(plan, bodies, cmd["port"], cmd["rounds"])))
        elif cmd["cmd"] == "run":
            records, payload = run(plan, bodies, cmd["port"], cmd["t0"], cmd["seconds"],
                                   cmd["grace"])
            head = json.dumps(records).encode() + b"\n"
            send(stdout, f"done {len(head) + len(payload)}", head + payload)
        else:
            return


if __name__ == "__main__":
    main()
