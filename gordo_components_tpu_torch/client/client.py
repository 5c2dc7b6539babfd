"""The bulk prediction client (the port's copy of
``gordo_components_tpu/client/client.py:60-829``).

``Client.predict(start, end)`` resolves the machines (``/models`` unless
given), splits ``[start, end)`` into ``max_interval`` chunks
(:func:`~.utils.make_date_ranges`), asks ``POST …/<machine>/anomaly/
prediction?start=…&end=…`` per machine and chunk, ``parallelism`` at a
time, joins each machine's chunks into a :class:`ScoredFrame` and hands
the frames to the forwarders. The server fetches and scores the rows.

The contract is the reference's:

- a 4xx is permanent (:class:`ClientError` at once); a 5xx and a
  connection error or timeout are retried with jittered exponential
  backoff, at least a server's ``Retry-After``, within ``retries`` and
  the call's ``retry_budget`` (and any deadline bound on the caller); a
  503 from a draining worker (``X-Gordo-Draining``) is retried at once;
- one circuit breaker per base URL (:mod:`..resilience.breaker`), shared
  by every chunk: a dead server trips it after a few failures and the
  remaining chunks fail at once. A 504, a 503 with ``Retry-After`` and a
  4xx are answers of a live server and do not count against it;
- a 429 is this tenant's quota, not a failure: it never opens the circuit;
  the tenant backs off ``Retry-After`` (the gate is the client's, apart
  from the breaker) and a call started inside that window raises
  :class:`QuotaExceeded` at once, as does a call whose retries all met 429;
- every request names the tenant (``X-Gordo-Tenant``), carries the
  caller's remaining deadline (``X-Gordo-Deadline``, re-stamped per
  attempt) and the trace id (``X-Gordo-Trace-Id``: the caller's, else one
  minted per ``predict`` and shared by its chunks), and asks for the npz
  wire format with JSON as the fallback the server may choose;
  ``chunk_fetch`` and ``decode`` stages land in the caller's timeline (one
  is begun per ``predict`` and kept in the flight recorder when the caller
  has none).

Where the port differs, by design: the reference runs aiohttp on a
background event loop (and ``requests`` for ``predict_frame``); the port
uses ``http.client`` with one kept-alive connection per worker thread of a
``ThreadPoolExecutor(parallelism)``, each chunk run in a copy of the
caller's context. :meth:`Client.close` cancels the chunks that have not
started, aborts the connections in flight, and ``predict`` then raises
:class:`ClientError`; a closed client makes a fresh pool on its next call.
The reference's ``lockcheck.named_lock`` is a plain ``threading.Lock``.
``predict`` returns ``{machine: ScoredFrame}`` rather than DataFrames.
"""

from __future__ import annotations

import contextvars
import http.client
import json
import logging
import random
import socket
import threading
import time
import urllib.parse
from concurrent.futures import CancelledError, ThreadPoolExecutor
from dataclasses import dataclass
from datetime import datetime
from typing import Any, Dict, List, Optional, Sequence, Tuple, Union

import numpy as np

from .. import wire
from ..analysis import lockcheck
from ..dataset.data_provider.providers import utc_ns
from ..observability import flightrec, spans, tracing
from ..observability.registry import REGISTRY
from ..resilience import deadline, qos
from ..resilience.admission import DRAINING_HEADER
from ..resilience.breaker import BreakerBoard
from .forwarders import PredictionForwarder
from .utils import make_date_ranges

logger = logging.getLogger(__name__)

_M_RETRIES = REGISTRY.counter(
    "gordo_client_retries_total",
    "Client request retries, by cause (timeout / connection / http_5xx / "
    "bad_body) — the client-side flakiness signal",
    labels=("reason",),
)
_M_REQUESTS = REGISTRY.counter(
    "gordo_client_requests_total",
    "Client requests by terminal outcome (ok / permanent_4xx / exhausted "
    "/ circuit_open / budget_exhausted / quota_blocked / quota_exhausted)",
    labels=("outcome",),
)

_QUOTA_ERROR = "HTTP 429 (quota)"


class ClientError(RuntimeError):
    """A request failed permanently (4xx, or retries exhausted)."""


class QuotaExceeded(ClientError):
    """HTTP 429: this tenant's token bucket is empty. The server is
    healthy (a 429 never counts against the breaker): slow down for
    ``retry_after`` seconds or raise the tenant's quota."""

    def __init__(self, message: str, retry_after: float = 1.0,
                 tenant: str = qos.DEFAULT_TENANT):
        super().__init__(message)
        self.retry_after = retry_after
        self.tenant = tenant


@dataclass
class ScoredFrame:
    """One machine's scores over a range: the four arrays of the response
    (``model_input``, ``model_output``, ``tag_anomaly_scores``,
    ``total_anomaly_score``), the rows' ``timestamps`` (int64 UTC ns, or
    ``None`` when the server sent none) and the machine's thresholds.
    :attr:`columns` and :attr:`values` are the reference's score frame:
    ``tag-anomaly-score-<i>`` per tag and ``total-anomaly-score``, float64."""

    model_input: np.ndarray
    model_output: np.ndarray
    tag_anomaly_scores: np.ndarray
    total_anomaly_score: np.ndarray
    timestamps: Optional[np.ndarray]
    tag_thresholds: Optional[np.ndarray]
    total_threshold: Optional[float]

    def __len__(self) -> int:
        return len(self.total_anomaly_score)

    @property
    def columns(self) -> List[str]:
        n_tags = self.tag_anomaly_scores.shape[1] if self.tag_anomaly_scores.ndim == 2 else 0
        return [f"tag-anomaly-score-{i}" for i in range(n_tags)] + ["total-anomaly-score"]

    @property
    def values(self) -> np.ndarray:
        scores = np.asarray(self.tag_anomaly_scores, dtype=np.float64)
        if scores.ndim != 2:
            scores = scores.reshape(len(self), 0)
        total = np.asarray(self.total_anomaly_score, dtype=np.float64)
        return np.concatenate([scores, total[:, None]], axis=1)

    @classmethod
    def from_payload(cls, payload: Dict[str, Any]) -> Optional["ScoredFrame"]:
        """A response payload (JSON, or npz through
        ``wire.payload_from_npz``) as a frame; ``None`` when it scored no
        rows."""
        data = payload.get("data", {})
        total = data.get("total-anomaly-score")
        if total is None or len(total) == 0:
            return None
        arrays = [np.asarray(data[name], dtype=np.float32) for name in wire.SCORE_FIELDS]
        thresholds = payload.get("tag-thresholds")
        return cls(
            *arrays,
            timestamps=utc_ns(data["timestamps"]) if "timestamps" in data else None,
            tag_thresholds=None if thresholds is None else np.asarray(thresholds, np.float32),
            total_threshold=payload.get("total-threshold"),
        )

    @classmethod
    def concat(cls, frames: Sequence["ScoredFrame"]) -> Optional["ScoredFrame"]:
        """Chunks joined and sorted by timestamp (stable), as the
        reference's ``pd.concat(...).sort_index()`` orders them."""
        if not frames:
            return None
        fields = [np.concatenate([getattr(f, name) for f in frames])
                  for name in ("model_input", "model_output", "tag_anomaly_scores",
                               "total_anomaly_score")]
        timestamps = None
        if all(f.timestamps is not None for f in frames):
            timestamps = np.concatenate([f.timestamps for f in frames])
            order = np.argsort(timestamps, kind="stable")
            fields = [a[order] for a in fields]
            timestamps = timestamps[order]
        return cls(*fields, timestamps=timestamps, tag_thresholds=frames[0].tag_thresholds,
                   total_threshold=frames[0].total_threshold)


class _Reply:
    __slots__ = ("status", "headers", "body")

    def __init__(self, status: int, headers: Dict[str, str], body: bytes):
        self.status, self.headers, self.body = status, headers, body


class Client:
    """Bulk scoring against a port or reference server at ``base_url``.

    ``retry_budget``: a cap in seconds on one call's retries and backoff
    (a deadline bound on the caller tightens it). ``breaker_recovery``:
    seconds an endpoint's circuit stays open before one probe tests it.
    ``tenant``: the principal stamped on every request as
    ``X-Gordo-Tenant`` (``None`` rides as the server's default tenant).
    """

    def __init__(
        self,
        base_url: str,
        project: str = "project",
        machines: Optional[Sequence[str]] = None,
        max_interval: str = "1D",
        parallelism: int = 10,
        retries: int = 3,
        retry_backoff: float = 0.5,
        timeout: float = 60.0,
        retry_budget: Optional[float] = None,
        breaker_recovery: float = 30.0,
        forwarders: Optional[List[PredictionForwarder]] = None,
        tenant: Optional[str] = None,
    ):
        self.base_url = base_url.rstrip("/")
        parsed = urllib.parse.urlsplit(self.base_url)
        if parsed.scheme not in ("http", "https") or not parsed.hostname:
            raise ValueError(f"base_url must be http(s)://host[:port][/prefix], not {base_url!r}")
        self._scheme, self._host, self._port = parsed.scheme, parsed.hostname, parsed.port
        self._prefix = parsed.path
        self.project = project
        self.machines = list(machines) if machines else None
        self.max_interval = max_interval
        self.parallelism = parallelism
        self.retries = retries
        self.retry_backoff = retry_backoff
        self.timeout = timeout
        self.retry_budget = retry_budget
        # ONE circuit per base URL, shared by every chunk this client asks
        self._breakers = BreakerBoard(recovery_time=breaker_recovery)
        self.tenant = tenant
        # per-tenant quota backoff, apart from the breaker: a 429 is a live
        # server saying no to this principal. Values are monotonic "clear
        # at" times; dict get/set are atomic and the worst race is one
        # extra request, so no lock
        self._quota_until: Dict[str, float] = {}
        self.forwarders = forwarders or []
        # the worker pool and every connection it holds, released by close()
        self._io_lock = lockcheck.named_lock("client.io")
        self._pool: Optional[ThreadPoolExecutor] = None
        self._epoch = 0  # bumped by close(): work of an older epoch aborts
        self._local = threading.local()
        self._connections: set = set()

    # -- pooled I/O ----------------------------------------------------------
    def _executor(self) -> Tuple[ThreadPoolExecutor, int]:
        with self._io_lock:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(self.parallelism,
                                                thread_name_prefix="gordo-client-io")
            return self._pool, self._epoch

    def _connection(self) -> http.client.HTTPConnection:
        """This thread's kept-alive connection (made on first use)."""
        conn = getattr(self._local, "conn", None)
        if conn is None or getattr(self._local, "epoch", None) != self._epoch:
            cls = (http.client.HTTPSConnection if self._scheme == "https"
                   else http.client.HTTPConnection)
            conn = cls(self._host, self._port, timeout=self.timeout)
            with self._io_lock:
                self._connections.add(conn)
            self._local.conn, self._local.epoch = conn, self._epoch
        return conn

    def _drop_connection(self, conn: http.client.HTTPConnection) -> None:
        conn.close()
        with self._io_lock:
            self._connections.discard(conn)
        if getattr(self._local, "conn", None) is conn:
            self._local.conn = None

    def close(self) -> None:
        """Cancel the chunks that have not started, abort the requests in
        flight (their ``predict`` raises :class:`ClientError`) and release
        the pool. Idempotent; the next call makes a fresh pool."""
        with self._io_lock:
            pool, self._pool = self._pool, None
            connections, self._connections = self._connections, set()
            self._epoch += 1
        if pool is not None:
            pool.shutdown(wait=False, cancel_futures=True)
        for conn in connections:
            sock = conn.sock
            if sock is not None:
                try:
                    sock.shutdown(socket.SHUT_RDWR)  # wakes a thread blocked in recv
                except OSError:
                    pass
            conn.close()

    def __enter__(self) -> "Client":
        return self

    def __exit__(self, *exc_info) -> None:
        self.close()

    def _request(self, method: str, path: str, headers: Dict[str, str],
                 body: Optional[bytes] = None) -> _Reply:
        """One HTTP exchange on this thread's connection; a failed one is
        dropped, so the next attempt reconnects."""
        conn = self._connection()
        try:
            conn.request(method, self._prefix + path, body=body, headers=headers)
            response = conn.getresponse()
            reply = _Reply(response.status, {k.lower(): v for k, v in response.getheaders()},
                           response.read())
        except BaseException:
            self._drop_connection(conn)
            raise
        if reply.headers.get("connection", "").lower() == "close":
            self._drop_connection(conn)
        return reply

    # -- retries ---------------------------------------------------------------
    def _backoff_delay(self, attempt: int) -> float:
        """Exponential backoff with ±50 % jitter, so chunks that failed on
        one hiccup do not return in one wave."""
        return self.retry_backoff * 2 ** (attempt - 1) * random.uniform(0.5, 1.5)

    def _breaker(self):
        return self._breakers.get(self.base_url)

    def _budget_left(self, started: float) -> Optional[float]:
        """Seconds left of the call's retry budget and the caller's
        deadline, the tighter; ``None`` when neither binds."""
        candidates = []
        if self.retry_budget is not None:
            candidates.append(self.retry_budget - (time.monotonic() - started))
        bound = deadline.remaining()
        if bound is not None:
            candidates.append(bound)
        return min(candidates) if candidates else None

    def _retry_delay(self, attempt: int, started: float,
                     retry_after: Optional[float] = None) -> Optional[float]:
        """The wait before retry ``attempt`` (at least a server's
        ``Retry-After``; at most 50 ms when it is 0, a draining worker's
        shed), or ``None`` when the budget cannot cover it."""
        delay = self._backoff_delay(attempt)
        if retry_after is not None:
            delay = min(delay, 0.05) if retry_after <= 0 else max(delay, retry_after)
        left = self._budget_left(started)
        if left is not None and delay >= left:
            return None
        return delay

    @staticmethod
    def _parse_retry_after(value: Optional[str]) -> Optional[float]:
        """``Retry-After`` in seconds; an HTTP date or garbage forfeits it."""
        if not value:
            return None
        try:
            return max(0.0, float(value))
        except (TypeError, ValueError):
            return None

    def _headers(self) -> Dict[str, str]:
        headers = {
            tracing.TRACE_HEADER: tracing.current_or_new(),
            "Accept": f"{wire.NPZ_CONTENT_TYPE}, application/json",
        }
        budget = deadline.header_value()
        if budget is not None:
            headers[deadline.DEADLINE_HEADER] = budget
        if self.tenant:
            headers[qos.TENANT_HEADER] = self.tenant
        return headers

    def _quota_key(self) -> str:
        return self.tenant or qos.DEFAULT_TENANT

    def _quota_blocked(self) -> Optional[float]:
        remaining = self._quota_until.get(self._quota_key(), 0.0) - time.monotonic()
        return remaining if remaining > 0 else None

    def _note_quota(self, retry_after: Optional[float]) -> float:
        wait = retry_after if retry_after and retry_after > 0 else 1.0
        key = self._quota_key()
        self._quota_until[key] = max(self._quota_until.get(key, 0.0), time.monotonic() + wait)
        return wait

    def _check_quota_gate(self, what: str) -> None:
        blocked = self._quota_blocked()
        if blocked is not None:
            _M_REQUESTS.labels("quota_blocked").inc()
            raise QuotaExceeded(f"{what}: tenant {self._quota_key()!r} backing off "
                                f"{blocked:.2f}s after HTTP 429", retry_after=blocked,
                                tenant=self._quota_key())

    def _exhausted_error(self, message: str, last_error: Optional[str],
                         retry_after: Optional[float]) -> ClientError:
        if last_error == _QUOTA_ERROR:
            return QuotaExceeded(message, retry_after=retry_after or 1.0, tenant=self._quota_key())
        return ClientError(message)

    def _call(self, what: str, machine: str, path: str, body: Optional[bytes] = None,
              content_type: Optional[str] = None, epoch: Optional[int] = None) -> Dict[str, Any]:
        """POST ``path`` under the retry, breaker and quota contract; the
        decoded payload."""
        headers = self._headers()
        if content_type:
            headers["Content-Type"] = content_type
        breaker = self._breaker()
        self._check_quota_gate(what)
        started = time.monotonic()
        last_error: Optional[str] = None
        retry_after: Optional[float] = None
        for attempt in range(self.retries + 1):
            if attempt:
                delay = self._retry_delay(attempt, started, retry_after)
                if delay is None:
                    _M_REQUESTS.labels("budget_exhausted").inc()
                    raise self._exhausted_error(f"{what}: retry budget exhausted ({last_error})",
                                                last_error, retry_after)
                time.sleep(delay)
                budget = deadline.header_value()  # the REMAINING budget, per attempt
                if budget is not None:
                    headers[deadline.DEADLINE_HEADER] = budget
            retry_after = None
            if epoch is not None and epoch != self._epoch:
                raise ClientError(f"{what}: the client was closed")
            if not breaker.allow():
                _M_REQUESTS.labels("circuit_open").inc()
                spans.event("circuit_open", base_url=self.base_url, machine=machine)
                raise ClientError(f"{what}: circuit open for {self.base_url} "
                                  f"({last_error or 'recent failures'})")
            try:
                with spans.stage("chunk_fetch", machine=machine, attempt=attempt):
                    reply = self._request("POST", path, headers, body)
            except (socket.timeout, TimeoutError) as exc:
                breaker.record(False)
                last_error = repr(exc)
                _M_RETRIES.labels("timeout").inc()
                continue
            except (OSError, http.client.HTTPException) as exc:
                if epoch is not None and epoch != self._epoch:
                    raise ClientError(f"{what}: the client was closed") from None
                breaker.record(False)
                last_error = repr(exc)
                _M_RETRIES.labels("connection").inc()
                continue
            status = reply.status
            if status == 429:
                # quota: a live server saying no to this principal
                breaker.record(True)
                retry_after = self._note_quota(self._parse_retry_after(
                    reply.headers.get("retry-after")))
                last_error = _QUOTA_ERROR
                _M_RETRIES.labels("quota").inc()
                continue
            if 400 <= status < 500:
                breaker.record(True)  # alive: the request is bad
                _M_REQUESTS.labels("permanent_4xx").inc()
                raise ClientError(f"{what}: HTTP {status}: "
                                  f"{reply.body.decode('utf-8', 'replace')[:500]}")
            if status >= 500:
                hint = self._parse_retry_after(reply.headers.get("retry-after"))
                if status == 503 and reply.headers.get(DRAINING_HEADER.lower()):
                    # a draining worker's shed: alive, and momentary
                    breaker.record(True)
                    retry_after = 0.0
                    last_error = "HTTP 503 (draining)"
                    _M_RETRIES.labels("draining").inc()
                    continue
                # a 504 (our deadline) and a 503 with a hint are a live
                # server's flow control; a bare 5xx counts against it
                breaker.record(status == 504 or (status == 503 and hint is not None))
                retry_after = hint
                last_error = f"HTTP {status}"
                _M_RETRIES.labels("http_5xx").inc()
                continue
            ctype = wire.content_type_of(reply.headers.get("content-type"))
            try:
                if ctype == wire.NPZ_CONTENT_TYPE:
                    with spans.stage("decode", format="npz"):
                        payload = wire.payload_from_npz(reply.body)
                else:
                    with spans.stage("decode", format="json"):
                        payload = json.loads(reply.body)
            except ValueError:  # a 2xx with an undecodable body (a broken proxy)
                breaker.record(False)
                last_error = f"2xx response with undecodable body ({ctype})"
                _M_RETRIES.labels("bad_body").inc()
                continue
            breaker.record(True)
            _M_REQUESTS.labels("ok").inc()
            return payload
        _M_REQUESTS.labels("quota_exhausted" if last_error == _QUOTA_ERROR else "exhausted").inc()
        raise self._exhausted_error(f"{what}: retries exhausted ({last_error})", last_error,
                                    retry_after)

    # -- machines --------------------------------------------------------------
    def resolve_machines(self) -> List[str]:
        """The explicit machine list, else the server's ``/models``."""
        if self.machines is not None:
            return self.machines
        reply = self._request("GET", "/models", {"Accept": "application/json"})
        if reply.status != 200:
            raise ClientError(f"GET /models: HTTP {reply.status}")
        return json.loads(reply.body)["models"]

    def _anomaly_path(self, machine: str) -> str:
        return f"/gordo/v0/{self.project}/{machine}/anomaly/prediction"

    # -- scoring ---------------------------------------------------------------
    def _fetch_chunk(self, machine: str, start: datetime, end: datetime,
                     epoch: int) -> Optional[ScoredFrame]:
        query = urllib.parse.urlencode({"start": start.isoformat(), "end": end.isoformat()})
        # one trace id per chunk request (the caller's or the predict's):
        # the server echoes it and stamps its log records with it
        with tracing.trace(tracing.current_or_new()):
            payload = self._call(f"{machine} [{start}, {end})", machine,
                                 f"{self._anomaly_path(machine)}?{query}", body=b"",
                                 epoch=epoch)
        return ScoredFrame.from_payload(payload)

    def predict(
        self,
        start: Union[str, datetime],
        end: Union[str, datetime],
        machine_names: Optional[Sequence[str]] = None,
    ) -> Dict[str, Optional[ScoredFrame]]:
        """Score ``[start, end)`` for every machine: ``{machine:
        ScoredFrame}`` (``None`` for a machine that scored no rows), each
        also handed to the forwarders. The first failed chunk raises once
        every chunk has finished."""
        machines = list(machine_names) if machine_names else self.resolve_machines()
        ranges = make_date_ranges(start, end, self.max_interval)
        logger.info("Client.predict: %d machines x %d chunks", len(machines), len(ranges))
        ctx = spans.capture()
        own_timeline = own_token = own_trace_token = None
        if ctx.timeline is None and flightrec.RECORDER.enabled:
            trace_id = ctx.trace_id or tracing.new_trace_id()
            if not ctx.trace_id:
                # bound, so every chunk rides this one id
                own_trace_token = tracing.set_trace_id(trace_id)
            own_timeline, own_token = spans.begin(trace_id, kind="client.predict",
                                                  machines=len(machines), chunks=len(ranges))
        try:
            pool, epoch = self._executor()
            futures = {}
            try:
                for machine in machines:
                    for i, (lo, hi) in enumerate(ranges):
                        # each chunk in a copy of the caller's context: its
                        # deadline, trace id and timeline
                        futures[(machine, i)] = pool.submit(
                            contextvars.copy_context().run, self._fetch_chunk, machine, lo, hi,
                            epoch)
            except RuntimeError as exc:  # the pool was shut down by close()
                raise ClientError(f"predict: the client was closed ({exc})") from None
            frames: Dict[str, Optional[ScoredFrame]] = {}
            first_error: Optional[BaseException] = None
            for machine in machines:
                chunks = []
                for i in range(len(ranges)):
                    try:
                        chunk = futures[(machine, i)].result()
                    except CancelledError:
                        chunk = None
                        first_error = first_error or ClientError(
                            f"{machine} chunk {i}: cancelled by close()")
                    except Exception as exc:  # noqa: BLE001 - every chunk finishes first
                        chunk = None
                        first_error = first_error or exc
                    if chunk is not None:
                        chunks.append(chunk)
                frames[machine] = ScoredFrame.concat(chunks)
            if first_error is not None:
                raise first_error
        except BaseException as exc:
            if own_timeline is not None:
                own_timeline.finish(status="error", error=f"{type(exc).__name__}: {exc}")
            raise
        else:
            if own_timeline is not None:
                own_timeline.finish(status="ok")
        finally:
            if own_token is not None:
                spans.end(own_token)
                if own_trace_token is not None:
                    tracing.reset_trace_id(own_trace_token)
                flightrec.RECORDER.record(own_timeline)
        for forwarder in self.forwarders:
            for machine, frame in frames.items():
                if frame is not None:
                    forwarder.forward(machine, frame)
        return frames

    def predict_frame(
        self,
        machine: str,
        X: np.ndarray,
        columns: Optional[Sequence[str]] = None,
        timestamps: Optional[np.ndarray] = None,
        fmt: str = "parquet",
    ) -> Optional[ScoredFrame]:
        """Score rows the caller holds (no server-side fetch): ``X`` (rows x
        tags) named by ``columns`` and stamped by ``timestamps`` (int64 UTC
        ns), POSTed as parquet (the timestamps its index; ``pyarrow`` is
        imported here) or as JSON records (nested lists without
        ``columns``), under the same retry contract as :meth:`predict`."""
        X = np.asarray(X, dtype=np.float32)
        if fmt == "parquet":
            if columns is None:
                raise ValueError("a parquet body needs the column names")
            body, content_type = _parquet_body(X, list(columns), timestamps), \
                "application/x-parquet"
        elif fmt == "json":
            rows = ([dict(zip(columns, row)) for row in X.tolist()] if columns is not None
                    else X.tolist())
            body, content_type = json.dumps({"X": rows}).encode(), "application/json"
        else:
            raise ValueError(f"fmt must be 'parquet' or 'json', got {fmt!r}")
        payload = self._call(machine, machine, self._anomaly_path(machine), body=body,
                             content_type=content_type)
        return ScoredFrame.from_payload(payload)


def _parquet_body(X: np.ndarray, columns: List[str], timestamps: Optional[np.ndarray]) -> bytes:
    """A parquet table of ``X``'s columns with, when given, a tz-aware UTC
    datetime index, described by the pandas metadata that ``pd.read_parquet``
    reads the index from."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError as exc:
        raise ImportError("a parquet body needs the 'pyarrow' package, which is not "
                          "installed; use fmt='json'") from exc
    arrays = [pa.array(X[:, j]) for j in range(X.shape[1])]
    names = list(columns)
    meta_columns = [{"name": name, "field_name": name, "pandas_type": "float32",
                     "numpy_type": "float32", "metadata": None} for name in names]
    index_columns: List[Any] = [{"kind": "range", "name": None, "start": 0,
                                 "stop": len(X), "step": 1}]
    if timestamps is not None:
        arrays.append(pa.array(np.asarray(timestamps, np.int64), pa.timestamp("ns", tz="UTC")))
        names.append("__index_level_0__")
        meta_columns.append({"name": None, "field_name": "__index_level_0__",
                             "pandas_type": "datetimetz", "numpy_type": "datetime64[ns]",
                             "metadata": {"timezone": "UTC"}})
        index_columns = ["__index_level_0__"]
    pandas_meta = {"index_columns": index_columns, "column_indexes": [],
                   "columns": meta_columns, "creator": {"library": "pyarrow",
                                                        "version": pa.__version__},
                   "pandas_version": "2.0.0"}
    table = pa.Table.from_arrays(arrays, names=names).replace_schema_metadata(
        {b"pandas": json.dumps(pandas_meta).encode()})
    sink = pa.BufferOutputStream()
    pq.write_table(table, sink)
    return sink.getvalue().to_pybytes()
