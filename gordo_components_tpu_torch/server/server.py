"""HTTP front of the port (port of ``gordo_components_tpu/server/server.py``:
the routes at 108-160, ``_ServerState`` at 275-420, ``reload`` at 796-1040,
the request wrapper at 1253-1335, the handlers at 1470-1840 and the scoring
path at 1868-2248).

Built on the standard library's ``ThreadingHTTPServer``: no web framework.
Routes, each also under ``/gordo/v0/<project>/<machine>/`` where marked:

- ``GET  /healthz`` (and machine-scoped): the fleet's tri-state health
  (``ok``/``degraded``/``draining``, ``live``, ``ready``, the quarantined
  and suspect machines), or one machine's generation and precision (503
  while it is quarantined);
- ``GET  /metadata`` (and machine-scoped): the machine's build metadata;
- ``GET  /models``; ``POST /reload``;
- ``GET  /metrics``: JSON (``latency``, ``engine``, ``resilience``,
  ``registry``), or Prometheus text with ``?format=prometheus``;
- ``POST /prediction`` and ``POST /anomaly/prediction`` (and
  machine-scoped): the scoring endpoints. The bare paths serve a server
  of one machine.

A scoring request passes the machine's quarantine gate (a quarantined
machine answers 503 until its cooldown lets one request through as a
probe), then the admission gate (``GORDO_MAX_INFLIGHT``, default 64;
``GORDO_MAX_QUEUE``, default 32), then the handler. The body is JSON
``{"X": rows}`` (nested lists, or records keyed by the tag list); the
answer is JSON, or the npz wire format when ``Accept`` lists
``application/x-gordo-npz``. Failures map as in the reference: bad input
400, unknown machine 404, wrong method 405, a model that is not an anomaly
detector 422 on ``/anomaly/prediction``, an expired ``X-Gordo-Deadline``
504 (the machine is marked suspect), a shed 503, and any other scoring
exception quarantines the machine (503) while the rest of the fleet keeps
serving. Every answer echoes ``X-Gordo-Trace-Id``. A machine the engine
cannot lift answers 503 on the scoring endpoints: the port has no host
path, so nothing is scored on the CPU in its place. Parquet bodies and
``?start&end`` data fetches are not served (415, 422).

Machines load to the host; the stacked engine places one copy of each
bucket's weights on the device and is warmed up before the server binds
its port and before a reload publishes a new engine. ``POST /reload``
rescans a models directory and swaps machines and engine as ONE state;
the old state's in-flight requests drain before its engine closes.

Run: ``python -m gordo_components_tpu_torch.server --models-dir DIR
[--port N] [--device cpu]``.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import threading
import time
import urllib.parse
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, NamedTuple, Optional, Tuple

import numpy as np

from .. import precision as precision_mod
from .. import wire
from ..models.anomaly.diff import DiffBasedAnomalyDetector
from ..observability import exposition, tracing
from ..observability.registry import REGISTRY
from ..resilience import deadline
from ..resilience.admission import DRAINING_HEADER, AdmissionController, AdmissionRejected
from ..resilience.deadline import DeadlineExceeded
from ..resilience.quarantine import Quarantine
from ..serializer.persistence import DEFINITION_FILE, load, load_metadata
from ..store.generations import current_generation
from ..store.manifest import CURRENT_FILE, resolve_artifact_dir
from ..utils.backend import DeviceLike, resolve_device
from .engine import ServingEngine

logger = logging.getLogger(__name__)

_M_REQUEST_SECONDS = REGISTRY.histogram(
    "gordo_server_request_duration_seconds",
    "End-to-end HTTP request latency by endpoint",
    labels=("endpoint",),
)
_M_REQUESTS = REGISTRY.counter(
    "gordo_server_requests_total",
    "HTTP requests served, by endpoint and status code",
    labels=("endpoint", "status"),
)
_M_WIRE_FORMAT = REGISTRY.counter(
    "gordo_server_wire_format_total",
    "Scoring responses by negotiated wire format (npz = binary "
    "application/x-gordo-npz, fast_json = the printf-rendered JSON "
    "fallback)",
    labels=("format",),
)

_MACHINE_ENDPOINTS = {
    "healthz": "healthz",
    "metadata": "metadata",
    "prediction": "prediction",
    "anomaly/prediction": "anomaly",
}
_ROOT_ENDPOINTS = {
    "/healthz": "healthz",
    "/metadata": "metadata",
    "/metrics": "metrics",
    "/models": "models",
    "/reload": "reload",
    "/prediction": "prediction",
    "/anomaly/prediction": "anomaly",
}
_MACHINE_ROUTE = re.compile(
    r"^/gordo/v0/(?P<project>[^/]+)/(?P<machine>[^/]+)/(?P<endpoint>"
    + "|".join(re.escape(e) for e in _MACHINE_ENDPOINTS)
    + ")$"
)
_PARQUET_TYPES = (
    "application/octet-stream",
    "application/x-parquet",
    "application/vnd.apache.parquet",
)


class Response(NamedTuple):
    status: int
    body: bytes
    content_type: str
    headers: Dict[str, str]


def _json(payload: Any, status: int = 200, headers: Optional[Dict[str, str]] = None) -> Response:
    return Response(status, json.dumps(payload, default=str).encode(), "application/json",
                    dict(headers or {}))


class HTTPError(Exception):
    """An answer other than 200, with a JSON body ``{"error": message,
    **extra}``."""

    def __init__(self, status: int, message: str, headers: Optional[Dict[str, str]] = None,
                 **extra: Any):
        super().__init__(message)
        self.status = status
        self.response = _json({"error": message, **extra}, status, headers)


def _retry_after(seconds: float) -> str:
    """``Retry-After`` in whole seconds, never 0 (a zero invites an
    instant retry storm)."""
    return str(max(1, int(math.ceil(seconds))))


def _latency_view() -> Dict[str, Any]:
    return {
        labelvalues[0]: {
            "count": stats["count"],
            "p50_ms": stats["p50"] * 1000,
            "p99_ms": stats["p99"] * 1000,
            "mean_ms": stats["mean"] * 1000,
        }
        for labelvalues, stats in _M_REQUEST_SECONDS.stats().items()
    }


def _artifact_mtime(model_dir: str) -> float:
    """Newest mtime among the artifact's files: the signal by which reload
    spots a machine rebuilt in place."""
    newest = 0.0
    try:
        for entry in os.scandir(model_dir):
            if entry.is_file():
                newest = max(newest, entry.stat().st_mtime)
    except OSError:
        pass
    return newest


class _Machine:
    def __init__(self, name: str, model_dir: str):
        self.name = name
        self.model_dir = model_dir
        # mtime first: a rebuild landing during the load then reads as
        # changed at the next reload
        self.mtime = _artifact_mtime(model_dir)
        self.generation = current_generation(model_dir)
        # on the host: the engine stacks the weights and places one copy
        self.model = load(model_dir, device="cpu")
        self.metadata = load_metadata(model_dir)
        # an unknown precision raises here: the machine is refused, never
        # served at f32 silently
        self.precision = precision_mod.of_metadata(self.metadata)
        self.quantized = None
        if self.precision == "int8":
            self.quantized = precision_mod.load_quantized(resolve_artifact_dir(model_dir))

    @property
    def tag_list(self) -> Optional[List[str]]:
        return self.metadata.get("dataset", {}).get("tag_list")

    @property
    def target_columns(self) -> Optional[List[int]]:
        """Input-column index of each target tag when the build metadata
        names targets as a subset of the inputs, else ``None``."""
        tags = self.tag_list
        targets = self.metadata.get("dataset", {}).get("target_tag_list")
        if not tags or not targets or targets == tags:
            return None
        try:
            return [tags.index(t) for t in targets]
        except ValueError:
            return None


def _is_artifact(path: str) -> bool:
    return any(os.path.isfile(os.path.join(path, f)) for f in (DEFINITION_FILE, CURRENT_FILE))


def scan_models_dir(models_dir: str) -> Dict[str, str]:
    """``{name: path}`` for each immediate artifact subdirectory (flat or
    generation root) of ``models_dir``; hidden directories never count."""
    return {
        entry: os.path.join(models_dir, entry)
        for entry in sorted(os.listdir(models_dir))
        if not entry.startswith(".")
        and os.path.isdir(os.path.join(models_dir, entry))
        and _is_artifact(os.path.join(models_dir, entry))
    }


class _ServerState:
    """Machines and their engine, swapped as ONE reference on reload, so a
    request never sees machines and engine of different generations. Each
    scoring request ``enter()``s the state it read and ``exit()``s when
    done; a reload ``drain()``s the old state before closing its engine."""

    __slots__ = ("machines", "single", "engine", "_inflight", "_cond")

    def __init__(self, machines: Dict[str, _Machine], single: bool, device):
        self._inflight = 0
        self._cond = threading.Condition()
        self.machines = machines
        self.single = next(iter(machines.values())) if single else None
        self.engine = ServingEngine(
            {name: m.model for name, m in machines.items()},
            target_cols={name: m.target_columns for name, m in machines.items()},
            precisions={name: m.precision for name, m in machines.items()},
            quantized={name: m.quantized for name, m in machines.items()
                       if m.quantized is not None},
            device=device,
        )
        for name, reason in self.engine.skipped.items():
            logger.warning("Machine %r is not served: %s", name, reason)
        ladder = self.engine.stats()["precision"]["machines"]
        if set(ladder) - {"f32"}:
            logger.info("Precision ladder: %s",
                        ", ".join(f"{k}={v}" for k, v in sorted(ladder.items())))

    def enter(self) -> None:
        with self._cond:
            self._inflight += 1

    def exit(self) -> None:
        with self._cond:
            self._inflight -= 1
            if self._inflight == 0:
                self._cond.notify_all()

    def drain(self, timeout: float) -> bool:
        """Wait until every request that entered has exited (True), or
        ``timeout`` passed (False)."""
        end = time.monotonic() + timeout
        with self._cond:
            while self._inflight > 0:
                left = end - time.monotonic()
                if left <= 0:
                    return False
                self._cond.wait(timeout=left)
        return True


class ModelServer:
    """The request handling of the server, without sockets: ``handle(method,
    path, headers, body) -> Response``.

    ``models_dir``: one artifact (a server of one machine, named by the
    directory; reload then has nothing to rescan) or a directory of them
    (a fleet: a machine that fails to load is quarantined and the rest
    serve; ``POST /reload`` rescans it). ``max_inflight`` defaults to
    ``GORDO_MAX_INFLIGHT`` (64), the admission queue to ``GORDO_MAX_QUEUE``
    (32); ``quarantine_cooldown``: seconds before a quarantined machine may
    be probed; ``drain_timeout``: how long a reload or a shutdown waits for
    in-flight requests. :meth:`close` drains and stops the engine.
    """

    def __init__(
        self,
        models_dir: str,
        project: str = "project",
        device: DeviceLike = None,
        max_inflight: Optional[int] = None,
        quarantine_cooldown: float = 30.0,
        drain_timeout: float = 10.0,
    ):
        self.device = resolve_device(device)
        self.project = project
        if max_inflight is None:
            max_inflight = int(os.environ.get("GORDO_MAX_INFLIGHT", "64"))
        self.admission = AdmissionController(
            max_inflight=max_inflight,
            max_queue=int(os.environ.get("GORDO_MAX_QUEUE", "32")),
        )
        self.quarantine = Quarantine(cooldown=quarantine_cooldown)
        self.drain_timeout = drain_timeout
        # machines that failed to load, name -> dir: quarantined, retried
        # at every reload
        self._quarantined_dirs: Dict[str, str] = {}
        self._reload_lock = threading.Lock()
        if _is_artifact(models_dir):
            self.models_root: Optional[str] = None
            name = os.path.basename(os.path.normpath(models_dir))
            machines = {name: _Machine(name, models_dir)}
        else:
            self.models_root = models_dir
            machines = {}
            for name, path in scan_models_dir(models_dir).items():
                try:
                    machines[name] = _Machine(name, path)
                except Exception as exc:  # noqa: BLE001 - one bad artifact must not stop the fleet
                    logger.exception("Failed to load machine %r", name)
                    self.quarantine.quarantine(name, f"{type(exc).__name__}: {exc}", "load")
                    self._quarantined_dirs[name] = path
            if not machines:
                raise ValueError(
                    f"no model artifact under {models_dir} loaded; quarantined: "
                    f"{sorted(self._quarantined_dirs)}"
                )
        self._state = self._new_state(machines)
        tracing.install_log_record_factory()
        logger.info("ModelServer serving %d model(s): %s", len(machines), sorted(machines))

    def _new_state(self, machines: Dict[str, _Machine]) -> _ServerState:
        """A state for ``machines`` with its engine warmed up (kernel
        libraries built, cuBLAS handles made) before it takes traffic."""
        state = _ServerState(machines, single=self.models_root is None, device=self.device)
        state.engine.warmup()
        return state

    # the current state's parts
    @property
    def machines(self) -> Dict[str, _Machine]:
        return self._state.machines

    @property
    def engine(self) -> ServingEngine:
        return self._state.engine

    def close(self) -> None:
        """Stop admitting, let admitted requests finish (up to
        ``drain_timeout``), then stop the engine's collector threads."""
        self.admission.close("shutting down")
        if not self.admission.drain(self.drain_timeout):
            logger.warning("Shutdown: requests still in flight after %.1fs", self.drain_timeout)
        self._state.engine.close()

    # -- reload ----------------------------------------------------------------
    def reload(self) -> Dict[str, Any]:
        """Rescan the models directory and swap in the new fleet as ONE
        state: new machines load, vanished ones drop, machines whose
        artifacts changed on disk re-load. A directory that fails to load
        is skipped and reported, never fatal: the machine keeps its
        previous artifact if it had one, else is quarantined."""
        if not self.models_root:
            raise ValueError(
                "Server was not started with a models directory; reload has nothing to rescan"
            )
        with self._reload_lock:
            state = self._state
            seen = scan_models_dir(self.models_root)
            added: List[str] = []
            refreshed: List[str] = []
            errors: Dict[str, str] = {}
            machines: Dict[str, _Machine] = {}
            for name, path in seen.items():
                current = state.machines.get(name)
                try:
                    if current is None:
                        machines[name] = _Machine(name, path)
                        added.append(name)
                    elif current.model_dir != path or _artifact_mtime(path) != current.mtime:
                        machines[name] = _Machine(name, path)
                        refreshed.append(name)
                    else:
                        machines[name] = current
                except Exception as exc:  # noqa: BLE001 - a half-written dir is reported
                    errors[name] = f"{type(exc).__name__}: {exc}"
                    if current is not None:
                        machines[name] = current
                    else:
                        self.quarantine.quarantine(name, errors[name], "load")
                        self._quarantined_dirs.setdefault(name, path)
            for name in list(self._quarantined_dirs):
                if name not in seen:  # its directory is gone: decommissioned
                    self._quarantined_dirs.pop(name)
                    self.quarantine.recover(name)
            for name in added + refreshed:
                self._quarantined_dirs.pop(name, None)
                self.quarantine.recover(name)
            removed = sorted(set(state.machines) - set(machines))
            if added or removed or refreshed:
                self._state = self._new_state(machines)
                # drain BEFORE closing: a request still scoring against the
                # old engine's stacked trees must finish first
                if not state.drain(self.drain_timeout):
                    logger.warning("Reload: old generation still has in-flight requests "
                                   "after %.1fs drain; releasing anyway", self.drain_timeout)
                state.engine.close()
                logger.info("Reload: +%d / -%d / refreshed %d -> %d machine(s)%s",
                            len(added), len(removed), len(refreshed), len(machines),
                            f"; errors: {errors}" if errors else "")
            return {
                "added": sorted(added),
                "removed": removed,
                "refreshed": sorted(refreshed),
                "errors": errors,
                "total": len(machines),
            }

    # -- dispatch --------------------------------------------------------------
    def handle(self, method: str, raw_path: str, headers: Mapping[str, str],
               body: bytes) -> Response:
        """Answer one request: adopt or mint its trace id, bind its
        deadline, route it, map the resilience exceptions to 503/504, and
        record its latency and status."""
        started = time.perf_counter()
        headers = {key.lower(): value for key, value in headers.items()}
        path, _, query = raw_path.partition("?")
        params = {key: values[-1] for key, values in urllib.parse.parse_qs(query).items()}
        trace_id = headers.get(tracing.TRACE_HEADER.lower()) or tracing.new_trace_id()
        token = tracing.set_trace_id(trace_id)
        budget = deadline.parse_header(headers.get(deadline.DEADLINE_HEADER.lower()))
        deadline_token = deadline.set_deadline(budget) if budget is not None else None
        # ONE state per request: a reload may swap it meanwhile
        state = self._state
        endpoint = "error"
        try:
            try:
                endpoint, args = self._match(path)
                response = self._dispatch(method, endpoint, args, params, headers, body, state)
            except AdmissionRejected as exc:
                response = _json({"error": f"overloaded: {exc}"}, 503,
                                 {"Retry-After": _retry_after(exc.retry_after)})
            except DeadlineExceeded as exc:
                # the work is fine; the caller needs a fresh budget
                response = _json({"error": str(exc)}, 504, {"Retry-After": _retry_after(1.0)})
            except HTTPError as exc:
                response = exc.response
                endpoint = "error"
            except Exception as exc:  # noqa: BLE001 - the request fails, the server stays up
                logger.exception("Request %s %s failed", method, path)
                response = _json({"error": f"{type(exc).__name__}: {exc}"}, 500)
                endpoint = "error"
            response.headers[tracing.TRACE_HEADER] = trace_id
            if self.admission.closed is not None:
                response.headers[DRAINING_HEADER] = "1"
            elapsed = time.perf_counter() - started
            _M_REQUEST_SECONDS.labels(endpoint).observe(elapsed)
            _M_REQUESTS.labels(endpoint, str(response.status)).inc()
            logger.log(
                logging.DEBUG if endpoint in ("healthz", "metrics") else logging.INFO,
                "%s %s -> %d in %.1f ms [trace=%s]",
                method, path, response.status, elapsed * 1000, trace_id,
            )
        finally:
            if deadline_token is not None:
                deadline.reset(deadline_token)
            tracing.reset_trace_id(token)
        return response

    @staticmethod
    def _match(path: str) -> Tuple[str, Dict[str, str]]:
        if path in _ROOT_ENDPOINTS:
            return _ROOT_ENDPOINTS[path], {}
        match = _MACHINE_ROUTE.match(path)
        if match is None:
            raise HTTPError(404, f"No route {path!r}")
        return _MACHINE_ENDPOINTS[match["endpoint"]], {
            "project": match["project"], "machine": match["machine"]}

    def _machine_for(self, args: Dict[str, str], state: _ServerState) -> _Machine:
        name = args.get("machine")
        if name is None:
            if state.single is not None:
                return state.single
            raise HTTPError(404, "Multiple models served; use "
                                 "/gordo/v0/<project>/<machine>/<endpoint>")
        if args.get("project") != self.project:
            raise HTTPError(404, f"Unknown project {args.get('project')!r}")
        try:
            return state.machines[name]
        except KeyError:
            if self.quarantine.is_quarantined(name):
                # it exists but failed to load: 503 (try later), not 404
                self._abort_quarantined(name)
            raise HTTPError(404, f"Unknown machine {name!r}") from None

    def _abort_quarantined(self, name: str) -> None:
        raise HTTPError(
            503, f"Machine {name!r} is quarantined: {self.quarantine.last_error(name)}",
            headers={"Retry-After": _retry_after(self.quarantine.retry_after(name))},
        )

    def _dispatch(self, method: str, endpoint: str, args: Dict[str, str],
                  params: Dict[str, str], headers: Dict[str, str], body: bytes,
                  state: _ServerState) -> Response:
        if endpoint == "healthz":
            return self._healthz(args, state)
        if endpoint == "metrics":
            if params.get("format") == "prometheus":
                return Response(200, exposition.render_prometheus(REGISTRY).encode(),
                                exposition.CONTENT_TYPE, {})
            return _json({
                "latency": _latency_view(),
                "engine": state.engine.stats(),
                "resilience": {
                    "admission": self.admission.stats(),
                    "quarantined": self.quarantine.quarantined(),
                    "suspect": self.quarantine.suspects(),
                },
                "registry": REGISTRY.snapshot(),
            })
        if endpoint == "models":
            return _json({"project": self.project, "models": sorted(state.machines)})
        if endpoint == "reload":
            if method != "POST":
                raise HTTPError(405, "POST required")
            try:
                return _json(self.reload())
            except ValueError as exc:
                raise HTTPError(422, str(exc)) from None
        machine = self._machine_for(args, state)
        if endpoint == "metadata":
            return _json({"name": machine.name, "metadata": machine.metadata})
        # pin THIS state while scoring: a concurrent reload drains it
        # before closing its engine
        state.enter()
        try:
            return self._score_endpoint(method, endpoint, machine, params, headers, body, state)
        finally:
            state.exit()

    def _healthz(self, args: Dict[str, str], state: _ServerState) -> Response:
        name = args.get("machine")
        if name is not None:
            if self.quarantine.is_quarantined(name):
                return _json(
                    {"ok": False, "status": "quarantined",
                     "error": self.quarantine.last_error(name)},
                    503, {"Retry-After": _retry_after(self.quarantine.retry_after(name))},
                )
            served = self._machine_for(args, state)
            # load() verified the manifest: a served machine IS verified
            return _json({"ok": True, "status": "ok", "generation": served.generation,
                          "verified": True, "precision": served.precision})
        quarantined = self.quarantine.quarantined()
        suspects = self.quarantine.suspects()
        draining = self.admission.closed is not None
        ready = bool(state.machines) and not draining
        degraded = bool(quarantined or suspects)
        return _json(
            {
                "ok": ready and not degraded,
                "status": "draining" if draining else ("degraded" if degraded else "ok"),
                "live": True,
                "ready": ready,
                "quarantined": quarantined,
                "suspect": suspects,
                "device": str(self.device),
                "machines": sorted(state.machines),
                # machines the engine cannot lift, with the reason (503)
                "skipped": dict(state.engine.skipped),
                "store": {
                    "verified": len(state.machines),
                    "unverified": sorted(self._quarantined_dirs),
                    "generations": {n: m.generation for n, m in sorted(state.machines.items())},
                    "precisions": {n: m.precision for n, m in sorted(state.machines.items())},
                },
            },
            200 if ready else 503,
        )

    # -- scoring ---------------------------------------------------------------
    def _score_endpoint(self, method: str, endpoint: str, machine: _Machine,
                        params: Dict[str, str], headers: Dict[str, str], body: bytes,
                        state: _ServerState) -> Response:
        """The quarantine gate (with probe recovery), then admission, then
        the handler. Success clears the machine's health marks."""
        name = machine.name
        probing = False
        if self.quarantine.is_quarantined(name):
            if not self.quarantine.probe_allowed(name):
                self._abort_quarantined(name)
            probing = True  # cooldown elapsed: this request is the probe
            logger.info("Quarantine recovery probe for machine %r", name)
        try:
            with self.admission.admit():
                if endpoint == "prediction":
                    response = self._predict(method, machine, headers, body, state)
                else:
                    response = self._anomaly(method, machine, params, headers, body, state)
        except (AdmissionRejected, DeadlineExceeded):
            if probing:  # the model was never exercised: keep the probe open
                self.quarantine.release_probe(name)
            raise
        except HTTPError as exc:
            if probing and exc.status < 500:  # a client error proves nothing
                self.quarantine.release_probe(name)
            raise
        if probing:
            self.quarantine.recover(name)
            logger.info("Machine %r recovered from quarantine", name)
        else:
            self.quarantine.clear_suspect(name)
        return response

    @staticmethod
    def _parse_X(method: str, machine: _Machine, headers: Dict[str, str],
                 body: bytes) -> np.ndarray:
        if method != "POST":
            raise HTTPError(405, "POST required")
        content_type = wire.content_type_of(headers.get("content-type"))
        if content_type in _PARQUET_TYPES and (
            content_type != "application/octet-stream" or body[:4] == b"PAR1"
        ):
            raise HTTPError(415, "parquet request bodies are not served here; send JSON")
        try:
            payload = json.loads(body.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise HTTPError(400, "Request body is not valid JSON") from None
        X = payload.get("X") if isinstance(payload, dict) else None
        if X is None:
            raise HTTPError(400, 'Payload must contain "X"')
        if isinstance(X, list) and X and isinstance(X[0], dict):
            tags = machine.tag_list or sorted(X[0])  # column order of the build
            try:
                X = [[row[tag] for tag in tags] for row in X]
            except KeyError as exc:
                raise HTTPError(400, f"Record missing tag {exc.args[0]!r}") from None
        try:
            arr = np.asarray(X, dtype=np.float32)
        except (ValueError, TypeError):
            raise HTTPError(400, '"X" must be a rectangular numeric array') from None
        if arr.ndim == 1:
            arr = arr[None, :]
        if arr.ndim != 2:
            raise HTTPError(400, f'"X" must be 2-D, got shape {list(arr.shape)}')
        return arr

    @staticmethod
    def _validate_X(arr: np.ndarray, machine: _Machine) -> None:
        """Wrong width and non-finite values answer a 400 naming the
        offending columns."""
        tags = machine.tag_list
        if tags and arr.shape[1] != len(tags):
            raise HTTPError(
                400, f"Machine {machine.name!r} expects {len(tags)} features, got {arr.shape[1]}",
                expected_features=len(tags), got_features=int(arr.shape[1]),
            )
        finite = np.isfinite(arr)
        if not finite.all():
            bad = sorted(int(c) for c in np.unique(np.where(~finite)[1]))
            raise HTTPError(
                400, f"Payload contains non-finite (NaN/Inf) values in column(s) {bad}",
                non_finite_columns=bad,
            )

    def _predict(self, method: str, machine: _Machine, headers: Dict[str, str], body: bytes,
                 state: _ServerState) -> Response:
        X = self._parse_X(method, machine, headers, body)
        self._validate_X(X, machine)
        self._servable(machine, state)
        output = self._guarded(machine, lambda: state.engine.predict(machine.name, X),
                               "Prediction failed")
        return self._scored_response(headers, {"model-input": X, "model-output": output})

    def _anomaly(self, method: str, machine: _Machine, params: Dict[str, str],
                 headers: Dict[str, str], body: bytes, state: _ServerState) -> Response:
        model = machine.model
        if not isinstance(model, DiffBasedAnomalyDetector):
            raise HTTPError(422, f"Model for machine {machine.name!r} is not an anomaly "
                                 "detector; use /prediction")
        if params.get("start") or params.get("end"):
            raise HTTPError(422, "?start&end data fetches are not served here; "
                                 "POST the rows explicitly")
        X = self._parse_X(method, machine, headers, body)
        self._validate_X(X, machine)
        self._servable(machine, state)
        scored = self._guarded(machine, lambda: state.engine.anomaly(machine.name, X),
                               "Anomaly scoring failed")
        extras = {}
        if model.tag_thresholds_ is not None:
            extras = {
                "tag-thresholds": [float(v) for v in model.tag_thresholds_],
                "total-threshold": model.total_threshold_,
            }
        return self._scored_response(headers, dict(zip(wire.SCORE_FIELDS, scored)), extras)

    @staticmethod
    def _servable(machine: _Machine, state: _ServerState) -> None:
        """A machine the engine could not lift answers 503 with the reason:
        there is no host path to score it on instead."""
        if not state.engine.can_score(machine.name):
            raise HTTPError(503, f"Machine {machine.name!r} cannot be scored: "
                                 f"{state.engine.skipped.get(machine.name)}")

    @staticmethod
    def _scored_response(headers: Dict[str, str], arrays: Dict[str, Any],
                         extras: Optional[Dict[str, Any]] = None) -> Response:
        """npz when ``Accept`` lists it, else the fast JSON body."""
        arrays = {name: np.asarray(arr) for name, arr in arrays.items()}
        if wire.wants_npz(headers.get("accept")):
            _M_WIRE_FORMAT.labels("npz").inc()
            return Response(200, wire.encode_npz(arrays, dict(extras or {})),
                            wire.NPZ_CONTENT_TYPE, {})
        _M_WIRE_FORMAT.labels("fast_json").inc()
        return Response(200, wire.encode_scored_json(arrays, None, extras).encode(),
                        "application/json", {})

    def _guarded(self, machine: _Machine, fn: Callable[[], Any], error_prefix: str) -> Any:
        """One failure taxonomy for scoring: bad input 400, an expired
        deadline 504 with the machine marked suspect, anything else
        quarantines the machine (503) — never a 500 from the engine."""
        try:
            return fn()
        except ValueError as exc:
            raise HTTPError(400, f"{error_prefix}: {exc}") from None
        except DeadlineExceeded:
            self.quarantine.mark_suspect(machine.name, "deadline expired at dispatch")
            raise
        except Exception as exc:  # noqa: BLE001 - isolate THIS machine
            logger.exception("Scoring failed for machine %r; quarantining", machine.name)
            self.quarantine.quarantine(machine.name, f"{type(exc).__name__}: {exc}", "score")
            self._abort_quarantined(machine.name)


class _Handler(BaseHTTPRequestHandler):
    server_version = "gordo-torch"
    protocol_version = "HTTP/1.1"

    def _route(self, method: str) -> None:
        app: ModelServer = self.server.model_server  # type: ignore[attr-defined]
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        response = app.handle(method, self.path, self.headers, body)
        self.send_response(response.status)
        self.send_header("Content-Type", response.content_type)
        self.send_header("Content-Length", str(len(response.body)))
        for key, value in response.headers.items():
            self.send_header(key, value)
        self.end_headers()
        self.wfile.write(response.body)

    def do_GET(self) -> None:  # noqa: N802 - http.server's naming
        self._route("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._route("POST")

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.debug("%s %s", self.address_string(), fmt % args)


class _HTTPServer(ThreadingHTTPServer):
    daemon_threads = True
    # the listen backlog: socketserver's default of 5 drops the SYNs of a
    # burst of concurrent clients, which retry after 1 s and then 3 s
    request_queue_size = 128

    def server_close(self) -> None:
        super().server_close()
        self.model_server.close()  # type: ignore[attr-defined]


def make_server(
    models_dir: str, host: str = "127.0.0.1", port: int = 5555,
    device: DeviceLike = None, project: str = "project", **options: Any,
) -> ThreadingHTTPServer:
    """Load every machine under ``models_dir``, warm the engine up and bind
    the HTTP server (``port=0`` picks a free port: read
    ``server.server_address``); ``options`` go to :class:`ModelServer`.
    ``server_close()`` also drains and closes the engine."""
    app = ModelServer(models_dir, project=project, device=device, **options)
    try:
        httpd = _HTTPServer((host, port), _Handler)
    except BaseException:
        app.close()
        raise
    httpd.model_server = app  # type: ignore[attr-defined]
    return httpd
