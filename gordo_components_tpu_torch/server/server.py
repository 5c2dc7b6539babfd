"""HTTP front of the port (port of the ``/anomaly/prediction`` handler in
``gordo_components_tpu/server/server.py:1938-1983, 2032-2074, 2147-2168``).

Built on the standard library's ``ThreadingHTTPServer``. Routes:

- ``GET  /healthz``
- ``POST /anomaly/prediction`` (when one machine is served)
- ``POST /gordo/v0/<project>/<machine>/anomaly/prediction``

The request body is JSON ``{"X": rows}`` (nested lists, or records keyed
by the machine's tag list); the response body is byte-compatible with the
reference's fast-JSON encoder. A request that is too short for the
window, has the wrong width or holds non-finite values answers 400, as the
reference does; a model that is not an anomaly detector answers 422.

Every machine's artifact is loaded to the host; the stacked engine places
one copy of each bucket's weights on the device, and is warmed up (kernel
libraries built, cuBLAS handles made) before the server binds its port.

Run: ``python -m gordo_components_tpu_torch.server --models-dir DIR
[--port N] [--device cpu]``.
"""

from __future__ import annotations

import json
import logging
import os
import re
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
from typing import Any, Dict, List, Optional

import numpy as np

from .. import wire
from ..models.anomaly.diff import DiffBasedAnomalyDetector
from ..serializer.persistence import DEFINITION_FILE, load, load_metadata
from ..store.manifest import CURRENT_FILE
from ..utils.backend import DeviceLike, resolve_device
from .engine import ServingEngine

logger = logging.getLogger(__name__)

_MACHINE_ROUTE = re.compile(r"^/gordo/v0/([^/]+)/([^/]+)/anomaly/prediction$")


class HTTPError(Exception):
    def __init__(self, status: int, message: str, **extra: Any):
        super().__init__(message)
        self.status = status
        self.body = {"error": message, **extra}


class _Machine:
    def __init__(self, name: str, model_dir: str):
        self.name = name
        # on the host: the engine stacks the weights and places one copy
        self.model = load(model_dir, device="cpu")
        self.metadata = load_metadata(model_dir)

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


def scan_models_dir(models_dir: str) -> Dict[str, str]:
    """``{name: path}``: the directory itself when it is one artifact,
    else each immediate artifact subdirectory (flat or generation root)."""

    def is_artifact(path: str) -> bool:
        return any(
            os.path.isfile(os.path.join(path, f)) for f in (DEFINITION_FILE, CURRENT_FILE)
        )

    if is_artifact(models_dir):
        return {os.path.basename(os.path.normpath(models_dir)): models_dir}
    return {
        entry: os.path.join(models_dir, entry)
        for entry in sorted(os.listdir(models_dir))
        if not entry.startswith(".")
        and os.path.isdir(os.path.join(models_dir, entry))
        and is_artifact(os.path.join(models_dir, entry))
    }


class ModelServer:
    """Loaded machines + their warmed-up engine; request handling without
    sockets. :meth:`close` stops the engine's collector threads."""

    def __init__(self, models_dir: str, project: str = "project", device: DeviceLike = None):
        self.device = resolve_device(device)
        self.project = project
        self.machines = {
            name: _Machine(name, path)
            for name, path in scan_models_dir(models_dir).items()
        }
        if not self.machines:
            raise ValueError(f"no model artifacts under {models_dir}")
        self.engine = ServingEngine(
            {name: m.model for name, m in self.machines.items()},
            target_cols={n: m.target_columns for n, m in self.machines.items()},
            device=self.device,
        )
        for name, reason in self.engine.skipped.items():
            logger.warning("Machine %r is not served: %s", name, reason)
        self.engine.warmup()

    def close(self) -> None:
        self.engine.close()

    def healthz(self) -> Dict[str, Any]:
        return {
            "status": "ok",
            "device": str(self.device),
            "machines": sorted(self.machines),
            "skipped": dict(self.engine.skipped),
        }

    def _machine(self, path: str) -> _Machine:
        if path == "/anomaly/prediction":
            if len(self.machines) != 1:
                raise HTTPError(
                    404,
                    "Multiple models served; use "
                    "/gordo/v0/<project>/<machine>/anomaly/prediction",
                )
            return next(iter(self.machines.values()))
        match = _MACHINE_ROUTE.match(path)
        if match is None:
            raise HTTPError(404, f"No route {path!r}")
        project, name = match.groups()
        if project != self.project:
            raise HTTPError(404, f"Unknown project {project!r}")
        if name not in self.machines:
            raise HTTPError(404, f"Unknown machine {name!r}")
        return self.machines[name]

    @staticmethod
    def _parse_X(body: bytes, machine: _Machine) -> np.ndarray:
        try:
            payload = json.loads(body.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise HTTPError(400, "Request body is not valid JSON") from None
        X = payload.get("X") if isinstance(payload, dict) else None
        if X is None:
            raise HTTPError(400, 'Payload must contain "X"')
        if isinstance(X, list) and X and isinstance(X[0], dict):
            tags = machine.tag_list or sorted(X[0])
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
        tags = machine.tag_list
        if tags and arr.shape[1] != len(tags):
            raise HTTPError(
                400,
                f"Machine {machine.name!r} expects {len(tags)} features, "
                f"got {arr.shape[1]}",
                expected_features=len(tags),
                got_features=int(arr.shape[1]),
            )
        finite = np.isfinite(arr)
        if not finite.all():
            bad = sorted(int(c) for c in np.unique(np.where(~finite)[1]))
            raise HTTPError(
                400,
                f"Payload contains non-finite (NaN/Inf) values in column(s) {bad}",
                non_finite_columns=bad,
            )

    def anomaly(self, path: str, body: bytes) -> str:
        """``POST`` body → response JSON text; raises :class:`HTTPError`."""
        machine = self._machine(path)
        if not isinstance(machine.model, DiffBasedAnomalyDetector):
            raise HTTPError(
                422,
                f"Model for machine {machine.name!r} is not an anomaly detector",
            )
        if not self.engine.can_score(machine.name):
            raise HTTPError(
                503,
                f"Machine {machine.name!r} cannot be scored: "
                f"{self.engine.skipped.get(machine.name)}",
            )
        X = self._parse_X(body, machine)
        self._validate_X(X, machine)
        try:
            scored = self.engine.anomaly(machine.name, X)
        except ValueError as exc:
            raise HTTPError(400, f"Anomaly scoring failed: {exc}") from None
        arrays = dict(zip(wire.SCORE_FIELDS, scored))
        extras = {}
        model = machine.model
        if model.tag_thresholds_ is not None:
            extras = {
                "tag-thresholds": [float(v) for v in model.tag_thresholds_],
                "total-threshold": model.total_threshold_,
            }
        return wire.encode_scored_json(arrays, None, extras)


class _Handler(BaseHTTPRequestHandler):
    server_version = "gordo-torch"
    protocol_version = "HTTP/1.1"

    def _send(self, status: int, text: str) -> None:
        data = text.encode()
        self.send_response(status)
        self.send_header("Content-Type", "application/json")
        self.send_header("Content-Length", str(len(data)))
        self.end_headers()
        self.wfile.write(data)

    def _route(self, method: str) -> None:
        app: ModelServer = self.server.model_server  # type: ignore[attr-defined]
        path = self.path.split("?", 1)[0]
        length = int(self.headers.get("Content-Length") or 0)
        body = self.rfile.read(length) if length else b""
        try:
            if path == "/healthz":
                self._send(200, json.dumps(app.healthz()))
            elif method != "POST":
                raise HTTPError(405, "POST required")
            else:
                self._send(200, app.anomaly(path, body))
        except HTTPError as exc:
            self._send(exc.status, json.dumps(exc.body))
        except Exception as exc:  # noqa: BLE001 - the request fails, the server stays up
            logger.exception("Scoring failed for %s", path)
            self._send(500, json.dumps({"error": f"{type(exc).__name__}: {exc}"}))

    def do_GET(self) -> None:  # noqa: N802 - http.server's naming
        self._route("GET")

    def do_POST(self) -> None:  # noqa: N802
        self._route("POST")

    def log_message(self, fmt: str, *args: Any) -> None:
        logger.info("%s %s", self.address_string(), fmt % args)


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
    device: DeviceLike = None, project: str = "project",
) -> ThreadingHTTPServer:
    """Load every machine under ``models_dir``, warm the engine up and bind
    the HTTP server (``port=0`` picks a free port: read
    ``server.server_address``); ``server_close()`` also closes the engine."""
    app = ModelServer(models_dir, project=project, device=device)
    try:
        httpd = _HTTPServer((host, port), _Handler)
    except BaseException:
        app.close()
        raise
    httpd.model_server = app  # type: ignore[attr-defined]
    return httpd
