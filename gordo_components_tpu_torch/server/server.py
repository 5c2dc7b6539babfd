"""HTTP front of the port (port of ``gordo_components_tpu/server/server.py``:
the routes at 108-160, ``_ServerState`` at 275-420, the control loops'
wiring at 657-795, ``reload`` at 796-1040, the request wrapper at
1253-1432, the handlers at 1470-1866 and the scoring path at 1868-2248,
with lazy fleet boot at 435-470, 570-655 and 1122-1200, ``/prefetch`` at
1741-1754, the host path at 2010-2024 and 2170-2200, ``/layout`` at
678-682, 998-1006 and 1755-1816, and the fleet-sharded mesh's partition).

Built on the standard library's ``ThreadingHTTPServer``: no web framework.
Routes, each also under ``/gordo/v0/<project>/<machine>/`` where marked:

- ``GET  /healthz`` (and machine-scoped): the fleet's tri-state health
  (``ok``/``degraded``/``draining``, ``live``, ``ready``, the quarantined
  and suspect machines), or one machine's generation and precision (503
  while it is quarantined);
- ``GET  /metadata`` (and machine-scoped): the machine's build metadata;
- ``GET  /models``; ``POST /reload``;
- ``GET  /layout`` (the layout plan this worker applied: ``fingerprint``,
  ``resident``, ``cap``, ``applied``); ``POST /layout`` (``{fingerprint,
  resident, cap, prefetch}``: the worker's slice of a committed plan, as
  the fleet reconciler lands it: residency pins, the residency cap through
  :meth:`ModelServer.apply_tuning`, ``/prefetch`` hints) and ``POST
  /layout {"clear": true}`` (back to no plan). Each is an ``apply-plan`` or
  ``clear-plan`` control-ledger event; the fingerprint is ``/healthz``'s
  ``layout`` and survives a reload, whose new engine is re-pinned;
- ``POST /prefetch`` (``{"machines": [...]}``): a placement hint that
  queues background host-cache loads of lazy machines; answers
  ``{"queued", "skipped", "unknown"}`` (405 for another method, 400 for a
  body without a ``machines`` list);
- ``GET  /download-model`` (and machine-scoped): the machine's artifact as
  one gzip'd tar (``serializer.dumps``), which either package ``loads``;
- ``GET  /metrics``: JSON (``latency``, ``engine``, ``resilience``,
  ``registry``), or Prometheus text with ``?format=prometheus`` (and
  ``&exemplars=1`` for OpenMetrics exemplars naming trace ids);
- ``GET  /tenants``: the tenant table (keys redacted), live quota bucket
  levels, the raw header values seen, and the admission gate's stats;
- ``GET  /debug/requests`` (``?limit=N``): the flight recorder's recent,
  slowest and errored request timelines; ``GET
  /debug/requests/<trace_id>`` one timeline (``?format=chrome``: Chrome
  trace-event JSON, which Perfetto loads);
- ``GET  /slo``: each objective's attainment, fast and slow burn rates and
  breaches, and the stages that ate the latency budget
  (``observability/slo.py``; ``{"enabled": false}`` under ``GORDO_SLO=0``);
- ``GET  /telemetry`` (``?window=`` seconds or ``1m``/``10m``/``1h``;
  ``?view=export`` for the ``gordo-layout-input/v1`` document): the
  warehouse's windowed rates and percentiles, the traffic top-k and the
  cost ledger (``observability/telemetry.py``; off under
  ``GORDO_TELEMETRY=0``);
- ``GET  /incidents`` (``?view=ledger&window=&limit=``: the control
  ledger's tail) and ``GET /incidents/<id>``: the incident reports that SLO
  breach edges open (``observability/incidents.py``);
- ``GET  /autopilot``; ``POST /autopilot/enable|disable``: the controller's
  status and runtime kill switch (``autopilot/``; 409 under
  ``GORDO_AUTOPILOT=0``, where no controller exists);
- ``POST /prediction``, ``POST /anomaly/prediction`` and ``POST
  /bulk/anomaly/prediction`` (and machine-scoped): the scoring endpoints;
  the bulk one scores as ``/anomaly/prediction`` does, in the bulk class.
  The bare paths serve a server of one machine. ``/anomaly/prediction``
  with ``?start=…&end=…`` fetches the rows itself: the machine's build
  metadata names its ``dataset_config``, which is rebuilt with those
  dates (the ``data_fetch`` stage, the ``data-fetch`` fault point) and
  scored; the answer carries the scored rows' timestamps.

Every request resolves its tenant from ``X-Gordo-Tenant`` (a name or a
declared API key of ``GORDO_TENANTS``; anything else is ``default``) and,
while the flight recorder is on (``GORDO_FLIGHTREC``, default on), records
a span timeline: ``admission``, ``queue_wait``, ``megabatch``,
``dispatch``, ``device_execute``, ``fetch``, ``score`` and ``encode``. A
caller that sends ``X-Gordo-Timeline: 1`` gets the timeline back in that
header (``observability/stitch.py``). A scoring request passes the
machine's quarantine gate (a quarantined machine answers 503 until its
cooldown lets one request through as a probe), then the class-aware
admission gate (``GORDO_MAX_INFLIGHT``, default 64; ``GORDO_MAX_QUEUE``,
default 32; a tenant past its quota answers 429 + ``Retry-After``), then
the handler. The body is JSON
``{"X": rows}`` (nested lists, or records keyed by the tag list); the
answer is JSON, or the npz wire format when ``Accept`` lists
``application/x-gordo-npz``. Failures map as in the reference: bad input
400, unknown machine 404, wrong method 405, a model that is not an anomaly
detector 422 on ``/anomaly/prediction``, an expired ``X-Gordo-Deadline``
504 (the machine is marked suspect), a shed 503, and any other scoring
exception quarantines the machine (503) while the rest of the fleet keeps
serving. Every answer echoes ``X-Gordo-Trace-Id``. A machine the engine
cannot lift (a pipeline with a ``FeatureUnion``, or more steps than
``[scaler, estimator]``) is scored on the host path, as the reference
scores it: ``model.anomaly`` / ``model.predict``, the transformers in
numpy and the estimator on the server's device, where the engine placed it
once; a joint multi-step forecaster, which no path scores as anomalies,
answers 503 on ``/anomaly/prediction``. A parquet body is read through
pyarrow (415 where it is missing).

Machines load to the host (a ``model-load`` fault, ``GORDO_FAULTS``,
stands in for a broken artifact and quarantines the machine); the stacked
engine places one copy of each bucket's weights on the device and is
warmed up before the server binds its port and before a reload publishes
a new engine. Control events (quarantine, recovery, fault plans, shed
levels) go to the control ledger under ``GORDO_LEDGER_DIR/worker-<id>``,
or ``<models-dir>/.telemetry/ledger-worker-<id>``, or memory only, where
``<id>`` is the server's ``worker_id`` (``--worker-id``,
``GORDO_WORKER_ID``; 0 when unset): each worker of a fleet tier over one
models directory writes a tree of its own, and a worker's responses carry
``X-Gordo-Worker: <id>``. ``POST /reload``
rescans a models directory and swaps machines and engine as ONE state;
the old state's in-flight requests drain before its engine closes.

Lazy fleet boot (``lazy_boot=True``, ``GORDO_LAZY_BOOT=1``, ``run-server
--lazy-boot``): the models root's ``FLEET_INDEX.json``
(``store.generations.write_fleet_index``) names the fleet; its first
``GORDO_BOOT_EAGER`` machines (sorted names, default 0) load at boot and
the rest are lazy: no load, no device bytes, until a request's first
touch verifies and loads the artifact through the engine's spill tier
(``GORDO_HOST_CACHE_MB``). A load that fails there quarantines the machine
as an eager boot's would. A machine-scoped ``/healthz`` of a lazy machine
answers from the host cache, or as ``lazy``, and never loads it. With no
readable index the boot scans instead. ``POST /reload`` re-reads the index:
membership changes swap the state, and a lazy machine whose index
``generation`` moved has its cached bundle dropped (``refreshed``).

The fleet-sharded serving mesh (reference ``server.py:436-543``,
``:609-614``, ``:851-880``, ``:1048-1117``, ``:1346-1350``, ``:1380-1383``,
``:1563-1575``): a server given ``mesh_shards`` and a shard
(``run-server --mesh-shards N --mesh-shard i``, or ``GORDO_MESH_SHARDS``
and ``GORDO_MESH_SHARD``, else its worker id mod N) over a models root
applies the shard plan (``parallel/shard_plan.py``): once the fleet holds
at least ``GORDO_MESH_MIN_SHARD_MACHINES`` machines (default 2N) only the
machines its shard owns by ring position load eagerly, and every other
machine goes behind the spill tier exactly as a lazy one does, the
fallback rung that answers for a dead owner. Every reload re-derives the
partition. Answers carry ``X-Gordo-Shard: <i>``, timelines ``shard``, and
``/healthz`` a ``mesh`` block (``shard``, ``shards``, ``owned``,
``remote_or_lazy``); the engine counts ``gordo_mesh_requests_total`` by
rung, ``owned`` or ``fallback``.

Host-sharded capacity mode (reference ``server.py:311-318``,
``:364-382``, ``:429-545``, ``:979``): ``shard_fleet=True`` (``run-server
--shard-fleet``) builds every state's engine (boot, reload, rollback)
over ``parallel.mesh.fleet_mesh`` of the server's device type, every
visible card: each bucket's stack is split over them, scored on the first,
with the engine's hot cache and megabatching off. The boot log says which
dispatch mode a state serves with.

Warm boot (reference ``server.py:483``, ``:546-547``, ``:2340-2370``):
every state's engine (boot, reload, rollback) resolves the kernel
libraries it launches through one store, ``compile_cache_store=`` (or
``GORDO_COMPILE_CACHE_STORE``; ``"off"``: none), by default
``<models-dir>/.compile-cache/torch-cuda``: a verified entry is loaded
with no ``nvcc``, any other is built and written back. ``make_server``
logs the hits and writes, ``/metrics``' engine block carries the counts,
and the telemetry sampler reads the store's build seconds.

The control loops tick on reads, never on a thread: every ``/metrics``
scrape ticks the SLO evaluator, then the autopilot, then the telemetry
warehouse, each gated by its own minimum interval
(``GORDO_SLO_EVAL_INTERVAL``, ``GORDO_AUTOPILOT_INTERVAL``,
``GORDO_TELEMETRY_INTERVAL``);
``/slo``, ``/autopilot``, ``/incidents`` and ``/telemetry`` tick what they
read. The SLO evaluator (``GORDO_SLO``, default on) reads the scoring
latency and availability and each tenant class's availability; a breach
edge opens an incident report under the ledger directory's
``incidents/``. The autopilot (built frozen unless ``GORDO_AUTOPILOT=1``;
none at all under ``0``) moves the dispatch depth, the fill window, the
in-flight bound and the shed ladder through :meth:`ModelServer.
apply_tuning`, whose values a reload carries to the new engine. The
warehouse (``GORDO_TELEMETRY``, default on) keeps its segments under
``GORDO_TELEMETRY_DIR`` or ``<models-dir>/.telemetry/worker-<id>``.

Shutdown is the reference's graceful sequence, :meth:`ModelServer.quiesce`:
admission closes (new work answers 503 with ``X-Gordo-Draining: 1``, and
``/healthz`` answers ``draining``), in-flight requests drain, the engine
quiesces; ``run-server`` stops its listener only after that, so a router
reads a draining worker as draining, never as dead.

Run: ``python -m gordo_components_tpu_torch.cli run-server --models-dir DIR
[--port N] [--device cpu]`` (or ``python -m
gordo_components_tpu_torch.server``, the same command).
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import time
import urllib.parse
from http.server import ThreadingHTTPServer
from typing import Any, Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np

from .. import precision as precision_mod
from .. import wire
from ..analysis import lockcheck
from ..autopilot import build_server_autopilot, disabled_snapshot
from ..compile_cache import resolve_store
from ..dataset import GordoBaseDataset
from ..dataset.data_provider.providers import pandas_index_columns
from ..models.anomaly.diff import DiffBasedAnomalyDetector
from ..observability import exposition, flightrec, spans, stitch, tracing
from ..observability import incidents as incidents_engine
from ..observability import ledger as control_ledger
from ..observability import slo as slo_engine
from ..observability import telemetry as telemetry_engine
from ..observability.registry import REGISTRY
from ..parallel.mesh import fleet_mesh
from ..resilience import deadline, faults, qos
from ..resilience.admission import (
    DRAINING_HEADER,
    AdmissionController,
    AdmissionRejected,
    QuotaExceeded,
)
from ..resilience.deadline import DeadlineExceeded
from ..resilience.quarantine import Quarantine
from ..serializer.persistence import dumps, estimators, load, load_metadata
from ..store.generations import (
    current_generation,
    is_artifact_dir,
    read_fleet_index,
    resolve_artifact_dir,
    scan_models_dir,
)
from ..utils.backend import DeviceLike, resolve_device
from .engine import ScoreResult, ServingEngine, SpillNotLiftable
from .httpd import AppHTTPServer, Response

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
    "bulk/anomaly/prediction": "bulk-anomaly",
    "download-model": "download-model",
}
_ROOT_ENDPOINTS = {
    "/healthz": "healthz",
    "/metadata": "metadata",
    "/metrics": "metrics",
    "/models": "models",
    "/reload": "reload",
    "/prefetch": "prefetch",
    "/layout": "layout",
    "/tenants": "tenants",
    "/prediction": "prediction",
    "/anomaly/prediction": "anomaly",
    "/bulk/anomaly/prediction": "bulk-anomaly",
    "/debug/requests": "debug-requests",
    "/download-model": "download-model",
    "/slo": "slo",
    "/telemetry": "telemetry",
    "/incidents": "incidents",
    "/autopilot": "autopilot",
}
_MACHINE_ROUTE = re.compile(
    r"^/gordo/v0/(?P<project>[^/]+)/(?P<machine>[^/]+)/(?P<endpoint>"
    + "|".join(re.escape(e) for e in _MACHINE_ENDPOINTS)
    + ")$"
)
_DEBUG_REQUEST_ROUTE = re.compile(r"^/debug/requests/(?P<trace_id>[^/]+)$")
_INCIDENT_ROUTE = re.compile(r"^/incidents/(?P<incident_id>[^/]+)$")
_AUTOPILOT_ROUTE = re.compile(r"^/autopilot/(?P<action>[^/]+)$")
_SCORING_ENDPOINTS = ("prediction", "anomaly", "bulk-anomaly")
# probe and scrape endpoints stay out of the flight recorder: a watchman
# polling N machines would flush every scoring trace out of the ring
_UNRECORDED_ENDPOINTS = ("healthz", "metrics", "slo", "tenants", "autopilot", "autopilot-action",
                         "debug-requests", "debug-request")
# probe endpoints log at DEBUG: pollers would double the steady log volume
_QUIET_ENDPOINTS = ("healthz", "metrics", "slo", "autopilot")
_PARQUET_TYPES = (
    "application/octet-stream",
    "application/x-parquet",
    "application/vnd.apache.parquet",
)


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
        # a `model-load:<name>:error` fault stands in for a broken artifact
        faults.inject("model-load", name)
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


class _ServerState:
    """Machines and their engine, swapped as ONE reference on reload, so a
    request never sees machines and engine of different generations. Each
    scoring request ``enter()``s the state it read and ``exit()``s when
    done; a reload ``drain()``s the old state before closing its engine."""

    __slots__ = ("machines", "single", "engine", "lazy_names", "_inflight", "_cond")

    def __init__(self, machines: Dict[str, _Machine], single: bool, device,
                 lazy_loaders: Optional[Dict[str, Callable[[], Dict[str, Any]]]] = None,
                 compile_cache: Any = None, mesh_shard: Optional[Tuple[int, int]] = None,
                 mesh_remote: Optional[set] = None, shard_fleet: bool = False):
        self._inflight = 0
        self._cond = lockcheck.named_condition("server.state_cond")
        self.machines = machines
        self.single = next(iter(machines.values())) if single else None
        # the fleet index's machines that are not materialised: the engine
        # loads each through its spill tier at the first touch
        lazy_loaders = lazy_loaders or {}
        self.lazy_names = frozenset(lazy_loaders)
        # capacity mode: every bucket's stack split over the local devices
        # of the server's device type, at the cost of a gather per cold
        # dispatch (engine.py's shard mode)
        mesh = fleet_mesh(device=device.type) if shard_fleet else None
        self.engine = ServingEngine(
            {name: m.model for name, m in machines.items()},
            target_cols={name: m.target_columns for name, m in machines.items()},
            precisions={name: m.precision for name, m in machines.items()},
            quantized={name: m.quantized for name, m in machines.items()
                       if m.quantized is not None},
            device=device,
            lazy=lazy_loaders,
            compile_cache=compile_cache,
            # this process's (shard, shards) in a serving mesh: the eager
            # machines are its owned slice, and mesh_remote names the other
            # shards' machines behind the spill fallback rung (an owned lazy
            # machine stays "owned" in the accounting)
            mesh_shard=mesh_shard,
            mesh_remote=mesh_remote,
            mesh=mesh,
        )
        for name, reason in self.engine.skipped.items():
            logger.warning("Machine %r is scored on the host path: %s", name, reason)
        if lazy_loaders:
            logger.info("Lazy fleet boot: %d machine(s) eager, %d lazy behind the host-RAM "
                        "spill tier (GORDO_HOST_CACHE_MB=%d)", len(machines), len(lazy_loaders),
                        self.engine.host_cache_mb)
        # the dispatch mode this state serves with, readable from the log
        stats = self.engine.stats()
        megabatch = stats["megabatch"]
        if megabatch["enabled"]:
            logger.info("Cross-machine megabatching ON: fill window %d us, %d/%d machines "
                        "resident in the stacked program(s)", megabatch["fill_window_us"],
                        megabatch["resident_machines"], len(self.engine.machines()))
        else:
            logger.info("Cross-machine megabatching off (%s)",
                        "shard mode" if shard_fleet else "disabled by config")
        if mesh is not None:
            logger.info("Shard mode: every bucket's stack split over %d device(s) of %s, hot "
                        "cache of %d machine(s) per bucket", len(mesh), device.type,
                        self.engine.hot_cap)
        ladder = stats["precision"]["machines"]
        if set(ladder) - {"f32"}:
            logger.info("Precision ladder: %s",
                        ", ".join(f"{k}={v}" for k, v in sorted(ladder.items())))

    def enter(self) -> None:
        with self._cond:
            lockcheck.assert_guard("server.state_cond")
            self._inflight += 1

    def exit(self) -> None:
        with self._cond:
            lockcheck.assert_guard("server.state_cond")
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
    directory; reload then has nothing to rescan), a directory of them (a
    fleet: a machine that fails to load is quarantined and the rest serve;
    ``POST /reload`` rescans it), or a mapping ``{name: artifact dir}``
    (a fleet of those machines, kept through every reload; ``models_root``
    adds the artifacts under that directory and is what reload rescans).
    The tenant table is ``GORDO_TENANTS``. ``max_inflight`` defaults to
    ``GORDO_MAX_INFLIGHT`` (64), the admission queue to ``GORDO_MAX_QUEUE``
    (32); ``quarantine_cooldown``: seconds before a quarantined machine may
    be probed; ``drain_timeout``: how long a reload or a shutdown waits for
    in-flight requests. ``lazy_boot`` (default ``GORDO_LAZY_BOOT``, off)
    boots a models directory from its fleet index, most machines lazy (see
    the module docstring). ``compile_cache_store``: the root of the store
    the kernel libraries resolve through (``"off"``: none); default
    ``GORDO_COMPILE_CACHE_STORE``, else ``<models_root>/.compile-cache/
    torch-cuda`` (``compile_cache.resolve_store``). ``mesh_shards`` /
    ``mesh_shard`` (defaults ``GORDO_MESH_SHARDS`` / ``GORDO_MESH_SHARD``, the
    shard falling back to ``worker_id`` mod shards): this process is shard
    ``mesh_shard`` of a fleet-sharded serving mesh (see the module
    docstring); 0 shards is single-host serving. ``shard_fleet``: every
    state's engine runs the host-sharded capacity mode (see the module
    docstring), kept across reload and rollback. :meth:`close` drains and
    stops the engine.
    """

    def __init__(
        self,
        models_dir: Union[str, Mapping[str, str]],
        project: str = "project",
        device: DeviceLike = None,
        max_inflight: Optional[int] = None,
        quarantine_cooldown: float = 30.0,
        drain_timeout: float = 10.0,
        models_root: Optional[str] = None,
        worker_id: Optional[int] = None,
        lazy_boot: Optional[bool] = None,
        compile_cache_store: Optional[str] = None,
        mesh_shards: Optional[int] = None,
        mesh_shard: Optional[int] = None,
        shard_fleet: bool = False,
    ):
        self.device = resolve_device(device)
        # the host-sharded capacity mode of every state this server builds
        self.shard_fleet = bool(shard_fleet)
        if worker_id is None:
            raw_worker = os.environ.get("GORDO_WORKER_ID")
            worker_id = int(raw_worker) if raw_worker else None
        # this process's slot in a fleet tier; its directories and the
        # correlator's role are worker-<id> (0 when unset)
        self.worker_id = worker_id
        self.project = project
        tracing.install_log_record_factory()
        if max_inflight is None:
            max_inflight = int(os.environ.get("GORDO_MAX_INFLIGHT", "64"))
        self.tenants = qos.TenantTable.from_env()
        self.admission = AdmissionController(
            max_inflight=max_inflight,
            max_queue=int(os.environ.get("GORDO_MAX_QUEUE", "32")),
            queue_timeout=float(os.environ.get("GORDO_QUEUE_TIMEOUT", "1.0")),
            tenants=self.tenants,
        )
        self.quarantine = Quarantine(cooldown=quarantine_cooldown)
        self.drain_timeout = drain_timeout
        # values the autopilot applied: a reload's new engine inherits them
        self._tuning: Dict[str, int] = {}
        # the layout plan last applied through /layout (fingerprint,
        # residency pins, cap, what applying did): a reload's new engine is
        # re-pinned from it
        self._layout: Dict[str, Any] = {}
        # machines that failed to load, name -> dir: quarantined, retried
        # at every reload
        self._quarantined_dirs: Dict[str, str] = {}
        # machines named explicitly: reload keeps them, wherever they live
        self._pinned: Dict[str, str] = {}
        # the lazy half of a lazily booted fleet: name -> model dir, and
        # each one's index generation, reload's staleness signal
        self._lazy_dirs: Dict[str, str] = {}
        self._lazy_gens: Dict[str, Any] = {}
        self._reload_lock = lockcheck.named_lock("server.reload")
        if isinstance(models_dir, Mapping):
            self.models_root = models_root
            self._pinned = dict(models_dir)
        elif is_artifact_dir(models_dir):
            self.models_root = None
        else:
            self.models_root = models_dir
        self._resolve_mesh(mesh_shards, mesh_shard)
        # the kernel-library store every state's engine (boot, reload,
        # rollback) resolves its libraries through
        self.compile_cache = resolve_store(compile_cache_store, self.models_root)
        # before the machines load, so their quarantine events land there
        ledger_dir = os.environ.get("GORDO_LEDGER_DIR")
        if ledger_dir:
            # one GORDO_LEDGER_DIR serves the whole tier: two writers in one
            # segment directory would interleave torn tails
            ledger_dir = os.path.join(ledger_dir, self._role)
        elif self.models_root:
            ledger_dir = os.path.join(self.models_root, ".telemetry", f"ledger-{self._role}")
        control_ledger.configure(ledger_dir or None)
        if lazy_boot is None:
            lazy_boot = os.environ.get("GORDO_LAZY_BOOT", "0").strip().lower() in (
                "1", "true", "on", "yes")
        self.lazy_boot = bool(lazy_boot) and bool(self.models_root)
        # a server of one artifact answers the bare paths
        self._single = not isinstance(models_dir, Mapping) and self.models_root is None
        if self._single:
            name = os.path.basename(os.path.normpath(models_dir))
            machines = {name: _Machine(name, models_dir)}
        else:
            machines = {}
            eager_dirs, lazy_dirs, lazy_gens = self._partition()
            # machines other shards own never load here: they go behind the
            # spill tier (the fallback rung), loaders built like any lazy one's
            self._mesh_partition(eager_dirs, lazy_dirs, lazy_gens)
            self._lazy_dirs = lazy_dirs
            self._lazy_gens = {name: lazy_gens.get(name) for name in lazy_dirs}
            for name, path in eager_dirs.items():
                try:
                    machines[name] = _Machine(name, path)
                except Exception as exc:  # noqa: BLE001 - one bad artifact must not stop the fleet
                    logger.exception("Failed to load machine %r", name)
                    self.quarantine.quarantine(name, f"{type(exc).__name__}: {exc}", "load")
                    self._quarantined_dirs[name] = path
            if not machines and not lazy_dirs:
                raise ValueError(
                    f"no model artifact under {self.models_root or sorted(self._pinned)} "
                    f"loaded; quarantined: {sorted(self._quarantined_dirs)}"
                )
        self._state = self._new_state(machines)
        self._start_control_loops(ledger_dir or None)
        logger.info("ModelServer serving %d model(s): %s%s", len(machines), sorted(machines),
                    f" and {len(self._lazy_dirs)} lazy" if self._lazy_dirs else "")

    def _start_control_loops(self, ledger_dir: Optional[str]) -> None:
        """The SLO evaluator over the request series this server records
        (scoring latency and availability, then each tenant class and
        declared tenant), the autopilot over the engine's and the gate's
        knobs, the telemetry warehouse, and the incident correlator beside
        the ledger, fed by the evaluator's breach edges."""
        self.slo = (
            slo_engine.SLOEvaluator(
                slo_engine.server_objectives()
                + slo_engine.tenant_objectives(self.tenants.specs())
            )
            if slo_engine.enabled() else None
        )
        self.autopilot = build_server_autopilot(self)
        self.telemetry: Optional[telemetry_engine.TelemetryWarehouse] = None
        if telemetry_engine.enabled():
            warehouse_dir = os.environ.get("GORDO_TELEMETRY_DIR")
            if not warehouse_dir and self.models_root:
                warehouse_dir = os.path.join(self.models_root, ".telemetry", self._role)
            self.telemetry = telemetry_engine.TelemetryWarehouse(
                directory=warehouse_dir or None,
                worker=str(self.worker_id) if self.worker_id is not None else "",
                cost_sampler=lambda: telemetry_engine.sample_costs(self._state.engine,
                                                                   self.compile_cache),
            )
        self.incidents = incidents_engine.IncidentCorrelator(
            directory=os.path.join(ledger_dir, "incidents") if ledger_dir else None,
            warehouse=self.telemetry,
            layout_fingerprint=lambda: self._layout.get("fingerprint"),
            role=self._role,
        )
        if self.slo is not None:
            self.slo.breach_hook = self.incidents.on_breach

    @property
    def _role(self) -> str:
        return f"worker-{self.worker_id if self.worker_id is not None else 0}"

    def _scan(self) -> Dict[str, str]:
        """``{name: artifact dir}``: the pinned machines, then every artifact
        under ``models_root`` that is not one of them."""
        found = dict(self._pinned)
        if self.models_root:
            for name, path in scan_models_dir(self.models_root).items():
                found.setdefault(name, path)
        return found

    def _partition(self) -> Tuple[Dict[str, str], Dict[str, str], Dict[str, Any]]:
        """``(eager dirs, lazy dirs, index generations)``. Under lazy boot,
        from the fleet index: the pinned machines and the index's first
        ``GORDO_BOOT_EAGER`` names (sorted; they warm the common
        architecture's kernels at boot) are eager, the rest lazy. Else, or
        when the index is absent or damaged (which turns lazy boot off: a
        bad index must never make a fleet unbootable), the scan, all
        eager."""
        index = read_fleet_index(self.models_root) if self.lazy_boot else None
        if self.lazy_boot and index is None:
            logger.warning("Lazy boot: no readable fleet index at %s; scanning instead",
                           self.models_root)
            self.lazy_boot = False
        if not self.lazy_boot:
            return self._scan(), {}, {}
        try:
            eager_n = int(os.environ.get("GORDO_BOOT_EAGER", "0"))
        except ValueError:
            eager_n = 0
        eager, lazy, gens = dict(self._pinned), {}, {}
        for i, name in enumerate(sorted(index)):
            entry = index[name] if isinstance(index[name], dict) else {}
            gens[name] = entry.get("generation")
            path = os.path.join(self.models_root, entry.get("path") or name)
            if i < eager_n:
                eager.setdefault(name, path)
            elif name not in eager:
                lazy[name] = path
        return eager, lazy, gens

    # -- the fleet-sharded serving mesh ------------------------------------------
    def _resolve_mesh(self, mesh_shards: Optional[int], mesh_shard: Optional[int]) -> None:
        """This process's place in the serving mesh: ``mesh_shards`` (default
        ``GORDO_MESH_SHARDS``) and ``mesh_shard`` (default ``GORDO_MESH_SHARD``,
        else the worker id mod the shards). It serves single-host, as without
        a mesh, when no shard is named, when the shard lies outside the mesh,
        or without a models root to partition (one artifact, or machines
        named explicitly with no root: registration overrides the layout)."""
        from ..parallel import shard_plan

        if mesh_shards is None:
            mesh_shards = shard_plan.mesh_shards_env()
        if mesh_shard is None:
            mesh_shard = shard_plan.mesh_shard_env()
        self.mesh_shards = max(0, int(mesh_shards or 0))
        self.mesh_shard: Optional[int] = None
        self._mesh_plan = None
        # machines OTHER shards own, moved behind the spill tier by
        # _mesh_partition: the engine's owned-vs-fallback boundary
        self._mesh_remote: set = set()
        if not self.mesh_shards:
            return
        if not self.models_root:
            logger.warning("Mesh serving needs --models-dir (a rescannable fleet root); "
                           "explicitly registered machines serve single-host")
            self.mesh_shards = 0
            return
        if mesh_shard is None and self.worker_id is not None:
            mesh_shard = shard_plan.worker_shard(self.worker_id, self.mesh_shards)
        if mesh_shard is None:
            logger.warning("GORDO_MESH_SHARDS=%d but neither GORDO_MESH_SHARD nor a worker "
                           "id names this process's shard; serving single-host",
                           self.mesh_shards)
            self.mesh_shards = 0
        elif not 0 <= int(mesh_shard) < self.mesh_shards:
            logger.warning("GORDO_MESH_SHARD=%s outside the %d-shard mesh; serving "
                           "single-host", mesh_shard, self.mesh_shards)
            self.mesh_shards = 0
        else:
            self.mesh_shard = int(mesh_shard)
            self._mesh_plan = shard_plan.resolve_plan(self.mesh_shards)

    def _mesh_tuple(self) -> Optional[Tuple[int, int]]:
        """(shard, shards) when this server is one shard of a serving mesh,
        else None: the engine's accounting tag."""
        if self._mesh_plan is None or self.mesh_shard is None:
            return None
        return (self.mesh_shard, self.mesh_shards)

    def _mesh_partition(self, eager_dirs: Dict[str, str], lazy_dirs: Dict[str, str],
                        lazy_gens: Dict[str, Any]) -> None:
        """Apply the shard plan to a resolved fleet: machines other shards own
        move from the eager set behind the host-RAM spill tier (the fallback
        rung: still servable here if their owner dies, at spill cost instead
        of an error). The declared policy keeps a small fleet replicated
        everywhere; each moved machine's artifact mtime is its staleness
        signal, so a reload drops a rebuilt machine's cached bundle. A
        machine registered outside ``models_root`` stays eager whatever shard
        owns it: a rescan cannot find its directory, so behind the
        (rescan-rebuilt) lazy set it would drop at the first reload.
        ``self._mesh_remote`` records the moved names."""
        self._mesh_remote = set()
        if self._mesh_plan is None or self.mesh_shard is None:
            return
        from ..parallel.shard_plan import POLICY_SHARDED

        fleet = sorted(set(eager_dirs) | set(lazy_dirs))
        if self._mesh_plan.policy(len(fleet)) != POLICY_SHARDED:
            logger.info("Mesh serving: %d-machine fleet below the sharding threshold (%d): "
                        "replicated on every shard", len(fleet),
                        self._mesh_plan.min_shard_machines)
            return
        root_real = os.path.realpath(self.models_root) + os.sep
        moved = 0
        for name in sorted(eager_dirs):
            if self._mesh_plan.shard_of(name) == self.mesh_shard:
                continue
            path = eager_dirs[name]
            if not (os.path.realpath(path) + os.sep).startswith(root_real):
                continue  # pinned outside the root: registration wins
            eager_dirs.pop(name)
            lazy_dirs[name] = path
            try:
                lazy_gens[name] = _artifact_mtime(path)
            except OSError:
                lazy_gens.setdefault(name, None)
            self._mesh_remote.add(name)
            moved += 1
        # lazily registered machines other shards own (an index boot) are
        # remote too: the accounting boundary is ownership, not the tier
        self._mesh_remote.update(name for name in lazy_dirs
                                 if self._mesh_plan.shard_of(name) != self.mesh_shard)
        logger.info("Mesh-sharded serving: shard %d/%d owns %d of %d machine(s); %d reachable "
                    "via the spill fallback rung", self.mesh_shard, self.mesh_shards,
                    len(eager_dirs), len(fleet), moved)

    def _lazy_loaders(self) -> Dict[str, Callable[[], Dict[str, Any]]]:
        """A loader per lazy machine, fresh for each state: a reload's new
        engine starts with a cold host cache, so no bundle of a dropped
        generation is served."""
        return {name: self._lazy_loader(name, path) for name, path in self._lazy_dirs.items()}

    @staticmethod
    def _lazy_loader(name: str, path: str) -> Callable[[], Dict[str, Any]]:
        def load_lazy() -> Dict[str, Any]:
            # the store path the spill tier fronts: _Machine verifies the
            # manifest before deserialising (the first touch's check), and
            # parks in the bundle so the metadata routes need no second load
            machine = _Machine(name, path)
            nbytes = 0
            try:
                with os.scandir(resolve_artifact_dir(path)) as entries:
                    nbytes = sum(e.stat().st_size for e in entries if e.is_file())
            except OSError:
                pass
            return {
                "model": machine.model,
                "target_cols": machine.target_columns,
                "precision": machine.precision,
                "quantized": machine.quantized,
                "context": machine,
                # the host copy of the model parked in the bundle, for the
                # cache's byte ledger
                "nbytes": nbytes,
            }

        return load_lazy

    def _materialize_lazy(self, name: str, state: _ServerState) -> _Machine:
        """A lazy machine's ``_Machine``: off the host cache without counting
        a lookup (the engine counts the request's own), else through the
        spill tier's store path. A load that fails quarantines the machine
        as an eager boot's failure would, with the same probe recovery."""
        bundle = state.engine.host_cache.peek(name)
        if bundle is not None:
            return bundle["context"]
        probing = False
        if self.quarantine.is_quarantined(name):
            if not self.quarantine.probe_allowed(name):
                self._abort_quarantined(name)
            probing = True
            logger.info("Quarantine recovery probe (lazy load) for machine %r", name)
        try:
            bundle = state.engine.spill_bundle(name)
        except Exception as exc:  # noqa: BLE001 - one broken artifact must not stop the fleet
            logger.exception("Lazy load of machine %r failed", name)
            self.quarantine.quarantine(name, f"{type(exc).__name__}: {exc}", "load")
            self._abort_quarantined(name)
        if probing:
            self.quarantine.recover(name)
            logger.info("Machine %r recovered from quarantine", name)
        return bundle["context"]

    def _new_state(self, machines: Dict[str, _Machine]) -> _ServerState:
        """A state for ``machines`` (and the lazy ones) with its engine
        warmed up (kernel libraries built, cuBLAS handles made) before it
        takes traffic."""
        state = _ServerState(machines, single=self._single, device=self.device,
                             lazy_loaders=self._lazy_loaders(),
                             compile_cache=self.compile_cache,
                             mesh_shard=self._mesh_tuple(),
                             mesh_remote=set(self._mesh_remote),
                             shard_fleet=self.shard_fleet)
        state.engine.warmup()
        # the autopilot's applied values carry over: a new engine reads the
        # environment's, which would revert every adaptation at a reload
        engine_tuning = {key: value for key, value in self._tuning.items()
                         if key not in ("max_inflight", "shed_level")}
        if engine_tuning:
            state.engine.apply_tuning(**engine_tuning)
        # so does the applied layout plan's resident set; machines gone from
        # the new scan are reported by pin_residency and skipped
        if self._layout.get("resident"):
            state.engine.pin_residency(self._layout["resident"])
        return state

    # the current state's parts
    @property
    def machines(self) -> Dict[str, _Machine]:
        return self._state.machines

    @property
    def engine(self) -> ServingEngine:
        return self._state.engine

    def quiesce(self, drain_timeout: Optional[float] = None) -> bool:
        """The graceful-shutdown sequence (SIGTERM, then this, then exit):
        close the admission gate (new requests shed at once, stamped with
        the draining marker so a router re-routes them), wait for every
        in-flight request to finish, then drain the engine's dispatch
        pipeline. Afterwards, stopping the process drops no accepted
        request. Returns False when the drain timed out (stragglers are
        logged; the caller exits anyway)."""
        if drain_timeout is None:
            drain_timeout = self.drain_timeout
        self.admission.close("draining for shutdown")
        logger.info("Draining: admission closed; waiting up to %.1fs for in-flight requests",
                    drain_timeout)
        state = self._state
        drained = state.drain(drain_timeout)
        if not drained:
            logger.warning("Drain timed out after %.1fs with requests still in flight; "
                           "shutting down anyway", drain_timeout)
        try:
            state.engine.quiesce()
        except Exception:  # noqa: BLE001 - the process is going down anyway
            logger.warning("Engine quiesce failed during shutdown", exc_info=True)
        logger.info("Drain complete (clean=%s)", drained)
        return drained

    def close(self) -> None:
        """Stop admitting, let admitted requests finish (up to
        ``drain_timeout``), then stop the engine's collector threads.
        Idempotent, and cheap after :meth:`quiesce`."""
        if self.admission.closed is None:
            self.admission.close("shutting down")
        if not self.admission.drain(self.drain_timeout):
            logger.warning("Shutdown: requests still in flight after %.1fs", self.drain_timeout)
        self._state.engine.close()
        if self.telemetry is not None:
            self.telemetry.close()

    def apply_tuning(
        self,
        dispatch_depth: Optional[int] = None,
        fill_window_us: Optional[int] = None,
        max_inflight: Optional[int] = None,
        megabatch_residency: Optional[int] = None,
        shed_level: Optional[int] = None,
    ) -> Dict[str, Any]:
        """The autopilot's actuation seam: land knob values on the live
        serving state without a reload. The gate resizes under its own
        condition; engine values go through the engine's setters. Applied
        values are remembered, so a reload's new engine inherits them."""
        applied: Dict[str, Any] = {}
        if max_inflight is not None:
            applied["max_inflight"] = self.admission.set_max_inflight(max_inflight)
            self._tuning["max_inflight"] = applied["max_inflight"]
        if shed_level is not None:
            # the shed ladder tightens only the bulk class's watermark
            applied["shed_level"] = self.admission.set_shed_level(shed_level)
            self._tuning["shed_level"] = applied["shed_level"]
        engine_values = {
            key: value for key, value in (
                ("dispatch_depth", dispatch_depth),
                ("fill_window_us", fill_window_us),
                ("megabatch_residency", megabatch_residency),
            ) if value is not None
        }
        if engine_values:
            engine_applied = self._state.engine.apply_tuning(**engine_values)
            applied.update(engine_applied)
            for key, value in engine_applied.items():
                if value is not None:
                    self._tuning[key] = value
        return applied

    # -- reload ----------------------------------------------------------------
    def reload(self) -> Dict[str, Any]:
        """Rescan the models directory and swap in the new fleet as ONE
        state: new machines load, vanished ones drop, machines whose
        artifacts changed on disk re-load. A directory that fails to load
        is skipped and reported, never fatal: the machine keeps its
        previous artifact if it had one, else is quarantined. Under lazy
        boot the fleet index is re-read: a materialised machine stays
        eager, lazy membership changes count as added or removed, and a
        lazy machine whose index generation moved has its cached bundle
        dropped and counts as refreshed (its next touch pays the store
        path)."""
        if not self.models_root:
            raise ValueError(
                "Server was not started with a models directory; reload has nothing to rescan"
            )
        with self._reload_lock:
            state = self._state
            seen, new_lazy, new_gens = self._partition()
            for name in state.machines:
                if name in new_lazy:  # materialised: stays eager
                    seen[name] = new_lazy.pop(name)
            # the rescan re-derives the SAME partition: machines other shards
            # own go back behind the spill tier, a pinned in-root machine too
            # once the partition re-homes it (the fleet crossed the sharding
            # threshold), which would otherwise be served twice
            self._mesh_partition(seen, new_lazy, new_gens)
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
            # the lazy half: membership changes swap the state like eager
            # ones; a moved index generation drops the cached bundle, so the
            # next touch verifies and loads the new generation (no I/O here)
            added += [name for name in new_lazy if name not in state.lazy_names]
            removed = sorted(set(removed) | {
                name for name in state.lazy_names if name not in new_lazy and name not in machines})
            lazy_refreshed = [name for name in new_lazy if name in state.lazy_names
                              and self._lazy_gens.get(name) != new_gens.get(name)]
            for name in lazy_refreshed:
                state.engine.host_cache.drop(name)
            self._lazy_gens = {name: new_gens.get(name) for name in new_lazy}
            if added or removed or refreshed:
                self._lazy_dirs = new_lazy
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
                "refreshed": sorted(set(refreshed) | set(lazy_refreshed)),
                "errors": errors,
                "total": len(machines) + len(new_lazy),
            }

    # -- dispatch --------------------------------------------------------------
    def handle(self, method: str, raw_path: str, headers: Mapping[str, str],
               body: bytes) -> Response:
        """Answer one request: adopt or mint its trace id, bind its deadline
        and tenant, begin its timeline, route it, map the resilience
        exceptions to 429/503/504, record its latency, status and tenant
        outcome, and finish and keep its timeline."""
        started = time.perf_counter()
        headers = {key.lower(): value for key, value in headers.items()}
        path, _, query = raw_path.partition("?")
        params = {key: values[-1] for key, values in urllib.parse.parse_qs(query).items()}
        trace_id = headers.get(tracing.TRACE_HEADER.lower()) or tracing.new_trace_id()
        token = tracing.set_trace_id(trace_id)
        budget = deadline.parse_header(headers.get(deadline.DEADLINE_HEADER.lower()))
        deadline_token = deadline.set_deadline(budget) if budget is not None else None
        # the tenant (a declared name or API key, else "default"), bound for
        # the admission gate's quota and watermark and the engine's submit
        tenant_spec = self.tenants.resolve(headers.get(qos.TENANT_HEADER.lower()))
        qos_token = qos.set_current(tenant_spec)
        shed = False
        # the request's timeline; the engine's leader and collector get it
        # through each item's captured span context
        timeline = timeline_token = None
        if flightrec.RECORDER.enabled:
            timeline, timeline_token = spans.begin(trace_id, method=method, path=path)
        # ONE state per request: a reload may swap it meanwhile
        state = self._state
        endpoint = "error"
        try:
            try:
                endpoint, args = self._match(path)
                response = self._dispatch(method, endpoint, args, params, headers, body, state)
            except QuotaExceeded as exc:
                # this tenant's quota, not overload: 429 with the bucket's
                # refill time
                spans.event("quota_exceeded", tenant=exc.tenant, retry_after=exc.retry_after)
                response = _json({"error": f"quota exhausted: {exc}", "tenant": exc.tenant}, 429,
                                 {"Retry-After": _retry_after(exc.retry_after)})
            except AdmissionRejected as exc:
                shed = True
                spans.event("admission_rejected", reason=str(exc), retry_after=exc.retry_after,
                            tenant=tenant_spec.name)
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
            if self.worker_id is not None:
                # which fleet slot answered: a router's placement checks read it
                response.headers["X-Gordo-Worker"] = str(self.worker_id)
            if self.mesh_shard is not None:
                # which mesh shard answered: the owner in steady state; another
                # shard than the plan's owner means the fallback rung served it
                response.headers["X-Gordo-Shard"] = str(self.mesh_shard)
            if self.admission.closed is not None:
                response.headers[DRAINING_HEADER] = "1"
            elapsed = time.perf_counter() - started
            _M_REQUEST_SECONDS.labels(endpoint).observe(elapsed)
            _M_REQUESTS.labels(endpoint, str(response.status)).inc()
            status = response.status
            if endpoint in _SCORING_ENDPOINTS:
                qos.note_request(
                    tenant_spec.name,
                    "bulk" if endpoint == "bulk-anomaly" else tenant_spec.klass,
                    "quota" if status == 429 else "shed" if shed
                    else "ok" if status < 400 else "error",
                )
            if timeline is not None:
                timeline.meta["endpoint"] = endpoint
                timeline.meta["tenant"] = tenant_spec.name
                if self.worker_id is not None:
                    timeline.meta["worker"] = self.worker_id
                if self.mesh_shard is not None:
                    # the router's stitched lane renders per shard
                    timeline.meta["shard"] = self.mesh_shard
                timeline.finish(status=str(status), error=f"HTTP {status}" if status >= 500 else "")
                # only when the caller negotiated it; past the size cap the
                # truncation marker says to pull /debug/requests/<trace_id>
                if headers.get(stitch.TIMELINE_HEADER.lower()):
                    encoded, truncated = stitch.encode_timeline(timeline)
                    if encoded is not None:
                        response.headers[stitch.TIMELINE_HEADER] = encoded
                    else:
                        response.headers[stitch.TIMELINE_TRUNCATED_HEADER] = str(truncated)
                if endpoint not in _UNRECORDED_ENDPOINTS:
                    flightrec.RECORDER.record(timeline)
            logger.log(
                logging.DEBUG if endpoint in _QUIET_ENDPOINTS else logging.INFO,
                "%s %s -> %d in %.1f ms [trace=%s]",
                method, path, status, elapsed * 1000, trace_id,
            )
        finally:
            if timeline_token is not None:
                spans.end(timeline_token)
            qos.reset(qos_token)
            if deadline_token is not None:
                deadline.reset(deadline_token)
            tracing.reset_trace_id(token)
        return response

    @staticmethod
    def _match(path: str) -> Tuple[str, Dict[str, str]]:
        if path in _ROOT_ENDPOINTS:
            return _ROOT_ENDPOINTS[path], {}
        match = _DEBUG_REQUEST_ROUTE.match(path)
        if match is not None:
            return "debug-request", {"trace_id": match["trace_id"]}
        match = _INCIDENT_ROUTE.match(path)
        if match is not None:
            return "incident", {"incident_id": match["incident_id"]}
        match = _AUTOPILOT_ROUTE.match(path)
        if match is not None:
            return "autopilot-action", {"action": match["action"]}
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
        machine = state.machines.get(name)
        if machine is not None:
            return machine
        if name in state.lazy_names:
            # known from the fleet index, not materialised: the first touch
            # verifies and loads it through the spill tier
            return self._materialize_lazy(name, state)
        if self.quarantine.is_quarantined(name):
            # it exists but failed to load: 503 (try later), not 404
            self._abort_quarantined(name)
        raise HTTPError(404, f"Unknown machine {name!r}")

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
            # a scrape ticks the loops: SLO first, so the autopilot reads
            # fresh burn rates, then the warehouse
            if self.slo is not None:
                self.slo.maybe_tick()
            if self.autopilot is not None:
                self.autopilot.maybe_tick()
            if self.telemetry is not None:
                self.telemetry.maybe_tick()
            if params.get("format") == "prometheus":
                # &exemplars=1 opts into OpenMetrics exemplars; the bare
                # scrape stays strict v0.0.4, whose parsers reject them
                text = exposition.render_prometheus(
                    REGISTRY, exemplars=params.get("exemplars") in ("1", "true"))
                return Response(200, text.encode(), exposition.CONTENT_TYPE, {})
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
        if endpoint in ("slo", "telemetry", "incidents", "incident", "autopilot",
                        "autopilot-action"):
            return self._control(method, endpoint, args, params)
        if endpoint == "tenants":
            snapshot = self.tenants.snapshot()
            snapshot["admission"] = self.admission.stats()
            return _json(snapshot)
        if endpoint == "debug-requests":
            try:
                limit = int(params.get("limit", ""))
            except ValueError:
                limit = 0
            return _json(flightrec.RECORDER.summaries(limit=limit or 50))
        if endpoint == "debug-request":
            recorded = flightrec.RECORDER.get(args["trace_id"])
            if recorded is None:
                raise HTTPError(404, f"no recorded timeline for trace {args['trace_id']!r} "
                                     "(rotated out of the flight recorder, or never seen)")
            if params.get("format") == "chrome":
                return _json(recorded.to_chrome_trace())
            return _json(recorded.to_dict())
        if endpoint == "models":
            return _json({"project": self.project,
                          "models": sorted(set(state.machines) | state.lazy_names)})
        if endpoint == "prefetch":
            # a placement hint: background host-cache loads of lazy machines;
            # advisory, the answer says what was queued and nothing waits
            if method != "POST":
                raise HTTPError(405, "POST required")
            try:
                payload = json.loads(body.decode() or "{}")
            except (UnicodeDecodeError, json.JSONDecodeError):
                raise HTTPError(400, "Request body is not valid JSON") from None
            names = payload.get("machines") if isinstance(payload, dict) else None
            if not isinstance(names, list):
                raise HTTPError(400, 'Payload must contain "machines": [...]')
            return _json(state.engine.prefetch([str(n) for n in names]))
        if endpoint == "layout":
            return self._layout_route(method, body, state)
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
        if endpoint == "download-model":
            return Response(200, dumps(machine.model), "application/octet-stream", {})
        # pin THIS state while scoring: a concurrent reload drains it
        # before closing its engine
        state.enter()
        try:
            return self._score_endpoint(method, endpoint, machine, params, headers, body, state)
        finally:
            state.exit()

    def _control(self, method: str, endpoint: str, args: Dict[str, str],
                 params: Dict[str, str]) -> Response:
        """The control loops' routes; each read ticks what it shows."""
        if endpoint == "slo":
            if self.slo is None:
                return _json({"enabled": False})
            self.slo.maybe_tick()
            return _json(self.slo.snapshot(recorder=flightrec.RECORDER))
        if endpoint == "telemetry":
            if self.telemetry is None:
                return _json({"enabled": False})
            self.telemetry.maybe_tick()
            window = telemetry_engine.parse_window(params.get("window")) or 300.0
            view = self.telemetry.view(window=window)
            if params.get("view") == "export":
                return _json(telemetry_engine.build_export(view, window=window))
            return _json(view)
        if endpoint == "incidents":
            # a breach since the last scrape opens its report before this
            # answer renders
            if self.slo is not None:
                self.slo.maybe_tick()
            if params.get("view") == "ledger":
                try:
                    limit = int(params.get("limit", ""))
                except ValueError:
                    limit = 0
                return _json({
                    "ledger": control_ledger.LEDGER.snapshot(),
                    "events": control_ledger.LEDGER.recent(
                        window=telemetry_engine.parse_window(params.get("window")),
                        limit=limit or 200),
                })
            return _json({"incidents": self.incidents.list(),
                          "correlator": self.incidents.snapshot()})
        if endpoint == "incident":
            report = self.incidents.get(args["incident_id"])
            if report is None:
                raise HTTPError(404, f"no incident {args['incident_id']!r} (rotated out of "
                                     "GORDO_INCIDENT_KEEP, or never opened)")
            return _json(report)
        if endpoint == "autopilot":
            if self.autopilot is None:
                return _json(disabled_snapshot())
            # the SLO ticks first, so the controller reads fresh burn rates
            if self.slo is not None:
                self.slo.maybe_tick()
            self.autopilot.maybe_tick()
            return _json(self.autopilot.snapshot())
        # autopilot-action: the runtime kill switch
        if method != "POST":
            raise HTTPError(405, "POST required")
        if self.autopilot is None:
            return _json({**disabled_snapshot(),
                          "error": "hard kill switch active; runtime enable is not possible"},
                         409)
        action = args["action"]
        if action == "enable":
            self.autopilot.enable()
        elif action == "disable":
            self.autopilot.disable(reason="operator via /autopilot/disable")
        else:
            raise HTTPError(404, f"unknown autopilot action {action!r} (enable | disable)")
        return _json(self.autopilot.snapshot())

    def _layout_route(self, method: str, body: bytes, state: _ServerState) -> Response:
        """The layout plan's application seam: the fleet reconciler (or an
        operator) lands this worker's slice of the committed plan here;
        the fingerprint recorded is what ``/healthz`` reports back."""
        if method != "POST":
            return _json({
                "fingerprint": self._layout.get("fingerprint"),
                "resident": list(self._layout.get("resident") or ()),
                "cap": self._layout.get("cap"),
                "applied": self._layout.get("applied"),
            })
        try:
            payload = json.loads(body.decode() or "{}")
        except (UnicodeDecodeError, json.JSONDecodeError):
            raise HTTPError(400, "Request body is not valid JSON") from None
        if not isinstance(payload, dict):
            raise HTTPError(400, "Request body must be a JSON object")
        if payload.get("clear"):
            cleared = state.engine.pin_residency(())
            previous = self._layout.get("fingerprint")
            self._layout = {}
            control_ledger.emit(actor="layout", action="clear-plan", target="worker",
                                before=previous)
            return _json({"cleared": True, "residency": cleared})
        fingerprint = payload.get("fingerprint")
        if not isinstance(fingerprint, str) or not fingerprint:
            raise HTTPError(400, 'Payload must carry the plan "fingerprint"')
        resident = payload.get("resident") or []
        if not isinstance(resident, list):
            raise HTTPError(400, '"resident" must be a list of machine names')
        resident = [str(name) for name in resident]
        applied: Dict[str, Any] = {"residency": state.engine.pin_residency(resident)}
        cap = payload.get("cap")
        if cap is not None:
            applied["tuning"] = self.apply_tuning(megabatch_residency=int(cap))
        hints = payload.get("prefetch") or []
        if isinstance(hints, list) and hints:
            applied["prefetch"] = state.engine.prefetch([str(name) for name in hints])
        previous = self._layout.get("fingerprint")
        self._layout = {
            "fingerprint": fingerprint,
            "resident": resident,
            "cap": int(cap) if cap is not None else None,
            "applied": applied,
        }
        control_ledger.emit(actor="layout", action="apply-plan", target="worker",
                            before=previous, after=fingerprint,
                            reason=f"{len(resident)} pin(s), cap {cap}")
        return _json({"fingerprint": fingerprint, "applied": applied})

    def _healthz(self, args: Dict[str, str], state: _ServerState) -> Response:
        name = args.get("machine")
        if name is not None:
            if (name in state.lazy_names and name not in state.machines
                    and args.get("project") == self.project
                    and not self.quarantine.is_quarantined(name)):
                # a probe never loads a lazy machine (a watchman sweeping the
                # fleet would thrash the tier): it answers off the host cache
                # without touching its order or counters, or as "lazy"
                bundle = state.engine.host_cache.peek(name)
                if bundle is None:
                    return _json({"ok": True, "status": "lazy", "lazy": True, "resident": False,
                                  "generation": None, "verified": None, "precision": None})
                served = bundle["context"]
                return _json({"ok": True, "status": "ok", "lazy": True, "resident": True,
                              "generation": served.generation, "verified": True,
                              "precision": served.precision})
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
        ready = bool(state.machines or state.lazy_names) and not draining
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
                "worker_id": self.worker_id,
                # this process's slice of the serving mesh: owned machines
                # stack eagerly, the rest serve through the spill fallback
                # rung (null: single-host)
                "mesh": (
                    {
                        "shard": self.mesh_shard,
                        "shards": self.mesh_shards,
                        "owned": len(state.machines),
                        "remote_or_lazy": len(state.lazy_names),
                    }
                    if self.mesh_shard is not None else None
                ),
                "machines": sorted(state.machines),
                # machines the engine cannot lift, with the reason: the host
                # path scores them
                "skipped": dict(state.engine.skipped),
                # the layout plan this worker applied (null: none), the fleet
                # reconciler's convergence signal for its layout class
                "layout": self._layout.get("fingerprint"),
                "store": {
                    "verified": len(state.machines),
                    # the index's machines not touched yet: verified at the
                    # first touch
                    "lazy": len(state.lazy_names),
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
        the handler. Success clears the machine's health marks. The bulk
        endpoint scores in the bulk class whatever the tenant's class (its
        quota stays the tenant's own), rebound here so the engine reads it
        at submit."""
        name = machine.name
        probing = False
        if self.quarantine.is_quarantined(name):
            if not self.quarantine.probe_allowed(name):
                self._abort_quarantined(name)
            probing = True  # cooldown elapsed: this request is the probe
            logger.info("Quarantine recovery probe for machine %r", name)
        bulk_token = None
        if endpoint == "bulk-anomaly":
            spec = qos.current() or self.tenants.default
            if spec.klass != "bulk":
                bulk_token = qos.set_current(qos.as_class(spec, "bulk"))
        try:
            # the gate wait itself, so a queued request's timeline shows it
            with spans.stage("admission"):
                admitted = self.admission.admit()
            with admitted:
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
        finally:
            if bulk_token is not None:
                qos.reset(bulk_token)
        if probing:
            self.quarantine.recover(name)
            logger.info("Machine %r recovered from quarantine", name)
        else:
            self.quarantine.clear_suspect(name)
        return response

    @staticmethod
    def _parse_X(method: str, machine: _Machine, headers: Dict[str, str],
                 body: bytes) -> Tuple[np.ndarray, Optional[List[str]]]:
        """The body's rows and, for a parquet table with a datetime index,
        their timestamps."""
        if method != "POST":
            raise HTTPError(405, "POST required")
        content_type = wire.content_type_of(headers.get("content-type"))
        # generic octet-stream is parquet only with the parquet magic: a
        # client posting JSON under that type keeps working
        if content_type in _PARQUET_TYPES and (
            content_type != "application/octet-stream" or body[:4] == b"PAR1"
        ):
            return _parse_parquet(body, machine.tag_list)
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
        return arr, None

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
        X, _ = self._parse_X(method, machine, headers, body)
        self._validate_X(X, machine)

        def run():
            if state.engine.can_score(machine.name):
                try:
                    return state.engine.predict(machine.name, X)
                except SpillNotLiftable:
                    pass  # a lazy machine the engine cannot lift: the host path
            # the host path: the engine's deadline check does not cover it
            deadline.check("server.predict")
            return np.asarray(machine.model.predict(X))

        output = self._guarded(machine, run, "Prediction failed")
        return self._scored_response(headers, {"model-input": X, "model-output": output})

    def _anomaly(self, method: str, machine: _Machine, params: Dict[str, str],
                 headers: Dict[str, str], body: bytes, state: _ServerState) -> Response:
        model = machine.model
        if not isinstance(model, DiffBasedAnomalyDetector):
            raise HTTPError(422, f"Model for machine {machine.name!r} is not an anomaly "
                                 "detector; use /prediction")
        start, end = params.get("start"), params.get("end")
        if start or end:
            X, timestamps = self._fetch_range(machine, start, end)
        else:
            X, timestamps = self._parse_X(method, machine, headers, body)
            self._validate_X(X, machine)
        scored = self._guarded(machine, lambda: self._score(machine, X, state),
                               "Anomaly scoring failed")
        if timestamps is not None:
            # the model scores the last rows: a window of L rows scores its
            # last one (models/anomaly/diff.py:_tail_align)
            timestamps = timestamps[len(timestamps) - len(scored.total_anomaly_score):]
        extras = {}
        if model.tag_thresholds_ is not None:
            extras = {
                "tag-thresholds": [float(v) for v in model.tag_thresholds_],
                "total-threshold": model.total_threshold_,
            }
        return self._scored_response(headers, dict(zip(wire.SCORE_FIELDS, scored)), extras,
                                     timestamps)

    @staticmethod
    def _fetch_range(machine: _Machine, start: Optional[str],
                     end: Optional[str]) -> Tuple[np.ndarray, List[str]]:
        """The rows of ``[start, end)``: the build's ``dataset_config`` with
        those dates, fetched in the ``data_fetch`` stage. The deadline is
        checked before the provider: a lake read for an expired request is
        waste."""
        deadline.check("server.data_fetch")
        config = machine.metadata.get("dataset", {}).get("dataset_config")
        if not config:
            raise HTTPError(422, "Build metadata carries no dataset_config; POST data "
                                 "explicitly instead of using ?start&end")
        if not (start and end):
            raise HTTPError(400, "Both ?start and ?end are required")
        config = {**config, "train_start_date": start, "train_end_date": end}
        try:
            with spans.stage("data_fetch", machine=machine.name):
                faults.inject("data-fetch", machine.name)  # a dead lake
                dataset = GordoBaseDataset.from_dict(config)
                X, _ = dataset.get_data()
        except Exception as exc:  # noqa: BLE001 - a provider or config error is the caller's
            raise HTTPError(400, f"Data fetch failed: {exc}") from None
        naive = dataset.train_start_date.tzinfo is None
        return X, wire.iso_timestamps(dataset.index, None if naive else "UTC")

    @staticmethod
    def _score(machine: _Machine, X: np.ndarray, state: _ServerState) -> ScoreResult:
        """The anomaly arrays through the engine when it scores the machine,
        else on the host path: ``model.anomaly``, its transformers in numpy
        and its estimator on the server's device. Either way inside the
        request's ``score`` stage; the host path's span is flat."""
        if state.engine.can_score(machine.name):
            try:
                return state.engine.anomaly(machine.name, X)
            except SpillNotLiftable:
                pass  # a lazy machine the engine cannot lift: the host path
        # the engine's deadline check does not cover the host path
        deadline.check("server.anomaly_host")
        if any(getattr(est, "joint_horizon", False) for est in estimators(machine.model)):
            # a joint forecast predicts horizon x F values per window: no
            # path compares them one row per timestamp
            raise HTTPError(503, f"Machine {machine.name!r} cannot be scored: "
                                 f"{state.engine.host_path_machines().get(machine.name)}")
        cols = machine.target_columns
        X = np.asarray(X, np.float32)
        frame = machine.model.anomaly(X) if cols is None else machine.model.anomaly(
            X, y=X[:, cols])
        return ScoreResult(
            model_input=frame["model-input"],
            model_output=frame["model-output"],
            tag_anomaly_scores=frame["tag-anomaly-scores"],
            total_anomaly_score=np.ravel(frame["total-anomaly-score"]),
        )

    @staticmethod
    def _scored_response(headers: Dict[str, str], arrays: Dict[str, Any],
                         extras: Optional[Dict[str, Any]] = None,
                         timestamps: Optional[List[str]] = None) -> Response:
        """npz when ``Accept`` lists it, else the fast JSON body; the
        timestamps, where there are any, ride in the npz header or beside
        the arrays."""
        arrays = {name: np.asarray(arr) for name, arr in arrays.items()}
        if wire.wants_npz(headers.get("accept")):
            header = dict(extras or {})
            if timestamps is not None:
                header["timestamps"] = timestamps
            _M_WIRE_FORMAT.labels("npz").inc()
            with spans.stage("encode", format="npz"):
                body = wire.encode_npz(arrays, header)
            return Response(200, body, wire.NPZ_CONTENT_TYPE, {})
        _M_WIRE_FORMAT.labels("fast_json").inc()
        with spans.stage("encode", format="fast_json"):
            body = wire.encode_scored_json(arrays, timestamps, extras).encode()
        return Response(200, body, "application/json", {})

    def _guarded(self, machine: _Machine, fn: Callable[[], Any], error_prefix: str) -> Any:
        """One failure taxonomy for scoring: bad input 400, an expired
        deadline 504 with the machine marked suspect, anything else
        quarantines the machine (503) — never a 500 from the engine. The
        call is the request's ``score`` stage."""
        try:
            with spans.stage("score", machine=machine.name):
                return fn()
        except ValueError as exc:
            raise HTTPError(400, f"{error_prefix}: {exc}") from None
        except DeadlineExceeded:
            self.quarantine.mark_suspect(machine.name, "deadline expired at dispatch")
            raise
        except HTTPError:
            raise
        except Exception as exc:  # noqa: BLE001 - isolate THIS machine
            logger.exception("Scoring failed for machine %r; quarantining", machine.name)
            self.quarantine.quarantine(machine.name, f"{type(exc).__name__}: {exc}", "score")
            self._abort_quarantined(machine.name)


def _parse_parquet(body: bytes, tags: Optional[List[str]]) -> Tuple[np.ndarray,
                                                                   Optional[List[str]]]:
    """A parquet body as the reference reads it with pandas: the data
    columns in the build's tag order (else sorted), all numeric; a
    datetime index gives the rows' timestamps."""
    try:
        import pyarrow as pa
        import pyarrow.parquet as pq
    except ImportError:
        raise HTTPError(415, "parquet request bodies need the 'pyarrow' package, which is "
                             "not installed here; send JSON") from None
    try:
        table = pq.read_table(pa.BufferReader(body))
    except Exception as exc:  # noqa: BLE001 - any unreadable body is the caller's
        raise HTTPError(400, f"Request body is not a readable parquet table: {exc}") from None
    index_cols = pandas_index_columns(table)
    columns = [c for c in table.column_names if c not in index_cols]
    tags = tags or sorted(columns)
    missing = [t for t in tags if t not in columns]
    if missing:
        raise HTTPError(400, f"Parquet payload missing tag columns {missing}")
    blocks = []
    for tag in tags:
        column = table.column(tag)
        if not (pa.types.is_integer(column.type) or pa.types.is_floating(column.type)
                or pa.types.is_boolean(column.type) or pa.types.is_decimal(column.type)):
            raise HTTPError(400, "Parquet payload must be all-numeric")
        blocks.append(np.asarray(column.cast(pa.float64()).to_numpy(zero_copy_only=False),
                                 dtype=np.float32))
    arr = np.stack(blocks, axis=1) if blocks else np.zeros((table.num_rows, 0), np.float32)
    timestamps = None
    if len(index_cols) == 1 and pa.types.is_timestamp(table.column(index_cols[0]).type):
        index = table.column(index_cols[0])
        ns = index.cast(pa.timestamp("ns", tz=index.type.tz)).cast(pa.int64())
        timestamps = wire.iso_timestamps(ns.to_numpy(zero_copy_only=False), index.type.tz)
    return arr, timestamps


def make_server(
    models_dir: str, host: str = "127.0.0.1", port: int = 5555,
    device: DeviceLike = None, project: str = "project", **options: Any,
) -> ThreadingHTTPServer:
    """Load every machine under ``models_dir``, warm the engine up and bind
    the HTTP server (``port=0`` picks a free port: read
    ``server.server_address``); ``options`` go to :class:`ModelServer`.
    ``server_close()`` also drains and closes the engine."""
    app = ModelServer(models_dir, project=project, device=device, **options)
    cache = app.compile_cache
    libraries = app.engine.kernel_libraries
    logger.info(
        "Serving engine warm: %d kernel librar%s%s", len(libraries),
        "y" if len(libraries) == 1 else "ies",
        (f" (compile cache {cache.root}: {cache.counters.get('hit', 0)} hit(s), "
         f"{cache.counters.get('write', 0)} write(s))" if cache is not None
         else " (compile cache off)"))
    try:
        httpd = AppHTTPServer((host, port), app)
    except BaseException:
        app.close()
        raise
    httpd.model_server = app  # type: ignore[attr-defined]
    return httpd
