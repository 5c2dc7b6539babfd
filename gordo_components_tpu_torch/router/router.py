"""The routing front tier: one HTTP front in front of N worker processes
(the port's copy of ``gordo_components_tpu/router/router.py``).

Every layer below this one, the stacked engine and its megabatching,
lives inside ONE Python process. The router breaks that ceiling
horizontally: it supervises N full server processes (``workers.py``) and
forwards ``/prediction`` · ``/anomaly`` traffic by consistent-hash
machine→worker placement (``placement.py``), so each machine's requests
land on the worker whose stacked weights already hold it. Hot machines
replicate across ``replicas`` workers (requests rotate among them);
everything else is pinned to exactly one.

Failure handling is re-route, not error: a candidate that is dead,
quarantined, circuit-open, or draining is skipped; a forward that fails
at transport level (or lands on a draining worker's shed) moves to the
next worker in the machine's ring preference order. The breaker board
and quarantine ledger are SHARED with the control plane
(``watchman.control``), so probe failures and routing failures feed the
same circuits, and an ejected worker stops receiving traffic within one
decision, not one probe cycle.

Rolling generation adoption rides ``POST /reload``: canary one worker,
verify it, sweep the rest (``rollout.py``); ``POST /rollback`` swaps
every machine's ``CURRENT`` pointer once on shared disk — atomic
fleet-wide — then runs the same canary→sweep adoption.

Where the port differs, by design: the front is the standard library's
``ThreadingHTTPServer`` (:func:`make_router_server`, the server's own
front) and the routes are matched by hand; forwards take kept-alive
``http.client`` connections from a pool per worker
(:class:`~..utils.http.Session`) in place of a pooled
``requests.Session``. Nothing here imports ``torch``: the router's
process never touches the card.

With a ``models_root`` the router builds the declarative fleet
reconciler (``fleet.wiring.build_router_reconciler``): ``/metrics`` and
``/fleet`` reads tick it, ``/fleet/status`` and ``/fleet/diff`` read it,
``POST /fleet/apply`` commits a spec and ``POST /fleet/rollback``
re-applies the previous revision. Without a ``models_root``, or under
``GORDO_FLEET=0``, ``self.fleet`` is None: ``/fleet`` answers the
disabled snapshot and ``/fleet/<action>`` 409.
"""

from __future__ import annotations

import json
import logging
import math
import os
import re
import time
import urllib.parse
from typing import Any, Dict, List, Mapping, Optional, Tuple

from ..analysis import lockcheck
from ..autopilot import build_router_autopilot, disabled_snapshot
from ..fleet import reconciler as fleet_reconciler
from ..fleet.spec import FleetSpec, SpecError
from ..fleet.wiring import build_router_reconciler
from ..observability import aggregate, exposition, flightrec, spans, stitch, tracing
from ..observability import incidents as incidents_engine
from ..observability import ledger as ledger_engine
from ..observability import slo as slo_engine
from ..observability import telemetry as telemetry_engine
from ..observability.registry import REGISTRY
from ..resilience import qos
from ..server.httpd import AppHTTPServer, Response
from ..store.generations import build_fleet_index
from ..utils import http
from ..watchman.control import DRAINING_HEADER, ControlPlane
from .placement import Placement
from .rollout import RolloutManager
from .workers import WorkerSupervisor

logger = logging.getLogger(__name__)

_M_ROUTED = REGISTRY.counter(
    "gordo_router_requests_total",
    "Requests routed, by worker and outcome (ok = forwarded and "
    "answered; reroute = transport failure, moved to the next worker; "
    "drained = worker shed while draining, moved on; skipped = candidate "
    "not routable; short_circuit = worker circuit open)",
    labels=("worker", "outcome"),
)
_M_FORWARD_SECONDS = REGISTRY.histogram(
    "gordo_router_forward_seconds",
    "Router→worker forward round-trip latency, by worker",
    labels=("worker",),
)
_M_UNROUTABLE = REGISTRY.counter(
    "gordo_router_unroutable_total",
    "Requests that exhausted every worker candidate (answered 503)",
)
_M_STITCH = REGISTRY.counter(
    "gordo_router_stitch_total",
    "Cross-process trace stitching outcomes (merged = worker timeline "
    "merged from the response header; truncated = over the size cap, "
    "pull pending; pulled = fetched from the worker's flight recorder "
    "on read; pull_failed / invalid = fallback misses)",
    labels=("outcome",),
)
_M_AGG_SCRAPES = REGISTRY.counter(
    "gordo_router_aggregate_scrapes_total",
    "Scrape-of-scrapes worker fetches by worker and outcome",
    labels=("worker", "outcome"),
)

# end-to-end headers the worker's answer owns; everything hop-by-hop or
# recomputed by the front is dropped on the way back through the router
_PASS_RESPONSE_HEADERS = (
    "Retry-After",
    DRAINING_HEADER,
    "X-Gordo-Worker",
    # which mesh shard answered (a worker of a fleet-sharded mesh sets it)
    "X-Gordo-Shard",
)
_DROP_FORWARD_HEADERS = frozenset(
    ("host", "connection", "keep-alive", "content-length",
     "transfer-encoding", "upgrade", "te", "trailer", "proxy-authorization")
)
# reads that stay out of the router's flight recorder
_UNRECORDED_PATHS = ("/healthz", "/metrics", "/slo", "/router/status", "/tenants")
_QUIET_PATHS = ("/healthz", "/metrics", "/slo", "/autopilot")

_ROOT_ENDPOINTS = {
    "/healthz": "healthz",
    "/metrics": "metrics",
    "/slo": "slo",
    "/tenants": "tenants",
    "/telemetry": "telemetry",
    "/incidents": "incidents",
    "/autopilot": "autopilot",
    "/fleet": "fleet",
    "/models": "models",
    "/reload": "reload",
    "/rollback": "rollback",
    "/router/status": "status",
    "/debug/requests": "debug-requests",
    "/prediction": "score",
    "/anomaly/prediction": "score",
}
_PATTERNS = (
    (re.compile(r"^/incidents/(?P<incident_id>[^/]+)$"), "incident"),
    (re.compile(r"^/autopilot/(?P<action>[^/]+)$"), "autopilot-action"),
    (re.compile(r"^/fleet/(?P<action>[^/]+)$"), "fleet-action"),
    (re.compile(r"^/debug/requests/(?P<trace_id>[^/]+)$"), "debug-request"),
    (re.compile(r"^/gordo/v0/(?P<project>[^/]+)/(?P<machine>[^/]+)/(?P<rest>.+)$"), "machine"),
)


def _aggregate_enabled() -> bool:
    """GORDO_ROUTER_AGGREGATE=0 turns ``?aggregate=1`` into a plain
    router-registry scrape (workers too slow/many to fan out to)."""
    return os.environ.get(
        "GORDO_ROUTER_AGGREGATE", "1"
    ).strip().lower() not in ("0", "false", "off", "no")


class _AggregateWarehouse:
    """The router-side stand-in for a telemetry warehouse: the incident
    correlator's ``window_view`` queries fan out to every routable worker
    and merge — so a router incident's metric deltas describe the FLEET,
    not the (warehouse-less) router process."""

    def __init__(self, router: "FleetRouter"):
        self._router = router

    def window_view(self, window, now_wall=None):
        merged, _errors = self._router._aggregate_telemetry(window)
        return merged.get("window") or {}


class _Request:
    """What a handler needs of one request: method, path, the raw query,
    its last value per key, the headers (case-insensitive) and the body."""

    __slots__ = ("method", "path", "query", "args", "headers", "body")

    def __init__(self, method: str, raw_path: str, headers: Mapping[str, str], body: bytes):
        self.method = method
        self.path, _, self.query = raw_path.partition("?")
        self.args = {key: values[-1]
                     for key, values in urllib.parse.parse_qs(self.query).items()}
        self.headers = headers
        self.body = body

    @property
    def full_path(self) -> str:
        return f"{self.path}?{self.query}" if self.query else self.path

    def int_arg(self, key: str) -> Optional[int]:
        try:
            return int(self.args[key])
        except (KeyError, ValueError):
            return None


class FleetRouter:
    """The router: ``handle(method, path, headers, body) -> Response``
    (served by :func:`make_router_server`), consistent-hash routing over
    supervised workers.

    ``supervisor`` owns the processes, ``control`` owns their health
    (breakers + quarantine, shared here for routing decisions),
    ``placement`` owns machine→worker assignment, ``rollout`` owns
    generation adoption. ``models_root`` (the tree every worker serves)
    anchors fleet-wide rollback.
    """

    def __init__(
        self,
        supervisor: WorkerSupervisor,
        control: ControlPlane,
        placement: Optional[Placement] = None,
        project: str = "project",
        models_root: Optional[str] = None,
        forward_timeout: float = 60.0,
        retry_after: float = 1.0,
        scrape_timeout: float = 5.0,
    ):
        self.supervisor = supervisor
        self.control = control
        self.placement = placement or Placement(sorted(supervisor.specs))
        # assemble_fleet installs a callback that re-derives the mesh
        # layout policy (sharded vs replicated) after /reload: fleet
        # membership can cross the sharding threshold at runtime
        self.mesh_refresh = None
        # the shard count a mesh router was assembled with (None: no
        # mesh), the reconciler's observed mesh_shards
        self.mesh_shards: Optional[int] = None
        self.project = project
        self.models_root = models_root
        self.forward_timeout = forward_timeout
        self.retry_after = retry_after
        # the aggregate fan-out's PER-WORKER budget: deliberately much
        # shorter than forward_timeout — a wedged worker must cost the
        # fleet scrape seconds, not a Prometheus scrape-timeout blackout
        self.scrape_timeout = scrape_timeout
        # a pool of kept-alive connections to each worker: a per-request
        # connection would pay a TCP handshake per score
        self._session = http.Session()
        self.rollout = RolloutManager(
            supervisor,
            control,
            session=self._session,
            models_root=models_root,
        )
        self._models_cache: Optional[List[str]] = None
        self._models_lock = lockcheck.named_lock("router.models")
        # truncated-stitch pull ledger: claims a pending pull exactly
        # once across concurrent /debug readers (never held across HTTP)
        self._stitch_lock = lockcheck.named_lock("router.stitch")
        # the tenant table at the fleet's front door — the SAME
        # GORDO_TENANTS spec the workers load, so a name resolves to the
        # same class on both tiers, and unknown names fold into the
        # default tenant (bounded metric cardinality by construction)
        self.tenants = qos.TenantTable.from_env()
        # router-side SLO engine: route latency + routability objectives
        # over the router's own series, scrape-driven; per-class and
        # per-tenant availability ride the same engine
        self.slo = (
            slo_engine.SLOEvaluator(
                slo_engine.router_objectives()
                + slo_engine.tenant_objectives(self.tenants.specs())
            )
            if slo_engine.enabled()
            else None
        )
        # elastic autopilot: spawns/retires workers through the
        # supervisor slot table + hash ring on sustained burn / idle.
        # None under GORDO_AUTOPILOT=0; constructed-but-frozen when the
        # knob is unset.
        self.autopilot = build_router_autopilot(self)
        # the declarative fleet reconciler: journaled desired-state specs
        # diffed against the observed fleet each scrape, repaired through
        # the seams above (supervisor, rollout, autopilot, generation
        # store, placement, the workers' /layout). None under GORDO_FLEET=0
        # or without a models_root; inert until a spec is committed.
        self.fleet = build_router_reconciler(self)
        # the router's own control ledger (its autopilot, rollout and
        # breaker events land here) plus its breach-edge incident
        # correlator. Warehouse deltas come through the aggregate fan-out
        # — the router has no warehouse of its own.
        ledger_dir = os.environ.get("GORDO_LEDGER_DIR")
        if ledger_dir:
            ledger_dir = os.path.join(ledger_dir, "router")
        elif models_root:
            ledger_dir = os.path.join(
                models_root, ".telemetry", "ledger-router",
            )
        ledger_engine.configure(ledger_dir or None)
        self.incidents = incidents_engine.IncidentCorrelator(
            directory=(
                os.path.join(ledger_dir, "incidents") if ledger_dir
                else None
            ),
            warehouse=(
                _AggregateWarehouse(self)
                if telemetry_engine.enabled() else None
            ),
            spec_revision=self._current_spec_revision,
            role="router",
        )
        if self.slo is not None:
            self.slo.breach_hook = self.incidents.on_breach
        tracing.install_log_record_factory()

    def _current_spec_revision(self) -> Optional[int]:
        if self.fleet is None:
            return None
        loaded = self.fleet.spec_store.current_spec()
        return loaded[0] if loaded else None

    # -- the front ------------------------------------------------------------
    def handle(self, method: str, raw_path: str, headers: Mapping[str, str],
               body: bytes) -> Response:
        request = _Request(method, raw_path, headers, body)
        started = time.perf_counter()
        trace_id = (
            request.headers.get(tracing.TRACE_HEADER) or tracing.new_trace_id()
        )
        token = tracing.set_trace_id(trace_id)
        timeline = None
        timeline_token = None
        if flightrec.RECORDER.enabled:
            timeline, timeline_token = spans.begin(
                trace_id, method=method, path=request.path,
                service="router",
            )
        try:
            try:
                endpoint, args = self._match(request.path)
                response = self._dispatch(request, endpoint, args)
            except Exception as exc:  # noqa: BLE001 - the request fails, the router stays up
                logger.exception("Router error on %s", request.path)
                response = _json({"error": str(exc)}, status=500)
            response.headers[tracing.TRACE_HEADER] = trace_id
            if timeline is not None:
                status = response.status
                timeline.meta["endpoint"] = request.path
                timeline.finish(
                    status=str(status),
                    error=f"HTTP {status}" if status >= 500 else "",
                )
                if request.path not in _UNRECORDED_PATHS and not request.path.startswith(
                    ("/debug/", "/autopilot")
                ):
                    flightrec.RECORDER.record(timeline)
            logger.log(
                logging.DEBUG if request.path in _QUIET_PATHS else logging.INFO,
                "%s %s -> %d in %.1f ms [trace=%s]",
                method,
                request.path,
                response.status,
                (time.perf_counter() - started) * 1000,
                trace_id,
            )
        finally:
            if timeline_token is not None:
                spans.end(timeline_token)
            tracing.reset_trace_id(token)
        return response

    @staticmethod
    def _match(path: str) -> Tuple[str, Dict[str, str]]:
        if path in _ROOT_ENDPOINTS:
            return _ROOT_ENDPOINTS[path], {}
        for pattern, endpoint in _PATTERNS:
            match = pattern.match(path)
            if match is not None:
                return endpoint, match.groupdict()
        return "not-found", {}

    # -- endpoints -----------------------------------------------------------
    def _dispatch(self, request: _Request, endpoint: str, args: Dict[str, str]) -> Response:
        if endpoint == "not-found":
            return _json({"error": f"No route {request.path!r}"}, status=404)
        if endpoint == "healthz":
            return self._healthz()
        if endpoint == "metrics":
            if self.slo is not None:
                self.slo.maybe_tick()
            if self.autopilot is not None:
                self.autopilot.maybe_tick()
            if self.fleet is not None:
                self.fleet.maybe_tick()
            exemplars = request.args.get("exemplars") in ("1", "true")
            if request.args.get("format") == "prometheus":
                if request.args.get("aggregate") in (
                    "1", "true"
                ) and _aggregate_enabled():
                    # scrape-of-scrapes: the fleet in ONE exposition —
                    # worker registries merged (counters summed, histogram
                    # buckets merged, gauges worker-labeled) with the
                    # router's own on top
                    return _text(self._aggregate_metrics(exemplars=exemplars))
                return _text(exposition.render_prometheus(REGISTRY, exemplars=exemplars))
            return _json(
                {
                    "router": self._router_stats(),
                    "registry": REGISTRY.snapshot(),
                }
            )
        if endpoint == "slo":
            if self.slo is None:
                return _json({"enabled": False})
            self.slo.maybe_tick()
            return _json(self.slo.snapshot(recorder=flightrec.RECORDER))
        if endpoint == "tenants":
            return _json(self.tenants.snapshot())
        if endpoint == "telemetry":
            if not telemetry_engine.enabled():
                return _json({"enabled": False})
            # horizon forms accepted alongside bare seconds: ?window=1m
            # /10m/1h select the matching warehouse EWMA horizon
            window = telemetry_engine.parse_window(
                request.args.get("window")
            ) or 300.0
            merged, errors = self._aggregate_telemetry(window)
            if request.args.get("view") == "export":
                payload: Dict[str, Any] = telemetry_engine.build_export(
                    merged, window=window
                )
            else:
                payload = merged
            if errors:
                payload["errors"] = errors
            return _json(payload)
        if endpoint == "incidents":
            # reading incidents ticks the router's SLO engine first
            # (breach edges materialize their reports before rendering)
            if self.slo is not None:
                self.slo.maybe_tick()
            if request.args.get("view") == "ledger":
                window = telemetry_engine.parse_window(
                    request.args.get("window")
                )
                return _json({
                    "ledger": ledger_engine.LEDGER.snapshot(),
                    "events": ledger_engine.LEDGER.recent(
                        window=window,
                        limit=request.int_arg("limit") or 200,
                    ),
                })
            merged, errors = self._aggregate_incidents()
            payload = {
                "incidents": merged,
                "correlator": self.incidents.snapshot(),
            }
            if errors:
                payload["errors"] = errors
            return _json(payload)
        if endpoint == "incident":
            report = self._find_incident(str(args.get("incident_id")))
            if report is None:
                return _json(
                    {"error": f"no incident {args.get('incident_id')!r} "
                              "on the router or any routable worker"},
                    status=404,
                )
            return _json(report)
        if endpoint == "autopilot":
            if self.autopilot is None:
                return _json(disabled_snapshot())
            if self.slo is not None:
                self.slo.maybe_tick()  # fresh burn rates first
            self.autopilot.maybe_tick()
            return _json(self.autopilot.snapshot())
        if endpoint == "autopilot-action":
            if request.method != "POST":
                return _json({"error": "POST required"}, status=405)
            if self.autopilot is None:
                return _json(
                    {
                        **disabled_snapshot(),
                        "error": "hard kill switch active; runtime "
                                 "enable is not possible",
                    },
                    status=409,
                )
            action = args.get("action")
            if action == "enable":
                self.autopilot.enable()
            elif action == "disable":
                self.autopilot.disable(
                    reason="operator via /autopilot/disable"
                )
            else:
                return _json(
                    {"error": f"unknown autopilot action {action!r} "
                              "(enable | disable)"},
                    status=404,
                )
            return _json(self.autopilot.snapshot())
        if endpoint == "fleet":
            if self.fleet is None:
                return _json(fleet_reconciler.disabled_snapshot())
            if self.slo is not None:
                self.slo.maybe_tick()
            self.fleet.maybe_tick()
            return _json(self.fleet.snapshot())
        if endpoint == "fleet-action":
            return self._fleet_action(request, args.get("action"))
        if endpoint == "debug-requests":
            limit = request.int_arg("limit")
            return _json(
                flightrec.RECORDER.summaries(limit=limit if limit else 50)
            )
        if endpoint == "debug-request":
            return self._debug_request(request, args["trace_id"])
        if endpoint == "status":
            return _json(self._status())
        if endpoint == "models":
            machines = self._machines(refresh=True)
            if machines is None:
                return self._unroutable("no worker could list models")
            return _json({"project": self.project, "models": machines})
        if endpoint == "reload":
            if request.method != "POST":
                return _json({"error": "POST required"}, status=405)
            result = self.rollout.rolling_reload()
            if self.mesh_refresh is not None:
                # the adopted generation may have crossed the sharding
                # threshold: re-derive the layout policy the workers'
                # rescans just re-derived on their side
                try:
                    self.mesh_refresh()
                except Exception:  # noqa: BLE001 - the reload itself succeeded
                    logger.exception("Mesh layout refresh after reload failed")
            return _json(result)
        if endpoint == "rollback":
            if request.method != "POST":
                return _json({"error": "POST required"}, status=405)
            if not self.models_root:
                return _json(
                    {"error": "router started without a models_root; "
                              "fleet rollback has nothing to swap"},
                    status=422,
                )
            return _json(self.rollout.rollback())
        if endpoint == "score":
            # bare single-model paths: routable only when the fleet serves
            # exactly one machine (parity with the server's single mode)
            machines = self._machines()
            if machines is not None and len(machines) == 1:
                return self._route(
                    request,
                    machines[0],
                    f"/gordo/v0/{self.project}/{machines[0]}{request.full_path}",
                )
            return _json(
                {
                    "error": "multiple models served; use "
                             "/gordo/v0/<project>/<machine>/<endpoint>"
                },
                status=404,
            )
        # machine-scoped: /gordo/v0/<project>/<machine>/<rest>
        if args.get("project") != self.project:
            return _json(
                {"error": f"Unknown project {args.get('project')!r}"},
                status=404,
            )
        return self._route(request, args["machine"], request.full_path)

    # -- the fleet spec's control surface --------------------------------------
    def _fleet_action(self, request: _Request, action: Optional[str]) -> Response:
        if self.fleet is None:
            return _json(
                {
                    **fleet_reconciler.disabled_snapshot(),
                    "error": "fleet reconciler not constructed "
                             "(GORDO_FLEET=0 or no models_root)",
                },
                status=409,
            )
        if action == "status":
            return _json(self.fleet.snapshot())
        if action == "diff":
            return _json(self.fleet.diff_now())
        if action in ("apply", "rollback") and request.method != "POST":
            return _json({"error": "POST required"}, status=405)
        if action == "apply":
            try:
                payload = json.loads(request.body.decode() or "{}")
            except (UnicodeDecodeError, ValueError) as exc:
                return _json({"error": f"spec body is not JSON: {exc}"}, status=400)
            known = sorted(build_fleet_index(self.models_root)) if self.models_root else None
            try:
                spec = FleetSpec.parse(payload, known_machines=known)
            except SpecError as exc:
                return _json({"error": str(exc)}, status=422)
            record = self.fleet.spec_store.commit(spec, op="apply")
            return _json({"committed": True, "record": record})
        if action == "rollback":
            try:
                record = self.fleet.spec_store.rollback(
                    reason="operator via /fleet/rollback"
                )
            except SpecError as exc:
                return _json({"error": str(exc)}, status=422)
            return _json({"committed": True, "record": record})
        return _json(
            {"error": f"unknown fleet action {action!r} "
                      "(status | diff | apply | rollback)"},
            status=404,
        )

    # -- routing core --------------------------------------------------------
    def _route(self, request: _Request, machine: str, path: str) -> Response:
        """Forward to the machine's placed worker, walking the failover
        order on dead/draining/unreachable candidates. The whole decision
        + forward is the timeline's ``route`` stage."""
        self.placement.note_request(machine)
        # per-tenant accounting at the front door too — the router's SLO
        # engine reads its OWN registry, and a router-side shed (no
        # routable worker) would otherwise be invisible to tenant
        # availability. The tenant header itself forwards to the worker
        # untouched (it is not hop-by-hop).
        tenant_spec = self.tenants.resolve(
            request.headers.get(qos.TENANT_HEADER)
        )
        base_path = path.split("?", 1)[0]
        is_scoring = base_path.endswith("/prediction")
        klass = (
            "bulk"
            if base_path.endswith("/bulk/anomaly/prediction")
            else tenant_spec.klass
        )
        timeline = spans.current_timeline()
        if timeline is not None:
            timeline.meta["tenant"] = tenant_spec.name
        headers = {
            key: value
            for key, value in request.headers.items()
            if key.lower() not in _DROP_FORWARD_HEADERS
        }
        headers[tracing.TRACE_HEADER] = tracing.get_trace_id()
        if timeline is not None:
            # negotiate trace stitching: the worker stamps its completed
            # timeline on the response (size-capped) ONLY when asked
            headers[stitch.TIMELINE_HEADER] = "1"
        with spans.stage(
            "route", machine=machine, hot=self.placement.is_hot(machine)
        ):
            candidates = self.placement.candidates(machine)
            # TWO sweeps over the candidates before giving up: the ways
            # every worker can fail at once (one draining + one mid-boot
            # + a stale kept-alive connection on the survivor) are
            # transient at the tens-of-milliseconds scale, so one
            # short-delayed re-walk converts a client-visible 503 into a
            # served request. Bounded: at most ~50ms extra, only on the
            # path that would otherwise fail outright.
            for sweep in range(2):
                if sweep:
                    time.sleep(0.05)
                for worker_name in candidates:
                    if not self.control.routable(worker_name):
                        _M_ROUTED.labels(worker_name, "skipped").inc()
                        continue
                    breaker = self.control.breakers.get(worker_name)
                    if not breaker.allow():
                        _M_ROUTED.labels(
                            worker_name, "short_circuit"
                        ).inc()
                        continue
                    response = self._forward(
                        worker_name, request.method, path, request.body,
                        headers, breaker,
                    )
                    if response is not None:
                        spans.event(
                            "routed",
                            worker=worker_name,
                            tenant=tenant_spec.name,
                        )
                        if is_scoring:
                            status = response.status
                            qos.note_request(
                                tenant_spec.name,
                                klass,
                                "quota" if status == 429
                                else "shed" if status == 503
                                else "ok" if status < 400
                                else "error",
                            )
                        return response
        _M_UNROUTABLE.inc()
        if is_scoring:
            # a router-side shed: every candidate dead/draining — charge
            # it to the tenant's availability like any worker-side shed
            qos.note_request(tenant_spec.name, klass, "shed")
        spans.event("unroutable", machine=machine, tenant=tenant_spec.name)
        return self._unroutable(
            f"no routable worker for machine {machine!r} "
            f"(candidates: {candidates})"
        )

    def _forward(
        self, worker_name: str, method: str, path: str, body: bytes,
        headers: Dict[str, str], breaker,
    ) -> Optional[Response]:
        """One forward attempt; None = move to the next candidate."""
        spec = self.supervisor.specs.get(worker_name)
        if spec is None:  # retired between the candidate walk and here
            return None
        url = f"{spec.base_url}{path}"
        started = time.perf_counter()
        upstream = None
        for retry in (False, True):
            try:
                upstream = self._session.request(
                    method, url, body=body, headers=headers,
                    timeout=self.forward_timeout, fresh=retry,
                )
                break
            except http.TransportError as exc:
                if not retry:
                    # first failure is retried ONCE against the SAME
                    # worker on a fresh connection: a stale kept-alive
                    # connection resets exactly like a dead worker, and
                    # mis-reading it would both ding the breaker and
                    # churn placement. Scoring POSTs are idempotent, so
                    # the replay is safe.
                    continue
                # transport failure for real: feeds the SAME circuit the
                # control plane's probes use, then the request moves on —
                # re-route, not error.
                breaker.record(False)
                _M_ROUTED.labels(worker_name, "reroute").inc()
                logger.warning(
                    "Forward to %s failed (%r); re-routing",
                    worker_name, exc,
                )
                return None
        _M_FORWARD_SECONDS.labels(worker_name).observe(
            time.perf_counter() - started
        )
        if upstream.status_code == 503 and upstream.headers.get(
            DRAINING_HEADER
        ):
            # the worker is mid-drain (rolling restart): it answered — the
            # circuit stays closed — but this request must land elsewhere
            breaker.record(True)
            _M_ROUTED.labels(worker_name, "drained").inc()
            return None
        breaker.record(True)
        _M_ROUTED.labels(worker_name, "ok").inc()
        self._stitch_response(worker_name, upstream, started)
        passed = {
            key: upstream.headers[key]
            for key in _PASS_RESPONSE_HEADERS
            if key in upstream.headers
        }
        return Response(
            upstream.status_code, upstream.content,
            upstream.headers.get("Content-Type") or "application/octet-stream", passed,
        )

    def _stitch_response(
        self, worker_name: str, upstream: http.Reply, started: float
    ) -> None:
        """Merge the worker's stamped timeline (or note the truncation
        for the pull fallback) under this request's ``route`` stage."""
        timeline = spans.current_timeline()
        if timeline is None:
            return
        rel_start = max(0.0, started - timeline.started)
        rel_end = max(rel_start, time.perf_counter() - timeline.started)
        encoded = upstream.headers.get(stitch.TIMELINE_HEADER)
        truncated = upstream.headers.get(stitch.TIMELINE_TRUNCATED_HEADER)
        if encoded:
            try:
                remote = stitch.decode_timeline(encoded)
            except ValueError as exc:
                _M_STITCH.labels("invalid").inc()
                spans.event(
                    "stitch_invalid", worker=worker_name, error=str(exc)
                )
                return
            merged = stitch.merge_remote(
                timeline, remote, rel_start, rel_end,
                process=_stitch_lane(worker_name, remote),
            )
            _M_STITCH.labels("merged" if merged else "invalid").inc()
        elif truncated:
            # over the size cap: remember WHICH worker holds the full
            # timeline so /debug/requests/<trace_id> can pull it
            timeline.meta["stitch_pending"] = {
                "worker": worker_name,
                "window": [round(rel_start, 6), round(rel_end, 6)],
            }
            spans.event(
                "timeline_truncated", worker=worker_name, bytes=truncated
            )
            _M_STITCH.labels("truncated").inc()

    # -- stitched timelines ---------------------------------------------------
    def _debug_request(self, request: _Request, trace_id: str) -> Response:
        recorded = flightrec.RECORDER.get(trace_id)
        if recorded is None:
            return _json(
                {
                    "error": (
                        f"no recorded timeline for trace {trace_id!r} "
                        "(rotated out of the flight recorder, or routed "
                        "before recording was enabled)"
                    )
                },
                status=404,
            )
        self._pull_stitch(recorded, trace_id)
        if request.args.get("format") == "chrome":
            return _json(recorded.to_chrome_trace())
        return _json(recorded.to_dict())

    def _pull_stitch(self, timeline, trace_id: str) -> None:
        """Pull fallback: the worker's stamped timeline was over the
        size cap, so fetch the full one from the worker's own flight
        recorder and merge it now. Claimed once under the stitch lock;
        the HTTP round-trip runs OUTSIDE it."""
        with self._stitch_lock:
            pending = timeline.meta.pop("stitch_pending", None)
        if not pending:
            return
        worker_name = pending.get("worker", "")
        window = pending.get("window") or [0.0, timeline.duration]
        spec = self.supervisor.specs.get(worker_name)
        if spec is None:
            # worker left the slot table: permanent — say so in the meta
            # (a one-lane trace with no explanation reads as a stitch
            # that was never attempted)
            timeline.meta["stitch_failed"] = (
                f"worker {worker_name} no longer in the slot table"
            )
            _M_STITCH.labels("pull_failed").inc()
            return
        try:
            upstream = self._session.get(
                f"{spec.base_url}/debug/requests/{trace_id}",
                timeout=5.0,
            )
        except http.TransportError as exc:
            # transient: put the claim back so a later read retries
            with self._stitch_lock:
                timeline.meta.setdefault("stitch_pending", pending)
            _M_STITCH.labels("pull_failed").inc()
            logger.warning(
                "Stitch pull from %s failed (%r); will retry on next "
                "read", worker_name, exc,
            )
            return
        if upstream.status_code != 200:
            # rotated out of the worker's recorder (or the worker
            # restarted): permanent — stop retrying, say so in the meta
            timeline.meta["stitch_failed"] = (
                f"worker {worker_name} answered "
                f"HTTP {upstream.status_code}"
            )
            _M_STITCH.labels("pull_failed").inc()
            return
        try:
            remote = upstream.json()
            merged = stitch.merge_remote(
                timeline, remote,
                float(window[0]), float(window[1]),
                process=_stitch_lane(worker_name, remote),
            )
        except (ValueError, TypeError, IndexError, AttributeError) as exc:
            timeline.meta["stitch_failed"] = f"unparseable: {exc}"
            _M_STITCH.labels("invalid").inc()
            return
        _M_STITCH.labels("pulled" if merged else "invalid").inc()

    # -- scrape-of-scrapes ----------------------------------------------------
    def _routable_targets(self) -> Dict[str, str]:
        return {
            name: spec.base_url
            for name, spec in sorted(self.supervisor.specs.items())
            if self.control.routable(name)
        }

    def _aggregate_metrics(self, exemplars: bool = False) -> str:
        """One fleet exposition: every routable worker's registry merged
        with the router's own (``observability.aggregate``). Unreachable
        or malformed workers are named in a comment and skipped — the
        fleet view degrades, never dies."""
        targets = self._routable_targets()
        texts, errors = aggregate.scrape_sources(
            self._session, targets, timeout=self.scrape_timeout,
            exemplars=exemplars,
        )
        for name in texts:
            _M_AGG_SCRAPES.labels(name, "ok").inc()
        for name in errors:
            _M_AGG_SCRAPES.labels(name, "error").inc()
        # the router's OWN registry renders AFTER the scrape counters
        # above so the aggregate reports its own collection honestly
        sources = dict(texts)
        sources["router"] = exposition.render_prometheus(
            REGISTRY, exemplars=exemplars
        )
        merged = aggregate.merge_expositions(sources, exemplars=exemplars)
        preamble = "".join(
            f"# aggregate: worker {name} skipped — {error}\n"
            for name, error in sorted(errors.items())
        )
        skipped = "".join(
            f"# aggregate: worker {name} not routable, skipped\n"
            for name in sorted(set(self.supervisor.specs) - set(targets))
        )
        return preamble + skipped + merged

    def _aggregate_telemetry(
        self, window: float
    ) -> Tuple[Dict[str, Any], Dict[str, str]]:
        """Fetch every routable worker's ``/telemetry`` view and merge
        them into one fleet view (``telemetry.merge_views``). Unreachable,
        malformed, or telemetry-disabled workers are named in the errors
        map and skipped — the fleet view degrades, never dies."""
        targets = self._routable_targets()
        views: Dict[str, Dict[str, Any]] = {}
        errors: Dict[str, str] = {}
        for name, base in targets.items():
            try:
                reply = self._session.get(
                    f"{base}/telemetry",
                    params={"window": window},
                    timeout=self.scrape_timeout,
                )
                reply.raise_for_status()
                view = reply.json()
            except (http.TransportError, ValueError) as exc:
                errors[name] = str(exc)
                continue
            if not isinstance(view, dict) or not view.get("enabled"):
                errors[name] = "telemetry disabled on worker"
                continue
            views[name] = view
        for name in sorted(set(self.supervisor.specs) - set(targets)):
            errors[name] = "not routable, skipped"
        return telemetry_engine.merge_views(views), errors

    def _aggregate_incidents(
        self,
    ) -> Tuple[List[Dict[str, Any]], Dict[str, str]]:
        """The router's own incident summaries plus every routable
        worker's, one newest-first list with a ``source`` on each row.
        Unreachable workers are named in the errors map and skipped."""
        merged: List[Dict[str, Any]] = []
        for summary in self.incidents.list():
            merged.append({**summary, "source": "router"})
        errors: Dict[str, str] = {}
        for name, spec in sorted(self.supervisor.specs.items()):
            if not self.control.routable(name):
                errors[name] = "not routable, skipped"
                continue
            try:
                reply = self._session.get(
                    f"{spec.base_url}/incidents",
                    timeout=self.scrape_timeout,
                )
                reply.raise_for_status()
                body = reply.json()
            except (http.TransportError, ValueError) as exc:
                errors[name] = str(exc)
                continue
            for summary in (body or {}).get("incidents") or []:
                if isinstance(summary, dict):
                    merged.append({**summary, "source": name})
        merged.sort(key=lambda s: -(s.get("ts") or 0.0))
        return merged, errors

    def _find_incident(self, incident_id: str) -> Optional[Dict[str, Any]]:
        """Serve a full report from the router's own correlator, else the
        first routable worker that has it (reports are per-process; the
        id encodes nothing about where it lives)."""
        report = self.incidents.get(incident_id)
        if report is not None:
            return {**report, "source": "router"}
        for name, spec in sorted(self.supervisor.specs.items()):
            if not self.control.routable(name):
                continue
            try:
                reply = self._session.get(
                    f"{spec.base_url}/incidents/{urllib.parse.quote(incident_id)}",
                    timeout=self.scrape_timeout,
                )
                if reply.status_code != 200:
                    continue
                body = reply.json()
            except (http.TransportError, ValueError):
                continue
            if isinstance(body, dict) and body.get("id") == incident_id:
                return {**body, "source": name}
        return None

    # -- views ---------------------------------------------------------------
    def _healthz(self) -> Response:
        workers = {}
        ready = 0
        specs = self.supervisor.specs
        for name in sorted(specs):
            routable = self.control.routable(name)
            last = self.control.last_probe(name)
            workers[name] = {
                "alive": self.supervisor.alive(name),
                "routable": routable,
                "state": (last or {}).get("state"),
                "circuit": self.control.breakers.get(name).state,
            }
            if routable:
                ready += 1
        ok = ready > 0
        return _json(
            {
                "ok": ok and ready == len(specs),
                "status": (
                    "ok" if ready == len(specs)
                    else ("degraded" if ok else "down")
                ),
                "live": True,
                "ready": ok,
                "workers": workers,
            },
            status=200 if ok else 503,
        )

    def _router_stats(self) -> Dict[str, Any]:
        return {
            "project": self.project,
            "workers": {
                name: {
                    "base_url": spec.base_url,
                    "alive": self.supervisor.alive(name),
                    "routable": self.control.routable(name),
                }
                for name, spec in sorted(self.supervisor.specs.items())
            },
            "placement": self.placement.stats(),
            "respawns": self.supervisor.respawn_counts(),
        }

    def _status(self) -> Dict[str, Any]:
        machines = self._machines() or []
        return {
            "project": self.project,
            "control": self.control.status(),
            "placement": self.placement.stats(),
            "table": self.placement.table(machines),
            "rollout": self.rollout.last(),
        }

    def _machines(self, refresh: bool = False) -> Optional[List[str]]:
        """The fleet's machine list, proxied from the first routable
        worker and cached (every worker serves the same tree)."""
        with self._models_lock:
            if self._models_cache is not None and not refresh:
                return self._models_cache
        specs = self.supervisor.specs
        for name in sorted(specs):
            if not self.control.routable(name):
                continue
            try:
                response = self._session.get(
                    f"{specs[name].base_url}/models", timeout=5.0
                )
                if response.status_code != 200:
                    continue
                models = response.json().get("models")
            except (http.TransportError, ValueError, AttributeError):
                continue
            if isinstance(models, list):
                with self._models_lock:
                    lockcheck.assert_guard("router.models")
                    self._models_cache = sorted(models)
                    return self._models_cache
        with self._models_lock:
            return self._models_cache

    def _unroutable(self, message: str) -> Response:
        return _json(
            {"error": message},
            status=503,
            headers={"Retry-After": str(max(1, math.ceil(self.retry_after)))},
        )

    def close(self) -> None:
        self._session.close()


def make_router_server(router: FleetRouter, host: str = "127.0.0.1",
                       port: int = 5555) -> AppHTTPServer:
    """Bind the router's HTTP front (``port=0`` picks a free port: read
    ``server.server_address``); ``server_close()`` also closes the
    router's connections."""
    return AppHTTPServer((host, port), router)


def _stitch_lane(worker_name: str, remote: Dict[str, Any]) -> str:
    """Process-lane name for a stitched worker timeline: a worker that
    stamps a mesh shard into its timeline meta renders one lane PER
    SHARD."""
    meta = remote.get("meta")
    shard = meta.get("shard") if isinstance(meta, dict) else None
    if shard is None:
        return worker_name
    return f"{worker_name}@shard-{shard}"


def _json(
    payload: Dict[str, Any],
    status: int = 200,
    headers: Optional[Dict[str, str]] = None,
) -> Response:
    return Response(status, json.dumps(payload, default=str).encode(), "application/json",
                    dict(headers or {}))


def _text(text: str) -> Response:
    return Response(200, text.encode(), exposition.CONTENT_TYPE, {})
