"""Watchman: fleet health aggregator (the port's copy of
``gordo_components_tpu/watchman/server.py``, on the standard library: the
front is :class:`~..server.httpd.AppHTTPServer` and the probes go through
:func:`..utils.http.get`, injectable as ``http_get``).

A small service configured with the project name and machine list;
``GET /`` polls every model endpoint's ``/healthz`` and reports which are
up. The fleet usually lives behind ONE multi-model server (or a fleet
router), so watchman polls
``{target}/gordo/v0/<project>/<machine>/healthz`` per machine — but the
machine list may also point at several hosts (``{machine: base_url}``),
matching the reference's one-deployment-per-model layout.

Observability: every probe's duration and failure reason is surfaced
per-target in ``status()`` (a 4.9 s probe against a 5 s timeout is a
dying machine, not a healthy one) and counted into the process registry.
``GET /metrics`` scrapes each distinct model-server base URL's own
``/metrics`` JSON and aggregates the engine counters into ONE fleet-wide
view — the scrape-of-scrapes the reference's watchman never had.

Resilience: each target's probe runs behind a circuit breaker — an
UNREACHABLE endpoint (connect/read timeout, not an HTTP error answer)
trips its circuit after a few failures, and until the recovery window
elapses its probes short-circuit in microseconds. Without this, a
1000-machine fleet with a handful of dead hosts pays ``n_dead × timeout``
per ``GET /`` even with the thread pool absorbing most of it.
"""

from __future__ import annotations

import json
import logging
import threading
import time
import urllib.parse
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, List, Mapping, Optional, Sequence, Union

from ..analysis import lockcheck
from ..observability import exposition
from ..observability.registry import REGISTRY
from ..resilience import faults
from ..resilience.breaker import BreakerBoard
from ..server.httpd import AppHTTPServer, Response
from ..utils import http

logger = logging.getLogger(__name__)

_M_PROBES = REGISTRY.counter(
    "gordo_watchman_probes_total",
    "Health probes issued, by outcome (healthy / unhealthy / unreachable "
    "/ short_circuit)",
    labels=("outcome",),
)
_M_PROBE_SECONDS = REGISTRY.histogram(
    "gordo_watchman_probe_seconds",
    "Per-target health-probe duration",
)


class WatchmanServer:
    def __init__(
        self,
        project: str,
        machines: Union[Sequence[str], Dict[str, str]],
        target_url: Optional[str] = None,
        timeout: float = 5.0,
        max_poll_workers: int = 32,
        manifest_path: Optional[str] = None,
        breaker_recovery: float = 30.0,
        breaker_clock=time.monotonic,
        http_get: Optional[Callable[..., http.Reply]] = None,
    ):
        """``machines``: list of names served at ``target_url``, or an
        explicit ``{machine: base_url}`` map. Health polls fan out over a
        thread pool of ``max_poll_workers`` so a 1000-machine fleet with a
        few dead endpoints answers ``GET /`` in ~``timeout`` seconds, not
        ``n_dead * timeout``.

        ``manifest_path``: a fleet build's ``fleet_manifest.json``; when
        given, ``GET /`` also reports build progress (completed/pending
        counts and the pending names) read from the manifest — the
        reference's later watchman evolution replaced HTTP polling with
        k8s CRD status; the manifest is this rebuild's equivalent build
        source of truth (rewritten atomically after every slice).

        ``breaker_recovery``: seconds a tripped target's circuit stays
        open before one probe tests it again (``breaker_clock`` is
        injectable so state-machine tests advance time, not sleep).
        ``http_get(url, timeout=...)``: the GET every probe and scrape
        makes (default :func:`..utils.http.get`); an ``OSError`` is an
        unreachable target."""
        self._http_get = http_get or http.get
        if isinstance(machines, dict):
            self.machine_urls = dict(machines)
        else:
            if target_url is None:
                raise ValueError(
                    "target_url is required when machines is a name list"
                )
            self.machine_urls = {name: target_url for name in machines}
        self.project = project
        self.timeout = timeout
        self.max_poll_workers = max(1, int(max_poll_workers))
        self.manifest_path = manifest_path
        # last failure per target, kept ACROSS polls: a machine that is
        # healthy right now but failed an hour ago reads differently from
        # one that never failed (the reference's watchman forgot everything
        # between GETs)
        self._last_errors: Dict[str, str] = {}
        self._errors_lock = lockcheck.named_lock("watchman.errors")
        # one circuit per HOST (base URL), shared by every machine probed
        # there: unreachability is a host property, so a dead host is
        # contained after min_calls timeouts TOTAL, not min_calls × N
        # machines. Only unreachability trips it — an endpoint that
        # ANSWERS (even 503) keeps its circuit closed.
        self._breakers = BreakerBoard(
            recovery_time=breaker_recovery, clock=breaker_clock
        )

    def _note_error(self, machine: str, error: str) -> None:
        stamped = f"{time.strftime('%Y-%m-%d %H:%M:%S%z')} {error}"
        with self._errors_lock:
            self._last_errors[machine] = stamped

    def _check(self, machine: str, base_url: str) -> Dict:
        url = (
            f"{base_url.rstrip('/')}/gordo/v0/{self.project}/{machine}/healthz"
        )
        breaker = self._breakers.get(base_url.rstrip("/"))
        if not breaker.allow():
            # open circuit: the target was unreachable recently — answer
            # from state in microseconds instead of burning another timeout
            _M_PROBES.labels("short_circuit").inc()
            with self._errors_lock:
                last_error = self._last_errors.get(machine)
            return {
                "endpoint": url,
                "target": machine,
                "healthy": False,
                "latency_ms": 0.0,
                "error": (
                    f"circuit open (unreachable; next probe in "
                    f"{breaker.retry_after():.0f}s)"
                ),
                "last_error": last_error or "",
                "circuit": breaker.state,
                "generation": None,
                "verified": None,
            }
        started = time.perf_counter()
        error: Optional[str] = None
        reachable = True
        generation: Optional[str] = None
        verified: Optional[bool] = None
        try:
            # chaos seam: a `probe:<machine>:error` fault stands in for a
            # dead endpoint without anything actually dying
            faults.inject("probe", machine)
            response = self._http_get(url, timeout=self.timeout)
            healthy = response.status_code == 200
            if not healthy:
                error = f"HTTP {response.status_code}"
            # artifact-integrity facet (store/): the machine healthz body
            # names the serving generation and its manifest-verify status —
            # surface them per target so a fleet operator sees WHICH gen
            # each machine runs (and a rollback taking effect) from one
            # watchman GET. Absent/non-JSON bodies (old servers) skip it.
            body = None
            json_fn = getattr(response, "json", None)
            if callable(json_fn):
                try:
                    body = json_fn()
                except ValueError:
                    body = None
            if isinstance(body, dict):
                generation = body.get("generation")
                verified = body.get("verified")
            _M_PROBES.labels("healthy" if healthy else "unhealthy").inc()
        except (OSError, faults.FaultInjected) as exc:
            logger.warning("Watchman: %s unreachable: %r", machine, exc)
            healthy = False
            reachable = False
            error = repr(exc)
            _M_PROBES.labels("unreachable").inc()
        breaker.record(reachable)
        probe_s = time.perf_counter() - started
        _M_PROBE_SECONDS.observe(probe_s)
        if error is not None:
            self._note_error(machine, error)
        with self._errors_lock:
            last_error = self._last_errors.get(machine)
        return {
            "endpoint": url,
            "target": machine,
            "healthy": healthy,
            "latency_ms": probe_s * 1000,
            # current probe's failure ('' when this probe succeeded) and
            # the most recent failure ever seen, timestamped — a slow/dead
            # machine is distinguishable from a healthy one at a glance
            "error": error or "",
            "last_error": last_error or "",
            "circuit": breaker.state,
            # serving generation + manifest-verify status from the machine
            # healthz body (None when the target predates the store)
            "generation": generation,
            "verified": verified,
        }

    def _build_progress(self) -> Optional[Dict]:
        if not self.manifest_path:
            return None
        return read_build_progress(self.manifest_path)

    def _slowest_request(self, base_url: str) -> Optional[Dict]:
        """The target server's slowest recorded request — the flight
        recorder's summary row (trace id, duration, dominant stage) from
        ``/debug/requests`` — or None when the target predates the
        recorder or is unreachable. One scrape per distinct base URL, so
        a 1000-machine single-server fleet costs one extra GET per
        status poll."""
        # read-only breaker peek (allow() would consume the half-open
        # probe slot the health checks own): an unreachable host must not
        # cost an extra timeout per poll on top of its probe
        if self._breakers.get(base_url.rstrip("/")).state != "closed":
            return None
        url = f"{base_url.rstrip('/')}/debug/requests?limit=1"
        try:
            response = self._http_get(url, timeout=self.timeout)
            if response.status_code != 200:
                return None
            json_fn = getattr(response, "json", None)
            body = json_fn() if callable(json_fn) else None
        except (OSError, ValueError):
            return None
        if not isinstance(body, dict):
            return None
        return body.get("slowest")

    def status(self) -> Dict:
        targets = sorted(self.machine_urls.items())
        workers = min(self.max_poll_workers, max(1, len(targets)))
        urls = sorted(set(self.machine_urls.values()))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            endpoints: List[Dict] = list(
                pool.map(lambda mu: self._check(*mu), targets)
            )
            slow = dict(zip(urls, pool.map(self._slowest_request, urls)))
        body = {
            "project-name": self.project,
            "ok": all(e["healthy"] for e in endpoints),
            "endpoints": endpoints,
            # non-closed circuits only: the interesting subset at a glance
            # (every endpoint entry carries its own "circuit" field too)
            "open-circuits": {
                name: state
                for name, state in self._breakers.states().items()
                if state != "closed"
            },
            # per-target slowest recorded request (flight recorder): the
            # "which trace do I open in Perfetto" pointer, fleet-wide
            "slow-requests": {
                url: summary for url, summary in slow.items()
                if summary is not None
            },
        }
        build = self._build_progress()
        if build is not None:
            body["build"] = build
        return body

    # engine.stats() fields that are meaningfully summable across model
    # servers — the fleet-wide totals a capacity dashboard wants
    _SUMMED_ENGINE_STATS = (
        "machines",
        "buckets",
        "compiled_programs",
        "dispatches",
        "batched_requests",
        "hot_machines",
        "hot_requests",
    )

    def _scrape_one(self, base_url: str) -> Dict:
        url = f"{base_url.rstrip('/')}/metrics"
        started = time.perf_counter()
        try:
            response = self._http_get(url, timeout=self.timeout)
            response.raise_for_status()
            body = response.json()
        except (OSError, ValueError) as exc:
            return {"error": repr(exc), "scrape_ms": (time.perf_counter() - started) * 1000}
        return {
            "engine": body.get("engine") or {},
            "latency": body.get("latency") or {},
            "scrape_ms": (time.perf_counter() - started) * 1000,
        }

    def metrics(self) -> Dict:
        """Scrape every distinct model-server base URL's ``/metrics`` JSON
        and aggregate the engine counters fleet-wide. One multi-model
        server hosting the whole fleet scrapes once; a per-host layout
        scrapes each host — either way the ``fleet`` block is the single
        place to read total dispatches, batched requests, and how many
        machines serve via the slow host path."""
        urls = sorted(set(self.machine_urls.values()))
        workers = min(self.max_poll_workers, max(1, len(urls)))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            scraped = dict(zip(urls, pool.map(self._scrape_one, urls)))
        fleet: Dict = {key: 0 for key in self._SUMMED_ENGINE_STATS}
        fleet["host_path_machines"] = {}
        up = 0
        for url, result in scraped.items():
            engine = result.get("engine")
            if engine is None:
                continue
            up += 1
            for key in self._SUMMED_ENGINE_STATS:
                value = engine.get(key)
                if isinstance(value, (int, float)):
                    fleet[key] += value
            # keep WHICH machines are slow, not just how many — prefixed
            # by target when several servers report
            for name, reason in (engine.get("host_path_machines") or {}).items():
                key = name if len(urls) == 1 else f"{url}/{name}"
                fleet["host_path_machines"][key] = reason
        return {
            "project-name": self.project,
            "targets-up": up,
            "targets-total": len(urls),
            "fleet": fleet,
            "targets": scraped,
        }

    def handle(self, method: str, raw_path: str, headers: Mapping[str, str],
               body: bytes) -> Response:
        path, _, query = raw_path.partition("?")
        params = {key: values[-1] for key, values in urllib.parse.parse_qs(query).items()}
        if path in ("/", ""):
            payload, status = self.status(), 200
        elif path == "/healthz":
            payload, status = {"ok": True}, 200
        elif path == "/metrics":
            if params.get("format") == "prometheus":
                # watchman's OWN series (probe counts/durations), text-form
                return Response(200, exposition.render_prometheus(REGISTRY).encode(),
                                exposition.CONTENT_TYPE, {})
            payload, status = self.metrics(), 200
        else:
            payload, status = {"error": "not found"}, 404
        return Response(status, json.dumps(payload).encode(), "application/json", {})

    def close(self) -> None:
        """Nothing to release: every probe opens its own connection."""


def read_build_progress(manifest_path: str, pending_cap: int = 50) -> Dict:
    """Unioned fleet-build progress from the manifest file(s), or an error
    record when the path is set but unreadable (a monitor must see that the
    manifest is gone, not a silently vanished field).

    Multi-host builds write one manifest per process
    (``fleet_manifest.json`` + ``fleet_manifest.p<i>.json`` siblings — see
    build_fleet._write_manifest); the union is the fleet view: completed
    machines are the union of every file's, and a machine is pending only
    while NO process has completed it. Shared by the HTTP view and the CLI
    ``run-watchman --watch`` follower."""
    import glob
    import os

    stem, ext = os.path.splitext(manifest_path)
    paths = [manifest_path] + sorted(glob.glob(f"{stem}.p*{ext}"))
    try:
        completed: Dict = {}
        pending: set = set()
        updated = None
        for path in paths:
            with open(path) as fh:
                manifest = json.load(fh)
            completed.update(manifest.get("machines") or {})
            pending |= set(manifest.get("pending") or [])
            updated = max(updated or "", manifest.get("updated") or "")
        still_pending = sorted(pending - set(completed))
        return {
            "updated": updated or None,
            "n_completed": len(completed),
            "n_pending": len(still_pending),
            "pending": still_pending[:pending_cap],  # capped for 10k fleets
        }
    except (OSError, ValueError, AttributeError, TypeError) as exc:
        # wrong-shaped JSON (top-level list, null pending) must degrade
        # to an error field, not take the whole health view down
        return {"error": f"manifest unreadable: {exc}"}


def watch_build_progress(
    manifest_path: str,
    interval_s: float = 5.0,
    emit=print,
    sleep=time.sleep,
    max_iterations: Optional[int] = None,
) -> bool:
    """CRD-style build follower (the reference eventually replaced watchman
    HTTP polling with k8s CRD status — SURVEY §3 watchman row): emit one
    JSON progress line per interval from the manifest file(s), returning
    True once every machine is completed, False if ``max_iterations``
    elapsed first. No HTTP anywhere — this reads the same files the build
    writes atomically. Ticks are jittered ±10% (control.jittered_interval)
    so many followers over one shared filesystem don't all stat the
    manifests on the same beat."""
    from .control import jittered_interval

    i = 0
    while True:
        progress = read_build_progress(manifest_path)
        emit(json.dumps(progress))
        if not progress.get("error") and progress.get("n_pending") == 0:
            return True
        i += 1
        if max_iterations is not None and i >= max_iterations:
            return False
        sleep(jittered_interval(interval_s))


def build_watchman_app(
    project: str,
    machines: Union[Sequence[str], Dict[str, str]],
    target_url: Optional[str] = None,
    manifest_path: Optional[str] = None,
) -> WatchmanServer:
    return WatchmanServer(
        project, machines, target_url, manifest_path=manifest_path
    )


def make_watchman_server(
    app: WatchmanServer, host: str = "0.0.0.0", port: int = 5556
) -> AppHTTPServer:
    """Bind the watchman's HTTP front (``port=0`` picks a free port)."""
    return AppHTTPServer((host, port), app)


def run_watchman(
    project: str,
    machines: Union[Sequence[str], Dict[str, str]],
    target_url: Optional[str] = None,
    host: str = "0.0.0.0",
    port: int = 5556,
    manifest_path: Optional[str] = None,
) -> None:
    """Serve the watchman until SIGTERM or an interrupt."""
    import signal

    server = make_watchman_server(
        build_watchman_app(project, machines, target_url, manifest_path=manifest_path),
        host, port,
    )
    logger.info("Watchman on http://%s:%d over %d machine(s)", host,
                server.server_address[1], len(machines))

    def _on_sigterm(signum, frame) -> None:
        threading.Thread(target=server.shutdown, name="gordo-watchman-stop",
                         daemon=True).start()

    try:
        signal.signal(signal.SIGTERM, _on_sigterm)
    except ValueError:
        logger.debug("SIGTERM handler not installed (not the main thread)")
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()
