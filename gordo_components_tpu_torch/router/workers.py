"""Worker processes: spawn, watch, drain, respawn (the port's copy of
``gordo_components_tpu/router/workers.py``).

One worker = one full model-server process (``python -m
gordo_components_tpu_torch.cli run-server --worker-id N``) on its own port, owning its own serving engine and
device residency. The supervisor is deliberately dumb about HEALTH — it
knows processes (spawn / alive / terminate / respawn); deciding that a
live process is sick is the control plane's job
(``watchman.control.ControlPlane``), which calls back into
:meth:`WorkerSupervisor.respawn`.

Workers are pluggable behind the tiny :class:`SubprocessWorker` protocol
(``start / alive / pid / terminate / kill``) so tests and benchmarks can
supervise in-process thread-backed workers through the exact same
supervisor and router code paths the production subprocess tier runs.
"""

from __future__ import annotations

import logging
import os
import signal
import subprocess
import sys
import time
from typing import Callable, Dict, List, NamedTuple, Optional, Sequence

from ..analysis import lockcheck
from ..observability.registry import REGISTRY
from ..utils import http

logger = logging.getLogger(__name__)

_M_RESPAWNS = REGISTRY.counter(
    "gordo_router_worker_respawns_total",
    "Worker processes respawned by the supervisor, by worker and cause "
    "(dead = process exited, ejected = control plane gave up on it)",
    labels=("worker", "cause"),
)
_M_WORKERS_ALIVE = REGISTRY.gauge(
    "gordo_router_workers_alive",
    "Worker processes currently alive under the supervisor",
)


class WorkerSpec(NamedTuple):
    """Identity + address of one worker slot. The NAME (not the pid) is
    the placement key: a respawned worker inherits its predecessor's slot
    on the hash ring, so a crash-restart moves zero keys."""

    name: str
    worker_id: int
    host: str
    port: int

    @property
    def base_url(self) -> str:
        return f"http://{self.host}:{self.port}"


def worker_specs(
    n: int, base_port: int, host: str = "127.0.0.1"
) -> List[WorkerSpec]:
    return [
        WorkerSpec(f"worker-{i}", i, host, base_port + i) for i in range(n)
    ]


def server_worker_argv(
    spec: WorkerSpec,
    models_dir: str,
    project: str = "project",
    extra: Sequence[str] = (),
    device: Optional[str] = None,
    launcher: Optional[Sequence[str]] = None,
) -> List[str]:
    """The production worker command line: the port's server, one process
    per worker, all serving ``models_dir``. ``device`` is passed on as
    ``--device`` (the card unless ``cpu``); ``launcher`` replaces the
    ``python -m gordo_components_tpu_torch.cli`` prefix (a wrapper that
    runs the CLI module itself, e.g. to record the process's kernel
    launches at exit)."""
    prefix = list(launcher) if launcher is not None else [
        sys.executable, "-m", "gordo_components_tpu_torch.cli"]
    argv = [
        *prefix,
        "run-server",
        "--models-dir",
        models_dir,
        "--host",
        spec.host,
        "--port",
        str(spec.port),
        "--project",
        project,
        "--worker-id",
        str(spec.worker_id),
        *extra,
    ]
    if device is not None:
        argv += ["--device", str(device)]
    return argv


class SubprocessWorker:
    """One worker process. ``terminate()`` is the GRACEFUL path: SIGTERM
    (the server drains in-flight requests and quiesces its engine before
    exiting — server.py), escalating to SIGKILL only after ``grace``."""

    def __init__(
        self,
        spec: WorkerSpec,
        argv: Sequence[str],
        env: Optional[Dict[str, str]] = None,
        stdout=None,
        stderr=None,
    ):
        self.spec = spec
        self.argv = list(argv)
        self.env = dict(env) if env is not None else None
        self._stdout = stdout
        self._stderr = stderr
        self._proc: Optional[subprocess.Popen] = None

    def start(self) -> None:
        env = dict(os.environ)
        if self.env:
            env.update(self.env)
        self._proc = subprocess.Popen(
            self.argv,
            env=env,
            stdout=self._stdout if self._stdout is not None else None,
            stderr=self._stderr if self._stderr is not None else None,
        )
        logger.info(
            "Worker %s spawned (pid %d, port %d)",
            self.spec.name, self._proc.pid, self.spec.port,
        )

    @property
    def pid(self) -> Optional[int]:
        return self._proc.pid if self._proc is not None else None

    def alive(self) -> bool:
        return self._proc is not None and self._proc.poll() is None

    def terminate(self, grace: float = 15.0) -> None:
        if self._proc is None or self._proc.poll() is not None:
            return
        self._proc.send_signal(signal.SIGTERM)
        try:
            self._proc.wait(timeout=grace)
        except subprocess.TimeoutExpired:
            logger.warning(
                "Worker %s did not drain within %.1fs; killing",
                self.spec.name, grace,
            )
            self._proc.kill()
            self._proc.wait(timeout=5)

    def kill(self) -> None:
        if self._proc is not None and self._proc.poll() is None:
            self._proc.kill()
            self._proc.wait(timeout=5)


class WorkerSupervisor:
    """Owns the worker slot table: spawn all, respawn one, stop all.

    ``factory(spec) -> worker`` builds a fresh (unstarted) worker for a
    slot — the seam tests use to supervise thread-backed workers. Respawn
    REPLACES the slot's worker object; the spec (name, port) is stable,
    so the ring, the placement table, and every cached base URL survive
    the restart untouched.

    The slot table itself is elastic (§20): ``add_slot`` grows it and
    ``retire`` shrinks it at runtime. ``self.specs`` is COPY-ON-WRITE —
    every mutation swaps in a fresh dict — so the router's lock-free
    readers (candidate walks, status views, probe sweeps mid-iteration)
    always see a consistent snapshot, never a dict mutated under them.
    """

    def __init__(
        self,
        specs: Sequence[WorkerSpec],
        factory: Callable[[WorkerSpec], object],
    ):
        if not specs:
            raise ValueError("at least one worker spec is required")
        names = [spec.name for spec in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate worker names: {names}")
        self.specs = {spec.name: spec for spec in specs}
        self._factory = factory
        self._lock = lockcheck.named_lock("router.workers")
        self._workers: Dict[str, object] = {}
        self._respawns: Dict[str, int] = {name: 0 for name in self.specs}

    # -- lifecycle -----------------------------------------------------------
    def start_all(self) -> None:
        with self._lock:
            lockcheck.assert_guard("router.workers")
            for name, spec in self.specs.items():
                if name not in self._workers:
                    worker = self._factory(spec)
                    worker.start()
                    self._workers[name] = worker
        self._publish_alive()

    def wait_ready(
        self,
        timeout: float = 180.0,
        poll_interval: float = 0.25,
        probe: Optional[Callable[[WorkerSpec], bool]] = None,
        names: Optional[Sequence[str]] = None,
    ) -> List[str]:
        """Block until every worker answers its ``/healthz`` (or
        ``timeout``); returns the names that became ready. Workers that
        DIED while waiting are reported missing rather than waited on.
        ``names`` restricts the wait to a subset — the elastic layer
        waits on its ONE new worker without re-gating the whole fleet
        (a sick incumbent must not stall a scale-up)."""
        if probe is None:
            probe = _default_ready_probe
        ready: set = set()
        end = time.monotonic() + timeout
        while time.monotonic() < end:
            specs = self.specs  # copy-on-write snapshot per sweep
            wanted = (
                {n: specs[n] for n in names if n in specs}
                if names is not None else specs
            )
            for name, spec in wanted.items():
                if name in ready:
                    continue
                worker = self.worker(name)
                if worker is None or not worker.alive():
                    continue
                try:
                    if probe(spec):
                        ready.add(name)
                except Exception:  # lint: allow-swallow(a failed ready-probe just means not ready yet; the poll loop retries until its deadline)
                    pass
            if len(ready) == len(wanted):
                break
            time.sleep(poll_interval)
        self._publish_alive()
        return sorted(ready)

    def stop_all(self, grace: float = 15.0) -> None:
        with self._lock:
            workers = list(self._workers.values())
        for worker in workers:
            try:
                worker.terminate(grace)
            except Exception:
                logger.warning(
                    "Worker %s terminate failed", worker.spec.name,
                    exc_info=True,
                )
        self._publish_alive()

    # -- views ---------------------------------------------------------------
    def worker(self, name: str):
        with self._lock:
            return self._workers.get(name)

    def workers(self) -> Dict[str, object]:
        with self._lock:
            return dict(self._workers)

    def alive(self, name: str) -> bool:
        worker = self.worker(name)
        return worker is not None and worker.alive()

    def respawn_counts(self) -> Dict[str, int]:
        with self._lock:
            return dict(self._respawns)

    def _publish_alive(self) -> None:
        _M_WORKERS_ALIVE.set(
            sum(1 for w in self.workers().values() if w.alive())
        )

    # -- elastic slots (§20) -------------------------------------------------
    def add_slot(self, spec: WorkerSpec):
        """Grow the slot table by one worker (spawned immediately via
        the supervisor's own factory — subprocess and thread tiers share
        this seam). The caller owns readiness and ring membership; this
        method only makes the process exist.

        Ordering matters: the worker is STARTED before its spec is
        published. A spec visible without a live worker object reads as
        ``dead`` to a concurrent control-plane probe sweep, which would
        quarantine the slot and respawn a duplicate process onto the
        same port — so spec and worker land in the table together, under
        the lock, only once the process exists."""
        with self._lock:
            if spec.name in self.specs:
                raise ValueError(f"worker {spec.name!r} already has a slot")
        worker = self._factory(spec)
        worker.start()
        with self._lock:
            if spec.name in self.specs:
                # lost a naming race (two concurrent scale-ups must not
                # both win a slot): ours never becomes visible — kill it
                try:
                    worker.terminate(2.0)
                except Exception:  # lint: allow-swallow(best-effort kill of the naming-race loser; the ValueError below is the loud signal)
                    pass
                raise ValueError(f"worker {spec.name!r} already has a slot")
            self.specs = {**self.specs, spec.name: spec}
            self._workers[spec.name] = worker
            self._respawns.setdefault(spec.name, 0)
        logger.info("Worker slot %s added (elastic)", spec.name)
        self._publish_alive()
        return worker

    def retire(self, name: str, grace: float = 15.0) -> WorkerSpec:
        """Shrink the slot table: remove ``name`` from the table (probe
        sweeps and status views stop seeing it immediately — a racing
        control-plane respawn finds no spec and no-ops), then terminate
        its worker GRACEFULLY: SIGTERM → the server drains in-flight
        requests and quiesces its engine → exit. The caller must have
        removed the worker from placement first; with that ordering a
        retire drops zero accepted requests."""
        with self._lock:
            spec = self.specs.get(name)
            if spec is None:
                raise KeyError(f"unknown worker {name!r}")
            specs = dict(self.specs)
            specs.pop(name)
            self.specs = specs
            worker = self._workers.pop(name, None)
            self._respawns.pop(name, None)
        if worker is not None:
            try:
                worker.terminate(grace)
            except Exception:
                logger.warning(
                    "Retiring worker %s terminate failed; killing", name,
                    exc_info=True,
                )
                try:
                    worker.kill()
                except Exception:  # lint: allow-swallow(SIGKILL backstop; the terminate failure above already warned with exc_info)
                    pass
        logger.info("Worker slot %s retired (elastic)", name)
        self._publish_alive()
        return spec

    # -- repair --------------------------------------------------------------
    def respawn(
        self, name: str, cause: str = "dead", grace: float = 5.0
    ):
        """Replace slot ``name``'s worker with a fresh one (terminating
        the old process first if it is somehow still alive). Called by
        the control plane when a worker dies or is ejected."""
        spec = self.specs.get(name)
        if spec is None:
            raise KeyError(f"unknown worker {name!r}")
        with self._lock:
            old = self._workers.get(name)
        if old is not None and old.alive():
            try:
                old.terminate(grace)
            except Exception:
                logger.warning(
                    "Ejected worker %s terminate failed; killing", name,
                    exc_info=True,
                )
                try:
                    old.kill()
                except Exception:  # lint: allow-swallow(SIGKILL backstop; the terminate failure above already warned with exc_info)
                    pass
        fresh = self._factory(spec)
        fresh.start()
        with self._lock:
            self._workers[name] = fresh
            self._respawns[name] += 1
        _M_RESPAWNS.labels(name, cause).inc()
        logger.info("Worker %s respawned (cause: %s)", name, cause)
        self._publish_alive()
        return fresh


def _default_ready_probe(spec: WorkerSpec) -> bool:
    try:
        response = http.get(f"{spec.base_url}/healthz", timeout=2.0)
    except http.TransportError:
        return False
    return response.status_code == 200
