"""Elastic workers: spawn and retire serving processes, zero-drop (the
port's copy of ``gordo_components_tpu/autopilot/elastic.py``).

The horizontal tier makes the worker count a CONFIG value; this
module makes it an actuator. Both directions ride machinery that
already exists — nothing new touches a request path:

- **spawn**: a fresh :class:`~..router.workers.WorkerSpec` (next free
  slot id, freshly bound loopback port) goes through
  ``WorkerSupervisor.add_slot`` — the supervisor's OWN factory builds
  the worker, so subprocess tiers spawn subprocesses and test tiers
  spawn thread workers through the identical seam. The new worker joins
  the consistent-hash ring only after its ``/healthz`` answers ready
  (until then the ring doesn't know it, so no request can land on a
  booting process), and ring-join moves only ~1/N of the keys — the
  bounded-movement property placement was built for.
- **retire**: strictly drain-before-retire. The worker leaves the ring
  FIRST (new placements stop immediately; a request already routed to
  it completes normally), then ``WorkerSupervisor.retire`` removes the
  slot and SIGTERMs the process — the graceful path: admission
  closes, in-flight requests finish, the engine quiesces, and only then
  does the process exit. A scale-down therefore drops zero accepted
  requests; anything racing the drain gets the draining 503 the router
  already re-routes.

Scale operations run on a bounded background thread ("gordo-autopilot-
scale"): a worker boot can take tens of seconds (torch import + warmup)
and the controller ticks on the scrape path, which must never block
that long. One operation at a time — ``busy()`` is read by the policy
rule, so the controller holds further decisions until the current op
lands.
"""

from __future__ import annotations

import logging
import socket
import threading
import time
from typing import Callable, Dict, List, Optional

from ..analysis import lockcheck
from ..router.workers import WorkerSpec

logger = logging.getLogger(__name__)


def _free_loopback_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


class ElasticWorkers:
    """Spawn/retire worker slots through an existing supervisor +
    control plane + placement ring.

    ``ready_timeout``: how long a spawned worker may take to answer its
    first healthy probe before the op is abandoned (the slot is retired
    again — a worker that can't boot must not squat the ring).
    ``drain_grace``: the SIGTERM → SIGKILL escalation budget on retire,
    forwarded to the worker's ``terminate``.
    """

    def __init__(
        self,
        supervisor,
        control,
        placement,
        ready_timeout: float = 300.0,
        drain_grace: float = 20.0,
        port_allocator: Callable[[], int] = _free_loopback_port,
        clock: Callable[[], float] = time.monotonic,
    ):
        self.supervisor = supervisor
        self.control = control
        self.placement = placement
        self.ready_timeout = ready_timeout
        self.drain_grace = drain_grace
        self._port_allocator = port_allocator
        self._clock = clock
        self._lock = lockcheck.named_lock("autopilot.elastic")
        self._op_thread: Optional[threading.Thread] = None
        self._last_op: Optional[Dict[str, object]] = None

    # -- views ---------------------------------------------------------------
    def count(self) -> int:
        return len(self.supervisor.specs)

    def busy(self) -> bool:
        with self._lock:
            return self._op_thread is not None and self._op_thread.is_alive()

    def last_op(self) -> Optional[Dict[str, object]]:
        with self._lock:
            return dict(self._last_op) if self._last_op else None

    def join(self, timeout: float = 60.0) -> bool:
        """Wait for the in-flight scale op (tests and the smoke); True
        when idle."""
        with self._lock:
            thread = self._op_thread
        if thread is None or not thread.is_alive():
            return True
        thread.join(timeout=timeout)
        return not thread.is_alive()

    # -- the actuator seam ---------------------------------------------------
    def apply_target(self, target: int) -> Optional[str]:
        """The controller's apply callback: move the worker count ONE
        step toward ``target`` (the AIMD for this actuator is ±1 by
        construction). Returns the affected worker's name, or None when
        nothing could be done (an op already in flight, or no retireable
        worker)."""
        current = self.count()
        if target > current:
            return self.scale_up()
        if target < current:
            return self.scale_down()
        return None

    def scale_up(self) -> Optional[str]:
        """Spawn one worker into a fresh slot; background-completes by
        joining the ring once ready."""
        with self._lock:
            if self._op_thread is not None and self._op_thread.is_alive():
                return None
            spec = self._next_spec_locked()
            thread = threading.Thread(
                target=self._spawn_op, args=(spec,),
                name="gordo-autopilot-scale", daemon=True,
            )
            self._op_thread = thread
            self._last_op = {
                "op": "spawn", "worker": spec.name, "state": "starting",
                "at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            }
        thread.start()
        return spec.name

    def scale_down(self) -> Optional[str]:
        """Retire the newest worker (highest slot id): leave the ring
        now, drain + terminate in the background."""
        with self._lock:
            if self._op_thread is not None and self._op_thread.is_alive():
                return None
            name = self._retire_candidate_locked()
            if name is None:
                return None
            # off the ring BEFORE anything else: from this moment no new
            # placement can choose the retiree (in-flight forwards finish
            # against a still-serving process)
            self.placement.remove_worker(name)
            set_shard = getattr(self.placement, "set_worker_shard", None)
            if callable(set_shard):
                set_shard(name, None)
            thread = threading.Thread(
                target=self._retire_op, args=(name,),
                name="gordo-autopilot-scale", daemon=True,
            )
            self._op_thread = thread
            self._last_op = {
                "op": "retire", "worker": name, "state": "draining",
                "at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            }
        thread.start()
        return name

    # -- op bodies (background thread) ---------------------------------------
    def _spawn_op(self, spec: WorkerSpec) -> None:
        try:
            self.supervisor.add_slot(spec)
            ready = self.supervisor.wait_ready(
                timeout=self.ready_timeout, names=[spec.name]
            )
            if spec.name not in ready:
                logger.warning(
                    "Elastic spawn: %s not ready within %.0fs; retiring "
                    "the slot again", spec.name, self.ready_timeout,
                )
                self.supervisor.retire(spec.name, grace=5.0)
                self._finish_op("spawn_failed", spec.name)
                return
            # ring-join LAST: traffic may now land on a proven-ready
            # worker (bounded key movement steals ~1/N of each incumbent)
            self.placement.add_worker(spec.name)
            shard_for = getattr(self.placement, "mesh_shard_for", None)
            set_shard = getattr(self.placement, "set_worker_shard", None)
            if callable(shard_for) and callable(set_shard):
                shard = shard_for(spec.worker_id)
                if shard is not None:
                    # §23: mesh routers record the new worker's shard so
                    # the candidate walk prefers it for its owned machines
                    set_shard(spec.name, shard)
            self._finish_op("spawned", spec.name)
        except Exception:
            logger.exception("Elastic spawn of %s failed", spec.name)
            self._finish_op("spawn_failed", spec.name)

    def _retire_op(self, name: str) -> None:
        try:
            # retire = pop the slot (control plane stops probing it, the
            # router stops listing it) + graceful SIGTERM terminate: the
            # worker drains its in-flight requests before exiting
            self.supervisor.retire(name, grace=self.drain_grace)
            forget = getattr(self.control, "forget", None)
            if callable(forget):
                forget(name)
            self._finish_op("retired", name)
        except Exception:
            logger.exception("Elastic retire of %s failed", name)
            self._finish_op("retire_failed", name)

    def _finish_op(self, state: str, worker: str) -> None:
        with self._lock:
            self._last_op = {
                "op": state, "worker": worker, "state": state,
                "at": time.strftime("%Y-%m-%dT%H:%M:%S%z"),
            }
        logger.info("Elastic workers: %s %s", state, worker)

    # -- slot arithmetic -----------------------------------------------------
    def _next_spec_locked(self) -> WorkerSpec:
        specs: Dict[str, WorkerSpec] = dict(self.supervisor.specs)
        next_id = max(
            (spec.worker_id for spec in specs.values()), default=-1
        ) + 1
        host = next(iter(specs.values())).host if specs else "127.0.0.1"
        return WorkerSpec(
            f"worker-{next_id}", next_id, host, self._port_allocator()
        )

    def _retire_candidate_locked(self) -> Optional[str]:
        specs: List[WorkerSpec] = sorted(
            self.supervisor.specs.values(), key=lambda s: s.worker_id
        )
        if len(specs) <= 1:
            return None  # never retire the last worker, whatever the knobs
        return specs[-1].name
