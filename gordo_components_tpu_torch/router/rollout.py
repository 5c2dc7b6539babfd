"""Rolling generation adoption: canary one worker, verify, sweep (the
port's copy of ``gordo_components_tpu/router/rollout.py``; worker calls
ride the port's ``utils.http.Session``).

Every worker serves the same ``models_root`` tree, whose machines are
``gen-NNNN/`` generation roots behind an atomically-swapped ``CURRENT``
pointer (store/). A new generation (fleet rebuild, single-machine
rebuild) is therefore ALREADY on disk everywhere the moment it commits —
adoption is just each worker's ``POST /reload``, which loads the new
artifact and warms its engine before it swaps.

The rollout contract:

- **canary** — exactly one worker reloads first. If its reload errors or
  it stops answering ready afterwards, the rollout ABORTS: the other
  workers never reloaded, so the fleet keeps serving the old generation
  (minus one canary the control plane will notice and repair). A bad
  build costs one worker, never the fleet.
- **sweep** — after the canary verifies, the remaining workers reload
  one at a time. Sequential on purpose: at any instant at most one
  worker is paying its reload, so fleet capacity never dips by more than
  1/N, and a mid-sweep failure leaves a named, bounded set of workers on
  each generation (reported per worker, repairable by re-POSTing).
- **rollback** — ``CURRENT`` is swapped back once per machine root on
  shared disk BEFORE any worker reloads: the pointer swap is atomic
  fleet-wide (no worker can adopt the bad generation after it), and the
  same canary→sweep adoption walks the fleet onto the restored one.
"""

from __future__ import annotations

import logging
import time
from typing import Any, Dict, List, Optional

from ..analysis import lockcheck
from ..observability import ledger as control_ledger
from ..observability.registry import REGISTRY
from ..utils import http

logger = logging.getLogger(__name__)

_M_ROLLOUTS = REGISTRY.counter(
    "gordo_router_rollouts_total",
    "Rolling generation adoptions, by kind (reload / rollback) and "
    "outcome (complete / partial / aborted / no_workers)",
    labels=("kind", "outcome"),
)


class RolloutManager:
    """Canary → verify → sweep over a supervisor's workers.

    ``verify_timeout`` bounds how long the canary gets to answer ready
    after its reload before the rollout is aborted (a reload that wedged
    the worker must not be swept fleet-wide)."""

    def __init__(
        self,
        supervisor,
        control,
        session=None,
        models_root: Optional[str] = None,
        reload_timeout: float = 300.0,
        verify_timeout: float = 30.0,
    ):
        self.supervisor = supervisor
        self.control = control
        self.models_root = models_root
        self.reload_timeout = reload_timeout
        self.verify_timeout = verify_timeout
        self._session = session if session is not None else http.Session()
        self._lock = lockcheck.named_lock("router.rollout_state")
        # at most ONE rollout/rollback at a time: the capacity contract
        # ("never dips more than 1/N") and the generation bookkeeping
        # both assume the sweep is the only reload traffic — a second
        # concurrent POST must answer "busy", not interleave
        self._op_lock = lockcheck.named_lock("router.op")
        self._last: Optional[Dict[str, Any]] = None

    # -- worker verbs --------------------------------------------------------
    def _reload_worker(self, name: str) -> Dict[str, Any]:
        spec = self.supervisor.specs[name]
        try:
            response = self._session.post(
                f"{spec.base_url}/reload", timeout=self.reload_timeout
            )
        except http.TransportError as exc:
            return {"ok": False, "error": repr(exc)}
        body: Dict[str, Any] = {}
        try:
            parsed = response.json()
            if isinstance(parsed, dict):
                body = parsed
        except ValueError:
            pass
        if response.status_code != 200:
            return {
                "ok": False,
                "error": f"HTTP {response.status_code}: "
                         f"{body.get('error', '')}",
            }
        return {"ok": True, "reload": body}

    def _verify_worker(self, name: str) -> Dict[str, Any]:
        """Post-reload verification: the worker must answer ``/healthz``
        ready within ``verify_timeout``. Degraded-but-ready passes (a
        pre-existing quarantined machine must not veto a fleet rollout);
        not answering, or ready:false, fails."""
        spec = self.supervisor.specs[name]
        end = time.monotonic() + self.verify_timeout
        last_error = "verify window empty"
        while time.monotonic() < end:
            try:
                response = self._session.get(
                    f"{spec.base_url}/healthz", timeout=5.0
                )
                body = response.json()
                if response.status_code == 200 and body.get("ready"):
                    return {
                        "ok": True,
                        "generations": (body.get("store") or {}).get(
                            "generations"
                        ),
                    }
                last_error = f"HTTP {response.status_code}: " \
                             f"status={body.get('status')!r}"
            except (http.TransportError, ValueError) as exc:
                last_error = repr(exc)
            time.sleep(0.2)
        return {"ok": False, "error": last_error}

    # public aliases for the fleet reconciler (§26): its per-worker
    # canary→sweep steps ride the SAME reload/verify verbs the operator
    # rollout uses, so a worker cannot tell the two apart
    def reload_worker(self, name: str) -> Dict[str, Any]:
        return self._reload_worker(name)

    def verify_worker(self, name: str) -> Dict[str, Any]:
        return self._verify_worker(name)

    def try_claim_op(self) -> bool:
        """Non-blocking claim of the one-rollout-at-a-time lock — the
        reconciler's adoption steps must never interleave with an
        operator ``/reload``/``/rollback`` (and vice versa: while the
        reconciler holds it, those answer busy)."""
        return self._op_lock.acquire(blocking=False)

    def release_op(self) -> None:
        self._op_lock.release()

    def _routable_workers(self) -> List[str]:
        return [
            name
            for name in sorted(self.supervisor.specs)
            if self.control.routable(name)
        ]

    # -- rolling adoption ----------------------------------------------------
    def rolling_reload(self, kind: str = "reload") -> Dict[str, Any]:
        """Canary one routable worker's ``/reload``, verify it, sweep the
        rest sequentially. Returns the per-worker outcome map; sets
        ``aborted`` when the canary failed and the sweep never ran.
        Concurrent rollouts are refused (``busy``), never interleaved —
        two sweeps running at once would reload several workers
        simultaneously and split the fleet across generations."""
        if not self._op_lock.acquire(blocking=False):
            _M_ROLLOUTS.labels(kind, "busy").inc()
            return {
                "kind": kind,
                "aborted": True,
                "error": "a rollout is already in progress",
                "busy": True,
            }
        try:
            return self._rolling_reload_locked(kind)
        finally:
            self._op_lock.release()

    def _rolling_reload_locked(self, kind: str) -> Dict[str, Any]:
        workers = self._routable_workers()
        result: Dict[str, Any] = {
            "kind": kind,
            "at": time.strftime("%Y-%m-%d %H:%M:%S%z"),
            "workers": {},
            "aborted": False,
        }
        if not workers:
            result["aborted"] = True
            result["error"] = "no routable workers"
            _M_ROLLOUTS.labels(kind, "no_workers").inc()
            return self._finish(result)
        canary, rest = workers[0], workers[1:]
        result["canary"] = canary
        reloaded = self._reload_worker(canary)
        if reloaded["ok"]:
            verified = self._verify_worker(canary)
            reloaded["verified"] = verified
            reloaded["ok"] = verified["ok"]
        result["workers"][canary] = reloaded
        # §28: the canary step is the rollout's first control event —
        # an abort right after it is the strongest root-cause signal a
        # bad build leaves behind
        control_ledger.emit(
            actor="rollout", action="canary", target=canary,
            after="ok" if reloaded["ok"] else "failed",
            reason=str(reloaded.get("error") or ""),
        )
        if not reloaded["ok"]:
            # the canary caught it: the sweep never runs, the fleet keeps
            # serving the old generation. The canary itself is left to the
            # control plane (a wedged reload reads as unreachable and gets
            # the worker ejected + respawned against the on-disk CURRENT).
            result["aborted"] = True
            result["error"] = (
                f"canary {canary} failed: "
                f"{reloaded.get('error') or reloaded.get('verified')}"
            )
            logger.warning("Rollout aborted: %s", result["error"])
            _M_ROLLOUTS.labels(kind, "aborted").inc()
            control_ledger.emit(
                actor="rollout", action="sweep", target=kind,
                after="aborted", reason=str(result["error"]),
            )
            return self._finish(result)
        failures = 0
        for name in rest:
            swept = self._reload_worker(name)
            if swept["ok"]:
                verified = self._verify_worker(name)
                swept["verified"] = verified
                swept["ok"] = verified["ok"]
            if not swept["ok"]:
                # a sweep failure is NOT an abort: the generation is
                # already proven by the canary, so keep walking — the
                # failed worker is named in the result and the control
                # plane repairs it (respawn adopts CURRENT at boot)
                failures += 1
                logger.warning(
                    "Rollout sweep: worker %s failed (%s)",
                    name, swept.get("error"),
                )
            result["workers"][name] = swept
        outcome = "partial" if failures else "complete"
        result["failures"] = failures
        _M_ROLLOUTS.labels(kind, outcome).inc()
        logger.info(
            "Rollout %s %s: canary %s, %d swept, %d failed",
            kind, outcome, canary, len(rest) - failures, failures,
        )
        control_ledger.emit(
            actor="rollout", action="sweep", target=kind, after=outcome,
            reason=f"{len(rest) - failures} swept, {failures} failed",
        )
        return self._finish(result)

    # -- fleet-wide rollback -------------------------------------------------
    def rollback(self) -> Dict[str, Any]:
        """Swap every machine root's ``CURRENT`` back one verified
        generation (one atomic pointer swap per machine, all on shared
        disk, BEFORE any worker reloads), then adopt via the same
        canary→sweep. Machines without a previous verified generation are
        reported and skipped — a partially-rollback-able fleet rolls back
        what it can, loudly."""
        from ..store.errors import StoreError
        from ..store.generations import is_generation_root, rollback_generation, scan_models_dir

        if not self.models_root:
            raise ValueError("rollback requires a models_root")
        # the op lock covers the CURRENT swaps AND the adoption: a
        # /reload racing the swaps could adopt a half-rolled-back tree
        if not self._op_lock.acquire(blocking=False):
            _M_ROLLOUTS.labels("rollback", "busy").inc()
            return {
                "kind": "rollback",
                "aborted": True,
                "error": "a rollout is already in progress",
                "busy": True,
            }
        try:
            restored: Dict[str, str] = {}
            skipped: Dict[str, str] = {}
            for name, path in sorted(
                scan_models_dir(self.models_root).items()
            ):
                if not is_generation_root(path):
                    skipped[name] = "flat (pre-generation) artifact"
                    continue
                try:
                    restored[name] = rollback_generation(path)
                except StoreError as exc:
                    skipped[name] = str(exc)
            control_ledger.emit(
                actor="rollout", action="rollback", target="fleet",
                after={"restored": len(restored), "skipped": len(skipped)},
            )
            result = self._rolling_reload_locked(kind="rollback")
            result["restored"] = restored
            result["skipped"] = skipped
            return self._finish(result)
        finally:
            self._op_lock.release()

    # -- state ---------------------------------------------------------------
    def _finish(self, result: Dict[str, Any]) -> Dict[str, Any]:
        with self._lock:
            self._last = result
        return result

    def last(self) -> Optional[Dict[str, Any]]:
        with self._lock:
            return self._last
