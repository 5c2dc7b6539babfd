"""Role assembly: the router-side reconciler over the live seams (the
port's copy of ``gordo_components_tpu/fleet/wiring.py``).

Mirrors ``autopilot.build_router_autopilot``: one constructor that binds
the :class:`~.reconciler.Reconciler`'s observation and repair surfaces
to the router's existing organs — supervisor slot table, control-plane
routability, rollout reload/verify verbs, elastic scaling, generation
pinning on the shared models root, autopilot bound ownership, the
workers' ``/layout`` route, and the telemetry warehouse's
measured-capacity feed.

Where the port differs, by design: observation and the ``/layout``
posts go through the port's HTTP client (:class:`~..utils.http.Session`),
the artifacts' precision rungs are read from their ``metadata.json``
without the serializer (the router's process never imports ``torch``).
``observed.mesh_shards`` is the router's (None without a mesh, so the
``mesh`` class never diverges there) and the ``mesh`` class repairs
through the router's ``mesh_refresh``.

``GORDO_FLEET=0`` is the hard kill switch (no reconciler is
constructed; ``/fleet`` answers ``hard_off``). Constructed reconcilers
are harmless until a spec is committed: with an empty journal every
tick is a no-op diff.
"""

from __future__ import annotations

import json
import logging
import os
import time
from typing import Any, Dict, Optional, Tuple

from .. import precision as precision_mod
from ..observability import telemetry as telemetry_engine
from ..store import generations as generations_mod
from ..utils import http
from . import capacity
from .reconciler import Observed, Reconciler, RepairSeams
from .spec import SpecStore

logger = logging.getLogger(__name__)


def hard_off() -> bool:
    """Explicit ``GORDO_FLEET=0``: no reconciler exists."""
    return os.environ.get("GORDO_FLEET", "").strip().lower() in (
        "0", "false", "off", "no",
    )


def scan_disk_state(
    models_root: str,
) -> Tuple[Dict[str, Optional[str]], Dict[str, str]]:
    """On-disk truth for every fleet member: ``CURRENT`` generation and
    the built precision rung (from the artifact's build metadata)."""
    disk_generations: Dict[str, Optional[str]] = {}
    disk_precisions: Dict[str, str] = {}
    for machine, entry in generations_mod.build_fleet_index(
        models_root
    ).items():
        disk_generations[machine] = entry.get("generation")
        try:
            metadata = _read_metadata(os.path.join(models_root, machine))
        except Exception:  # noqa: BLE001  # lint: allow-swallow(unreadable metadata: no precision fact beats a wrong one; the artifact's own verified load is the loud path)
            metadata = {}
        try:
            disk_precisions[machine] = precision_mod.of_metadata(metadata)
        except Exception:  # noqa: BLE001  # lint: allow-swallow(metadata without a rung stamp: same contract as above — the machine simply contributes no precision divergence)
            pass
    return disk_generations, disk_precisions


def _read_metadata(machine_dir: str) -> Dict[str, Any]:
    """The artifact's build metadata (``metadata.json`` of its current
    generation), ``{}`` when it has none."""
    path = os.path.join(
        generations_mod.resolve_artifact_dir(machine_dir), "metadata.json"
    )
    if not os.path.exists(path):
        return {}
    with open(path) as fh:
        return json.load(fh)


def build_router_reconciler(
    router,
    rebuild=None,
    clock=time.time,
) -> Optional[Reconciler]:
    """Wire a reconciler over a :class:`~..router.router.FleetRouter`.
    None under the hard kill switch or without a ``models_root`` (no
    place to journal specs, no disk truth to diff). ``rebuild`` is the
    optional precision-rebuild seam (``(machine, rung) -> Any``) — the
    serving tier cannot rebuild artifacts itself, so without one the
    precision class journals ``unwired``."""
    if hard_off():
        return None
    models_root = router.models_root
    if not models_root:
        logger.info(
            "Fleet reconciler not constructed: router has no models_root"
        )
        return None
    spec_store = SpecStore(models_root, clock=clock)
    pilot = router.autopilot
    supervisor = router.supervisor
    control = router.control

    def observe() -> Observed:
        names = sorted(supervisor.specs)
        dead = [name for name in names if not supervisor.alive(name)]
        ready = [
            name for name in names
            if name not in dead and control.routable(name)
        ]
        worker_generations: Dict[str, Dict[str, str]] = {}
        worker_layouts: Dict[str, Optional[str]] = {}
        for name in ready:
            spec = supervisor.specs[name]
            try:
                body = router._session.get(
                    f"{spec.base_url}/healthz",
                    timeout=router.scrape_timeout,
                ).json()
            except (http.TransportError, ValueError, AttributeError):
                # a scrape miss: an unreachable worker contributes no
                # adoption facts this tick; routability is the control
                # plane's verdict
                continue
            gens = (body.get("store") or {}).get("generations") or {}
            worker_generations[name] = {
                machine: gen for machine, gen in gens.items()
                if isinstance(gen, str)
            }
            # the layout-plan fingerprint this worker applied
            fp = body.get("layout")
            worker_layouts[name] = fp if isinstance(fp, str) else None
        disk_generations, disk_precisions = scan_disk_state(models_root)
        bounds = None
        if pilot is not None:
            actuator = pilot.actuators.get("workers")
            if actuator is not None:
                bounds = (actuator.bounds.lo, actuator.bounds.hi)
        return Observed(
            workers_total=len(names),
            workers_ready=ready,
            workers_dead=dead,
            worker_generations=worker_generations,
            disk_generations=disk_generations,
            disk_precisions=disk_precisions,
            mesh_shards=getattr(router, "mesh_shards", None),
            elastic_busy=(
                pilot.elastic.busy()
                if pilot is not None and hasattr(pilot, "elastic")
                else False
            ),
            autopilot_bounds=bounds,
            placement_weights=router.placement.worker_weights(),
            worker_layouts=worker_layouts,
        )

    # the telemetry view is fetched once per tick (calibrate runs before
    # the diff) and reused by the derived-bounds default
    view_cache: Dict[str, Any] = {}

    def calibrate() -> None:
        if not telemetry_engine.enabled():
            return
        try:
            merged, _ = router._aggregate_telemetry(300.0)
        except Exception:
            logger.exception("Reconciler: telemetry fetch failed")
            return
        view_cache["view"] = merged
        if pilot is not None:
            capacity.calibrate_autopilot(pilot, merged)

    def default_worker_bounds() -> Optional[Tuple[int, int]]:
        # imported here, not at module top: autopilot pulls in the
        # router package, which imports this one (cycle otherwise)
        from ..autopilot import policy

        hard = policy.bounds_knob(
            "GORDO_AUTOPILOT_WORKER_BOUNDS", policy.Bounds(1, 8)
        )
        view = view_cache.get("view")
        if view:
            derived = capacity.derive_worker_bounds(view, (hard.lo, hard.hi))
            if derived is not None:
                return derived
        return (hard.lo, hard.hi)

    def pin_generation(machine: str, gen: str) -> str:
        return generations_mod.pin_generation(
            os.path.join(models_root, machine), gen
        )

    def mesh_refresh() -> None:
        # bound lazily: assemble_fleet attaches router.mesh_refresh
        # AFTER the router (and this reconciler) is constructed
        fn = getattr(router, "mesh_refresh", None)
        if fn is None:
            raise RuntimeError("router has no mesh layout to refresh")
        fn()

    def apply_worker_layout(
        worker: str, plan: Optional[Dict[str, Any]]
    ) -> Dict[str, Any]:
        """Land one worker's slice of the committed plan on its /layout
        endpoint — or clear it (rollback's direction)."""
        spec = supervisor.specs.get(worker)
        if spec is None:
            raise RuntimeError(f"worker {worker!r} left the slot table")
        if plan is None:
            payload: Dict[str, Any] = {"clear": True}
        else:
            residency = (plan.get("residency") or {})
            entry = (residency.get("workers") or {}).get(worker) or {}
            payload = {
                "fingerprint": plan.get("fingerprint"),
                "resident": list(entry.get("resident") or ()),
                "cap": residency.get("cap"),
                "prefetch": list(
                    (plan.get("prefetch") or {}).get(worker) or ()
                ),
            }
        reply = router._session.post(
            f"{spec.base_url}/layout", body=json.dumps(payload).encode(),
            timeout=router.scrape_timeout,
            headers={"Content-Type": "application/json"},
        )
        reply.raise_for_status()
        return reply.json()

    def rederive_layout(
        plan: Dict[str, Any]
    ) -> Optional[Dict[str, Any]]:
        """Judge the committed plan against fresh telemetry; compile a
        replacement when it went stale. None = plan stands (also on any
        telemetry/compile trouble — a flaky scrape must never churn
        committed plans)."""
        from ..layout import compiler as layout_compiler

        if not telemetry_engine.enabled():
            return None
        window = telemetry_engine.parse_window(
            os.environ.get("GORDO_LAYOUT_HORIZON")
        ) or 600.0
        try:
            merged, _ = router._aggregate_telemetry(window)
            doc = telemetry_engine.build_export(merged, window=window)
        except Exception:
            logger.exception("Reconciler: layout telemetry fetch failed")
            return None
        reason = layout_compiler.staleness(plan, doc)
        if reason is None:
            return None
        ready = [
            name for name in sorted(supervisor.specs)
            if supervisor.alive(name) and control.routable(name)
        ]
        cap = (plan.get("residency") or {}).get("cap")
        try:
            fresh = layout_compiler.compile_plan(
                doc, workers=ready or None, residency_cap=cap,
            )
        except ValueError as exc:
            logger.warning(
                "Reconciler: stale layout plan (%s) but fresh telemetry "
                "does not compile: %s", reason, exc,
            )
            return None
        logger.info("Reconciler: layout plan stale (%s)", reason)
        return fresh

    seams = RepairSeams(
        respawn=lambda name: supervisor.respawn(name, cause="reconcile"),
        scale=(
            pilot.elastic.apply_target
            if pilot is not None and hasattr(pilot, "elastic") else None
        ),
        pin_generation=pin_generation,
        rebuild=rebuild,
        reload_worker=router.rollout.reload_worker,
        verify_worker=router.rollout.verify_worker,
        mesh_refresh=mesh_refresh,
        set_worker_bounds=(
            (lambda lo, hi: pilot.set_bounds("workers", lo, hi))
            if pilot is not None else None
        ),
        acquire_op=router.rollout.try_claim_op,
        release_op=router.rollout.release_op,
        calibrate=calibrate,
        default_worker_bounds=default_worker_bounds,
        set_placement_weights=router.placement.set_worker_weights,
        apply_worker_layout=apply_worker_layout,
        rederive_layout=rederive_layout,
    )
    return Reconciler(spec_store, observe, seams, clock=clock)
