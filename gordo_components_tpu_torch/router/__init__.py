"""Horizontal serving tier: router + supervised worker processes (the
port's copy of ``gordo_components_tpu/router/``).

``placement`` — consistent-hash machine→worker assignment with
hot-machine replication; ``workers`` — worker process lifecycle;
``router`` — the routing HTTP front; ``rollout`` — canary→sweep
generation adoption. The control plane driving eject/respawn lives in
``watchman.control``.

``assemble_fleet`` / ``run_fleet_server`` assemble the whole tier the way
``python -m gordo_components_tpu_torch.cli run-fleet-server`` does; tests
and tools reuse them with injected worker factories. With ``mesh_shards``
the tier is a fleet-sharded serving mesh (reference ``router/__init__.py:
34-60``, ``:92-169``, ``:186-231``): worker i serves shard i mod shards of
``parallel/shard_plan.py``'s layout, and placement walks each machine's
owning shard's workers first. Nothing in this package imports ``torch``
(nor does the shard plan): only the workers touch the card.
"""

from __future__ import annotations

import logging
from typing import Callable, Iterable, Optional, Sequence

from ..watchman.control import ControlPlane, jittered_interval
from .placement import HashRing, Placement
from .rollout import RolloutManager
from .router import FleetRouter, make_router_server
from .workers import (
    SubprocessWorker,
    WorkerSpec,
    WorkerSupervisor,
    server_worker_argv,
    worker_specs,
)

logger = logging.getLogger(__name__)


def _fleet_at_least(models_root: str, n: int) -> bool:
    """Whether ``models_root`` holds at least ``n`` model dirs — the one
    fact the mesh layout policy needs. Same walk rule as the server's
    scan with the shared store-layer predicate, but SHORT-CIRCUITED at
    ``n``: a 100k-machine tree costs O(n) predicate checks at router boot,
    not a full scan."""
    import os

    from ..store import generations as store_generations

    if n <= 0:
        return True
    count = 0
    try:
        entries = os.listdir(models_root)  # unsorted: order is irrelevant
    except OSError:
        return True  # unreadable root: workers decide; don't un-mesh
    for entry in entries:
        path = os.path.join(models_root, entry)
        if entry.startswith(".") or not os.path.isdir(path):
            continue
        if store_generations.is_artifact_dir(path):
            count += 1
            if count >= n:
                return True
    return False


__all__ = [
    "ControlPlane",
    "FleetRouter",
    "HashRing",
    "Placement",
    "RolloutManager",
    "SubprocessWorker",
    "WorkerSpec",
    "WorkerSupervisor",
    "assemble_fleet",
    "jittered_interval",
    "make_router_server",
    "run_fleet_server",
    "server_worker_argv",
    "worker_specs",
]


def assemble_fleet(
    specs: Sequence[WorkerSpec],
    factory: Callable[[WorkerSpec], object],
    project: str = "project",
    models_root: Optional[str] = None,
    replicas: int = 2,
    hot_rps: float = 50.0,
    hot: Iterable[str] = (),
    probe_timeout: float = 3.0,
    breaker_recovery: float = 10.0,
    respawn: bool = True,
    boot_grace: float = 60.0,
    forward_timeout: float = 60.0,
    mesh_shards: int = 0,
) -> FleetRouter:
    """Wire supervisor + control plane + placement + router together
    (nothing started yet — callers own start/stop ordering).

    ``mesh_shards`` > 0 makes this a MESH router: the shard plan resolves
    each machine's owning shard, workers cover shards round-robin by slot
    id, and placement walks the owner shard's workers before the
    spill-fallback rest. The workers themselves must be spawned with the
    matching ``--mesh-shards``/``--mesh-shard`` flags (``run_fleet_server``
    does both sides from one knob)."""
    supervisor = WorkerSupervisor(specs, factory)
    control = ControlPlane(
        supervisor,
        probe_timeout=probe_timeout,
        breaker_recovery=breaker_recovery,
        respawn=respawn,
        boot_grace=boot_grace,
    )
    placement = Placement(
        [spec.name for spec in specs],
        replicas=replicas,
        hot_rps=hot_rps,
        hot=hot,
    )
    mesh_refresh = None
    if mesh_shards and int(mesh_shards) > 0:
        from ..parallel.shard_plan import resolve_plan, worker_shard

        plan = resolve_plan(int(mesh_shards))

        def mesh_refresh():
            """Apply the SAME declared layout policy the workers apply: a
            fleet below the sharding threshold stays replicated on every
            shard, so the router must NOT prefer an "owner" group (that
            would halve a hot machine's replica spread while every worker
            serves it eagerly). Called at assemble time and after every
            /reload — fleet membership can cross the threshold at runtime,
            and each worker's rescan re-derives its side of exactly this
            decision."""
            sharded = plan.n_shards > 1 and (
                models_root is None
                or _fleet_at_least(models_root, plan.min_shard_machines)
            )
            flipped = placement.set_mesh(
                plan.shard_of if sharded else None,
                {
                    name: worker_shard(spec.worker_id, plan.n_shards)
                    for name, spec in supervisor.specs.items()
                }
                if sharded else None,
                plan.n_shards if sharded else None,
            )
            if flipped or not sharded:
                logger.info(
                    "Mesh placement policy: %s",
                    "sharded by ring position" if sharded else
                    f"replicated (fleet below the {plan.min_shard_machines}-machine "
                    f"threshold)",
                )

        mesh_refresh()
    router = FleetRouter(
        supervisor,
        control,
        placement=placement,
        project=project,
        models_root=models_root,
        forward_timeout=forward_timeout,
    )
    # the reload endpoint re-derives the layout policy after fleet
    # membership changes (None on non-mesh routers)
    router.mesh_refresh = mesh_refresh
    # the observed shard count the reconciler diffs a declared mesh_shards
    # against (None: a fleet assembled without a mesh)
    router.mesh_shards = int(mesh_shards) if mesh_shards else None
    return router


def run_fleet_server(
    models_dir: str,
    workers: int = 2,
    host: str = "0.0.0.0",
    port: int = 5555,
    worker_host: str = "127.0.0.1",
    worker_base_port: int = 5600,
    project: str = "project",
    replicas: int = 2,
    hot_rps: float = 50.0,
    probe_interval: float = 2.0,
    ready_timeout: float = 300.0,
    worker_args: Sequence[str] = (),
    mesh_shards: int = 0,
    device: Optional[str] = None,
) -> None:
    """``run-fleet-server``: spawn N worker server processes over one
    ``models_dir`` (``--device`` passed on to each), wait for them, start
    the control plane, and serve the router. SIGTERM shuts the whole tier
    down: the router stops routing, then every worker gets its own SIGTERM
    (graceful drain) before the process exits — killing the router must
    never orphan N worker processes.

    ``mesh_shards`` > 0 boots a MESH tier: worker ``i`` serves shard ``i mod
    mesh_shards`` (only its owned machines stack eagerly; the rest serve
    through the spill fallback rung), and the router's placement walks
    owner-shard workers first — one knob drives both sides of the layout,
    so they can never disagree. An elastic worker's slot id gives its shard
    the same way (``Placement.mesh_shard_for``)."""
    import signal
    import threading

    specs = worker_specs(workers, worker_base_port, host=worker_host)

    def factory(spec: WorkerSpec) -> SubprocessWorker:
        extra = list(worker_args)
        if mesh_shards and int(mesh_shards) > 0:
            from ..parallel.shard_plan import worker_shard

            extra += [
                "--mesh-shards", str(int(mesh_shards)),
                "--mesh-shard", str(worker_shard(spec.worker_id, int(mesh_shards))),
            ]
        return SubprocessWorker(
            spec,
            server_worker_argv(
                spec, models_dir, project=project, extra=extra, device=device,
            ),
        )

    app = assemble_fleet(
        specs,
        factory,
        project=project,
        models_root=models_dir,
        replicas=replicas,
        hot_rps=hot_rps,
        mesh_shards=mesh_shards,
    )
    supervisor, control = app.supervisor, app.control
    supervisor.start_all()
    # EVERYTHING past start_all runs under the teardown guard: a router
    # that fails to come up (port already bound, wait_ready timeout)
    # must never exit leaving N orphaned worker processes squatting
    # their ports
    server = None
    try:
        ready = supervisor.wait_ready(timeout=ready_timeout)
        if not ready:
            raise RuntimeError(
                f"no worker became ready within {ready_timeout:.0f}s"
            )
        if len(ready) < workers:
            logger.warning(
                "Only %d/%d workers ready; control plane will repair "
                "the rest", len(ready), workers,
            )
        control.start(interval=probe_interval)
        server = make_router_server(app, host, port)

        def _on_sigterm(signum, frame) -> None:
            logger.info("SIGTERM: shutting the fleet tier down")
            # a thread: shutdown() must not run on the serve_forever
            # thread
            threading.Thread(
                target=server.shutdown, name="gordo-router-stop",
                daemon=True,
            ).start()

        try:
            signal.signal(signal.SIGTERM, _on_sigterm)
        except ValueError:
            logger.debug(
                "SIGTERM handler not installed (non-main thread)"
            )
        logger.info(
            "Fleet router serving %d worker(s) on http://%s:%d (workers at %s)",
            workers, host, server.server_address[1],
            ", ".join(spec.base_url for spec in specs),
        )
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
    finally:
        # control FIRST: a probe loop racing the worker teardown would
        # read every SIGTERM'd worker as dead and respawn it
        control.stop()
        supervisor.stop_all()
        if server is not None:
            server.server_close()  # closes the router's connections too
        else:
            app.close()
        logger.info("Fleet tier stopped")
