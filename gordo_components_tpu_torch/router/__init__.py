"""Horizontal serving tier: router + supervised worker processes (the
port's copy of ``gordo_components_tpu/router/``).

``placement`` — consistent-hash machine→worker assignment with
hot-machine replication; ``workers`` — worker process lifecycle;
``router`` — the routing HTTP front; ``rollout`` — canary→sweep
generation adoption. The control plane driving eject/respawn lives in
``watchman.control``.

``assemble_fleet`` / ``run_fleet_server`` assemble the whole tier the way
``python -m gordo_components_tpu_torch.cli run-fleet-server`` does; tests
and tools reuse them with injected worker factories. Nothing in this
package imports ``torch``: only the workers touch the card.
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

MESH_NOT_PORTED = (
    "mesh serving (mesh_shards > 0) is not ported: the shard plan needs "
    "several cards (ROADMAP.md Queue 1 item 10)"
)

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
    ``mesh_shards`` > 0 raises ``NotImplementedError``."""
    if mesh_shards and int(mesh_shards) > 0:
        raise NotImplementedError(MESH_NOT_PORTED)
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
    return FleetRouter(
        supervisor,
        control,
        placement=placement,
        project=project,
        models_root=models_root,
        forward_timeout=forward_timeout,
    )


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
    never orphan N worker processes."""
    import signal
    import threading

    if mesh_shards and int(mesh_shards) > 0:
        raise NotImplementedError(MESH_NOT_PORTED)
    specs = worker_specs(workers, worker_base_port, host=worker_host)

    def factory(spec: WorkerSpec) -> SubprocessWorker:
        return SubprocessWorker(
            spec,
            server_worker_argv(
                spec, models_dir, project=project, extra=worker_args, device=device,
            ),
        )

    app = assemble_fleet(
        specs,
        factory,
        project=project,
        models_root=models_dir,
        replicas=replicas,
        hot_rps=hot_rps,
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
