"""Declarative fleet control (the port's copy of
``gordo_components_tpu/fleet/``).

A controller converges the fleet onto declared state, over the
repo's own actuators. :mod:`.spec` is the artifact: a versioned
:class:`~gordo_components_tpu_torch.fleet.spec.FleetSpec` committed
through an fsync'd journal (rollback = re-apply the previous revision);
:mod:`.reconciler` is the mechanism: a scrape-driven diff/repair loop
that drives the EXISTING seams (respawn, elastic scaling, canary→sweep
adoption, generation pinning, autopilot bounds, ring weights, the
workers' ``/layout``) toward the declared state, journaling every repair
with WAL idempotence keys so a crash mid-apply resumes without
double-applying. :mod:`.capacity` folds the telemetry warehouse's
measured-cost ledger into the spec's default worker bounds and the
autopilot's thresholds. :mod:`.wiring` binds it all to a live router.
Nothing here imports ``torch``.
"""

from .spec import FleetSpec, SpecError, SpecStore  # noqa: F401
from .reconciler import (  # noqa: F401
    Divergence,
    Observed,
    Reconciler,
    RepairSeams,
    diff_spec,
)
from .wiring import build_router_reconciler  # noqa: F401
