"""The fleet layout compiler (the port's copy of
``gordo_components_tpu/layout/``).

Four placement axes (ring shard assignment, megabatch residency,
precision rung, host-RAM spill prefetch) are ONE compiled,
cost-model-driven decision here, made from the telemetry warehouse's
measurements:

- :mod:`costmodel` scores candidate layouts on measured telemetry (the
  ``gordo-layout-input/v1`` export): device-bytes-per-worker balance,
  expected residency hit rate under the observed rate distribution, and
  a traffic-weighted p99 proxy.
- :mod:`compiler` emits the deterministic, versioned
  ``gordo-layout-plan/v1`` artifact and checks a committed plan's
  staleness against fresh telemetry.
- :mod:`plan` is the dependency-free plan contract: validator,
  canonical fingerprint, and the ``explain`` rendering that names why
  each machine moved.

The plan is DECLARED (a ``FleetSpec.layout`` field, journaled like
every other spec change) and APPLIED by the reconciler through existing
seams only: placement weight overrides, the workers' ``/layout`` route
(residency pins, the residency cap, ``/prefetch`` hints). Rollback is a
new spec revision, exactly like any other fleet change. Nothing here
imports ``torch``.
"""

from .compiler import compile_plan, staleness  # noqa: F401
from .costmodel import CostModel, machine_rates  # noqa: F401
from .plan import (  # noqa: F401
    PLAN_SCHEMA,
    explain_plan,
    plan_fingerprint,
    validate_layout_plan,
)
