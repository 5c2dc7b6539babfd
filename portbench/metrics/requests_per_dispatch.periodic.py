"""Requests fused per device dispatch over the window: the change of
``gordo_engine_requests_total`` over that of
``gordo_engine_dispatch_seconds_count``, every path summed."""


def read(run):
    dispatches = run.prom_delta("gordo_engine_dispatch_seconds_count")
    if not dispatches:
        return None
    return run.prom_delta("gordo_engine_requests_total") / dispatches
