"""Mean wait in the engine's queue of the window's requests: the change of
``gordo_stage_seconds{stage="queue_wait"}``'s sum over its count on /metrics."""


def read(run):
    count = run.prom_delta("gordo_stage_seconds_count", stage="queue_wait")
    if not count:
        return None
    return 1e3 * run.prom_delta("gordo_stage_seconds_sum", stage="queue_wait") / count
