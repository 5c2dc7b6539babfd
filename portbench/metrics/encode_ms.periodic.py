"""Mean response encode time of the window's requests: the change of
``gordo_stage_seconds{stage="encode"}``'s sum over its count on /metrics."""


def read(run):
    count = run.prom_delta("gordo_stage_seconds_count", stage="encode")
    if not count:
        return None
    return 1e3 * run.prom_delta("gordo_stage_seconds_sum", stage="encode") / count
