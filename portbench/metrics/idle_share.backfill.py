"""Share of the traced window with nothing running on the device, from the
union of the profiler's device activity, in percent."""


def read(run):
    if run.trace is None or run.trace["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - run.trace["busy_s"] / run.trace["window_s"])
