"""Windows scored per second: every window of an answered request, each
request counted by the share of its flight inside the measured window,
over the whole window (host clock)."""


def read(run):
    return run.windows_scored() / run.window_s
