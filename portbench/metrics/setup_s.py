"""Seconds from the process's start to the first timed request: the
seeded data and weights, the artifacts, the server's boot with its kernel
loads, and the warm-up (host clock)."""


def read(run):
    return run.setup_s
