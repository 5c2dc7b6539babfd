"""95th percentile, nearest rank, of every request due in the window, from
its scheduled send to its last response byte (host clock); a failed
request counts as longer than any answered one."""

from harness.readings import percentile


def read(run):
    due = run.due_in_window()
    if not due:
        return None
    return 1e3 * percentile([run.latency_s(r) for r in due], 95)
