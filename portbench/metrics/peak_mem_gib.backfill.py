"""``torch.cuda.max_memory_allocated()`` over the window (the peak reset as
it opens), in GiB."""


def read(run):
    return run.memory_window_bytes / 2 ** 30 if run.memory_window_bytes else None
