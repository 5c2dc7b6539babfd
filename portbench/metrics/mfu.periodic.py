"""The whole step's share of the card's peak: the matrix operations the
window's scored windows need (the benchmark's own count from the
configuration's widths) over the window's seconds times the
configuration's peak, in percent."""

from harness.workcount import PEAKS, flops_per_window


def read(run):
    model, peak = run.config["model"], PEAKS[run.config["peak"]]
    ops = run.windows_scored() * flops_per_window(model, run.config["n_tags"])
    return 100.0 * ops / (run.window_s * peak) if ops else None
