"""The attention kernels' share of their roofline: the least time the
window's attention needs (per layer 4*BH*S^2*D operations; q, k, v read
and the output and log-sum-exp written once) over the device time of the
kernels whose names hold ``flash_fwd`` in the trace, in percent."""

from harness.workcount import PEAKS, attention_work, least_seconds


def read(run):
    if run.trace is None:
        return None
    kernel = sum(s for name, s in run.trace["kernel_s"].items() if "flash_fwd" in name)
    if kernel <= 0:
        return None
    model = run.config["model"]
    elem = 2 if model["compute_dtype"] == "bfloat16" else 4
    work = attention_work(model, run.config["n_tags"], run.windows_scored(), elem)
    least = model["n_layers"] * least_seconds(work, PEAKS[run.config["peak"]])
    return 100.0 * least / kernel
