"""The device trace of a window: ``torch.profiler`` on the harness's own
process, which hosts the server, started a little before the window
opens (a profile can lose records at its start) and read over the window
alone: the union of device activity, device time by kernel name, and the
longest gaps with nothing on the device, named by the host op that ran
longest in each."""

from __future__ import annotations

import time
from typing import Dict, List, Tuple


_MARK = "portbench.clock_mark"


class Trace:
    def __init__(self):
        from torch.profiler import ProfilerActivity, profile, record_function

        import torch

        # the server's ops run on its own threads; a torch without the
        # option records this thread's ops and every thread's kernels
        try:
            extra = {"experimental_config": torch._C._profiler._ExperimentalConfig(
                profile_all_threads=True)}
        except (AttributeError, TypeError):
            extra = {}
        self._prof = profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA], **extra)
        self._prof.__enter__()
        # the profile's clock starts at an unknown host time: a marked op
        # ties it to time.monotonic()
        with record_function(_MARK):
            self._mark = time.monotonic()

    def stop(self, t0: float, t1: float) -> Dict:
        """Close the profile and read the window ``[t0, t1]`` (monotonic
        seconds): ``busy_s``, ``window_s``, ``kernel_s`` (seconds by kernel
        name) and ``breakdown``."""
        from torch.autograd import DeviceType

        self._prof.__exit__(None, None, None)
        events = self._prof.events()
        mark = next(evt.time_range.start for evt in events if evt.name == _MARK)
        lo, hi = mark + (t0 - self._mark) * 1e6, mark + (t1 - self._mark) * 1e6
        device: List[Tuple[float, float, str]] = []
        host: List[Tuple[float, float, str]] = []
        for evt in events:
            start, end = evt.time_range.start, evt.time_range.end
            if end <= lo or start >= hi or end <= start:
                continue
            span = (max(start, lo), min(end, hi), evt.name)
            (device if evt.device_type == DeviceType.CUDA else host).append(span)
        device.sort()
        busy, gaps, kernel_s = 0.0, [], {}
        cursor = lo
        for start, end, name in device:
            kernel_s[name] = kernel_s.get(name, 0.0) + (end - start) / 1e6
            if start > cursor:
                gaps.append((cursor, start))
            if end > cursor:
                busy += end - max(start, cursor)
                cursor = end
        if hi > cursor:
            gaps.append((cursor, hi))
        gaps.sort(key=lambda g: g[0] - g[1])
        idle = [[_host_label(host, a, b), (b - a) / 1e6] for a, b in gaps[:10]]
        ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:10]
        return {"busy_s": busy / 1e6, "window_s": (hi - lo) / 1e6, "kernel_s": kernel_s,
                "breakdown": {"device_ops": [[_short(n), s] for n, s in ops],
                              "idle_gaps": idle}}


def _host_label(host: List[Tuple[float, float, str]], a: float, b: float) -> str:
    best, label = 0.0, "no host op recorded (Python, HTTP or JSON)"
    for start, end, name in host:
        overlap = min(end, b) - max(start, a)
        if overlap > best:
            best, label = overlap, name
    return _short(label)


def _short(name: str) -> str:
    return name if len(name) <= 120 else name[:117] + "..."
