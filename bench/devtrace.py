"""Host-clock spans and the profiler's device trace.

Spans are kept in memory, one list of (start, end) host seconds a name,
recorded by the benchmark around its calls into each layer of the
program.  ``traced`` runs a function under ``torch.profiler`` and reads
the device's activity (kernels, copies, fills) from the exported trace:
the union of their intervals (busy), the time by kernel name, and the
idle gaps between them named by what the host was doing."""
from __future__ import annotations

import collections
import json
import os
import re
import tempfile
import time

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("user_annotation", "cpu_op", "cuda_runtime")


class Spans:
    def __init__(self):
        self.spans: dict[str, list] = collections.defaultdict(list)

    def add(self, name: str, start: float, end: float) -> None:
        self.spans[name].append((start, end))

    def seconds(self, name: str) -> list:
        return [e - s for s, e in self.spans.get(name, [])]

    def mean_ms(self, name: str):
        xs = self.seconds(name)
        return 1e3 * sum(xs) / len(xs) if xs else None


def _union(intervals) -> list:
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """The device events of one traced window (microseconds, the trace's
    clock) and the window's host-clock length ``window_s``."""

    def __init__(self, events: list, window_s: float):
        self.window_s = window_s
        self.device = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"])
                       for e in events if e.get("cat") in DEVICE_CATS
                       and e.get("ph") == "X"]
        self.host = [(e["ts"], e["ts"] + e.get("dur", 0.0), e["name"],
                      e.get("cat"))
                     for e in events if e.get("cat") in HOST_CATS
                     and e.get("ph") == "X"]
        self.busy = _union((s, e) for s, e, _ in self.device)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy) * 1e-6

    def kernel_seconds(self, pattern: str) -> float:
        rx = re.compile(pattern)
        return 1e-6 * sum(e - s for s, e, n in self.device
                          if rx.search(n))

    def device_ops(self, top: int = 10) -> list:
        by = collections.Counter()
        for s, e, n in self.device:
            by[n[:160]] += (e - s) * 1e-6
        return [[n, t] for n, t in by.most_common(top)]

    def idle_gaps(self, top: int = 10) -> list:
        """The longest gaps between device activity inside the traced
        span, each named by the innermost host range open at its middle
        (a benchmark span, a program range or an op)."""
        gaps = [(b[0] - a[1], a[1], b[0])
                for a, b in zip(self.busy, self.busy[1:])]
        gaps.sort(reverse=True)
        out = []
        for dur, s, e in gaps[:top]:
            mid = (s + e) / 2
            open_ = [h for h in self.host if h[0] <= mid <= h[1]]
            name = (max(open_, key=lambda h: h[0])[2][:160] if open_
                    else "no host range")
            out.append([name, dur * 1e-6])
        return out


def traced(fn, torch):
    """(fn's result, the ``Trace`` of its window): ``fn`` runs under the
    profiler (CPU and CUDA activity), the device synchronised at both
    ends; the exported trace is read and deleted."""
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        window_s = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return out, Trace(events, window_s)
