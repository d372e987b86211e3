"""One traced call, reduced to what the per-layer readers and the
breakdown need.

``traced(fn)`` runs ``fn`` under ``torch.profiler`` (host operations and,
on a GPU, device activity) inside a span of the benchmark's own
(``SPAN``), and reduces the raw events without building the profiler's
event tree: the span's length (the traced window), the device's busy
time (the union of its kernels, copies and sets inside the window), the
kernels launched and their time by name, and the idle gaps of the device
summed by the host operation that was running at each gap's midpoint.
"""

from __future__ import annotations

import bisect
import collections

import torch
from torch.autograd import DeviceType

SPAN = "bench.profile"
_NOT_KERNELS = ("Memcpy", "Memset", "memcpy", "memset")


def traced(fn):
    """``(fn(), summary)`` with ``summary`` from :func:`summarize`."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        with record_function(SPAN):
            out = fn()
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    return out, summarize(prof.profiler.kineto_results.events())


def summarize(events) -> dict:
    """Window, busy time, kernels and gaps of raw kineto events."""
    window = None
    dev_iv, host = [], []
    kernels = 0
    by_name = collections.defaultdict(float)
    for e in events:
        name = e.name()
        start = e.start_ns()
        dur = e.duration_ns()
        if e.device_type() == DeviceType.CPU:
            if name == SPAN:
                window = (start, start + dur)
            else:
                host.append((start, start + dur, name))
            continue
        if name == SPAN or dur <= 0:
            continue                 # the span's own mark on the device
        dev_iv.append((start, start + dur))
        if not name.startswith(_NOT_KERNELS):
            kernels += 1
            by_name[name] += dur * 1e-9
    if window is None:
        return dict(window_s=0.0, busy_s=0.0, kernels=0, kernel_s={},
                    device_ops=[], idle_gaps=[])
    w0, w1 = window
    busy, gaps = _busy_and_gaps(dev_iv, w0, w1)
    return dict(window_s=(w1 - w0) * 1e-9, busy_s=busy * 1e-9,
                kernels=kernels, kernel_s=dict(by_name),
                device_ops=sorted(([n[:120], s] for n, s in by_name.items()),
                                  key=lambda x: -x[1])[:10],
                idle_gaps=_name_gaps(gaps, host))


def _busy_and_gaps(intervals, w0, w1):
    """Union length of ``intervals`` clipped to [w0, w1], and the idle
    gaps between them there."""
    busy = 0
    gaps = []
    cur = w0
    for s, e in sorted(intervals):
        s, e = max(s, w0), min(e, w1)
        if e <= s:
            continue
        if s > cur:
            gaps.append((cur, s))
            cur = s
        if e > cur:
            busy += e - cur
            cur = e
    if w1 > cur:
        gaps.append((cur, w1))
    return busy, gaps


def _name_gaps(gaps, host):
    """Gap seconds summed by the outermost host operation covering each
    gap's midpoint ("host, between operations" where none does); the ten
    largest."""
    host.sort()
    top = []                          # outermost operations, in order
    end = -1
    for s, e, name in host:
        if s >= end:
            top.append((s, e, name))
            end = e
    starts = [t[0] for t in top]
    out = collections.defaultdict(float)
    for g0, g1 in gaps:
        mid = (g0 + g1) // 2
        i = bisect.bisect_right(starts, mid) - 1
        name = (top[i][2] if i >= 0 and top[i][1] > mid
                else "host, between operations")
        out[name[:120]] += (g1 - g0) * 1e-9
    return sorted(([n, s] for n, s in out.items()),
                  key=lambda x: -x[1])[:10]


def kernel_seconds(summary: dict, names) -> float:
    """Device seconds of the kernels whose name holds one of ``names``."""
    return sum(s for k, s in summary["kernel_s"].items()
               if any(n in k for n in names))
