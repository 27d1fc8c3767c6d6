"""The traced window: torch.profiler over the card, reduced to what the
per-layer readers and the result's breakdown need.

`profiled(fn)` runs fn under torch.profiler (CPU and CUDA activity, every
event kept) and returns fn's result with the window's events: the device's
(kernels, copies, fills) and the host's (torch operators, CUDA runtime
calls), each as (name, start s, end s) on the profiler's clock. `reduce`
gives the device's busy seconds (the union of its events), seconds by
device operation, and the idle gaps between device events labelled by
the host event that was running at the gap's middle.
"""

from __future__ import annotations

import bisect
from collections import defaultdict


def profiled(fn):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        result = fn()
        torch.cuda.synchronize()
    device, host = [], []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns() * 1e-9
        item = (e.name(), start, start + e.duration_ns() * 1e-9)
        (device if e.device_type() == DeviceType.CUDA else host).append(item)
    return result, {"device": device, "host": host}


def union(intervals):
    """[(start, end)] merged, sorted."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            if e > out[-1][1]:
                out[-1][1] = e
        else:
            out.append([s, e])
    return out


def short(name: str, width: int = 72) -> str:
    """A kernel's name without its return type, anonymous namespace,
    template and argument lists."""
    base = name.replace("(anonymous namespace)::", "")
    if base.startswith("void "):
        base = base[5:]
    for stop in "<(":
        if stop in base:
            base = base[:base.index(stop)]
    return base.strip()[:width] or name[:width]


def top(pairs, n: int = 10):
    return sorted(([k, v] for k, v in pairs.items()),
                  key=lambda kv: -kv[1])[:n]


def reduce(events: dict, min_gap_s: float = 5e-6) -> dict:
    device, host = events["device"], events["host"]
    busy = union((s, e) for _, s, e in device)
    by_op = defaultdict(float)
    for name, s, e in device:
        by_op[name] += e - s
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    gaps = defaultdict(float)
    for (_, e0), (s1, _) in zip(busy, busy[1:]):
        if s1 - e0 < min_gap_s:
            continue
        mid = 0.5 * (e0 + s1)
        label = "host outside any torch operator or CUDA call"
        i = bisect.bisect_right(starts, mid) - 1
        for j in range(i, max(i - 400, -1), -1):
            if host[j][2] >= mid:
                label = host[j][0]
                break
        gaps[label] += s1 - e0
    short_ops = defaultdict(float)
    for name, seconds in by_op.items():
        short_ops[short(name)] += seconds
    return {"busy_s": sum(e - s for s, e in busy),
            "by_op": dict(by_op),
            "device_ops": top(short_ops),
            "idle_gaps": top(gaps)}
