"""Spans and counters of the port's driver loops, recorded only while a
torch.profiler session runs.

A driver loop resolves `recorder()` once at its start. With no profiler
running that is a shared null recorder: `span(...)` hands back one shared
`contextlib.nullcontext` and `count(...)` and `annotate(...)` return at
once, so an untraced run pays a few microseconds a chunk. Under a
profiler each span is opened as a profiler range, so the profiler's trace
shows it among its host events, on the kernels' timeline, and it is also
kept in this process's store as a `Span` with `time.perf_counter_ns()`
stamps.

The range is `torch._C._profiler._RecordFunctionFast`, not
`torch.profiler.record_function`. The latter records a user annotation,
for which the CUDA profiler adds an event on the device's timeline that
covers every kernel launched inside the range: a reader of the device's
busy time would count a chunk's host work as device work. The former
records a plain host operator (and costs 1.6 us a span where
record_function costs 13 us, on a CPU with the profiler on). A span that
may hold a long run of kernel launches made outside any torch operator
(more than one call of kernel B3's C loop) takes `timeline=False`: the
store keeps it and the profiler does not see it, or, once the loop knows
the span holds a single launch, `put_on_timeline()` shows it from then on.
With ranges around 256-step chunks on the timeline the profiler's own stop
took 373 s instead of 41 s after a 10 s window (binary d6b96 on an H100,
PyTorch 2.11); ranges around chunks of one B3 call (up to 16 steps) cost
little.

`spans()`, `counts()` and `clear()` read and reset the store; `summary()`
reduces it to a count, total and self milliseconds per span name, a
span's self time being its duration less the union of its children's
intervals.

The spans of binary's loop and of the six fixed-dt loops (amrsand, sedov,
cloud, sand3d, blast3d, kh, through app/driver.py and app/performance.py):

- `mara3.chunk`, one chunk (attributes `iteration`, `steps`), holding
- `mara3.plan` (the chunk planner), `mara3.launch` (the host's enqueue),
  `mara3.wait` (the host waiting for the device; in a fixed-dt loop for
  the chunk before, after this chunk's launch, or for the chunk in
  flight, before a host read), `mara3.repair` (the safe-mode rewind and
  retry), `mara3.mark` (float64 time and the schedule marks),
  `mara3.output` (one output, attribute `task`; inside it `mara3.replay`
  and `mara3.sample` for a time-series row), `mara3.regrid`,
  `mara3.tables` (kernel B3's or B6's tables) and `mara3.print` (the
  progress line; in a fixed-dt loop the line of the chunk waited for);
- `mara3.recover`, a sedov row's or diagnostics write's primitive
  recovery of the whole state;
- in blast3d's octree step (mesh/euler3d.py), where it runs as torch ops
  (the plain version of kernel B12, on the CPU), `mara3.step`, one step's
  enqueue, holding a `mara3.guard` (the two guard slabs) and a
  `mara3.correct` (the level-jump flux correction) for each axis; kernel
  B12 has no per-step host work and records no span.

Its counters: `steps` (useful steps advanced), `replay_steps` (steps run
again to reach a due or to rewind a faulted chunk), in binary
`planned_to_due` (chunks whose plan aimed at a time-series due) and
`planned_due_hits` (of those, the chunks whose last step was that due:
their ratio is the plan's hit share), `outputs.<task>`,
`retries` (safe-mode retries), `regrids`, `tree_changes`,
`table_builds`, in the fixed-dt loops `chunks_in_flight` (launches made
while the chunk before was not yet waited on) and `drains` (waits for
the chunk in flight before the host reads the state: a task due, a
regrid, a test of the state, the loop's end), in binary
`geometry_uploads` (the mesh geometry taken to the device, once per
solver data: the rows and the diagnostics read it there) and, wherever
the SRHD Newton of physics/srhd.py runs, `recover_passes` (its host
reads of whether every cell has converged) and, in blast3d,
`wavespeed_reads` (its host reads of the maximum wavespeed, one a
window) and `octree_kernel_steps` (the steps kernel B12 ran, counted once
a call with its n: on the card it equals `steps`).

`profile_to` runs a whole subprogram under the profiler and writes its
Chrome trace and the store's summary (`MARA3_PROFILE_DIR`, app/subprogram).
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from collections import defaultdict
from typing import NamedTuple, Optional

import torch

PROFILE_DIR = "MARA3_PROFILE_DIR"
CHUNK = "mara3.chunk"


class Span(NamedTuple):
    """A span of the store: its name, its perf_counter_ns stamps (end_ns
    None while it is open), the index in the store of its parent (None at
    the top), the iteration at the start of the chunk it lies in (None
    outside a chunk) and its attributes."""
    name: str
    start_ns: int
    end_ns: Optional[int]
    parent: Optional[int]
    chunk: Optional[int]
    attrs: dict


_spans: list = []          # Span, in the order they opened
_counts: dict = {}
_open: list = []           # the open spans (_Range), innermost last
_NOTHING = contextlib.nullcontext()


def spans() -> list:
    return list(_spans)


def counts() -> dict:
    return dict(_counts)


def clear():
    """Empty the store (between runs, not inside one)."""
    _spans.clear()
    _counts.clear()
    _open.clear()


class _Range:
    """One span being recorded: the store's entry and, on the timeline, a
    profiler range."""
    __slots__ = ("name", "attrs", "index", "fn")

    def __init__(self, name: str, attrs: dict, timeline: bool):
        self.name, self.attrs = name, attrs
        self.fn = (torch._C._profiler._RecordFunctionFast(name) if timeline
                   else _NOTHING)

    def put_on_timeline(self):
        if self.fn is _NOTHING:
            self.fn = torch._C._profiler._RecordFunctionFast(self.name)
            self.fn.__enter__()

    def __enter__(self):
        self.fn.__enter__()
        parent = _open[-1].index if _open else None
        chunk = (self.attrs.get("iteration") if self.name == CHUNK
                 else None if parent is None else _spans[parent].chunk)
        self.index = len(_spans)
        _spans.append(Span(self.name, time.perf_counter_ns(), None, parent,
                           chunk, self.attrs))
        _open.append(self)
        return self

    def __exit__(self, *exc):
        end = time.perf_counter_ns()
        _open.pop()
        _spans[self.index] = _spans[self.index]._replace(end_ns=end)
        self.fn.__exit__(*exc)
        return False


class _Recorder:
    def span(self, name: str, timeline: bool = True, **attrs):
        """A span; with timeline=False the store keeps it but the profiler
        does not see it."""
        return _Range(name, attrs, timeline)

    def count(self, name: str, n: int = 1):
        _counts[name] = _counts.get(name, 0) + n

    def annotate(self, **attrs):
        """Set attributes on the innermost open span."""
        _spans[_open[-1].index].attrs.update(attrs)

    def put_on_timeline(self):
        """Show the innermost open span to the profiler from now on."""
        _open[-1].put_on_timeline()


class _Null:
    def span(self, name: str, timeline: bool = True, **attrs):
        return _NOTHING

    def count(self, name: str, n: int = 1):
        return None

    def annotate(self, **attrs):
        return None

    def put_on_timeline(self):
        return None


_RECORDER, _NULL = _Recorder(), _Null()


def recorder():
    """The recorder while a torch.profiler session runs, else the null
    one."""
    return _RECORDER if torch._C._autograd._profiler_enabled() else _NULL


def _covered_ns(intervals) -> int:
    """The length of the union of [(start, end)]."""
    total, reach = 0, None
    for s, e in sorted(intervals):
        if reach is None or s > reach:
            total += e - s
            reach = e
        elif e > reach:
            total += e - reach
            reach = e
    return total


def summary(store=None) -> dict:
    """{name: {"count", "total_ms", "self_ms"}} over the closed spans of
    `store` (the process's by default)."""
    store = spans() if store is None else store
    children = defaultdict(list)
    for s in store:
        if s.parent is not None and s.end_ns is not None:
            children[s.parent].append((s.start_ns, s.end_ns))
    out = {}
    for i, s in enumerate(store):
        if s.end_ns is None:
            continue
        total = s.end_ns - s.start_ns
        row = out.setdefault(s.name, {"count": 0, "total_ms": 0.0,
                                      "self_ms": 0.0})
        row["count"] += 1
        row["total_ms"] += total * 1e-6
        row["self_ms"] += (total - _covered_ns(children[i])) * 1e-6
    return out


def profile_to(directory: str, name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs) under torch.profiler (CPU, and CUDA where there
    is a card), the store cleared first. After a clean run it writes
    <directory>/<name>.trace.json (the Chrome trace: spans and kernels on
    one timeline) and <directory>/<name>.spans.json (summary() and the
    counters). Only a profiler that does not start makes it run fn
    untraced, saying so on one line; an error raised by fn propagates as
    itself."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.start()
    except Exception as e:  # the profiler's own failure, never the run's
        print(f"profile: the profiler did not start ({e!r}); running "
              f"untraced")
        return fn(*args, **kwargs)
    clear()
    try:
        result = fn(*args, **kwargs)
    except BaseException:
        with contextlib.suppress(Exception):
            prof.stop()
        raise
    prof.stop()
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(directory, name)
    prof.export_chrome_trace(f"{base}.trace.json")
    with open(f"{base}.spans.json", "w") as f:
        json.dump({"spans": summary(), "counts": counts()}, f, indent=1)
    print(f"profile: {base}.trace.json, {base}.spans.json")
    return result
