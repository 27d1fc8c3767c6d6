"""Spans and counters of the port: those of its time-stepping loops,
recorded only while a torch.profiler session runs, and those of a run's
set-up phases, recorded always.

A driver loop resolves `recorder()` once at its start. With no profiler
running that is a shared null recorder: `span(...)` hands back one shared
`contextlib.nullcontext` and `count(...)` and `annotate(...)` return at
once, so an untraced run pays a few microseconds a chunk. Under a
profiler each span is opened as a profiler range, so the profiler's trace
shows it among its host events, on the kernels' timeline, and it is also
kept in this process's store as a `Span` with `time.perf_counter_ns()`
stamps.

Phase spans (`phase(...)`) mark work done a few times a run, and the store
keeps them whether or not a profiler runs; under one they go on the
timeline too. `tally(...)` is their counter, kept the same way:

- `mara3.setup`, each subprogram's setup(): its configuration, mesh and
  geometry, and the initial state on the device (the CUDA context comes
  with the process's first allocation on the card, inside it);
- `mara3.build` (attributes `kernel`, the source's name, and `built`,
  whether nvcc ran), kernels/_build.load's build or load of one CUDA
  library, at its first call in the process; counter `kernel_builds`;
- `mara3.tables`, kernel B3's scan (at every run() of binary) or B6's
  tables (amrsand, on a change of tree); counter `table_builds`.

The range is `torch._C._profiler._RecordFunctionFast`, not
`torch.profiler.record_function`. The latter records a user annotation,
for which the CUDA profiler adds an event on the device's timeline that
covers every kernel launched inside the range: a reader of the device's
busy time would count a chunk's host work as device work. The former
records a plain host operator (and costs 1.6 us a span where
record_function costs 13 us, on a CPU with the profiler on). Every span
goes on the timeline while a profiler runs, binary's chunks of two B3
calls and their `mara3.call` spans included: the traced window's idle
gaps then all fall inside some span.

One clock: the store stamps with `perf_counter_ns` (CLOCK_MONOTONIC), the
profiler's events are on the Unix epoch. `clock_offset_ns()` is the
difference, read once a profiler session (at the first `recorder()` under
a profiler after `clear()`, or at the first reading); `profiler_ns(stamp)`
maps a store stamp onto the profiler's clock. `idle_by_span(device,
store)` puts each of the device's idle gaps (between the profiler's device
events) down to the innermost span of the store over its midpoint: what
the program was doing while the card sat idle. The profiler's own
innermost host event over a gap is as often a torch operator or a CUDA
call (`aten::empty_strided`, `cudaLaunchKernel`) as a span, and it cannot
see a span that opened before the profiler started (a phase span of a
set-up the profiler started inside); the store's spans, with their
attributes, are laid over the trace by this clock alone.

`spans()`, `counts()` and `clear()` read and reset the store; `summary()`
reduces it to a count, total and self milliseconds per span name, a
span's self time being its duration less the union of its children's
intervals.

The spans of binary's loop and of the six fixed-dt loops (amrsand, sedov,
cloud, sand3d, blast3d, kh, through app/driver.py and app/performance.py):

- `mara3.chunk`, one chunk (attributes `iteration`, `steps`), holding
- `mara3.plan` (the chunk planner), `mara3.launch` (the host's enqueue;
  in binary a `mara3.call` inside it for each B3 call, attribute
  `steps`), `mara3.wait` (the host waiting for the device; in a fixed-dt
  loop for the chunk before, after this chunk's launch, or for the chunk
  in flight, before a host read), in binary `mara3.post` (the host's work
  on the read rows, holding the repair, mark, outputs and print),
  `mara3.repair` (the safe-mode rewind and retry), `mara3.mark` (float64
  time and the schedule marks), `mara3.output` (one output, attribute
  `task`; inside it `mara3.replay` and `mara3.sample` for a time-series
  row), `mara3.regrid`, `mara3.tables` and `mara3.print` (the progress
  line; in a fixed-dt loop the line of the chunk waited for);
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
in the fixed-dt loops `chunks_in_flight` (launches made
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
Chrome trace and <name>.spans.json: the store's summary, the counters and
`idle_by_span` over the run's device events (`MARA3_PROFILE_DIR`,
app/subprogram; empty without a card).
"""

from __future__ import annotations

import bisect
import contextlib
import functools
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
_offset: list = []         # the profiler's clock less perf_counter, in ns
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
    _offset.clear()


class _Range:
    """One span being recorded: the store's entry and, on the timeline, a
    profiler range."""
    __slots__ = ("name", "attrs", "index", "fn")

    def __init__(self, name: str, attrs: dict, timeline: bool):
        self.name, self.attrs = name, attrs
        self.fn = (torch._C._profiler._RecordFunctionFast(name) if timeline
                   else _NOTHING)

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
    def span(self, name: str, **attrs):
        return _Range(name, attrs, True)

    def count(self, name: str, n: int = 1):
        tally(name, n)

    def annotate(self, **attrs):
        """Set attributes on the innermost open span."""
        _spans[_open[-1].index].attrs.update(attrs)


class _Null:
    def span(self, name: str, **attrs):
        return _NOTHING

    def count(self, name: str, n: int = 1):
        return None

    def annotate(self, **attrs):
        return None


_RECORDER, _NULL = _Recorder(), _Null()


def recorder():
    """The recorder while a torch.profiler session runs, else the null
    one."""
    if torch._C._autograd._profiler_enabled():
        clock_offset_ns()
        return _RECORDER
    return _NULL


def phase(name: str, **attrs):
    """A phase span: kept in the store whether or not a profiler runs, and
    on the profiler's timeline while one does."""
    return _Range(name, attrs, torch._C._autograd._profiler_enabled())


def phased(name: str):
    """A decorator: each call of the function is a phase span `name`."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            with phase(name):
                return fn(*args, **kwargs)
        return call
    return wrap


def tally(name: str, n: int = 1):
    """A phase counter: counted whether or not a profiler runs."""
    _counts[name] = _counts.get(name, 0) + n


def clock_offset_ns() -> int:
    """The profiler's clock (the Unix epoch, time.time_ns) less the store's
    (perf_counter_ns), read once after clear(): of five readings, the one
    whose two perf_counter_ns stamps lie closest together."""
    if not _offset:
        best = None
        for _ in range(5):
            a = time.perf_counter_ns()
            wall = time.time_ns()
            b = time.perf_counter_ns()
            if best is None or b - a < best[0]:
                best = (b - a, wall - (a + b) // 2)
        _offset.append(best[1])
    return _offset[0]


def profiler_ns(stamp_ns: int) -> int:
    """A store stamp on the profiler's clock."""
    return stamp_ns + clock_offset_ns()


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


NO_SPAN = "(no span)"


def idle_by_span(device, store=None, offset_ns=None,
                 min_gap_s: float = 5e-6) -> list:
    """The device's idle gaps by the innermost span of the store over each
    gap's middle: [[span name or NO_SPAN, idle seconds, gaps]], the most
    idle first. `device` holds (start s, end s) or (name, start s, end s)
    on the profiler's clock, as torch_bench/trace.py takes them; a gap is
    as its reducer has it, a stretch of at least min_gap_s that no device
    interval covers. The store's stamps are mapped with offset_ns
    (clock_offset_ns() by default); a span still open covers the rest."""
    store = spans() if store is None else store
    offset = clock_offset_ns() if offset_ns is None else offset_ns
    starts = [s.start_ns for s in store]
    by, reach = {}, None
    for s, e in sorted(d[-2:] for d in device):
        if reach is not None and s - reach >= min_gap_s:
            mid = round(0.5 * (reach + s) * 1e9) - offset
            # spans nest and open in order: the innermost over mid is the
            # last opened at or before it, or its nearest ancestor still
            # open at mid
            i = bisect.bisect_right(starts, mid) - 1
            while i >= 0 and store[i].end_ns is not None \
                    and store[i].end_ns < mid:
                i = -1 if store[i].parent is None else store[i].parent
            row = by.setdefault(store[i].name if i >= 0 else NO_SPAN,
                                [0.0, 0])
            row[0] += s - reach
            row[1] += 1
        reach = e if reach is None else max(reach, e)
    return sorted(([k, *v] for k, v in by.items()), key=lambda r: -r[1])


def profile_to(directory: str, name: str, fn, *args, **kwargs):
    """fn(*args, **kwargs) under torch.profiler (CPU, and CUDA where there
    is a card), the store cleared first. After a clean run it writes
    <directory>/<name>.trace.json (the Chrome trace: spans and kernels on
    one timeline) and <directory>/<name>.spans.json (summary(), the
    counters and idle_by_span over the run's device events). Only a
    profiler that does not start makes it run fn untraced, saying so on
    one line; an error raised by fn propagates as itself."""
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
    from torch.autograd import DeviceType
    device = [(e.start_ns() * 1e-9, (e.start_ns() + e.duration_ns()) * 1e-9)
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == DeviceType.CUDA]
    os.makedirs(directory, exist_ok=True)
    base = os.path.join(directory, name)
    prof.export_chrome_trace(f"{base}.trace.json")
    with open(f"{base}.spans.json", "w") as f:
        json.dump({"spans": summary(), "counts": counts(),
                   "idle_by_span": idle_by_span(device)}, f, indent=1)
    print(f"profile: {base}.trace.json, {base}.spans.json")
    return result
