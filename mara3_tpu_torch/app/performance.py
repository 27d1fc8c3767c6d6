"""Wall-clock performance metering.

Re-design of the reference's perf tools (src/app_performance.hpp:55-78): a
``time_execution`` wrapper that reports execution time in ms. CUDA launches
are asynchronous, so ``time_execution`` synchronizes the current CUDA
device, when the process uses one, before it reads the clock.
``timed_launch`` launches a fixed-dt loop's chunk without waiting for it,
between two CUDA timing events, and ``wait`` waits for it later, each
inside its span.
"""

from __future__ import annotations

import contextlib
import time
from dataclasses import dataclass

import torch


@dataclass(frozen=True)
class PerfDiagnostics:
    execution_time_ms: float = 0.0


def time_execution(fn, *args, **kwargs):
    """Run fn(*args) and return (result, PerfDiagnostics) with the wall time
    in ms (reference time_execution, app_performance.hpp:55-78)."""
    start = time.perf_counter()
    result = fn(*args, **kwargs)
    if torch.cuda.is_initialized():
        torch.cuda.synchronize()
    stop = time.perf_counter()
    return result, PerfDiagnostics(execution_time_ms=(stop - start) * 1e3)


def record_event(device: torch.device):
    """A timing event recorded on `device`'s current stream, or None off a
    CUDA device."""
    if device.type != "cuda":
        return None
    event = torch.cuda.Event(enable_timing=True)
    event.record(torch.cuda.current_stream(device))
    return event


class Launch:
    """A timed_launch's chunk: the events before and after it on the
    stream (None off a CUDA device) and its milliseconds."""
    __slots__ = ("start", "end", "ms")


@contextlib.contextmanager
def timed_launch(rec, device: torch.device):
    """The body in `rec`'s span `mara3.launch`, not waited for: on a CUDA
    device two timing events on the current stream bracket it. Yields a
    Launch whose `ms`, once the body exits, is the body's wall time on the
    host; `wait` sets it from the events."""
    launch = Launch()
    launch.start = record_event(device)
    start = time.perf_counter()
    with rec.span("mara3.launch"):
        yield launch
    launch.end = record_event(device)
    launch.ms = (time.perf_counter() - start) * 1e3


def wait(rec, launch: Launch):
    """In `rec`'s span `mara3.wait`, block until the stream has passed the
    launch's end event, and set its `ms` to the time between its two
    events: the chunk's time on the card, counted from the end of what the
    stream ran before it."""
    with rec.span("mara3.wait"):
        if launch.end is not None:
            launch.end.synchronize()
            launch.ms = launch.start.elapsed_time(launch.end)
