"""Wall-clock performance metering.

Re-design of the reference's perf tools (src/app_performance.hpp:43-78): a
``time_execution`` wrapper that reports execution time in ms, ``compose``,
and the kzps (kilo-zone-updates per second) meter every subprogram prints
(e.g. subprog_binary.cpp:394-404). CUDA launches are asynchronous, so
``time_execution`` synchronizes the current CUDA device, when the process
uses one, before it reads the clock.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import reduce

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


def compose(*fns):
    """compose(f, g)(x) = f(g(x)) (reference compose, app_performance.hpp:43-50)."""
    return reduce(lambda f, g: lambda *a, **k: f(g(*a, **k)), fns)


def kzps(total_zones: int, step_ms: float) -> float:
    """Kilo-zone-updates per second: the reference's universal throughput
    meter (subprog_binary.cpp:394-404 and siblings)."""
    return total_zones / max(step_ms, 1e-12)
