"""Wall-clock performance metering.

Re-design of the reference's perf tools (src/app_performance.hpp:55-78): a
``time_execution`` wrapper that reports execution time in ms. CUDA launches
are asynchronous, so ``time_execution`` synchronizes the current CUDA
device, when the process uses one, before it reads the clock.
"""

from __future__ import annotations

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

