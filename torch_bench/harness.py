"""One run of one cell: set-up, the checked first steps, the window, the
metrics, the check against the plain reference, the result line.

1. Set-up (counted in setup_s, from the process's start): the program's
   setup() with the seed's initial state, then its first steps to the
   cell's `check_until` through the same entry and task runner as the
   window (their outputs are copied to the host for the check), then a
   pace probe of `probe` more.
2. The window: one call of the program's run() on from there, to where the
   probe's pace says `--seconds` of wall time ends. Standard output is
   stamped line by line; with --trace 1 the window, at most TRACE_SECONDS
   long, runs under torch.profiler.
3. The device's memory peak is read and the program's state freed; the
   float64 reference then follows the checked first steps from the same
   seed and the gaps are held to the cell's limits.
"""

from __future__ import annotations

import contextlib
import math
import sys
import time

import torch

from torch_bench import record, spec, trace
from torch_bench.work import model

# the longest traced window: the profiler's events of a longer one take
# minutes to read back
TRACE_SECONDS = 10.0


def card(device) -> dict:
    device = torch.device(device)
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1}


def checked_start(cell: spec.Cell, seed: int, device, argv=()):
    """The program's set-up from the seed's initial state and its first
    steps to the cell's `check_until`, through the window's own entry and
    task runner: (the system, ready to run on; the host copies of what the
    check compares). The program's standard output is swallowed."""
    system = spec.system(cell.config["subprogram"])(cell, device, argv)
    with contextlib.redirect_stdout(record.Stamped()):
        system.setup(seed)
        system.advance(system.check_until)
    return system, system.outputs()


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, started: float, argv=(), log=sys.stderr) -> dict:
    """The result of one run (the dict the last line prints)."""
    if traced:
        seconds = min(seconds, TRACE_SECONDS)
    system, checked = checked_start(cell, seed, device, argv)
    with contextlib.redirect_stdout(record.Stamped()):
        t0 = time.perf_counter()
        start = system.now()
        system.advance(start + system.probe)
        _sync(device)
        pace = (system.now() - start) / (time.perf_counter() - t0)
        until = system.now() + pace * seconds

    stamped = record.Stamped()
    rec = record.Record(0.0, 0.0, stamped.lines, system.iteration(),
                        system.now(), system.blocks(),
                        system.zones_per_block(), system.output_every(),
                        config=cell.config)

    def window():
        rec.start = time.perf_counter()
        system.advance(until)
        _sync(device)
        rec.end = time.perf_counter()

    rec.setup_s = time.perf_counter() - started
    with contextlib.redirect_stdout(stamped):
        if traced:
            _, events = trace.profiled(window)
            rec.trace = trace.reduce(events)
        else:
            window()
    device_info = card(device)
    cells_end = system.blocks() * system.zones_per_block()
    rec.work = model.work_of(cell.config, device_info["kind"],
                             (rec.blocks0 * rec.zones_per_block + cells_end)
                             // 2)
    metrics = {}
    for m in cell.metrics(traced):
        value = spec.reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    if torch.device(device).type == "cuda":
        device_info["memory_peak_bytes"] = torch.cuda.max_memory_allocated(
            device)
    if traced:
        device_info["busy_s"] = rec.trace["busy_s"]
        device_info["window_s"] = rec.window_s
    steps = rec.steps()
    system.free()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()

    gaps = system.gaps(checked, seed)
    limits = cell.traffic["limits"]
    checks = {k: {"value": gaps[k], "limit": limits[k]} for k in limits}
    correct = all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                  for c in checks.values())
    result = {"correct": correct, "attempted": steps,
              "failed": rec.retries(), "metrics": metrics,
              "device": device_info}
    if traced:
        result["breakdown"] = {"device_ops": rec.trace["device_ops"],
                               "idle_gaps": rec.trace["idle_gaps"]}
    result["checks"] = checks
    for name, c in checks.items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=log)
    return result


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
