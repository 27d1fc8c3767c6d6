"""Shared subprogram driver plumbing.

The reference repeats its run-loop/checkpoint/restart boilerplate in every
subprogram (by design — subprog_boilerplate.cpp is the template). Here the
common parts are factored once:

- restart precedence: template defaults <- checkpoint run_config <- CLI args
  (reference subprog_binary.cpp:155-164)
- numbered checkpoint paths and schedules
- numbered checkpoints with solution/schedule/run_config groups
  (reference subprog_boilerplate.cpp:201-210)
- the fixed-dt loops' chunk plan, traced outputs, chunks in flight and
  ``[iter] t=... kzps=... [path]`` line, and the line of a per-step loop
- the finiteness test of a run's state at each write and at its end

h5py is imported only by the functions that open a file, so a run that
writes no checkpoint needs no h5py.
"""

from __future__ import annotations

import contextlib
import math
import os

import numpy as np
import torch

from mara3_tpu_torch.app import performance, serialize
from mara3_tpu_torch.app.config import Config, ConfigTemplate, argv_to_string_map
from mara3_tpu_torch.app.schedule import Schedule


def create_run_config(template: ConfigTemplate, argv) -> Config:
    """argv -> config with checkpoint-restart merge semantics."""
    args = argv_to_string_map(argv)
    cfg = template.create()
    if "restart" in args and args["restart"]:
        import h5py
        with h5py.File(args["restart"], "r") as f:
            # our checkpoints use 'run_config'; reference-generated sedov/
            # cloud checkpoints use 'config' (subprog_sedov.cpp:487)
            group = f["run_config"] if "run_config" in f else f["config"]
            stored = serialize.read_config(group)
            # ignore keys the template doesn't declare (forward/backward
            # compatibility with reference-generated files)
            stored = {k: v for k, v in stored.items() if k in cfg}
            cfg = cfg.update(stored)
    return cfg.update(args)


def create_schedule(run_config: Config, task_names) -> Schedule:
    """Fresh schedule with every task initially due, or the checkpoint's."""
    restart = run_config.get_string("restart") if "restart" in run_config else ""
    if restart:
        import h5py
        with h5py.File(restart, "r") as f:
            return serialize.read_schedule(f["schedule"])
    s = Schedule.create(*task_names)
    for name in task_names:
        s = s.mark_as_due(name)
    return s


def checkpoint_path(run_config: Config, count: int, prefix: str = "chkpt") -> str:
    outdir = (run_config.get_string("outdir")
              if "outdir" in run_config else ".")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    return serialize.create_numbered_filename(prefix, count, "h5", outdir)


def write_checkpoint_groups(path: str, run_config: Config,
                            schedule: Schedule, write_solution_fn):
    """Create chkpt file with the reference's three groups; the caller's
    write_solution_fn(group) fills the solution group."""
    import h5py
    with h5py.File(path, "w") as f:
        write_solution_fn(f.require_group("solution"))
        serialize.write_schedule(f.require_group("schedule"), schedule)
        serialize.write_config(f.require_group("run_config"), run_config)
    print(f"write checkpoint: {path}")


EPS = 1e-12     # the planner's tolerance on times, the JAX package's value


def steps_to_next_stop(t: float, dt: float, tfinal: float, dues=()) -> int:
    """The fewest whole steps of dt from t, at least 1, that reach tfinal
    or the nearest of `dues` (each task's last_performed + interval, the
    next regrid) lying more than EPS ahead of t."""
    n = max(1, int(math.ceil((tfinal - t) / dt - EPS)))
    for due in dues:
        if due > t + EPS:
            n = min(n, max(1, int(math.ceil((due - t) / dt - EPS))))
    return n


def due_tasks(schedule) -> list:
    """The names of the tasks due in `schedule`."""
    return [task.name for task in schedule if task.is_due]


@contextlib.contextmanager
def traced_outputs(rec, schedule):
    """Around a fixed-dt loop's task call: counts `outputs.<task>` for each
    task due in `schedule` and, if one is, opens `mara3.output` with task
    the due names joined by "+". Yields the due names."""
    due = due_tasks(schedule)
    for name in due:
        rec.count(f"outputs.{name}")
    with (rec.span("mara3.output", task="+".join(due)) if due
          else contextlib.nullcontext()):
        yield due


def progress_line(steps: int, iteration: int, time: float, zones: int,
                  ms: float, path: str) -> str:
    """A fixed-dt loop's line ``[iter] t=... kzps=... [path]``, which
    torch_bench/record.py and chip_smoke.py parse."""
    return (f"[{iteration:04d}] t={time:3.7f} "
            f"kzps={steps * zones / max(ms, 1e-9):3.2f} [{path}]")


class _Chunk:
    """A launched chunk: its Launch, whether it has been waited on, and
    what its progress line needs."""
    __slots__ = ("launch", "waited", "line")

    def __init__(self, launch, line):
        self.launch, self.waited, self.line = launch, False, line


class ChunksInFlight:
    """A fixed-dt loop's chunks, one chunk left running on the device while
    the host plans and launches the next.

    Per chunk the loop calls `launch()` around its advance call, then
    `end(steps, iteration, time, zones, path)` with the values after it.
    `end` counts the `steps` and, only then, waits for the chunk before
    (`mara3.wait`) and prints that chunk's progress line (`mara3.print`),
    its kzps from the chunk's time on the card. So the stream holds at
    most two chunks, and a line is printed only once its chunk has ended
    on the card.

    Before it reads the state on the host (a task due, a regrid, its end)
    the loop calls `drain()`: wait for the chunk in flight and print its
    line. Where the loop prints a chunk's line after the host read (the
    tasks after the launch in sedov and cloud, blast3d's finiteness test)
    it calls `wait()` instead; the line follows at the next `end()` or
    `drain()`. Counters: `chunks_in_flight`, the launches made while the
    chunk before was not waited on, and `drains`, the waits of `wait()`
    and `drain()`."""

    def __init__(self, rec, device):
        self.rec, self.device = rec, torch.device(device)
        self.last = None      # the newest chunk whose line is not printed
        self.launched = None  # the Launch of the chunk launch() last ran

    @contextlib.contextmanager
    def launch(self):
        """The advance call in `mara3.launch`, not waited for."""
        if self.last is not None and not self.last.waited:
            self.rec.count("chunks_in_flight")
        with performance.timed_launch(self.rec, self.device) as launch:
            yield
        self.launched = launch

    def end(self, steps: int, iteration: int, time: float, zones: int,
            path: str):
        """The end of the chunk just launched, its `steps` counted; the
        chunk before is waited for and its line printed."""
        self.rec.count("steps", steps)
        self.rec.annotate(steps=steps)
        before, self.last = self.last, _Chunk(
            self.launched, (steps, iteration, time, zones, path))
        if before is not None:
            self._print(before)

    def wait(self):
        """Wait for the chunk in flight, if there is one; its line is
        kept."""
        chunk = self.last
        if chunk is not None and not chunk.waited:
            self.rec.count("drains")
            self._wait(chunk)

    def drain(self):
        """Wait for the chunk in flight and print the line kept."""
        self.wait()
        if self.last is not None:
            self._print(self.last)
            self.last = None

    def _wait(self, chunk):
        performance.wait(self.rec, chunk.launch)
        chunk.waited = True

    def _print(self, chunk):
        if not chunk.waited:
            self._wait(chunk)
        steps, iteration, time, zones, path = chunk.line
        with self.rec.span("mara3.print"):
            print(progress_line(steps, iteration, time, zones,
                                chunk.launch.ms, path))


def print_run_loop_message(iteration: int, time: float, total_zones: int,
                           execution_time_ms: float):
    """The per-step line of a host loop: ``[iter] t=... kzps=...``."""
    rate = total_zones / max(execution_time_ms, 1e-12)
    print(f"[{iteration:04d}] t={time:3.7f} kzps={rate:3.2f}")


class NonFiniteState(RuntimeError):
    """A run reached a state that is not finite."""


def check_finite(subprogram: str, values, iteration: int, time: float):
    """Raise NonFiniteState, naming the subprogram, the iteration and the
    time, unless every one of `values` is finite. A writer passes the host
    copy it has made; a tensor on the card is reduced there and one flag
    read back."""
    def finite(v):
        if isinstance(v, torch.Tensor):
            return bool(torch.isfinite(v).all())
        return bool(np.isfinite(np.asarray(v)).all())

    if not all(finite(v) for v in values):
        raise NonFiniteState(f"{subprogram}: the state is not finite at "
                             f"iteration {iteration}, t = {time!r}")
