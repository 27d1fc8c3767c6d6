"""Shared subprogram driver plumbing.

The reference repeats its run-loop/checkpoint/restart boilerplate in every
subprogram (by design — subprog_boilerplate.cpp is the template). Here the
common parts are factored once:

- restart precedence: template defaults <- checkpoint run_config <- CLI args
  (reference subprog_binary.cpp:155-164)
- numbered checkpoint paths and schedules
- numbered checkpoints with solution/schedule/run_config groups
  (reference subprog_boilerplate.cpp:201-210)
- the ``[iter] t=... kzps=...`` line of a per-step loop
- the finiteness test of a run's state at each write and at its end

h5py is imported only by the functions that open a file, so a run that
writes no checkpoint needs no h5py.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from mara3_tpu_torch.app import serialize
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
