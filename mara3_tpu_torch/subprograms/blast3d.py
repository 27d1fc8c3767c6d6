"""3D Euler point explosion on the AMR octree.

Port of mara3_tpu/subprograms/blast3d.py, the rank-3 real-hydro sibling of
`sand3d`: a Sedov-like central overpressure on a centre-refined octree,
advanced by mesh/euler3d.py (HLLE fluxes through the six-face guard
exchange with exactly conservative coarse-fine flux correction) through
the app framework: config, drift-free schedule, numbered diagnostics with
"level:i-j-k" tree keys (`mass_density`, `gas_pressure`), and kzps meters.

Each inter-output window is one advance call. Its dt is frozen for the
window from one host read of the global maximum wavespeed at its start,
with the JAX package's ceil(... - eps) step counts, so a float64 run takes
the JAX package's steps. The step has no kernel in either package: it runs
as torch ops on the state's device. The state keeps the dtype it was given
(float32 by default; the tests pass float64); the run's device is the CUDA
card unless the caller asks for the CPU (app/device.py).

Faults: the whole state (not the density alone, as the JAX package's loop
tests it) is tested after each window, at each diagnostics write and at the
end of `run()`; a non-finite state raises driver.NonFiniteState. h5py is
imported only by the functions that touch files.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace
from typing import Mapping

import numpy as np
import torch

from mara3_tpu_torch.app import driver, serialize, tracing
from mara3_tpu_torch.app.config import ConfigTemplate
from mara3_tpu_torch.app.device import resolve_device
from mara3_tpu_torch.app.schedule import Schedule, mark_tasks
from mara3_tpu_torch.app.subprogram import register
from mara3_tpu_torch.mesh import amr3d, euler3d, tree_nd
from mara3_tpu_torch.physics import euler

GAMMA = 5.0 / 3.0


def config_template():
    return (ConfigTemplate()
            .item("outdir", "data")
            .item("dfi", 0.1)
            .item("tfinal", 0.25)
            .item("block_size", 16)
            .item("depth", 3)
            .item("cfl", 0.3))


@dataclass(frozen=True)
class Solution:
    iteration: int
    time: float
    conserved: torch.Tensor       # [B, bs, bs, bs, 5]


def build_mesh(cfg):
    """Octree refined toward the explosion centre (the sand3d predicate):
    level == 0 or centroid radius < 1/level."""
    return amr3d.BlockMesh3D.create(
        lambda level, radius: level == 0 or radius < 1.0 / level,
        cfg.get_int("depth"))


def initial_conserved(X, Y, Z):
    """Unit-density medium at rest with a hot central sphere (the 3D analog
    of subprog_sedov.cpp's initial overpressure region)."""
    r2 = X ** 2 + Y ** 2 + Z ** 2
    d = torch.ones_like(X)
    p = torch.where(r2 < 0.05, torch.full_like(X, 10.0),
                    torch.full_like(X, 0.1))
    P = torch.stack([d, 0 * X, 0 * X, 0 * X, p], dim=-1)
    return euler.to_conserved_density(P, GAMMA)


def new_solution(cfg, mesh, *, device="cpu", dtype=None) -> Solution:
    """The explosion, sampled in float64 on the host, then moved to `device`
    in dtype (float32 by default)."""
    u = amr3d.sample_blocks(mesh, cfg.get_int("block_size"),
                            initial_conserved)
    return Solution(0, 0.0, u.to(device=device,
                                 dtype=dtype or torch.float32))


def solution_from_arrays(arrays: Mapping, *, device="cpu",
                         dtype=None) -> Solution:
    """A Solution from host values: the JAX package's Solution (iteration,
    time, conserved) as numpy arrays; dtype None keeps the conserved
    array's."""
    u = torch.tensor(np.asarray(arrays["conserved"]))      # a copy
    return Solution(int(arrays["iteration"]), float(arrays["time"]),
                    u.to(device=device, dtype=dtype or u.dtype))


def solution_to_arrays(s: Solution) -> dict:
    """The inverse of solution_from_arrays: host values."""
    return {"iteration": np.int64(s.iteration), "time": np.float64(s.time),
            "conserved": s.conserved.detach().cpu().numpy()}


# -----------------------------------------------------------------------------
# tasks
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class State:
    solution: Solution
    schedule: Schedule
    mesh: amr3d.BlockMesh3D


def write_diagnostics(state: State, cfg) -> State:
    import h5py
    s = state.solution
    driver.check_finite("blast3d", [s.conserved], s.iteration, s.time)
    P = euler.recover_primitive(s.conserved, GAMMA).detach().cpu().numpy()
    count = state.schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename(
        "diagnostics", count, "h5", cfg.get_string("outdir"))
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(s.time)
        serialize.write_tree(f.require_group("mass_density"),
                             state.mesh.leaves, list(P[..., 0]))
        serialize.write_tree(f.require_group("gas_pressure"),
                             state.mesh.leaves, list(P[..., 4]))
    print(f"write diagnostics: {path}")
    return replace(state, schedule=state.schedule.mark_as_completed(
        "write_diagnostics"))


def run_tasks(state: State, cfg) -> State:
    if state.schedule.is_due("write_diagnostics"):
        state = write_diagnostics(state, cfg)
    return state


# -----------------------------------------------------------------------------
# driver
# -----------------------------------------------------------------------------

def min_spacing(mesh, bs) -> float:
    """The finest cell size of the octree."""
    return 2.0 / (1 << (tree_nd.tree_depth(mesh.leaves) - 1)) / bs


def setup(argv, *, device=None, dtype=None):
    """Config and initial state (solution, schedule and mesh) of a run, with
    the banner; writes no file. Returns (cfg, state)."""
    device = resolve_device(device)
    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()
    bs = cfg.get_int("block_size")
    mesh = build_mesh(cfg)
    s = new_solution(cfg, mesh, device=device, dtype=dtype)
    print(f"octree: {s.conserved.shape[0]} blocks of {bs}^3 x 5, depth "
          f"{tree_nd.tree_depth(mesh.leaves)}")
    where = (f"on {torch.cuda.get_device_name(device)}"
             if device.type == "cuda" else "on the CPU")
    print(f"advance: the scheme (torch ops) {where}, "
          f"{str(s.conserved.dtype).replace('torch.', '')}")
    return cfg, State(s, driver.create_schedule(cfg, ["write_diagnostics"]),
                      mesh)


def run(cfg, state: State, tasks=run_tasks) -> State:
    """The chunked loop: each inter-output window is one advance call at the
    dt its start sets; `tasks(state, cfg)` writes the diagnostics. Returns
    the final state; raises driver.NonFiniteState if the state is not
    finite after a window, at a write or at the end, or its wavespeed at a
    window's start. The dt of a window is read from the card and each
    window's state is tested there, so the loop waits for every window
    before it plans the next."""
    rec = tracing.recorder()
    mesh = state.mesh
    s, schedule = state.solution, state.schedule
    chunks = driver.ChunksInFlight(rec, s.conserved.device)
    bs = s.conserved.shape[1]
    cfl = cfg.get_double("cfl")
    dx_min = min_spacing(mesh, bs)
    advance = euler3d.make_advance(mesh, bs, GAMMA)
    tfinal = cfg.get_double("tfinal")
    dfi = cfg.get_double("dfi")
    num_zones = s.conserved.shape[0] * bs ** 3
    while s.time < tfinal - driver.EPS:
        with rec.span("mara3.chunk", iteration=s.iteration):
            if driver.due_tasks(schedule):
                chunks.drain()
            with driver.traced_outputs(rec, schedule):
                state = tasks(State(s, schedule, mesh), cfg)
            s, schedule = state.solution, state.schedule
            with rec.span("mara3.plan"):
                # dimension-split CFL from the current global max wavespeed
                a = float(euler3d.max_signal_speed(s.conserved, GAMMA))
                if not math.isfinite(a):
                    raise driver.NonFiniteState(
                        f"blast3d: the maximum wavespeed is {a} (a "
                        f"non-finite or non-physical state) at iteration "
                        f"{s.iteration}, t = {s.time!r}")
                dt = cfl * dx_min / a / 3.0
                n = driver.steps_to_next_stop(
                    s.time, dt, tfinal,
                    [schedule.last_performed("write_diagnostics") + dfi])
            with chunks.launch():
                u1 = advance(s.conserved, dt, n)
            s = replace(s, iteration=s.iteration + n, time=s.time + n * dt,
                        conserved=u1)
            chunks.end(n, s.iteration, s.time, num_zones, f"scheme[{n}]")
            chunks.wait()
            driver.check_finite("blast3d", [u1], s.iteration, s.time)
            schedule = mark_tasks(schedule, s.time,
                                  [("write_diagnostics", dfi)])
    chunks.drain()
    final = tasks(State(s, schedule, mesh), cfg)
    s = final.solution
    driver.check_finite("blast3d", [s.conserved], s.iteration, s.time)
    return final


@register("blast3d")
def main(argv, *, device=None, dtype=None) -> int:
    import os
    cfg, state = setup(argv, device=device, dtype=dtype)
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    run(cfg, state)
    return 0
