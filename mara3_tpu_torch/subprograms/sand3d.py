"""3D AMR sandbox: octree advection of a Gaussian blob at v = (.5,.5,.5).

Port of mara3_tpu/subprograms/sand3d.py, the rank-3 analog of `amrsand`
(beyond the reference, whose shipped workloads are 2D): it drives
mesh/amr3d.py (octree build with 2:1 balance, six-face guard exchange
across level jumps, exactly conservative coarse-fine flux correction)
through the app framework: config, drift-free schedule, numbered
diagnostics with rank-3 "level:i-j-k" tree keys, and kzps meters. Each
inter-output window is one advance call.

The `kernel` key picks the advance:

- on a CUDA device, -1 (the default) and 1 run kernel B7
  (kernels/sand3d_step.py, csrc/sand3d_step.cu), 0 the amr3d scheme as
  torch ops on the card, and 2 (the JAX package's interpret mode) raises;
- on the CPU, -1 and 0 run the scheme, and 1 and 2 B7's plain version.

B7 needs every velocity component above 0: kernel=1 with one that is not
raises (-1 then takes the scheme). No fallback: a kernel that fails
raises. The state keeps the dtype it was given (float32 by default; the
tests pass float64). The run's device is the CUDA card unless the caller
asks for the CPU (app/device.py). h5py is imported only by the functions
that touch files.
"""

from __future__ import annotations

from dataclasses import dataclass, replace

import numpy as np
import torch

from mara3_tpu_torch.app import driver, serialize, tracing
from mara3_tpu_torch.app.config import ConfigTemplate
from mara3_tpu_torch.app.device import resolve_device
from mara3_tpu_torch.app.schedule import Schedule, mark_tasks
from mara3_tpu_torch.app.subprogram import register
from mara3_tpu_torch.kernels import sand3d_step
from mara3_tpu_torch.mesh import amr3d, tree_nd

VELOCITY = (0.5, 0.5, 0.5)
KERNELS = (-1, 0, 1, 2)


def config_template():
    return (ConfigTemplate()
            .item("outdir", "data")
            .item("dfi", 1.0)
            .item("tfinal", 1.0)
            .item("block_size", 16)
            .item("depth", 3)
            .item("kernel", -1))   # -1 auto, 0 scheme, 1 B7, 2 B7 plain


@dataclass(frozen=True)
class Solution:
    iteration: int
    time: float
    conserved: torch.Tensor       # [B, bs, bs, bs]


def build_mesh(cfg):
    """Octree with the 2D sandbox's predicate (refine toward the centre):
    level == 0 or centroid radius < 1/level, up to `depth`."""
    return amr3d.BlockMesh3D.create(
        lambda level, radius: level == 0 or radius < 1.0 / level,
        cfg.get_int("depth"))


def block_spacings(mesh, bs, dtype, device):
    """[B] cell size per block, float64 on the host, then cast."""
    return torch.as_tensor(2.0 / (1 << mesh.level) / bs).to(
        device=device, dtype=dtype)


LAST_PATH = "unset"   # what the last advance ran, e.g. cuda_b7[384]


def uses_kernel(kernel: int, device, v) -> bool:
    """Whether the `kernel` key runs B7 (or its plain version) on
    `device`; raises on a value that has no meaning there."""
    if kernel not in KERNELS:
        raise ValueError(f"sand3d kernel must be one of {KERNELS}, not "
                         f"{kernel}")
    cuda = torch.device(device).type == "cuda"
    if cuda and kernel == 2:
        raise ValueError("sand3d kernel=2 (interpret mode) runs B7's plain "
                         "version on the CPU; on a CUDA device use 1")
    use = kernel in (1, 2) or (kernel == -1 and cuda and min(v) > 0)
    if use and min(v) <= 0:
        raise ValueError(f"kernel B7 needs every velocity component above "
                         f"0, not {tuple(v)}")
    return use


def make_advance_auto(mesh, bs, v, kernel: int = -1, device="cpu"):
    """(u, dt, n) -> u over the octree, on `device`, through what the
    `kernel` key picks there (module docstring). B7's tables are built on
    the first call and kept while dt and the dtype stay."""
    if not uses_kernel(kernel, device, v):
        scheme = amr3d.make_advance(mesh, bs, v)

        def advance(u, dt, n):
            global LAST_PATH
            out = scheme(u, dt, n)
            LAST_PATH = f"scheme[{n}]"
            return out

        return advance

    cache = {}

    def advance(u, dt, n):
        global LAST_PATH
        key = (u.dtype, u.device, float(dt))
        if key not in cache:
            cache.clear()
            cache[key] = sand3d_step.guard_tables(
                mesh, block_spacings(mesh, bs, u.dtype, u.device), v, dt)
        out = sand3d_step.advance_n(u, cache[key], n)
        LAST_PATH = f"{'cuda' if u.is_cuda else 'plain'}_b7[{n}]"
        return out

    return advance


def new_solution(cfg, mesh, *, device="cpu", dtype=None) -> Solution:
    """The Gaussian blob, sampled in float64 on the host, then moved to
    `device` in dtype (float32 by default)."""
    u = amr3d.sample_blocks(
        mesh, cfg.get_int("block_size"),
        lambda X, Y, Z: torch.exp(-(X**2 + Y**2 + Z**2) / 0.025))
    return Solution(0, 0.0, u.to(device=device,
                                 dtype=dtype or torch.float32))


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
    u = s.conserved.detach().cpu().numpy()
    driver.check_finite("sand3d", [u], s.iteration, s.time)
    count = state.schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename(
        "diagnostics", count, "h5", cfg.get_string("outdir"))
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(s.time)
        serialize.write_tree(f.require_group("conserved"), state.mesh.leaves,
                             list(u))
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

def time_step(mesh, bs) -> float:
    """Dimension-split upwind stability: dt * sum(v) / dx_min = 1/2."""
    dx_min = 2.0 / (1 << (tree_nd.tree_depth(mesh.leaves) - 1)) / bs
    return 0.5 * dx_min / sum(VELOCITY)


@tracing.phased("mara3.setup")
def setup(argv, *, device=None, dtype=None):
    """Config and initial state (solution, schedule and mesh) of a run, with
    the banner; writes no file. Returns (cfg, state)."""
    device = resolve_device(device)
    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()
    b7 = uses_kernel(cfg.get_int("kernel"), device, VELOCITY)
    bs = cfg.get_int("block_size")
    mesh = build_mesh(cfg)
    s = new_solution(cfg, mesh, device=device, dtype=dtype)
    print(f"octree: {s.conserved.shape[0]} blocks of {bs}^3, depth "
          f"{tree_nd.tree_depth(mesh.leaves)}")
    where = ("CUDA kernel B7" if b7 else "the scheme (torch ops)") + (
        f" on {torch.cuda.get_device_name(device)}" if device.type == "cuda"
        else (" (its plain version)" if b7 else "") + " on the CPU")
    print(f"advance: {where}, "
          f"{str(s.conserved.dtype).replace('torch.', '')}")
    return cfg, State(s, driver.create_schedule(cfg, ["write_diagnostics"]),
                      mesh)


def run(cfg, state: State, tasks=run_tasks) -> State:
    """The chunked loop: each inter-output window is one advance call;
    `tasks(state, cfg)` writes the diagnostics. Returns the final state;
    raises driver.NonFiniteState if a write or the end finds the state not
    finite. A chunk is left running on the card while the next is planned
    and launched; the loop drains it before a diagnostics due and at its
    end."""
    rec = tracing.recorder()
    mesh = state.mesh
    s, schedule = state.solution, state.schedule
    chunks = driver.ChunksInFlight(rec, s.conserved.device)
    bs = s.conserved.shape[1]
    dt = time_step(mesh, bs)
    advance = make_advance_auto(mesh, bs, VELOCITY, cfg.get_int("kernel"),
                                s.conserved.device)
    tfinal = cfg.get_double("tfinal")
    dfi = cfg.get_double("dfi")
    num_zones = s.conserved.numel()
    while s.time < tfinal - driver.EPS:
        with rec.span("mara3.chunk", iteration=s.iteration):
            if driver.due_tasks(schedule):
                chunks.drain()
            with driver.traced_outputs(rec, schedule):
                state = tasks(State(s, schedule, mesh), cfg)
            s, schedule = state.solution, state.schedule
            with rec.span("mara3.plan"):
                n = driver.steps_to_next_stop(
                    s.time, dt, tfinal,
                    [schedule.last_performed("write_diagnostics") + dfi])
            with chunks.launch():
                u1 = advance(s.conserved, dt, n)
            s = replace(s, iteration=s.iteration + n, time=s.time + n * dt,
                        conserved=u1)
            chunks.end(n, s.iteration, s.time, num_zones, LAST_PATH)
            schedule = mark_tasks(schedule, s.time,
                                  [("write_diagnostics", dfi)])
    chunks.drain()
    final = tasks(State(s, schedule, mesh), cfg)
    s = final.solution
    driver.check_finite("sand3d", [s.conserved], s.iteration, s.time)
    return final


@register("sand3d")
def main(argv, *, device=None, dtype=None) -> int:
    import os
    cfg, state = setup(argv, device=device, dtype=dtype)
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    run(cfg, state)
    return 0
