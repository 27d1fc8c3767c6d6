"""AMR sandbox: quadtree advection of a Gaussian blob at v = (0.5, 0.5).

Port of mara3_tpu/subprograms/amrsand.py (the reference's
subprog_amrsand.cpp:49-369): builds a static quadtree with refinement
predicate `centroid_radius < 1/level` up to `depth`, advects a Gaussian with
first-order upwind fluxes, writes per-block diagnostics trees with
"level:i-j" keys. `regrid=1` rebuilds the mesh from the solution's gradient
every `rgi` time units (mesh/regrid.py; beyond the reference, whose trees
are static). The leaves live in one dense [B, bs, bs, 1] tensor in Hilbert
order; dt = 2 / bs / 2^depth is fixed by the tree.

Every step goes through advance_n:

- on a CUDA device, kernel B6 (kernels/amrsand_step.py,
  csrc/amrsand_step.cu), whose tables are built once per tree (cached by
  the tree's content, rebuilt after a regrid that changes it). No fallback:
  a kernel that fails raises;
- on the CPU, the scheme (_advance: extend_blocks, fluxes, update) as torch
  ops; kernel=True runs B6's plain version there instead.

fast_step picks the driver loop, as in the JAX package: 1 the chunked loop
(chunks of 256, 64, 16, 4 and 1 steps planned onto the diagnostics and
regrid dues, one advance_n call each), 0 the per-step loop, -1 (the
default) 1 on a CUDA device and 0 on the CPU.

The state's dtype is float32 unless the caller passes one (the tests pass
float64). The run's device is the CUDA card unless the caller asks for the
CPU (app/device.py). h5py is imported only by the functions that touch
files.
"""

from __future__ import annotations

import hashlib
import time as _time
from dataclasses import dataclass, replace
from typing import Mapping

import numpy as np
import torch

from mara3_tpu_torch.app import driver, serialize, tracing
from mara3_tpu_torch.app.config import ConfigTemplate
from mara3_tpu_torch.app.device import resolve_auto, resolve_device
from mara3_tpu_torch.app.performance import time_execution
from mara3_tpu_torch.app.schedule import Schedule, mark_tasks
from mara3_tpu_torch.app.subprogram import register
from mara3_tpu_torch.kernels import amrsand_step
from mara3_tpu_torch.mesh import block_layout, tree

CHUNKS = (256, 64, 16, 4, 1)      # the chunked loop's step counts


def config_template():
    """The JAX package's keys and defaults, so command lines carry over
    between the two."""
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("dfi", 1.0)
            .item("tfinal", 1.0)
            .item("block_size", 16)
            .item("depth", 4)
            # adaptive regridding (beyond the reference, whose trees are
            # static): rebuild the mesh from the solution gradient every
            # `rgi` time units when `regrid=1`
            .item("regrid", 0)
            # driver loop: -1 auto (1 on a CUDA device, else 0), 0 the
            # per-step loop, 1 the chunked loop
            .item("fast_step", -1)
            .item("rgi", 0.1)
            .item("refine_threshold", 0.3)
            .item("coarsen_threshold", 0.05))


@dataclass(frozen=True)
class Solution:
    iteration: int
    time: float
    leaves: tuple                 # the quadtree's leaves, Hilbert-ordered
    conserved: torch.Tensor       # [B, bs, bs, 1]


def build_tree(cfg):
    return tuple(tree.create_quadtree(
        lambda level, radius: level == 0 or radius < 1.0 / level,
        cfg.get_int("depth")))


def new_solution(cfg, *, device="cpu", dtype=None) -> Solution:
    """The Gaussian blob, sampled in float64 on the host, then moved to
    `device` in dtype (float32 by default)."""
    bs = cfg.get_int("block_size")
    leaves = build_tree(cfg)
    xc = block_layout.block_cell_centers(leaves, bs)
    u = np.exp(-(xc[..., 0] ** 2 + xc[..., 1] ** 2) / 0.025)
    return Solution(0, 0.0, leaves, torch.as_tensor(u[..., None]).to(
        device=device, dtype=dtype or torch.float32))


def solution_from_arrays(arrays: Mapping, *, device="cpu",
                         dtype=None) -> Solution:
    """A Solution from host values: the JAX package's Solution (iteration,
    time, leaves, conserved) as numpy arrays and tuples; dtype None keeps
    the conserved array's."""
    u = torch.tensor(np.asarray(arrays["conserved"]))      # a copy
    leaves = tuple(tuple(int(x) for x in leaf) for leaf in arrays["leaves"])
    return Solution(int(arrays["iteration"]), float(arrays["time"]), leaves,
                    u.to(device=device, dtype=dtype or u.dtype))


def solution_to_arrays(s: Solution) -> dict:
    """The inverse of solution_from_arrays: host values."""
    return {"iteration": np.int64(s.iteration), "time": np.float64(s.time),
            "leaves": np.asarray(s.leaves, dtype=np.int64).reshape(-1, 3),
            "conserved": s.conserved.detach().cpu().numpy()}


def block_spacings(s: Solution):
    """[B] cell size per block, in the state's dtype on its device."""
    bs = s.conserved.shape[1]
    return torch.as_tensor(block_layout.block_dx(s.leaves, bs)).to(
        device=s.conserved.device, dtype=s.conserved.dtype)


def time_step(s: Solution) -> float:
    """dt = 2 / bs / 2^depth (subprog_amrsand.cpp:244-245)."""
    return 2.0 / s.conserved.shape[1] / (1 << tree.tree_depth(s.leaves))


# -----------------------------------------------------------------------------
# the scheme (reference subprog_amrsand.cpp:243-300)
# -----------------------------------------------------------------------------

def _advance(u0, dxb, nt, dt: float):
    """One upwind step over all blocks: f = 0.5 * u_upwind per axis,
    u1 = u0 - (dfx + dfy) * dt / dx."""
    ue = block_layout.extend_blocks(u0, nt, axis=0, g=1)
    fx = 0.5 * ue[:, : u0.shape[1] + 1]          # upwind (v > 0)
    lx = fx[:, 1:] - fx[:, :-1]

    ue = block_layout.extend_blocks(u0, nt, axis=1, g=1)
    fy = 0.5 * ue[:, :, : u0.shape[2] + 1]
    ly = fy[:, :, 1:] - fy[:, :, :-1]

    dt_ = torch.full((), dt, dtype=u0.dtype, device=u0.device)
    return u0 - (lx + ly) * dt_ / dxb[:, None, None, None]


_TABLES_CACHE = {}
LAST_PATH = "unset"   # what the last advance_n ran, e.g. cuda_b6[256]


def kernel_tables(nt, dxb, dt: float) -> amrsand_step.GuardTables:
    """B6's tables for the tree `nt`, spacings dxb and step dt, built once
    per tree: the cache is keyed by the tree's content (never by id(nt), a
    freed table's id can come back with another tree) and holds one tree.
    A build is a `mara3.tables` phase span (app/tracing.py)."""
    digest = hashlib.sha1(b"".join(
        np.ascontiguousarray(a).tobytes()
        for a in (nt.case, nt.same_id, nt.coarse_id, nt.coarse_half,
                  nt.fine_id))).hexdigest()
    key = (digest, str(dxb.dtype), str(dxb.device), float(dt))
    if key not in _TABLES_CACHE:
        tracing.tally("table_builds")
        with tracing.phase("mara3.tables"):
            _TABLES_CACHE.clear()
            _TABLES_CACHE[key] = amrsand_step.guard_tables(nt, dxb, dt)
    return _TABLES_CACHE[key]


def advance_n(u0, dxb, nt, dt: float, num_steps: int, kernel=None):
    """num_steps upwind steps in one call. kernel: None = auto (B6 iff u0
    is on a CUDA device), False = the scheme, True = B6 (its plain version
    for a CPU tensor)."""
    global LAST_PATH
    if u0.device.type not in ("cpu", "cuda"):
        raise ValueError(f"no amrsand advance for a tensor on {u0.device}")
    if kernel is None:
        kernel = u0.device.type == "cuda"
    if kernel:
        u = amrsand_step.advance_n(u0, kernel_tables(nt, dxb, dt),
                                   num_steps)
        where = "cuda" if u0.device.type == "cuda" else "plain"
        LAST_PATH = f"{where}_b6[{num_steps}]"
        return u
    u = u0
    for _ in range(num_steps):
        u = _advance(u, dxb, nt, dt)
    LAST_PATH = f"scheme[{num_steps}]"
    return u


def next_solution(s: Solution, nt, dxb, kernel=None) -> Solution:
    dt = time_step(s)
    u1 = advance_n(s.conserved, dxb, nt, dt, 1, kernel)
    return replace(s, iteration=s.iteration + 1, time=s.time + dt,
                   conserved=u1)


# -----------------------------------------------------------------------------
# tasks: diagnostics (per-block trees with "level:i-j" keys) and the regrid
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class State:
    solution: Solution
    schedule: Schedule


def write_diagnostics(state: State, cfg) -> State:
    import h5py
    s = state.solution
    u = s.conserved[..., 0].detach().cpu().numpy()
    driver.check_finite("amrsand", [u], s.iteration, s.time)
    count = state.schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              cfg.get_string("outdir"))
    bs = s.conserved.shape[1]
    verts = block_layout.block_vertices(s.leaves, bs)
    idxs = [(l, (i, j)) for (l, i, j) in s.leaves]
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(s.time)
        serialize.write_tree(f.require_group("vertices"), idxs, list(verts))
        serialize.write_tree(f.require_group("conserved"), idxs, list(u))
    print(f"write diagnostics: {path}")
    return replace(state, schedule=state.schedule.mark_as_completed(
        "write_diagnostics"))


def run_tasks(state: State, cfg) -> State:
    if state.schedule.is_due("write_diagnostics"):
        state = write_diagnostics(state, cfg)
    return state


def apply_regrid(s: Solution, cfg):
    """One adaptive regrid cycle (mesh/regrid.py) on the host; returns the
    new solution with its neighbor table and spacings."""
    from mara3_tpu_torch.mesh import regrid as rg
    t0 = _time.perf_counter()
    bs = s.conserved.shape[1]
    new_leaves, new_blocks, changed = rg.regrid(
        s.leaves, s.conserved.detach().cpu().numpy(),
        block_layout.block_dx(s.leaves, bs),
        refine_threshold=cfg.get_double("refine_threshold"),
        coarsen_threshold=cfg.get_double("coarsen_threshold"),
        max_level=cfg.get_int("depth"))
    if changed:
        s = replace(s, leaves=tuple(new_leaves),
                    conserved=torch.as_tensor(new_blocks).to(
                        s.conserved.device))
    nt = block_layout.build_neighbor_table(s.leaves)
    ms = (_time.perf_counter() - t0) * 1e3
    print(f"regrid: {len(s.leaves)} blocks, depth "
          f"{tree.tree_depth(s.leaves)}, "
          f"{'changed' if changed else 'unchanged'}, {ms:.3f} ms on the "
          f"host")
    return s, nt, block_spacings(s)


# -----------------------------------------------------------------------------
# driver
# -----------------------------------------------------------------------------

@tracing.phased("mara3.setup")
def setup(argv, *, device=None, dtype=None):
    """Config and initial state (solution and schedule) of a run, with the
    banner; writes no file. Returns (cfg, state)."""
    device = resolve_device(device)
    cfg = driver.create_run_config(config_template(), argv)
    cfg.pretty_print()
    s = new_solution(cfg, device=device, dtype=dtype)
    bs = cfg.get_int("block_size")
    print(f"quadtree: {s.conserved.shape[0]} blocks of {bs}x{bs}, depth "
          f"{tree.tree_depth(s.leaves)}")
    where = (f"CUDA kernel B6 on {torch.cuda.get_device_name(device)}"
             if device.type == "cuda" else "the scheme (torch ops) on the CPU")
    loop = "chunked" if resolve_auto(cfg, "fast_step", device) else "per-step"
    regrid = (f", a regrid every {cfg.get_double('rgi')!r}"
              if cfg.get_int("regrid") else "")
    print(f"advance: {where}, "
          f"{str(s.conserved.dtype).replace('torch.', '')}, the {loop} "
          f"loop{regrid}")
    return cfg, State(s, driver.create_schedule(cfg, ["write_diagnostics"]))


def _run_fast(cfg, state: State, tasks) -> State:
    """The chunked loop: each chunk (256, 64, 16, 4 or 1 steps) is one
    advance_n call, planned to land on the next diagnostics due, regrid or
    tfinal (the JAX package's planner, eps and all). Under a profiler the
    loop records the spans and counters of app/tracing.py. A chunk is left
    running on the card while the next is planned and launched; the loop
    drains it before a diagnostics due, a regrid and its end."""
    rec = tracing.recorder()
    s, schedule = state.solution, state.schedule
    chunks = driver.ChunksInFlight(rec, s.conserved.device)
    nt = block_layout.build_neighbor_table(s.leaves)
    dxb = block_spacings(s)
    adaptive = cfg.get_int("regrid") != 0
    rgi = cfg.get_double("rgi")
    next_regrid = rgi
    tfinal = cfg.get_double("tfinal")
    dfi = cfg.get_double("dfi")
    while s.time < tfinal - driver.EPS:
        with rec.span("mara3.chunk", iteration=s.iteration):
            if driver.due_tasks(schedule):
                chunks.drain()
            with driver.traced_outputs(rec, schedule):
                state = tasks(State(s, schedule), cfg)
            s, schedule = state.solution, state.schedule
            if adaptive and s.time >= next_regrid:
                chunks.drain()
                rec.count("regrids")
                with rec.span("mara3.regrid"):
                    leaves = s.leaves
                    s, nt, dxb = apply_regrid(s, cfg)
                if s.leaves != leaves:
                    rec.count("tree_changes")
                next_regrid += rgi
            with rec.span("mara3.plan"):
                dt = time_step(s)
                dues = [schedule.last_performed("write_diagnostics") + dfi]
                if adaptive:
                    dues.append(next_regrid)
                n_cap = driver.steps_to_next_stop(s.time, dt, tfinal, dues)
                n = next(c for c in CHUNKS if c <= n_cap)
            with chunks.launch():
                u1 = advance_n(s.conserved, dxb, nt, dt, n)
            s = replace(s, iteration=s.iteration + n, time=s.time + n * dt,
                        conserved=u1)
            chunks.end(n, s.iteration, s.time, u1.numel(), LAST_PATH)
            schedule = mark_tasks(schedule, s.time,
                                  [("write_diagnostics", dfi)])
    chunks.drain()
    return tasks(State(s, schedule), cfg)


def _run_per_step(cfg, state: State, tasks) -> State:
    """The per-step loop of the JAX package (one advance_n call a step)."""
    s, schedule = state.solution, state.schedule
    nt = block_layout.build_neighbor_table(s.leaves)
    dxb = block_spacings(s)
    adaptive = cfg.get_int("regrid") != 0
    rgi = cfg.get_double("rgi")
    next_regrid = rgi
    dfi = cfg.get_double("dfi")
    while s.time < cfg.get_double("tfinal"):
        state = tasks(State(s, schedule), cfg)
        s, schedule = state.solution, state.schedule
        if adaptive and s.time >= next_regrid:
            s, nt, dxb = apply_regrid(s, cfg)
            next_regrid += rgi
        s, perf = time_execution(next_solution, s, nt, dxb)
        schedule = mark_tasks(schedule, s.time, [("write_diagnostics", dfi)])
        if s.iteration % 50 == 0:
            driver.print_run_loop_message(
                s.iteration, s.time, s.conserved.numel(),
                perf.execution_time_ms)
    return tasks(State(s, schedule), cfg)


def run(cfg, state: State, tasks=run_tasks) -> State:
    """The run through the loop fast_step picks, with `tasks(state, cfg)`
    for the diagnostics; returns the final state. Raises
    driver.NonFiniteState if a write or the end finds the state not
    finite."""
    if resolve_auto(cfg, "fast_step", state.solution.conserved.device):
        final = _run_fast(cfg, state, tasks)
    else:
        final = _run_per_step(cfg, state, tasks)
    s = final.solution
    driver.check_finite("amrsand", [s.conserved], s.iteration, s.time)
    return final


@register("amrsand")
def main(argv, *, device=None, dtype=None) -> int:
    import os
    cfg, state = setup(argv, device=device, dtype=dtype)
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    run(cfg, state)
    return 0
