"""Sedov-Taylor blast wave in 1D spherical symmetry (Euler or SRHD).

Port of mara3_tpu/subprograms/sedov.py (the reference's subprog_sedov.cpp):
a log-spaced radial grid spanning log10(outer_radius) decades at `nr` zones
per decade, Godunov with HLLE fluxes, spherical geometry sources,
reflecting-inner / zero-gradient-outer guards, gamma = 4/3, CFL 0.4.
`newtonian` selects the Euler system instead of SRHD; `reconstruct_method`
pcm (the reference's first order), plm or weno5. The conserved state is
extrinsic (U * dv per cell) in a [nr, 5] tensor; dt = CFL * min(dr) is fixed
by the grid.

Every step goes through advance_n:

- on a CUDA device, kernel B5 (kernels/sedov_step.py, csrc/sedov_step.cu),
  which takes any cell count and all three reconstructions: no remainder
  or fallback path, and a kernel that fails raises;
- on the CPU, the scheme (_step, _step_stacked) as torch ops; kernel=True
  runs B5's plain version there instead.

fast_step picks the driver loop, as in the JAX package: 1 the chunked loop
(chunks of 128, 32, 8 and 1 steps planned onto the task dues, one
advance_n call each), 0 the per-step loop, -1 (the default) 1 on a CUDA
device and 0 on the CPU.

Checkpoints carry the JAX layout both ways: solution (time, iteration,
vertices, conserved), schedule, run_config and its "config" alias. The
state's dtype is float32 unless the caller passes one (the tests pass
float64); the vertices stay float64. The run's device is the CUDA card
unless the caller asks for the CPU (app/device.py). h5py is imported only
by the functions that touch files.
"""

from __future__ import annotations

import math
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
from mara3_tpu_torch.core import ops
from mara3_tpu_torch.mathx.plm import plm_gradient
from mara3_tpu_torch.mathx.polynomial import parabola_vertex
from mara3_tpu_torch.mathx.shock import (find_index_of_maximum_behind,
                                         find_index_of_pressure_plateau_ahead,
                                         find_shock_index)
from mara3_tpu_torch.mathx.weno import weno5_faces
from mara3_tpu_torch.physics import euler, srhd

GAMMA_LAW_INDEX = 4.0 / 3.0
CFL_NUMBER = 0.4
RECONSTRUCT_METHODS = ("pcm", "plm", "weno5")
CHUNKS = (128, 32, 8, 1)      # the chunked loop's step counts

TIME_SERIES_COLUMNS = (
    "time",
    "shock_radius",
    "shock_radius_upstream",
    "shock_radius_downstream",
    "shock_radius_interpolated",
    "shock_velocity",
)


def config_template():
    """The JAX package's keys and defaults, so command lines and
    checkpoints carry over between the two."""
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("nr", 256)
            .item("tfinal", 1.0)
            .item("cpi", 1.0)
            .item("tsi", 0.1)
            .item("dfi", 0.1)
            .item("outer_radius", 100.0)
            .item("explosion_pressure", 1.0)
            .item("explosion_density", 1.0)
            .item("density_index", 0.0)
            .item("newtonian", 0)
            # driver loop: -1 auto (1 on a CUDA device, else 0), 0 the
            # per-step loop, 1 the chunked loop
            .item("fast_step", -1)
            .item("reconstruct_method", "pcm")    # pcm | plm | weno5
            .item("plm_theta", 1.5))


def hydro_system(cfg):
    return euler if cfg.get_int("newtonian") != 0 else srhd


def system_name(system) -> str:
    return "euler" if system is euler else "srhd"


# -----------------------------------------------------------------------------
# geometry (reference subprog_sedov.cpp:144-163)
# -----------------------------------------------------------------------------

def face_areas(vertices):
    return vertices * vertices


def cell_volumes(vertices):
    r0, r1 = ops.zip_adjacent2_on_axis(vertices)
    return ops.div_scalar(r1 * (r1 * r1) - r0 * (r0 * r0), 3.0)


# -----------------------------------------------------------------------------
# solution state
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class Solution:
    time: float
    iteration: int
    vertices: torch.Tensor     # [nr + 1], float64
    conserved: torch.Tensor    # extrinsic: U * dv, [nr, 5]


def new_solution(cfg, *, device="cpu", dtype=None) -> Solution:
    """The blast's initial state, computed in float64 on the host, then
    moved to `device` (conserved cast to dtype, float32 by default)."""
    system = hydro_system(cfg)
    nr = cfg.get_int("nr")
    radial_decades = math.log10(cfg.get_double("outer_radius"))
    y = torch.linspace(-0.5, radial_decades, int(radial_decades * nr) + 1,
                       dtype=torch.float64)
    vertices = 10.0 ** y
    rc = ops.midpoint_on_axis(vertices)
    dv = cell_volumes(vertices)

    ambient = rc ** -cfg.get_double("density_index")
    temperature = 1e-6
    inside = rc < 1.0
    rho = torch.where(inside, cfg.get_double("explosion_density"), ambient)
    pre = torch.where(inside, cfg.get_double("explosion_pressure"),
                      ambient * temperature)
    zeros = torch.zeros_like(rc)
    P = system.primitive_from_quantities(rho, zeros, zeros, zeros, pre)
    U = system.to_conserved_density(P, GAMMA_LAW_INDEX) * dv[:, None]
    return Solution(0.0, 0, vertices.to(device),
                    U.to(device=device, dtype=dtype or torch.float32))


def solution_from_arrays(arrays: Mapping, *, device="cpu",
                         dtype=None) -> Solution:
    """A Solution from host values: the JAX package's SolutionState (time,
    iteration, vertices, conserved) as numpy arrays, or a checkpoint's
    solution group; dtype None keeps the conserved array's."""
    u = torch.as_tensor(np.asarray(arrays["conserved"]))
    v = torch.as_tensor(np.asarray(arrays["vertices"], dtype=np.float64))
    return Solution(float(arrays["time"]), int(arrays["iteration"]),
                    v.to(device), u.to(device=device, dtype=dtype or u.dtype))


def solution_to_arrays(s: Solution) -> dict:
    """The inverse of solution_from_arrays: host numpy values."""
    return {"time": np.float64(s.time), "iteration": np.int64(s.iteration),
            "vertices": s.vertices.detach().cpu().numpy(),
            "conserved": s.conserved.detach().cpu().numpy()}


def read_solution(group, *, device="cpu", dtype=None) -> Solution:
    return solution_from_arrays(
        {k: group[k][()] for k in ("time", "iteration", "vertices",
                                   "conserved")}, device=device, dtype=dtype)


def write_solution(group, s: Solution):
    for k, v in solution_to_arrays(s).items():
        group[k] = v


def create_solution(cfg, *, device="cpu", dtype=None) -> Solution:
    """The initial solution, or the checkpoint's (`restart`), on `device`
    in dtype (float32 by default)."""
    restart = cfg.get_string("restart")
    if restart:
        import h5py
        with h5py.File(restart, "r") as f:
            return read_solution(f["solution"], device=device,
                                 dtype=dtype or torch.float32)
    return new_solution(cfg, device=device, dtype=dtype)


# -----------------------------------------------------------------------------
# the scheme (reference next_solution, subprog_sedov.cpp:395-420)
# -----------------------------------------------------------------------------

_REFLECT_SIGNS = (1.0, -1.0, 1.0, 1.0, 1.0)


def _extend_bc(P, g: int = 1):
    """Reflecting inner + zero-gradient outer (subprog_sedov.cpp:231-250),
    with g guard cells per side for the higher-order stencils."""
    refl = torch.tensor(_REFLECT_SIGNS, dtype=P.dtype, device=P.device)
    inner = (P[:g] * refl).flip(0)
    outer = P[-1:].expand(g, P.shape[1])
    return torch.cat([inner, P, outer], dim=0)


def _face_states(P, reconstruct: str, plm_theta: float):
    """(L, R) states at the n+1 faces: pcm as the reference; plm and weno5
    reconstruct in the computational (log-radius) coordinate."""
    if reconstruct == "weno5":
        L, R = weno5_faces(_extend_bc(P, 3), axis=0)
        # positivity fallback to the first-order states
        Pe = _extend_bc(P, 1)
        L0, R0 = Pe[:-1], Pe[1:]
        bad = ((L[:, 0] <= 0.0) | (L[:, 4] <= 0.0)
               | (R[:, 0] <= 0.0) | (R[:, 4] <= 0.0))[:, None]
        return torch.where(bad, L0, L), torch.where(bad, R0, R)
    if reconstruct == "plm":
        Pe = _extend_bc(P, 2)
        grad = plm_gradient(Pe[:-2], Pe[1:-1], Pe[2:], plm_theta)
        L = (Pe[1:-1] + 0.5 * grad)[:-1]
        R = (Pe[1:-1] - 0.5 * grad)[1:]
        return L, R
    Pe = _extend_bc(P, 1)
    return Pe[:-1], Pe[1:]


def _geometry(vertices, dtype):
    """(dv, da, rc) in the state's dtype."""
    return (cell_volumes(vertices).to(dtype), face_areas(vertices).to(dtype),
            ops.midpoint_on_axis(vertices).to(dtype))


def _step_stacked(system, u0, vertices, dt, reconstruct="pcm",
                  plm_theta=1.5):
    """The stacked-state step: the weno5 path, and the oracle of _step."""
    dv, da, rc = _geometry(vertices, u0.dtype)
    P = system.recover_primitive(u0 / dv[:, None], GAMMA_LAW_INDEX, 0.0)
    s0 = system.spherical_geometry_source_terms_radial(
        P, rc, GAMMA_LAW_INDEX) * dv[:, None]
    L, R = _face_states(P, reconstruct, plm_theta)
    F = system.riemann_hlle(L, R, (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)
    l0 = -ops.difference_on_axis(F * da[:, None])
    return u0 + (l0 + s0) * dt


def _step(system, u0, vertices, dt, reconstruct="pcm", plm_theta=1.5):
    """The tuple-form step: the formulas and rounding of _step_stacked with
    the state carried as 5 component tensors."""
    if reconstruct == "weno5":
        return _step_stacked(system, u0, vertices, dt, reconstruct,
                             plm_theta)
    dv, da, rc = _geometry(vertices, u0.dtype)
    Ut = tuple(u0[:, k] / dv for k in range(5))
    Pt = system.recover_primitive_t(Ut, GAMMA_LAW_INDEX, 0.0)
    s0 = system.spherical_geometry_source_terms_radial_t(
        Pt, rc, GAMMA_LAW_INDEX)

    def faces_1(c, sign):
        # reflecting inner (velocity sign flip) + zero-gradient outer
        if reconstruct == "plm":
            ce = torch.cat([(c[:2] * sign).flip(0), c, c[-1:], c[-1:]])
            grad = plm_gradient(ce[:-2], ce[1:-1], ce[2:], plm_theta)
            return (ce[1:-1] + 0.5 * grad)[:-1], (ce[1:-1] - 0.5 * grad)[1:]
        ce = torch.cat([c[:1] * sign, c, c[-1:]])
        return ce[:-1], ce[1:]

    LR = [faces_1(c, s) for c, s in zip(Pt, _REFLECT_SIGNS)]
    F = system.riemann_hlle_t(tuple(l for l, _ in LR),
                              tuple(r for _, r in LR),
                              (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)
    return torch.stack(
        [u0[:, k] + (-(F[k][1:] * da[1:] - F[k][:-1] * da[:-1])
                     + s0[k] * dv) * dt for k in range(5)], dim=-1)


LAST_PATH = "unset"   # what the last advance_n ran, e.g. cuda_b5_srhd_pcm[128]


def advance_n(u0, vertices, dt, newtonian: bool, num_steps: int,
              reconstruct: str = "pcm", plm_theta: float = 1.5, kernel=None):
    """num_steps steps in one call. kernel: None = auto (B5 iff u0 is on a
    CUDA device), False = the scheme, True = B5 (its plain version for a
    CPU tensor)."""
    global LAST_PATH
    if kernel is None:
        kernel = u0.device.type == "cuda"
    name = "euler" if newtonian else "srhd"
    if kernel:
        from mara3_tpu_torch.kernels import sedov_step
        u = sedov_step.advance_n(u0, vertices, float(dt), num_steps,
                                 reconstruct, plm_theta, GAMMA_LAW_INDEX,
                                 name)
        where = "cuda" if u0.device.type == "cuda" else "plain"
        LAST_PATH = f"{where}_b5_{name}_{reconstruct}[{num_steps}]"
        return u
    system = euler if newtonian else srhd
    u = u0
    for _ in range(num_steps):
        u = _step(system, u, vertices, dt, reconstruct, plm_theta)
    LAST_PATH = f"scheme[{num_steps}]"
    return u


def grid_dt(vertices) -> float:
    """CFL timestep from the innermost (minimum) radial spacing, fixed for
    the run on the log grid (subprog_sedov.cpp:407-408)."""
    return CFL_NUMBER * float(vertices[1] - vertices[0])


def next_solution(s: Solution, newtonian: bool, reconstruct: str = "pcm",
                  plm_theta: float = 1.5, kernel=None) -> Solution:
    dt = grid_dt(s.vertices)
    u1 = advance_n(s.conserved, s.vertices, dt, newtonian, 1, reconstruct,
                   plm_theta, kernel)
    return replace(s, time=s.time + dt, iteration=s.iteration + 1,
                   conserved=u1)


# -----------------------------------------------------------------------------
# diagnostics & time series (reference subprog_sedov.cpp:253-308, 493-530)
# -----------------------------------------------------------------------------

def primitives_of(s: Solution, system):
    """The primitives of the whole state (a row's or a diagnostics
    write's recovery: the `mara3.recover` span under a profiler)."""
    with tracing.recorder().span("mara3.recover"):
        dv = cell_volumes(s.vertices).to(s.conserved.dtype)
        return system.recover_primitive(s.conserved / dv[:, None],
                                        GAMMA_LAW_INDEX, 0.0)


def make_diagnostic_fields(s: Solution, system):
    P = primitives_of(s, system)
    return {
        "mass_density": P[:, 0],
        "gas_pressure": P[:, 4],
        "specific_entropy": system.specific_entropy(P, GAMMA_LAW_INDEX),
        "radial_gamma_beta": P[:, 1],
        "radial_coordinates": ops.midpoint_on_axis(s.vertices),
    }


def _solve_for_shock_velocity(system, p1, p2):
    """Mass-flux jump condition (subprog_sedov.cpp:88-106): relativistic
    (d2 u2 - d1 u1)/(d2 g2 - d1 g1) or newtonian (d2 v2 - d1 v1)/(d2 - d1)."""
    d1, d2 = p1[0], p2[0]
    u1, u2 = p1[1], p2[1]
    if system is srhd:
        g1 = torch.sqrt(1.0 + p1[1] ** 2 + p1[2] ** 2 + p1[3] ** 2)
        g2 = torch.sqrt(1.0 + p2[1] ** 2 + p2[2] ** 2 + p2[3] ** 2)
        return (d2 * u2 - d1 * u1) / (d2 * g2 - d1 * g1)
    return (d2 * u2 - d1 * u1) / (d2 - d1)


def compute_time_series_data(s: Solution, system) -> dict:
    """The time-series row: the shock found by the entropy locator, the
    pressure maximum behind it and plateau ahead of it, a parabola-vertex
    sub-cell estimate, and the jump-condition shock velocity."""
    P = primitives_of(s, system)
    entropy = system.specific_entropy(P, GAMMA_LAW_INDEX)
    shock_index = int(find_shock_index(entropy))
    downstream_index = int(find_index_of_maximum_behind(P[:, 4], shock_index))
    upstream_index = int(find_index_of_pressure_plateau_ahead(P[:, 4],
                                                              shock_index))
    rc = ops.midpoint_on_axis(s.vertices)
    vc = P[:, 1]
    i = max(downstream_index, 1)
    x_vertex, _ = parabola_vertex(rc[i - 1], rc[i], rc[i + 1],
                                  vc[i - 1], vc[i], vc[i + 1])
    n = rc.shape[0]
    return {
        "time": float(s.time),
        "shock_radius": float(s.vertices[shock_index]),
        "shock_radius_upstream": float(rc[min(upstream_index, n - 1)]),
        "shock_radius_downstream": float(rc[downstream_index]),
        "shock_radius_interpolated": float(x_vertex),
        "shock_velocity": float(_solve_for_shock_velocity(
            system, P[upstream_index if upstream_index < P.shape[0] else -1],
            P[downstream_index])),
    }


# -----------------------------------------------------------------------------
# tasks (reference subprog_sedov.cpp:480-578)
# -----------------------------------------------------------------------------

TASKS = ("write_checkpoint", "write_diagnostics", "write_time_series")


@dataclass(frozen=True)
class State:
    solution: Solution
    schedule: Schedule


def check_finite(s: Solution):
    """Raise driver.NonFiniteState unless the state is finite."""
    driver.check_finite("sedov", [s.conserved], s.iteration, s.time)


def write_checkpoint(state: State, cfg) -> State:
    """chkpt.NNNN.h5 with the solution, the schedule (counted after this
    checkpoint, so a restart continues the numbering), run_config and its
    "config" alias (the reference's plotting tools read "config")."""
    import h5py
    check_finite(state.solution)
    count = state.schedule.num_times_performed("write_checkpoint")
    schedule = state.schedule.mark_as_completed("write_checkpoint")
    path = driver.checkpoint_path(cfg, count)
    with h5py.File(path, "w") as f:
        write_solution(f.require_group("solution"), state.solution)
        serialize.write_schedule(f.require_group("schedule"), schedule)
        serialize.write_config(f.require_group("run_config"), cfg)
        serialize.write_config(f.require_group("config"), cfg)
    print(f"write checkpoint: {path}")
    return replace(state, schedule=schedule)


def write_diagnostics(state: State, cfg) -> State:
    import h5py
    check_finite(state.solution)
    system = hydro_system(cfg)
    count = state.schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              cfg.get_string("outdir"))
    fields = make_diagnostic_fields(state.solution, system)
    ts = compute_time_series_data(state.solution, system)
    with h5py.File(path, "w") as f:
        for k, v in fields.items():
            f[k] = v.detach().cpu().numpy()
        for k, v in ts.items():
            f[k] = np.float64(v)
    print(f"write diagnostics: {path}")
    return replace(state, schedule=state.schedule.mark_as_completed(
        "write_diagnostics"))


def _time_series_path(cfg) -> str:
    outdir = cfg.get_string("outdir")
    return (f"{outdir}/time_series.h5" if outdir not in (".", "")
            else "time_series.h5")


def write_time_series(state: State, cfg) -> State:
    import h5py
    row = state.schedule.num_times_performed("write_time_series")
    data = compute_time_series_data(state.solution, hydro_system(cfg))
    with h5py.File(_time_series_path(cfg), "r+") as f:
        for name, value in data.items():
            ds = f[name]
            ds.resize((row + 1,))
            ds[row] = value
    return replace(state, schedule=state.schedule.mark_as_completed(
        "write_time_series"))


def prepare_filesystem(cfg):
    """Create outdir and the extendable chunked time_series.h5 (reference
    subprog_sedov.cpp:589-614); nothing on a restart."""
    import os

    import h5py
    if cfg.get_string("restart"):
        return
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    with h5py.File(_time_series_path(cfg), "w") as f:
        for name in TIME_SERIES_COLUMNS:
            f.create_dataset(name, shape=(0,), maxshape=(None,),
                             chunks=(1000,), dtype="f8")
        serialize.write_config(f.require_group("run_config"), cfg)


def run_tasks(state: State, cfg) -> State:
    if state.schedule.is_due("write_checkpoint"):
        state = write_checkpoint(state, cfg)
    if state.schedule.is_due("write_diagnostics"):
        state = write_diagnostics(state, cfg)
    if state.schedule.is_due("write_time_series"):
        state = write_time_series(state, cfg)
    return state


# -----------------------------------------------------------------------------
# driver
# -----------------------------------------------------------------------------

def _intervals(cfg):
    return [("write_checkpoint", cfg.get_double("cpi")),
            ("write_diagnostics", cfg.get_double("dfi")),
            ("write_time_series", cfg.get_double("tsi"))]


def setup(argv, *, device=None, dtype=None):
    """Config and initial state (solution and schedule) of a run, with the
    banner; writes no file. Returns (cfg, state)."""
    device = resolve_device(device)
    cfg = driver.create_run_config(config_template(), argv)
    if cfg.get_string("reconstruct_method") not in RECONSTRUCT_METHODS:
        raise ValueError("reconstruct_method must be pcm, plm or weno5")
    cfg.pretty_print()
    solution = create_solution(cfg, device=device, dtype=dtype)
    schedule = driver.create_schedule(cfg, list(TASKS))
    system = system_name(hydro_system(cfg))
    where = (f"CUDA kernel B5 on {torch.cuda.get_device_name(device)}"
             if device.type == "cuda" else "the scheme (torch ops) on the CPU")
    loop = "chunked" if resolve_auto(cfg, "fast_step", device) else "per-step"
    print(f"advance: {where}, {system} "
          f"{cfg.get_string('reconstruct_method')}, "
          f"{str(solution.conserved.dtype).replace('torch.', '')}, the "
          f"{loop} loop")
    return cfg, State(solution, schedule)


def _run_fast(cfg, state: State, tasks) -> State:
    """The chunked loop: each chunk (128, 32, 8 or 1 steps) is one
    advance_n call, planned to land on the next task due or tfinal. Under a
    profiler the loop records the spans and counters of app/tracing.py. A
    chunk is left running on the card while the next is planned and
    launched; the loop waits for it before a task due and drains it at
    its end."""
    rec = tracing.recorder()
    s = state.solution
    schedule = state.schedule
    chunks = driver.ChunksInFlight(rec, s.conserved.device)
    newtonian = cfg.get_int("newtonian") != 0
    dt = grid_dt(s.vertices)
    tfinal = cfg.get_double("tfinal")
    method = cfg.get_string("reconstruct_method")
    theta = cfg.get_double("plm_theta")
    intervals = _intervals(cfg)
    u, t, it = s.conserved, float(s.time), int(s.iteration)
    nz = u.shape[0]
    while t < tfinal - driver.EPS:
        with rec.span("mara3.chunk", iteration=it):
            with rec.span("mara3.plan"):
                n_cap = driver.steps_to_next_stop(
                    t, dt, tfinal, [schedule.last_performed(name) + ivl
                                    for name, ivl in intervals])
                n = next(c for c in CHUNKS if c <= n_cap)
            with chunks.launch():
                u = advance_n(u, s.vertices, dt, newtonian, n, method,
                              theta)
            t += n * dt
            it += n
            chunks.end(n, it, t, nz, LAST_PATH)
            schedule = mark_tasks(schedule, t, intervals)
            if driver.due_tasks(schedule):
                chunks.wait()
            with driver.traced_outputs(rec, schedule) as due:
                if due:
                    schedule = tasks(State(replace(s, time=t, iteration=it,
                                                   conserved=u), schedule),
                                     cfg).schedule
    chunks.drain()
    final = State(replace(s, time=t, iteration=it, conserved=u),
                  mark_tasks(schedule, t, intervals))
    return tasks(final, cfg)


def _run_per_step(cfg, state: State, tasks) -> State:
    """The per-step loop of the JAX package (one advance_n call a step),
    which ends with one more step and its tasks after tfinal."""
    newtonian = cfg.get_int("newtonian") != 0
    rec = cfg.get_string("reconstruct_method")
    theta = cfg.get_double("plm_theta")
    intervals = _intervals(cfg)

    def next_state(st):
        s = next_solution(st.solution, newtonian, rec, theta)
        return State(s, mark_tasks(st.schedule, s.time, intervals))

    tfinal = cfg.get_double("tfinal")
    while state.solution.time < tfinal:
        state, perf = time_execution(lambda st: tasks(next_state(st), cfg),
                                     state)
        s = state.solution
        if s.iteration % 100 == 0:
            driver.print_run_loop_message(s.iteration, s.time,
                                          s.conserved.shape[0],
                                          perf.execution_time_ms)
    return tasks(next_state(state), cfg)


def run(cfg, state: State, tasks=run_tasks) -> State:
    """The run after its initial tasks, through the loop fast_step picks,
    with `tasks(state, cfg)` for the checkpoints, diagnostics and time
    series; returns the final state. Raises driver.NonFiniteState if a
    write or the end finds the state not finite."""
    state = tasks(state, cfg)
    if resolve_auto(cfg, "fast_step", state.solution.conserved.device):
        final = _run_fast(cfg, state, tasks)
    else:
        final = _run_per_step(cfg, state, tasks)
    check_finite(final.solution)
    return final


@register("sedov")
def main(argv, *, device=None, dtype=None) -> int:
    cfg, state = setup(argv, device=device, dtype=dtype)
    prepare_filesystem(cfg)
    run(cfg, state)
    return 0
