"""Kelvin-Helmholtz shear layer: 2D isothermal gas on a uniform doubly-
periodic grid.

Port of mara3_tpu/subprograms/kh.py: the flagship's PLM + HLLE/HLLC iso2d
Godunov update (subprog_binary_scheme.cpp:268-343, 568-612) on a plain
uniform periodic box, a beyond-reference workload. The whole chunk of steps
between two scheduled outputs is one call of the advance:

- fast_step=-1 (auto): kernel B1 (kernels/iso2d_step.py, csrc/iso2d_step.cu)
  on a CUDA device, the scheme (schemes/iso2d_grid.py) on the CPU;
- fast_step=1: B1, whose plain PyTorch version runs on the CPU;
- fast_step=0: the scheme on the run's device;
- shards=N (N != 0): the x-sharded run (make_sharded_advance,
  parallel/iso2d_sharded.py): N x-slabs, each advanced by kernel B9
  (kernels/iso2d_step_v4.py, csrc/iso2d_ladder.cu) in grains of G = 4
  steps, with edge strips copied from the neighbor slabs. shards=-1 takes
  every CUDA card; on the CPU the N slabs share the CPU (B9's plain version
  runs on each), as the JAX package's tests share 8 virtual CPU devices.
  fast_step is not read then, as in the JAX package.

B1 takes any step count and any N >= 4 in one call, so no remainder runs
through the scheme, and the JAX package's fallback chain (v5, v4, then the
scheme) is not carried over: a kernel that fails raises. kh keeps the state
[N, N, 3] at its public functions and in checkpoints; each B1 chunk moves
it to [3, N, N] and back, so a chunk copies the state twice.

precision: "" is float32 unless the caller passes a dtype (the tests pass
float64); f32 and f64 are honoured; bf16 raises NotImplementedError naming
the ROADMAP.md item that will port it.

Setup: density band sigma1 inside |y - 1/2| < 1/4 (else sigma0) moving at
+mach*cs, the rest at -mach*cs, with a small sinusoidal vy seed at both
interfaces. dt is FIXED for the run (the reference's fixed_dt mode,
subprog_binary.cpp:67), computed once from the initial CFL condition and
stored in checkpoints so restarted runs are bit-identical to uninterrupted
ones.

The run's device is the CUDA card unless the caller asks for the CPU
(app/device.py). h5py is imported only by the functions that touch files.
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
from mara3_tpu_torch.schemes import iso2d_grid


def config_template():
    """The JAX package's keys and defaults, so command lines and
    checkpoints carry over between the two."""
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("N", 1024)            # square grid
            .item("cs", 1.0)            # isothermal sound speed
            .item("mach", 0.5)          # band speed / cs
            .item("sigma0", 1.0)        # outer band density
            .item("sigma1", 2.0)        # inner band density
            .item("pert", 0.01)         # vy seed amplitude
            .item("pert_k", 2)          # vy seed wavenumber (cycles/box)
            .item("plm_theta", 1.8)
            .item("riemann", "hlle")    # hlle | hllc (all paths)
            .item("rk_order", 1)        # 2 = SSP-RK2 (all paths)
            # "" = float32 unless the caller passes a dtype; f32 | f64
            # (bf16 is not ported yet)
            .item("precision", "")
            .item("cfl", 0.3)
            .item("fixed_dt", 0.0)      # 0 -> cfl * dx / max wavespeed(IC)
            .item("tfinal", 2.0)
            .item("cpi", 0.5)           # checkpoint interval
            .item("dfi", 0.25)          # diagnostics interval
            .item("tsi", 0.05)          # time-series interval
            # -1 auto (kernel B1 on a CUDA device, the scheme on the CPU),
            # 0 the scheme, 1 kernel B1 (its plain version on the CPU)
            .item("fast_step", -1)
            # x-shard the grid over this many devices and advance each slab
            # with kernel B9, halos copied from the neighbor slabs
            # (parallel/iso2d_sharded.py). 0 = off, -1 = every CUDA card
            # (one shard on the CPU); on the CPU N shards share the CPU
            .item("shards", 0))


@dataclass(frozen=True)
class Solution:
    iteration: int
    time: float
    dt: float                     # fixed for the run; checkpointed
    conserved: torch.Tensor       # [N, N, 3] = (sigma, sigma vx, sigma vy)


def check_options(cfg):
    """Raise on the options whose paths are not ported yet."""
    if cfg.get_string("precision") == "bf16":
        raise NotImplementedError(
            "kh precision=bf16 is not ported yet: ROADMAP.md queue A item 13")


def resolve_dtype(cfg, dtype=None) -> torch.dtype:
    """The state's dtype: the precision key when set, else `dtype`, else
    float32."""
    p = cfg.get_string("precision")
    if p == "":
        return dtype or torch.float32
    check_options(cfg)
    if p not in ("f32", "f64"):
        raise ValueError(f"kh precision takes '', f32 or f64, not {p!r}")
    return {"f32": torch.float32, "f64": torch.float64}[p]


# -----------------------------------------------------------------------------
# initial condition + fixed dt
# -----------------------------------------------------------------------------

def initial_conserved(cfg, *, dtype=None, device="cpu"):
    """The shear layer [N, N, 3], computed in float64 on the host, then
    cast to the run's dtype (resolve_dtype) and moved to `device`."""
    n = cfg.get_int("N")
    cs = cfg.get_double("cs")
    f64 = lambda v: torch.tensor(v, dtype=torch.float64)
    x = ((torch.arange(n, dtype=torch.float64) + 0.5)[:, None]) / n
    y = ((torch.arange(n, dtype=torch.float64) + 0.5)[None, :]) / n
    inner = torch.abs(y - 0.5) < 0.25
    sigma = torch.where(inner, f64(cfg.get_double("sigma1")),
                        f64(cfg.get_double("sigma0"))) * torch.ones_like(x * y)
    vx = torch.where(inner, f64(1.0), f64(-1.0)) * cfg.get_double("mach") * cs
    vx = vx * torch.ones_like(sigma)
    k = cfg.get_int("pert_k")
    # seed localized at the two interfaces y = 1/4, 3/4
    envelope = (torch.exp(-((y - 0.25) / 0.05) ** 2)
                + torch.exp(-((y - 0.75) / 0.05) ** 2))
    vy = (cfg.get_double("pert") * cs
          * torch.sin(2 * math.pi * k * x) * envelope)
    u = torch.stack([sigma, sigma * vx, sigma * vy], dim=-1)
    return u.to(dtype=resolve_dtype(cfg, dtype), device=device)


def fixed_timestep(cfg, u0) -> float:
    dt = cfg.get_double("fixed_dt")
    if dt > 0.0:
        return dt
    n = cfg.get_int("N")
    cs2 = cfg.get_double("cs") ** 2
    P = u0.detach().cpu().numpy().astype(np.float64)
    P[..., 1] /= P[..., 0]
    P[..., 2] /= P[..., 0]
    amax = float(np.max(np.abs(P[..., 1:3])) + math.sqrt(cs2))
    return cfg.get_double("cfl") / n / amax


# -----------------------------------------------------------------------------
# advance: kernel B1, or the scheme
# -----------------------------------------------------------------------------

LAST_PATH = "unset"   # what the last chunk ran, e.g. cuda_b1_rk1[11]


def _advance_scheme(u, n: int, cs2: float, dx: float, dy: float, dt: float,
                    theta: float, riemann: str, rk_order: int = 1):
    step = (iso2d_grid.step_periodic_uniform if rk_order == 1
            else iso2d_grid.step_periodic_uniform_rk2)
    for _ in range(n):
        u = step(u, cs2, dx, dy, dt, theta, riemann)
    return u


def advance_n(u, n: int, *, cs2: float, dx: float, dy: float, dt: float,
              theta: float, riemann: str = "hlle", rk_order: int = 1,
              kernel=None):
    """n steps on [N, N, 3] (forward Euler, or SSP-RK2 when rk_order=2).
    kernel: None = auto (B1 iff u is on a CUDA device), False = the scheme,
    True = B1 (its plain version for a CPU tensor)."""
    global LAST_PATH
    if kernel is None:
        kernel = u.device.type == "cuda"
    if not kernel:
        LAST_PATH = f"scheme_rk{rk_order}[{n}]"
        return _advance_scheme(u, n, cs2, dx, dy, dt, theta, riemann,
                               rk_order)
    from mara3_tpu_torch.kernels import iso2d_step
    uT = u.permute(2, 0, 1).contiguous()
    uT = iso2d_step.advance_n(uT, n, cs2=cs2, dtdx=dt / dx, dtdy=dt / dy,
                              theta=theta, rk_order=rk_order,
                              riemann=riemann)
    where = "cuda" if u.device.type == "cuda" else "plain"
    LAST_PATH = f"{where}_b1_rk{rk_order}[{n}]"
    return uT.permute(1, 2, 0).contiguous()


def _pick_tx(nx: int):
    """The JAX package's stripe width for a slab of nx rows (kh.py:148-156):
    it decides which shard counts run (2 G rk_order <= TX), so it is kept;
    the widths do not change the result."""
    for tx in (256, 512, 128, 64, 32, 16, 8):
        if nx % tx == 0 and (nx // tx) % 2 == 0:
            return tx
    return None


def make_sharded_advance(cfg, dt: float, device):
    """The x-sharded advance of kh.py:240-276: `shards` slabs of the [3, N,
    N] state, kernel B9 on each in grains of G = 4 steps. Returns
    (advance(shards, n), devices, G). On a CUDA device shards=-1 takes
    every card and more shards than cards raise; on the CPU shards=-1 is
    one shard and N shards share the CPU. The JAX package's TPU layout rules
    (N % 128, TX % 8) are not kept."""
    from mara3_tpu_torch.parallel import iso2d_sharded
    shards = cfg.get_int("shards")
    device = torch.device(device)
    if device.type == "cuda":
        count = torch.cuda.device_count()
        ndev = count if shards < 0 else shards
        if ndev > count:
            raise ValueError(f"shards={ndev} but only {count} devices")
        devices = [torch.device("cuda", k) for k in range(ndev)]
    else:
        ndev = 1 if shards < 0 else shards
        devices = [device] * ndev
    n = cfg.get_int("N")
    if ndev < 1 or n % ndev:
        raise ValueError(f"N={n} not divisible by shards={ndev}")
    tx = _pick_tx(n // ndev) or (n // ndev)
    G = 4
    rk = cfg.get_int("rk_order")
    if 2 * G * rk > tx:
        raise ValueError(
            f"sharded rk_order={rk} needs stripe width >= {2 * G * rk} "
            f"(local width {n // ndev} gives TX={tx}); use fewer shards")
    adv = iso2d_sharded.make_advance_v4_sharded(
        devices, G=G, cs2=cfg.get_double("cs") ** 2, dtdx=dt * n,
        dtdy=dt * n, theta=cfg.get_double("plm_theta"), TX=tx,
        rk_order=rk, riemann=cfg.get_string("riemann"))
    return adv, devices, G


def advance_sharded(u, n: int, advance, devices):
    """n steps of u [N, N, 3] through a sharded advance (n a multiple of
    its G): u's [3, N, N] image split over `devices`, advanced, and
    gathered back on u's device."""
    global LAST_PATH
    from mara3_tpu_torch.parallel import iso2d_sharded
    shards = iso2d_sharded.shard_state(u.permute(2, 0, 1), devices)
    uT = iso2d_sharded.gather_state(advance(shards, n), u.device)
    LAST_PATH = f"sharded_b9[{len(devices)}dev]"
    return uT.permute(1, 2, 0).contiguous()


def advance_kwargs(cfg, dt: float) -> dict:
    """advance_n's keywords for a run of `cfg` with time step dt."""
    n = cfg.get_int("N")
    fast = cfg.get_int("fast_step")
    return dict(cs2=cfg.get_double("cs") ** 2, dx=1.0 / n, dy=1.0 / n,
                dt=dt, theta=cfg.get_double("plm_theta"),
                riemann=cfg.get_string("riemann"),
                rk_order=cfg.get_int("rk_order"),
                kernel=None if fast < 0 else bool(fast))


# -----------------------------------------------------------------------------
# state carried across packages
# -----------------------------------------------------------------------------

def solution_from_arrays(arrays: Mapping, *, device="cpu",
                         dtype=None) -> Solution:
    """A Solution from host values: the JAX package's state (iteration,
    time, dt, conserved) as numpy arrays, or a checkpoint's solution group;
    dtype None keeps the array's."""
    u = torch.as_tensor(np.asarray(arrays["conserved"]))
    return Solution(int(arrays["iteration"]), float(arrays["time"]),
                    float(arrays["dt"]),
                    u.to(device=device, dtype=dtype or u.dtype))


# -----------------------------------------------------------------------------
# outputs
# -----------------------------------------------------------------------------

TIME_SERIES_COLUMNS = ("time", "total_mass", "momentum_x", "momentum_y",
                       "kinetic_energy", "sigma_min", "sigma_max")


def compute_time_series_data(solution: Solution, cfg):
    """The time-series row, reduced in float64 on the state's device (the
    host reads seven numbers, not the state)."""
    u = solution.conserved.to(torch.float64)
    n = u.shape[0]
    da = (1.0 / n) ** 2
    sigma = u[..., 0]
    ke = 0.5 * (u[..., 1] ** 2 + u[..., 2] ** 2) / sigma
    row = torch.stack([sigma.sum() * da, u[..., 1].sum() * da,
                       u[..., 2].sum() * da, ke.sum() * da, sigma.min(),
                       sigma.max()]).tolist()
    return {"time": solution.time,
            **dict(zip(TIME_SERIES_COLUMNS[1:], row))}


def vorticity(u, dx):
    """z-vorticity dvy/dx - dvx/dy by periodic central differences."""
    vx = u[..., 1] / u[..., 0]
    vy = u[..., 2] / u[..., 0]
    dvy_dx = (np.roll(vy, -1, axis=0) - np.roll(vy, 1, axis=0)) / (2 * dx)
    dvx_dy = (np.roll(vx, -1, axis=1) - np.roll(vx, 1, axis=1)) / (2 * dx)
    return dvy_dx - dvx_dy


@dataclass(frozen=True)
class State:
    solution: Solution
    schedule: Schedule


def write_checkpoint(state: State, cfg) -> State:
    # complete the task *before* writing so the checkpoint stores the
    # post-completion count and restarts continue numbering without
    # overwriting (subprog_binary.cpp:331-341 ordering)
    count = state.schedule.num_times_performed("write_checkpoint")
    schedule = state.schedule.mark_as_completed("write_checkpoint")
    path = driver.checkpoint_path(cfg, count)
    s = state.solution
    driver.check_finite("kh", [s.conserved], s.iteration, s.time)

    def write_solution(group):
        group["iteration"] = np.int64(s.iteration)
        group["time"] = np.float64(s.time)
        group["dt"] = np.float64(s.dt)
        group["conserved"] = s.conserved.detach().cpu().numpy()

    driver.write_checkpoint_groups(path, cfg, schedule, write_solution)
    return replace(state, schedule=schedule)


def write_diagnostics(state: State, cfg) -> State:
    import h5py
    count = state.schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              cfg.get_string("outdir"))
    u = state.solution.conserved.detach().cpu().numpy().astype(np.float64)
    driver.check_finite("kh", [u], state.solution.iteration,
                        state.solution.time)
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(state.solution.time)
        f["sigma"] = u[..., 0]
        f["vorticity"] = vorticity(u, 1.0 / u.shape[0])
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
    data = compute_time_series_data(state.solution, cfg)
    with h5py.File(_time_series_path(cfg), "r+") as f:
        for name, value in data.items():
            ds = f[name]
            ds.resize((row + 1,))
            ds[row] = value
    return replace(state, schedule=state.schedule.mark_as_completed(
        "write_time_series"))


def prepare_filesystem(cfg):
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


TASKS = ("write_checkpoint", "write_diagnostics", "write_time_series")


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

def create_state(cfg, *, device="cpu", dtype=None) -> Solution:
    """The initial solution, or the checkpoint's (`restart`), on `device`
    in resolve_dtype(cfg, dtype)."""
    dtype = resolve_dtype(cfg, dtype)
    restart = cfg.get_string("restart")
    if restart:
        import h5py
        with h5py.File(restart, "r") as f:
            g = f["solution"]
            return solution_from_arrays(
                {k: g[k][()] for k in ("iteration", "time", "dt",
                                       "conserved")},
                device=device, dtype=dtype)
    u0 = initial_conserved(cfg, dtype=dtype, device=device)
    return Solution(0, 0.0, fixed_timestep(cfg, u0), u0)


@tracing.phased("mara3.setup")
def setup(argv, *, device=None, dtype=None):
    """Config and initial state (solution and schedule) of a run, with the
    banner; writes no file. Returns (cfg, state)."""
    device = resolve_device(device)
    cfg = driver.create_run_config(config_template(), argv)
    check_options(cfg)
    cfg.pretty_print()
    solution = create_state(cfg, device=device, dtype=dtype)
    schedule = driver.create_schedule(cfg, list(TASKS))
    kernel = advance_kwargs(cfg, solution.dt)["kernel"]
    if kernel is None:
        kernel = device.type == "cuda"
    if cfg.get_int("shards") != 0:
        _, devices, _ = make_sharded_advance(cfg, solution.dt, device)
        kind = ("CUDA kernel B9" if device.type == "cuda"
                else "kernel B9's plain version")
        where = (f"{kind} x-sharded over {len(devices)} shards on "
                 f"{device.type} (edge strips copied from the neighbors)")
    elif not kernel:
        where = f"the scheme (torch ops) on {device.type}"
    elif device.type == "cuda":
        where = f"CUDA kernel B1 on {torch.cuda.get_device_name(device)}"
    else:
        where = "kernel B1's plain version on the CPU"
    print(f"advance: {where}, "
          f"{str(solution.conserved.dtype).replace('torch.', '')}")
    return cfg, State(solution, schedule)


def run(cfg, state: State, tasks=run_tasks) -> State:
    """The driver loop until tfinal, with `tasks(state, cfg)` for the
    checkpoints, diagnostics and time series: each chunk of steps lands
    exactly on the next scheduled output (or tfinal) and is one call of
    advance_n; sharded (shards != 0), each chunk is rounded up to whole
    grains of G steps and is one call of the sharded advance. Prints kzps
    per chunk; returns the final state. Raises driver.NonFiniteState if a
    write or the end finds the state not finite. A chunk is left running
    on the card while the next is planned and launched; the loop drains it
    before a task due and at its end."""
    rec = tracing.recorder()
    s = state.solution
    chunks = driver.ChunksInFlight(rec, s.conserved.device)
    n = cfg.get_int("N")
    kw = advance_kwargs(cfg, s.dt)
    sharded = (make_sharded_advance(cfg, s.dt, s.conserved.device)
               if cfg.get_int("shards") != 0 else None)
    intervals = [("write_checkpoint", cfg.get_double("cpi")),
                 ("write_diagnostics", cfg.get_double("dfi")),
                 ("write_time_series", cfg.get_double("tsi"))]
    tfinal = cfg.get_double("tfinal")
    while state.solution.time < tfinal - driver.EPS:
        with rec.span("mara3.chunk", iteration=state.solution.iteration):
            if driver.due_tasks(state.schedule):
                chunks.drain()
            with driver.traced_outputs(rec, state.schedule):
                state = tasks(state, cfg)
            s = state.solution
            with rec.span("mara3.plan"):
                n_run = driver.steps_to_next_stop(
                    s.time, s.dt, tfinal,
                    [state.schedule.last_performed(name) + interval
                     for name, interval in intervals])
                if sharded is not None:
                    # whole grains; rounding up keeps 'first time >= due'
                    # (tasks fire at the next loop top), as in the JAX package
                    advance, devices, grain = sharded
                    n_run = grain * math.ceil(n_run / grain)
            with chunks.launch():
                if sharded is None:
                    u1 = advance_n(s.conserved, n_run, **kw)
                else:
                    u1 = advance_sharded(s.conserved, n_run, advance,
                                         devices)
            s = replace(s, iteration=s.iteration + n_run,
                        time=s.time + n_run * s.dt, conserved=u1)
            chunks.end(n_run, s.iteration, s.time, n * n, LAST_PATH)
            # a chunk planned onto a due can end a round-off short of it
            # (512 steps of dt = 0.3 / 2048 / 1.5 end at 0.05 - 7e-18), so
            # tasks are marked within EPS; marked at s.time, as the JAX
            # package marks them, that output would be skipped
            state = State(s, mark_tasks(state.schedule, s.time + driver.EPS,
                                        intervals))
    chunks.drain()
    final = tasks(state, cfg)
    s = final.solution
    driver.check_finite("kh", [s.conserved], s.iteration, s.time)
    return final


@register("kh")
def main(argv, *, device=None) -> int:
    cfg, state = setup(argv, device=device)
    prepare_filesystem(cfg)
    run(cfg, state)
    return 0
