"""Relativistic jet / cloud interaction (GRB progenitor) in 2D (r, theta).

Port of mara3_tpu/subprograms/cloud.py (the reference's
subprog_cloud.cpp:40-954): SRHD on a log-radial x polar spherical mesh; the
initial state from the cloud/envelope model at t = jet_delay_time; the inner
guard row is the structured jet nozzle's inflow (mirrored about the
equator, q -> pi - q); zero-gradient outer guard; zero polar flux through
the poles; pcm or plm with zero edge slopes; RK1 or Shu-Osher RK2; the
spherical source terms; the CGS unit banner. The conserved state is
extrinsic (U * dv per cell), [nr, nq, 5] in the Solution and in
checkpoints, [5, nr, nq] (one plane per component) inside the loops.

Every step goes through one of three routes:

- on a CUDA device, kernel B4 (kernels/cloud_update.py,
  csrc/cloud_update.cu): the chunked loop's chunks are B4d calls of any
  step count (`multi_launch=1`, the default there) or one B4c (rk2) or B4b
  (rk1) call a step (`multi_launch=0`), and the per-step loop's steps are
  B4c or B4b calls. No remainder or fallback path: a kernel that fails
  raises;
- on the CPU, the scheme (_flux_update, _advance_once_soa) as torch ops;
  kernel=True runs B4's plain versions there instead.

fast_step picks the driver loop, as in the JAX package: 1 the chunked loop
(chunks of 64, 16, 4 and 1 steps planned onto the task dues), 0 the
per-step loop, -1 (the default) 1 on a CUDA device and 0 on the CPU;
multi_launch -1 resolves likewise.

The Newton's warm-start pressure is carried from stage to stage and step to
step in the run (Solution.pressure) and is not checkpointed: a restart
starts its first stage from p = 0, as the JAX package's does.

The state's dtype is float32 unless the caller passes one (the tests pass
float64); the vertices are in the state's dtype, as the JAX package keeps
them. The CGS model is evaluated in float64 on the CPU and only the
code-unit ratios are cast. The run's device is the CUDA card unless the
caller asks for the CPU (app/device.py). h5py is imported only by the
functions that touch files.
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
from mara3_tpu_torch.core import dimensional as dim
from mara3_tpu_torch.core import ops
from mara3_tpu_torch.kernels.cloud_update import Geometry
from mara3_tpu_torch.mathx.plm import plm_gradient
from mara3_tpu_torch.mathx.shock import (find_index_of_maximum_behind,
                                         find_index_of_pressure_plateau_ahead,
                                         find_shock_index)
from mara3_tpu_torch.models.atmosphere import (CloudAndEnvelope,
                                               PowerLawAtmosphere)
from mara3_tpu_torch.models.jet_nozzle import JetNozzle
from mara3_tpu_torch.physics import srhd

GAMMA_LAW_INDEX = 4.0 / 3.0
LIGHT_SPEED_CGS = 2.998e10
SOLAR_MASS_CGS = 1.989e33
CHUNKS = (64, 16, 4, 1)      # the chunked loop's step counts
TASKS = ("write_checkpoint", "write_diagnostics", "write_time_series")


def config_template():
    """The JAX package's keys and defaults, so command lines and
    checkpoints carry over between the two."""
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("nr", 256)
            .item("tfinal", 1.0)
            .item("cpi", 10.0)
            .item("tsi", 0.1)
            .item("dfi", 1.0)
            .item("num_decades", 2.0)
            .item("inner_radius", 3e08)
            .item("cloud_cutoff", 3e10)
            .item("cloud_mass", 2e-2)
            .item("density_index", 2.0)
            .item("density_index2", 6.0)
            .item("jet_delay_time", 1.0)
            .item("jet_total_energy", 1e50)
            .item("jet_duration", 1.0)
            .item("jet_gamma_beta", 10.0)
            .item("jet_opening_angle", 0.1)
            .item("jet_structure_exp", 2.0)
            .item("cfl_number", 0.4)
            .item("rk_order", 1)
            .item("reconstruct_method", 2)
            .item("plm_theta", 1.2)
            # driver loop: -1 auto (1 on a CUDA device, else 0), 0 the
            # per-step loop, 1 the chunked loop
            .item("fast_step", -1)
            # the chunked loop's kernel calls: -1 auto (1 on a CUDA device,
            # else 0), 0 one B4c or B4b call a step, 1 one B4d call a chunk
            .item("multi_launch", -1)
            .item("temperature_floor", 1e-8))


# -----------------------------------------------------------------------------
# models and units (subprog_cloud.cpp:285-330)
# -----------------------------------------------------------------------------

def make_cloud_envelope_model(cfg) -> CloudAndEnvelope:
    return CloudAndEnvelope(inner_radius=cfg.get_double("inner_radius"),
                            cloud_index=cfg.get_double("density_index"))


def make_atmosphere_model(cfg) -> PowerLawAtmosphere:
    m = PowerLawAtmosphere(inner_radius=cfg.get_double("inner_radius"),
                           cutoff_radius=cfg.get_double("cloud_cutoff"),
                           inner_index=cfg.get_double("density_index"),
                           outer_index=cfg.get_double("density_index2"))
    return m.with_total_mass(cfg.get_double("cloud_mass") * SOLAR_MASS_CGS)


def make_jet_nozzle_model(cfg) -> JetNozzle:
    return JetNozzle(Ej=cfg.get_double("jet_total_energy"),
                     G0=cfg.get_double("jet_gamma_beta"),
                     tj=cfg.get_double("jet_duration"),
                     qj=cfg.get_double("jet_opening_angle"),
                     as_=cfg.get_double("jet_structure_exp"),
                     r0=cfg.get_double("inner_radius"))


@dataclass(frozen=True)
class UnitSystem:
    """CGS reference units (subprog_cloud.cpp:177-195). The derived units
    are built by Quantity algebra (core/dimensional.py), so their exponents
    are checked; the float properties hand back their values."""
    length: float = 1.0   # cm
    mass: float = 1.0     # g
    time: float = 1.0     # s

    def quantities(self):
        L = dim.make_length(self.length)
        M = dim.make_mass(self.mass)
        T = dim.make_time(self.time)
        c = dim.make_velocity(LIGHT_SPEED_CGS)
        return dict(length=L, mass=M, time=T, velocity=c,
                    energy=M * c * c,
                    mass_density=M / (L * L * L),
                    energy_density=M * c * c / (L * L * L),
                    power=M * c * c / T)

    @property
    def velocity(self): return LIGHT_SPEED_CGS
    @property
    def energy(self):
        return dim.require_dims(self.quantities()["energy"], 2, 1, -2,
                                "energy")
    @property
    def mass_density(self):
        return dim.require_dims(self.quantities()["mass_density"], -3, 1, 0,
                                "mass_density")
    @property
    def energy_density(self):
        return dim.require_dims(self.quantities()["energy_density"], -1, 1,
                                -2, "energy_density")
    @property
    def power(self):
        return dim.require_dims(self.quantities()["power"], 2, 1, -3,
                                "power")


def make_reference_units(cfg) -> UnitSystem:
    atmosphere = make_atmosphere_model(cfg)
    r0 = atmosphere.inner_radius
    return UnitSystem(length=r0, mass=atmosphere.total_mass(),
                      time=r0 / LIGHT_SPEED_CGS)


def jet_static(cfg):
    """The inflow row's constants: (Ej, G0, tj, qj, as, r0, the reference
    mass density, the reference time)."""
    units = make_reference_units(cfg)
    jet = make_jet_nozzle_model(cfg)
    return (jet.Ej, jet.G0, jet.tj, jet.qj, jet.as_, jet.r0,
            units.mass_density, units.time)


# -----------------------------------------------------------------------------
# spherical mesh geometry (subprog_cloud.cpp:253-283)
# -----------------------------------------------------------------------------

def radial_face_areas(rv, qv):
    """dA_r[i, j] = rv[i]^2 (cos q[j] - cos q[j+1]) 2 pi,  [Nr+1, Nq]."""
    dm = -ops.difference_on_axis(torch.cos(qv))
    return rv[:, None] ** 2 * dm[None, :] * 2 * math.pi


def polar_face_areas(rv, qv):
    """dA_q[i, j] = rc[i] dr[i] sin(q[j]) 2 pi,  [Nr, Nq+1]."""
    rc = ops.midpoint_on_axis(rv)
    dr = ops.difference_on_axis(rv)
    return (rc * dr)[:, None] * torch.sin(qv)[None, :] * 2 * math.pi


def cell_volumes(rv, qv):
    """dv[i, j] = (rv[i+1]^3 - rv[i]^3)/3 (cos q[j] - cos q[j+1]) 2 pi."""
    dr3 = ops.difference_on_axis(rv ** 3)
    dm = -ops.difference_on_axis(torch.cos(qv))
    return ops.div_scalar(dr3[:, None] * dm[None, :] * 2 * math.pi, 3.0)


def make_geometry(rv, qv):
    """(rv, qv, rc, qc, dv, dAr, dAq): the scheme's geometry tuple."""
    return (rv, qv, ops.midpoint_on_axis(rv), ops.midpoint_on_axis(qv),
            cell_volumes(rv, qv), radial_face_areas(rv, qv),
            polar_face_areas(rv, qv))


def kernel_geometry(rv, qv) -> Geometry:
    """Kernel B4's geometry: dv, dAr, dAq, 1 / rc and tan(pi/2 - qc), as the
    JAX package hands them to its kernels (cloud.py:510-517)."""
    rc, qc = ops.midpoint_on_axis(rv), ops.midpoint_on_axis(qv)
    return Geometry(cell_volumes(rv, qv), radial_face_areas(rv, qv),
                    polar_face_areas(rv, qv), ops.scalar_div(1.0, rc),
                    torch.tan(math.pi / 2 - qc))


# -----------------------------------------------------------------------------
# solution state
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class Solution:
    time: float
    iteration: int
    radial_vertices: torch.Tensor
    polar_vertices: torch.Tensor
    conserved: torch.Tensor  # extrinsic U*dv, [Nr, Nq, 5]
    # the run's Newton warm start (the last stage's recovered pressure,
    # [Nr, Nq]); not checkpointed
    pressure: torch.Tensor | None = None


def new_solution(cfg, *, device="cpu", dtype=None) -> Solution:
    """The initial state at jet_delay_time, formed on the host in dtype
    (float32 by default) with the CGS model in float64, then moved to
    `device`."""
    dtype = dtype or torch.float32
    envelope = make_cloud_envelope_model(cfg)
    units = make_reference_units(cfg)
    jet_delay_time = cfg.get_double("jet_delay_time")

    nr = cfg.get_int("nr")
    num_decades = cfg.get_double("num_decades")
    rv = 10.0 ** torch.linspace(0.0, num_decades, int(num_decades * nr) + 1,
                                dtype=dtype)
    qv = torch.linspace(0.0, math.pi, nr + 1, dtype=dtype)
    rc = ops.midpoint_on_axis(rv)
    dv = cell_volumes(rv, qv)

    # the envelope model works in CGS: each quantity is tagged, divided by
    # the matching reference unit and checked dimensionless, in float64
    uq = units.quantities()
    temperature = 1e-6
    r_cm = rc.to(torch.float64) * units.length
    density_cgs = dim.make_mass_density(
        envelope.density_at(r_cm, jet_delay_time))
    density64 = dim.require_dims(density_cgs / uq["mass_density"],
                                 0, 0, 0, "code density")
    gamma_beta64 = envelope.gamma_beta_at(r_cm, jet_delay_time)
    density = density64.to(dtype)
    gamma_beta = gamma_beta64.to(dtype)

    nq = qv.shape[0] - 1
    rho = density[:, None].expand(rc.shape[0], nq)
    ur = gamma_beta[:, None].expand(rc.shape[0], nq)
    z = torch.zeros_like(rho)
    # code values keep their unit types through the constructor, as the
    # reference's unit_mass_density etc. do (physics_srhd.hpp:71-97)
    P = srhd.primitive_from_quantities(
        dim.require_dims(dim.make_mass_density(rho), -3, 1, 0,
                         "mass_density"),
        ur, z, z,
        dim.require_dims(dim.make_quantity(rho * temperature, -1, 1, -2),
                         -1, 1, -2, "gas_pressure"))
    U = srhd.to_conserved_density(P, GAMMA_LAW_INDEX) * dv[..., None]
    return Solution(0.0, 0, rv.to(device), qv.to(device), U.to(device))


def solution_from_arrays(arrays: Mapping, *, device="cpu",
                         dtype=None) -> Solution:
    """A Solution from host values: the JAX package's Solution (time,
    iteration, radial_vertices, polar_vertices, conserved) as numpy arrays,
    or a checkpoint's solution group; dtype None keeps the conserved
    array's, and the vertices take the state's dtype."""
    u = torch.as_tensor(np.asarray(arrays["conserved"]))
    dtype = dtype or u.dtype

    def vertices(k):
        return torch.as_tensor(np.asarray(arrays[k])).to(device=device,
                                                         dtype=dtype)

    return Solution(float(arrays["time"]), int(arrays["iteration"]),
                    vertices("radial_vertices"), vertices("polar_vertices"),
                    u.to(device=device, dtype=dtype))


def solution_to_arrays(s: Solution) -> dict:
    """The inverse of solution_from_arrays: host numpy values."""
    return {"time": np.float64(s.time), "iteration": np.int64(s.iteration),
            "radial_vertices": s.radial_vertices.detach().cpu().numpy(),
            "polar_vertices": s.polar_vertices.detach().cpu().numpy(),
            "conserved": s.conserved.detach().cpu().numpy()}


_SOLUTION_KEYS = ("time", "iteration", "radial_vertices", "polar_vertices",
                  "conserved")


def read_solution(group, *, device="cpu", dtype=None) -> Solution:
    return solution_from_arrays({k: group[k][()] for k in _SOLUTION_KEYS},
                                device=device, dtype=dtype)


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
# the scheme (subprog_cloud.cpp:511-583)
# -----------------------------------------------------------------------------

def _face_states_1(c, axis, plm_theta, method):
    """L/R states at the n - 1 faces between neighbours along `axis` of a
    component tensor: pcm the cell values, plm the limited slopes
    zero-padded at the axis's ends (subprog_cloud.cpp:536-570)."""
    n = c.shape[axis]
    lo, hi = c.narrow(axis, 0, n - 1), c.narrow(axis, 1, n - 1)
    if method == 1:  # PCM
        return lo, hi
    g_int = plm_gradient(c.narrow(axis, 0, n - 2), c.narrow(axis, 1, n - 2),
                         c.narrow(axis, 2, n - 2), plm_theta)
    pad = torch.zeros_like(c.narrow(axis, 0, 1))
    G = torch.cat([pad, g_int, pad], dim=axis)
    return (lo + 0.5 * G.narrow(axis, 0, n - 1),
            hi - 0.5 * G.narrow(axis, 1, n - 1))


def _inflow_row(qc, t_code: float, jet_static_):
    """The jet nozzle's inner guard row of primitives [1, Nq, 5]
    (subprog_cloud.cpp:466-493): u = jet(q) + jet(pi - q),
    d = rho_base / rho_ref, p = 0."""
    (jet_Ej, jet_G0, jet_tj, jet_qj, jet_as, jet_r0,
     ref_density, ref_time) = jet_static_
    jet = JetNozzle(jet_Ej, jet_G0, jet_tj, jet_qj, jet_as, jet_r0)
    t_seconds = t_code * ref_time
    u = (jet.gamma_beta(qc, t_seconds)
         + jet.gamma_beta(math.pi - qc, t_seconds))
    d = torch.full_like(qc, jet.density_at_base() / ref_density)
    z = torch.zeros_like(qc)
    return torch.stack([d, u, z, z, z], dim=-1)[None, :, :]


def inflow_rows(qc, t0: float, dt: float, n: int, jet_static_):
    """The inflow rows [n + 1, 5, Nq] of n steps from t0, the times
    accumulated as the per-step loop accumulates them (t = t + dt, a
    float64 host number), so that row s + 1 is the row of step s's second
    stage and of step s + 1 (cloud.py:948-953)."""
    rows, t = [], t0
    for _ in range(n + 1):
        rows.append(_inflow_row(qc, t, jet_static_)[0].t())
        t = t + dt
    return torch.stack(rows).contiguous()


def _flux_update(Pt, u0, inflow, geometry, dt, plm_theta: float,
                 method: int):
    """Everything after primitive recovery: the guard rows, face states,
    HLLE on both axes, geometric sources, the conservative update of u0
    [Nr, Nq, 5]. The scheme that kernel B4 is held to."""
    rv, qv, rc, qc, dv, dAr, dAq = geometry

    s0 = srhd.spherical_geometry_source_terms_t(
        Pt, rc[:, None], qc[None, :], GAMMA_LAW_INDEX)

    # radial axis: inflow nozzle inner, zero-gradient outer
    Pe = tuple(torch.cat([inflow[..., k], c, c[-1:]], dim=0)
               for k, c in enumerate(Pt))
    LR = [_face_states_1(c, 0, plm_theta, method) for c in Pe]
    Fr = srhd.riemann_hlle_t(tuple(l for l, _ in LR),
                             tuple(r for _, r in LR),
                             (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)
    lr = tuple(-(ops.difference_on_axis(f * dAr, 0)) for f in Fr)

    # polar axis: interior faces only, zero flux at both poles
    LR = [_face_states_1(c, 1, plm_theta, method) for c in Pt]
    Fq = srhd.riemann_hlle_t(tuple(l for l, _ in LR),
                             tuple(r for _, r in LR),
                             (0.0, 1.0, 0.0), GAMMA_LAW_INDEX)
    lq = tuple(-(ops.difference_on_axis(
        torch.nn.functional.pad(f, (1, 1)) * dAq, 1)) for f in Fq)

    return torch.stack(
        [u0[..., k] + (lr[k] + lq[k] + s0[k] * dv) * dt for k in range(5)],
        dim=-1)


def _advance_once(u0, t, geometry, jet_static_, dt, plm_theta: float,
                  method: int, temperature_floor: float, p_guess=None,
                  return_pressure=False, kernel=None):
    """A stage of u0 [Nr, Nq, 5]: the scheme's recovery, then the update,
    by kernel B4a (kernel None: iff u0 is on a CUDA device; True: B4a, its
    plain version on a CPU tensor) or by the scheme's _flux_update."""
    rv, qv, rc, qc, dv, dAr, dAq = geometry
    Ut = tuple(u0[..., k] / dv for k in range(5))
    Pt = srhd.recover_primitive_t(Ut, GAMMA_LAW_INDEX, temperature_floor,
                                  p_guess)
    inflow = _inflow_row(qc, t, jet_static_)
    if kernel is None:
        kernel = u0.device.type == "cuda"
    if kernel:
        from mara3_tpu_torch.kernels import cloud_update
        Pe = torch.stack([torch.cat([inflow[..., k], c, c[-1:]])
                          for k, c in enumerate(Pt)])
        u1 = cloud_update.flux_update(
            Pe, u0.permute(2, 0, 1).contiguous(), kernel_geometry(rv, qv),
            float(dt), plm_theta, method).permute(1, 2, 0)
    else:
        u1 = _flux_update(Pt, u0, inflow, geometry, dt, plm_theta, method)
    return (u1, Pt[4]) if return_pressure else u1


def _advance_once_soa(us, t, geometry, jet_static_, dt, plm_theta, method,
                      temperature_floor, p_guess):
    """The scheme's stage of the SoA state [5, Nr, Nq]: (u1, the recovered
    pressure)."""
    rv, qv, rc, qc, dv, dAr, dAq = geometry
    inflow = _inflow_row(qc, t, jet_static_)
    Ut = tuple(us[k] / dv for k in range(5))
    Pt = srhd.recover_primitive_t(Ut, GAMMA_LAW_INDEX, temperature_floor,
                                  p_guess)
    u1 = _flux_update(Pt, us.permute(1, 2, 0), inflow, geometry, dt,
                      plm_theta, method)
    return u1.permute(2, 0, 1), Pt[4]


LAST_PATH = "unset"   # what the last advance ran, e.g. cuda_b4d_rk2[64]


def _route(us, kernel: bool, rk: int, multi: bool) -> str:
    """The label of what runs a step: scheme, or {cuda,plain}_b4{b,c,d}."""
    if not kernel:
        return "scheme"
    where = "cuda" if us.device.type == "cuda" else "plain"
    if multi:
        return f"{where}_b4d_rk{rk}"
    return f"{where}_b4c" if rk == 2 else f"{where}_b4b"


def _advance_rk_carry_soa(us, p_prev, t, rv, qv, jet_static_, dt, plm_theta,
                          method, temperature_floor, rk_order, kernel=None):
    """One step of the SoA state [5, Nr, Nq] from the warm pressure p_prev:
    (u, p). kernel None: B4 iff us is on a CUDA device (B4c for rk 2, B4b
    for rk 1; their plain versions on a CPU tensor with kernel=True),
    False: the scheme's two (or one) stages and the Shu-Osher average."""
    global LAST_PATH
    if kernel is None:
        kernel = us.device.type == "cuda"
    LAST_PATH = f"{_route(us, kernel, rk_order, False)}[1]"
    qc = ops.midpoint_on_axis(qv)
    if p_prev is None:
        p_prev = torch.zeros_like(us[0])
    if kernel:
        from mara3_tpu_torch.kernels import cloud_update
        rows = inflow_rows(qc, t, dt, 1, jet_static_)
        geo = kernel_geometry(rv, qv)
        if rk_order == 2:
            return cloud_update.step_rk2(rows[0], rows[1], us, p_prev, geo,
                                         float(dt), plm_theta, method,
                                         temperature_floor)
        return cloud_update.stage(rows[0], us, p_prev, geo, float(dt),
                                  plm_theta, method, temperature_floor)
    geometry = make_geometry(rv, qv)
    u1, p1 = _advance_once_soa(us, t, geometry, jet_static_, dt, plm_theta,
                               method, temperature_floor, p_prev)
    if rk_order == 1:
        return u1, p1
    u2, p2 = _advance_once_soa(u1, t + dt, geometry, jet_static_, dt,
                               plm_theta, method, temperature_floor, p1)
    return 0.5 * us + 0.5 * u2, p2


def grid_dt(s: Solution, cfg) -> float:
    """dt = dr_min * cfl, fixed by the grid for the run."""
    dr_min = float(s.radial_vertices[1] - s.radial_vertices[0])
    return dr_min * cfg.get_double("cfl_number")


def _scheme_args(cfg):
    return (cfg.get_double("plm_theta"), cfg.get_int("reconstruct_method"),
            cfg.get_double("temperature_floor"))


def next_solution(state: Solution, cfg, kernel=None) -> Solution:
    """One step (the per-step loop's), carrying the warm pressure."""
    dt = grid_dt(state, cfg)
    us = state.conserved.permute(2, 0, 1).contiguous()
    u1, p1 = _advance_rk_carry_soa(us, state.pressure, state.time,
                                   state.radial_vertices,
                                   state.polar_vertices, jet_static(cfg), dt,
                                   *_scheme_args(cfg), cfg.get_int("rk_order"),
                                   kernel)
    return replace(state, time=state.time + dt,
                   iteration=state.iteration + 1,
                   conserved=u1.permute(1, 2, 0).contiguous(), pressure=p1)


def advance_n(us, p, t0: float, n: int, rv, qv, jet_static_, dt: float,
              plm_theta: float, method: int, temperature_floor: float,
              rk: int, kernel=None, multi=True):
    """n steps of the SoA state [5, Nr, Nq] from t0 and the warm pressure
    p, in one call: (u, p). kernel None: B4 iff us is on a CUDA device;
    with multi, one B4d call over the inflow stack (cloud.py:926-961),
    else n steps of _advance_rk_carry_soa (B4c or B4b calls, or the
    scheme), the time accumulated alike."""
    global LAST_PATH
    if kernel is None:
        kernel = us.device.type == "cuda"
    if kernel and multi:
        from mara3_tpu_torch.kernels import cloud_update
        rows = inflow_rows(ops.midpoint_on_axis(qv), t0, dt, n, jet_static_)
        u, p = cloud_update.run_n(rows, us, p, kernel_geometry(rv, qv),
                                  float(dt), plm_theta, method,
                                  temperature_floor, rk)
    else:
        u, t = us, t0
        for _ in range(n):
            u, p = _advance_rk_carry_soa(u, p, t, rv, qv, jet_static_, dt,
                                         plm_theta, method,
                                         temperature_floor, rk, kernel)
            t = t + dt
    LAST_PATH = f"{_route(us, kernel, rk, multi)}[{n}]"
    return u, p


# -----------------------------------------------------------------------------
# diagnostics (subprog_cloud.cpp:328-420)
# -----------------------------------------------------------------------------

def make_diagnostic_fields(state: Solution, cfg):
    units = make_reference_units(cfg)
    rv, qv = state.radial_vertices, state.polar_vertices
    dv = cell_volumes(rv, qv)
    dAr = radial_face_areas(rv, qv)
    rc = ops.midpoint_on_axis(rv)

    P = srhd.recover_primitive(state.conserved / dv[..., None],
                               GAMMA_LAW_INDEX,
                               cfg.get_double("temperature_floor"))
    entropy = srhd.specific_entropy(P, GAMMA_LAW_INDEX)
    F = srhd.flux(P, (1.0, 0.0, 0.0), GAMMA_LAW_INDEX)

    # per-theta columns: the locators batched over the polar axis. The
    # fields in erg and erg/s are formed in float64: units.power and
    # units.energy are of order 1e52, past float32's range
    f64 = torch.float64
    Aj_mid = ops.midpoint_on_axis(dAr, 0)              # [Nr, Nq]
    Lj = F[..., 4].to(f64) * Aj_mid.to(f64) * units.power   # energy flow

    def col(a):                                        # [Nq, Nr]
        return a.transpose(0, 1)

    midpoint = find_shock_index(col(entropy))
    upstream = find_index_of_pressure_plateau_ahead(col(P[..., 4]), midpoint)
    pressure = find_index_of_maximum_behind(col(P[..., 4]), midpoint)
    luminosity = find_index_of_maximum_behind(col(Lj), midpoint)

    nq = qv.shape[0] - 1
    jj = torch.arange(nq, device=qv.device)
    LjT = col(Lj)

    def L_at(idx):
        return LjT[jj, idx]

    def back(k):
        return torch.where(midpoint > k, midpoint - k,
                           torch.zeros_like(midpoint))

    lorentz = torch.sqrt(1.0 + P[..., 1] ** 2 + P[..., 2] ** 2
                         + P[..., 3] ** 2)

    return {
        "time": float(state.time) * units.time,
        "mass_density": P[..., 0] * units.mass_density,
        "gas_pressure": P[..., 4] * units.energy_density,
        "specific_entropy": entropy,
        "radial_gamma_beta": P[..., 1],
        "radial_energy_flow": F[..., 4].to(f64) * dAr[:-1, :].to(f64)
                              * units.power,
        "radial_vertices": rv * units.length,
        "polar_vertices": qv,
        "solid_angle_at_theta": ops.div_scalar(dAr[0, :],
                                               float(rv[0]) ** 2),
        "total_energy_at_theta": torch.sum(state.conserved[..., 4], dim=0)
                                 .to(f64) * units.energy,
        "shock_midpoint_radius": rc[midpoint] * units.length,
        "shock_upstream_radius": rc[upstream] * units.length,
        "shock_pressure_radius": rc[pressure] * units.length,
        "shock_luminosity_radius": rc[luminosity] * units.length,
        "postshock_flow_gamma": col(lorentz)[jj, pressure],
        "postshock_flow_power": L_at(pressure),
        "postshock_flow_power02": L_at(back(2)),
        "postshock_flow_power04": L_at(back(4)),
        "postshock_flow_power08": L_at(back(8)),
        "postshock_flow_power16": L_at(back(16)),
        "postshock_flow_power32": L_at(back(32)),
        "postshock_flow_power64": L_at(back(64)),
        "postshock_flow_power_max": L_at(luminosity),
    }


# -----------------------------------------------------------------------------
# tasks (subprog_cloud.cpp:729-954)
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class State:
    solution: Solution
    schedule: Schedule


def check_finite(s: Solution):
    """Raise driver.NonFiniteState unless the state is finite."""
    driver.check_finite("cloud", [s.conserved], s.iteration, s.time)


def write_checkpoint(state: State, cfg) -> State:
    """chkpt.NNNN.h5 with the solution, the schedule (counted after this
    checkpoint, so a restart continues the numbering), run_config and its
    "config" alias."""
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
    count = state.schedule.num_times_performed("write_diagnostics")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              cfg.get_string("outdir"))
    fields = make_diagnostic_fields(state.solution, cfg)
    with h5py.File(path, "w") as f:
        for k, v in fields.items():
            f[k] = v.detach().cpu().numpy() if isinstance(v, torch.Tensor) \
                else np.asarray(v)
    print(f"write diagnostics: {path}")
    return replace(state, schedule=state.schedule.mark_as_completed(
        "write_diagnostics"))


def write_time_series(state: State, cfg) -> State:
    # the reference's write_time_series body is empty
    # (subprog_cloud.cpp:801-803); the task only advances its counter
    return replace(state, schedule=state.schedule.mark_as_completed(
        "write_time_series"))


def prepare_filesystem(cfg):
    """Create outdir and time_series.h5 with its empty time and
    shock_radius datasets; nothing on a restart."""
    import os

    import h5py
    if cfg.get_string("restart"):
        return
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    path = (f"{outdir}/time_series.h5" if outdir not in (".", "")
            else "time_series.h5")
    with h5py.File(path, "w") as f:
        for name in ("time", "shock_radius"):
            f.create_dataset(name, shape=(0,), maxshape=(None,),
                             chunks=(1000,), dtype="f8")
        serialize.write_config(f.require_group("config"), cfg)


def print_run_dimensions(cfg):
    """(subprog_cloud.cpp:863-905)."""
    c2 = LIGHT_SPEED_CGS ** 2
    env = make_cloud_envelope_model(cfg)
    jet = make_jet_nozzle_model(cfg)
    t0 = cfg.get_double("jet_delay_time")
    total_mass = env.total_mass(t0)
    r0 = env.inner_radius
    rc = float(env.cloud_outer_boundary(t0))
    print("=" * 52)
    print("model description:\n")
    print(f"\treference length.................. {r0} cm")
    print(f"\treference time.................... {r0 / LIGHT_SPEED_CGS} s")
    print(f"\treference mass.................... {total_mass} g")
    print(f"\treference density................. {total_mass / r0 ** 3} g/cm^3")
    print(f"\treference energy.................. {total_mass * c2} erg")
    print(f"\ttotal atmosphere mass............. {total_mass / SOLAR_MASS_CGS} M_solar")
    print(f"\tcloud cutoff radius............... {rc} cm")
    print(f"\tcloud velocity.................... {float(env.velocity_at(r0, t0))} cm/s")
    print(f"\tcloud four velocity............... {float(env.gamma_beta_at(r0, t0))}")
    print(f"\tdensity at cloud base............. {float(env.density_at(r0, t0))} g/cm^3")
    print(f"\tdensity at cloud cutoff........... {float(env.density_at(rc, t0))} g/cm^3")
    print(f"\tjet mass density at base.......... {jet.density_at_base()} g/cm^3")
    print(f"\tjet Lorentz factor at q=0, t=0s... {float(jet.gamma_beta(0.0, 0.0))}")
    print(f"\tjet Lorentz factor at q=0, t=1s... {float(jet.gamma_beta(0.0, 1.0))}")
    print(f"\texplosion E / M................... {jet.Ej / (total_mass * c2)}")
    print()


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


@tracing.phased("mara3.setup")
def setup(argv, *, device=None, dtype=None):
    """Config and initial state (solution and schedule) of a run, with the
    banners; writes no file. Returns (cfg, state)."""
    device = resolve_device(device)
    cfg = driver.create_run_config(config_template(), argv)
    if cfg.get_int("reconstruct_method") not in (1, 2):
        raise ValueError("reconstruct_method must be 1 (pcm) or 2 (plm)")
    if cfg.get_int("rk_order") not in (1, 2):
        raise ValueError("rk_order must be 1 or 2")
    cfg.pretty_print()
    print_run_dimensions(cfg)
    solution = create_solution(cfg, device=device, dtype=dtype)
    schedule = driver.create_schedule(cfg, list(TASKS))
    if device.type == "cuda":
        where = f"CUDA kernel B4 on {torch.cuda.get_device_name(device)}"
    else:
        where = "the scheme (torch ops) on the CPU"
    fast = resolve_auto(cfg, "fast_step", device)
    multi = resolve_auto(cfg, "multi_launch", device)
    loop = ("chunked loop" + (", one B4d call a chunk"
                              if multi and device.type == "cuda" else "")
            if fast else "per-step loop")
    print(f"advance: {where}, rk{cfg.get_int('rk_order')} "
          f"{'pcm' if cfg.get_int('reconstruct_method') == 1 else 'plm'}, "
          f"{str(solution.conserved.dtype).replace('torch.', '')}, the "
          f"{loop}")
    return cfg, State(solution, schedule)


def _run_fast(cfg, state: State, tasks) -> State:
    """The chunked loop (cloud.py:795-890): dt is fixed by the grid, so
    each chunk (64, 16, 4 or 1 steps) is planned to land on the next task
    due or tfinal, and is one advance_n call; the time is a float64 host
    number, advanced by n dt a chunk. A chunk is left running on the card
    while the next is planned and launched; the loop waits for it before a
    task due and drains it at its end."""
    rec = tracing.recorder()
    s = state.solution
    schedule = state.schedule
    chunks = driver.ChunksInFlight(rec, s.conserved.device)
    dt = grid_dt(s, cfg)
    theta, method, tfloor = _scheme_args(cfg)
    rk = cfg.get_int("rk_order")
    tfinal = cfg.get_double("tfinal")
    intervals = _intervals(cfg)
    rv, qv = s.radial_vertices, s.polar_vertices
    jet = jet_static(cfg)
    multi = resolve_auto(cfg, "multi_launch", s.conserved.device) != 0
    us = s.conserved.permute(2, 0, 1).contiguous()
    pz = s.pressure if s.pressure is not None else torch.zeros_like(us[0])
    t, it = float(s.time), int(s.iteration)
    nzones = us.shape[1] * us.shape[2]

    def solution():
        return replace(s, time=t, iteration=it,
                       conserved=us.permute(1, 2, 0).contiguous(),
                       pressure=pz)

    while t < tfinal - driver.EPS:
        with rec.span("mara3.chunk", iteration=it):
            with rec.span("mara3.plan"):
                n_cap = driver.steps_to_next_stop(
                    t, dt, tfinal, [schedule.last_performed(name) + ivl
                                    for name, ivl in intervals])
                n = next(c for c in CHUNKS if c <= n_cap)
            with chunks.launch():
                us, pz = advance_n(us, pz, t, n, rv, qv, jet, dt, theta,
                                   method, tfloor, rk, multi=multi)
            t += n * dt
            it += n
            chunks.end(n, it, t, nzones, LAST_PATH)
            schedule = mark_tasks(schedule, t, intervals)
            if driver.due_tasks(schedule):
                chunks.wait()
            with driver.traced_outputs(rec, schedule) as due:
                if due:
                    schedule = tasks(State(solution(), schedule),
                                     cfg).schedule
    chunks.drain()
    return tasks(State(solution(), mark_tasks(schedule, t, intervals)), cfg)


def _run_per_step(cfg, state: State, tasks) -> State:
    """The per-step loop of the JAX package (one step a call, the tasks
    after each), which ends with one more step and its tasks after
    tfinal."""
    intervals = _intervals(cfg)
    nzones = (state.solution.conserved.shape[0]
              * state.solution.conserved.shape[1])

    def next_state(st):
        s = next_solution(st.solution, cfg)
        return State(s, mark_tasks(st.schedule, s.time, intervals))

    tfinal = cfg.get_double("tfinal")
    while state.solution.time < tfinal:
        state, perf = time_execution(lambda st: tasks(next_state(st), cfg),
                                     state)
        s = state.solution
        driver.print_run_loop_message(s.iteration, s.time, nzones,
                                      perf.execution_time_ms)
    return tasks(next_state(state), cfg)


def run(cfg, state: State, tasks=run_tasks) -> State:
    """The run after its initial tasks, through the loop fast_step picks,
    with `tasks(state, cfg)` for the checkpoints and diagnostics; returns
    the final state. Raises driver.NonFiniteState if a write or the end
    finds the state not finite."""
    state = tasks(state, cfg)
    if resolve_auto(cfg, "fast_step", state.solution.conserved.device):
        final = _run_fast(cfg, state, tasks)
    else:
        final = _run_per_step(cfg, state, tasks)
    check_finite(final.solution)
    return final


@register("cloud")
def main(argv, *, device=None, dtype=None) -> int:
    cfg, state = setup(argv, device=device, dtype=dtype)
    prepare_filesystem(cfg)
    run(cfg, state)
    return 0
