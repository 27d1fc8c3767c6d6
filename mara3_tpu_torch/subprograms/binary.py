"""Circumbinary disk accretion — the flagship workload.

Port of mara3_tpu/subprograms/binary.py (a re-design of
src/subprog_binary.{hpp,cpp} + _scheme/_solver_data/_io/_diagnostics.cpp):
2D locally-isothermal thin disk (iso2d) on a static quadtree AMR mesh
focused on the binary, with live orbital evolution driven by accreted
mass/momentum and gravitational torque, sink particles, softened gravity,
wave-damping buffer, alpha/nu viscosity, density floor, PLM+HLLE/HLLC,
RK1/RK2, and safe-mode retry on negative density
(subprog_binary.cpp:285-292).

Two driver loops, as in the JAX package:
  - fast_step=0, the reference-shaped loop: the hydrodynamic advance runs
    on [B, bs, bs, 3] tensors on the run's device (schemes/binary_scheme.py;
    kernel B2 on a GPU); the host keeps the scalar orbital-element
    bookkeeping (models/two_body.py) and checks the fault flag once per
    advance, as the reference does;
  - fast_step=1, the device-resident loop (_main_fast): whole steps on the
    device (schemes/binary_step.py), run in chunks that the host reads
    once; with multi_launch=k > 0, up to k steps per launch of kernel B3
    (a chunk's remainder is one shorter launch).
On a CUDA device fast_step=-1 and multi_launch=-1 resolve to 1 and 16, the
JAX package's choice on a TPU; on the CPU both resolve to 0. With regrid=1
both loops rebuild the leaf set every `rgi` orbits from the density
gradient (apply_regrid, mesh/regrid.py; beyond the reference, whose trees
are static) and rebuild everything that hangs off the tree: the solver
data (geometry, guard tables, B2's tables) and, in the fast loop, the scan
with B3's tables. run() hands the final solver data back on the state it
returns (State.solver_data). A checkpoint of a regridded run does not
restart: its blocks are not the leaves the config builds, and
read_solution raises, as the JAX package's does.

The run's device is the CUDA card unless the caller asks for the CPU
(device="cpu" in code, MARA3_TPU_TORCH_DEVICE=cpu on the command line); with
no card and no such request, create_solver_data raises. h5py is imported
only by the functions that read or write files.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field, replace
from typing import Mapping, Tuple

import numpy as np
import torch

from mara3_tpu_torch.app import driver, serialize, tracing
from mara3_tpu_torch.app.config import ConfigTemplate
from mara3_tpu_torch.app.device import DEVICE_SELECTOR, resolve_device  # noqa: F401
from mara3_tpu_torch.app.schedule import Schedule, mark_tasks
from mara3_tpu_torch.app.subprogram import register
from mara3_tpu_torch.mesh import block_layout, tree
from mara3_tpu_torch.models import two_body
from mara3_tpu_torch.physics import iso2d
from mara3_tpu_torch.schemes import binary_scheme
from mara3_tpu_torch.schemes.binary_scheme import SchemeConfig


def create_config_template():
    """(subprog_binary.cpp:50-99). The keys are the JAX package's, so
    checkpoints and command lines carry over between the two."""
    return (ConfigTemplate()
            .item("restart", "")
            .item("outdir", "data")
            .item("cpi", 10.0)
            .item("dfi", 1.0)
            .item("tsi", 2e-3)
            .item("tfinal", 1.0)
            .item("cfl_number", 0.4)
            .item("fixed_dt", 0)
            .item("depth", 4)
            .item("begin_live_binary", 1e6)
            .item("conserve_linear_p", 1)
            .item("block_size", 24)
            .item("focus_factor", 2.00)
            .item("focus_index", 2.00)
            .item("threaded", 1)
            .item("rk_order", 2)
            # K complete steps per launch of kernel B3 in the fast loop:
            # 0 = off, k > 0 = the launch chunk, -1 = auto (16 on a CUDA
            # device, off on the CPU)
            .item("multi_launch", -1)
            .item("reconstruct_method", "plm")
            # the reference pins hlle (subprog_binary_solver_data.cpp:109);
            # hllc (physics_iso2d.hpp:704-712) is selectable here
            .item("riemann", "hlle")
            .item("plm_theta", 1.8)
            .item("source_term_softening", 1.0)
            .item("softening_radius", 0.05)
            .item("sink_radius", 0.05)
            .item("sink_rate", 1.0)
            .item("buffer_damping_rate", 10.0)
            .item("domain_radius", 12.0)
            .item("disk_radius", 2.0)
            .item("disk_mass", 1e-3)
            .item("ambient_density", 1e-4)
            .item("density_floor", 0.0)
            .item("separation", 1.0)
            .item("mass_ratio", 1.0)
            .item("eccentricity", 0.0)
            .item("counter_rotate", 0)
            .item("mach_number", 10.0)
            .item("axisymmetric_cs2", 0)
            .item("no_accretion_force", 0)
            .item("alpha_cutoff_radius", 0.0)
            .item("alpha", 0.1)
            .item("nu", 0.0)
            .item("mdot", 0.0)
            # adaptive regridding every `rgi` orbits (apply_regrid)
            .item("regrid", 0)
            .item("rgi", 0.5)
            # the device-resident step: 1 on, 0 off (the reference-shaped
            # loop), -1 auto (on for a CUDA device)
            .item("fast_step", -1))


def resolve_multi_launch(cfg_value: int, device) -> int:
    """multi_launch -> the launch chunk k: -1 = auto (16 on a CUDA device,
    the per-step scan elsewhere), 0 = off, k > 0 explicit."""
    if cfg_value < 0:
        return 16 if torch.device(device).type == "cuda" else 0
    return cfg_value


def resolve_options(cfg, device):
    """The config with fast_step and multi_launch resolved for `device`
    (-1: 1 and 16 on a CUDA device, 0 and 0 on the CPU)."""
    fast = cfg.get_int("fast_step")
    if fast < 0:
        fast = int(torch.device(device).type == "cuda")
    return (cfg.set("fast_step", int(fast > 0))
            .set("multi_launch", resolve_multi_launch(
                cfg.get_int("multi_launch"), device)))


# -----------------------------------------------------------------------------
# disk profile (subprog_binary.cpp:104-152; sigma normalization from the
# equilibrium Mathematica notebook, cited at :115)
# -----------------------------------------------------------------------------

def disk_profile(cfg, xy):
    """Primitive state [.., 3] at positions xy [.., 2] (a tensor)."""
    rs = cfg.get_double("softening_radius")
    rc = cfg.get_double("disk_radius")
    Ma = cfg.get_double("mach_number")
    disk_mass = cfg.get_double("disk_mass")
    ambient = cfg.get_double("ambient_density")
    mdot = cfg.get_double("mdot")
    counter = -1.0 if cfg.get_int("counter_rotate") else 1.0

    s0 = disk_mass / (17.0618 * rc * rc)
    s1 = ambient * s0

    x, y = xy[..., 0], xy[..., 1]
    r = torch.sqrt(x * x + y * y)
    xs = r / rc
    sigma = s0 * torch.exp(-0.5 * (xs - 1) ** 2) + s1
    dp_dr = (1.0 / Ma / Ma / (r + rs)) * (
        xs * (1 - xs) * (1 - s1 / sigma) - 1.0)
    vp = torch.sqrt(torch.clamp(1.0 / (r + rs) + dp_dr, min=0.0)) * counter
    vr = -mdot / (sigma * 2 * math.pi * r) * (r > 2.0).to(r.dtype)
    vx = vr * (x / r) + vp * (-y / r)
    vy = vr * (y / r) + vp * (x / r)
    return torch.stack([sigma, vx, vy], dim=-1)


# -----------------------------------------------------------------------------
# solver data (subprog_binary_solver_data.cpp:18-117)
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class SolverData:
    cfg_scheme: SchemeConfig
    leaves: tuple
    nt: object
    geometry: tuple            # host float64 (xc, dA, spacing, xf, yf)
    vertices: np.ndarray       # [B, bs+1, bs+1, 2]
    initial_conserved: torch.Tensor
    buffer_rate: torch.Tensor
    recommended_time_step: float
    cfl_number: float
    plm_theta: float
    rk_order: int
    fixed_dt: bool
    begin_live_binary: float
    no_accretion_force: bool
    conserve_linear_p: bool
    device: torch.device
    dtype: torch.dtype
    advance: object = field(repr=False, default=None)
    maximum_timestep: object = field(repr=False, default=None)

    @property
    def device_geometry(self):
        """(xc, dA) on the run's device in its dtype, which the time series
        and the diagnostics read: the advance's own tables, converted from
        `geometry` once, when create_solver_data built them."""
        return self.advance.tables.xc, self.advance.tables.dA


def create_leaves(cfg):
    """The leaf set: `depth` rounds of refinement inside the focus radius
    (reference refinement_radius, subprog_binary.cpp:166-184), 2:1
    balanced, in Hilbert order."""
    focus_factor = cfg.get_double("focus_factor")
    focus_index = cfg.get_double("focus_index")
    depth = cfg.get_int("depth")

    def predicate(level, radius):
        # at level 0 the pow is 1/0^n -> inf, so the root always refines
        threshold = (focus_factor / level ** focus_index if level > 0
                     else float("inf"))
        return radius < threshold

    return tuple(tree.create_quadtree(predicate, depth))


def create_solver_data(cfg, leaves=None, *, device=None,
                       dtype=torch.float32) -> SolverData:
    """Everything static about a run, with its tensors on `device` (by
    default the CUDA card, see resolve_device) in `dtype`."""
    device = resolve_device(device)
    bs = cfg.get_int("block_size")
    rd = cfg.get_double("domain_radius")
    if leaves is None:
        leaves = create_leaves(cfg)
    leaves = tuple(leaves)
    nt = block_layout.build_neighbor_table(leaves)

    verts = block_layout.block_vertices(leaves, bs) * rd
    xc = block_layout.block_cell_centers(leaves, bs) * rd
    spacing = block_layout.block_dx(leaves, bs) * rd
    dA = np.broadcast_to((spacing ** 2)[:, None, None],
                         xc.shape[:-1]).copy()
    xf = 0.5 * (verts[:, :, :-1] + verts[:, :, 1:])   # x-face centers
    yf = 0.5 * (verts[:, :-1, :] + verts[:, 1:, :])   # y-face centers

    conserve_linear_p = bool(cfg.get_int("conserve_linear_p"))
    xc_t = torch.as_tensor(xc, dtype=dtype, device=device)
    P0 = disk_profile(cfg, xc_t)
    if conserve_linear_p:
        initial = iso2d.to_conserved_per_area(P0)
    else:
        initial = iso2d.to_conserved_angmom_per_area(P0, xc_t)

    # buffer damping field (subprog_binary_solver_data.cpp:61-76)
    r_cell = np.sqrt(xc[..., 0] ** 2 + xc[..., 1] ** 2)
    buffer_rate = cfg.get_double("buffer_damping_rate") * (
        1.0 + np.tanh(3.0 * (r_cell - rd)))

    max_velocity = max(1.0, float(torch.max(torch.sqrt(
        P0[..., 1] ** 2 + P0[..., 2] ** 2))))
    min_dx = float(spacing.min())
    recommended_dt = min_dx / max_velocity * cfg.get_double("cfl_number")

    scheme = SchemeConfig(
        block_size=bs,
        domain_radius=rd,
        mach_number=cfg.get_double("mach_number"),
        softening_radius=cfg.get_double("softening_radius"),
        sink_radius=cfg.get_double("sink_radius"),
        sink_rate=cfg.get_double("sink_rate"),
        gst_suppr_radius=cfg.get_double("source_term_softening") * min_dx,
        density_floor=cfg.get_double("density_floor")
                      * cfg.get_double("disk_mass"),
        alpha=cfg.get_double("alpha"),
        alpha_cutoff_radius=cfg.get_double("alpha_cutoff_radius"),
        nu=cfg.get_double("nu"),
        axisymmetric_cs2=bool(cfg.get_int("axisymmetric_cs2")),
        conserve_linear_p=conserve_linear_p,
        reconstruct_method=cfg.get_string("reconstruct_method"),
        buffer_damping_rate=cfg.get_double("buffer_damping_rate"),
        riemann=cfg.get_string("riemann"))
    if scheme.reconstruct_method not in ("plm", "pcm"):
        raise ValueError(f"invalid reconstruct_method "
                         f"'{scheme.reconstruct_method}', must be plm or pcm")
    if scheme.riemann not in ("hlle", "hllc"):
        raise ValueError(f"invalid riemann '{scheme.riemann}', "
                         f"must be hlle or hllc")
    if cfg.get_int("threaded") <= 0:
        raise ValueError("runtime option 'threaded' must be > 0")

    geometry = (xc, dA, spacing, xf, yf)
    # the advance's tables take the geometry to the device, once per
    # SolverData; the output path reads them (SolverData.device_geometry)
    tracing.recorder().count("geometry_uploads")
    return SolverData(
        cfg_scheme=scheme, leaves=leaves, nt=nt, geometry=geometry,
        vertices=verts,
        initial_conserved=initial,
        buffer_rate=torch.as_tensor(buffer_rate, dtype=dtype, device=device),
        recommended_time_step=recommended_dt,
        cfl_number=cfg.get_double("cfl_number"),
        plm_theta=cfg.get_double("plm_theta"),
        rk_order=cfg.get_int("rk_order"),
        fixed_dt=bool(cfg.get_int("fixed_dt")),
        # the reference's config comment says orbits but its code compares
        # the raw value against code time — match the code, not the comment
        begin_live_binary=cfg.get_double("begin_live_binary"),
        no_accretion_force=bool(cfg.get_int("no_accretion_force")),
        conserve_linear_p=conserve_linear_p,
        device=device, dtype=dtype,
        advance=binary_scheme.make_advance(
            scheme, nt, geometry, initial, buffer_rate, device=device,
            dtype=dtype),
        maximum_timestep=binary_scheme.make_maximum_timestep(
            scheme, geometry, device=device, dtype=dtype))


# -----------------------------------------------------------------------------
# solution state (subprog_binary.hpp:95-126)
# -----------------------------------------------------------------------------

ZERO2 = (0.0, 0.0)


@dataclass(frozen=True)
class Solution:
    time: float
    iteration: int
    conserved: torch.Tensor           # [B, bs, bs, 3] (u or q formulation)
    mass_accreted_on: Tuple[float, float] = ZERO2
    angular_momentum_accreted_on: Tuple[float, float] = ZERO2
    integrated_torque_on: Tuple[float, float] = ZERO2
    work_done_on: Tuple[float, float] = ZERO2
    mass_ejected: float = 0.0
    angular_momentum_ejected: float = 0.0
    orbital_elements_acc: two_body.FullOrbitalElements = \
        two_body.make_full_orbital_elements_with_zeros()
    orbital_elements_grav: two_body.FullOrbitalElements = \
        two_body.make_full_orbital_elements_with_zeros()
    orbital_elements: two_body.FullOrbitalElements = \
        two_body.FullOrbitalElements()

    def scaled_plus(self, other: "Solution", wa: float, wb: float):
        """wa*self + wb*other for the RK averaging (the reference's
        solution_t operator+/operator*, subprog_binary_scheme.cpp:1022+)."""
        add2 = lambda a, b: (wa * a[0] + wb * b[0], wa * a[1] + wb * b[1])
        return Solution(
            time=wa * self.time + wb * other.time,
            iteration=int(wa * self.iteration + wb * other.iteration),
            conserved=wa * self.conserved + wb * other.conserved,
            mass_accreted_on=add2(self.mass_accreted_on,
                                  other.mass_accreted_on),
            angular_momentum_accreted_on=add2(
                self.angular_momentum_accreted_on,
                other.angular_momentum_accreted_on),
            integrated_torque_on=add2(self.integrated_torque_on,
                                      other.integrated_torque_on),
            work_done_on=add2(self.work_done_on, other.work_done_on),
            mass_ejected=wa * self.mass_ejected + wb * other.mass_ejected,
            angular_momentum_ejected=wa * self.angular_momentum_ejected
                                     + wb * other.angular_momentum_ejected,
            orbital_elements_acc=self.orbital_elements_acc * wa
                                 + other.orbital_elements_acc * wb,
            orbital_elements_grav=self.orbital_elements_grav * wa
                                  + other.orbital_elements_grav * wb,
            orbital_elements=self.orbital_elements * wa
                             + other.orbital_elements * wb)


def create_binary_params(cfg) -> two_body.OrbitalElements:
    return two_body.OrbitalElements(
        separation=cfg.get_double("separation"),
        total_mass=1.0,
        mass_ratio=cfg.get_double("mass_ratio"),
        eccentricity=cfg.get_double("eccentricity"))


def create_solution(cfg, solver_data: SolverData) -> Solution:
    return Solution(
        time=0.0, iteration=0,
        conserved=solver_data.initial_conserved.clone(),
        orbital_elements=two_body.make_full_orbital_elements(
            create_binary_params(cfg)))


def bodies_array(state: two_body.TwoBodyState) -> np.ndarray:
    """[2, 5] host float64 rows (mass, x, y, vx, vy)."""
    return np.array([
        [state.body1.mass, state.body1.position_x, state.body1.position_y,
         state.body1.velocity_x, state.body1.velocity_y],
        [state.body2.mass, state.body2.position_x, state.body2.position_y,
         state.body2.velocity_x, state.body2.velocity_y]], np.float64)


class NegativeDensityError(RuntimeError):
    pass


def _totals_to_host(totals, invalid):
    """One device-to-host copy for the fault flag and every total."""
    keys = binary_scheme.PAIR_TOTALS
    packed = torch.cat([totals[k].reshape(-1) for k in keys]
                       + [totals["mass_ejected"].reshape(1),
                          totals["angular_momentum_ejected"].reshape(1),
                          invalid.reshape(1).to(totals["mass_ejected"].dtype)])
    h = packed.cpu().numpy()
    t = {k: h[2 * n:2 * n + 2] for n, k in enumerate(keys)}
    t["mass_ejected"] = h[16]
    t["angular_momentum_ejected"] = h[17]
    return t, bool(h[18])


def advance(solution: Solution, sd: SolverData, dt: float,
            safe_mode: bool = False) -> Solution:
    """One hydro step + orbital-element bookkeeping
    (binary::advance_u/advance_q, subprog_binary_scheme.cpp:790-1020)."""
    bstate = two_body.compute_two_body_state(solution.orbital_elements,
                                             solution.time)
    bodies = bodies_array(bstate)
    theta = 0.0 if safe_mode else sd.plm_theta

    u1, totals, invalid = sd.advance(solution.conserved, bodies, dt, theta)
    t, bad = _totals_to_host(totals, invalid)
    if bad:
        # report the worst cell like the reference's validate_u printout
        # (subprog_binary_scheme.cpp:726-744)
        sig = u1[..., 0].cpu().numpy()
        # a NaN density counts as the worst (np.nanargmin raises when the
        # whole state is NaN)
        b, i, j = np.unravel_index(
            np.argmin(np.where(np.isnan(sig), -np.inf, sig)), sig.shape)
        x, y = sd.geometry[0][b, i, j]
        print(f"negative density {sig[b, i, j]:3.2e} "
              f"(at position [{x:+3.2f} {y:+3.2f}])")
        raise NegativeDensityError("negative density in updated state")

    b1, b2 = bstate.body1, bstate.body2
    dM1, dM2 = float(t["mass_accreted_on"][0]), float(t["mass_accreted_on"][1])
    dpx1 = float(t["momentum_x_accreted_on"][0])
    dpy1 = float(t["momentum_y_accreted_on"][0])
    dpx2 = float(t["momentum_x_accreted_on"][1])
    dpy2 = float(t["momentum_y_accreted_on"][1])

    def accreted(b, dM, dpx, dpy):
        if sd.no_accretion_force:
            vx, vy = b.velocity_x, b.velocity_y
        else:
            vx = (b.mass * b.velocity_x + dpx) / (b.mass + dM)
            vy = (b.mass * b.velocity_y + dpy) / (b.mass + dM)
        return two_body.PointMass(b.mass + dM, b.position_x, b.position_y,
                                  vx, vy)

    def forced(b, dfx, dfy):
        return two_body.PointMass(
            b.mass, b.position_x, b.position_y,
            b.velocity_x + dfx / b.mass, b.velocity_y + dfy / b.mass)

    E0 = solution.orbital_elements
    E_acc = two_body.compute_orbital_elements(
        two_body.TwoBodyState(accreted(b1, dM1, dpx1, dpy1),
                              accreted(b2, dM2, dpx2, dpy2)), solution.time)
    E_grv = two_body.compute_orbital_elements(
        two_body.TwoBodyState(
            forced(b1, float(t["integrated_force_x_on"][0]),
                   float(t["integrated_force_y_on"][0])),
            forced(b2, float(t["integrated_force_x_on"][1]),
                   float(t["integrated_force_y_on"][1]))), solution.time)

    live = 1.0 if solution.time > sd.begin_live_binary else 0.0
    d_acc = two_body.diff(E0, E_acc)
    d_grv = two_body.diff(E0, E_grv)
    d_cm = two_body.diff_cm(E0, dt)

    add2 = lambda a, v: (a[0] + float(v[0]), a[1] + float(v[1]))
    return Solution(
        time=solution.time + dt,
        iteration=solution.iteration + 1,
        conserved=u1,
        mass_accreted_on=add2(solution.mass_accreted_on,
                              t["mass_accreted_on"]),
        angular_momentum_accreted_on=add2(
            solution.angular_momentum_accreted_on,
            t["angular_momentum_accreted_on"]),
        integrated_torque_on=add2(solution.integrated_torque_on,
                                  t["integrated_torque_on"]),
        work_done_on=add2(solution.work_done_on, t["work_done_on"]),
        mass_ejected=solution.mass_ejected + float(t["mass_ejected"]),
        angular_momentum_ejected=solution.angular_momentum_ejected
                                 + float(t["angular_momentum_ejected"]),
        orbital_elements_acc=solution.orbital_elements_acc + d_acc,
        orbital_elements_grav=solution.orbital_elements_grav + d_grv,
        orbital_elements=solution.orbital_elements
                         + (d_acc + d_grv + d_cm) * live)


def next_solution(solution: Solution, sd: SolverData) -> Solution:
    """RK1/RK2 with safe-mode retry (subprog_binary.cpp:258-292)."""
    if sd.fixed_dt:
        dt = sd.recommended_time_step
    else:
        bodies = bodies_array(two_body.compute_two_body_state(
            solution.orbital_elements, solution.time))
        dt = sd.cfl_number * float(sd.maximum_timestep(solution.conserved,
                                                       bodies))

    def can_fail(dt, safe_mode):
        if sd.rk_order == 1:
            return advance(solution, sd, dt, safe_mode)
        s1 = advance(solution, sd, dt, safe_mode)
        s2 = advance(s1, sd, dt, safe_mode)
        return solution.scaled_plus(s2, 0.5, 0.5)

    try:
        return can_fail(dt, False)
    except NegativeDensityError as e:
        print(e)
        return can_fail(dt * 0.1, True)


# -----------------------------------------------------------------------------
# state carried across packages: the JAX package's Solution fields as numpy
# arrays and floats
# -----------------------------------------------------------------------------

_PAIR_FIELDS = ("mass_accreted_on", "angular_momentum_accreted_on",
                "integrated_torque_on", "work_done_on")
_ELEMENT_FIELDS = ("orbital_elements_acc", "orbital_elements_grav",
                   "orbital_elements")


def solution_to_arrays(s: Solution) -> dict:
    """Plain host values of a Solution: conserved as a numpy array, pairs
    as tuples of floats, orbital elements as FULL_ORBITAL_DTYPE records
    (the checkpoint's layout)."""
    out = {"time": float(s.time), "iteration": int(s.iteration),
           "conserved": s.conserved.detach().cpu().numpy(),
           "mass_ejected": float(s.mass_ejected),
           "angular_momentum_ejected": float(s.angular_momentum_ejected)}
    for key in _PAIR_FIELDS:
        out[key] = tuple(float(v) for v in getattr(s, key))
    for key in _ELEMENT_FIELDS:
        out[key] = np.array(_full_elements_to_np(getattr(s, key)),
                            dtype=FULL_ORBITAL_DTYPE)
    return out


def fast_state_to_arrays(s: Mapping) -> dict:
    """The fast step's state (schemes/binary_step.py) as numpy, in the
    layout of the JAX package's binary_step.solution_to_arrays: conserved
    component-first [B, 3, bs, bs]."""
    out = {k: v.detach().cpu().numpy() for k, v in s.items()
           if torch.is_tensor(v)}
    out["conserved"] = np.transpose(out["conserved"], (0, 3, 1, 2))
    out["iteration"] = int(s["iteration"])
    return out


def fast_state_from_arrays(arrays: Mapping, sd: SolverData) -> dict:
    """The fast step's state from the JAX package's
    binary_step.solution_to_arrays dict as numpy (the inverse of
    fast_state_to_arrays), on the run's device in its dtype."""
    out = {k: torch.as_tensor(np.array(v), dtype=sd.dtype,
                              device=sd.device)
           for k, v in arrays.items() if k not in ("iteration", "conserved")}
    out["conserved"] = torch.as_tensor(
        np.ascontiguousarray(np.transpose(arrays["conserved"], (0, 2, 3, 1))),
        dtype=sd.dtype, device=sd.device)
    out["iteration"] = int(arrays["iteration"])
    return out


def solution_from_arrays(arrays: Mapping, sd: SolverData) -> Solution:
    """The port's Solution from plain values (the inverse of
    solution_to_arrays). Orbital elements may be FULL_ORBITAL_DTYPE records
    or the tuples (pomega, tau, cm_x, cm_y, cm_vx, cm_vy,
    (a, M, q, e))."""
    elements = {key: _full_elements_from_np(
        np.array(arrays[key], dtype=FULL_ORBITAL_DTYPE))
        for key in _ELEMENT_FIELDS}
    return Solution(
        time=float(arrays["time"]),
        iteration=int(arrays["iteration"]),
        conserved=torch.tensor(np.asarray(arrays["conserved"]),
                               dtype=sd.dtype, device=sd.device),
        mass_ejected=float(arrays["mass_ejected"]),
        angular_momentum_ejected=float(arrays["angular_momentum_ejected"]),
        **{key: tuple(float(v) for v in arrays[key])
           for key in _PAIR_FIELDS},
        **elements)


# -----------------------------------------------------------------------------
# I/O (subprog_binary_io.cpp)
# -----------------------------------------------------------------------------

ORBITAL_DTYPE = np.dtype([
    ("separation", "f8"), ("total_mass", "f8"), ("mass_ratio", "f8"),
    ("eccentricity", "f8")])
FULL_ORBITAL_DTYPE = np.dtype([
    ("pomega", "f8"), ("tau", "f8"), ("cm_position_x", "f8"),
    ("cm_position_y", "f8"), ("cm_velocity_x", "f8"),
    ("cm_velocity_y", "f8"), ("elements", ORBITAL_DTYPE)])
TIME_SERIES_DTYPE = np.dtype([
    ("time", "f8"), ("disk_mass", "f8"), ("disk_angular_momentum", "f8"),
    ("mass_accreted_on", "f8", (2,)),
    ("angular_momentum_accreted_on", "f8", (2,)),
    ("integrated_torque_on", "f8", (2,)),
    ("work_done_on", "f8", (2,)),
    ("mass_ejected", "f8"), ("angular_momentum_ejected", "f8"),
    ("orbital_elements_acc", FULL_ORBITAL_DTYPE),
    ("orbital_elements_grav", FULL_ORBITAL_DTYPE),
    ("orbital_elements", FULL_ORBITAL_DTYPE),
    ("position_of_mass1", "f8", (2,)), ("position_of_mass2", "f8", (2,))])


def _full_elements_to_np(e: two_body.FullOrbitalElements):
    return (e.pomega, e.tau, e.cm_position_x, e.cm_position_y,
            e.cm_velocity_x, e.cm_velocity_y,
            (e.elements.separation, e.elements.total_mass,
             e.elements.mass_ratio, e.elements.eccentricity))


def _full_elements_from_np(row) -> two_body.FullOrbitalElements:
    el = row["elements"]
    return two_body.FullOrbitalElements(
        pomega=float(row["pomega"]), tau=float(row["tau"]),
        cm_position_x=float(row["cm_position_x"]),
        cm_position_y=float(row["cm_position_y"]),
        cm_velocity_x=float(row["cm_velocity_x"]),
        cm_velocity_y=float(row["cm_velocity_y"]),
        elements=two_body.OrbitalElements(
            float(el["separation"]), float(el["total_mass"]),
            float(el["mass_ratio"]), float(el["eccentricity"])))


def write_solution(group, s: Solution, sd: SolverData):
    group["time"] = np.float64(s.time)
    group["iteration"] = np.int64(s.iteration)
    idxs = [(l, (i, j)) for (l, i, j) in sd.leaves]
    name = "conserved_u" if sd.conserve_linear_p else "conserved_q"
    serialize.write_tree(group.require_group(name), idxs,
                         list(s.conserved.cpu().numpy()))
    group.require_group("conserved_q" if sd.conserve_linear_p
                        else "conserved_u")
    for key in _PAIR_FIELDS:
        group[key] = np.asarray(getattr(s, key))
    group["mass_ejected"] = np.float64(s.mass_ejected)
    group["angular_momentum_ejected"] = np.float64(s.angular_momentum_ejected)
    for key in _ELEMENT_FIELDS:
        group[key] = np.array(_full_elements_to_np(getattr(s, key)),
                              dtype=FULL_ORBITAL_DTYPE)


def read_solution(group, sd: SolverData) -> Solution:
    """The solution of a checkpoint on sd's leaves. Raises ValueError when
    the checkpoint holds other blocks: a regridded run's checkpoint does not
    restart (the JAX package's read_solution fails there too)."""
    name = "conserved_u" if sd.conserve_linear_p else "conserved_q"
    idxs, blocks = serialize.read_tree(group[name])
    order = {(l, c[0], c[1]): b for b, (l, c) in enumerate(idxs)}
    if set(order) != set(sd.leaves):
        raise ValueError(
            f"the checkpoint holds {len(order)} blocks that are not the "
            f"{len(sd.leaves)} leaves this config builds (a regridded run?): "
            f"restart across a regrid is not supported")
    stacked = np.stack([blocks[order[leaf]] for leaf in sd.leaves])
    arrays = {key: group[key][()] for key in
              ("time", "iteration", "mass_ejected",
               "angular_momentum_ejected", *_PAIR_FIELDS, *_ELEMENT_FIELDS)}
    return solution_from_arrays({**arrays, "conserved": stacked}, sd)


# -----------------------------------------------------------------------------
# time series & diagnostics (subprog_binary.cpp:358-379,
# subprog_binary_diagnostics.cpp)
# -----------------------------------------------------------------------------

def _disk_mass(u, sd: SolverData):
    return torch.sum(u[..., 0] * sd.device_geometry[1])


def _disk_angular_momentum(u, sd: SolverData):
    xc, dA = sd.device_geometry
    if sd.conserve_linear_p:
        lz = iso2d.angular_momentum(u, xc)
    else:
        lz = u[..., 2]
    return torch.sum(lz * dA)


def disk_mass(solution: Solution, sd: SolverData) -> float:
    return float(_disk_mass(solution.conserved, sd))


def disk_angular_momentum(solution: Solution, sd: SolverData) -> float:
    return float(_disk_angular_momentum(solution.conserved, sd))


def time_series_sample(solution, sd: SolverData):
    """One TIME_SERIES_DTYPE row of a Solution, or of the fast step's state
    (schemes/binary_step.py, a dict of device tensors). The disk's two sums
    are formed on the device and read in one copy: with the fast state's
    scalars, or with each other."""
    if isinstance(solution, Mapping):
        from mara3_tpu_torch.schemes import binary_step
        u = solution["conserved"]
        h = binary_step.host_values(solution, extra=(
            _disk_mass(u, sd), _disk_angular_momentum(u, sd)))
        mass, angmom = h["extra"]
        solution = binary_step.arrays_to_solution(solution, Solution, h)
    else:
        u = solution.conserved
        mass, angmom = torch.stack([_disk_mass(u, sd),
                                    _disk_angular_momentum(u, sd)]).tolist()
    bstate = two_body.compute_two_body_state(solution.orbital_elements,
                                             solution.time)
    return np.array((
        solution.time, mass, angmom,
        solution.mass_accreted_on, solution.angular_momentum_accreted_on,
        solution.integrated_torque_on, solution.work_done_on,
        solution.mass_ejected, solution.angular_momentum_ejected,
        _full_elements_to_np(solution.orbital_elements_acc),
        _full_elements_to_np(solution.orbital_elements_grav),
        _full_elements_to_np(solution.orbital_elements),
        (bstate.body1.position_x, bstate.body1.position_y),
        (bstate.body2.position_x, bstate.body2.position_y)),
        dtype=TIME_SERIES_DTYPE)


def diagnostic_fields(solution: Solution, sd: SolverData):
    xc, _ = sd.device_geometry
    if sd.conserve_linear_p:
        p0 = iso2d.recover_primitive(solution.conserved)
    else:
        p0 = iso2d.recover_primitive_angmom(solution.conserved, xc)
    r = torch.sqrt(xc[..., 0] ** 2 + xc[..., 1] ** 2)
    vx, vy = p0[..., 1], p0[..., 2]
    vr = (vx * xc[..., 0] + vy * xc[..., 1]) / r
    vp = (-vx * xc[..., 1] + vy * xc[..., 0]) / r
    bstate = two_body.compute_two_body_state(solution.orbital_elements,
                                             solution.time)
    return {
        "sigma": p0[..., 0].cpu().numpy(),
        "radial_velocity": vr.cpu().numpy(),
        "phi_velocity": vp.cpu().numpy(),
        "position_of_mass1": np.array([bstate.body1.position_x,
                                       bstate.body1.position_y]),
        "position_of_mass2": np.array([bstate.body2.position_x,
                                       bstate.body2.position_y]),
    }


# -----------------------------------------------------------------------------
# app state / tasks / driver (subprog_binary.cpp:295-449)
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class State:
    solution: Solution
    schedule: Schedule
    time_series: tuple
    run_config: object
    # the solver data the solution lives on: set on the state run()
    # returns, which a regrid may have moved to other leaves
    solver_data: object = field(repr=False, default=None)


def check_finite(s: Solution):
    """Raise driver.NonFiniteState unless the state is finite."""
    driver.check_finite("binary", [s.conserved], s.iteration, s.time)


def write_checkpoint(state: State, sd: SolverData) -> State:
    import h5py
    check_finite(state.solution)
    count = state.schedule.num_times_performed("write_checkpoint")
    state = replace(
        state, schedule=state.schedule.mark_as_completed("write_checkpoint"))
    path = driver.checkpoint_path(state.run_config, count)
    with h5py.File(path, "w") as f:
        write_solution(f.require_group("solution"), state.solution, sd)
        serialize.write_schedule(f.require_group("schedule"), state.schedule)
        serialize.write_config(f.require_group("run_config"),
                               state.run_config)
        if state.time_series:
            f["time_series"] = np.stack(state.time_series)
        else:
            f.create_dataset("time_series", shape=(0,),
                             dtype=TIME_SERIES_DTYPE)
    print(f"write checkpoint: {path}")
    return state


def write_diagnostics(state: State, sd: SolverData) -> State:
    import h5py
    check_finite(state.solution)
    count = state.schedule.num_times_performed("write_diagnostics")
    outdir = state.run_config.get_string("outdir")
    path = serialize.create_numbered_filename("diagnostics", count, "h5",
                                              outdir)
    fields = diagnostic_fields(state.solution, sd)
    idxs = [(l, (i, j)) for (l, i, j) in sd.leaves]
    with h5py.File(path, "w") as f:
        f["time"] = np.float64(state.solution.time)
        serialize.write_tree(f.require_group("vertices"), idxs,
                             list(sd.vertices))
        for name in ("sigma", "radial_velocity", "phi_velocity"):
            serialize.write_tree(f.require_group(name), idxs,
                                 list(fields[name]))
        f["position_of_mass1"] = fields["position_of_mass1"]
        f["position_of_mass2"] = fields["position_of_mass2"]
        serialize.write_config(f.require_group("run_config"),
                               state.run_config)
    print(f"write diagnostics: {path}")
    return replace(
        state, schedule=state.schedule.mark_as_completed("write_diagnostics"))


def record_time_series(state: State, sd: SolverData) -> State:
    sample = time_series_sample(state.solution, sd)
    return replace(
        state,
        time_series=state.time_series + (sample,),
        schedule=state.schedule.mark_as_completed("record_time_series"))


def run_tasks(state: State, sd: SolverData) -> State:
    if state.schedule.is_due("write_diagnostics"):
        state = write_diagnostics(state, sd)
    if state.schedule.is_due("record_time_series"):
        state = record_time_series(state, sd)
    if state.schedule.is_due("write_checkpoint"):
        state = write_checkpoint(state, sd)
    return state


def create_state(cfg, sd: SolverData) -> State:
    restart = cfg.get_string("restart")
    if not restart:
        return State(create_solution(cfg, sd),
                     driver.create_schedule(cfg, ["write_checkpoint",
                                                  "write_diagnostics",
                                                  "record_time_series"]),
                     (), cfg)
    import h5py
    with h5py.File(restart, "r") as f:
        solution = read_solution(f["solution"], sd)
        schedule = serialize.read_schedule(f["schedule"])
        ts = tuple(f["time_series"][()]) if "time_series" in f else ()
    return State(solution, schedule, ts, cfg)


def apply_regrid(solution: Solution, sd: SolverData, cfg):
    """One regrid (the JAX package's apply_regrid, beyond the reference,
    whose trees are static): flag the blocks on the density-gradient
    indicator, enforce 2:1 balance, remap the state by prolongation and
    restriction (mesh/regrid.py, on the host), and rebuild the solver data
    for the new leaves on the run's device. The cell-average remap keeps
    the totals of mass and momentum. Returns (solution, sd), the same
    objects when the leaf set is unchanged."""
    import time as _time

    from mara3_tpu_torch.mesh import regrid as rg
    t0 = _time.perf_counter()
    u = solution.conserved.detach().cpu().numpy()
    indicator = rg.gradient_indicator(u, np.asarray(sd.geometry[2]))
    new_leaves = rg.propose_leaves(sd.leaves, indicator,
                                   refine_threshold=0.3,
                                   coarsen_threshold=0.05,
                                   max_level=cfg.get_int("depth"))
    if tuple(new_leaves) == tuple(sd.leaves):
        return solution, sd
    remapped = rg.remap_blocks(sd.leaves, u, new_leaves)
    sd2 = create_solver_data(cfg, leaves=new_leaves, device=sd.device,
                             dtype=sd.dtype)
    conserved = torch.as_tensor(remapped, dtype=sd.dtype, device=sd.device)
    ms = (_time.perf_counter() - t0) * 1e3
    print(f"regrid: {len(sd.leaves)} -> {len(new_leaves)} blocks "
          f"({ms:.3f} ms on the host)")
    return replace(solution, conserved=conserved), sd2


def next_state(state: State, sd: SolverData) -> State:
    solution = next_solution(state.solution, sd)
    cfg = state.run_config
    schedule = mark_tasks(state.schedule, solution.time, [
        ("write_checkpoint", cfg.get_double("cpi") * 2 * math.pi),
        ("write_diagnostics", cfg.get_double("dfi") * 2 * math.pi),
        ("record_time_series", cfg.get_double("tsi") * 2 * math.pi)])
    return State(solution, schedule, state.time_series, cfg)


@tracing.phased("mara3.setup")
def setup(argv, *, device=None, dtype=torch.float32):
    """Config, solver data and initial state of a run, with the banner.
    Returns (cfg, sd, state)."""
    import os
    device = resolve_device(device)
    cfg = resolve_options(
        driver.create_run_config(create_config_template(), argv), device)
    sd = create_solver_data(cfg, device=device, dtype=dtype)
    state = create_state(cfg, sd)
    outdir = cfg.get_string("outdir")
    if outdir and outdir != ".":
        os.makedirs(outdir, exist_ok=True)
    cfg.pretty_print()
    bs = cfg.get_int("block_size")
    print(f"quadtree: {len(sd.leaves)} blocks of {bs}x{bs}, "
          f"depth {tree.tree_depth(sd.leaves)}")
    k = cfg.get_int("multi_launch")
    if sd.device.type == "cuda":
        name = torch.cuda.get_device_name(sd.device)
        where = (f"CUDA kernels B3 ({k} steps per launch) and B2 on {name}"
                 if cfg.get_int("fast_step") and k > 0
                 else f"CUDA kernel B2 on {name}")
    else:
        where = "plain torch on the CPU"
    loop = ("device-resident steps" if cfg.get_int("fast_step")
            else "reference-shaped loop")
    print(f"advance: {where}, {str(sd.dtype).replace('torch.', '')}, "
          f"{loop}")
    return cfg, sd, state


def run(cfg, sd: SolverData, state: State, tasks=run_tasks) -> State:
    """The driver loop until tfinal orbits, printing kzps, with
    `tasks(state, sd)` for the checkpoints, diagnostics and time series.
    fast_step=1 runs the device-resident loop (_main_fast); fast_step=0 the
    reference's loop (subprog_binary.cpp:394-449), with the tasks after
    every step. With regrid=1 both loops regrid every `rgi` orbits
    (apply_regrid). Returns the final state, with the solver data it lives
    on as `solver_data`; raises driver.NonFiniteState if a write or the end
    finds the state not finite."""
    state = tasks(state, sd)
    if cfg.get_int("fast_step"):
        final = _main_fast(cfg, sd, state, tasks)
        check_finite(final.solution)
        return final
    from mara3_tpu_torch.app.performance import time_execution
    bs = cfg.get_int("block_size")
    regrid_on = cfg.get_int("regrid") != 0
    rgi_t = cfg.get_double("rgi") * 2 * math.pi
    next_regrid = state.solution.time + rgi_t
    while state.solution.time / (2 * math.pi) < cfg.get_double("tfinal"):
        if regrid_on and state.solution.time >= next_regrid:
            sol2, sd = apply_regrid(state.solution, sd, cfg)
            state = replace(state, solution=sol2)
            next_regrid += rgi_t
        num_zones = len(sd.leaves) * bs * bs
        state, perf = time_execution(
            lambda s: tasks(next_state(s, sd), sd), state)
        rate = num_zones / max(perf.execution_time_ms, 1e-12)
        print(f"[{state.solution.iteration:04d}] "
              f"orbits={state.solution.time / (2 * math.pi):3.7f} "
              f"kzps={rate:3.2f}")
    final = tasks(next_state(state, sd), sd)
    check_finite(final.solution)
    return replace(final, solver_data=sd)


# the fast loop's longest chunk, in steps
MAX_CHUNK = 256


def steps_to(t_now: float, dts, t_stop: float) -> int:
    """The fewest steps from t_now after which the time may have reached
    t_stop, at least 1; MAX_CHUNK + 1 when that is beyond MAX_CHUNK. Step j
    ahead is bounded by dt_max + rise j, from `dts` (recent steps' dt,
    oldest first): their largest, and their largest step-to-step rise.
    With no step above its bound, t_stop is not reached before the step
    returned."""
    gap = t_stop - t_now
    if gap <= 0:
        return 1
    dts = np.asarray(dts)
    dt_max = float(dts.max())
    rise = max(float((dts[1:] - dts[:-1]).max()), 0.0)

    def short(n):                          # n bounded steps fall short
        return n * dt_max + rise * n * (n + 1) / 2 < gap

    # the root of the bounded steps' sum, then the least n not short
    b = dt_max + rise / 2
    root = (gap / dt_max if rise == 0 else
            (math.sqrt(b * b + 2 * rise * gap) - b) / rise)
    n = min(max(math.ceil(root), 1), MAX_CHUNK + 1)
    while n > 1 and not short(n - 1):
        n -= 1
    while n <= MAX_CHUNK and short(n):
        n += 1
    return n


def plan_chunk(t_now: float, dts, next_due: float, next_regrid,
               tfinal: float) -> int:
    """The steps of the fast loop's next chunk from t_now: one while fewer
    than two dt are known (`dts`, recent steps' dt, oldest first; None at
    the start), to learn dt and its rise; else the steps to the nearest of
    the next time-series due, the next regrid (None without regrid) and
    tfinal that they may reach (steps_to), at most MAX_CHUNK. A due then
    falls on the chunk's last step or after it, not before."""
    if dts is None or len(dts) < 2:
        return 1
    stop = min(next_due, tfinal,
               math.inf if next_regrid is None else next_regrid)
    return min(steps_to(t_now, dts, stop), MAX_CHUNK)


def build_scan(cfg, sd: SolverData):
    """The fast loop's scan: kernel B3 launches of up to multi_launch steps
    when multi_launch > 0 and the configuration is in B3's scope, else the
    per-step scan. A `mara3.tables` phase span (app/tracing.py)."""
    from mara3_tpu_torch.schemes import binary_step
    tracing.tally("table_builds")
    with tracing.phase("mara3.tables"):
        k = cfg.get_int("multi_launch")
        if k > 0:
            try:
                return binary_step.make_multi_scan(sd, k_chunk=k)
            except NotImplementedError as e:
                print(f"multi_launch: per-step scan for this configuration "
                      f"({e})")
        return binary_step.make_fast_scan(sd)


def _main_fast(cfg, sd: SolverData, state: State, tasks) -> State:
    """The driver loop over device-resident steps (the JAX package's
    _main_fast). Steps run in chunks whose packed info rows the host reads
    once; the schedule marking replays from the rows. plan_chunk ends a
    chunk on the step that the next time-series due is predicted to fall
    on, from the recent steps' dt; a due that falls inside a chunk all the
    same is sampled by replaying the chunk to it from its head. A chunk
    with a negative density is repaired: rewind, replay the good steps,
    retry the faulted one in safe mode. Checkpoints and diagnostics run at
    the first chunk boundary after they come due. With regrid=1 a chunk
    also stops at the next regrid, and a regrid that changes the tree
    rebuilds the scan (B3's tables) on the new solver data. Under a
    profiler the loop records the spans and counters of app/tracing.py."""
    import time as _time

    from mara3_tpu_torch.schemes import binary_step
    rec = tracing.recorder()
    IX = binary_step.INFO_INDEX
    scan_steps = build_scan(cfg, sd)
    s = binary_step.solution_to_arrays(state.solution)
    schedule, ts = state.schedule, state.time_series
    u = s["conserved"]
    num_zones = u.shape[0] * u.shape[1] * u.shape[2]
    tfinal_t = cfg.get_double("tfinal") * 2 * math.pi
    tsi_t = cfg.get_double("tsi") * 2 * math.pi
    intervals = [
        ("write_checkpoint", cfg.get_double("cpi") * 2 * math.pi),
        ("write_diagnostics", cfg.get_double("dfi") * 2 * math.pi),
        ("record_time_series", tsi_t)]
    retry_step = None                      # built when a fault needs it
    regrid_on = cfg.get_int("regrid") != 0
    rgi_t = cfg.get_double("rgi") * 2 * math.pi

    def replay(s_, n_):
        """n_ steps of the scan in one call: (state, host rows)."""
        rec.count("replay_steps", n_)
        if n_ == 0:
            return s_, np.zeros((0, binary_step.INFO_WIDTH))
        s_, r = scan_steps(s_, n_)
        return s_, r.cpu().numpy()

    def repair(s_prev, rows):
        """Rewind to the chunk head, replay the steps before the first
        faulted one, and run that one through the retrying step (the
        reference's catch + dt/10, theta=0 path, subprog_binary.cpp:
        285-292)."""
        nonlocal retry_step
        if retry_step is None:
            retry_step = binary_step.make_fast_step(sd)
        bad = int(np.argmax(rows[:, IX["invalid"]] > 0))
        s2, good = replay(s_prev, bad)
        s2, info = retry_step(s2)
        if bool(info["invalid"]):
            raise NegativeDensityError(
                "negative density persisted through safe-mode retry")
        rec.count("retries")
        print("negative density: step retried in safe mode (dt/10, "
              "theta=0)")
        retried = binary_step.pack_info_host(
            {k: (v.cpu().numpy() if torch.is_tensor(v) else v)
             for k, v in info.items()})
        return s2, np.concatenate([good, retried[None]], axis=0)

    t_now = float(state.solution.time)
    t_f64 = t_now                          # float64 time anchor
    t_start = t_now                        # the device's time at chunk
    #                                        start: the plan's origin
    iteration = int(state.solution.iteration)
    next_regrid = t_now + rgi_t
    dts = None                             # recent steps' dt, for the plan
    while t_now < tfinal_t:
        with rec.span("mara3.chunk", iteration=iteration):
            if regrid_on and t_now >= next_regrid:
                rec.count("regrids")
                with rec.span("mara3.regrid"):
                    sol2, sd2 = apply_regrid(
                        binary_step.arrays_to_solution(s, Solution), sd, cfg)
                    if sd2 is not sd:
                        rec.count("tree_changes")
                        sd = sd2
                        scan_steps = build_scan(cfg, sd)
                        retry_step = None
                        dts = None         # a new tree, a new dt: learn it
                        num_zones = (len(sd.leaves)
                                     * cfg.get_int("block_size") ** 2)
                        s = binary_step.solution_to_arrays(sol2)
                next_regrid += rgi_t
            with rec.span("mara3.plan"):
                next_ts = (schedule.last_performed("record_time_series")
                           + tsi_t)
                n = plan_chunk(t_start, dts, next_ts,
                               next_regrid if regrid_on else None, tfinal_t)
                to_due = (dts is not None and len(dts) > 1
                          and n == steps_to(t_start, dts, next_ts))
            if to_due:
                rec.count("planned_to_due")

            t0 = _time.perf_counter()
            s_prev = s
            with rec.span("mara3.launch"):
                s, rows = scan_steps(s, n)
            with rec.span("mara3.wait"):
                rows = rows.cpu().numpy()      # the chunk's one device read
            ms = (_time.perf_counter() - t0) * 1e3

            # the host's work on the read rows, in one span so that no
            # idle gap of the device falls between spans
            with rec.span("mara3.post"):
                if rows[:, IX["invalid"]].any():
                    with rec.span("mara3.repair"):
                        s, rows = repair(s_prev, rows)

                with rec.span("mara3.mark"):
                    # the time accumulates in the run's dtype on the device;
                    # a float32 run takes it back each chunk from a float64
                    # sum of the dt used (the reference carries time in
                    # double)
                    t_f64 += float(rows[:, IX["dt"]].astype(np.float64).sum())
                    # the plan's dt: this chunk's and the step before it
                    dts = (rows[:, IX["dt"]] if dts is None else
                           np.concatenate([dts[-1:], rows[:, IX["dt"]]]))
                    t_start = float(rows[-1, IX["time"]])
                    if s["time"].dtype == torch.float32:
                        t_start = float(np.float32(t_f64))
                        s = {**s, "time": torch.full(
                            (), t_start, dtype=torch.float32,
                            device=s["time"].device)}

                    due_steps = []
                    for i, row in enumerate(rows):
                        schedule = mark_tasks(
                            schedule, float(row[IX["time"]]), intervals)
                        if schedule.is_due("record_time_series"):
                            due_steps.append(i)
                            schedule = schedule.mark_as_completed(
                                "record_time_series")
                if to_due and due_steps[:1] == [len(rows) - 1]:
                    rec.count("planned_due_hits")
                # sample the whole state at each due step (the reference
                # records the current solution, subprog_binary.cpp:358-378):
                # the last step's state is s; earlier dues replay from the
                # chunk head
                s_cursor, done = s_prev, 0
                for i in due_steps:
                    rec.count("outputs.record_time_series")
                    with rec.span("mara3.output",
                                  task="record_time_series"):
                        if i == len(rows) - 1:
                            s_due = s
                        else:
                            with rec.span("mara3.replay"):
                                s_cursor, _ = replay(s_cursor, i + 1 - done)
                            done = i + 1
                            s_due = s_cursor
                        with rec.span("mara3.sample"):
                            ts = ts + (time_series_sample(s_due, sd),)

                due = [task for task in ("write_diagnostics",
                                         "write_checkpoint")
                       if schedule.is_due(task)]
                if due:
                    for task in due:
                        rec.count(f"outputs.{task}")
                    with rec.span("mara3.output", task="+".join(due)):
                        st = tasks(State(binary_step.arrays_to_solution(
                            s, Solution), schedule, ts, cfg), sd)
                    schedule, ts = st.schedule, st.time_series

                t_now = float(rows[-1, IX["time"]])
                iteration = int(rows[-1, IX["iteration"]])
                with rec.span("mara3.print"):
                    print(f"[{iteration:04d}] "
                          f"orbits={t_now / (2 * math.pi):3.7f} "
                          f"kzps={n * num_zones / max(ms, 1e-12):3.2f}")
            rec.count("steps", len(rows))
            rec.annotate(steps=len(rows))

    state = State(binary_step.arrays_to_solution(s, Solution), schedule, ts,
                  cfg)
    return replace(tasks(state, sd), solver_data=sd)


@register("binary")
def main(argv, *, device=None, dtype=torch.float32) -> int:
    cfg, sd, state = setup(argv, device=device, dtype=dtype)
    run(cfg, sd, state)
    return 0
