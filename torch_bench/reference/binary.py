"""The plain reference of the flagship circumbinary disk (`binary`).

A locally isothermal thin disk around a circular binary on the quadtree
(reference/mesh.py), in plain PyTorch: primitive recovery, one guard cell
exchanged across level jumps, limited linear slopes (generalised minmod),
HLLE fluxes plus the alpha-viscosity shear stress, the coarse-fine flux
correction, softened gravity of both bodies, Gaussian sinks, the buffer
damped toward the initial disk, RK2 with the CFL time step, and the
host's float64 bookkeeping of what the bodies accrete and how their orbit
would change (reference/two_body.py). One step at a time, one host read a
stage, the time series sampled at every step that reaches its due.

Written for this benchmark from the scheme's equations (Mara3's
subprog_binary_scheme.cpp); it imports nothing of the program under test
and builds its own tree, geometry and initial disk. The configuration's
linear-momentum formulation with HLLE and PLM is what it covers; anything
else raises.

Beside each total it accumulates the sum of the magnitudes of the terms
that formed it (`gross`): a float32 program's rounding of a total is
bounded by a few ulps of that sum, not of the total, which can cancel to
near zero (the torque of an axisymmetric disk).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field

import numpy as np
import torch

from torch_bench.reference import mesh, two_body

PAIRS = ("mass_accreted_on", "angular_momentum_accreted_on",
         "integrated_torque_on", "work_done_on")
EJECTED = ("mass_ejected", "angular_momentum_ejected")
ELEMENTS = ("pomega", "tau", "cm_position_x", "cm_position_y",
            "cm_velocity_x", "cm_velocity_y", "elements.separation",
            "elements.total_mass", "elements.mass_ratio",
            "elements.eccentricity")
ELEMENT_SETS = ("orbital_elements_acc", "orbital_elements_grav",
                "orbital_elements")


class NegativeDensity(RuntimeError):
    pass


def focus_leaves(p):
    """The flagship's tree: `depth` rounds refining every block whose
    centroid lies inside focus_factor / round^focus_index."""
    ff, fi = p["focus_factor"], p["focus_index"]
    return mesh.build_tree(
        lambda r, radius: r == 0 or radius < ff / r ** fi, int(p["depth"]))


def disk_profile(p, x):
    """Primitive [sigma, vx, vy] of the initial disk at positions x."""
    rs, rc, Ma = p["softening_radius"], p["disk_radius"], p["mach_number"]
    s0 = p["disk_mass"] / (17.0618 * rc * rc)
    s1 = p["ambient_density"] * s0
    r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    xs = r / rc
    sigma = s0 * torch.exp(-0.5 * (xs - 1) ** 2) + s1
    dp_dr = (1.0 / Ma / Ma / (r + rs)) * (xs * (1 - xs) * (1 - s1 / sigma)
                                          - 1.0)
    vp = torch.sqrt(torch.clamp(1.0 / (r + rs) + dp_dr, min=0.0))
    vr = -p["mdot"] / (sigma * 2 * math.pi * r) * (r > 2.0).to(r.dtype)
    vx = vr * (x[..., 0] / r) - vp * (x[..., 1] / r)
    vy = vr * (x[..., 1] / r) + vp * (x[..., 0] / r)
    return torch.stack([sigma, vx, vy], dim=-1)


def conserved(P):
    s = P[..., 0]
    return torch.stack([s, s * P[..., 1], s * P[..., 2]], dim=-1)


def primitive(U):
    s = U[..., 0]
    return torch.stack([s, U[..., 1] / s, U[..., 2] / s], dim=-1)


def slope(yl, y0, yr, theta):
    """Generalised minmod: 0.25 |sgn a + sgn b| (sgn a + sgn c)
    min(|a|, |b|, |c|), a sign of 0 counting as +1."""
    a, b, c = (y0 - yl) * theta, (yr - yl) * 0.5, (yr - y0) * theta
    sgn = lambda v: torch.where(v < 0, -torch.ones_like(v), torch.ones_like(v))
    m = torch.minimum(torch.minimum(a.abs(), b.abs()), c.abs())
    return 0.25 * (sgn(a) + sgn(b)).abs() * (sgn(a) + sgn(c)) * m


def cs2_at(x, bodies, p):
    """Sound speed squared from the binary's softened potential."""
    phi = 0.0
    for k in (0, 1):
        d = x - bodies[k, 1:3]
        phi = phi - bodies[k, 0] / torch.sqrt(
            d[..., 0] ** 2 + d[..., 1] ** 2 + p["softening_radius"] ** 2)
    return -phi / p["mach_number"] ** 2


def nu_at(x, cs2, p):
    """Kinematic alpha viscosity alpha cs H, H = r / Mach."""
    if p["nu"] > 0.0 or p["alpha_cutoff_radius"] > 0.0:
        raise NotImplementedError("constant nu or an alpha cutoff")
    r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    return p["alpha"] * torch.sqrt(cs2) * (r / p["mach_number"])


def hlle(pl, pr, cs2, axis: int):
    """HLLE flux of the isothermal system through a face normal to axis."""
    cs = torch.sqrt(cs2)
    ul, ur = conserved(pl), conserved(pr)

    def flux(P, U):
        vn = P[..., 1 + axis]
        f = U * vn[..., None]
        pressure = P[..., 0] * cs2
        return f + torch.stack([torch.zeros_like(pressure),
                                pressure * (axis == 0),
                                pressure * (axis == 1)], dim=-1)

    vl, vr = pl[..., 1 + axis], pr[..., 1 + axis]
    ap = torch.clamp(torch.maximum(vl + cs, vr + cs), min=0.0)[..., None]
    am = torch.clamp(torch.minimum(vl - cs, vr - cs), max=0.0)[..., None]
    return (flux(pl, ul) * ap - flux(pr, ur) * am
            - (ul - ur) * ap * am) / (ap - am)


def shear(axis: int, gl, gr, hl, hr, mu):
    """The viscous stress flux from the velocity gradients of the two
    cells beside a face: gl, gr along the face normal, hl, hr across it."""
    g = lambda a, b, c: 0.5 * (a[..., c] + b[..., c])
    if axis == 0:
        dx_ux, dx_uy = g(gl, gr, 1), g(gl, gr, 2)
        dy_ux, dy_uy = g(hl, hr, 1), g(hl, hr, 2)
        tx, ty = mu * (dx_ux - dy_uy), mu * (dx_uy + dy_ux)
    else:
        dx_ux, dx_uy = g(hl, hr, 1), g(hl, hr, 2)
        dy_ux, dy_uy = g(gl, gr, 1), g(gl, gr, 2)
        tx, ty = mu * (dx_uy + dy_ux), -mu * (dx_ux - dy_uy)
    return torch.stack([torch.zeros_like(mu), -tx, -ty], dim=-1)


@dataclass
class Disk:
    """The static data of one mesh, on the device in the run's dtype."""
    p: dict
    leaves: list
    nb: mesh.Neighbours
    xc: torch.Tensor
    xf: torch.Tensor
    yf: torch.Tensor
    dx: torch.Tensor
    dA: torch.Tensor
    u_init: torch.Tensor
    buffer: torch.Tensor

    @staticmethod
    def build(p, device, dtype):
        if not (p["conserve_linear_p"] and p["riemann"] == "hlle"
                and p["reconstruct_method"] == "plm"
                and p["rk_order"] == 2 and not p["axisymmetric_cs2"]
                and not p["fixed_dt"] and p["eccentricity"] == 0.0
                and not p["counter_rotate"]):
            raise NotImplementedError("the reference covers the flagship's "
                                      "default scheme only")
        leaves = focus_leaves(p)
        bs, rd = int(p["block_size"]), p["domain_radius"]
        t = lambda a: torch.as_tensor(a, dtype=dtype, device=device)
        xc64 = mesh.cell_centres(leaves, bs) * rd
        dx64 = mesh.spacing(leaves, bs) * rd
        r = np.hypot(xc64[..., 0], xc64[..., 1])
        buffer = p["buffer_damping_rate"] * (1.0 + np.tanh(3.0 * (r - rd)))
        xc = t(xc64)
        return Disk(p, leaves, mesh.Neighbours(leaves, device), xc,
                    t(mesh.face_centres(leaves, bs, 0) * rd),
                    t(mesh.face_centres(leaves, bs, 1) * rd), t(dx64),
                    t(np.broadcast_to((dx64 ** 2)[:, None, None],
                                      xc64.shape[:-1]).copy()),
                    conserved(disk_profile(p, xc)), t(buffer))

    def fluxes(self, axis, pe, g_long, g_tran, bodies):
        """Face flux times face length along `axis`, from the primitives
        and slopes extended by a guard cell on that axis."""
        n = pe.shape[1 + axis]
        left = lambda a: a.narrow(1 + axis, 0, n - 1)
        right = lambda a: a.narrow(1 + axis, 1, n - 1)
        half = 0.5 * self.dx[:, None, None, None]
        pl = left(pe) + left(g_long) * half
        pr = right(pe) - right(g_long) * half
        xf = self.xf if axis == 0 else self.yf
        cs2 = cs2_at(xf, bodies, self.p)
        mu = 0.5 * nu_at(xf, cs2, self.p) * (pl[..., 0] + pr[..., 0])
        f = hlle(pl, pr, cs2, axis) + shear(axis, left(g_long), right(g_long),
                                             left(g_tran), right(g_tran), mu)
        f = f * self.dx[:, None, None, None]
        # a face shared with two finer blocks carries the sum of their fluxes
        out = f.clone()
        for side in (0, 1):
            face = 2 * axis + side
            theirs = f.select(1 + axis, 0 if side == 1 else n - 2)
            both = torch.cat([theirs[self.nb.fine[:, face, 0]],
                              theirs[self.nb.fine[:, face, 1]]], dim=1)
            at = 0 if side == 0 else n - 2
            finer = (self.nb.case[:, face] == 2).view(-1, 1, 1)
            out.select(1 + axis, at).copy_(torch.where(
                finer, both[:, 0::2] + both[:, 1::2], f.select(1 + axis, at)))
        return out

    def sources(self, u0, bodies, dt):
        """The gravity, sink, buffer and floor sources times dt, and the
        totals {name: (value, gross)} they give the bodies and the buffer."""
        p, xc = self.p, self.xc
        sigma = u0[..., 0]
        lz = lambda v: xc[..., 0] * v[..., 2] - xc[..., 1] * v[..., 1]
        tot = lambda a: (torch.sum(a * self.dA), torch.sum(a.abs() * self.dA))
        s = (self.u_init - u0) * self.buffer[..., None] * dt
        totals = {"mass_ejected": tot(-s[..., 0]),
                  "angular_momentum_ejected": tot(-lz(s))}
        pairs = {k: [] for k in ("mass_accreted_on",
                                 "angular_momentum_accreted_on",
                                 "integrated_torque_on", "momentum_x",
                                 "momentum_y", "force_x", "force_y")}
        for k in (0, 1):
            d = xc - bodies[k, 1:3]
            d2 = d[..., 0] ** 2 + d[..., 1] ** 2
            acc = -d * (bodies[k, 0] / (d2 + p["softening_radius"] ** 2)
                        ** 1.5)[..., None]
            force = acc * sigma[..., None]
            grav = torch.stack([torch.zeros_like(sigma), force[..., 0],
                                force[..., 1]], dim=-1) * dt
            rate = p["sink_rate"] * torch.exp(
                -(d2 / p["sink_radius"] ** 2 / 2.0))
            sink = -u0 * rate[..., None] * dt
            s = s + grav + sink
            pairs["mass_accreted_on"].append(tot(-sink[..., 0]))
            pairs["angular_momentum_accreted_on"].append(tot(-lz(sink)))
            pairs["integrated_torque_on"].append(tot(-lz(grav)))
            pairs["momentum_x"].append(tot(-sink[..., 1]))
            pairs["momentum_y"].append(tot(-sink[..., 2]))
            pairs["force_x"].append(tot(-force[..., 0] * dt))
            pairs["force_y"].append(tot(-force[..., 1] * dt))
        floor = p["density_floor"] * p["disk_mass"]
        s = s + u0 * 1e-2 * (sigma < floor).to(u0.dtype)[..., None]
        for k, v in pairs.items():
            totals[k] = (torch.stack([v[0][0], v[1][0]]),
                         torch.stack([v[0][1], v[1][1]]))
        return s, totals

    def stage(self, u0, bodies, dt, theta):
        """One forward-Euler stage: (u1, totals on the host, invalid)."""
        p0 = primitive(u0)
        pe = [mesh.extend(p0, self.nb, a) for a in (0, 1)]
        g = [slope(e.narrow(1 + a, 0, e.shape[1 + a] - 2),
                   e.narrow(1 + a, 1, e.shape[1 + a] - 2),
                   e.narrow(1 + a, 2, e.shape[1 + a] - 2), theta)
             / self.dx[:, None, None, None] for a, e in enumerate(pe)]
        fx = self.fluxes(0, pe[0], mesh.extend(g[0], self.nb, 0),
                         mesh.extend(g[1], self.nb, 0), bodies)
        fy = self.fluxes(1, pe[1], mesh.extend(g[1], self.nb, 1),
                         mesh.extend(g[0], self.nb, 1), bodies)
        s, totals = self.sources(u0, bodies, dt)
        u1 = u0 - ((fx[:, 1:] - fx[:, :-1]) + (fy[:, :, 1:] - fy[:, :, :-1])) \
            * dt / self.dA[..., None] + s
        sig = u1[..., 0]
        invalid = bool(torch.any((sig < 0) | torch.isnan(sig)))
        host = {k: (v[0].double().cpu().numpy(), v[1].double().cpu().numpy())
                for k, v in totals.items()}
        return u1, host, invalid

    def time_step(self, u, bodies):
        P = primitive(u)
        cs = torch.sqrt(cs2_at(self.xc, bodies, self.p))
        a = torch.maximum(P[..., 1].abs() + cs, P[..., 2].abs() + cs)
        return self.p["cfl_number"] * float(
            torch.min(self.dx / torch.amax(a, dim=(1, 2))))


def _bodies(state: two_body.TwoBodyState):
    return np.array([[b.mass, b.position_x, b.position_y, b.velocity_x,
                      b.velocity_y] for b in (state.body1, state.body2)])


def element_vector(e: two_body.FullOrbitalElements) -> np.ndarray:
    el = e.elements
    return np.array([e.pomega, e.tau, e.cm_position_x, e.cm_position_y,
                     e.cm_velocity_x, e.cm_velocity_y, el.separation,
                     el.total_mass, el.mass_ratio, el.eccentricity])


def element_set(v) -> two_body.FullOrbitalElements:
    return two_body.FullOrbitalElements(
        *[float(x) for x in v[:6]],
        two_body.OrbitalElements(*[float(x) for x in v[6:]]))


@dataclass
class Solution:
    """The reference's state: the conserved tensor, the host totals (each
    with its gross) and the three element sets as 10-vectors."""
    time: float
    iteration: int
    u: torch.Tensor
    totals: dict = field(default_factory=dict)    # name -> [value, gross]
    oe_acc: np.ndarray = None
    oe_grav: np.ndarray = None
    oe: np.ndarray = None

    def average(self, other: "Solution") -> "Solution":
        """The RK2 close: the mean of this state and other."""
        mean = lambda a, b: 0.5 * a + 0.5 * b
        return Solution(
            mean(self.time, other.time), (self.iteration + other.iteration) // 2,
            mean(self.u, other.u),
            {k: [mean(v[0], other.totals[k][0]), mean(v[1], other.totals[k][1])]
             for k, v in self.totals.items()},
            mean(self.oe_acc, other.oe_acc), mean(self.oe_grav, other.oe_grav),
            mean(self.oe, other.oe))


def _square_sum(a, b):
    return a * a + b * b


class Binary:
    """The reference run: initial state, steps, and the time-series rows
    at each due."""

    def __init__(self, p, device, dtype):
        self.p = p
        self.dtype = dtype
        self.disk = Disk.build(p, device, dtype)
        self.period = 2 * math.pi

    def initial(self, u0) -> Solution:
        """The state at t = 0 holding the conserved tensor u0 (on the
        disk's leaves)."""
        z2 = lambda: [np.zeros(2), np.zeros(2)]
        z1 = lambda: [np.zeros(()), np.zeros(())]
        totals = {k: z2() for k in PAIRS}
        totals.update({k: z1() for k in EJECTED})
        p = self.p
        oe = element_vector(two_body.make_full_orbital_elements(
            two_body.OrbitalElements(p["separation"], 1.0, p["mass_ratio"],
                                     p["eccentricity"])))
        return Solution(0.0, 0, u0, totals, np.zeros(10), np.zeros(10), oe)

    def _stage(self, s: Solution, dt, theta) -> Solution:
        E0 = element_set(s.oe)
        state = two_body.compute_two_body_state(E0, s.time)
        bodies = _bodies(state)
        u1, t, invalid = self.disk.stage(
            s.u, torch.as_tensor(bodies, dtype=self.dtype, device=s.u.device),
            dt, theta)
        if invalid:
            raise NegativeDensity
        acc, grv = [], []
        work, work_gross = np.zeros(2), np.zeros(2)
        for k, b in enumerate(bodies):
            m, x, y, vx, vy = b
            dM = float(t["mass_accreted_on"][0][k])
            dpx = float(t["momentum_x"][0][k])
            dpy = float(t["momentum_y"][0][k])
            avx, avy = (m * vx + dpx) / (m + dM), (m * vy + dpy) / (m + dM)
            acc.append(two_body.PointMass(m + dM, x, y, avx, avy))
            grv.append(two_body.PointMass(
                m, x, y, vx + float(t["force_x"][0][k]) / m,
                vy + float(t["force_y"][0][k]) / m))
            e1 = _square_sum(m * vx + dpx, m * vy + dpy) / (m + dM)
            e0 = _square_sum(m * vx, m * vy) / m
            work[k], work_gross[k] = 0.5 * (e1 - e0), 0.5 * (e1 + e0)
        E_acc = two_body.compute_orbital_elements(
            two_body.TwoBodyState(*acc), s.time)
        E_grv = two_body.compute_orbital_elements(
            two_body.TwoBodyState(*grv), s.time)
        d_acc = element_vector(two_body.diff(E0, E_acc))
        d_grv = element_vector(two_body.diff(E0, E_grv))
        d_cm = element_vector(two_body.diff_cm(E0, dt))
        live = 1.0 if s.time > self.p["begin_live_binary"] else 0.0
        totals = {}
        for k in PAIRS + EJECTED:
            value, gross = ((work, work_gross) if k == "work_done_on"
                            else t[k])
            totals[k] = [s.totals[k][0] + value, s.totals[k][1] + gross]
        return Solution(s.time + dt, s.iteration + 1, u1, totals,
                        s.oe_acc + d_acc, s.oe_grav + d_grv,
                        s.oe + (d_acc + d_grv + d_cm) * live)

    def step(self, s: Solution) -> Solution:
        """One RK2 step at the CFL time step; a step that gives a negative
        density is taken again at a tenth of it, first order."""
        bodies = _bodies(two_body.compute_two_body_state(element_set(s.oe),
                                                         s.time))
        dt = self.disk.time_step(s.u, torch.as_tensor(
            bodies, dtype=self.dtype, device=s.u.device))

        def rk2(dt, theta):
            return s.average(self._stage(self._stage(s, dt, theta), dt, theta))

        try:
            return rk2(dt, self.p["plm_theta"])
        except NegativeDensity:
            return rk2(0.1 * dt, 0.0)

    def row(self, s: Solution) -> dict:
        """The time-series row of state s: {field: (value, scale)}, the
        scale being what the field's float32 rounding is measured against."""
        u, xc, dA = s.u, self.disk.xc, self.disk.dA
        lz = xc[..., 0] * u[..., 2] - xc[..., 1] * u[..., 1]
        out = {"time": (s.time, abs(s.time)),
               "disk_mass": (float(torch.sum(u[..., 0] * dA)),
                             float(torch.sum(u[..., 0].abs() * dA))),
               "disk_angular_momentum": (float(torch.sum(lz * dA)),
                                         float(torch.sum(lz.abs() * dA)))}
        out.update(self.scalars(s))
        state = two_body.compute_two_body_state(element_set(s.oe), s.time)
        a = float(s.oe[6])
        for name, b in (("position_of_mass1", state.body1),
                        ("position_of_mass2", state.body2)):
            out[name + ".0"] = (b.position_x, a)
            out[name + ".1"] = (b.position_y, a)
        return out

    def scalars(self, s: Solution) -> dict:
        """The state's totals and element sets: {field: (value, scale)}.
        Each element's scale is its orbit's size in that unit (2 pi, the
        period, the separation, the orbital speed, the mass, 1), times the
        steps accumulated for the perturbation sets. A circular orbit's
        perturbation sets have no differentiable pomega, tau or
        eccentricity, and those three are left out."""
        out = {"time": (s.time, abs(s.time))}
        for k in PAIRS:
            for i in (0, 1):
                out[f"{k}.{i}"] = (float(s.totals[k][0][i]),
                                   float(s.totals[k][1][i]))
        for k in EJECTED:
            out[k] = (float(s.totals[k][0]), float(s.totals[k][1]))
        a, M, q = (float(x) for x in s.oe[6:9])
        scale = np.array([2 * math.pi, 2 * math.pi / math.sqrt(M / a ** 3),
                          a, a, math.sqrt(M / a), math.sqrt(M / a), a, M, q,
                          1.0])
        circular = float(s.oe[9]) < 1e-3
        steps = max(s.iteration, 1)
        for name, v, n in (("orbital_elements_acc", s.oe_acc, steps),
                           ("orbital_elements_grav", s.oe_grav, steps),
                           ("orbital_elements", s.oe, None)):
            for j, key in enumerate(ELEMENTS):
                if circular and n is not None and j in (0, 1, 9):
                    continue
                out[f"{name}.{key}"] = (float(v[j]), (n or 1) * scale[j])
        return out
