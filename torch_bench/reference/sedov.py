"""The plain reference of the relativistic Sedov blast (`sedov`, SRHD).

Written for this benchmark from Mara3's equations (subprog_sedov.cpp and
physics_srhd.hpp); it imports nothing of the program under test.

- The grid: vertices 10^y at y evenly spaced from -0.5 to log10(outer
  radius), int(log10(outer radius) nr) cells; cell volumes
  (r1^3 - r0^3) / 3 and face areas r^2 (subprog_sedov.cpp:144-163).
- The initial state: density `explosion_density` and pressure
  `explosion_pressure` inside r = 1, density r^-density_index and
  pressure 1e-6 times it outside, at rest; the state kept is the conserved
  density times the cell volume.
- The step (subprog_sedov.cpp:395-420): the primitives recovered cell by
  cell, the guards (the first cell mirrored with its radial velocity
  negated inside, the last copied outside, :231-250), the HLLE flux with
  the SRHD wave speeds at every face, the spherical source, and forward
  Euler at dt = 0.4 min dr.
- The recovery (physics_srhd.hpp:364-440): Newton on the pressure from
  p = 0, each cell until |f| < 1e-10 or 50 updates, the Lorentz factor of
  the converging update kept.
- The time-series row (subprog_sedov.cpp:276-308): the shock at the most
  negative jump of the specific entropy log(p / rho^gamma), the pressure
  maximum behind it, the plateau ahead of it, the vertex of the parabola
  through the radial four-velocity at the maximum and its neighbours,
  and the shock velocity from the jump in the mass flux.

Departures from upstream:

- The whole grid updates as tensors (torch, on any device); upstream loops
  over cells. The Newton runs every unconverged cell together, a converged
  one frozen, so each cell sees upstream's sequence of updates.
- In a dtype coarser than float64 (the control) the Newton's tolerance
  adds 8 eps (|tau| + D + |p|), since 1e-10 lies below the dtype's
  resolution of f; a cell that has not converged after 50 updates keeps
  its last iterate where upstream throws. In float64 neither applies.
- `warm=True` starts each step's Newton from the pressure the cell's
  previous step converged to, not from 0: it is used to count the
  updates the recovery needs (`updates`), not for the check.
- The geometry is formed in float64 and cast to the run's dtype, as the
  vertices of a run are float64 whatever the state's dtype.
- The source is upstream's at the polar angle pi / 2 (cot theta = 0): a
  radial run.
"""

from __future__ import annotations

import math

import torch

GAMMA = 4.0 / 3.0
CFL = 0.4
TOLERANCE = 1e-10
ITERATIONS = 50
TEMPERATURE = 1e-6


def vertices(p, device) -> torch.Tensor:
    """The radial vertices, float64 on `device`."""
    decades = math.log10(float(p["outer_radius"]))
    cells = int(decades * int(p["nr"]))
    y = torch.linspace(-0.5, decades, cells + 1, dtype=torch.float64)
    return (10.0 ** y).to(device)


def centres(v) -> torch.Tensor:
    return 0.5 * (v[:-1] + v[1:])


def log_positions(p, v) -> torch.Tensor:
    """[nr, 2] float64: each cell centre's log radius mapped onto [-1, 1],
    and 0 (the seed's field lives on this line)."""
    lo, hi = -0.5, math.log10(float(p["outer_radius"]))
    x = 2.0 * (torch.log10(centres(v)) - lo) / (hi - lo) - 1.0
    return torch.stack([x, torch.zeros_like(x)], dim=-1)


# -- SRHD (physics_srhd.hpp) --------------------------------------------------

def lorentz(P):
    return torch.sqrt(1.0 + P[1] ** 2 + P[2] ** 2 + P[3] ** 2)


def enthalpy_density(P):
    return P[0] + P[4] * GAMMA / (GAMMA - 1.0)


def conserved(P):
    """[D, S1, S2, S3, tau] of the primitives [rho, u1, u2, u3, p]."""
    W = lorentz(P)
    D = P[0] * W
    Dh = D * enthalpy_density(P) / P[0]
    return [D, Dh * P[1], Dh * P[2], Dh * P[3], Dh * W - P[4] - D]


def recover(U, p_start=None):
    """(primitives, pressure, updates a cell) of the conserved density U:
    Newton on the pressure, each cell from p_start (default 0) until
    |f| < tolerance or ITERATIONS updates."""
    D, S1, S2, S3, tau = U
    SS = S1 * S1 + S2 * S2 + S3 * S3
    p = torch.zeros_like(D) if p_start is None else p_start.clone()
    W0 = torch.ones_like(D)
    done = torch.zeros_like(D, dtype=torch.bool)
    updates = torch.zeros_like(D, dtype=torch.int32)
    coarse = torch.finfo(D.dtype).eps > 1e-12
    for _ in range(ITERATIONS):
        q = tau + D + p
        v2 = torch.clamp(SS / (q * q), max=1.0 - 1e-10)
        W2 = 1.0 / (1.0 - v2)
        W = torch.sqrt(W2)
        e = (tau + D * (1.0 - W) + p * (1.0 - W2)) / (D * W)
        d = D / W
        h = 1.0 + e + p / d
        cs2 = GAMMA * p / (d * h)
        f = d * e * (GAMMA - 1.0) - p
        g = v2 * cs2 - 1.0
        tol = TOLERANCE
        if coarse:
            tol = tol + 8.0 * torch.finfo(D.dtype).eps \
                * (torch.abs(tau) + D + torch.abs(p))
        live = ~done
        updates = updates + live.to(torch.int32)
        W0 = torch.where(live, W, W0)
        p = torch.where(live, p - f / g, p)
        done = done | (torch.abs(f) < tol)
        if bool(done.all()):
            break
    q = tau + D + p
    P = [D / W0, W0 * S1 / q, W0 * S2 / q, W0 * S3 / q, p]
    return P, p, updates


def wave_speeds(P):
    """The slowest and fastest acoustic speeds along the radius."""
    cs2 = GAMMA * P[4] / enthalpy_density(P)
    W = lorentz(P)
    vn = P[1] / W
    uu = P[1] ** 2 + P[2] ** 2 + P[3] ** 2
    vv = uu / (1.0 + uu)
    k0 = torch.sqrt(cs2 * (1.0 - vv) * (1.0 - vv * cs2 - vn * vn
                                        * (1.0 - cs2)))
    den = 1.0 - vv * cs2
    return (vn * (1.0 - cs2) - k0) / den, (vn * (1.0 - cs2) + k0) / den


def radial_flux(P, U):
    vn = P[1] / lorentz(P)
    return [vn * U[0], vn * U[1] + P[4], vn * U[2], vn * U[3],
            vn * U[4] + P[4] * vn]


def hlle(Pl, Pr):
    Ul, Ur = conserved(Pl), conserved(Pr)
    Fl, Fr = radial_flux(Pl, Ul), radial_flux(Pr, Ur)
    alm, alp = wave_speeds(Pl)
    arm, arp = wave_speeds(Pr)
    ap = torch.clamp(torch.maximum(alp, arp), min=0.0)
    am = torch.clamp(torch.minimum(alm, arm), max=0.0)
    return [(fl * ap - fr * am - (ul - ur) * ap * am) / (ap - am)
            for fl, fr, ul, ur in zip(Fl, Fr, Ul, Ur)]


def source(P, r):
    """Upstream's spherical source at theta = pi / 2."""
    H = enthalpy_density(P)
    ur, uq, up, pg = P[1], P[2], P[3], P[4]
    zero = torch.zeros_like(pg)
    return [zero, (2.0 * pg + H * (uq * uq + up * up)) / r,
            -H * ur * uq / r, -H * up * ur / r, zero]


# -- the run ----------------------------------------------------------------

class Sedov:
    """The blast of parameters p on `device` in `dtype`; the state is
    [nr, 5] (conserved density times volume), as the program keeps it."""

    def __init__(self, p, device, dtype=torch.float64, warm=False):
        self.p, self.dtype, self.warm = p, dtype, warm
        self.v = vertices(p, device)
        r0, r1 = self.v[:-1], self.v[1:]
        self.volume = (r1 ** 3 - r0 ** 3) / 3.0
        self.dv = self.volume.to(dtype)
        self.da = (self.v ** 2).to(dtype)
        self.rc = centres(self.v).to(dtype)
        self.dt = CFL * float(self.v[1] - self.v[0])
        self.p_warm = None
        self.updates = 0
        self.cell_steps = 0

    def initial(self, factor=None) -> torch.Tensor:
        """The initial state in float64, times the seed's factor [nr]."""
        p = self.p
        rc = centres(self.v)
        inside = rc < 1.0
        rho = torch.where(inside, float(p["explosion_density"]),
                          rc ** -float(p["density_index"]))
        pre = torch.where(inside, float(p["explosion_pressure"]),
                          rho * TEMPERATURE)
        zero = torch.zeros_like(rc)
        U = torch.stack(conserved([rho, zero, zero, zero, pre]), dim=-1)
        u = U * self.volume[:, None]
        return u if factor is None else u * factor[:, None]

    def step(self, u):
        U = [u[:, k] / self.dv for k in range(5)]
        P, self.p_warm, n = recover(U, self.p_warm if self.warm else None)
        self.updates += int(n.sum())
        self.cell_steps += n.numel()
        inner = [P[0][:1], -P[1][:1], P[2][:1], P[3][:1], P[4][:1]]
        ext = [torch.cat([a, q, q[-1:]]) for a, q in zip(inner, P)]
        F = hlle([q[:-1] for q in ext], [q[1:] for q in ext])
        S = source(P, self.rc)
        du = [(-(f[1:] * self.da[1:] - f[:-1] * self.da[:-1])
               + s * self.dv) * self.dt for f, s in zip(F, S)]
        return u + torch.stack(du, dim=-1)

    def run(self, u, steps: int):
        u = u.to(self.dtype)
        for _ in range(steps):
            u = self.step(u)
        return u

    def row(self, u, time: float) -> dict:
        """The time-series row of the state u at `time`, as floats; the
        recovery and the locators in the run's dtype."""
        P, _, _ = recover([u[:, k] / self.dv for k in range(5)])
        P = [q.cpu() for q in P]
        rho, ur, pg = P[0], P[1], P[4]
        v = self.v.cpu()
        rc = centres(v)
        entropy = torch.log(pg / rho ** GAMMA)
        shock = int(torch.argmin(entropy[1:] - entropy[:-1]))
        behind = shock
        while behind > 0 and pg[behind - 1] > pg[behind]:
            behind -= 1
        ahead = plateau_ahead(pg, shock)
        i = max(behind, 1)
        return {"time": time,
                "shock_radius": float(v[shock]),
                "shock_radius_upstream": float(rc[ahead]),
                "shock_radius_downstream": float(rc[behind]),
                "shock_radius_interpolated": parabola_vertex_x(
                    rc[i - 1:i + 2], ur[i - 1:i + 2]),
                "shock_velocity": jump_velocity(
                    [q[ahead] for q in P], [q[behind] for q in P])}


def plateau_ahead(pg, index: int) -> int:
    """Walk outward from `index` while dlogp[i - 1] < dlogp[i - 2] / 2;
    0 where the walk leaves the grid (post_shock_locator.hpp:134-152)."""
    dlogp = torch.log(pg[1:]) - torch.log(pg[:-1])
    i = index
    while True:
        if i < 2:
            return i
        if i - 1 >= dlogp.shape[0]:
            return 0
        if not dlogp[i - 1] < 0.5 * dlogp[i - 2]:
            return i
        i += 1


def parabola_vertex_x(x, y) -> float:
    """The abscissa of the vertex of the parabola through three points."""
    x1, x2, x3 = (float(a) for a in x)
    y1, y2, y3 = (float(a) for a in y)
    d = (x1 - x2) * (x1 - x3) * (x2 - x3)
    a = (x3 * (y2 - y1) + x2 * (y1 - y3) + x1 * (y3 - y2)) / d
    b = (x3 * x3 * (y1 - y2) + x2 * x2 * (y3 - y1)
         + x1 * x1 * (y2 - y3)) / d
    return -b / (2.0 * a)


def jump_velocity(P1, P2) -> float:
    """(d2 u2 - d1 u1) / (d2 W2 - d1 W1), 1 ahead of the shock, 2 behind,
    in the primitives' dtype."""
    d1, d2, u1, u2 = P1[0], P2[0], P1[1], P2[1]
    return float((d2 * u2 - d1 * u1) / (d2 * lorentz(P2) - d1 * lorentz(P1)))
