"""The plain reference of the 3D blast on the octree (`blast3d`).

A gamma-law gas (gamma 5/3) on the periodic [-1, 1]^3 box, at rest, of
density 1 and pressure 0.1, with a sphere r^2 < 0.05 at pressure 10 (the
Sedov-Taylor test's overpressure); the tree of reference/octree.py, blocks
of n^3 cells. First-order Godunov: the primitives of each cell, the HLLE
flux through every face of every axis (a guard slab on each side of a
block, reference/octree.py), the coarse-fine correction, and the forward
Euler update u - dt (F[i+1/2] - F[i-1/2]) / dx summed over the axes.

Each output window runs at one dt, fixed at its start from the state's
largest signal speed a = max(|v_x|, |v_y|, |v_z|) + c_s over the cells:
dt = cfl dx_min / a / 3, with dx_min the finest cell; the window's steps
are the fewest whole steps that reach the run's end or the next output
due, ceil((stop - t) / dt - 1e-12); an output falls due when a whole
interval has passed since the last, which then moves on by exactly one
interval (so the dues are the interval's multiples).
The state is [B, n, n, n, 5] = (rho, rho v, E), E = p / (gamma - 1) +
rho v^2 / 2. Runs on the device and in the dtype it is given (float64, or
bfloat16 for the control); the wavespeed is the state's own dtype's,
read once a window.

Written for this benchmark from the scheme's equations (the Euler HLLE
flux of Mara3's physics_euler.hpp:614-640, the octree of
reference/octree.py); it imports nothing of the program under test and
builds its own initial state. Departures from the program's arithmetic
(mesh/euler3d.py), all round-off: the 2 x 2 means at level jumps
(reference/octree.py); the update divides the summed flux differences by
dx after multiplying by dt (the program multiplies by dt and by 1 / dx);
the normal velocity is the axis's component, where the program forms
n . v with a unit vector; the initial state and the seed's field are
multiplied in the reference's dtype (the program rounds the initial state
to float32 first).
"""

from __future__ import annotations

import math

import torch

from torch_bench.reference import octree


def steps_to_stop(t: float, dt: float, stops, eps: float = 1e-12) -> int:
    """The fewest whole steps of dt, at least 1, from t to the nearest of
    `stops` lying more than eps ahead (the run's end and the next output
    due): ceil((stop - t) / dt - eps)."""
    return min(max(1, math.ceil((stop - t) / dt - eps))
               for stop in stops if stop > t + eps)


class Blast:
    """The blast of parameters p (the configuration's, with the cell's
    words applied) on `device` in `dtype`."""

    def __init__(self, p, device, dtype):
        # nothing here multiplies matrices, but nothing may do so in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.device, self.dtype = torch.device(device), dtype
        self.gamma = p["gamma_law_index"]
        self.cfl, self.dfi = p["cfl"], p["dfi"]
        self.n = int(p["block_size"])
        self.leaves = octree.create(int(p["depth"]))
        self.faces = octree.Faces(self.leaves, self.device)
        dx = octree.spacing(self.leaves, self.n)
        self.dx_min = min(dx)
        self.dx = torch.tensor(dx, dtype=torch.float64,
                               device=self.device)[:, None, None, None, None]

    def centres(self) -> torch.Tensor:
        return octree.cell_centres(self.leaves, self.n, self.device)

    def initial(self, factor: torch.Tensor) -> torch.Tensor:
        """The conserved blast times the seed's field [B, n, n, n]."""
        x = self.centres()
        r2 = x[..., 0] ** 2 + x[..., 1] ** 2 + x[..., 2] ** 2
        rho = torch.ones_like(r2)
        p = torch.where(r2 < 0.05, torch.full_like(r2, 10.0),
                        torch.full_like(r2, 0.1))
        zero = torch.zeros_like(r2)
        u = torch.stack([rho, zero, zero, zero, p / (self.gamma - 1.0)],
                        dim=-1)
        return (u * factor[..., None]).to(self.dtype)

    def primitive(self, u: torch.Tensor) -> torch.Tensor:
        rho, m = u[..., 0], u[..., 1:4]
        ke = 0.5 * (m * m).sum(dim=-1) / rho
        p = (u[..., 4] - ke) * (self.gamma - 1.0)
        return torch.cat([rho[..., None], m / rho[..., None], p[..., None]],
                         dim=-1)

    def sound_speed(self, P: torch.Tensor) -> torch.Tensor:
        return torch.sqrt(self.gamma * P[..., 4] / P[..., 0])

    def conserved(self, P: torch.Tensor) -> torch.Tensor:
        rho, v, p = P[..., 0], P[..., 1:4], P[..., 4]
        e = p / (self.gamma - 1.0) + 0.5 * rho * (v * v).sum(dim=-1)
        return torch.cat([rho[..., None], rho[..., None] * v, e[..., None]],
                         dim=-1)

    def flux(self, P, u, axis: int) -> torch.Tensor:
        """The Euler flux along the axis: vn u, with p added to the
        axis's momentum and p vn to the energy."""
        vn, p = P[..., 1 + axis], P[..., 4]
        f = vn[..., None] * u
        f[..., 1 + axis] = f[..., 1 + axis] + p
        f[..., 4] = f[..., 4] + p * vn
        return f

    def hlle(self, Pl, Pr, axis: int) -> torch.Tensor:
        ul, ur = self.conserved(Pl), self.conserved(Pr)
        cl, cr = self.sound_speed(Pl), self.sound_speed(Pr)
        vl, vr = Pl[..., 1 + axis], Pr[..., 1 + axis]
        ap = torch.clamp(torch.maximum(vl + cl, vr + cr), min=0.0)[..., None]
        am = torch.clamp(torch.minimum(vl - cl, vr - cr), max=0.0)[..., None]
        fl, fr = self.flux(Pl, ul, axis), self.flux(Pr, ur, axis)
        return (fl * ap - fr * am - (ul - ur) * ap * am) / (ap - am)

    def fluxes(self, P: torch.Tensor, axis: int) -> torch.Tensor:
        """[B, ..., n + 1 faces along the axis, ..., 5]: HLLE between each
        pair of neighbouring cells of a block and its guard slabs, the
        level jumps corrected."""
        lo = self.faces.guard(P, axis, 0).unsqueeze(axis + 1)
        hi = self.faces.guard(P, axis, 1).unsqueeze(axis + 1)
        ext = torch.cat([lo, P, hi], dim=axis + 1)
        n = P.shape[1]
        f = self.hlle(ext.narrow(axis + 1, 0, n + 1),
                      ext.narrow(axis + 1, 1, n + 1), axis)
        return self.faces.correct(f, axis)

    def step(self, u: torch.Tensor, dt: float) -> torch.Tensor:
        P = self.primitive(u)
        n = u.shape[1]
        du = 0.0
        for axis in range(3):
            f = self.fluxes(P, axis)
            du = du + (f.narrow(axis + 1, 1, n) - f.narrow(axis + 1, 0, n))
        return u - (du * dt / self.dx.to(u.dtype))

    def max_signal_speed(self, u: torch.Tensor) -> float:
        P = self.primitive(u)
        speed = P[..., 1:4].abs().amax(dim=-1) + self.sound_speed(P)
        return float(speed.max())

    def dt(self, u: torch.Tensor) -> float:
        return self.cfl * self.dx_min / self.max_signal_speed(u) / 3.0

    def run(self, u: torch.Tensor, until: float):
        """(the state at the first window's end that reaches `until`, its
        time, its steps, each window's (dt, steps)) from time 0."""
        t, steps, windows, last = 0.0, 0, [], 0.0
        while t < until - 1e-12:
            dt = self.dt(u)
            n = steps_to_stop(t, dt, [until, last + self.dfi])
            for _ in range(n):
                u = self.step(u, dt)
            t, steps = t + n * dt, steps + n
            windows.append((dt, n))
            # an output is due once a whole interval has passed since the
            # last one, which moves on by exactly the interval
            if t - last >= self.dfi:
                last += self.dfi
        return u, t, steps, windows

    def totals(self, u: torch.Tensor) -> list:
        """The five totals sum(u * cell volume), in float64."""
        vol = self.dx.double() ** 3
        return (u.double() * vol).sum(dim=(0, 1, 2, 3)).tolist()

    def gross_momentum(self, u: torch.Tensor) -> float:
        """sum(|rho v_x| + |rho v_y| + |rho v_z|) times the cells'
        volumes, in float64: the scale of a momentum total's rounding,
        since the totals cancel to about 0."""
        vol = self.dx.double() ** 3
        return float((u.double()[..., 1:4].abs() * vol).sum())
