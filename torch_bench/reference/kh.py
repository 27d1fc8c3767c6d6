"""The plain reference of the Kelvin-Helmholtz shear layer (`kh`).

2D isothermal gas on a uniform doubly-periodic unit box of N x N cells,
in plain PyTorch: primitive recovery, limited linear slopes (generalised
minmod, theta = plm_theta) on both axes with periodic neighbours, the face
states, HLLE fluxes through every x- and y-face, and the forward-Euler
update u - dt/dx (F[i+1/2] - F[i-1/2]) - dt/dy (G[j+1/2] - G[j-1/2]), with
the fixed dt = cfl dx / (max |v| + cs) of the initial shear layer. The
state is [N, N, 3] = (sigma, sigma vx, sigma vy), x along the first axis.
One step at a time on the run's device, in the dtype asked for (float64,
or bfloat16 for the control); the row is formed in float64 from the state.

Written for this benchmark from the scheme's equations (Mara3's
subprog_binary_scheme.cpp:268-343 for the slopes and face states,
physics_iso2d.hpp:488-520 for HLLE); it imports nothing of the program
under test and builds its own initial shear layer. The slope, the HLLE
flux and the primitive/conserved maps are binary's (reference/binary.py),
the same isothermal formulas.

Departures from the program's arithmetic (kernel B1 and the scheme), all
round-off: the slope is the full generalised minmod, and the face state
adds half of it (B1 folds 0.5 theta and 0.25 into a half-slope taken by
its sign bits); HLLE divides by (ap - am) (B1 multiplies by its
reciprocal); the update multiplies the flux difference by dt and divides
by dx (B1 multiplies by dt / dx); the initial state and the seed's field
are multiplied in the reference's dtype (the program rounds the initial
state to float32 first). Only HLLE and forward Euler (the configuration's
riemann and rk_order) are covered; anything else raises.
"""

from __future__ import annotations

import math

import torch

from torch_bench.reference.binary import conserved, hlle, primitive, slope

ROW = ("time", "total_mass", "momentum_x", "momentum_y", "kinetic_energy",
       "sigma_min", "sigma_max")


def cell_centres(n: int, device) -> torch.Tensor:
    """[N, N, 2] float64 cell centres in the unit box."""
    c = (torch.arange(n, dtype=torch.float64, device=device) + 0.5) / n
    return torch.stack(torch.meshgrid(c, c, indexing="ij"), dim=-1)


def positions(n: int, device) -> torch.Tensor:
    """[N, N, 2] float64: the cell centres mapped by x -> 2 x - 1 onto the
    seed field's [-1, 1]^2, on which its whole wave numbers are periodic
    with the box."""
    return 2.0 * cell_centres(n, device) - 1.0


class KH:
    """The shear layer of parameters p (the configuration's, with the
    cell's words applied) on `device` in `dtype`."""

    def __init__(self, p, device, dtype):
        if p["riemann"] != "hlle" or int(p["rk_order"]) != 1:
            raise NotImplementedError("the reference covers HLLE with "
                                      "forward Euler only")
        # nothing here multiplies matrices, but nothing may do so in TF32
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        self.p, self.device, self.dtype = p, torch.device(device), dtype
        self.n = int(p["N"])
        self.dx = 1.0 / self.n
        self.x = cell_centres(self.n, self.device)
        self.cs2 = torch.tensor(p["cs"] ** 2, dtype=dtype,
                                device=self.device)
        self.theta = p["plm_theta"]
        P = self.shear_layer()
        self.dt = p["cfl"] * self.dx / (P[..., 1:].abs().max().item()
                                        + p["cs"])

    def shear_layer(self) -> torch.Tensor:
        """Primitive [N, N, 3] float64: density sigma1 in |y - 1/2| < 1/4
        moving at +mach cs, sigma0 outside at -mach cs; vy seeded at both
        interfaces by pert cs sin(2 pi pert_k x) in Gaussians of width
        0.05."""
        p, x, y = self.p, self.x[..., 0], self.x[..., 1]
        f64 = lambda v: torch.full_like(x, v)
        inner = (y - 0.5).abs() < 0.25
        sigma = torch.where(inner, f64(p["sigma1"]), f64(p["sigma0"]))
        vx = torch.where(inner, f64(1.0), f64(-1.0)) * p["mach"] * p["cs"]
        envelope = (torch.exp(-((y - 0.25) / 0.05) ** 2)
                    + torch.exp(-((y - 0.75) / 0.05) ** 2))
        vy = p["pert"] * p["cs"] * torch.sin(
            2 * math.pi * p["pert_k"] * x) * envelope
        return torch.stack([sigma, vx, vy], dim=-1)

    def initial(self, factor: torch.Tensor) -> torch.Tensor:
        """The conserved shear layer times the seed's field [N, N]."""
        u = conserved(self.shear_layer()) * factor[..., None]
        return u.to(self.dtype)

    def fluxes(self, P, axis: int) -> torch.Tensor:
        """HLLE flux through the face i+1/2 of every cell i along axis."""
        left = torch.roll(P, 1, axis)
        right = torch.roll(P, -1, axis)
        g = slope(left, P, right, self.theta)
        pl = P + 0.5 * g
        pr = torch.roll(P - 0.5 * g, -1, axis)
        return hlle(pl, pr, self.cs2, axis)

    def step(self, u: torch.Tensor) -> torch.Tensor:
        P = primitive(u)
        fx, fy = self.fluxes(P, 0), self.fluxes(P, 1)
        return u - ((fx - torch.roll(fx, 1, 0)) * self.dt / self.dx
                    + (fy - torch.roll(fy, 1, 1)) * self.dt / self.dx)

    def run(self, u: torch.Tensor, steps: int) -> torch.Tensor:
        for _ in range(steps):
            u = self.step(u)
        return u

    def row(self, u: torch.Tensor, time: float) -> dict:
        """The time-series row of state u, in float64: the totals over the
        box, the kinetic energy, the density's extremes."""
        u = u.double()
        da = self.dx * self.dx
        sigma = u[..., 0]
        ke = 0.5 * (u[..., 1] ** 2 + u[..., 2] ** 2) / sigma
        values = torch.stack([sigma.sum() * da, u[..., 1].sum() * da,
                              u[..., 2].sum() * da, ke.sum() * da,
                              sigma.min(), sigma.max()]).tolist()
        return dict(zip(ROW, [time] + values))

    def gross_momentum(self, u: torch.Tensor) -> float:
        """The sum of the momenta's magnitudes over the box, in float64:
        what a float32 total's rounding is measured against, since the
        totals cancel (the y-momentum to about 0)."""
        u = u.double()
        return float((u[..., 1].abs() + u[..., 2].abs()).sum()
                     * self.dx * self.dx)
