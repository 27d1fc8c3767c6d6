"""3D Euler AMR solver on the 2:1-balanced octree.

Port of mara3_tpu/mesh/euler3d.py: mesh/amr3d.py's guard exchange and
exactly conservative coarse-fine flux correction driven by the Newtonian
Euler physics (physics/euler.py), a 3D finite-volume hydro solver.

Scheme (first-order in space, forward Euler in time):
- the state is the conserved density ``U[B, n, n, n, 5]`` (trailing
  component axis);
- per axis: one guard slab of primitives on each side (piecewise-constant
  prolongation and the exact 2x2 mean restriction at level jumps, periodic
  wrap), HLLE fluxes at the n + 1 faces;
- coarse-fine faces are exactly conservative: amr3d.correct_fluxes
  overwrites the coarse side's boundary flux with the 2x2 mean of the fine
  side's per-area HLLE fluxes.

It has no kernel, in either package: the step is torch ops on the state's
device (gathers, the HLLE, the update). A non-physical state (negative
density or pressure after recovery) gives NaNs, which the caller's
finiteness test finds.

Under torch.profiler (app/tracing.py) each step records a `mara3.step`
span, and inside it one `mara3.guard` (the two guard slabs) and one
`mara3.correct` (the level-jump flux correction) an axis; untraced they
are the tracer's shared null context.
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.app import tracing
from mara3_tpu_torch.core.ops import scalar_div
from mara3_tpu_torch.mesh import amr3d
from mara3_tpu_torch.physics import euler, on_axis


def _spacings(mesh, bs, domain_size, U):
    """[B] cell size per block, float64 on the host, then in U's dtype on
    U's device."""
    return torch.as_tensor(domain_size / (1 << mesh.level) / bs).to(
        device=U.device, dtype=U.dtype)


def make_advance(mesh, bs, gamma_law_index=5.0 / 3.0, domain_size=2.0):
    """(U, dt, steps) -> U: first-order HLLE Euler on the octree with exactly
    conservative coarse-fine flux correction, as torch ops on U's device and
    dtype."""
    g = gamma_law_index

    def face_flux(P, axis, rec):
        """[B, ..., n + 1 faces along axis, ..., 5] HLLE per-area fluxes,
        the two guard faces included, then the level-jump correction."""
        n = P.shape[1]
        with rec.span("mara3.guard"):
            lo = amr3d._guard(P, mesh, axis, 0).unsqueeze(axis + 1)
            hi = amr3d._guard(P, mesh, axis, 1).unsqueeze(axis + 1)
        Pe = torch.cat([lo, P, hi], dim=axis + 1)
        F = euler.riemann_hlle(Pe.narrow(axis + 1, 0, n + 1),
                               Pe.narrow(axis + 1, 1, n + 1), on_axis(axis),
                               g)
        with rec.span("mara3.correct"):
            return amr3d.correct_fluxes(F, axis, mesh)

    def advance(U, dt, steps):
        rec = tracing.recorder()
        inv_dx = scalar_div(1.0, _spacings(mesh, bs, domain_size, U))[
            :, None, None, None, None]
        dt_ = torch.full((), dt, dtype=U.dtype, device=U.device)
        n = U.shape[1]
        for _ in range(steps):
            with rec.span("mara3.step"):
                P = euler.recover_primitive(U, g)
                dU = 0.0
                for axis in range(3):
                    F = face_flux(P, axis, rec)
                    dU = dU + (F.narrow(axis + 1, 1, n)
                               - F.narrow(axis + 1, 0, n))
                U = U - dt_ * inv_dx * dU
        return U

    return advance


def max_signal_speed(U, gamma_law_index=5.0 / 3.0):
    """Global fastest wavespeed (a 0-d tensor on U's device), for host-level
    CFL timesteps."""
    P = euler.recover_primitive(U, gamma_law_index)
    return torch.max(euler.max_wavespeed(P, gamma_law_index))


def total_conserved(mesh, bs, U, domain_size=2.0):
    """[5] exact extrinsic totals: sum(U * cell volume) per component."""
    dx = _spacings(mesh, bs, domain_size, U)
    return torch.sum(U.sum(dim=(1, 2, 3)) * dx[:, None] ** 3, dim=0)
