"""2D isothermal structured-grid Godunov scheme (PLM + HLLE/HLLC).

Port of mara3_tpu/schemes/iso2d_grid.py: the single-block compute core of
the reference's hot path (subprog_binary_scheme.cpp:790-904: recover_primitive
-> guard extend -> PLM gradients -> intercell_flux -> block_update) on plain
torch ops. Functions take *guard-extended* primitive tensors (2 guard cells
per side). Layout: [nx(+4), ny(+4), 3] with components trailing. The
operation order follows the JAX package term for term, so the two agree to
round-off. This is the kh subprogram's scheme path (fast_step=0, and the
default on the CPU); kernel B1 (kernels/iso2d_step.py) computes the same
update with its own operation order.
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.mathx.plm import plm_gradient
from mara3_tpu_torch.physics import iso2d

GUARD = 2  # PLM needs 2 guard cells per side


def plm_face_states(Pe, theta, axis):
    """Left/right primitive states at every interior face along `axis`.

    Pe is extended by GUARD cells on `axis` (length n+4); returns (Pl, Pr)
    of length n+1 along `axis` (all faces of the n interior cells):
    Pl = P[j] + grad[j]/2, Pr = P[j+1] - grad[j+1]/2
    (subprog_binary_scheme.cpp:268-343)."""
    n4 = Pe.shape[axis]
    y0 = Pe.narrow(axis, 1, n4 - 2)
    grad = plm_gradient(Pe.narrow(axis, 0, n4 - 2), y0,
                        Pe.narrow(axis, 2, n4 - 2), theta)
    m = grad.shape[axis]                      # = n + 2
    Pl = y0.narrow(axis, 0, m - 1) + 0.5 * grad.narrow(axis, 0, m - 1)
    Pr = y0.narrow(axis, 1, m - 1) - 0.5 * grad.narrow(axis, 1, m - 1)
    return Pl, Pr


def godunov_fluxes(Pe, cs2_faces_x, cs2_faces_y, plm_theta,
                   riemann="hlle"):
    """Intercell fluxes on both axes from a (GUARD, GUARD)-extended
    primitive tensor; cs2_faces_* are the sound speeds squared at the
    x-faces [nx+1, ny] and y-faces [nx, ny+1]. Returns (Fx [nx+1, ny, 3],
    Fy [nx, ny+1, 3])."""
    solve = iso2d.riemann_hlle if riemann == "hlle" else iso2d.riemann_hllc
    Pl, Pr = plm_face_states(Pe[:, GUARD:-GUARD], plm_theta, 0)
    Fx = solve(Pl, Pr, cs2_faces_x, cs2_faces_x, (1.0, 0.0))
    Pl, Pr = plm_face_states(Pe[GUARD:-GUARD, :], plm_theta, 1)
    Fy = solve(Pl, Pr, cs2_faces_y, cs2_faces_y, (0.0, 1.0))
    return Fx, Fy


def flux_divergence_update(u0, Fx, Fy, dx, dy, dt):
    """u1 = u0 - dt * (dFx/dx + dFy/dy) (subprog_binary_scheme.cpp:568-612)."""
    lx = (Fx[1:] - Fx[:-1]) / dx
    ly = (Fy[:, 1:] - Fy[:, :-1]) / dy
    return u0 - (lx + ly) * dt


def max_wavespeed(P, cs2_cells):
    """Global maximum signal speed for the CFL condition
    (subprog_binary_scheme.cpp:1107-1126)."""
    return torch.max(iso2d.max_wavespeed(P, cs2_cells))


def extend_periodic2(u):
    """Both axes, GUARD cells, periodic (single-device guard fill)."""
    u = torch.cat([u[-GUARD:], u, u[:GUARD]], dim=0)
    return torch.cat([u[:, -GUARD:], u, u[:, :GUARD]], dim=1)


def _cs2_faces(cs2, nx, ny, like):
    return (torch.full((nx + 1, ny), cs2, dtype=like.dtype, device=like.device),
            torch.full((nx, ny + 1), cs2, dtype=like.dtype, device=like.device))


def step_periodic_uniform(u0, cs2: float, dx: float, dy: float, dt,
                          plm_theta: float = 1.8, riemann="hlle"):
    """One full update on a uniform doubly-periodic grid [nx, ny, 3]."""
    nx, ny = u0.shape[0], u0.shape[1]
    Pe = extend_periodic2(iso2d.recover_primitive(u0))
    Fx, Fy = godunov_fluxes(Pe, *_cs2_faces(cs2, nx, ny, u0), plm_theta,
                            riemann)
    return flux_divergence_update(u0, Fx, Fy, dx, dy, dt)


def step_periodic_uniform_rk2(u0, cs2: float, dx: float, dy: float, dt,
                              plm_theta: float = 1.8, riemann="hlle"):
    """One SSP-RK2 (Heun) update: u1 = E(u0), u_{n+1} = (u0 + E(u1))/2 —
    the reference's rational-1/2 Shu-Osher averaging
    (subprog_binary.cpp:272-275, subprog_cloud.cpp:676-697)."""
    u1 = step_periodic_uniform(u0, cs2, dx, dy, dt, plm_theta, riemann)
    u2 = step_periodic_uniform(u1, cs2, dx, dy, dt, plm_theta, riemann)
    return 0.5 * (u0 + u2)


def step_local_extended(u_ext, cs2: float, dx: float, dy: float, dt,
                        plm_theta: float = 1.8, riemann="hlle"):
    """Update from a pre-extended conserved block (guards already filled);
    returns the interior update, the shard-local body of a distributed
    run."""
    nx = u_ext.shape[0] - 2 * GUARD
    ny = u_ext.shape[1] - 2 * GUARD
    Pe = iso2d.recover_primitive(u_ext)
    Fx, Fy = godunov_fluxes(Pe, *_cs2_faces(cs2, nx, ny, u_ext), plm_theta,
                            riemann)
    u0 = u_ext[GUARD:-GUARD, GUARD:-GUARD]
    return flux_divergence_update(u0, Fx, Fy, dx, dy, dt)
