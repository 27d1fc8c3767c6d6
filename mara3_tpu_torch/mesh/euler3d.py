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

The step is kernels/euler3d_step.py's: kernel B12
(csrc/octree_euler_step.cu, one launch a step) for a state on a CUDA card,
its plain version (torch ops: gathers, the HLLE, the update) on the CPU; the
JAX package has no kernel for it. A non-physical state (negative density or
pressure after recovery) gives NaNs, which the caller's finiteness test
finds.

Under torch.profiler (app/tracing.py) each step of the plain version
records a `mara3.step` span, and inside it one `mara3.guard` (the two guard
slabs) and one `mara3.correct` (the level-jump flux correction) an axis;
untraced they are the tracer's shared null context. The kernel has no
per-step host work and records no span; its calls count their steps as
`octree_kernel_steps`.
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.physics import euler


def _spacings(mesh, bs, domain_size, U):
    """[B] cell size per block, float64 on the host, then in U's dtype on
    U's device."""
    return torch.as_tensor(domain_size / (1 << mesh.level) / bs).to(
        device=U.device, dtype=U.dtype)


def make_advance(mesh, bs, gamma_law_index=5.0 / 3.0, domain_size=2.0):
    """(U, dt, steps) -> U: first-order HLLE Euler on the octree with exactly
    conservative coarse-fine flux correction, on U's device and in its
    dtype: kernel B12 on a CUDA card, the plain version on the CPU
    (kernels/euler3d_step.advance_n)."""
    from mara3_tpu_torch.kernels import euler3d_step

    def advance(U, dt, steps):
        return euler3d_step.advance_n(U, mesh, dt, steps, gamma_law_index,
                                      domain_size)

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
