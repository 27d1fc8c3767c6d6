"""SRHD primitive recovery as the kernels spell it: the plain version.

Port of mara3_tpu/kernels/cloud_update.py::_recover_window (:267-344) and
its `_rcp` (:35), the Newton recovery that kernels B5 (sedov) and B4
(cloud) run inside the kernel. Its device twin is csrc/srhd_recover.cuh,
which the CUDA kernels include; this module is what their plain versions
call.

It is the reciprocal-first spelling, not the scheme's
(physics/srhd.recover_primitive_t): 1/(tau + D + p), rsqrt(1 - v2) and
1/(v2 gamma p / d - h) are the three reciprocals of an update, 1/D is
hoisted, and the relative floor 8 eps (|tau| + D + |p|) is on in every
dtype. Per cell: at most 50 updates from p0; a cell is frozen once
|f| < tolerance; W kept is the W of the converging update (1 where a cell
never converges), and p has the converging update applied. The vector loop
runs CHUNK updates per pass and reads `all(done)` on the host once per
pass: frozen cells do not move, so the per-cell results do not depend on
CHUNK.
"""

from __future__ import annotations

import torch

GAMMA = 4.0 / 3.0       # the in-kernel Newton is written for gamma = 4/3
NEWTON_ITER_MAX = 50
ERROR_TOLERANCE = 1e-10
CHUNK = 5


def _rcp(x):
    """The exact (correctly rounded) reciprocal, pl.reciprocal(approx=False)."""
    return torch.reciprocal(x)


def recover_window(Ut, p0, tfloor: float = 0.0):
    """Primitives of the conserved densities Ut = (D, S1, S2, S3, tau) by
    the masked Newton from the pressure guess p0: (Pt, p, done, updates),
    with updates each cell's count of Newton updates. With tfloor > 0 the
    pressure Pt[4] is floored at tfloor * D / W (cloud_update.py:339-344);
    tfloor = 0 skips the floor, as the TPU kernel's static test does. p is
    the final pressure before the floor: sedov's warm start. Cloud carries
    the floored Pt[4] to its next stage (cloud_update.py:446, :459)."""
    D, S1, S2, S3, tau = Ut
    SS = S1 * S1 + S2 * S2 + S3 * S3
    eps_rel = 8.0 * torch.finfo(D.dtype).eps
    f_floor = eps_rel * (torch.abs(tau) + D)
    invD = _rcp(D)

    def one_update(p, Wc, done):
        invdp = _rcp(tau + D + p)
        v2 = torch.clamp(SS * invdp * invdp, max=1.0 - 1e-10)
        W = torch.rsqrt(1.0 - v2)
        invW = (1.0 - v2) * W
        W2 = W * W
        e = (tau + D * (1.0 - W) + p * (1.0 - W2)) * (invD * invW)
        d = D * invW
        invd = invD * W
        h = 1.0 + e + p * invd
        f = d * e * (GAMMA - 1.0) - p
        p_next = p - f * h * _rcp(v2 * GAMMA * p * invd - h)
        newly = torch.abs(f) < ERROR_TOLERANCE + f_floor + eps_rel * torch.abs(p)
        p_out = torch.where(done, p, p_next)
        W_out = torch.where(done, Wc, torch.where(newly, W, Wc))
        return p_out, W_out, done | newly

    p, W = p0, torch.ones_like(D)
    done = torch.zeros_like(D, dtype=torch.bool)
    updates = torch.zeros_like(D, dtype=torch.int32)
    it = 0
    while it < NEWTON_ITER_MAX and not bool(done.all()):
        for _ in range(CHUNK):
            updates += (~done).to(torch.int32)
            p, W, done = one_update(p, W, done)
        it += CHUNK
    invW = _rcp(W)
    pf = torch.maximum(p, tfloor * D * invW) if tfloor > 0.0 else p
    inv_denom = _rcp(tau + D + pf)
    return ((D * invW, W * S1 * inv_denom, W * S2 * inv_denom,
             W * S3 * inv_denom, pf), p, done, updates)
