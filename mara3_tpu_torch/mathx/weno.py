"""WENO-5 (Jiang & Shu 1996) interface reconstruction.

Port of mara3_tpu/mathx/weno.py, the fifth-order finite-volume
reconstruction the reference derives in math/WenoInterpolation.nb but ships
no code for. ``weno5_faces`` mirrors the PLM face-state API: given a tensor
extended by 3 guard cells per side along `axis`, it returns (L, R) states
at the n+1 interior faces.
"""

from __future__ import annotations

from mara3_tpu_torch.core.ops import div_scalar, scalar_div

EPSILON = 1e-6

# optimal linear weights for the upwind-biased 5-point stencil
D0, D1, D2 = 0.1, 0.6, 0.3


def _sq(x):
    return x * x


def _weno5_left(qm2, qm1, q0, qp1, qp2):
    """Reconstructed value at the RIGHT face of cell 0 from the upwind
    (leftward) 5-point stencil: the '+' state propagating rightward."""
    b0 = (13.0 / 12.0) * _sq(qm2 - 2 * qm1 + q0) \
        + 0.25 * _sq(qm2 - 4 * qm1 + 3 * q0)
    b1 = (13.0 / 12.0) * _sq(qm1 - 2 * q0 + qp1) \
        + 0.25 * _sq(qm1 - qp1)
    b2 = (13.0 / 12.0) * _sq(q0 - 2 * qp1 + qp2) \
        + 0.25 * _sq(3 * q0 - 4 * qp1 + qp2)

    a0 = scalar_div(D0, _sq(EPSILON + b0))
    a1 = scalar_div(D1, _sq(EPSILON + b1))
    a2 = scalar_div(D2, _sq(EPSILON + b2))
    asum = a0 + a1 + a2

    p0 = div_scalar(2 * qm2 - 7 * qm1 + 11 * q0, 6.0)
    p1 = div_scalar(-qm1 + 5 * q0 + 2 * qp1, 6.0)
    p2 = div_scalar(2 * q0 + 5 * qp1 - qp2, 6.0)
    return (a0 * p0 + a1 * p1 + a2 * p2) / asum


def weno5_faces(q, axis: int = 0):
    """(L, R) face states at the n+1 faces of the n interior cells of a
    tensor extended by 3 guard cells per side along `axis`."""
    n = q.shape[axis] - 6

    def sl(k):
        return q.narrow(axis, k, n + 1)

    # left state at face i+1/2 reconstructed from cells i-2..i+2
    L = _weno5_left(sl(0), sl(1), sl(2), sl(3), sl(4))
    # right state at face i+1/2 from the mirrored stencil of cell i+1
    R = _weno5_left(sl(5), sl(4), sl(3), sl(2), sl(1))
    return L, R
