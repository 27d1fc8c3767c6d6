"""Piecewise-linear (generalized minmod) slope limiting.

Port of mara3_tpu/mathx/plm.py (the reference's PLM gradient,
src/math_interpolation.hpp:85-97): theta in [1, 2] tunes between minmod (1)
and MC (2); theta = 0 degenerates to piecewise-constant, which is how the
reference's binary "safe mode" falls back to first order
(subprog_binary.cpp:285-292). Tensors broadcast over any leading shape.
"""

from __future__ import annotations

import torch


def _sign_or_one(a):
    """copysign(1, a) as the reference uses it, except that -0 counts as +1
    (sign(0) is +1, as in the JAX package's spelling)."""
    s = torch.sign(a)
    return torch.where(s == 0, torch.ones_like(s), s)


def plm_gradient(yl, y0, yr, theta):
    """Limited slope from three adjacent cell values.

    Matches the reference formula bit-for-bit in exact arithmetic:
      a = (y0 - yl) * theta, b = (yr - yl) / 2, c = (yr - y0) * theta
      slope = 0.25 |sgn a + sgn b| (sgn a + sgn c) min(|a|,|b|,|c|)
    """
    a = (y0 - yl) * theta
    b = (yr - yl) * 0.5
    c = (yr - y0) * theta
    sa, sb, sc = _sign_or_one(a), _sign_or_one(b), _sign_or_one(c)
    minabs = torch.minimum(torch.minimum(torch.abs(a), torch.abs(b)),
                           torch.abs(c))
    return 0.25 * torch.abs(sa + sb) * (sa + sc) * minabs


def plm_gradient_on_axis(y, theta, axis: int = 0):
    """Limited slopes for every interior cell along `axis`; output is two
    cells shorter, aligned with y[1:-1]."""
    n = y.shape[axis]
    return plm_gradient(y.narrow(axis, 0, n - 2), y.narrow(axis, 1, n - 2),
                        y.narrow(axis, 2, n - 2), theta)
