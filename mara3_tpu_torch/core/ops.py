"""Stencil combinators along one axis, and division by a Python number.

Port of the three functions of mara3_tpu/core/ops.py that the sedov
subprogram and mathx/shock.py call (the reference's core_ndarray_ops.hpp:
121-150). The rest of that module is not ported yet (ROADMAP.md queue A
item 10).

`div_scalar` and `scalar_div` divide as JAX and the CUDA kernels do on
every device: PyTorch's CUDA `x / c` multiplies by the reciprocal of c,
and its `c / x` (on any device) is `reciprocal(x) * c`, each one rounding
more than the quotient.
"""

from __future__ import annotations

import torch


def div_scalar(x, c: float):
    """x / c, correctly rounded in x's dtype on every device."""
    return x / torch.full((), c, dtype=x.dtype, device=x.device)


def scalar_div(c: float, x):
    """c / x, correctly rounded in x's dtype on every device."""
    return torch.full((), c, dtype=x.dtype, device=x.device) / x


def zip_adjacent2_on_axis(a, axis: int = 0):
    """Pairs (a[i], a[i+1]) along `axis` (reference :141-150)."""
    n = a.shape[axis]
    return a.narrow(axis, 0, n - 1), a.narrow(axis, 1, n - 1)


def midpoint_on_axis(a, axis: int = 0):
    """Averages of adjacent pairs: 0.5*(a[i] + a[i+1]) (reference :121-129)."""
    lo, hi = zip_adjacent2_on_axis(a, axis)
    return 0.5 * (lo + hi)


def difference_on_axis(a, axis: int = 0):
    """Differences of adjacent pairs: a[i+1] - a[i] (reference :131-139)."""
    lo, hi = zip_adjacent2_on_axis(a, axis)
    return hi - lo
