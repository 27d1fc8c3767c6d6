"""Parabola vertex, for the sedov shock tracker's sub-cell interpolation.

Port of parabola_vertex from mara3_tpu/mathx/polynomial.py (the reference's
math_polynomial.hpp:208-215). cubic_roots and quartic_roots are not ported
yet (ROADMAP.md queue A item 10).
"""

from __future__ import annotations


def parabola_vertex(x1, x2, x3, y1, y2, y3):
    """Vertex (x, y) of the parabola through three points; takes numbers
    or tensors."""
    d = (x1 - x2) * (x1 - x3) * (x2 - x3)
    A = (x3 * (y2 - y1) + x2 * (y1 - y3) + x1 * (y3 - y2)) / d
    B = (x3 * x3 * (y1 - y2) + x2 * x2 * (y3 - y1) + x1 * x1 * (y2 - y3)) / d
    C = (x2 * x3 * (x2 - x3) * y1 + x3 * x1 * (x3 - x1) * y2
         + x1 * x2 * (x1 - x2) * y3) / d
    return -B / (2.0 * A), C - B * B / (4.0 * A)
