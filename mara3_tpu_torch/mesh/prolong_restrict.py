"""Prolongation / restriction operators between AMR levels.

Port of mara3_tpu/mesh/prolong_restrict.py (the reference's
src/mesh_prolong_restrict.hpp:40-381), vertex- and cell-flavored, as torch
ops on tensors (shapes 2x +/- 1), in the same arithmetic. Conventions match
the reference: child k of a block covers the (x-half = k & 1, y-half =
k >> 1) quadrant (core_tree.hpp:930-956 bit order with combine_cells,
mesh_prolong_restrict.hpp:244-262).
"""

from __future__ import annotations

import torch


def _ax(a, axis, sl):
    index = [slice(None)] * a.dim()
    index[axis] = sl
    return a[tuple(index)]


# -- restriction (fine -> coarse), mesh_prolong_restrict.hpp:116-142 ----------

def restrict_verts(a, axis):
    """Stride-2 subsample of vertex data."""
    return _ax(a, axis, slice(0, None, 2))


def restrict_cells(a, axis):
    """Average adjacent pairs of cell data."""
    h0 = _ax(a, axis, slice(0, None, 2))
    h1 = _ax(a, axis, slice(1, None, 2))
    return (h0 + h1) / 2


def restrict_extrinsic(a, axis):
    """Sum adjacent pairs: for extensive quantities (fluxes through faces,
    cell totals); this is the coarse-fine flux-correction primitive."""
    h0 = _ax(a, axis, slice(0, None, 2))
    h1 = _ax(a, axis, slice(1, None, 2))
    return h0 + h1


# -- prolongation (coarse -> fine), mesh_prolong_restrict.hpp:148-193 ---------

def prolong_verts(a, axis):
    """n -> 2n-1 midpoint interpolation of vertex data."""
    mid = 0.5 * (_ax(a, axis, slice(0, -1)) + _ax(a, axis, slice(1, None)))
    shape = list(a.shape)
    shape[axis] = 2 * a.shape[axis] - 1
    out = a.new_zeros(shape)
    out[tuple(slice(0, None, 2) if i == axis else slice(None)
              for i in range(a.dim()))] = a
    out[tuple(slice(1, None, 2) if i == axis else slice(None)
              for i in range(a.dim()))] = mid
    return out


def prolong_cells(a, axis):
    """n -> 2n piecewise-constant prolongation (the reference's enabled
    variant; its PLM prolongation is present but disabled,
    mesh_prolong_restrict.hpp:170-193)."""
    return torch.repeat_interleave(a, 2, dim=axis)


# -- bisect / combine, mesh_prolong_restrict.hpp:202-296 ----------------------

def bisect_verts(a, axis):
    n = a.shape[axis]
    if n % 2 == 0:
        raise ValueError("bisect_verts: array size is even on given axis")
    return _ax(a, axis, slice(0, n // 2 + 1)), _ax(a, axis, slice(n // 2, n))


def bisect_cells(a, axis):
    n = a.shape[axis]
    if n % 2 != 0:
        raise ValueError("bisect_cells: array size is odd on given axis")
    return _ax(a, axis, slice(0, n // 2)), _ax(a, axis, slice(n // 2, n))


def combine_cells_2d(children):
    """Reassemble 4 child cell blocks; children[k] at (x-half k&1,
    y-half k>>1) (mesh_prolong_restrict.hpp:280-287)."""
    c01 = torch.cat([children[0], children[1]], dim=0)
    c23 = torch.cat([children[2], children[3]], dim=0)
    return torch.cat([c01, c23], dim=1)


def combine_verts_2d(children):
    """Reassemble 4 child vertex blocks, dropping duplicated shared edges
    (mesh_prolong_restrict.hpp:264-271)."""
    c01 = torch.cat([children[0][:-1], children[1]], dim=0)
    c23 = torch.cat([children[2][:-1], children[3]], dim=0)
    return torch.cat([c01[:, :-1], c23], dim=1)


# -- refine / coarsen whole blocks, mesh_prolong_restrict.hpp:303-381 ---------

def refine_verts_2d(a):
    """One vertex block -> 4 child vertex blocks (same shape each)."""
    p = prolong_verts(prolong_verts(a, 0), 1)
    x0, x1 = bisect_verts(p, 0)
    return (bisect_verts(x0, 1)[0], bisect_verts(x1, 1)[0],
            bisect_verts(x0, 1)[1], bisect_verts(x1, 1)[1])


def refine_cells_2d(a):
    """One cell block -> 4 child cell blocks."""
    p = prolong_cells(prolong_cells(a, 0), 1)
    x0, x1 = bisect_cells(p, 0)
    return (bisect_cells(x0, 1)[0], bisect_cells(x1, 1)[0],
            bisect_cells(x0, 1)[1], bisect_cells(x1, 1)[1])


def coarsen_cells_2d(a):
    return restrict_cells(restrict_cells(a, 0), 1)


def coarsen_verts_2d(a):
    return restrict_verts(restrict_verts(a, 0), 1)
