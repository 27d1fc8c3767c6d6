"""3D AMR block layout and conservative advection on a 2:1-balanced octree.

Port of mara3_tpu/mesh/amr3d.py: the production 2D design
(mesh/block_layout.py: a host-built static leaf list and neighbor table,
the guard exchange as masked gathers, coarse-fine flux correction) lifted
to rank 3, with a finite-volume advection scheme as the driving workload.

- The mesh is static: a Morton-ordered leaf list (tree_nd.create_tree, 2:1
  balanced with periodic wrap) and a per-face neighbor table built once on
  the host, as numpy.
- The state is dense ``u[B, bs, bs, bs]``; every per-face case
  (same-level / coarser / 4 finer) is evaluated for all blocks as gathers
  and selected by the case, as torch ops on the state's device.
- Guard slabs at level jumps use piecewise-constant prolongation and the
  exact 2x2 mean restriction, summed in the JAX package's order.
- Coarse-fine faces are exactly conservative: the coarse side's boundary
  flux is overwritten by the 2x2 mean of the fine side's per-area fluxes,
  so global mass is conserved to round-off with a single global dt.
"""

from __future__ import annotations

import numpy as np
import torch

from mara3_tpu_torch.core.ops import scalar_div
from mara3_tpu_torch.mesh import tree_nd

SAME, COARSE, FINE = 0, 1, 2


class BlockMesh3D:
    """Host-built static octree block mesh (the 3D NeighborTable analog).

    Per face (block b, axis a, side s):
      case[b,a,s]   SAME / COARSE / FINE
      same_id       same-level neighbor slot (valid when SAME)
      coarse_id     coarser neighbor slot (valid when COARSE)
      tq1/tq2       our quarter of the coarse face (tangential parity bits)
      fine_id[...,4] the 4 face-adjacent finer slots, ordered (b2, b1) so
                    index k = b2*2 + b1 with b1 the low tangential axis bit
    """

    def __init__(self, leaves):
        leaves = list(leaves)
        slot = {leaf: i for i, leaf in enumerate(leaves)}
        B = len(leaves)
        self.leaves = leaves
        self.case = np.zeros((B, 3, 2), np.int32)
        self.same_id = np.zeros((B, 3, 2), np.int32)
        self.coarse_id = np.zeros((B, 3, 2), np.int32)
        self.tq1 = np.zeros((B, 3, 2), np.int32)
        self.tq2 = np.zeros((B, 3, 2), np.int32)
        self.fine_id = np.zeros((B, 3, 2, 4), np.int32)
        self.level = np.array([l for l, _ in leaves], np.int32)
        for b, leaf in enumerate(leaves):
            level, coords = leaf
            for a in range(3):
                t1, t2 = [ax for ax in range(3) if ax != a]
                for s in (0, 1):
                    nbr = tree_nd.neighbor(leaf, a, s)
                    if nbr in slot:
                        self.case[b, a, s] = SAME
                        self.same_id[b, a, s] = slot[nbr]
                    elif tree_nd.parent(nbr) in slot:
                        self.case[b, a, s] = COARSE
                        self.coarse_id[b, a, s] = slot[tree_nd.parent(nbr)]
                        self.tq1[b, a, s] = coords[t1] & 1
                        self.tq2[b, a, s] = coords[t2] & 1
                    else:
                        self.case[b, a, s] = FINE
                        kids = tree_nd.children(nbr)
                        got = 0
                        for k, kid in enumerate(kids):
                            if ((k >> a) & 1) != (1 - s):
                                continue
                            if kid not in slot:
                                raise ValueError(
                                    "2:1 balance violated or incomplete "
                                    "leaf set")
                            b1 = (k >> t1) & 1
                            b2 = (k >> t2) & 1
                            self.fine_id[b, a, s, b2 * 2 + b1] = slot[kid]
                            got += 1
                        assert got == 4

    @classmethod
    def create(cls, predicate, depth):
        return cls(tree_nd.create_tree(predicate, depth, rank=3))


def _table(mesh, name, device):
    """mesh.<name> as an int64 tensor on `device`, copied there once per
    device and kept on the mesh: a copy from host memory waits for the
    device's queue, and the guards read these tables on every face of
    every step."""
    tables = mesh.__dict__.setdefault("_device_tables", {})
    key = (name, torch.device(device))
    if key not in tables:
        tables[key] = torch.as_tensor(np.asarray(getattr(mesh, name)),
                                      dtype=torch.int64, device=device)
    return tables[key]


def _slab(u, ids, axis, side):
    """[B, n, n, *C]: thickness-1 boundary slab of each gathered block,
    the face the neighbor presents to us (its high face for our side 0).
    Trailing axes beyond the three spatial ones ride along."""
    n = u.shape[1]
    return u.select(axis + 1, n - 1 if side == 0 else 0)[ids]


def _restrict_face(sf, n):
    """Exact 2x2 tangential mean of a [B, n, n, *C] face slab: the four
    cells summed in the order XLA's reduction over the two pair axes sums
    them (pairs along the second tangential axis, then their sum), then
    divided by 4."""
    r = sf.reshape(sf.shape[0], n // 2, 2, n // 2, 2, *sf.shape[3:])
    return ((r[:, :, 0, :, 0] + r[:, :, 0, :, 1])
            + (r[:, :, 1, :, 0] + r[:, :, 1, :, 1])) / 4


def _assemble_quarters(q):
    """The four [B, n/2, n/2, *C] quarters k = b2*2 + b1 into one face:
    b1 along dim 1 (the low tangential axis), b2 along dim 2."""
    return torch.cat([torch.cat([q[0], q[1]], dim=1),
                      torch.cat([q[2], q[3]], dim=1)], dim=2)


def _guard(u, mesh, axis, side):
    """[B, n, n, *C] guard slab outside face (axis, side) of every block,
    with level jumps handled by PC-prolongation / mean-restriction."""
    n = u.shape[1]
    dev = u.device
    tail = (1,) * (u.dim() - 4)
    t = lambda name: _table(mesh, name, dev)
    case = t("case")[:, axis, side].reshape(-1, 1, 1, *tail)

    g_same = _slab(u, t("same_id")[:, axis, side], axis, side)

    # coarser neighbor: select our quarter of its face and prolong
    # piecewise-constant, idx = tq * n/2 + i // 2 per tangential axis
    sc = _slab(u, t("coarse_id")[:, axis, side], axis, side)
    i2 = torch.arange(n, device=dev) // 2
    idx1 = t("tq1")[:, axis, side][:, None] * (n // 2) + i2
    idx2 = t("tq2")[:, axis, side][:, None] * (n // 2) + i2
    rows = torch.arange(sc.shape[0], device=dev)[:, None, None]
    g_coarse = sc[rows, idx1[:, :, None], idx2[:, None, :]]

    # 4 finer neighbors: mean-restrict each face, assemble quarters
    g_fine = _assemble_quarters([
        _restrict_face(_slab(u, t("fine_id")[:, axis, side, k], axis, side),
                       n) for k in range(4)])

    return torch.where(case == SAME, g_same,
                       torch.where(case == COARSE, g_coarse, g_fine))


def correct_fluxes(F, axis, mesh):
    """Overwrite each FINE-case boundary face of F with the 2x2 mean of the
    fine neighbors' per-area fluxes at their matching face (the per-area
    form of restrict_extrinsic over face totals), making every coarse-fine
    interface exactly conservative. F has n+1 faces along ``axis``;
    trailing component axes ride along."""
    n = F.shape[axis + 1] - 1
    dev = F.device
    tail = (1,) * (F.dim() - 4)
    for s in (0, 1):
        j_own = 0 if s == 0 else n           # our boundary face
        j_fine = n if s == 0 else 0          # their matching face
        Fface = F.select(axis + 1, j_fine)
        rest = _assemble_quarters([
            _restrict_face(Fface[_table(mesh, "fine_id", dev)[:, axis, s, k]],
                           n) for k in range(4)])
        own = F.select(axis + 1, j_own)
        mask = (_table(mesh, "case", dev)[:, axis, s] == FINE).reshape(
            -1, 1, 1, *tail)
        new = torch.where(mask, rest, own).unsqueeze(axis + 1)
        F = (torch.cat([new, F.narrow(axis + 1, 1, n)], dim=axis + 1)
             if s == 0 else
             torch.cat([F.narrow(axis + 1, 0, n), new], dim=axis + 1))
    return F


def make_advance(mesh, bs, v, domain_size=2.0):
    """(u, dt, steps) -> u: dimension-split first-order upwind advection at
    velocity ``v`` with per-level cell sizes and exactly conservative
    coarse-fine flux correction, as torch ops on u's device and dtype."""
    dx = domain_size / (1 << mesh.level) / bs       # [B], float64

    def face_flux(u, axis, vel):
        """Per-area flux at the n+1 faces along ``axis`` (incl. guards),
        then the coarse side of every level jump overwritten by the
        restricted fine-side flux (per-area restrict_extrinsic)."""
        n = u.shape[1]
        lo = _guard(u, mesh, axis, 0).unsqueeze(axis + 1)
        hi = _guard(u, mesh, axis, 1).unsqueeze(axis + 1)
        ue = torch.cat([lo, u, hi], dim=axis + 1)
        upwind = ue.narrow(axis + 1, 0 if vel > 0 else 1, n + 1)
        return torch.full((), vel, dtype=u.dtype, device=u.device) * upwind

    def advance(u, dt, steps):
        dx_t = torch.as_tensor(dx).to(device=u.device, dtype=u.dtype)
        inv_dx = scalar_div(1.0, dx_t)[:, None, None, None]
        dt_ = torch.full((), dt, dtype=u.dtype, device=u.device)
        n = u.shape[1]
        for _ in range(steps):
            du = 0.0
            for axis, vel in enumerate(v):
                F = correct_fluxes(face_flux(u, axis, vel), axis, mesh)
                du = du + (F.narrow(axis + 1, 1, n) - F.narrow(axis + 1, 0, n))
            u = u - dt_ * inv_dx * du
        return u

    return advance


def sample_blocks(mesh, bs, fn, dtype=None):
    """[B, bs, bs, bs]: fn(X, Y, Z) sampled at cell centroids of every
    block from the tree geometry (float64 coordinates)."""
    out = []
    for leaf in mesh.leaves:
        (x0, y0, z0), w = tree_nd.block_extent(leaf)
        c = (torch.arange(bs, dtype=torch.float64) + 0.5) * (w / bs)
        X, Y, Z = torch.meshgrid(x0 + c, y0 + c, z0 + c, indexing="ij")
        out.append(fn(X, Y, Z))
    u = torch.stack(out)
    return u.to(dtype) if dtype is not None else u


def total_mass(mesh, bs, u, domain_size=2.0):
    """Exact extrinsic total: sum(u * cell volume) over the octree."""
    dx = torch.as_tensor(domain_size / (1 << mesh.level) / bs).to(
        device=u.device, dtype=u.dtype)
    return torch.sum(u.sum(dim=(1, 2, 3)) * dx ** 3)
