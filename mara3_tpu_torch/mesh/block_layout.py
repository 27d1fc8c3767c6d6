"""Dense device layout for the static quadtree: neighbor tables, the guard
exchange, and the host-side single-block fetch.

Port of mara3_tpu/mesh/block_layout.py. The reference's recursive per-leaf
guard fetch (mara::get_cell_block, mesh_tree_operators.hpp:223-252:
same-level leaf, or prolong from parent, or combine+coarsen children)
becomes host-built static tables and gathers over a
[num_blocks, bs, bs, ncomp] tensor: `extend_blocks` (three candidate strips
and a select, any width; amrsand's scheme) and `extend_blocks_fast` (one
gather and a weighted sum, width 1; the plain versions of B2 and B3).

A 2:1-balanced tree guarantees each face sees exactly one of three cases:
  0 = same-level neighbor        (copy its edge strip)
  1 = coarser neighbor           (prolong the matching half of its edge)
  2 = two finer neighbors        (restrict their edges 2x2)
Faces are numbered 0: x-lower, 1: x-upper, 2: y-lower, 3: y-upper.

The tables are host-side numpy, as in the JAX package; the gather runs in
torch on whatever device the data lives on.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Sequence

import numpy as np
import torch

from mara3_tpu_torch.mesh import prolong_restrict as pr
from mara3_tpu_torch.mesh import tree as treemod
from mara3_tpu_torch.mesh.tree import TreeIndex


@dataclass(frozen=True)
class NeighborTable:
    """Static per-block, per-face neighbor relations (int32 arrays)."""
    case: np.ndarray       # [B, 4] in {0 same, 1 coarse, 2 fine}
    same_id: np.ndarray    # [B, 4]
    coarse_id: np.ndarray  # [B, 4]
    coarse_half: np.ndarray  # [B, 4] which half of the coarse edge (0 lower)
    fine_id: np.ndarray    # [B, 4, 2] ordered by the perpendicular coordinate


def build_neighbor_table(leaves: Sequence[TreeIndex]) -> NeighborTable:
    """Per-face neighbor relations of a 2:1-balanced leaf set."""
    leaves = list(leaves)
    index_of = {leaf: b for b, leaf in enumerate(leaves)}
    leaf_set = set(leaves)
    B = len(leaves)
    case = np.zeros((B, 4), np.int32)
    same_id = np.zeros((B, 4), np.int32)
    coarse_id = np.zeros((B, 4), np.int32)
    coarse_half = np.zeros((B, 4), np.int32)
    fine_id = np.zeros((B, 4, 2), np.int32)

    for b, leaf in enumerate(leaves):
        level, i, j = leaf
        for axis in (0, 1):
            for side in (0, 1):
                f = 2 * axis + side
                n = treemod.neighbor(leaf, axis, side)
                if n in leaf_set:
                    case[b, f] = 0
                    same_id[b, f] = index_of[n]
                elif level > 0 and treemod.parent(n) in leaf_set:
                    case[b, f] = 1
                    coarse_id[b, f] = index_of[treemod.parent(n)]
                    coarse_half[b, f] = (j & 1) if axis == 0 else (i & 1)
                else:
                    kids = treemod.children(n)
                    # children of n adjacent to my face, ordered by the
                    # perpendicular coordinate (child k at x-half k&1,
                    # y-half k>>1)
                    if axis == 0:
                        ks = (1, 3) if side == 0 else (0, 2)
                    else:
                        ks = (2, 3) if side == 0 else (0, 1)
                    try:
                        case[b, f] = 2
                        fine_id[b, f, 0] = index_of[kids[ks[0]]]
                        fine_id[b, f, 1] = index_of[kids[ks[1]]]
                    except KeyError as e:
                        raise ValueError(
                            f"tree is not 2:1 balanced at {leaf} face {f}"
                        ) from e
    return NeighborTable(case, same_id, coarse_id, coarse_half, fine_id)


def pack_neighbor_table(nt: NeighborTable) -> np.ndarray:
    """[B, 4, 6] int32 rows (case, same, coarse, coarse_half, fine0, fine1)
    per face: the one table a kernel reads to find its neighbors."""
    return np.stack([nt.case, nt.same_id, nt.coarse_id, nt.coarse_half,
                     nt.fine_id[:, :, 0], nt.fine_id[:, :, 1]],
                    axis=2).astype(np.int32)


def block_vertices(leaves: Sequence[TreeIndex], bs: int,
                   dtype=np.float64) -> np.ndarray:
    """[B, bs+1, bs+1, 2] vertex coordinates on the [-1,1]^2 root domain."""
    out = np.zeros((len(leaves), bs + 1, bs + 1, 2), dtype)
    for b, leaf in enumerate(leaves):
        x0, y0, w = treemod.block_extent(leaf)
        xv = x0 + w * np.arange(bs + 1) / bs
        yv = y0 + w * np.arange(bs + 1) / bs
        out[b, :, :, 0] = xv[:, None]
        out[b, :, :, 1] = yv[None, :]
    return out


def block_cell_centers(leaves: Sequence[TreeIndex], bs: int,
                       dtype=np.float64) -> np.ndarray:
    v = block_vertices(leaves, bs, dtype)
    return 0.25 * (v[:, :-1, :-1] + v[:, 1:, :-1] + v[:, :-1, 1:]
                   + v[:, 1:, 1:])


def block_dx(leaves: Sequence[TreeIndex], bs: int,
             dtype=np.float64) -> np.ndarray:
    """[B] cell size per block (square cells)."""
    return np.array([treemod.block_extent(leaf)[2] / bs for leaf in leaves],
                    dtype)


# -----------------------------------------------------------------------------
# guard exchange as three candidate strips and a select (any width g)
# -----------------------------------------------------------------------------

def _edge(Ug, axis: int, edge_side: int, w: int):
    """Edge strip of width w on `axis` of gathered blocks Ug [B, n, n, C]."""
    n = Ug.shape[1 + axis]
    return Ug.narrow(1 + axis, 0 if edge_side == 0 else n - w, w)


def _restrict2(a, axis: int):
    index0 = [slice(None)] * a.dim()
    index1 = [slice(None)] * a.dim()
    index0[axis] = slice(0, None, 2)
    index1[axis] = slice(1, None, 2)
    return 0.5 * (a[tuple(index0)] + a[tuple(index1)])


def guard_strip(U, nt: NeighborTable, axis: int, side: int, g: int):
    """The [B, g, n, C]-shaped (axis-0 convention; transposed for axis 1)
    guard strip outside face (axis, side) of every block, with level
    transitions handled by piecewise-constant prolongation / 2x2 averaging
    (reference restrict_cells/prolong_cells, mesh_prolong_restrict.hpp).
    The fine case pairs along the face normal first, then along the face,
    as the JAX package's does (not in GuardGather's slot order)."""
    f = 2 * axis + side
    n = U.shape[1]
    perp = 1 - axis
    neighbor_edge_side = 1 - side
    dev = U.device

    def ids(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    bcast = (slice(None),) + (None,) * (U.dim() - 1)
    case = ids(nt.case[:, f])[bcast]

    # case 0: same level
    same = _edge(U[ids(nt.same_id[:, f])], axis, neighbor_edge_side, g)

    # case 1: coarser neighbor: width ceil(g/2) edge, half along perp,
    # prolonged 2x in both directions, trimmed to g nearest the interface
    cw = (g + 1) // 2
    ce = _edge(U[ids(nt.coarse_id[:, f])], axis, neighbor_edge_side, cw)
    half = ids(nt.coarse_half[:, f])[bcast]
    lo = _edge(ce, perp, 0, n // 2)
    hi = _edge(ce, perp, 1, n // 2)
    chalf = torch.where(half == 0, lo, hi)
    cp = torch.repeat_interleave(
        torch.repeat_interleave(chalf, 2, dim=1 + axis), 2, dim=1 + perp)
    coarse = _edge(cp, axis, neighbor_edge_side, g)

    # case 2: two finer neighbors: width 2g edges, 2x2-averaged, stacked
    # along perp in perpendicular-coordinate order
    fa = _edge(U[ids(nt.fine_id[:, f, 0])], axis, neighbor_edge_side, 2 * g)
    fb = _edge(U[ids(nt.fine_id[:, f, 1])], axis, neighbor_edge_side, 2 * g)
    fa = _restrict2(_restrict2(fa, 1 + axis), 1 + perp)
    fb = _restrict2(_restrict2(fb, 1 + axis), 1 + perp)
    fine = torch.cat([fa, fb], dim=1 + perp)

    return torch.where(case == 0, same, torch.where(case == 1, coarse, fine))


def extend_blocks(U, nt: NeighborTable, axis: int, g: int = 1):
    """All blocks extended by g guard cells on both sides of `axis`
    (the reference's per-leaf extend, subprog_amrsand.cpp:253-261 /
    subprog_binary_scheme.cpp:132-142, as one gather program)."""
    lo = guard_strip(U, nt, axis, 0, g)
    hi = guard_strip(U, nt, axis, 1, g)
    return torch.cat([lo, U, hi], dim=1 + axis)


# -----------------------------------------------------------------------------
# host-side single-block fetch (API parity with mara::get_cell_block /
# get_vertex_block, mesh_tree_operators.hpp:223-292): one tree node's data
# at its own resolution, for the regrid's remap and for analysis; the hot
# path uses the vectorized exchanges instead.
# -----------------------------------------------------------------------------

def get_cell_block(leaves, blocks, index):
    """Cell data of the tree node `index` at its own resolution: the leaf
    itself, a prolonged quadrant of a coarser leaf, or the combined and
    coarsened four children. `blocks` is the dense [B, bs, bs, ...] tensor
    aligned with `leaves`."""
    order = {leaf: b for b, leaf in enumerate(leaves)}
    if index in order:
        return blocks[order[index]]
    parent = treemod.parent(index)
    if index[0] > 0 and parent in order:
        kids = pr.refine_cells_2d(blocks[order[parent]])
        level, i, j = index
        return kids[(i & 1) + 2 * (j & 1)]
    children_blocks = [get_cell_block(leaves, blocks, c)
                       for c in treemod.children(index)]
    return pr.coarsen_cells_2d(pr.combine_cells_2d(children_blocks))


def get_vertex_block(leaves, vertex_blocks, index):
    """Vertex-flavored analog of get_cell_block."""
    order = {leaf: b for b, leaf in enumerate(leaves)}
    if index in order:
        return vertex_blocks[order[index]]
    parent = treemod.parent(index)
    if index[0] > 0 and parent in order:
        kids = pr.refine_verts_2d(vertex_blocks[order[parent]])
        level, i, j = index
        return kids[(i & 1) + 2 * (j & 1)]
    children_blocks = [get_vertex_block(leaves, vertex_blocks, c)
                       for c in treemod.children(index)]
    return pr.coarsen_verts_2d(pr.combine_verts_2d(children_blocks))


# -----------------------------------------------------------------------------
# guard exchange: one gather + weighted sum
#
# Every one-cell guard is a linear combination of at most 4 source cells
# (1 for the same and coarse cases, the 2x2 average for the fine case), so
# the whole exchange is one precomputed gather.
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class GuardGather:
    """indices [B, 4, bs, 4] flat into U.reshape(B*bs*bs, C);
    weights [B, 4, bs, 4]. Guard width 1 (the workloads' width). Built as
    numpy on the host; `to` gives the tensor copy the hot path reads."""
    indices: object
    weights: object
    bs: int

    def to(self, device, dtype) -> "GuardGather":
        return GuardGather(
            torch.as_tensor(self.indices, dtype=torch.int64, device=device),
            torch.as_tensor(self.weights, dtype=dtype, device=device),
            self.bs)


def build_guard_gather(nt: NeighborTable, bs: int) -> GuardGather:
    B = nt.case.shape[0]
    idx = np.zeros((B, 4, bs, 4), np.int32)
    wts = np.zeros((B, 4, bs, 4), np.float64)

    def flat(b, i, j):
        return (b * bs + i) * bs + j

    for b in range(B):
        for axis in (0, 1):
            for side in (0, 1):
                f = 2 * axis + side
                edge = bs - 1 if side == 0 else 0   # neighbor's facing edge
                for p in range(bs):                  # position along face
                    if nt.case[b, f] == 0:
                        nb = nt.same_id[b, f]
                        src = ((nb, edge, p) if axis == 0
                               else (nb, p, edge))
                        idx[b, f, p, 0] = flat(*src)
                        wts[b, f, p, 0] = 1.0
                    elif nt.case[b, f] == 1:
                        nb = nt.coarse_id[b, f]
                        q = nt.coarse_half[b, f] * (bs // 2) + p // 2
                        src = ((nb, edge, q) if axis == 0
                               else (nb, q, edge))
                        idx[b, f, p, 0] = flat(*src)
                        wts[b, f, p, 0] = 1.0
                    else:
                        nb = nt.fine_id[b, f, 0 if p < bs // 2 else 1]
                        q = (2 * p) % bs
                        e2 = (bs - 2, bs - 1) if side == 0 else (1, 0)
                        # 2x2 average of the fine neighbor's edge cells
                        cells = ([(nb, e2[0], q), (nb, e2[0], q + 1),
                                  (nb, e2[1], q), (nb, e2[1], q + 1)]
                                 if axis == 0 else
                                 [(nb, q, e2[0]), (nb, q + 1, e2[0]),
                                  (nb, q, e2[1]), (nb, q + 1, e2[1])])
                        for m, src in enumerate(cells):
                            idx[b, f, p, m] = flat(*src)
                            wts[b, f, p, m] = 0.25
    return GuardGather(idx, wts, bs)


def guard_strips(U, gg: GuardGather):
    """The four one-cell guard strips [B, 4, bs, C] of blocks U
    [B, bs, bs, C] (faces x-lo, x-hi, y-lo, y-hi): one gather and a
    weighted sum over the four source slots, taken in slot order."""
    B, bs = U.shape[0], gg.bs
    C = U.shape[-1]
    flat = U.reshape(B * bs * bs, C)
    ii = torch.as_tensor(gg.indices, dtype=torch.int64, device=U.device)
    ww = torch.as_tensor(gg.weights, dtype=U.dtype, device=U.device)
    vals = flat[ii]                                      # [B, 4, bs, 4, C]
    w = ww[..., None]
    return (w[:, :, :, 0] * vals[:, :, :, 0] + w[:, :, :, 1] * vals[:, :, :, 1]
            + w[:, :, :, 2] * vals[:, :, :, 2]
            + w[:, :, :, 3] * vals[:, :, :, 3])


def extend_blocks_fast(U, gg: GuardGather, axis: int, strips=None):
    """All blocks extended by one guard cell on both sides of `axis`
    (the reference's per-leaf extend, subprog_binary_scheme.cpp:132-142).
    `strips` optionally supplies guard_strips(U, gg) already computed."""
    B, bs = U.shape[0], gg.bs
    C = U.shape[-1]
    if strips is None:
        strips = guard_strips(U, gg)
    lo, hi = strips[:, 2 * axis], strips[:, 2 * axis + 1]   # [B, bs, C]
    if axis == 0:
        return torch.cat([lo.reshape(B, 1, bs, C), U,
                          hi.reshape(B, 1, bs, C)], dim=1)
    return torch.cat([lo.reshape(B, bs, 1, C), U,
                      hi.reshape(B, bs, 1, C)], dim=2)


# -----------------------------------------------------------------------------
# guard exchange on component-first blocks from their edge rows (the front
# of the flagship's jnp_strips advance)
#
# The JAX package applies the coarse prolongation (half-select and 2x
# repeat) and the fine restriction (pair mean, half placement) as one-hot
# [bs, bs] matmuls, a TPU mechanism; here they are indexed gathers over the
# same neighbor rows, with the same sums: 0.5 a[q] + 0.5 a[q + 1].
# -----------------------------------------------------------------------------

@dataclass(frozen=True)
class SoaGuard:
    """Gather positions along a strip of bs cells: guard cell p beside a
    coarser neighbor's half h reads its edge at coarse_pos[h, p]; beside
    two finer neighbors it reads neighbor fine_slot[p] at fine_pos[p] and
    fine_pos[p] + 1."""
    coarse_pos: np.ndarray   # [2, bs]
    fine_pos: np.ndarray     # [bs]
    fine_slot: np.ndarray    # [bs]

    def to(self, device) -> "SoaGuard":
        """The positions as int64 tensors on `device`."""
        as_t = lambda a: torch.as_tensor(a, dtype=torch.int64, device=device)
        return SoaGuard(as_t(self.coarse_pos), as_t(self.fine_pos),
                        as_t(self.fine_slot))


def build_soa_guard(nt: NeighborTable, bs: int) -> SoaGuard:
    """The SoA guard exchange's positions (the JAX package's one-hot
    matrices Mh and Pf as indices). `nt` is taken for the JAX signature;
    the positions depend on bs alone."""
    half = bs // 2
    p = np.arange(bs)
    return SoaGuard(
        coarse_pos=np.stack([h * half + p // 2 for h in (0, 1)]),
        fine_pos=(2 * p) % bs,
        fine_slot=p // half)


def guard_strips_from_edges(E, nt: NeighborTable, consts: SoaGuard,
                            axis: int):
    """(lo, hi) one-cell guard strips [B, C, bs] from an edge tensor E
    [B, C, 4, bs] holding rows (axis 0) or columns (axis 1) (0, 1, bs-2,
    bs-1) of every block along `axis`. Bit-equal to the JAX package's for
    finite E. The arrays of `nt` and `consts` may be numpy or, to spare the
    host copies on a hot path, int64 tensors on E's device."""
    dev = E.device
    B, C, _, bs = E.shape

    def ids(a):
        return torch.as_tensor(a, dtype=torch.int64, device=dev)

    def along(rows, pos):
        """rows [B, C, bs] at positions pos [B, bs] or [bs]."""
        pos = ids(pos)
        if pos.dim() == 1:
            return rows[:, :, pos]
        return torch.gather(rows, 2, pos[:, None, :].expand(B, C, bs))

    def guard(side):
        f = 2 * axis + side
        # the neighbor's facing edge: its high rows for my low side, and
        # the other way round
        e_last = 3 if side == 0 else 0
        e_inner, e_edge = (2, 3) if side == 0 else (1, 0)
        same = E[ids(nt.same_id[:, f]), :, e_last]
        crow = E[ids(nt.coarse_id[:, f]), :, e_last]
        coarse = along(crow, consts.coarse_pos[nt.coarse_half[:, f]])
        g0 = E[ids(nt.fine_id[:, f, 0])]
        g1 = E[ids(nt.fine_id[:, f, 1])]
        a0 = 0.5 * (g0[:, :, e_inner] + g0[:, :, e_edge])
        a1 = 0.5 * (g1[:, :, e_inner] + g1[:, :, e_edge])
        slot = ids(consts.fine_slot)[None, None, :]
        a = torch.where(slot == 0, along(a0, consts.fine_pos),
                        along(a1, consts.fine_pos))
        b = torch.where(slot == 0, along(a0, consts.fine_pos + 1),
                        along(a1, consts.fine_pos + 1))
        fine = 0.5 * a + 0.5 * b
        case = ids(nt.case[:, f])[:, None, None]
        return torch.where(case == 0, same,
                           torch.where(case == 1, coarse, fine))

    return guard(0), guard(1)


def guard_strips_soa(UT, nt: NeighborTable, consts: SoaGuard, axis: int):
    """(lo, hi) one-cell guard strips [B, C, bs] of component-first blocks
    UT [B, C, bs, bs] (a permuted view of the port's [B, bs, bs, C] does)."""
    bs = UT.shape[3]
    rows = (0, 1, bs - 2, bs - 1)
    if axis == 0:
        E = torch.stack([UT[:, :, r] for r in rows], dim=2)
    else:
        E = torch.stack([UT[:, :, :, r] for r in rows], dim=2)
    return guard_strips_from_edges(E, nt, consts, axis)
