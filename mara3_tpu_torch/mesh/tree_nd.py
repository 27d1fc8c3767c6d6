"""Rank-generic host-side static tree: refinement, 2:1 balance, ordering.

Port of mara3_tpu/mesh/tree_nd.py (host Python, copied; the block
combinators run on torch tensors through the port's prolong_restrict).
The reference's tree machinery is 2^Rank-ary for any Rank
(src/core_tree.hpp:43-235: tree_index_t<Rank>, child_indexes at :156-158
adds bit a of the child ordinal to coordinate a; next_on/prev_on at
:203-204 wrap per axis) even though every shipped workload is 2D. This
module is the rank-generic analog of mesh/tree.py — same leaf-set design
(the tree IS the set of leaf indices; it runs once at setup on the host)
with the rank a runtime parameter instead of a template argument.

Ordering: the reference's space-filling curve is 2D-only
(core_tree.hpp:64 declares hilbert_index for tree_index_t<2> alone), so
rank 2 delegates to mesh/tree.py's Hilbert routine for bit-identical
layouts with the existing quadtree path, and other ranks use Morton
(bit-interleaved) ordering — still locality-preserving for block->device
assignment, and strictly more capability than the reference ships.

mesh/prolong_restrict.py's per-axis operators (restrict_verts/cells/
extrinsic, prolong_verts/cells, bisect_*) are already rank-agnostic;
the rank-generic block combinators over them live here (refine_cells_nd
etc. — the Rank-templated analogs of mesh_prolong_restrict.hpp:40-67).
"""

from __future__ import annotations

from typing import Callable, List, Sequence, Set, Tuple

import torch

from mara3_tpu_torch.mesh import prolong_restrict as pr
from mara3_tpu_torch.mesh import tree as tree2d

TreeIndexND = Tuple[int, Tuple[int, ...]]  # (level, coords)


def make_index(level: int, *coords: int) -> TreeIndexND:
    """tree_index_t<Rank> constructor analog (core_tree.hpp:56)."""
    return (level, tuple(coords))


def rank_of(index: TreeIndexND) -> int:
    return len(index[1])


def valid(index: TreeIndexND) -> bool:
    """Coordinates within [0, 2^level) (core_tree.hpp:99-106)."""
    level, coords = index
    n = 1 << level
    return level >= 0 and all(0 <= c < n for c in coords)


def block_extent(index: TreeIndexND, domain_x0: Sequence[float] = None,
                 domain_size: float = 2.0):
    """(origin tuple, width) of the block on the [-1,1]^Rank root domain
    (the 2D path roots there too, mesh_tree_operators.hpp:171)."""
    level, coords = index
    if domain_x0 is None:
        domain_x0 = (-1.0,) * len(coords)
    w = domain_size / (1 << level)
    return tuple(x0 + c * w for x0, c in zip(domain_x0, coords)), w


def centroid_radius(index: TreeIndexND) -> float:
    x0, w = block_extent(index)
    return sum((x + w / 2) ** 2 for x in x0) ** 0.5


def children(index: TreeIndexND) -> List[TreeIndexND]:
    """Child k adds bit a of k to coordinate a (core_tree.hpp:156-158's
    coordinates * 2 + binary_repr<Rank>(k); rank 2 reduces to the
    quadtree convention: x-half k&1, y-half k>>1)."""
    level, coords = index
    R = len(coords)
    return [(level + 1, tuple(2 * c + ((k >> a) & 1)
                              for a, c in enumerate(coords)))
            for k in range(1 << R)]


def parent(index: TreeIndexND) -> TreeIndexND:
    level, coords = index
    return (level - 1, tuple(c // 2 for c in coords))


def neighbor(index: TreeIndexND, axis: int, side: int) -> TreeIndexND:
    """Same-level neighbor with wrap-around (next_on/prev_on,
    core_tree.hpp:203-204); side 0 = prev (lower), side 1 = next."""
    level, coords = index
    n = 1 << level
    d = -1 if side == 0 else 1
    c = list(coords)
    c[axis] = (c[axis] + d) % n
    return (level, tuple(c))


def is_inside(leaf: TreeIndexND, node: TreeIndexND) -> bool:
    """True if `leaf` is a strict or equal descendant of `node`."""
    ll, lc = leaf
    nl, nc = node
    if ll < nl:
        return False
    shift = ll - nl
    return tuple(c >> shift for c in lc) == nc


def create_tree(predicate: Callable[[int, float], bool], depth: int,
                rank: int) -> List[TreeIndexND]:
    """Leaves of a 2:1-balanced 2^rank-ary tree: `depth` rounds of
    conditional refinement by predicate(round, centroid radius), then
    balancing — the rank-generic create_vertex_quadtree
    (mesh_tree_operators.hpp:158-198). Returns leaves in curve order."""
    leaves: Set[TreeIndexND] = {(0, (0,) * rank)}
    for rnd in range(depth):
        nxt: Set[TreeIndexND] = set()
        for leaf in leaves:
            if predicate(rnd, centroid_radius(leaf)):
                nxt.update(children(leaf))
            else:
                nxt.add(leaf)
        leaves = nxt
    leaves = ensure_valid_tree(leaves)
    return sorted(leaves, key=curve_key)


def over_refined_neighbors(leaves: Set[TreeIndexND]) -> Set[TreeIndexND]:
    """Leaves with a neighbor subtree more than one level deeper
    (mesh_tree_operators.hpp:90-101, any rank)."""
    max_level = max(l for l, _ in leaves)
    rank = rank_of(next(iter(leaves)))
    flagged = set()
    for leaf in leaves:
        level = leaf[0]
        if max_level <= level + 1:
            continue
        for axis in range(rank):
            for side in (0, 1):
                node = neighbor(leaf, axis, side)
                if any(other[0] >= level + 2 and is_inside(other, node)
                       for other in leaves):
                    flagged.add(leaf)
    return flagged


def ensure_valid_tree(leaves: Set[TreeIndexND]) -> Set[TreeIndexND]:
    """Refine until 2:1 balanced (mesh_tree_operators.hpp:115-139)."""
    leaves = set(leaves)
    while True:
        flagged = over_refined_neighbors(leaves)
        if not flagged:
            return leaves
        for leaf in flagged:
            leaves.remove(leaf)
            leaves.update(children(leaf))


def morton_index(index: TreeIndexND) -> int:
    """Bit-interleaved (Z-order) position of the block among the 2^(R*level)
    same-level blocks. Axis 0 provides the least-significant bit of each
    group, matching the child-ordinal convention above."""
    level, coords = index
    d = 0
    R = len(coords)
    for b in range(level):
        for a in range(R):
            d |= ((coords[a] >> b) & 1) << (b * R + a)
    return d


def curve_key(index: TreeIndexND):
    """Sort key interleaving levels so a leaf sorts where its region lies
    on the finest curve (the analog of tree.hilbert_key). Rank 2 uses the
    SAME Hilbert routine as mesh/tree.py so quadtree layouts built through
    either module order identically; other ranks use Morton order."""
    level, coords = index
    rank = len(coords)
    max_level = 30
    if rank == 2:
        d = tree2d.hilbert_index((level, coords[0], coords[1]))
    else:
        d = morton_index(index)
    return d << (rank * (max_level - level))


def tree_depth(leaves) -> int:
    """Levels including the root (core_tree.hpp:261 semantics)."""
    return max(l for l, _ in leaves) + 1


# ---------------------------------------------------------------------------
# Rank-generic block combinators over the per-axis prolong/restrict
# operators (the Rank-templated half of mesh_prolong_restrict.hpp:40-67;
# the per-axis operators themselves are in mesh/prolong_restrict.py and
# already rank-agnostic).

def refine_cells_nd(a, rank: int = None):
    """One cell-centered block -> its 2^rank children, prolonged along
    every axis (rank-generic refine_cells_2d). Children are returned in
    child-ordinal order (bit a of the ordinal = upper half of axis a)."""
    if rank is None:
        rank = a.dim()
    full = a
    for axis in range(rank):
        full = pr.prolong_cells(full, axis)
    out = []
    for k in range(1 << rank):
        piece = full
        for axis in range(rank):
            n = piece.shape[axis] // 2
            lo = n * ((k >> axis) & 1)
            piece = pr._ax(piece, axis, slice(lo, lo + n))
        out.append(piece)
    return out


def combine_cells_nd(child_blocks, rank: int = None):
    """2^rank cell-centered children (child-ordinal order) -> one coarse
    parent block at the children's resolution, i.e. the inverse layout of
    refine_cells_nd before restriction (rank-generic combine_cells_2d)."""
    if rank is None:
        rank = (len(child_blocks) - 1).bit_length()
    assert len(child_blocks) == 1 << rank
    blocks = list(child_blocks)
    # fold one axis at a time; after each fold the surviving list is
    # re-indexed by the remaining higher ordinal bits, so the pair to
    # join is always (2i, 2i+1)
    for axis in range(rank):
        blocks = [torch.cat([blocks[2 * i], blocks[2 * i + 1]], dim=axis)
                  for i in range(len(blocks) // 2)]
    assert len(blocks) == 1
    return blocks[0]


def coarsen_cells_nd(a, rank: int = None):
    """Average-restrict a cell block along every axis (rank-generic
    coarsen_cells_2d; restrict_cells per axis)."""
    if rank is None:
        rank = a.dim()
    for axis in range(rank):
        a = pr.restrict_cells(a, axis)
    return a


def coarsen_extrinsic_nd(a, rank: int = None):
    """Sum-restrict an extrinsic (conserved-total) block along every axis
    (rank-generic restrict_extrinsic composition): the coarse sum equals
    the fine sum exactly."""
    if rank is None:
        rank = a.dim()
    for axis in range(rank):
        a = pr.restrict_extrinsic(a, axis)
    return a
