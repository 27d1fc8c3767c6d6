"""Host-side static quadtree: refinement, 2:1 balance, Hilbert ordering.

Re-design of the reference's immutable 2^Rank-ary tree (src/core_tree.hpp)
and its mesh builders (src/mesh_tree_operators.hpp:90-198). The tree here is
simply the *set of leaf indices* (level, i, j) partitioning the unit square
with wrap-around topology (the reference's next_on/prev_on,
core_tree.hpp:203-204): that is all the device layout needs, and it runs
once at setup time — the mesh is static during a run, exactly as in the
reference's workloads.

The Hilbert linearization maps each leaf to its position along a space-
filling curve at its own level for locality-preserving block->device
assignment. (The reference's hilbert_index passes `level` where the curve
order 2^level belongs, core_tree.hpp:1033-1066 vs. the cited Wikipedia
routine; this implementation uses the standard curve.)
"""

from __future__ import annotations

from typing import Callable, List, Set, Tuple

TreeIndex = Tuple[int, int, int]  # (level, i, j)


def block_extent(index: TreeIndex, domain_x0=(-1.0, -1.0), domain_size=2.0):
    """(x0, y0, width) of the block on the [-1,1]^2 root domain (the
    reference roots its vertex quadtree there, mesh_tree_operators.hpp:171)."""
    level, i, j = index
    w = domain_size / (1 << level)
    return (domain_x0[0] + i * w, domain_x0[1] + j * w, w)


def centroid_radius(index: TreeIndex) -> float:
    x0, y0, w = block_extent(index)
    cx, cy = x0 + w / 2, y0 + w / 2
    return (cx * cx + cy * cy) ** 0.5


def children(index: TreeIndex) -> List[TreeIndex]:
    """Child k covers (x-half k&1, y-half k>>1) (core_tree.hpp:156-158)."""
    level, i, j = index
    return [(level + 1, 2 * i + (k & 1), 2 * j + (k >> 1)) for k in range(4)]


def parent(index: TreeIndex) -> TreeIndex:
    level, i, j = index
    return (level - 1, i // 2, j // 2)


def neighbor(index: TreeIndex, axis: int, side: int) -> TreeIndex:
    """Same-level neighbor with wrap-around (core_tree.hpp:203-204);
    side 0 = prev (lower), side 1 = next (upper)."""
    level, i, j = index
    n = 1 << level
    d = -1 if side == 0 else 1
    if axis == 0:
        return (level, (i + d) % n, j)
    return (level, i, (j + d) % n)


def is_inside(leaf: TreeIndex, node: TreeIndex) -> bool:
    """True if `leaf` is a strict or equal descendant of `node`."""
    ll, li, lj = leaf
    nl, ni, nj = node
    if ll < nl:
        return False
    shift = ll - nl
    return (li >> shift, lj >> shift) == (ni, nj)


def create_quadtree(predicate: Callable[[int, float], bool],
                    depth: int) -> List[TreeIndex]:
    """Leaves of a 2:1-balanced quadtree: starting from the root block,
    `depth` rounds of conditional refinement by predicate(round, centroid
    radius), then balancing (reference create_vertex_quadtree,
    mesh_tree_operators.hpp:158-198). Returns leaves in Hilbert order."""
    leaves: Set[TreeIndex] = {(0, 0, 0)}
    for rnd in range(depth):
        next_leaves: Set[TreeIndex] = set()
        for leaf in leaves:
            if predicate(rnd, centroid_radius(leaf)):
                next_leaves.update(children(leaf))
            else:
                next_leaves.add(leaf)
        leaves = next_leaves
    leaves = ensure_valid_quadtree(leaves)
    return sorted(leaves, key=hilbert_key)


def over_refined_neighbors(leaves: Set[TreeIndex]) -> Set[TreeIndex]:
    """Leaves with a neighbor subtree more than one level deeper
    (reference over_refined_neighbors, mesh_tree_operators.hpp:90-101)."""
    max_level = max(l for l, _, _ in leaves)
    flagged = set()
    for leaf in leaves:
        level = leaf[0]
        if max_level <= level + 1:
            continue
        for axis in (0, 1):
            for side in (0, 1):
                node = neighbor(leaf, axis, side)
                if any(other[0] >= level + 2 and is_inside(other, node)
                       for other in leaves):
                    flagged.add(leaf)
    return flagged


def ensure_valid_quadtree(leaves: Set[TreeIndex]) -> Set[TreeIndex]:
    """Refine until 2:1 balanced (mesh_tree_operators.hpp:115-139)."""
    leaves = set(leaves)
    while True:
        flagged = over_refined_neighbors(leaves)
        if not flagged:
            return leaves
        for leaf in flagged:
            leaves.remove(leaf)
            leaves.update(children(leaf))


def hilbert_index(index: TreeIndex) -> int:
    """Position of the block along the Hilbert curve of order 2^level
    (standard xy2d routine; cf. core_tree.hpp:1033-1066)."""
    level, x, y = index
    n = 1 << level
    d = 0
    s = n // 2
    while s > 0:
        rx = 1 if (x & s) > 0 else 0
        ry = 1 if (y & s) > 0 else 0
        d += s * s * ((3 * rx) ^ ry)
        # rotate
        if ry == 0:
            if rx == 1:
                x = s - 1 - x
                y = s - 1 - y
            x, y = y, x
        s //= 2
    return d


def hilbert_key(index: TreeIndex):
    """Sort key interleaving levels so that a leaf sorts where its region
    lies on the finest curve: scale the index to a common curve length."""
    level, _, _ = index
    max_level = 30
    return hilbert_index(index) << (2 * (max_level - level))


def tree_depth(leaves) -> int:
    """Number of levels including the root (reference tree depth semantics,
    core_tree.hpp:261: a lone root has depth 1)."""
    return max(l for l, _, _ in leaves) + 1
