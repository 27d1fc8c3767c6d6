"""The quadtree of the plain references: leaves, neighbours, guard cells.

A leaf is (level, i, j) on the periodic [-1, 1]^2 root domain; child k of a
node covers the (x-half k & 1, y-half k >> 1) quadrant. A face sees one of
three cases in a 2:1-balanced tree: a same-level neighbour (its edge row),
a coarser one (the matching half of its edge, each cell repeated twice) or
two finer ones (their two edge rows averaged 2x2). Everything here is plain
PyTorch and numpy, written from the mesh's definition for this benchmark;
it imports nothing of the program under test.
"""

from __future__ import annotations

import numpy as np
import torch


def block_extent(leaf):
    """(x0, y0, width) of a leaf on the [-1, 1]^2 root domain."""
    level, i, j = leaf
    w = 2.0 / (1 << level)
    return -1.0 + i * w, -1.0 + j * w, w


def centroid_radius(leaf) -> float:
    x0, y0, w = block_extent(leaf)
    return float(np.hypot(x0 + w / 2, y0 + w / 2))


def children(leaf):
    level, i, j = leaf
    return [(level + 1, 2 * i + (k & 1), 2 * j + (k >> 1)) for k in range(4)]


def parent(leaf):
    level, i, j = leaf
    return level - 1, i // 2, j // 2


def neighbour(leaf, axis: int, side: int):
    """The same-level node across face (axis, side), wrapping around."""
    level, i, j = leaf
    n, d = 1 << level, (-1 if side == 0 else 1)
    return (level, (i + d) % n, j) if axis == 0 else (level, i, (j + d) % n)


def _inside(leaf, node) -> bool:
    shift = leaf[0] - node[0]
    return shift >= 0 and (leaf[1] >> shift, leaf[2] >> shift) == node[1:]


def balance(leaves) -> set:
    """Refine every leaf that has a neighbour two or more levels finer,
    until none has."""
    leaves = set(leaves)
    while True:
        deep = max(leaf[0] for leaf in leaves)
        flagged = {
            leaf for leaf in leaves if deep > leaf[0] + 1 and any(
                other[0] >= leaf[0] + 2 and _inside(other, neighbour(leaf, a, s))
                for a in (0, 1) for s in (0, 1) for other in leaves)}
        if not flagged:
            return leaves
        for leaf in flagged:
            leaves.remove(leaf)
            leaves.update(children(leaf))


def hilbert_key(leaf):
    """A leaf's place along the Hilbert curve of the finest level."""
    level, x, y = leaf
    d, s = 0, (1 << level) // 2
    while s > 0:
        rx, ry = int(x & s > 0), int(y & s > 0)
        d += s * s * ((3 * rx) ^ ry)
        if ry == 0:
            if rx == 1:
                x, y = s - 1 - x, s - 1 - y
            x, y = y, x
        s //= 2
    return d << (2 * (30 - level))


def build_tree(predicate, rounds: int):
    """`rounds` rounds of refinement of the root by predicate(round,
    centroid radius), balanced, in Hilbert order."""
    leaves = {(0, 0, 0)}
    for r in range(rounds):
        nxt = set()
        for leaf in leaves:
            nxt.update(children(leaf) if predicate(r, centroid_radius(leaf))
                       else [leaf])
        leaves = nxt
    return sorted(balance(leaves), key=hilbert_key)


def tree_depth(leaves) -> int:
    """Levels counting the root (a lone root has depth 1)."""
    return max(leaf[0] for leaf in leaves) + 1


def cell_centres(leaves, bs: int) -> np.ndarray:
    """[B, bs, bs, 2] float64 cell centres."""
    out = np.empty((len(leaves), bs, bs, 2))
    for b, leaf in enumerate(leaves):
        x0, y0, w = block_extent(leaf)
        c = (np.arange(bs) + 0.5) * (w / bs)
        out[b, :, :, 0] = x0 + c[:, None]
        out[b, :, :, 1] = y0 + c[None, :]
    return out


def face_centres(leaves, bs: int, axis: int) -> np.ndarray:
    """Centres of the faces normal to `axis`: [B, bs+1, bs, 2] (axis 0) or
    [B, bs, bs+1, 2] (axis 1), float64."""
    shape = (bs + 1, bs) if axis == 0 else (bs, bs + 1)
    out = np.empty((len(leaves),) + shape + (2,))
    for b, leaf in enumerate(leaves):
        x0, y0, w = block_extent(leaf)
        h = w / bs
        on = np.arange(bs + 1) * h
        mid = (np.arange(bs) + 0.5) * h
        xs, ys = (on, mid) if axis == 0 else (mid, on)
        out[b, ..., 0] = x0 + xs[:, None]
        out[b, ..., 1] = y0 + ys[None, :]
    return out


def spacing(leaves, bs: int) -> np.ndarray:
    """[B] cell width of each leaf."""
    return np.array([block_extent(leaf)[2] / bs for leaf in leaves])


class Neighbours:
    """Per leaf and face (0 x-lo, 1 x-hi, 2 y-lo, 3 y-hi): the case (0 same
    level, 1 coarser, 2 finer) and the neighbour's block ids, as int64
    tensors on `device`."""

    def __init__(self, leaves, device):
        index = {leaf: b for b, leaf in enumerate(leaves)}
        B = len(leaves)
        case = np.zeros((B, 4), np.int64)
        same = np.zeros((B, 4), np.int64)
        coarse = np.zeros((B, 4), np.int64)
        half = np.zeros((B, 4), np.int64)
        fine = np.zeros((B, 4, 2), np.int64)
        for b, leaf in enumerate(leaves):
            for axis in (0, 1):
                for side in (0, 1):
                    f, n = 2 * axis + side, neighbour(leaf, axis, side)
                    if n in index:
                        same[b, f] = index[n]
                    elif leaf[0] > 0 and parent(n) in index:
                        case[b, f] = 1
                        coarse[b, f] = index[parent(n)]
                        half[b, f] = (leaf[2] if axis == 0 else leaf[1]) & 1
                    else:
                        kids = children(n)
                        pair = ((1, 3), (0, 2)) if axis == 0 else ((2, 3), (0, 1))
                        case[b, f] = 2
                        fine[b, f] = [index[kids[k]] for k in pair[side]]
        t = lambda a: torch.as_tensor(a, device=device)
        self.case, self.same, self.coarse = t(case), t(same), t(coarse)
        self.half, self.fine = t(half), t(fine)


def _rows(u, axis: int, start: int, width: int):
    return u.narrow(1 + axis, start, width)


def _pair_mean(a, axis: int):
    """Mean of adjacent pairs along `axis`."""
    return 0.5 * a.unfold(axis, 2, 2).sum(-1)


def guard(u, nb: Neighbours, axis: int, side: int):
    """The one-cell guard strip outside face (axis, side) of every block of
    u [B, bs, bs, C]: [B, 1, bs, C] for axis 0, [B, bs, 1, C] for axis 1."""
    f = 2 * axis + side
    bs = u.shape[1]
    perp = 1 - axis
    edge = _rows(u, axis, bs - 1 if side == 0 else 0, 1)  # facing row
    same = edge[nb.same[:, f]]
    # coarser: our half of its edge, each cell twice
    c = edge[nb.coarse[:, f]]
    lo, hi = c.narrow(1 + perp, 0, bs // 2), c.narrow(1 + perp, bs // 2, bs // 2)
    pick = nb.half[:, f].view(-1, 1, 1, 1)
    coarse = torch.repeat_interleave(torch.where(pick == 0, lo, hi), 2,
                                     dim=1 + perp)
    # finer: the two neighbours' two facing rows, averaged 2x2
    two = _rows(u, axis, 0 if side == 1 else bs - 2, 2)
    parts = []
    for k in (0, 1):
        rows = _pair_mean(two[nb.fine[:, f, k]], 1 + axis)   # across the face
        parts.append(_pair_mean(rows, 1 + perp))             # along it
    fine = torch.cat(parts, dim=1 + perp)
    case = nb.case[:, f].view(-1, 1, 1, 1)
    return torch.where(case == 0, same, torch.where(case == 1, coarse, fine))


def extend(u, nb: Neighbours, axis: int):
    """u with one guard cell on both sides of `axis`."""
    return torch.cat([guard(u, nb, axis, 0), u, guard(u, nb, axis, 1)],
                     dim=1 + axis)


# -- the remap of a regrid: one node's cells at its own resolution -----------

def refine_block(a):
    """A block's four children, each cell repeated 2x2."""
    p = torch.repeat_interleave(torch.repeat_interleave(a, 2, 0), 2, 1)
    n = a.shape[0]
    return [p[(k & 1) * n:(k & 1) * n + n, (k >> 1) * n:(k >> 1) * n + n]
            for k in range(4)]


def coarsen_blocks(kids):
    """Four children combined and averaged 2x2."""
    top = torch.cat([kids[0], kids[1]], 0)
    bottom = torch.cat([kids[2], kids[3]], 0)
    a = torch.cat([top, bottom], 1)
    a = 0.5 * (a[0::2] + a[1::2])
    return 0.5 * (a[:, 0::2] + a[:, 1::2])


def carry(leaves, blocks, targets):
    """The cells of each node of `targets` at its own resolution from the
    state `blocks` on `leaves`: the leaf itself, the cells of the leaf above
    it repeated 2x2 for each level between, or the leaves below it averaged
    2x2 for each level between."""
    index = {leaf: b for b, leaf in enumerate(leaves)}

    def cells(node):
        if node in index:
            return blocks[index[node]]
        above = node
        while above[0] > 0 and above not in index:
            above = parent(above)
        if above not in index:
            return coarsen_blocks([cells(c) for c in children(node)])
        a = blocks[index[above]]
        for level in range(above[0] + 1, node[0] + 1):
            shift = node[0] - level
            a = refine_block(a)[((node[1] >> shift) & 1)
                                + 2 * ((node[2] >> shift) & 1)]
        return a

    return torch.stack([cells(tuple(node)) for node in targets])
