"""The octree of the plain references: leaves, face neighbours, guard
slabs and the coarse-fine flux correction.

A leaf is (level, (i, j, k)) on the periodic [-1, 1]^3 root domain; child c
of a node adds bit a of c to its coordinate a. The tree is built by rounds
of refinement: in round r every leaf whose centroid lies less than 1 / r
from the origin (every leaf in round 0) is split into its 8 children;
then any leaf with a face neighbour two or more levels finer is split,
until none is (2:1 balance across faces, with the periodic wrap).

A block's face (axis a, side s; side 0 the low one) sees one of three
cases: a same-level neighbour, a coarser one, or four finer ones. Its
guard slab, one cell thick and n x n across, is the same-level
neighbour's face slab; the coarser neighbour's face slab restricted to the
quarter that touches this block, each cell repeated 2 x 2; or the four
finer neighbours' face slabs, each averaged over 2 x 2 cells into its
quarter. At a coarse-fine face the coarse block's face flux is replaced by
the mean of the four fine neighbours' per-area fluxes at that face, which
makes every level jump exactly conservative.

Everything is plain PyTorch and Python, written from the scheme's
definition for this benchmark; it imports nothing of the program under
test. The neighbour tables are built once, on the host, and the guard
slabs and corrections are formed for all blocks of a case at once, as
gathers on the state's device. The 2 x 2 means are torch's `mean` over
the pair axes (the program sums the four cells in a fixed order, then
divides by 4): the two differ by round-off.
"""

from __future__ import annotations

import torch


def block_extent(leaf):
    """((x0, y0, z0), width) of a leaf on the [-1, 1]^3 root domain."""
    level, coords = leaf
    w = 2.0 / (1 << level)
    return tuple(-1.0 + c * w for c in coords), w


def centroid_radius(leaf) -> float:
    x0, w = block_extent(leaf)
    return sum((x + w / 2) ** 2 for x in x0) ** 0.5


def children(leaf):
    level, coords = leaf
    return [(level + 1, tuple(2 * c + ((k >> a) & 1)
                              for a, c in enumerate(coords)))
            for k in range(8)]


def parent(leaf):
    level, coords = leaf
    return level - 1, tuple(c // 2 for c in coords)


def neighbour(leaf, axis: int, side: int):
    """The same-level node across face (axis, side), wrapping around."""
    level, coords = leaf
    c = list(coords)
    c[axis] = (c[axis] + (-1 if side == 0 else 1)) % (1 << level)
    return level, tuple(c)


def balance(leaves) -> set:
    """Split every leaf that has a face neighbour node holding a leaf two
    or more levels finer, until none has."""
    leaves = set(leaves)
    while True:
        # the nodes that hold a leaf two or more levels below them
        deep = set()
        for level, coords in leaves:
            for up in range(2, level + 1):
                deep.add((level - up, tuple(c >> up for c in coords)))
        flagged = {leaf for leaf in leaves
                   if any(neighbour(leaf, a, s) in deep
                          for a in range(3) for s in (0, 1))}
        if not flagged:
            return leaves
        for leaf in flagged:
            leaves.remove(leaf)
            leaves.update(children(leaf))


def create(depth: int) -> list:
    """The leaves of `depth` rounds of refinement toward the origin
    ("round 0 or centroid radius < 1 / round"), balanced, sorted by level
    and coordinates."""
    leaves = {(0, (0, 0, 0))}
    for rnd in range(depth):
        nxt = set()
        for leaf in leaves:
            if rnd == 0 or centroid_radius(leaf) < 1.0 / rnd:
                nxt.update(children(leaf))
            else:
                nxt.add(leaf)
        leaves = nxt
    return sorted(balance(leaves))


def cell_centres(leaves, n: int, device="cpu") -> torch.Tensor:
    """[B, n, n, n, 3] float64 cell centres of every leaf."""
    out = []
    for leaf in leaves:
        x0, w = block_extent(leaf)
        c = (torch.arange(n, dtype=torch.float64) + 0.5) * (w / n)
        axes = torch.meshgrid(x0[0] + c, x0[1] + c, x0[2] + c, indexing="ij")
        out.append(torch.stack(axes, dim=-1))
    return torch.stack(out).to(device)


def spacing(leaves, n: int) -> list:
    """Each leaf's cell size."""
    return [2.0 / (1 << level) / n for level, _ in leaves]


class Faces:
    """The face cases of a leaf set, as index tensors on `device`, for each
    (axis, side): `same` (blocks, neighbours), `coarse` (blocks, the
    coarser neighbour, the block's quarter of its face along the first and
    the second tangential axis) and `fine` (blocks, [blocks, 4] finer
    neighbours, quarter k at (k & 1, k >> 1) along the two tangential
    axes)."""

    def __init__(self, leaves, device):
        slot = {leaf: b for b, leaf in enumerate(leaves)}
        self.tables = {}
        as_t = lambda v: torch.tensor(v, dtype=torch.int64, device=device)
        for a in range(3):
            t1, t2 = [ax for ax in range(3) if ax != a]
            for s in (0, 1):
                same, coarse, fine = ([], []), ([], [], [], []), ([], [])
                for b, leaf in enumerate(leaves):
                    nb = neighbour(leaf, a, s)
                    if nb in slot:
                        same[0].append(b)
                        same[1].append(slot[nb])
                    elif parent(nb) in slot:
                        coords = leaf[1]
                        for lst, v in zip(coarse, (b, slot[parent(nb)],
                                                   coords[t1] & 1,
                                                   coords[t2] & 1)):
                            lst.append(v)
                    else:
                        # the children of nb on the face toward this block
                        kids = [0] * 4
                        for kid in children(nb):
                            _, kc = kid
                            if (kc[a] & 1) != (1 - s):
                                continue
                            q = (kc[t1] & 1) + 2 * (kc[t2] & 1)
                            kids[q] = slot[kid]   # KeyError: not balanced
                        fine[0].append(b)
                        fine[1].append(kids)
                self.tables[a, s] = {"same": tuple(map(as_t, same)),
                                     "coarse": tuple(map(as_t, coarse)),
                                     "fine": tuple(map(as_t, fine))}

    def count(self, case: str) -> int:
        """The faces of a case over every axis and side."""
        return sum(len(t[case][0]) for t in self.tables.values())

    def guard(self, P: torch.Tensor, axis: int, side: int) -> torch.Tensor:
        """[B, n, n, C]: the guard slab outside face (axis, side) of every
        block of P [B, n, n, n, C] (the two tangential axes in order)."""
        n = P.shape[1]
        h = n // 2
        # the face each neighbour presents: its high face to our low side
        face = P.select(axis + 1, n - 1 if side == 0 else 0)
        tab = self.tables[axis, side]
        g = torch.empty_like(face)
        b, nb = tab["same"]
        g[b] = face[nb]
        b, nb, q1, q2 = tab["coarse"]
        if len(b):
            quarters = face[nb].reshape(len(b), 2, h, 2, h, -1)
            q = quarters[torch.arange(len(b), device=P.device), q1, :, q2]
            g[b] = q.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
        b, kids = tab["fine"]
        if len(b):
            g[b] = self._from_fine(face, kids, n)
        return g

    @staticmethod
    def _from_fine(face, kids, n):
        """[len(kids), n, n, C]: the four finer blocks' face slabs, each
        averaged 2 x 2 into its quarter."""
        h = n // 2
        out = torch.empty(kids.shape[0], n, n, face.shape[-1],
                          dtype=face.dtype, device=face.device)
        for q in range(4):
            r = face[kids[:, q]].reshape(-1, h, 2, h, 2, face.shape[-1])
            i, j = (q & 1) * h, (q >> 1) * h
            out[:, i:i + h, j:j + h] = r.mean(dim=(2, 4))
        return out

    def correct(self, F: torch.Tensor, axis: int) -> torch.Tensor:
        """F [B, ..., n + 1 faces along axis, ..., C] with each coarse
        block's face at a level jump replaced by the mean of its four
        finer neighbours' fluxes at their face against it."""
        n = F.shape[axis + 1] - 1
        F = F.clone()
        for side in (0, 1):
            b, kids = self.tables[axis, side]["fine"]
            if not len(b):
                continue
            theirs = F.select(axis + 1, n if side == 0 else 0)
            own = F.select(axis + 1, 0 if side == 0 else n)
            own[b] = self._from_fine(theirs, kids, n)
        return F

