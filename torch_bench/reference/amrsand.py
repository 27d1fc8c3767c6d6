"""The plain reference of the AMR sandbox (`amrsand`).

A scalar advected at v = (0.5, 0.5) on the periodic quadtree
(reference/mesh.py) by first-order upwind fluxes, dt = 2 / bs / 2^depth
fixed by the tree; with regridding, every `rgi` the leaves are flagged by
the largest jump of the scalar between neighbouring cells of a block over
the block's largest value (refine above refine_threshold, below max level;
coarsen a quartet whose four flags are all below coarsen_threshold), the
tree is 2:1-balanced again and the state is carried over (a leaf's cells,
its parent's cells repeated 2x2, or its children's averaged 2x2).

Written for this benchmark from the scheme's definition (Mara3's
subprog_amrsand.cpp, and the regrid the port adds beyond it); it imports
nothing of the program under test and builds its own trees.
"""

from __future__ import annotations

import numpy as np
import torch

from torch_bench.reference import mesh


def initial_leaves(p):
    """`depth` rounds refining every block whose centroid lies inside
    1 / round."""
    return mesh.build_tree(lambda r, radius: r == 0 or radius < 1.0 / r,
                           int(p["depth"]))


def gaussian(leaves, bs: int):
    """The initial blob, float64 on the host: [B, bs, bs, 1]."""
    x = mesh.cell_centres(leaves, bs)
    return np.exp(-(x[..., 0] ** 2 + x[..., 1] ** 2) / 0.025)[..., None]


def time_step(leaves, bs: int) -> float:
    return 2.0 / bs / (1 << mesh.tree_depth(leaves))


def upwind(u, nb, dx, dt):
    """One step: the flux 0.5 u of the upwind cell on every face."""
    n = u.shape[1]
    fx = 0.5 * mesh.extend(u, nb, 0)[:, :n + 1]
    fy = 0.5 * mesh.extend(u, nb, 1)[:, :, :n + 1]
    return u - ((fx[:, 1:] - fx[:, :-1]) + (fy[:, :, 1:] - fy[:, :, :-1])) \
        * dt / dx[:, None, None, None]


def indicator(blocks: np.ndarray) -> np.ndarray:
    """Per block: the largest jump between neighbouring cells over the
    largest magnitude (+1e-12)."""
    q = blocks[..., 0]
    jump = np.maximum(np.abs(np.diff(q, axis=1)).max(axis=(1, 2)),
                      np.abs(np.diff(q, axis=2)).max(axis=(1, 2)))
    return jump / (np.abs(q).max(axis=(1, 2)) + 1e-12)


def propose(leaves, flags, refine: float, coarsen: float, max_level: int):
    """The new leaves from the flags, balanced, in Hilbert order."""
    by = dict(zip(leaves, flags))
    quartets = {}
    for leaf in leaves:
        if leaf[0] > 0:
            quartets.setdefault(mesh.parent(leaf), []).append(leaf)
    new, done = set(), set()
    for node, kids in quartets.items():
        if len(kids) == 4 and all(by[k] < coarsen for k in kids):
            new.add(node)
            done.update(kids)
    for leaf in leaves:
        if leaf in done:
            continue
        if by[leaf] > refine and leaf[0] < max_level:
            new.update(mesh.children(leaf))
        else:
            new.add(leaf)
    return sorted(mesh.balance(new), key=mesh.hilbert_key)


def margin(flags, refine: float, coarsen: float) -> float:
    """The smallest distance of a flag from either threshold, relative to
    the threshold: how near the regrid came to a tie."""
    f = np.asarray(flags)
    return float(min(np.min(np.abs(f - refine)) / refine,
                     np.min(np.abs(f - coarsen)) / coarsen))


def ties(leaves, flags, refine: float, coarsen: float, max_level: int,
         tol: float = 1e-3, most: int = 4):
    """The leaf sets the regrid gives when flags within `tol` (relative)
    of a threshold are decided the other way: every subset of up to `most`
    such flags (a float32 program's flag can land on the other side)."""
    f = np.asarray(flags, dtype=np.float64)
    near = [b for b in range(len(f)) if abs(f[b] - refine) <= tol * refine
            or abs(f[b] - coarsen) <= tol * coarsen][:most]
    out = []
    for mask in range(1, 1 << len(near)):
        g = f.copy()
        for k, b in enumerate(near):
            if mask >> k & 1:
                thr = refine if abs(f[b] - refine) <= tol * refine else coarsen
                g[b] = 2 * thr - f[b] if f[b] != thr else thr * (1 + tol)
        out.append(propose(leaves, g, refine, coarsen, max_level))
    return out


class Sandbox:
    """The reference run on the device in the given dtype."""

    def __init__(self, p, device, dtype):
        self.p, self.device, self.dtype = p, device, dtype
        self.bs = int(p["block_size"])

    def run(self, leaves, u, steps: int, program_trees=None):
        """`steps` steps from (leaves, u) at t = 0, regridding as the
        configuration says. `program_trees` [(iteration, leaves)] is the
        program's tree at each chunk: where a regrid's own leaf set differs
        from the program's only by flags within a tie of a threshold, the
        reference takes the program's decision. Returns (leaves, u, trees,
        margins, mismatches, tied): the leaf set after each regrid in the
        program_trees form, each regrid's margin, the regrids whose program
        tree differs beyond a tie, and those settled as a tie."""
        p, bs = self.p, self.bs
        adaptive = int(p["regrid"]) != 0
        rgi = p["rgi"]
        t, next_regrid = 0.0, rgi
        trees, margins, mismatches, tied = [], [], 0, 0

        def tables(leaves):
            dx = torch.as_tensor(mesh.spacing(leaves, bs), dtype=self.dtype,
                                 device=self.device)
            return mesh.Neighbours(leaves, self.device), dx, \
                time_step(leaves, bs)

        def program_tree(i):
            later = [lv for it, lv in program_trees or () if it > i]
            return list(later[0]) if later else None

        nb, dx, dt = tables(leaves)
        for i in range(steps):
            if adaptive and t >= next_regrid:
                host = u.double().cpu().numpy()
                flags = indicator(host)
                args = (p["refine_threshold"], p["coarsen_threshold"])
                margins.append(margin(flags, *args))
                new = propose(leaves, flags, *args, int(p["depth"]))
                theirs = program_tree(i)
                if theirs is not None and set(theirs) != set(new):
                    if any(set(theirs) == set(alt) for alt in ties(
                            leaves, flags, *args, int(p["depth"]))):
                        new, tied = theirs, tied + 1
                    else:
                        mismatches += 1
                if new != list(leaves):
                    u = mesh.carry(leaves, torch.as_tensor(host), new).to(
                        self.device, self.dtype)
                    leaves = new
                    nb, dx, dt = tables(leaves)
                trees.append((i + 1, tuple(leaves)))
                next_regrid += rgi
            u = upwind(u, nb, dx, dt)
            t += dt
        return list(leaves), u, trees, margins, mismatches, tied
