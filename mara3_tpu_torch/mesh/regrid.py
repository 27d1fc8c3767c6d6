"""Adaptive regridding: data-driven refinement of the static block layout.

Port of mara3_tpu/mesh/regrid.py. The reference's trees never adapt during
a run; this module goes beyond it: periodically rebuild the leaf set from a
per-block indicator and remap the state between layouts. It runs on the
host, on numpy, between chunks: the mesh is static between regrids, and a
regrid changes the block count (so the device tables are rebuilt). The
remap goes through block_layout.get_cell_block.

Flagging policy (conventional Loehner-style):
- refine a leaf when indicator > refine_threshold (and level < max_level)
- coarsen a sibling quartet when all four flag below coarsen_threshold
- 2:1 balance re-enforced afterwards (tree.ensure_valid_quadtree)
"""

from __future__ import annotations

from typing import Callable, Dict, List, Sequence, Tuple

import numpy as np
import torch

from mara3_tpu_torch.mesh import tree as treemod
from mara3_tpu_torch.mesh.tree import TreeIndex


def gradient_indicator(blocks: np.ndarray, dxb: np.ndarray) -> np.ndarray:
    """Default refinement indicator: max normalized gradient magnitude of
    component 0 per block. blocks [B, bs, bs, C], dxb [B]; returns [B]."""
    q = np.asarray(blocks)[..., 0]
    gx = np.abs(np.diff(q, axis=1)).max(axis=(1, 2))
    gy = np.abs(np.diff(q, axis=2)).max(axis=(1, 2))
    scale = np.abs(q).max(axis=(1, 2)) + 1e-12
    return np.maximum(gx, gy) / scale


def propose_leaves(leaves: Sequence[TreeIndex], indicator: np.ndarray,
                   refine_threshold: float, coarsen_threshold: float,
                   max_level: int) -> List[TreeIndex]:
    """New Hilbert-ordered leaf set from per-block indicator values."""
    leaves = list(leaves)
    flags: Dict[TreeIndex, float] = {leaf: float(v)
                                     for leaf, v in zip(leaves, indicator)}
    new: set = set()
    handled: set = set()

    # coarsening: a full sibling quartet, all below threshold
    by_parent: Dict[TreeIndex, List[TreeIndex]] = {}
    for leaf in leaves:
        if leaf[0] > 0:
            by_parent.setdefault(treemod.parent(leaf), []).append(leaf)
    for parent, kids in by_parent.items():
        if len(kids) == 4 and all(flags[k] < coarsen_threshold
                                  for k in kids):
            new.add(parent)
            handled.update(kids)

    for leaf in leaves:
        if leaf in handled:
            continue
        if flags[leaf] > refine_threshold and leaf[0] < max_level:
            new.update(treemod.children(leaf))
        else:
            new.add(leaf)

    balanced = treemod.ensure_valid_quadtree(new)
    return sorted(balanced, key=treemod.hilbert_key)


def remap_blocks(old_leaves: Sequence[TreeIndex], old_blocks,
                 new_leaves: Sequence[TreeIndex]) -> np.ndarray:
    """State on the new layout: per new leaf, the leaf itself, a refined
    quadrant of its old parent, or its coarsened old children (exactly the
    get_cell_block fetch, now level-shifted at most by one)."""
    from mara3_tpu_torch.mesh.block_layout import get_cell_block

    old = torch.as_tensor(np.asarray(old_blocks))
    old_leaves = list(old_leaves)
    return torch.stack([get_cell_block(old_leaves, old, leaf)
                        for leaf in new_leaves]).numpy()


def regrid(leaves: Sequence[TreeIndex], blocks, dxb,
           indicator_fn: Callable = gradient_indicator,
           refine_threshold: float = 0.3,
           coarsen_threshold: float = 0.05,
           max_level: int = 10) -> Tuple[List[TreeIndex], np.ndarray, bool]:
    """One regrid cycle. Returns (new_leaves, new_blocks, changed)."""
    indicator = indicator_fn(blocks, np.asarray(dxb))
    new_leaves = propose_leaves(leaves, indicator, refine_threshold,
                                coarsen_threshold, max_level)
    if list(new_leaves) == list(leaves):
        return list(leaves), np.asarray(blocks), False
    return new_leaves, remap_blocks(leaves, blocks, new_leaves), True
