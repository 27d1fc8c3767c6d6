"""The port's AMR mesh operators (mara3_tpu_torch/mesh/prolong_restrict.py,
block_layout.py's guard_strip, extend_blocks, get_cell_block and
get_vertex_block, and mesh/regrid.py) against the JAX package's, on the CPU
in float64, bit for bit. Inputs come from numpy seeds; the trees are
amrsand's quadtrees, whose level jumps give every face case."""

import numpy as np
import pytest
import torch

from mara3_tpu.mesh import block_layout as JB
from mara3_tpu.mesh import prolong_restrict as JP
from mara3_tpu.mesh import regrid as JG
from mara3_tpu.subprograms import amrsand as JA
from mara3_tpu_torch.mesh import block_layout as TB
from mara3_tpu_torch.mesh import prolong_restrict as TP
from mara3_tpu_torch.mesh import regrid as TG

torch.set_num_threads(1)


def _tree(depth):
    return JA.build_tree(JA.config_template().create().update(
        {"depth": depth}))


def _blocks(leaves, bs, seed=0, ncomp=1):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (len(leaves), bs, bs, ncomp))


def assert_same(jax_value, torch_value):
    a, b = np.asarray(jax_value), torch_value.numpy()
    assert a.shape == b.shape and a.dtype == b.dtype
    assert np.array_equal(a, b)


# -----------------------------------------------------------------------------
# prolong_restrict
# -----------------------------------------------------------------------------

# (operator, extent): vertex data has odd extents, cell data even ones
AXIS_OPS = [("restrict_verts", 9), ("restrict_cells", 8),
            ("restrict_extrinsic", 8), ("prolong_verts", 9),
            ("prolong_cells", 8)]


@pytest.mark.parametrize("axis", [0, 1])
@pytest.mark.parametrize("name,n", AXIS_OPS)
def test_axis_operators(name, n, axis):
    a = np.random.default_rng(1).uniform(-1, 1, (n, n, 2))
    assert_same(getattr(JP, name)(a, axis),
                getattr(TP, name)(torch.as_tensor(a), axis))


@pytest.mark.parametrize("name,n", [("bisect_verts", 9),
                                    ("bisect_cells", 8)])
def test_bisect(name, n):
    a = np.random.default_rng(2).uniform(-1, 1, (n, n))
    for axis in (0, 1):
        for x, y in zip(getattr(JP, name)(a, axis),
                        getattr(TP, name)(torch.as_tensor(a), axis)):
            assert np.array_equal(np.asarray(x), y.numpy())
    wrong = n + 1
    with pytest.raises(ValueError):
        getattr(TP, name)(torch.zeros(wrong, wrong), 0)


@pytest.mark.parametrize("kind,n", [("cells", 8), ("verts", 9)])
def test_refine_combine_coarsen(kind, n):
    """refine_*_2d gives four children in the child order (x-half k & 1,
    y-half k >> 1); combine_*_2d and coarsen_*_2d as the JAX package's."""
    a = np.random.default_rng(3).uniform(-1, 1, (n, n, 3))
    kids_j = getattr(JP, f"refine_{kind}_2d")(a)
    kids_t = getattr(TP, f"refine_{kind}_2d")(torch.as_tensor(a))
    assert len(kids_t) == 4
    for x, y in zip(kids_j, kids_t):
        assert_same(x, y)
    assert_same(getattr(JP, f"combine_{kind}_2d")(
        [np.asarray(k) for k in kids_j]),
        getattr(TP, f"combine_{kind}_2d")(kids_t))
    assert_same(getattr(JP, f"coarsen_{kind}_2d")(a),
                getattr(TP, f"coarsen_{kind}_2d")(torch.as_tensor(a)))


# -----------------------------------------------------------------------------
# guard strips (any width) and the single-block fetch
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("g", [1, 2])
@pytest.mark.parametrize("axis", [0, 1])
def test_guard_strip_and_extend_blocks(g, axis):
    """On a tree with same, coarse and fine faces, two components."""
    leaves = _tree(3)
    nt = TB.build_neighbor_table(leaves)
    assert {0, 1, 2} <= set(np.unique(nt.case))
    U = _blocks(leaves, 8, seed=4, ncomp=2)
    Ut = torch.as_tensor(U)
    for side in (0, 1):
        assert_same(JB.guard_strip(U, nt, axis, side, g),
                    TB.guard_strip(Ut, nt, axis, side, g))
    assert_same(JB.extend_blocks(U, nt, axis, g),
                TB.extend_blocks(Ut, nt, axis, g))


def _three_cases(leaves):
    """A leaf, a child of a leaf and a parent of four leaves."""
    leaf_set = set(leaves)
    leaf = leaves[0]
    child = JA.tree.children(leaves[0])[3]
    parent = next(JA.tree.parent(l) for l in leaves
                  if all(c in leaf_set for c in
                         JA.tree.children(JA.tree.parent(l))))
    return leaf, child, parent


def test_get_cell_block_three_cases():
    leaves = list(_tree(3))
    U = _blocks(leaves, 8, seed=5)
    for index in _three_cases(leaves):
        assert_same(JB.get_cell_block(leaves, U, index),
                    TB.get_cell_block(leaves, torch.as_tensor(U), index))


def test_get_vertex_block_three_cases():
    leaves = list(_tree(3))
    V = JB.block_vertices(leaves, 8)
    for index in _three_cases(leaves):
        assert_same(JB.get_vertex_block(leaves, V, index),
                    TB.get_vertex_block(leaves, torch.as_tensor(V), index))


# -----------------------------------------------------------------------------
# regrid
# -----------------------------------------------------------------------------

def _blob(leaves, bs, x0=0.3):
    xc = JB.block_cell_centers(leaves, bs)
    return np.exp(-((xc[..., 0] - x0) ** 2 + xc[..., 1] ** 2)
                  / 0.025)[..., None]


def test_gradient_indicator():
    leaves = _tree(3)
    U = _blob(leaves, 8)
    dxb = JB.block_dx(leaves, 8)
    assert np.array_equal(JG.gradient_indicator(U, dxb),
                          TG.gradient_indicator(U, dxb))


@pytest.mark.parametrize("thresholds", [(0.3, 0.05), (0.1, 0.2)])
def test_propose_leaves_and_remap(thresholds):
    """The same Hilbert-ordered leaf list (refining and coarsening), and the
    state remapped onto it bit for bit."""
    leaves = list(_tree(3))
    U = _blob(leaves, 8)
    ind = JG.gradient_indicator(U, JB.block_dx(leaves, 8))
    new_j = JG.propose_leaves(leaves, ind, *thresholds, 4)
    new_t = TG.propose_leaves(leaves, ind, *thresholds, 4)
    assert new_j == new_t and new_t != leaves
    got = TG.remap_blocks(leaves, U, new_t)
    assert isinstance(got, np.ndarray)
    assert np.array_equal(np.asarray(JG.remap_blocks(leaves, U, new_j)), got)


def test_regrid_changed_flag():
    leaves = list(_tree(3))
    U = _blob(leaves, 8)
    dxb = JB.block_dx(leaves, 8)
    for kw in (dict(refine_threshold=0.3, coarsen_threshold=0.05,
                    max_level=4),
               dict(refine_threshold=1e9, coarsen_threshold=-1.0)):
        lj, bj, cj = JG.regrid(leaves, U, dxb, **kw)
        lt, bt, ct = TG.regrid(leaves, U, dxb, **kw)
        assert cj == ct and lj == lt and np.array_equal(np.asarray(bj), bt)
    assert not ct and lt == leaves
