"""The port's 3D AMR sandbox (mara3_tpu_torch/mesh/tree_nd.py,
mesh/amr3d.py, kernels/sand3d_step.py, subprograms/sand3d.py) against the
JAX package's, on the CPU: the rank-generic tree, the octree's neighbor
tables, the guard exchange, the conservative scheme, kernel B7's plain
version against the JAX B7 in interpret mode (float64 and float32), the
whole run, and the `kernel` key's meanings. Inputs come from numpy seeds."""

import os
from contextlib import contextmanager

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mara3_tpu.kernels import sand3d_step as J7
from mara3_tpu.mesh import amr3d as JM
from mara3_tpu.mesh import tree_nd as JT
from mara3_tpu.subprograms import sand3d as JS
from mara3_tpu_torch.app.driver import NonFiniteState
from mara3_tpu_torch.kernels import sand3d_step as T7
from mara3_tpu_torch.mesh import amr3d as TM
from mara3_tpu_torch.mesh import tree_nd as TT
from mara3_tpu_torch.subprograms import sand3d as TS

torch.set_num_threads(1)

# the JAX package's bars for its B7 against the scheme, times max |u|
# (tests/test_sand3d_kernel.py:55-56)
B7_BAR = {np.float64: 1e-13, np.float32: 5e-6}
# the scheme against the JAX scheme, float64: they differ only in the order
# in which XLA sums a 2x2 flux mean inside the jitted step
SCHEME_TOL = dict(rtol=1e-13, atol=1e-15)
RUN_TOL = dict(rtol=1e-12, atol=1e-14)
V = (0.5, 0.3, 0.7)


def _pred(level, radius):
    return level == 0 or radius < 1.0 / level


@contextmanager
def _x64(on: bool):
    """The float32 cases run the JAX side with x64 off, as its own tests
    do, so its weak-typed constants stay float32."""
    old = jax.config.jax_enable_x64
    jax.config.update("jax_enable_x64", on)
    try:
        yield
    finally:
        jax.config.update("jax_enable_x64", old)


def _meshes(depth=3):
    return (JM.BlockMesh3D.create(_pred, depth),
            TM.BlockMesh3D.create(_pred, depth))


def _state(mesh, bs, seed=0):
    rng = np.random.default_rng(seed)
    return rng.uniform(0.5, 1.5, (len(mesh.leaves), bs, bs, bs))


# -----------------------------------------------------------------------------
# tree_nd and the octree's tables
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("rank", [2, 3])
def test_create_tree(rank):
    depth = 4 if rank == 2 else 3
    leaves = TT.create_tree(_pred, depth, rank)
    assert leaves == JT.create_tree(_pred, depth, rank)
    assert TT.tree_depth(leaves) == JT.tree_depth(leaves)
    assert [TT.curve_key(l) for l in leaves] == \
        [JT.curve_key(l) for l in leaves]


def test_index_functions():
    idx = TT.make_index(3, 5, 2, 7)
    assert idx == JT.make_index(3, 5, 2, 7) and TT.rank_of(idx) == 3
    assert TT.valid(idx) and not TT.valid((2, (4, 0, 0)))
    assert TT.children(idx) == JT.children(idx)
    assert TT.parent(idx) == JT.parent(idx)
    for axis in range(3):
        for side in (0, 1):
            assert TT.neighbor(idx, axis, side) == \
                JT.neighbor(idx, axis, side)
    assert TT.morton_index(idx) == JT.morton_index(idx)
    assert TT.block_extent(idx) == JT.block_extent(idx)
    assert TT.centroid_radius(idx) == JT.centroid_radius(idx)
    assert TT.is_inside(TT.children(idx)[6], idx)
    assert not TT.is_inside(TT.parent(idx), idx)


@pytest.mark.parametrize("rank", [2, 3])
def test_block_combinators(rank):
    a = np.random.default_rng(1).uniform(-1, 1, (8,) * rank)
    kids_j = JT.refine_cells_nd(a)
    kids_t = TT.refine_cells_nd(torch.as_tensor(a))
    assert len(kids_t) == 1 << rank
    for x, y in zip(kids_j, kids_t):
        assert np.array_equal(np.asarray(x), y.numpy())
    assert np.array_equal(np.asarray(JT.combine_cells_nd(kids_j)),
                          TT.combine_cells_nd(kids_t).numpy())
    for name in ("coarsen_cells_nd", "coarsen_extrinsic_nd"):
        assert np.array_equal(np.asarray(getattr(JT, name)(a)),
                              getattr(TT, name)(torch.as_tensor(a)).numpy())


def test_block_mesh_tables():
    jm, tm = _meshes()
    assert tm.leaves == jm.leaves
    for k in ("case", "same_id", "coarse_id", "tq1", "tq2", "fine_id",
              "level"):
        assert np.array_equal(getattr(tm, k), getattr(jm, k)), k
    assert set(np.unique(tm.case)) == {0, 1, 2}


# -----------------------------------------------------------------------------
# the scheme
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("side", [0, 1])
@pytest.mark.parametrize("axis", [0, 1, 2])
def test_guard_bit_for_bit(axis, side):
    jm, tm = _meshes()
    u = _state(jm, 8)
    assert np.array_equal(np.asarray(JM._guard(jnp.asarray(u), jm, axis,
                                                side)),
                          TM._guard(torch.as_tensor(u), tm, axis,
                                    side).numpy())


def test_guard_carries_components():
    jm, tm = _meshes()
    u = np.random.default_rng(2).uniform(size=(len(jm.leaves), 8, 8, 8, 2))
    assert np.array_equal(np.asarray(JM._guard(jnp.asarray(u), jm, 2, 0)),
                          TM._guard(torch.as_tensor(u), tm, 2, 0).numpy())


def test_make_advance_matches_jax():
    """5 steps at v = (0.5, 0.3, 0.7) with every face case, float64, and
    mass conserved to round-off."""
    jm, tm = _meshes()
    bs = 8
    u = _state(jm, bs, seed=3)
    dt = 0.25 * (2.0 / (1 << 3) / bs) / sum(V)
    want = np.asarray(JM.make_advance(jm, bs, V)(jnp.asarray(u), dt, 5))
    got = TM.make_advance(tm, bs, V)(torch.as_tensor(u), dt, 5)
    np.testing.assert_allclose(got.numpy(), want, **SCHEME_TOL)
    m0 = float(TM.total_mass(tm, bs, torch.as_tensor(u)))
    assert abs(float(TM.total_mass(tm, bs, got)) - m0) <= 1e-14 * m0
    assert float(TM.total_mass(tm, bs, torch.as_tensor(u))) == \
        pytest.approx(float(JM.total_mass(jm, bs, jnp.asarray(u))),
                      rel=1e-15)


def _b7_both(dtype, steps=5, bs=8):
    """(JAX B7 in interpret mode, the port's B7 plain version, the port's
    scheme, max |u|) on seeded input at v = (0.5, 0.3, 0.7)."""
    jm, tm = _meshes()
    u = _state(jm, bs, seed=4).astype(dtype)
    dxb = np.asarray(2.0 / (1 << jm.level) / bs, np.float64)
    dt = dtype(0.25 * dxb.min() / sum(V))
    with _x64(dtype == np.float64):
        B = u.shape[0]
        ops = J7.build_guard_ops(jm, bs, -(-B // 128) * 128, dtype)
        want = np.asarray(J7.advance_n_pallas(
            jnp.asarray(u), dxb.astype(dtype), ops, np.asarray(V, dtype),
            dt, steps, interpret=True))
    ut = torch.as_tensor(u)
    tables = T7.guard_tables(tm, torch.as_tensor(dxb).to(ut.dtype), V,
                             float(dt))
    got = T7.advance_n_plain(ut, tables, steps).numpy()
    scheme = TM.make_advance(tm, bs, V)(ut, float(dt), steps).numpy()
    return want, got, scheme, float(np.abs(u).max())


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_plain_matches_jax_kernel_in_interpret_mode(dtype):
    """B7's plain version against the JAX B7, at the JAX test's bars (the
    fine guard's four 0.25 terms are summed in another order than the
    TPU's one-hot product sums them, so not bit for bit)."""
    want, got, _, scale = _b7_both(dtype)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=0, atol=B7_BAR[dtype] * scale)


@pytest.mark.parametrize("dtype", [np.float64, np.float32],
                         ids=["f64", "f32"])
def test_plain_matches_the_scheme(dtype):
    """For v > 0 the flux correction is a no-op: B7's plain version
    matches the port's full scheme at the same bars."""
    _, got, scheme, scale = _b7_both(dtype)
    np.testing.assert_allclose(got, scheme, rtol=0,
                               atol=B7_BAR[dtype] * scale)


# -----------------------------------------------------------------------------
# the whole run and the kernel key
# -----------------------------------------------------------------------------

ARGS = ["sand3d", "depth=3", "block_size=8", "tfinal=0.1", "dfi=0.05"]


@pytest.mark.parametrize("kernel", [0, 2])
def test_main_matches_jax(tmp_path, kernel):
    """The same command line writes the same diagnostics ("level:i-j-k"
    trees) in both packages. kernel=0 runs the scheme in float64; kernel=2
    the interpret-mode B7 in the JAX package, which casts the state to
    float32 at its first advance (its first file is float64), and B7's
    plain version in the port, given float32 (the port keeps the dtype it
    is given), held at the JAX B7 test's float32 bar."""
    argv = ARGS + [f"kernel={kernel}"]
    dtype = torch.float64 if kernel == 0 else torch.float32
    assert JS.main(argv + [f"outdir={tmp_path / 'j'}"]) == 0
    assert TS.main(argv + [f"outdir={tmp_path / 't'}"], device="cpu",
                   dtype=dtype) == 0
    assert TS.LAST_PATH == ("scheme[5]" if kernel == 0 else "plain_b7[5]")
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    assert files == [f"diagnostics.{k:04d}.h5" for k in range(3)]
    for name in files:
        with h5py.File(tmp_path / "j" / name) as fj, \
                h5py.File(tmp_path / "t" / name) as ft:
            assert fj["time"][()] == ft["time"][()]
            keys = set(fj["conserved"])
            assert keys == set(ft["conserved"])
            assert all(k.count("-") == 2 for k in keys)
            want = {k: fj["conserved"][k][()] for k in keys}
            tol = RUN_TOL if kernel == 0 else dict(
                rtol=0, atol=B7_BAR[np.float32] * max(
                    float(np.abs(w).max()) for w in want.values()))
            for k in keys:
                got = ft["conserved"][k][()]
                assert kernel or got.dtype == want[k].dtype
                np.testing.assert_allclose(got, want[k], **tol)


@pytest.mark.parametrize("kernel,path", [(-1, "scheme"), (0, "scheme"),
                                         (1, "plain_b7"), (2, "plain_b7")])
def test_kernel_key_on_the_cpu(kernel, path):
    cfg, state = TS.setup(ARGS + [f"kernel={kernel}", "tfinal=0.02"],
                          device="cpu", dtype=torch.float64)
    final = TS.run(cfg, state, tasks=lambda st, cfg: st)
    assert TS.LAST_PATH == f"{path}[2]" and final.solution.iteration == 2
    assert final.solution.conserved.dtype == torch.float64


def test_kernel_key_rules():
    """kernel=2 has no meaning on a card; B7 needs every velocity above 0
    (kernel=-1 then takes the scheme); an unknown value raises."""
    assert TS.uses_kernel(-1, "cuda", (0.5, 0.5, 0.5))
    assert not TS.uses_kernel(-1, "cuda", (0.5, 0.0, 0.5))
    assert not TS.uses_kernel(0, "cuda", (0.5, 0.5, 0.5))
    with pytest.raises(ValueError, match="interpret"):
        TS.uses_kernel(2, "cuda", (0.5, 0.5, 0.5))
    with pytest.raises(ValueError, match="above 0"):
        TS.uses_kernel(1, "cpu", (0.5, -0.5, 0.5))
    with pytest.raises(ValueError, match="one of"):
        TS.uses_kernel(3, "cpu", (0.5, 0.5, 0.5))


def test_dtype_is_kept():
    """No silent cast to float32: the plain B7 runs in float64 when the
    state is float64, and float32 is the default."""
    cfg, state = TS.setup(ARGS + ["kernel=1", "tfinal=0.01"], device="cpu")
    assert state.solution.conserved.dtype == torch.float32
    final = TS.run(cfg, state, tasks=lambda st, cfg: st)
    assert final.solution.conserved.dtype == torch.float32


def test_non_finite_state_raises(tmp_path):
    cfg, state = TS.setup(ARGS + [f"outdir={tmp_path}"], device="cpu")
    u = state.solution.conserved.clone()
    u[5, 1, 2, 3] = float("inf")
    state = TS.replace(state, solution=TS.replace(state.solution,
                                                  conserved=u))
    with pytest.raises(NonFiniteState, match=r"sand3d.*iteration 0, t = 0"):
        TS.run(cfg, state)


def test_registered_with_the_cli():
    from mara3_tpu_torch.app import subprogram
    assert subprogram.registered()["sand3d"] is TS.main
