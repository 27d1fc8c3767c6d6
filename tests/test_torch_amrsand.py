"""The port's amrsand subprogram (mara3_tpu_torch/subprograms/amrsand.py)
and kernel B6's plain version (kernels/amrsand_step.py) against the JAX
package's, on the CPU in float64: the initial state, the scheme, B6's plain
version against the JAX B6 in interpret mode, both driver loops with and
without regridding, and the state carried across. Inputs come from numpy
seeds."""

import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mara3_tpu.kernels import amrsand_step as J6
from mara3_tpu.mesh import block_layout as JB
from mara3_tpu.subprograms import amrsand as JA
from mara3_tpu_torch.app.device import resolve_auto
from mara3_tpu_torch.app.driver import NonFiniteState
from mara3_tpu_torch.kernels import amrsand_step as T6
from mara3_tpu_torch.mesh import block_layout as TB
from mara3_tpu_torch.subprograms import amrsand as TA

torch.set_num_threads(1)

# the JAX package's bar for its B6 against the scheme
# (tests/test_mesh_amr.py:268-269)
B6_TOL = dict(rtol=1e-13, atol=1e-15)
# a whole run, the port against the JAX package
RUN_TOL = dict(rtol=1e-12, atol=1e-14)


def _pair(depth, bs, seed=None):
    """(JAX solution, port solution, NeighborTable, dxb tensor, dt) at depth
    and bs, float64; with a seed each cell is scaled by 1 + 5% noise."""
    cfg = JA.config_template().create().update(
        {"depth": depth, "block_size": bs})
    js = JA.new_solution(cfg)
    u = np.asarray(js.conserved)
    if seed is not None:
        u = u * (1.0 + 0.05 * np.random.default_rng(seed).uniform(
            size=u.shape))
        js = JA.Solution(0, 0.0, js.leaves, jnp.asarray(u))
    ts = TA.solution_from_arrays({"iteration": 0, "time": 0.0,
                                  "leaves": js.leaves, "conserved": u})
    nt = TB.build_neighbor_table(ts.leaves)
    return js, ts, nt, TA.block_spacings(ts), TA.time_step(ts)


def test_new_solution():
    cfg = TA.config_template().create().update({"depth": 3,
                                                "block_size": 8})
    js = JA.new_solution(cfg)
    ts = TA.new_solution(cfg, dtype=torch.float64)
    assert ts.leaves == js.leaves and ts.iteration == 0 and ts.time == 0.0
    assert np.array_equal(ts.conserved.numpy(), np.asarray(js.conserved))
    assert TA.new_solution(cfg).conserved.dtype == torch.float32


def test_advance_matches_jax_bit_for_bit():
    """Five steps of the scheme (extend_blocks, fluxes, update) at depth
    3, bs 8, where every face case occurs: the same bits."""
    js, ts, nt, dxb, dt = _pair(3, 8, seed=0)
    assert {0, 1, 2} <= set(np.unique(nt.case))
    nt_arrays = (nt.case, nt.same_id, nt.coarse_id, nt.coarse_half,
                 nt.fine_id)
    want = js.conserved
    for _ in range(5):
        want = JA._advance(want, jnp.asarray(dxb.numpy()), nt_arrays, dt)
    got = TA.advance_n(ts.conserved, dxb, nt, dt, 5)
    assert TA.LAST_PATH == "scheme[5]"
    assert np.array_equal(got.numpy(), np.asarray(want))


def test_plain_matches_jax_kernel_in_interpret_mode():
    """B6's plain version against the JAX B6 (interpret mode), 5 steps:
    within the JAX test's bar, and in fact bit for bit."""
    js, ts, nt, dxb, dt = _pair(3, 8, seed=1)
    B = ts.conserved.shape[0]
    mats = J6.build_guard_mats(nt, 8, -(-B // 8) * 8, np.float64)
    with pltpu.force_tpu_interpret_mode():
        want = np.asarray(J6.advance_n_pallas(
            js.conserved, jnp.asarray(dxb.numpy()), mats, dt, 5,
            interpret=True))
    got = T6.advance_n_plain(ts.conserved, T6.guard_tables(nt, dxb, dt),
                             5).numpy()
    np.testing.assert_allclose(got, want, **B6_TOL)
    assert np.array_equal(got, want)


def test_plain_matches_the_scheme():
    """B6's arithmetic (u - c (2u - u_xm1 - u_ym1)) against the scheme's
    (flux differences times dt / dx), 7 steps, at the JAX package's bar."""
    _, ts, nt, dxb, dt = _pair(3, 8, seed=2)
    want = TA.advance_n(ts.conserved, dxb, nt, dt, 7)
    got = TA.advance_n(ts.conserved, dxb, nt, dt, 7, kernel=True)
    assert TA.LAST_PATH == "plain_b6[7]"
    np.testing.assert_allclose(got.numpy(), want.numpy(), **B6_TOL)


# -----------------------------------------------------------------------------
# the whole run, both loops, with and without regrids
# -----------------------------------------------------------------------------

ARGS = ["amrsand", "depth=3", "block_size=16", "tfinal=0.25", "dfi=0.1"]


def _spy(monkeypatch, module, name, record):
    """Wrap module.name so that each call's result goes to record."""
    fn = getattr(module, name)

    def spy(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.append(out)
        return out

    monkeypatch.setattr(module, name, spy)


def _run_both(tmp_path, monkeypatch, extra):
    """Runs the JAX main and the port's setup + run with the same command
    line; returns (JAX final state, port final state, JAX regrids, port
    regrids)."""
    jout, jreg, treg = [], [], []
    _spy(monkeypatch, JA, "advance_n", jout)
    _spy(monkeypatch, JA, "apply_regrid", jreg)
    _spy(monkeypatch, TA, "apply_regrid", treg)
    argv = ARGS + list(extra)
    assert JA.main(argv + [f"outdir={tmp_path / 'j'}"]) == 0
    cfg, state = TA.setup(argv + [f"outdir={tmp_path / 't'}"], device="cpu",
                          dtype=torch.float64)
    os.makedirs(tmp_path / "t")
    final = TA.run(cfg, state)
    return np.asarray(jout[-1]), final.solution, jreg, treg


def _assert_same_files(tmp_path):
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    assert files == [f"diagnostics.{k:04d}.h5" for k in range(3)]
    for name in files:
        with h5py.File(tmp_path / "j" / name) as fj, \
                h5py.File(tmp_path / "t" / name) as ft:
            assert set(fj) == set(ft) == {"time", "vertices", "conserved"}
            assert fj["time"][()] == ft["time"][()]
            for group in ("vertices", "conserved"):
                assert set(fj[group]) == set(ft[group])
                assert all(":" in k and "-" in k for k in ft[group])
                for k in fj[group]:
                    np.testing.assert_allclose(ft[group][k][()],
                                               fj[group][k][()], **RUN_TOL)


@pytest.mark.parametrize("fast_step", [0, 1])
def test_main_matches_jax(tmp_path, monkeypatch, fast_step):
    want, final, _, _ = _run_both(tmp_path, monkeypatch,
                                  [f"fast_step={fast_step}"])
    _assert_same_files(tmp_path)
    np.testing.assert_allclose(final.conserved.numpy(), want, **RUN_TOL)
    assert final.iteration == 32 and TA.LAST_PATH.startswith("scheme[")


@pytest.mark.parametrize("fast_step", [0, 1])
def test_main_with_regrid_matches_jax(tmp_path, monkeypatch, fast_step):
    """regrid=1 rgi=0.05: the same leaf sets after every regrid, and the
    same diagnostics and final state."""
    want, final, jreg, treg = _run_both(
        tmp_path, monkeypatch,
        [f"fast_step={fast_step}", "regrid=1", "rgi=0.05"])
    assert len(treg) == len(jreg) >= 4
    assert [s.leaves for s, _, _ in treg] == [s.leaves for s, _, _ in jreg]
    initial = TA.build_tree(TA.config_template().create().update(
        {"depth": 3}))
    assert treg[0][0].leaves != initial                 # the mesh changed
    _assert_same_files(tmp_path)
    np.testing.assert_allclose(final.conserved.numpy(), want, **RUN_TOL)


def test_regrid_keeps_the_kernel_tables_of_an_unchanged_tree():
    """apply_regrid that changes nothing keeps the cached B6 tables; one
    that changes the tree rebuilds them, with the new dt."""
    cfg = TA.config_template().create().update(
        {"depth": 3, "block_size": 8, "refine_threshold": 1e9,
         "coarsen_threshold": -1.0})
    s = TA.new_solution(cfg, dtype=torch.float64)
    nt = TB.build_neighbor_table(s.leaves)
    tables = TA.kernel_tables(nt, TA.block_spacings(s), TA.time_step(s))
    s2, nt2, dxb2 = TA.apply_regrid(s, cfg)
    assert s2.leaves == s.leaves
    assert TA.kernel_tables(nt2, dxb2, TA.time_step(s2)) is tables
    s3, nt3, dxb3 = TA.apply_regrid(s, cfg.update(
        {"refine_threshold": 0.3, "coarsen_threshold": 0.05}))
    assert s3.leaves != s.leaves
    t3 = TA.kernel_tables(nt3, dxb3, TA.time_step(s3))
    assert t3 is not tables and t3.faces.shape[0] == len(s3.leaves)


def test_state_carries_across_the_packages():
    """A JAX state after 4 steps, carried into the port with
    solution_from_arrays, continues as the JAX package continues; and
    solution_to_arrays gives it back."""
    js, _, nt, _, dt = _pair(3, 8)
    nt_arrays = (nt.case, nt.same_id, nt.coarse_id, nt.coarse_half,
                 nt.fine_id)
    dxb_j = jnp.asarray(JB.block_dx(js.leaves, 8))
    u = js.conserved
    for _ in range(4):
        u = JA._advance(u, dxb_j, nt_arrays, dt)
    arrays = {"iteration": 4, "time": 4 * dt, "leaves": js.leaves,
              "conserved": np.asarray(u)}
    ts = TA.solution_from_arrays(arrays)
    back = TA.solution_to_arrays(ts)
    assert back["iteration"] == 4 and back["time"] == 4 * dt
    assert [tuple(x) for x in back["leaves"]] == list(js.leaves)
    assert np.array_equal(back["conserved"], np.asarray(u))
    for _ in range(3):
        u = JA._advance(u, dxb_j, nt_arrays, dt)
    got = TA.advance_n(ts.conserved, TA.block_spacings(ts), nt, dt, 3)
    assert np.array_equal(got.numpy(), np.asarray(u))


# -----------------------------------------------------------------------------
# the port's own rules
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("fast_step", [0, 1])
def test_non_finite_state_raises(tmp_path, fast_step):
    """A NaN in the initial state stops the run at the first diagnostics
    write, naming the subprogram, the iteration and the time."""
    cfg, state = TA.setup(ARGS + [f"fast_step={fast_step}",
                                  f"outdir={tmp_path}"], device="cpu")
    u = state.solution.conserved.clone()
    u[3, 2, 1, 0] = float("nan")
    state = TA.State(TA.replace(state.solution, conserved=u),
                     state.schedule)
    with pytest.raises(NonFiniteState, match=r"amrsand.*iteration 0, t = 0"):
        TA.run(cfg, state)


def test_fast_step_resolves_by_device():
    cfg = TA.config_template().create()
    assert resolve_auto(cfg, "fast_step", "cpu") == 0
    assert resolve_auto(cfg, "fast_step", "cuda") == 1
    assert resolve_auto(cfg.update({"fast_step": 1}), "fast_step", "cpu") == 1


def test_registered_with_the_cli():
    from mara3_tpu_torch.app import subprogram
    assert subprogram.registered()["amrsand"] is TA.main
