"""The port's 3D Euler solver on the octree (mara3_tpu_torch/mesh/euler3d.py)
and its blast3d subprogram against the JAX package's, on the CPU in
float64: the cases of tests/test_euler3d.py (the uniform octree against
one global grid, conservation at level jumps, positivity) on both packages,
make_advance against the JAX one, the whole run's diagnostics file by file,
the state carried across, the fault check, the command line and the plot
tool on the port's file."""

import os
import re
import subprocess
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mara3_tpu.mesh import amr3d as JM
from mara3_tpu.mesh import euler3d as JE
from mara3_tpu.mesh import tree_nd as JT
from mara3_tpu.physics import euler as JP
from mara3_tpu.subprograms import blast3d as JB
from mara3_tpu_torch.app.device import DEVICE_SELECTOR
from mara3_tpu_torch.app.driver import NonFiniteState
from mara3_tpu_torch.mesh import amr3d as TM
from mara3_tpu_torch.mesh import euler3d as TE
from mara3_tpu_torch.mesh import tree_nd as TT
from mara3_tpu_torch.physics import euler as TP
from mara3_tpu_torch.subprograms import blast3d as TB

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAMMA = 5.0 / 3.0
# the scheme against the JAX scheme, float64: they differ in the order in
# which XLA sums the 2x2 flux mean inside its jitted step (amr3d) and in
# its fused multiply-adds
SCHEME_TOL = dict(rtol=1e-13, atol=1e-15)
# whole runs' diagnostics (primitives recovered from the state): measured
# at 8.8e-16 relative after 83 steps (depth 3, block 8)
RUN_TOL = dict(rtol=1e-12, atol=1e-14)


def _pred(level, radius):
    return level == 0 or radius < 1.0 / level


def _blast_ic(xp, P_of):
    """tests/test_euler3d.py's initial state, in numpy-like `xp`."""
    def ic(X, Y, Z):
        r2 = X ** 2 + Y ** 2 + Z ** 2
        d = xp.ones_like(X)
        p = xp.where(r2 < 0.05, 10.0 + 0 * X, 0.1 + 0 * X)
        vx = 0.2 * xp.sin(np.pi * Y)
        return P_of(xp.stack([d, vx, 0.1 + 0 * X, 0 * X, p], -1))
    return ic


JIC = _blast_ic(jnp, lambda P: JP.to_conserved_density(P, GAMMA))
TIC = _blast_ic(torch, lambda P: TP.to_conserved_density(P, GAMMA))


def _mixed(depth=3):
    return (JM.BlockMesh3D.create(_pred, depth),
            TM.BlockMesh3D.create(_pred, depth))


def _dt(mesh, bs, U):
    a = float(TE.max_signal_speed(U, GAMMA))
    return 0.3 * (2.0 / (1 << int(mesh.level.max())) / bs) / a / 3


# -----------------------------------------------------------------------------
# the cases of tests/test_euler3d.py, each against the JAX package
# -----------------------------------------------------------------------------

def test_uniform_octree_matches_global_grid():
    """8 blocks of 8^3 against one periodic 16^3 block (a depth-0 mesh IS
    the global grid), 10 steps, in both packages."""
    leaves1 = TT.create_tree(lambda r, x: True, 1, 3)
    assert leaves1 == JT.create_tree(lambda r, x: True, 1, 3)
    lv1, lv0 = TM.BlockMesh3D(leaves1), TM.BlockMesh3D(
        [TT.make_index(0, 0, 0, 0)])
    u1 = TM.sample_blocks(lv1, 8, TIC)
    u0 = TM.sample_blocks(lv0, 16, TIC)
    a = float(TE.max_signal_speed(u0, GAMMA))
    assert a == float(JE.max_signal_speed(jnp.asarray(u0.numpy()), GAMMA))
    dt = 0.3 * (2.0 / 16) / a / 3
    u1 = TE.make_advance(lv1, 8, GAMMA)(u1, dt, 10)
    u0 = TE.make_advance(lv0, 16, GAMMA)(u0, dt, 10)
    glob = np.zeros((16, 16, 16, 5))
    for i, (_, (cx, cy, cz)) in enumerate(lv1.leaves):
        glob[cx * 8:cx * 8 + 8, cy * 8:cy * 8 + 8, cz * 8:cz * 8 + 8] = \
            u1[i].numpy()
    assert np.max(np.abs(glob - u0[0].numpy())) < 1e-13
    jlv0 = JM.BlockMesh3D([JT.make_index(0, 0, 0, 0)])
    want = JE.make_advance(jlv0, 16, GAMMA)(
        JM.sample_blocks(jlv0, 16, JIC), dt, 10)
    np.testing.assert_allclose(u0.numpy(), np.asarray(want), **SCHEME_TOL)


def test_make_advance_matches_jax():
    """5 steps on the depth-3 mixed octree (every face case)."""
    jm, tm = _mixed()
    bs = 8
    U0 = TM.sample_blocks(tm, bs, TIC)
    # the same state but for an ulp of a sine here and there
    np.testing.assert_allclose(
        U0.numpy(), np.asarray(JM.sample_blocks(jm, bs, JIC)), rtol=1e-15,
        atol=1e-16)
    dt = _dt(tm, bs, U0)
    want = JE.make_advance(jm, bs, GAMMA)(jnp.asarray(U0.numpy()), dt, 5)
    got = TE.make_advance(tm, bs, GAMMA)(U0, dt, 5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCHEME_TOL)
    assert float(TE.max_signal_speed(got, GAMMA)) == pytest.approx(
        float(JE.max_signal_speed(want, GAMMA)), rel=1e-13)
    # the totals, two of which cancel to round-off, at 1e-13 of the energy
    want_totals = np.asarray(JE.total_conserved(jm, bs, want))
    np.testing.assert_allclose(TE.total_conserved(tm, bs, got).numpy(),
                               want_totals, rtol=1e-13,
                               atol=1e-13 * abs(want_totals[4]))


def test_mixed_mesh_conserves_every_component():
    """25 steps across level jumps: every total to 1e-13 of the energy, in
    the port, as in the JAX package."""
    _, tm = _mixed()
    bs = 8
    U0 = TM.sample_blocks(tm, bs, TIC)
    U1 = TE.make_advance(tm, bs, GAMMA)(U0, _dt(tm, bs, U0), 25)
    t0 = TE.total_conserved(tm, bs, U0).numpy()
    t1 = TE.total_conserved(tm, bs, U1).numpy()
    assert np.isfinite(U1.numpy()).all()
    assert np.all(np.abs(t1 - t0) / abs(t0[4]) < 1e-13)


def test_blast_across_level_jumps_stays_physical():
    _, tm = _mixed()
    bs = 8
    U0 = TM.sample_blocks(tm, bs, TIC)
    U1 = TE.make_advance(tm, bs, GAMMA)(U0, _dt(tm, bs, U0), 60)
    P1 = TP.recover_primitive(U1, GAMMA)
    assert np.isfinite(U1.numpy()).all()
    assert float(P1[..., 0].min()) > 0.0   # density stays positive
    assert float(P1[..., 4].min()) > 0.0   # pressure stays positive


def test_float32_keeps_its_dtype():
    _, tm = _mixed(2)
    U = TM.sample_blocks(tm, 4, TIC, dtype=torch.float32)
    U1 = TE.make_advance(tm, 4, GAMMA)(U, 1e-3, 2)
    assert U1.dtype == torch.float32
    assert TE.total_conserved(tm, 4, U1).dtype == torch.float32


# -----------------------------------------------------------------------------
# the subprogram
# -----------------------------------------------------------------------------

ARGS = ["blast3d", "depth=3", "block_size=8", "tfinal=0.06", "dfi=0.03"]
LINE = re.compile(r"^\[(\d+)\] t=(\S+) ", re.M)


def test_main_matches_jax(tmp_path, capsys):
    """The same command line writes the same diagnostics in both packages:
    as many files, at the same times, after the same windows of steps (the
    iteration lines), each field key by key at RUN_TOL."""
    assert JB.main(ARGS + [f"outdir={tmp_path / 'j'}"]) == 0
    jax_lines = LINE.findall(capsys.readouterr().out)
    assert TB.main(ARGS + [f"outdir={tmp_path / 't'}"], device="cpu",
                   dtype=torch.float64) == 0
    assert LINE.findall(capsys.readouterr().out) == jax_lines
    assert len(jax_lines) == 2 and int(jax_lines[-1][0]) > 20
    files = sorted(os.listdir(tmp_path / "j"))
    assert files == sorted(os.listdir(tmp_path / "t"))
    assert files == [f"diagnostics.{k:04d}.h5" for k in range(3)]
    for name in files:
        with h5py.File(tmp_path / "j" / name) as fj, \
                h5py.File(tmp_path / "t" / name) as ft:
            assert set(fj) == set(ft) == {"time", "mass_density",
                                          "gas_pressure"}
            assert fj["time"][()] == ft["time"][()]
            for field in ("mass_density", "gas_pressure"):
                keys = set(fj[field])
                assert keys == set(ft[field])
                assert all(re.fullmatch(r"\d+:\d+-\d+-\d+", k) for k in keys)
                for k in keys:
                    got, want = ft[field][k][()], fj[field][k][()]
                    assert got.dtype == want.dtype == np.float64
                    np.testing.assert_allclose(got, want, **RUN_TOL)


def test_state_carried_across_from_jax():
    """The JAX package's initial Solution, as numpy arrays, becomes the
    port's; a window of steps from it on each side agrees, and the arrays
    come back as they went."""
    cfg = JB.config_template().create().update({"depth": 2,
                                                "block_size": 8})
    jmesh = JB.build_mesh(cfg)
    js = JB.new_solution(cfg, jmesh)
    arrays = {"iteration": js.iteration, "time": js.time,
              "conserved": np.asarray(js.conserved)}
    s = TB.solution_from_arrays(arrays)
    assert s.conserved.dtype == torch.float64
    back = TB.solution_to_arrays(s)
    assert back["iteration"] == 0 and back["time"] == 0.0
    np.testing.assert_array_equal(back["conserved"], arrays["conserved"])
    tmesh = TB.build_mesh(TB.config_template().create().update(
        {"depth": 2}))
    assert tmesh.leaves == jmesh.leaves
    np.testing.assert_array_equal(
        TB.new_solution(cfg, tmesh, dtype=torch.float64).conserved.numpy(),
        arrays["conserved"])
    dt = 1e-3
    want = JE.make_advance(jmesh, 8, GAMMA)(js.conserved, dt, 4)
    got = TE.make_advance(tmesh, 8, GAMMA)(s.conserved, dt, 4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCHEME_TOL)
    s32 = TB.solution_from_arrays(arrays, dtype=torch.float32)
    assert s32.conserved.dtype == torch.float32


def _poisoned(tmp_path):
    cfg, state = TB.setup(["blast3d", "depth=2", "block_size=4",
                           "tfinal=0.02", "dfi=0.01",
                           f"outdir={tmp_path}"], device="cpu")
    u = state.solution.conserved.clone()
    u[3, 1, 2, 3, 4] = float("nan")     # an energy, away from the centre
    return cfg, TB.replace(state, solution=TB.replace(state.solution,
                                                      conserved=u))


def test_non_finite_state_raises_at_a_write(tmp_path):
    """A NaN anywhere in the state, not only in the density."""
    cfg, state = _poisoned(tmp_path)
    with pytest.raises(NonFiniteState,
                       match="blast3d: the state .*iteration 0, t = 0"):
        TB.run(cfg, state)


def test_non_finite_wavespeed_raises(tmp_path):
    """With tasks that write nothing, the window's dt finds it."""
    cfg, state = _poisoned(tmp_path)
    with pytest.raises(NonFiniteState,
                       match="blast3d: the maximum wavespeed is nan"):
        TB.run(cfg, state, lambda st, cfg: st)


def test_non_finite_window_raises(tmp_path, monkeypatch):
    """A window whose advance ends in a NaN stops the run after it."""
    make = TB.euler3d.make_advance

    def poisoning(*args):
        advance = make(*args)

        def run(U, dt, steps):
            U = advance(U, dt, steps).clone()
            U[0, 0, 0, 0, 1] = float("nan")
            return U
        return run

    monkeypatch.setattr(TB.euler3d, "make_advance", poisoning)
    cfg, state = TB.setup(["blast3d", "depth=2", "block_size=4",
                           "tfinal=0.02"], device="cpu")
    with pytest.raises(NonFiniteState,
                       match="blast3d: the state .*iteration [1-9]"):
        TB.run(cfg, state, lambda st, cfg: st)


def test_run_keeps_the_dtype_and_writes_nothing_without_tasks():
    cfg, state = TB.setup(["blast3d", "depth=2", "block_size=4",
                           "tfinal=0.01"], device="cpu")
    assert state.solution.conserved.dtype == torch.float32
    final = TB.run(cfg, state, tasks=lambda st, cfg: st)
    assert final.solution.conserved.dtype == torch.float32
    # dt is frozen for the window, so the run ends at or past tfinal
    assert 0.01 <= final.solution.time < 0.02
    assert final.solution.iteration > 1


def test_cli_on_the_cpu_and_the_plot_tool(tmp_path):
    """python -m mara3_tpu_torch blast3d with the CPU selector writes
    numbered diagnostics, and tools/plot_sand3d.py --field gas_pressure
    renders the port's file (tests/test_tools.py does so for the JAX
    package's)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env[DEVICE_SELECTOR] = "cpu"
    proc = subprocess.run(
        [sys.executable, "-m", "mara3_tpu_torch", "blast3d", "depth=2",
         "block_size=8", "tfinal=0.02", "dfi=0.02", "outdir=out"],
        cwd=tmp_path, env=env, capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "kzps=" in proc.stdout and "float32" in proc.stdout
    diag = sorted((tmp_path / "out").glob("diagnostics.*.h5"))
    assert [p.name for p in diag] == ["diagnostics.0000.h5",
                                      "diagnostics.0001.h5"]
    out = subprocess.run(
        [sys.executable, os.path.join(REPO, "tools", "plot_sand3d.py"),
         "--field", "gas_pressure", str(diag[-1])],
        capture_output=True, text=True, cwd=tmp_path / "out", timeout=300)
    assert out.returncode == 0, out.stderr
    assert diag[-1].with_suffix(".png").exists()


def test_registered_with_the_cli():
    from mara3_tpu_torch.app import subprogram
    assert subprogram.registered()["blast3d"] is TB.main
