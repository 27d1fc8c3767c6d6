"""The port's kh subprogram (mara3_tpu_torch/subprograms/kh.py) and the
modules it runs (schemes/iso2d_grid.py, kernels/iso2d_step.py) against the
JAX package's, on the CPU in float64: the scheme, kernel B1's plain version
(against the JAX B1 in interpret mode and against the JAX scheme), the
initial state and dt, the CLI's files, restarts across the two packages and
the device rules. Inputs come from numpy seeds."""

import os
import shutil
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mara3_tpu.kernels import iso2d_step_v5 as JK5
from mara3_tpu.schemes import iso2d_grid as JG
from mara3_tpu.subprograms import kh as JKH
from mara3_tpu_torch.app.device import DEVICE_SELECTOR
from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.schemes import iso2d_grid as TG
from mara3_tpu_torch.subprograms import kh as TKH

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the scheme and B1's plain version against the JAX scheme: the same
# formulas in another rounding order (B1 folds 0.5 * theta into its slopes
# and updates by * dt/dx), so round-off apart
SCHEME_TOL = dict(rtol=1e-12, atol=1e-14)
# B1's plain version against the JAX B1 in interpret mode: the bar that
# tests/test_pallas_kernel.py holds v5 to against the scheme
V5_TOL = dict(rtol=1e-13, atol=1e-13)


def random_state(nx, ny, seed=0):
    """A conserved state [nx, ny, 3] of density 1-1.2 and speeds ~0.1."""
    rng = np.random.default_rng(seed)
    sg = 1.0 + 0.2 * rng.uniform(size=(nx, ny))
    vx = 0.1 * rng.normal(size=(nx, ny))
    vy = 0.1 * rng.normal(size=(nx, ny))
    return np.stack([sg, sg * vx, sg * vy], axis=-1)


# -----------------------------------------------------------------------------
# the scheme
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
@pytest.mark.parametrize("step", ["step_periodic_uniform",
                                  "step_periodic_uniform_rk2"])
def test_scheme_step_matches_jax(step, riemann):
    """One step of each form on a non-square 48 x 40 grid with dx != dy."""
    u = random_state(48, 40)
    args = (0.5, 1.0 / 48, 1.0 / 40, 2e-3, 1.5, riemann)
    want = np.asarray(jax.jit(lambda v: getattr(JG, step)(v, *args))(
        jnp.asarray(u)))
    got = getattr(TG, step)(torch.tensor(u), *args).numpy()
    np.testing.assert_allclose(got, want, **SCHEME_TOL)


@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
def test_scheme_local_extended_and_wavespeed_match_jax(riemann):
    """step_local_extended on a guard-filled block, and max_wavespeed."""
    u = random_state(48, 40, seed=1)
    ext = np.asarray(JG.extend_periodic2(jnp.asarray(u)))
    np.testing.assert_array_equal(
        TG.extend_periodic2(torch.tensor(u)).numpy(), ext)
    args = (0.5, 1.0 / 48, 1.0 / 40, 2e-3, 1.8, riemann)
    want = np.asarray(jax.jit(lambda v: JG.step_local_extended(v, *args))(
        jnp.asarray(ext)))
    got = TG.step_local_extended(torch.tensor(ext), *args).numpy()
    np.testing.assert_allclose(got, want, **SCHEME_TOL)
    P = np.stack([u[..., 0], u[..., 1] / u[..., 0], u[..., 2] / u[..., 0]],
                 axis=-1)
    cs2 = np.full(u.shape[:2], 0.5)
    assert float(TG.max_wavespeed(torch.tensor(P), torch.tensor(cs2))) == \
        pytest.approx(float(JG.max_wavespeed(jnp.asarray(P),
                                             jnp.asarray(cs2))), rel=1e-15)


# -----------------------------------------------------------------------------
# kernel B1's plain version
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("rk,riemann", [(1, "hlle"), (2, "hllc")])
def test_plain_b1_matches_jax_v5_interpret(rk, riemann):
    """advance_n_plain against advance_n_pallas_v5 in interpret mode at the
    smallest shape v5 takes with two tiles of TX = 32, 8 steps."""
    u = np.moveaxis(random_state(64, 128), -1, 0)
    kw = dict(cs2=0.5, dtdx=0.1, dtdy=0.1, theta=1.5, rk_order=rk,
              riemann=riemann)
    want = np.asarray(JK5.advance_n_pallas_v5(jnp.asarray(u), 8, TX=32,
                                              interpret=True, **kw))
    got = TK.advance_n_plain(torch.tensor(u), 8, **kw).numpy()
    np.testing.assert_allclose(got, want, **V5_TOL)


@pytest.mark.parametrize("shape,n,rk,riemann", [
    ((37, 45), 5, 2, "hllc"), ((4, 7), 3, 1, "hlle"),
    ((20, 4), 4, 2, "hlle")])
def test_plain_b1_matches_jax_scheme_on_odd_shapes(shape, n, rk, riemann):
    """Shapes v5 cannot take (odd, non-square, the 4-cell minimum), against
    the JAX scheme with dx != dy."""
    u = random_state(*shape, seed=2)
    dx, dy, dt = 1.0 / shape[0], 1.0 / shape[1], 0.1 / max(shape)
    got = TK.advance_n_plain(
        torch.tensor(np.moveaxis(u, -1, 0)), n, cs2=0.5, dtdx=dt / dx,
        dtdy=dt / dy, theta=1.5, rk_order=rk, riemann=riemann).numpy()
    form = (JG.step_periodic_uniform if rk == 1
            else JG.step_periodic_uniform_rk2)
    step = jax.jit(lambda v: form(v, 0.5, dx, dy, dt, 1.5, riemann))
    want = jnp.asarray(u)
    for _ in range(n):
        want = step(want)
    np.testing.assert_allclose(np.moveaxis(got, 0, -1), np.asarray(want),
                               **SCHEME_TOL)


def test_plain_b1_takes_no_step_and_rejects_what_the_kernel_rejects():
    u = torch.tensor(np.moveaxis(random_state(8, 6), -1, 0))
    assert torch.equal(TK.advance_n_plain(u, 0, cs2=1.0, dtdx=0.1,
                                          dtdy=0.1), u)
    for bad, kw in ((u[:, :3], {}), (u, {"rk_order": 3}),
                    (u, {"riemann": "roe"})):
        with pytest.raises(ValueError):
            TK.advance_n_plain(bad, 1, cs2=1.0, dtdx=0.1, dtdy=0.1, **kw)


# -----------------------------------------------------------------------------
# kh: initial state, dt, advance paths
# -----------------------------------------------------------------------------

def configs(**over):
    base = dict(N=32, outdir=".", fast_step=0)
    base.update(over)
    over = {k: str(v) for k, v in base.items()}
    return (JKH.config_template().create().update(over),
            TKH.config_template().create().update(over))


def test_config_template_matches_jax():
    jcfg, tcfg = configs()
    assert jcfg.to_dict() == tcfg.to_dict()


@pytest.mark.parametrize("over", [{}, {"N": 48, "mach": 0.7, "pert_k": 3,
                                       "sigma0": 1.1, "cs": 0.8}])
def test_initial_state_and_timestep_match_jax(over):
    jcfg, tcfg = configs(**over)
    u_j = JKH.initial_conserved(jcfg)
    u_t = TKH.initial_conserved(tcfg, dtype=torch.float64)
    assert u_t.dtype == torch.float64 and u_t.shape == u_j.shape
    np.testing.assert_allclose(u_t.numpy(), np.asarray(u_j), rtol=1e-14,
                               atol=1e-18)
    assert TKH.fixed_timestep(tcfg, u_t) == pytest.approx(
        JKH.fixed_timestep(jcfg, u_j), rel=1e-15)
    assert TKH.initial_conserved(tcfg).dtype == torch.float32


@pytest.mark.parametrize("kernel,path", [(False, "scheme_rk2[7]"),
                                         (True, "plain_b1_rk2[7]")])
def test_kh_advance_paths_match_jax(kernel, path):
    """kh.advance_n through the scheme and through B1's plain version (7
    steps, no remainder path) against the JAX package's jnp path."""
    jcfg, tcfg = configs(N=40)
    u0 = TKH.initial_conserved(tcfg, dtype=torch.float64)
    kw = dict(cs2=1.0, dx=1.0 / 40, dy=1.0 / 40,
              dt=TKH.fixed_timestep(tcfg, u0), theta=1.8, riemann="hllc",
              rk_order=2)
    got = TKH.advance_n(u0, 7, kernel=kernel, **kw)
    assert TKH.LAST_PATH == path
    want = JKH.advance_n(JKH.initial_conserved(jcfg), 7, kernel=False, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCHEME_TOL)


def no_files(state, cfg):
    """A task runner that marks every due task done and writes nothing."""
    for task in TKH.TASKS:
        if state.schedule.is_due(task):
            state = TKH.State(state.solution,
                              state.schedule.mark_as_completed(task))
    return state


@pytest.mark.parametrize("fast_step,path", [(-1, "scheme"), (0, "scheme"),
                                            (1, "plain_b1")])
def test_fast_step_selects_the_path_on_the_cpu(fast_step, path):
    """setup() and run() on the CPU: fast_step -1 and 0 run the scheme, 1
    kernel B1's plain version; all three reach the JAX package's state."""
    cfg, state = TKH.setup(["kh", "N=24", "tfinal=0.03", "tsi=0.01",
                            f"fast_step={fast_step}", "precision=f64"],
                           device="cpu")
    final = TKH.run(cfg, state, tasks=no_files)
    assert TKH.LAST_PATH.startswith(path + "_rk1[")
    jcfg, _ = configs(N=24)
    u0 = JKH.initial_conserved(jcfg)
    dt = JKH.fixed_timestep(jcfg, u0)
    assert final.solution.dt == dt
    want = JKH.advance_n(u0, final.solution.iteration, cs2=1.0, dx=1 / 24,
                         dy=1 / 24, dt=dt, theta=1.8, kernel=False)
    np.testing.assert_allclose(final.solution.conserved.numpy(),
                               np.asarray(want), **SCHEME_TOL)


def test_chunk_ending_a_round_off_short_of_a_due_time_keeps_its_output():
    """19 steps of dt = 0.05 / 19 end at 0.049999999999999996: the time
    series is still taken there (and every 19 steps), not skipped to a
    later chunk."""
    dt = 0.05 / 19
    assert 19 * dt < 0.05
    cfg, state = TKH.setup(["kh", "N=16", f"fixed_dt={dt!r}", "tsi=0.05",
                            "cpi=1", "dfi=1", "tfinal=0.2"], device="cpu")
    rows = []

    def record(state, cfg):
        if state.schedule.is_due("write_time_series"):
            rows.append(state.solution.iteration)
        return no_files(state, cfg)

    TKH.run(cfg, state, tasks=record)
    assert rows == [0, 19, 38, 57, 76]


# -----------------------------------------------------------------------------
# kh's CLI, checkpoints across the two packages
# -----------------------------------------------------------------------------

ARGS = ["kh", "N=32", "cpi=0.02", "dfi=0.04", "tsi=0.01"]


def read_solution(path):
    with h5py.File(path, "r") as f:
        return {k: f["solution"][k][()] for k in f["solution"]}


def test_cli_writes_the_jax_package_files(tmp_path):
    """The same command line in both packages writes the same files; the
    checkpoints' solution groups have the same names, dtypes and shapes
    and agree in value, and so do the time series."""
    argv = ARGS + ["tfinal=0.04", "precision=f64"]
    assert JKH.main(argv + [f"outdir={tmp_path / 'j'}"]) == 0
    assert TKH.main(argv + [f"outdir={tmp_path / 't'}"], device="cpu") == 0
    files = set(os.listdir(tmp_path / "j"))
    assert files == set(os.listdir(tmp_path / "t"))
    assert {"chkpt.0000.h5", "chkpt.0002.h5", "diagnostics.0001.h5",
            "time_series.h5"} <= files
    for name in sorted(files):
        with h5py.File(tmp_path / "j" / name) as fj, \
                h5py.File(tmp_path / "t" / name) as ft:
            assert set(fj) == set(ft), name
            for key in ("solution", "schedule", "run_config"):
                assert (key in fj) == (key in ft)
        if name.startswith("chkpt"):
            sj = read_solution(tmp_path / "j" / name)
            st = read_solution(tmp_path / "t" / name)
            assert set(sj) == set(st) == {"iteration", "time", "dt",
                                          "conserved"}
            for k in sj:
                assert np.asarray(sj[k]).dtype == np.asarray(st[k]).dtype
                assert np.shape(sj[k]) == np.shape(st[k])
            np.testing.assert_allclose(st["conserved"], sj["conserved"],
                                       **SCHEME_TOL)
            assert st["iteration"] == sj["iteration"]
    with h5py.File(tmp_path / "j" / "time_series.h5") as fj, \
            h5py.File(tmp_path / "t" / "time_series.h5") as ft:
        # the momenta are sums that cancel to round-off (order 1e-19)
        for col in TKH.TIME_SERIES_COLUMNS:
            np.testing.assert_allclose(ft[col][()], fj[col][()], rtol=1e-12,
                                       atol=1e-15)


def test_port_restart_is_bitexact(tmp_path):
    """Through B1's plain version in float32: a run to 0.04, and a run to
    0.02 restarted from its checkpoint, end in the same bits."""
    a, b = tmp_path / "a", tmp_path / "b"
    argv = ARGS + ["fast_step=1"]
    assert TKH.main(argv + ["tfinal=0.04", f"outdir={a}"], device="cpu") == 0
    assert TKH.main(argv + ["tfinal=0.02", f"outdir={b}"], device="cpu") == 0
    assert TKH.main(["kh", f"restart={b / 'chkpt.0001.h5'}", "tfinal=0.04"],
                    device="cpu") == 0
    assert TKH.LAST_PATH.startswith("plain_b1_rk1")
    sa, sb = (read_solution(d / "chkpt.0002.h5") for d in (a, b))
    assert sa["conserved"].dtype == np.float32
    np.testing.assert_array_equal(sa["conserved"], sb["conserved"])
    assert sa["time"] == sb["time"] and sa["dt"] == sb["dt"]


def test_jax_checkpoint_restarts_in_port(tmp_path):
    """restart=<a JAX checkpoint>: the port reads its solution exactly (also
    through solution_from_arrays), and continues as the JAX package does."""
    j, t = tmp_path / "j", tmp_path / "t"
    assert JKH.main(ARGS + ["tfinal=0.02", "riemann=hllc", "rk_order=2",
                            f"outdir={j}"]) == 0
    shutil.copytree(j, t)
    chk = "chkpt.0001.h5"
    cfg, state = TKH.setup(["kh", f"restart={t / chk}", f"outdir={t}",
                            "precision=f64"], device="cpu")
    s = read_solution(j / chk)
    np.testing.assert_array_equal(state.solution.conserved.numpy(),
                                  s["conserved"])
    assert (state.solution.iteration, state.solution.time,
            state.solution.dt) == (s["iteration"], s["time"], s["dt"])
    assert state.schedule.num_times_performed("write_checkpoint") == 2
    again = TKH.solution_from_arrays(s)
    assert torch.equal(again.conserved, state.solution.conserved)
    assert JKH.main(["kh", f"restart={j / chk}", "tfinal=0.04"]) == 0
    assert TKH.main(["kh", f"restart={t / chk}", "tfinal=0.04",
                     "precision=f64", f"outdir={t}"], device="cpu") == 0
    want, got = (read_solution(d / "chkpt.0002.h5") for d in (j, t))
    assert got["iteration"] == want["iteration"]
    np.testing.assert_allclose(got["conserved"], want["conserved"],
                               **SCHEME_TOL)


def test_port_checkpoint_restarts_in_jax(tmp_path):
    """A checkpoint the port wrote (B1's plain version, float64) restarts in
    the JAX package, which continues as the port does."""
    j, t = tmp_path / "j", tmp_path / "t"
    assert TKH.main(ARGS + ["tfinal=0.02", "precision=f64", "fast_step=1",
                            f"outdir={t}"], device="cpu") == 0
    shutil.copytree(t, j)
    # fast_step=0: the JAX package's kernel path refuses N % 128 != 0
    assert JKH.main(["kh", f"restart={j / 'chkpt.0001.h5'}", "tfinal=0.04",
                     f"outdir={j}", "fast_step=0"]) == 0
    assert TKH.main(["kh", f"restart={t / 'chkpt.0001.h5'}", "tfinal=0.04"],
                    device="cpu") == 0
    want, got = (read_solution(d / "chkpt.0002.h5") for d in (t, j))
    assert got["conserved"].dtype == np.float64
    assert got["iteration"] == want["iteration"]
    np.testing.assert_allclose(got["conserved"], want["conserved"],
                               **SCHEME_TOL)


def run_port(*args, cwd, selector=True):
    env = {k: v for k, v in os.environ.items() if k != DEVICE_SELECTOR}
    env["PYTHONPATH"] = REPO
    if selector:
        env[DEVICE_SELECTOR] = "cpu"
    return subprocess.run([sys.executable, "-m", "mara3_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_on_the_cpu_and_without_a_card(tmp_path):
    """python -m mara3_tpu_torch kh ... with the CPU selector writes the
    checkpoints, diagnostics and time series and imports no jax; without
    it, and without a card, it refuses to start."""
    args = ("kh", "N=64", "tfinal=0.05", "cpi=0.02")
    proc = run_port(*args, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "[scheme_rk1[" in proc.stdout
    assert {"chkpt.0000.h5", "chkpt.0001.h5", "chkpt.0002.h5",
            "diagnostics.0000.h5", "time_series.h5"} <= \
        set(os.listdir(tmp_path / "data"))
    refused = run_port(*args, cwd=str(tmp_path), selector=False)
    assert refused.returncode != 0
    assert f"{DEVICE_SELECTOR}=cpu" in refused.stderr


def test_no_card_and_no_selector_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=DEVICE_SELECTOR):
        TKH.setup(["kh", "N=16"])


@pytest.mark.parametrize("option,item", [("precision=bf16", "item 13")])
def test_unported_options_raise(option, item):
    with pytest.raises(NotImplementedError, match=f"ROADMAP.md queue A {item}"):
        TKH.setup(["kh", "N=16", option], device="cpu")
