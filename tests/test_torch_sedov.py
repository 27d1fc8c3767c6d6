"""The port's sedov subprogram (mara3_tpu_torch/subprograms/sedov.py) and
the modules it runs (physics/euler.py, physics/srhd.py, mathx/weno.py,
mathx/shock.py, mathx/polynomial.py, kernels/sedov_step.py) against the JAX
package's, on the CPU in float64: the physics in both forms, the
reconstruction and the shock locators, the scheme, kernel B5's plain version
against the JAX B5 in interpret mode, the CLI's files, restarts across the
two packages, the two driver loops and the device rules. Inputs come from
numpy seeds."""

import os
import shutil
import subprocess
import sys

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mara3_tpu.kernels import sedov_step as J5
from mara3_tpu.mathx import polynomial as JPOLY
from mara3_tpu.mathx import shock as JSHOCK
from mara3_tpu.mathx import weno as JWENO
from mara3_tpu.physics import euler as JE
from mara3_tpu.physics import srhd as JR
from mara3_tpu.subprograms import sedov as JS
from mara3_tpu_torch.app.device import DEVICE_SELECTOR
from mara3_tpu_torch.kernels import sedov_step as T5
from mara3_tpu_torch.mathx import polynomial as TPOLY
from mara3_tpu_torch.mathx import shock as TSHOCK
from mara3_tpu_torch.mathx import weno as TWENO
from mara3_tpu_torch.physics import euler as TE
from mara3_tpu_torch.physics import srhd as TR
from mara3_tpu_torch.subprograms import sedov as TS

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GAMMA = 4.0 / 3.0
NHAT = (0.6, 0.0, 0.8)

# the same formulas in the same order: round-off apart (pow and log may
# differ by an ulp between XLA and PyTorch)
FN_TOL = dict(rtol=1e-13, atol=1e-14)
# the scheme's step against the JAX package's (measured: bitwise equal)
STEP_TOL = dict(rtol=1e-12, atol=0.0)
# SRHD recovery: the same Newton on the same values; a cell whose |f|
# lands within round-off of the stopping test may take one update more or
# fewer, which moves W by up to the stopping tolerance
RECOVER_TOL = dict(rtol=1e-9, atol=1e-12)
# B5's plain version against the JAX B5 in interpret mode: the same
# arithmetic (measured 1.2e-15 of a cell's largest component over 5 steps)
B5_TOL = dict(rtol=1e-12, atol=1e-14)
# whole runs through the CLI: the initial grids differ by an ulp (linspace
# and pow), then many steps of round-off
RUN_TOL = dict(rtol=1e-10, atol=1e-14)


def close(got, want, tol=FN_TOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def euler_state(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.5, 2.0, n), rng.normal(0.0, 1.0, n),
                     rng.normal(0.0, 1.0, n), rng.normal(0.0, 1.0, n),
                     rng.uniform(0.1, 5.0, n)], axis=-1)


def srhd_state(n, seed=0):
    """Primitives with four-velocities up to ~5 (Lorentz factors ~5)."""
    rng = np.random.default_rng(seed)
    return np.stack([rng.uniform(0.5, 2.0, n), rng.normal(0.0, 2.0, n),
                     rng.normal(0.0, 1.0, n), rng.normal(0.0, 0.5, n),
                     rng.uniform(0.01, 10.0, n)], axis=-1)


SYSTEMS = {"euler": (JE, TE, euler_state), "srhd": (JR, TR, srhd_state)}


def both(system, n=257, seed=0):
    """(JAX module, port module, (jnp Pl, Pr, r), (torch Pl, Pr, r))."""
    jm, tm, make = SYSTEMS[system]
    Pl, Pr = make(n, seed), make(n, seed + 1)
    r = np.random.default_rng(seed + 2).uniform(0.5, 3.0, n)
    return (jm, tm, tuple(jnp.asarray(a) for a in (Pl, Pr, r)),
            tuple(torch.tensor(a) for a in (Pl, Pr, r)))


# -----------------------------------------------------------------------------
# physics: stacked and tuple forms
# -----------------------------------------------------------------------------

STACKED = {
    "to_conserved_density": lambda m, Pl, Pr, r:
        m.to_conserved_density(Pl, GAMMA),
    "flux": lambda m, Pl, Pr, r: m.flux(Pl, NHAT, GAMMA),
    "wavespeeds": lambda m, Pl, Pr, r: m.wavespeeds(Pl, NHAT, GAMMA),
    "max_wavespeed": lambda m, Pl, Pr, r: m.max_wavespeed(Pl, GAMMA),
    "sound_speed_squared": lambda m, Pl, Pr, r:
        m.sound_speed_squared(Pl, GAMMA),
    "specific_entropy": lambda m, Pl, Pr, r: m.specific_entropy(Pl, GAMMA),
    "specific_enthalpy": lambda m, Pl, Pr, r: m.specific_enthalpy(Pl, GAMMA),
    "riemann_hlle": lambda m, Pl, Pr, r: m.riemann_hlle(Pl, Pr, NHAT, GAMMA),
    "spherical_geometry_source_terms": lambda m, Pl, Pr, r:
        m.spherical_geometry_source_terms(Pl, r, 0.3 + r / 10.0, GAMMA),
    "spherical_geometry_source_terms_radial": lambda m, Pl, Pr, r:
        m.spherical_geometry_source_terms_radial(Pl, r, GAMMA),
}


@pytest.mark.parametrize("name", sorted(STACKED))
@pytest.mark.parametrize("system", ["euler", "srhd"])
def test_stacked_physics_matches_jax(system, name):
    jm, tm, ja, ta = both(system)
    close(STACKED[name](tm, *ta), STACKED[name](jm, *ja))


def unstack(P):
    return tuple(P[..., k] for k in range(5))


TUPLE = {
    "to_conserved_density_t": lambda m, Pl, Pr, r:
        m.to_conserved_density_t(unstack(Pl), GAMMA),
    "wavespeeds_t": lambda m, Pl, Pr, r:
        m.wavespeeds_t(unstack(Pl), NHAT, GAMMA),
    "flux_t": lambda m, Pl, Pr, r: m.flux_t(
        unstack(Pl), NHAT, m.to_conserved_density_t(unstack(Pl), GAMMA)),
    "riemann_hlle_t": lambda m, Pl, Pr, r:
        m.riemann_hlle_t(unstack(Pl), unstack(Pr), NHAT, GAMMA),
    "spherical_geometry_source_terms_radial_t": lambda m, Pl, Pr, r:
        m.spherical_geometry_source_terms_radial_t(unstack(Pl), r, GAMMA),
}


@pytest.mark.parametrize("name", sorted(TUPLE))
@pytest.mark.parametrize("system", ["euler", "srhd"])
def test_tuple_physics_matches_jax(system, name):
    jm, tm, ja, ta = both(system, seed=3)
    close(TUPLE[name](tm, *ta), TUPLE[name](jm, *ja))


@pytest.mark.parametrize("system", ["euler", "srhd"])
def test_tuple_forms_match_stacked_forms(system):
    """Within the port: the tuple HLLE and recovery equal the stacked."""
    _, tm, _, (Pl, Pr, _) = both(system, seed=4)
    close(tm.riemann_hlle_t(unstack(Pl), unstack(Pr), NHAT, GAMMA),
          unstack(tm.riemann_hlle(Pl, Pr, NHAT, GAMMA)), STEP_TOL)
    U = tm.to_conserved_density(Pl, GAMMA)
    close(tm.recover_primitive_t(unstack(U), GAMMA),
          unstack(tm.recover_primitive(U, GAMMA)), RECOVER_TOL)


def test_euler_recovery_and_roe_average_match_jax():
    jm, tm, (jl, jr, _), (tl, tr, _) = both("euler", seed=5)
    for floor in (0.0, 0.5):
        U = JE.to_conserved_density(jl, GAMMA).at[:7, 4].set(0.0)
        close(TE.recover_primitive(torch.tensor(np.asarray(U)), GAMMA,
                                   floor),
              JE.recover_primitive(U, GAMMA, floor))
        close(TE.recover_primitive_t(unstack(torch.tensor(np.asarray(U))),
                                     GAMMA, floor),
              JE.recover_primitive_t(unstack(U), GAMMA, floor))
    close(TE.roe_average(tl, tr), JE.roe_average(jl, jr))
    close(TE.primitive_from_quantities(*unstack(tl)), tl)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_srhd_recovery_matches_jax(dtype):
    """recover_primitive (whose relative floor is off in float64) and
    recover_primitive_t (on in every dtype, with and without a pressure
    guess) on relativistic states, and the fault mask."""
    P = srhd_state(513, seed=6)
    U = np.asarray(JR.to_conserved_density(jnp.asarray(P), GAMMA)).astype(
        dtype)
    ju, tu = jnp.asarray(U), torch.tensor(U)
    tol = RECOVER_TOL if dtype == "float64" else dict(rtol=2e-4, atol=1e-5)
    close(TR.recover_primitive(tu, GAMMA), JR.recover_primitive(ju, GAMMA),
          tol)
    guess = P[:, 4].astype(dtype) * 1.1
    for g in (None, guess):
        close(TR.recover_primitive_t(
            unstack(tu), GAMMA, p_guess=None if g is None else
            torch.tensor(g)),
            JR.recover_primitive_t(unstack(ju), GAMMA, p_guess=None if g is
                                   None else jnp.asarray(g)), tol)
    assert not bool(TR.recovery_failed(tu, GAMMA))
    bad = tu.clone()
    bad[3, 0] = -1.0
    _, fault = TR.recover_primitive(bad, GAMMA, return_fault=True)
    _, jfault = JR.recover_primitive(jnp.asarray(bad.numpy()), GAMMA,
                                     return_fault=True)
    np.testing.assert_array_equal(fault.numpy(), np.asarray(jfault))


def test_srhd_recovery_recovers_the_primitives():
    P = srhd_state(200, seed=7)
    U = TR.to_conserved_density(torch.tensor(P), GAMMA)
    close(TR.recover_primitive(U, GAMMA), P, dict(rtol=1e-8, atol=1e-9))


# -----------------------------------------------------------------------------
# reconstruction, shock locators, parabola vertex
# -----------------------------------------------------------------------------

def test_weno5_matches_jax():
    q = np.random.default_rng(8).normal(size=(70, 5)).cumsum(axis=0)
    close(TWENO.weno5_faces(torch.tensor(q), axis=0),
          JWENO.weno5_faces(jnp.asarray(q), axis=0))
    close(TWENO.weno5_faces(torch.tensor(q.T.copy()), axis=1),
          JWENO.weno5_faces(jnp.asarray(q.T), axis=1))


def blast_profile(n=200, shock=120, seed=9):
    """A pressure profile with a plateau behind a jump at `shock`, a decay
    ahead, and noise."""
    rng = np.random.default_rng(seed)
    x = np.arange(n, dtype=float)
    p = np.where(x <= shock, 1.0 + 0.5 * np.exp(-(shock - x) / 20.0),
                 1e-3 * np.exp(-(x - shock) / 5.0) + 1e-6)
    return p * (1.0 + 1e-3 * rng.uniform(size=n))


@pytest.mark.parametrize("shock", [0, 1, 57, 120, 198])
def test_shock_locators_match_jax(shock):
    p = blast_profile(shock=shock)
    s = np.log(p / np.linspace(1.0, 2.0, p.size) ** GAMMA)
    jp, tp = jnp.asarray(p), torch.tensor(p)
    i = int(JSHOCK.find_shock_index(jnp.asarray(s)))
    assert int(TSHOCK.find_shock_index(torch.tensor(s))) == i
    for index in (i, shock, p.size - 1, 0):
        assert int(TSHOCK.find_index_of_maximum_behind(tp, index)) == int(
            JSHOCK.find_index_of_maximum_behind(jp, index))
        assert int(TSHOCK.find_index_of_maximum_pressure_behind(
            tp, index)) == int(
            JSHOCK.find_index_of_maximum_pressure_behind(jp, index))
        assert int(TSHOCK.find_index_of_pressure_plateau_ahead(
            tp, index)) == int(
            JSHOCK.find_index_of_pressure_plateau_ahead(jp, index))


def test_shock_index_takes_the_first_minimum():
    s = torch.tensor([3.0, 2.0, 3.0, 2.0, 3.0], dtype=torch.float64)
    assert int(TSHOCK.find_shock_index(s)) == 0 == int(
        JSHOCK.find_shock_index(jnp.asarray(s.numpy())))


def test_parabola_vertex_matches_jax():
    rng = np.random.default_rng(10)
    xs = np.sort(rng.uniform(0, 5, size=(3, 40)), axis=0)
    ys = rng.normal(size=(3, 40))
    close(TPOLY.parabola_vertex(*torch.tensor(xs), *torch.tensor(ys)),
          JPOLY.parabola_vertex(*jnp.asarray(xs), *jnp.asarray(ys)))
    x, y = TPOLY.parabola_vertex(0.0, 1.0, 2.0, 1.0, 0.0, 1.0)
    assert (x, y) == (1.0, 0.0)


# -----------------------------------------------------------------------------
# sedov: the initial state, the scheme, B5's plain version
# -----------------------------------------------------------------------------

def configs(**over):
    over = {k: str(v) for k, v in over.items()}
    return (JS.config_template().create().update(over),
            TS.config_template().create().update(over))


def test_config_template_matches_jax():
    jcfg, tcfg = configs()
    assert jcfg.to_dict() == tcfg.to_dict()


@pytest.mark.parametrize("newtonian", [0, 1])
def test_new_solution_matches_jax(newtonian):
    jcfg, tcfg = configs(nr=48, newtonian=newtonian, density_index=1.5,
                         explosion_pressure=2.0)
    js = JS.new_solution(jcfg)
    ts = TS.new_solution(tcfg, dtype=torch.float64)
    assert ts.vertices.dtype == torch.float64 and ts.vertices.shape == (97,)
    # linspace and 10 ** y may round an ulp apart between the two packages
    close(ts.vertices, js.vertices, dict(rtol=1e-15, atol=0.0))
    close(ts.conserved, js.conserved, dict(rtol=1e-13, atol=0.0))
    assert TS.grid_dt(ts.vertices) == pytest.approx(JS.grid_dt(js.vertices),
                                                    rel=1e-14)
    assert TS.new_solution(tcfg).conserved.dtype == torch.float32


def seeded_sedov(nr, system, seed=11, flat_edge=False):
    """The sedov grid of `nr` zones per decade with a perturbed blast
    state: (u, vertices, dt) as numpy. With flat_edge the outer 24 cells
    stay as uniform as in a sedov run."""
    _, tcfg = configs(nr=nr, newtonian=int(system == "euler"))
    s = TS.new_solution(tcfg, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    noise = 1.0 + 0.05 * rng.uniform(size=(s.conserved.shape[0], 1))
    if flat_edge:
        noise[-24:] = 1.0
    u = s.conserved.numpy() * noise
    return u, s.vertices.numpy(), TS.grid_dt(s.vertices)


@pytest.mark.parametrize("reconstruct", ["pcm", "plm", "weno5"])
@pytest.mark.parametrize("system", ["euler", "srhd"])
def test_scheme_step_matches_jax(system, reconstruct):
    """_step and _step_stacked against the JAX package's, one step."""
    u, v, dt = seeded_sedov(24, system)
    jm, tm = SYSTEMS[system][:2]
    for form in ("_step", "_step_stacked"):
        want = getattr(JS, form)(jm, jnp.asarray(u), jnp.asarray(v), dt,
                                 reconstruct, 1.5)
        got = getattr(TS, form)(tm, torch.tensor(u), torch.tensor(v), dt,
                                reconstruct, 1.5)
        close(got, want, STEP_TOL)


@pytest.mark.parametrize("system,reconstruct,nr", [
    ("srhd", "pcm", 64), ("srhd", "plm", 64), ("srhd", "weno5", 64),
    ("euler", "weno5", 256)])
def test_plain_b5_matches_jax_b5_interpret(system, reconstruct, nr):
    """advance_n_plain against advance_n_pallas in interpret mode, 5 steps
    at 128 cells (512 for Euler), SRHD warm and cold. The port's B5 reads
    the scheme's weno5 stencil at the outer face and the TPU kernel its
    own, which agree while the outer three cells are equal: so the outer
    cells are left flat, as in a sedov run until the blast reaches them."""
    u, v, dt = seeded_sedov(nr, system, flat_edge=True)
    for warm in ((True,) if system == "euler" else (False, True)):
        with pltpu.force_tpu_interpret_mode():
            want = J5.advance_n_pallas(jnp.asarray(u), jnp.asarray(v), dt, 5,
                                       reconstruct, 1.5, system=system,
                                       warm=warm, interpret=True)
        got = T5.advance_n_plain(torch.tensor(u), torch.tensor(v), dt, 5,
                                 reconstruct, 1.5, system=system, warm=warm)
        close(got, want, B5_TOL)


@pytest.mark.parametrize("kernel,path", [(None, "scheme[3]"),
                                         (False, "scheme[3]"),
                                         (True, "plain_b5_srhd_plm[3]")])
def test_advance_paths_on_the_cpu(kernel, path):
    """advance_n on a CPU tensor: the scheme unless kernel=True, which
    runs B5's plain version; both reach the JAX scheme's state."""
    u, v, dt = seeded_sedov(16, "srhd")
    got = TS.advance_n(torch.tensor(u), torch.tensor(v), dt, False, 3, "plm",
                       kernel=kernel)
    assert TS.LAST_PATH == path
    want = jnp.asarray(u)
    for _ in range(3):
        want = JS._step(JR, want, jnp.asarray(v), dt, "plm", 1.5)
    close(got, want, dict(rtol=1e-8, atol=1e-10) if kernel else STEP_TOL)


# -----------------------------------------------------------------------------
# the driver loops
# -----------------------------------------------------------------------------

def no_files(samples=None):
    """A task runner that writes nothing, and records the time-series rows'
    iterations in `samples`."""
    def tasks(state, cfg):
        for task in TS.TASKS:
            if state.schedule.is_due(task):
                if task == "write_time_series" and samples is not None:
                    samples.append(state.solution.iteration)
                state = TS.State(state.solution,
                                 state.schedule.mark_as_completed(task))
        return state
    return tasks


@pytest.mark.parametrize("fast_step", [-1, 0, 1])
def test_driver_loops_reach_the_jax_state(fast_step):
    """setup() and run() on the CPU through each loop: the JAX package's
    state after as many scheme steps."""
    argv = ["sedov", "nr=16", "tfinal=0.2", "tsi=0.05", "newtonian=1",
            f"fast_step={fast_step}"]
    cfg, state = TS.setup(argv, device="cpu", dtype=torch.float64)
    final = TS.run(cfg, state, tasks=no_files())
    assert TS.LAST_PATH.startswith("scheme[")
    jcfg, _ = configs(nr=16, newtonian=1)
    js = JS.new_solution(jcfg)
    want = JS._advance_n_jnp(js.conserved, js.vertices,
                             JS.grid_dt(js.vertices), True,
                             final.solution.iteration)
    close(final.solution.conserved, want, RUN_TOL)


def test_chunked_loop_lands_on_every_due_at_the_chip_size(monkeypatch):
    """The chunk planner at nr=262144 (dt = 1.39e-6), with no steps taken:
    4,096 steps with a time-series row every 1,000 steps land every row on
    its step (no chunk ends a round-off short of a due time), in chunks of
    at most 128."""
    chunks = []

    def count(u0, vertices, dt, newtonian, n, *args, **kw):
        chunks.append(n)
        return u0

    monkeypatch.setattr(TS, "advance_n", count)
    cfg, state = TS.setup(["sedov", "nr=262144"], device="cpu")
    dt = TS.grid_dt(state.solution.vertices)
    cfg = cfg.update({"tfinal": str(4096 * dt), "tsi": str(1000 * dt),
                      "cpi": "1", "dfi": "1", "fast_step": "1"})
    rows = []
    final = TS.run(cfg, state, tasks=no_files(rows))
    assert final.solution.iteration == 4096 == sum(chunks)
    assert rows == [0, 1000, 2000, 3000, 4000]
    assert max(chunks) == 128


# -----------------------------------------------------------------------------
# the CLI, checkpoints across the two packages
# -----------------------------------------------------------------------------

ARGS = ["sedov", "nr=32", "tfinal=0.3", "cpi=0.15", "tsi=0.1", "dfi=0.3"]


def run_jax(argv, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return JS.main(argv)
    finally:
        os.chdir(old)


def read_solution(path):
    with h5py.File(path, "r") as f:
        return {k: f["solution"][k][()] for k in f["solution"]}


@pytest.mark.parametrize("newtonian", [0, 1])
def test_cli_writes_the_jax_package_files(tmp_path, newtonian):
    """The same command line in both packages writes the same files, with
    the same groups, and the same checkpoints, diagnostics and time series
    to round-off."""
    argv = ARGS + [f"newtonian={newtonian}"]
    assert run_jax(argv + [f"outdir={tmp_path / 'j'}"], tmp_path) == 0
    assert TS.main(argv + [f"outdir={tmp_path / 't'}"], device="cpu",
                   dtype=torch.float64) == 0
    files = set(os.listdir(tmp_path / "j"))
    assert files == set(os.listdir(tmp_path / "t"))
    assert {"chkpt.0000.h5", "chkpt.0002.h5", "diagnostics.0000.h5",
            "time_series.h5"} <= files
    for name in sorted(files):
        with h5py.File(tmp_path / "j" / name) as fj, \
                h5py.File(tmp_path / "t" / name) as ft:
            assert set(fj) == set(ft), name
            if name.startswith("chkpt"):
                assert {"solution", "schedule", "run_config",
                        "config"} <= set(ft)
                assert set(fj["solution"]) == set(ft["solution"])
                for k in fj["solution"]:
                    a, b = fj["solution"][k][()], ft["solution"][k][()]
                    assert np.asarray(a).dtype == np.asarray(b).dtype, k
                    close(b, a, RUN_TOL)
            elif name.startswith("diagnostics"):
                for k in fj:
                    close(ft[k][()], fj[k][()], RUN_TOL)
            else:
                for k in TS.TIME_SERIES_COLUMNS:
                    assert fj[k].shape == ft[k].shape and fj[k].shape[0] >= 3
                    close(ft[k][()], fj[k][()], RUN_TOL)


def test_jax_checkpoint_restarts_in_port(tmp_path):
    """restart=<a JAX checkpoint>: the port reads its solution exactly and
    continues as the JAX package does."""
    j, t = tmp_path / "j", tmp_path / "t"
    assert run_jax(ARGS + ["newtonian=1", f"outdir={j}"], tmp_path) == 0
    shutil.copytree(j, t)
    chk = "chkpt.0001.h5"
    cfg, state = TS.setup(["sedov", f"restart={t / chk}", f"outdir={t}"],
                          device="cpu", dtype=torch.float64)
    s = read_solution(j / chk)
    np.testing.assert_array_equal(state.solution.conserved.numpy(),
                                  s["conserved"])
    np.testing.assert_array_equal(state.solution.vertices.numpy(),
                                  s["vertices"])
    assert (state.solution.iteration, state.solution.time) == \
        (s["iteration"], s["time"])
    assert state.schedule.num_times_performed("write_checkpoint") == 2
    again = TS.solution_from_arrays(s)
    assert torch.equal(again.conserved, state.solution.conserved)
    assert run_jax(["sedov", f"restart={j / chk}", "tfinal=0.45"],
                   tmp_path) == 0
    assert TS.main(["sedov", f"restart={t / chk}", "tfinal=0.45",
                    f"outdir={t}"], device="cpu", dtype=torch.float64) == 0
    want, got = (read_solution(d / "chkpt.0003.h5") for d in (j, t))
    assert got["iteration"] == want["iteration"]
    close(got["conserved"], want["conserved"], RUN_TOL)


def test_port_checkpoint_restarts_in_jax(tmp_path):
    """A checkpoint the port wrote (float64, SRHD) restarts in the JAX
    package, which continues as the port does; solution_to_arrays is the
    inverse of solution_from_arrays."""
    j, t = tmp_path / "j", tmp_path / "t"
    assert TS.main(ARGS + [f"outdir={t}"], device="cpu",
                   dtype=torch.float64) == 0
    shutil.copytree(t, j)
    assert run_jax(["sedov", f"restart={j / 'chkpt.0001.h5'}",
                    "tfinal=0.45", f"outdir={j}"], tmp_path) == 0
    assert TS.main(["sedov", f"restart={t / 'chkpt.0001.h5'}",
                    "tfinal=0.45"], device="cpu", dtype=torch.float64) == 0
    want, got = (read_solution(d / "chkpt.0003.h5") for d in (t, j))
    assert got["conserved"].dtype == np.float64
    assert got["iteration"] == want["iteration"]
    close(got["conserved"], want["conserved"], RUN_TOL)
    back = TS.solution_to_arrays(TS.solution_from_arrays(want))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_fast_driver_matches_host_driver(tmp_path):
    """fast_step=1 (the chunked loop) reproduces the per-step loop: the same
    checkpoints, final time and time-series rows, the state at round-off
    (the JAX package's test, through the port)."""
    for sub, flag in (("host", "fast_step=0"), ("fast", "fast_step=1")):
        assert TS.main(ARGS + [flag, f"outdir={tmp_path / sub}"],
                       device="cpu", dtype=torch.float64) == 0

    def summary(d):
        names = sorted(f for f in os.listdir(d) if f.startswith("chkpt"))
        with h5py.File(d / names[-1]) as f:
            u, t = f["solution/conserved"][()], f["solution/time"][()]
        with h5py.File(d / "time_series.h5") as f:
            nts = f["time"].shape[0]
        return names, u, t, nts

    nh, uh, th, tsh = summary(tmp_path / "host")
    nf, uf, tf, tsf = summary(tmp_path / "fast")
    assert nh == nf and tsh == tsf
    np.testing.assert_allclose(tf, th, rtol=1e-12)
    np.testing.assert_allclose(uf, uh, rtol=1e-9, atol=1e-12)


def run_port(*args, cwd, selector=True):
    env = {k: v for k, v in os.environ.items() if k != DEVICE_SELECTOR}
    env["PYTHONPATH"] = REPO
    if selector:
        env[DEVICE_SELECTOR] = "cpu"
    return subprocess.run([sys.executable, "-m", "mara3_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_on_the_cpu_and_without_a_card(tmp_path):
    """python -m mara3_tpu_torch sedov ... with the CPU selector writes the
    files (float32, the scheme); without it, and without a card, it
    refuses to start."""
    args = ("sedov", "nr=32", "tfinal=0.2", "cpi=0.1", "reconstruct_method=plm")
    proc = run_port(*args, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "the scheme (torch ops) on the CPU" in proc.stdout
    assert {"chkpt.0000.h5", "chkpt.0002.h5", "diagnostics.0000.h5",
            "time_series.h5"} <= set(os.listdir(tmp_path / "data"))
    assert read_solution(tmp_path / "data" / "chkpt.0002.h5")[
        "conserved"].dtype == np.float32
    refused = run_port(*args, cwd=str(tmp_path), selector=False)
    assert refused.returncode != 0
    assert f"{DEVICE_SELECTOR}=cpu" in refused.stderr


def test_no_card_and_no_selector_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=DEVICE_SELECTOR):
        TS.setup(["sedov", "nr=16"])


def test_unknown_reconstruction_raises():
    with pytest.raises(ValueError, match="pcm, plm or weno5"):
        TS.setup(["sedov", "nr=16", "reconstruct_method=ppm"], device="cpu")
