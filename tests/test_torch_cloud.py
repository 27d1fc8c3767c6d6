"""The port's cloud subprogram (mara3_tpu_torch/subprograms/cloud.py) and
the modules it runs (models/jet_nozzle.py, models/atmosphere.py,
core/dimensional.py, mathx/shock.py batched, kernels/cloud_update.py)
against the JAX package's, on the CPU in float64: the models and units, the
geometry and the initial state, the scheme's stage and RK step, kernel B4's
four plain versions against the JAX B4 entries in interpret mode, the
diagnostics, the CLI's files, restarts across the two packages and the two
driver loops. Inputs come from the configurations and numpy seeds."""

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
from jax.experimental.pallas import tpu as pltpu

from mara3_tpu.core import dimensional as JD
from mara3_tpu.core import ops as JOPS
from mara3_tpu.kernels import cloud_update as JCU
from mara3_tpu.mathx import shock as JSHOCK
from mara3_tpu.models import atmosphere as JA
from mara3_tpu.models import jet_nozzle as JJ
from mara3_tpu.subprograms import cloud as JC
from mara3_tpu_torch.app.device import DEVICE_SELECTOR
from mara3_tpu_torch.core import dimensional as TD
from mara3_tpu_torch.kernels import cloud_update as TCU
from mara3_tpu_torch.mathx import shock as TSHOCK
from mara3_tpu_torch.models import atmosphere as TA
from mara3_tpu_torch.models import jet_nozzle as TJ
from mara3_tpu_torch.subprograms import cloud as TC

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# the same formulas in the same order: round-off apart (pow, log, exp, sin
# and tan may differ by an ulp between XLA and PyTorch)
FN_TOL = dict(rtol=1e-13, atol=0.0)
# the CGS model: the secant solve stops within 1e-10 of log10 r, so a
# one-ulp difference in a residual can take one more or one fewer update
MODEL_TOL = dict(rtol=1e-9, atol=0.0)
# the scheme's stage and step against the JAX package's jnp path (measured
# 2.2e-16 of a cell's largest component at 64 x 128): the SRHD Newton may
# stop one update apart where |f| lands within round-off of the tolerance,
# which moves a pressure by up to that tolerance
SCHEME_TOL = dict(rtol=1e-12, atol=1e-14)
# B4's plain versions against the JAX B4 entries in interpret mode: the
# same arithmetic (measured 2e-16 to 4e-16 of a cell's largest component
# over two stages at 64 x 128); the warm pressure at the Newton's stopping
# tolerance
B4_TOL = dict(rtol=1e-12, atol=1e-14)
P_TOL = dict(rtol=1e-12, atol=1e-13)
# whole runs through the CLI: the grids differ by an ulp (linspace and pow),
# then a few steps of round-off and of the Newton's stopping tolerance
RUN_TOL = dict(rtol=1e-9, atol=1e-14)
# the diagnostics recover with the scheme's recover_primitive, whose float64
# stopping test is the absolute |f| < 1e-10: on a cold gas (p ~ 1e-6 rho in
# code units) a Newton that stops one update apart moves p by up to ~1e-9
# of itself (measured 1.7e-9)
DIAG_TOL = dict(rtol=1e-8, atol=1e-14)


def close(got, want, tol=FN_TOL):
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            close(g, w, tol)
        return
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), **tol)


def configs(**over):
    over = {k: str(v) for k, v in over.items()}
    return (JC.config_template().create().update(over),
            TC.config_template().create().update(over))


# -----------------------------------------------------------------------------
# models, units, dimensions
# -----------------------------------------------------------------------------

def test_config_template_matches_jax():
    jcfg, tcfg = configs()
    assert jcfg.to_dict() == tcfg.to_dict()


def test_jet_nozzle_matches_jax():
    kw = dict(Ej=1e50, G0=10.0, tj=1.0, qj=0.1, as_=2.0, r0=3e8)
    jj, tj = JJ.JetNozzle(**kw), TJ.JetNozzle(**kw)
    q = np.linspace(0.0, np.pi, 97)
    assert tj.density_at_base() == jj.density_at_base()
    for t in (0.0, 0.37, 2.5):
        close(tj.gamma_beta(torch.tensor(q), t), jj.gamma_beta(q, t))
        # near the equator exp(-(q/qj)^2) is subnormal, which XLA flushes
        # to zero on the CPU
        close(tj.luminosity_per_steradian(torch.tensor(q), t),
              jj.luminosity_per_steradian(q, t), dict(rtol=1e-13,
                                                      atol=1e-200))
        assert tj.gamma_beta(0.05, t) == pytest.approx(
            float(jj.gamma_beta(0.05, t)), rel=1e-15)


def test_power_law_atmosphere_matches_jax():
    _, tcfg = configs()
    jcfg, _ = configs()
    jm, tm = JC.make_atmosphere_model(jcfg), TC.make_atmosphere_model(tcfg)
    assert tm.total_mass() == pytest.approx(jm.total_mass(), rel=1e-15)
    assert tm.coefficient == pytest.approx(jm.coefficient, rel=1e-15)
    r = np.geomspace(3e8, 3e12, 64)
    close(tm.density_at(torch.tensor(r)), jm.density_at(r))
    with pytest.raises(ValueError, match="greater than 3"):
        TA.PowerLawAtmosphere(outer_index=3.0).total_mass()


@pytest.mark.parametrize("t", [1.0, 3.0])
def test_cloud_and_envelope_matches_jax(t):
    je, te = JA.CloudAndEnvelope(), TA.CloudAndEnvelope()
    r = np.geomspace(3e8, 1e12, 80)   # cloud, envelope and tail
    close(te.mass_coordinate(torch.tensor(r), t),
          je.mass_coordinate(jnp.asarray(r), t), MODEL_TOL)
    close(te.density_at(torch.tensor(r), t), je.density_at(r, t), MODEL_TOL)
    close(te.gamma_beta_at(torch.tensor(r), t), je.gamma_beta_at(r, t),
          MODEL_TOL)
    close(te.velocity_at(torch.tensor(r), t), je.velocity_at(r, t),
          MODEL_TOL)
    assert te.total_mass(t) == pytest.approx(je.total_mass(t), rel=1e-9)
    assert float(te.cloud_gamma_beta()) == pytest.approx(
        float(je.cloud_gamma_beta()), rel=1e-14)


def test_secant_solves_each_element_alone():
    """The masked secant: an element that converges stops; the others go
    on, and each lands on its own root."""
    target = torch.tensor([2.0, 9.0, 30.0], dtype=torch.float64)
    x = TA._secant_vectorized(lambda x: x * x - target,
                              torch.ones(3, dtype=torch.float64),
                              torch.full((3,), 2.0, dtype=torch.float64))
    close(x, np.sqrt(target.numpy()), dict(rtol=1e-10, atol=0.0))


def test_units_match_jax():
    jcfg, tcfg = configs(cloud_mass=0.05)
    ju, tu = JC.make_reference_units(jcfg), TC.make_reference_units(tcfg)
    for name in ("length", "mass", "time", "velocity", "energy",
                 "mass_density", "energy_density", "power"):
        assert getattr(tu, name) == pytest.approx(float(getattr(ju, name)),
                                                  rel=1e-15), name
    assert TC.jet_static(tcfg) == pytest.approx(
        (*[getattr(JC.make_jet_nozzle_model(jcfg), k) for k in
           ("Ej", "G0", "tj", "qj", "as_", "r0")],
         ju.mass_density, ju.time), rel=1e-15)


def test_dimensional_matches_jax():
    for mod in (TD, JD):
        L, M, T = mod.make_length(2.0), mod.make_mass(3.0), mod.make_time(4.0)
        e = M * (L / T) * (L / T)
        assert mod.require_dims(e, 2, 1, -2) == 0.75
        assert (L * L).sqrt().dims == L.dims
        assert (L.pow(3, 2)).dims == (1.5, 0, 0)
        assert (1.0 / T).dims == mod.make_rate(1.0).dims
        with pytest.raises(ValueError, match="dimension mismatch"):
            L + M
        with pytest.raises(ValueError, match="expected"):
            mod.require_dims(e, 1, 0, 0, "length")
        with pytest.raises(ValueError, match="bare value"):
            mod.require_dims(2.0, 1, 0, 0)
        with pytest.raises(ValueError, match="cannot combine"):
            L + 1.0
    q = TD.make_mass_density(torch.ones(3, dtype=torch.float64))
    assert torch.equal(TD.require_dims(q / q, 0, 0, 0), torch.ones(3).double())


# -----------------------------------------------------------------------------
# geometry, the initial state, the scheme
# -----------------------------------------------------------------------------

def grid(nr=48, **over):
    jcfg, tcfg = configs(nr=nr, **over)
    js = JC.new_solution(jcfg)
    ts = TC.new_solution(tcfg, dtype=torch.float64)
    return jcfg, tcfg, js, ts


def test_geometry_matches_jax():
    _, _, js, ts = grid()
    for name in ("radial_face_areas", "polar_face_areas", "cell_volumes"):
        close(getattr(TC, name)(ts.radial_vertices, ts.polar_vertices),
              getattr(JC, name)(js.radial_vertices, js.polar_vertices))
    close(TC.ops.midpoint_on_axis(ts.radial_vertices),
          JOPS.midpoint_on_axis(js.radial_vertices), FN_TOL)


@pytest.mark.parametrize("over", [{}, {"density_index": 1.5,
                                       "jet_delay_time": 2.0}])
def test_new_solution_matches_jax(over):
    _, tcfg, js, ts = grid(nr=40, **over)
    assert ts.radial_vertices.dtype == torch.float64
    assert ts.conserved.shape == (80, 40, 5) and ts.pressure is None
    # linspace and 10 ** y may round an ulp apart between the two packages
    close(ts.radial_vertices, js.radial_vertices, dict(rtol=1e-15, atol=0.0))
    close(ts.polar_vertices, js.polar_vertices, dict(rtol=1e-15, atol=0.0))
    close(ts.conserved, js.conserved, dict(rtol=1e-9, atol=0.0))
    s32 = TC.new_solution(tcfg)
    assert s32.conserved.dtype == s32.radial_vertices.dtype == torch.float32
    assert bool(torch.isfinite(s32.conserved).all())


def scheme_inputs(nr=32, num_decades=1.0, seed=0):
    """A cloud grid with its state perturbed by 2% noise from a numpy seed,
    and a warm pressure near the state's: (jax args, torch args, dt,
    jet_static)."""
    jcfg, tcfg, js, ts = grid(nr=nr, num_decades=num_decades)
    rng = np.random.default_rng(seed)
    u = np.moveaxis(np.asarray(js.conserved), -1, 0) * (
        1.0 + 0.02 * rng.uniform(-1, 1, (5,) + js.conserved.shape[:2]))
    u[2] = 0.01 * rng.normal(size=u[2].shape) * np.abs(u[0])
    rv, qv = ts.radial_vertices, ts.polar_vertices
    P = TC.srhd.recover_primitive(torch.tensor(np.moveaxis(u, 0, -1))
                                  / TC.cell_volumes(rv, qv)[..., None],
                                  TC.GAMMA_LAW_INDEX)
    p = P[..., 4].numpy() * (1.0 + 0.1 * rng.uniform(size=u[0].shape))
    dt = TC.grid_dt(ts, tcfg)
    return ((jnp.asarray(u), jnp.asarray(p), js.radial_vertices,
             js.polar_vertices),
            (torch.tensor(u), torch.tensor(p), rv, qv), dt,
            TC.jet_static(tcfg))


@pytest.mark.parametrize("warm", [True, False], ids=["warm", "cold"])
@pytest.mark.parametrize("rk", [1, 2])
@pytest.mark.parametrize("method", [1, 2], ids=["pcm", "plm"])
def test_scheme_step_matches_jax(method, rk, warm):
    """_advance_rk_carry_soa (the scheme) against the JAX package's with
    fused=False, two steps, from a warm pressure or from 0."""
    (ju, jp, jrv, jqv), (tu, tp, trv, tqv), dt, js = scheme_inputs()
    if not warm:
        jp, tp = jnp.zeros_like(jp), torch.zeros_like(tp)
    t = 0.3
    for _ in range(2):
        ju, jp = JC._advance_rk_carry_soa(ju, jp, t, jrv, jqv, js, dt, 1.2,
                                          method, 1e-8, rk, fused=False)
        tu, tp = TC._advance_rk_carry_soa(tu, tp, t, trv, tqv, js, dt, 1.2,
                                          method, 1e-8, rk, kernel=False)
        t += dt
    assert TC.LAST_PATH == "scheme[1]"
    close(tu, ju, SCHEME_TOL)
    close(tp, jp, P_TOL)


def test_flux_update_and_advance_once_match_jax():
    """The scheme's _flux_update and the tuple-form stage _advance_once."""
    (ju, jp, jrv, jqv), (tu, tp, trv, tqv), dt, js = scheme_inputs(seed=1)
    jg = (jrv, jqv, JOPS.midpoint_on_axis(jrv), JOPS.midpoint_on_axis(jqv),
          JC.cell_volumes(jrv, jqv), JC.radial_face_areas(jrv, jqv),
          JC.polar_face_areas(jrv, jqv))
    tg = TC.make_geometry(trv, tqv)
    for method in (1, 2):
        want = JC._advance_once(jnp.moveaxis(ju, 0, -1), 0.2, jg, js, dt,
                                1.2, method, 1e-8, jp, fused=False)
        got = TC._advance_once(tu.permute(1, 2, 0), 0.2, tg, js, dt, 1.2,
                               method, 1e-8, tp, kernel=False)
        close(got, want, SCHEME_TOL)
        plain = TC._advance_once(tu.permute(1, 2, 0), 0.2, tg, js, dt, 1.2,
                                 method, 1e-8, tp, kernel=True)
        # B4a's plain version: the TPU kernel's spelling of the same update
        close(plain, want, dict(rtol=1e-11, atol=1e-14))


def test_inflow_rows_match_jax():
    _, tcfg, js, ts = grid(nr=24)
    jet = TC.jet_static(tcfg)
    qc = TC.ops.midpoint_on_axis(ts.polar_vertices)
    rows = TC.inflow_rows(qc, 0.25, 0.01, 3, jet)
    t = 0.25
    for s in range(4):
        want = JC._inflow_row(JOPS.midpoint_on_axis(js.polar_vertices), t,
                              jet)
        close(rows[s], np.moveaxis(np.asarray(want[0]), -1, 0))
        close(TC._inflow_row(qc, t, jet), want)
        t = t + 0.01


# -----------------------------------------------------------------------------
# kernel B4's plain versions against the JAX B4 in interpret mode
# -----------------------------------------------------------------------------

@pytest.fixture(scope="module")
def b4_case():
    """The JAX package's own test shape (nr=128, num_decades=0.5: 64 x
    128), its state perturbed, a warm pressure, and the JAX B4 entries run
    once each in interpret mode (jitted, so that each traces once): B4a on
    the scheme's primitives, B4b from the warm pressure and from 0, B4c,
    and B4d over 2 steps, rk 2 and rk 1."""
    (ju, jp, jrv, jqv), (tu, tp, trv, tqv), dt, js = scheme_inputs(
        nr=128, num_decades=0.5, seed=2)
    nr, nq = ju.shape[1:]
    rc, qc = JOPS.midpoint_on_axis(jrv), JOPS.midpoint_on_axis(jqv)
    dv = JC.cell_volumes(jrv, jqv)
    dAr = JC.radial_face_areas(jrv, jqv)
    dAq = JC.polar_face_areas(jrv, jqv)
    invr = jnp.broadcast_to((1.0 / rc)[:, None], (nr, nq))
    cotq = jnp.broadcast_to(jnp.tan(jnp.pi / 2 - qc)[None, :], (nr, nq))
    geo = (dv, invr, cotq, dAr, dAq[:, :-1], dAq[:, 1:])
    t0 = 0.4

    def row(t):
        r = JC._inflow_row(qc, t, js)
        return jnp.stack([r[0, :, k] for k in range(5)])

    stage = jax.jit(lambda i1, u, p: JCU.fused_stage(
        i1, u, p, *geo, dt, 1.2, 2, 1e-8, TX=16, interpret=True))
    rk2 = jax.jit(lambda i1, i2, u, p: JCU.fused_step_rk2(
        i1, i2, u, p, *geo, dt, 1.2, 2, 1e-8, TX=16, interpret=True))
    Ut = tuple(ju[k] / dv for k in range(5))
    Pt = JC.srhd.recover_primitive_t(Ut, JC.GAMMA_LAW_INDEX, 1e-8, jp)
    inflow = JC._inflow_row(qc, t0, js)
    Pe = jnp.stack([jnp.concatenate([inflow[..., k], c, c[-1:]], axis=0)
                    for k, c in enumerate(Pt)])
    rows = jnp.stack([row(t0), row(t0 + dt), row(t0 + dt + dt)])
    out = {}
    with pltpu.force_tpu_interpret_mode():
        out["b4a"] = JCU.fused_flux_update(Pe, ju, *geo, dt, 1.2, 2, TX=16,
                                           interpret=True)
        out["b4b_warm"] = stage(rows[0], ju, jp)
        out["b4b_cold"] = stage(rows[0], ju, jnp.zeros_like(jp))
        out["b4c"] = rk2(rows[0], rows[1], ju, jp)
        for rk in (1, 2):
            out[f"b4d_rk{rk}"] = JCU.fused_run_rk2(
                rows, ju, jp, *geo, dt, 1.2, 2, 1e-8, TX=16, rk=rk,
                interpret=True)
    tgeo = TC.kernel_geometry(trv, tqv)
    trows = TC.inflow_rows(TC.ops.midpoint_on_axis(tqv), t0, dt, 2, js)
    tPe = torch.tensor(np.asarray(Pe))
    return dict(jax={k: jax.tree_util.tree_map(np.asarray, v)
                     for k, v in out.items()},
                u=tu, p=tp, geo=tgeo, rows=trows, Pe=tPe, dt=dt, rv=trv,
                qv=tqv, jet=js)


def test_inflow_stack_matches_the_jax_rows(b4_case):
    """Rows s and s + 1 of the port's stack are the JAX rows at t and
    t + dt, accumulated as its loops accumulate them."""
    (_, _, _, jqv), _, dt, js = scheme_inputs(nr=128, num_decades=0.5,
                                              seed=2)
    qc = JOPS.midpoint_on_axis(jqv)
    for s, t in enumerate((0.4, 0.4 + dt, 0.4 + dt + dt)):
        r = JC._inflow_row(qc, t, js)
        close(b4_case["rows"][s], np.stack([r[0, :, k] for k in range(5)]))


def test_plain_b4a_matches_jax_b4a(b4_case):
    c = b4_case
    got = TCU.flux_update_plain(c["Pe"], c["u"], c["geo"], c["dt"], 1.2, 2)
    close(got, c["jax"]["b4a"], B4_TOL)


@pytest.mark.parametrize("start", ["warm", "cold"])
def test_plain_b4b_matches_jax_b4b(b4_case, start):
    """One stage, and cloud's floored carry against the JAX kernel's
    pout."""
    c = b4_case
    p = c["p"] if start == "warm" else torch.zeros_like(c["p"])
    u1, p1 = TCU.stage_plain(c["rows"][0], c["u"], p, c["geo"], c["dt"],
                             1.2, 2, 1e-8)
    ju, jp = c["jax"][f"b4b_{start}"]
    close(u1, ju, B4_TOL)
    close(p1, jp, P_TOL)


def test_plain_b4c_matches_jax_b4c(b4_case):
    c = b4_case
    u, p = TCU.step_rk2_plain(c["rows"][0], c["rows"][1], c["u"], c["p"],
                              c["geo"], c["dt"], 1.2, 2, 1e-8)
    close(u, c["jax"]["b4c"][0], B4_TOL)
    close(p, c["jax"]["b4c"][1], P_TOL)


@pytest.mark.parametrize("rk", [1, 2])
def test_plain_b4d_matches_jax_b4d(b4_case, rk):
    c = b4_case
    u, p = TCU.run_n_plain(c["rows"], c["u"], c["p"], c["geo"], c["dt"],
                           1.2, 2, 1e-8, rk=rk)
    close(u, c["jax"][f"b4d_rk{rk}"][0], B4_TOL)
    close(p, c["jax"][f"b4d_rk{rk}"][1], P_TOL)


def test_plain_stage_matches_the_scheme_stage(b4_case):
    """B4b's plain version against the scheme's stage (the JAX package's
    kernel-against-jnp bar, tests/test_subprogram_cloud.py:242-245, is
    rtol 5e-5 in float32; in float64 the two meet at round-off and the
    Newton's stopping tolerance)."""
    c = b4_case
    u1, p1 = TCU.stage_plain(c["rows"][0], c["u"], c["p"], c["geo"],
                             c["dt"], 1.2, 2, 1e-8)
    want, pw = TC._advance_once_soa(c["u"], 0.4,
                                    TC.make_geometry(c["rv"], c["qv"]),
                                    c["jet"], c["dt"], 1.2, 2, 1e-8, c["p"])
    close(u1, want, dict(rtol=1e-10, atol=1e-14))
    close(p1, pw, dict(rtol=1e-10, atol=1e-14))


# -----------------------------------------------------------------------------
# the shock locators, batched; the diagnostics
# -----------------------------------------------------------------------------

def test_batched_locators_match_the_jax_vmap():
    rng = np.random.default_rng(12)
    x = np.arange(60, dtype=float)
    shocks = rng.integers(0, 60, size=17)
    p = np.stack([np.where(x <= s, 1.0 + 0.5 * np.exp(-(s - x) / 9.0),
                           1e-3 * np.exp(-(x - s) / 4.0) + 1e-6)
                  for s in shocks]) * (1.0 + 1e-3 * rng.uniform(
                      size=(17, 60)))
    s = np.log(p / np.linspace(1.0, 2.0, 60) ** (4.0 / 3.0))
    tp = torch.tensor(p)
    mid = TSHOCK.find_shock_index(torch.tensor(s))
    jmid = jax.vmap(JSHOCK.find_shock_index)(jnp.asarray(s))
    np.testing.assert_array_equal(mid.numpy(), np.asarray(jmid))
    for fn in ("find_index_of_maximum_behind",
               "find_index_of_pressure_plateau_ahead",
               "find_index_of_maximum_pressure_behind"):
        got = getattr(TSHOCK, fn)(tp, mid)
        want = jax.vmap(getattr(JSHOCK, fn))(jnp.asarray(p), jmid)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        # a batch of one profile is the 1-D call
        for b in (0, 5):
            assert int(getattr(TSHOCK, fn)(tp[b], int(mid[b]))) == int(
                got[b])


def test_diagnostic_fields_match_jax():
    (ju, _, jrv, jqv), (tu, _, trv, tqv), _, _ = scheme_inputs(seed=3)
    jcfg, tcfg = configs(nr=32, num_decades=1.0)
    js = JC.Solution(0.7, 3, jrv, jqv, jnp.moveaxis(ju, 0, -1))
    ts = TC.Solution(0.7, 3, trv, tqv, tu.permute(1, 2, 0))
    want = JC.make_diagnostic_fields(js, jcfg)
    got = TC.make_diagnostic_fields(ts, tcfg)
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], dict(rtol=1e-10, atol=0.0))


# -----------------------------------------------------------------------------
# the driver loops, the CLI, checkpoints across the two packages
# -----------------------------------------------------------------------------

ARGS = ["cloud", "nr=32", "tfinal=0.1", "cpi=0.05", "dfi=0.05", "tsi=0.05"]


def run_jax(argv, cwd):
    old = os.getcwd()
    os.chdir(cwd)
    try:
        return JC.main(argv)
    finally:
        os.chdir(old)


def read_solution(path):
    with h5py.File(path, "r") as f:
        return {k: f["solution"][k][()] for k in f["solution"]}


@pytest.mark.parametrize("extra", [[], ["rk_order=2", "reconstruct_method=1"]])
def test_cli_writes_the_jax_package_files(tmp_path, extra):
    """The same command line in both packages writes the same files, with
    the same groups and datasets, to round-off."""
    argv = ARGS + extra
    assert run_jax(argv + [f"outdir={tmp_path / 'j'}"], tmp_path) == 0
    assert TC.main(argv + [f"outdir={tmp_path / 't'}"], device="cpu",
                   dtype=torch.float64) == 0
    files = set(os.listdir(tmp_path / "j"))
    assert files == set(os.listdir(tmp_path / "t"))
    assert {"chkpt.0000.h5", "chkpt.0002.h5", "diagnostics.0002.h5",
            "time_series.h5"} <= files
    for name in sorted(files):
        with h5py.File(tmp_path / "j" / name) as fj, \
                h5py.File(tmp_path / "t" / name) as ft:
            assert set(fj) == set(ft), name
            if name.startswith("chkpt"):
                assert set(fj["solution"]) == set(ft["solution"])
                for k in fj["solution"]:
                    a, b = fj["solution"][k][()], ft["solution"][k][()]
                    assert np.asarray(a).dtype == np.asarray(b).dtype, k
                    close(b, a, RUN_TOL)
            elif name.startswith("diagnostics"):
                for k in fj:
                    close(ft[k][()], fj[k][()], DIAG_TOL)
            else:
                for k in ("time", "shock_radius"):
                    assert fj[k].shape == ft[k].shape == (0,)


def test_jax_checkpoint_restarts_in_port(tmp_path):
    """restart=<a JAX checkpoint>: the port reads its solution exactly and
    continues as the JAX package does (both restart their Newton from
    p = 0)."""
    j, t = tmp_path / "j", tmp_path / "t"
    assert run_jax(ARGS + [f"outdir={j}"], tmp_path) == 0
    shutil.copytree(j, t)
    chk = "chkpt.0001.h5"
    cfg, state = TC.setup(["cloud", f"restart={t / chk}", f"outdir={t}"],
                          device="cpu", dtype=torch.float64)
    s = read_solution(j / chk)
    for k in ("conserved", "radial_vertices", "polar_vertices"):
        np.testing.assert_array_equal(
            getattr(state.solution, k).numpy(), s[k])
    assert (state.solution.iteration, state.solution.time) == \
        (s["iteration"], s["time"])
    assert state.schedule.num_times_performed("write_checkpoint") == 2
    again = TC.solution_from_arrays(s)
    assert torch.equal(again.conserved, state.solution.conserved)
    assert run_jax(["cloud", f"restart={j / chk}", "tfinal=0.15"],
                   tmp_path) == 0
    assert TC.main(["cloud", f"restart={t / chk}", "tfinal=0.15",
                    f"outdir={t}"], device="cpu", dtype=torch.float64) == 0
    want, got = (read_solution(d / "chkpt.0003.h5") for d in (j, t))
    assert got["iteration"] == want["iteration"]
    close(got["conserved"], want["conserved"], RUN_TOL)


def test_port_checkpoint_restarts_in_jax(tmp_path):
    """A checkpoint the port wrote (float64) restarts in the JAX package,
    which continues as the port does; solution_to_arrays is the inverse of
    solution_from_arrays."""
    j, t = tmp_path / "j", tmp_path / "t"
    assert TC.main(ARGS + [f"outdir={t}"], device="cpu",
                   dtype=torch.float64) == 0
    shutil.copytree(t, j)
    assert run_jax(["cloud", f"restart={j / 'chkpt.0001.h5'}",
                    "tfinal=0.15", f"outdir={j}"], tmp_path) == 0
    assert TC.main(["cloud", f"restart={t / 'chkpt.0001.h5'}",
                    "tfinal=0.15"], device="cpu", dtype=torch.float64) == 0
    want, got = (read_solution(d / "chkpt.0003.h5") for d in (t, j))
    assert got["conserved"].dtype == np.float64
    assert got["iteration"] == want["iteration"]
    close(got["conserved"], want["conserved"], RUN_TOL)
    back = TC.solution_to_arrays(TC.solution_from_arrays(want))
    for k in want:
        np.testing.assert_array_equal(back[k], want[k])


def test_fast_driver_matches_host_driver(tmp_path):
    """fast_step=1 (the chunked loop) reproduces the per-step loop: the
    same checkpoints and final time, the state at round-off (the JAX
    package's test, through the port)."""
    for sub, flag in (("host", "fast_step=0"), ("fast", "fast_step=1")):
        assert TC.main(ARGS + [flag, f"outdir={tmp_path / sub}"],
                       device="cpu", dtype=torch.float64) == 0

    def last(d):
        names = sorted(f for f in os.listdir(d) if f.startswith("chkpt"))
        with h5py.File(d / names[-1]) as f:
            return names, f["solution/conserved"][()], f["solution/time"][()]

    nh, uh, th = last(tmp_path / "host")
    nf, uf, tf = last(tmp_path / "fast")
    assert nh == nf
    np.testing.assert_allclose(tf, th, rtol=1e-12)
    np.testing.assert_allclose(uf, uh, rtol=1e-9, atol=1e-14)


def run_port(*args, cwd, selector=True):
    env = {k: v for k, v in os.environ.items() if k != DEVICE_SELECTOR}
    env["PYTHONPATH"] = REPO
    if selector:
        env[DEVICE_SELECTOR] = "cpu"
    return subprocess.run([sys.executable, "-m", "mara3_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_on_the_cpu_and_without_a_card(tmp_path):
    """python -m mara3_tpu_torch cloud ... with the CPU selector writes the
    files (float32, the scheme); without it, and without a card, it
    refuses to start."""
    args = ("cloud", "nr=32", "tfinal=0.1", "cpi=0.05")
    proc = run_port(*args, cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "the scheme (torch ops) on the CPU" in proc.stdout
    assert {"chkpt.0000.h5", "chkpt.0002.h5", "diagnostics.0000.h5",
            "time_series.h5"} <= set(os.listdir(tmp_path / "data"))
    s = read_solution(tmp_path / "data" / "chkpt.0002.h5")
    assert s["conserved"].dtype == s["radial_vertices"].dtype == np.float32
    refused = run_port(*args, cwd=str(tmp_path), selector=False)
    assert refused.returncode != 0
    assert f"{DEVICE_SELECTOR}=cpu" in refused.stderr


def test_no_card_and_no_selector_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match=DEVICE_SELECTOR):
        TC.setup(["cloud", "nr=16"])


@pytest.mark.parametrize("arg,match", [("reconstruct_method=3", "pcm"),
                                       ("rk_order=3", "rk_order")])
def test_unknown_options_raise(arg, match):
    with pytest.raises(ValueError, match=match):
        TC.setup(["cloud", "nr=16", arg], device="cpu")


ERG_FIELDS = ("radial_energy_flow", "total_energy_at_theta",
              "postshock_flow_power", "postshock_flow_power02",
              "postshock_flow_power04", "postshock_flow_power08",
              "postshock_flow_power16", "postshock_flow_power32",
              "postshock_flow_power64", "postshock_flow_power_max")


def test_float32_diagnostics_in_erg_are_finite():
    """In float32 the fields in erg and erg/s (units of order 1e52)
    overflow to inf in the JAX package; the port forms them in float64, so
    they are finite, and equal the same fields formed from the state cast
    to float64 at float32's resolution. The other fields still match the
    JAX package's at float32 round-off, on a hot state (so that the float32
    recovery is well conditioned), except the shock radii located by
    argmax over near-flat entropy and luminosity profiles: the midpoint's
    float32 ties fall apart differently in the two packages, and the
    luminosity locator now sees finite flows where the JAX one sees inf."""
    jcfg, tcfg = configs(nr=32)
    js = JC.new_solution(jcfg)
    u = np.array(js.conserved)
    u[..., 4] += 0.5 * u[..., 0]
    rv = np.asarray(js.radial_vertices, np.float32)
    qv = np.asarray(js.polar_vertices, np.float32)
    u32 = u.astype(np.float32)
    want = JC.make_diagnostic_fields(
        JC.Solution(js.time, js.iteration, jnp.asarray(rv), jnp.asarray(qv),
                    jnp.asarray(u32)), jcfg)
    ts = TC.Solution(js.time, js.iteration, torch.tensor(rv),
                     torch.tensor(qv), torch.tensor(u32))
    got = TC.make_diagnostic_fields(ts, tcfg)
    wide = TC.make_diagnostic_fields(
        TC.Solution(js.time, js.iteration, torch.tensor(rv).double(),
                    torch.tensor(qv).double(), torch.tensor(u32).double()),
        tcfg)
    assert set(got) == set(want)
    for k in ERG_FIELDS:
        g = got[k].numpy()
        assert g.dtype == np.float64 and np.isfinite(g).all(), k
        assert np.isinf(np.asarray(want[k])).any(), k
    for k in ("radial_energy_flow", "total_energy_at_theta"):
        close(got[k], wide[k], dict(rtol=1e-4, atol=0.0))
    for k in set(want) - set(ERG_FIELDS) - {"shock_midpoint_radius",
                                           "shock_luminosity_radius"}:
        g = got[k].numpy() if torch.is_tensor(got[k]) else np.asarray(got[k])
        assert g.dtype == np.asarray(want[k]).dtype, k
        close(got[k], want[k], dict(rtol=5e-5, atol=0.0))
