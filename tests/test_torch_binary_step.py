"""The port's device-resident flagship step against the JAX package's:
models/two_body_device.py against models/two_body_jax.py, and
schemes/binary_step.py (make_fast_step, make_fast_scan, the fault repair)
against mara3_tpu/schemes/binary_step.py, on the CPU in float64; plus the
resolution of fast_step and multi_launch and the device selector.

Where the orbit is near-circular (the default, eccentricity 0) the element
inversion is ill-conditioned: an ulp of a body position moves the inverted
eccentricity, and through it the gauge angles pomega and tau, by many
orders more (the JAX package's own tests split those out). So the tests
that evolve the elements live run an eccentric binary (eccentricity 0.3),
where the inversion is well-conditioned, and compare the gauge angles of
the near-circular perturbation elements at a stated absolute bar."""

import math
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mara3_tpu.models import two_body as jtb
from mara3_tpu.models import two_body_jax as tbj
from mara3_tpu.schemes import binary_step as JS
from mara3_tpu.subprograms import binary as JB
from mara3_tpu_torch.models import two_body as ttb
from mara3_tpu_torch.models import two_body_device as tbd
from mara3_tpu_torch.schemes import binary_step as TS
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64

# the bars of tests/test_torch_binary.py::test_five_steps_match_jax for
# steps of the port against the JAX package: the state at
# rtol 1e-11, the totals at rtol 1e-10 (atol 1e-17: they start at zero) and
# the elements at rtol 1e-10 (atol 1e-13). The accretion work is a
# difference of nearly equal squares (of momenta about 0.25) whose last
# bits depend on where XLA fuses a multiply-add, so it is held to 1e-16
# absolute, a few ulps of those squares.
STATE = dict(rtol=1e-11, atol=1e-20)
TOTALS = dict(rtol=1e-10, atol=1e-17)
WORK = dict(rtol=1e-10, atol=1e-16)
ELEMENTS = dict(rtol=1e-10, atol=1e-13)
# near-circular perturbation elements: the inverted eccentricity (about
# 1e-6 here) is the square root of a cancellation, and it sets the gauge
# angles pomega and tau; those three are held at this absolute bar
GAUGE = [0, 1, 9]
GAUGE_ATOL = 1e-8
ECCENTRIC = {"eccentricity": 0.3}


def t64(x):
    return torch.tensor(np.asarray(x), dtype=F64)


def full_elements(ecc, pomega=0.3, tau=0.2, q=0.5):
    return jtb.FullOrbitalElements(
        pomega=pomega, tau=tau, cm_position_x=0.01, cm_velocity_y=-0.02,
        elements=jtb.OrbitalElements(1.0, 1.0, q, ecc))


# -----------------------------------------------------------------------------
# models/two_body_device.py
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("ecc", [0.0, 0.3, 0.9])
def test_two_body_device_bodies_match_jax(ecc):
    """Bodies from the fixed-count Kepler solve at several times, one at a
    time and batched over the times: rtol 1e-13."""
    e = tbj.pack_elements(full_elements(ecc))
    times = [0.0, 0.9, 7.5, -3.2]
    want = np.stack([np.asarray(tbj.compute_two_body_state(e, t))
                     for t in times])
    batched = tbd.compute_two_body_state(t64(e), t64(times)).numpy()
    np.testing.assert_allclose(batched, want, rtol=1e-13, atol=1e-15)
    for t, w in zip(times, want):
        got = tbd.compute_two_body_state(t64(e), t64(t)).numpy()
        np.testing.assert_allclose(got, w, rtol=1e-13, atol=1e-15)


@pytest.mark.parametrize("ecc,q", [(0.3, 0.5), (0.9, 1.0), (0.5, 0.2)])
def test_two_body_device_elements_match_jax(ecc, q):
    """The inversion of a well-conditioned (eccentric) state: rtol 1e-12."""
    e = tbj.pack_elements(full_elements(ecc, q=q))
    for t in (0.0, 0.9, 7.5):
        bodies = tbj.compute_two_body_state(e, t)
        want = np.asarray(tbj.compute_orbital_elements(bodies, t))
        got = tbd.compute_orbital_elements(t64(bodies), t64(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)


def test_two_body_device_near_circular_matches_jax():
    """A near-circular orbit (e = 1e-3) round-trips through bodies and the
    inversion as in the JAX package: atol 1e-10 on every component."""
    e = tbj.pack_elements(full_elements(1e-3))
    for t in (0.0, 0.9, 7.5):
        bodies = tbj.compute_two_body_state(e, t)
        want = np.asarray(tbj.compute_orbital_elements(bodies, t))
        got = tbd.compute_orbital_elements(t64(bodies), t64(t)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-10)


@pytest.mark.parametrize("pomega,tau", [(6.2, 0.1), (0.1, 6.2), (3.0, 3.1),
                                        (-3.1, 6.0)])
def test_two_body_device_diffs_match_jax(pomega, tau):
    """diff wraps pomega mod 2 pi and tau mod the second argument's period
    (both directions of each wrap); diff_cm and the period."""
    a = full_elements(0.3)
    b = full_elements(0.2, pomega=pomega, tau=tau, q=0.7)
    ja, jb = tbj.pack_elements(a), tbj.pack_elements(b)
    np.testing.assert_allclose(tbd.diff(t64(ja), t64(jb)).numpy(),
                               np.asarray(tbj.diff(ja, jb)), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(tbd.diff(t64(jb), t64(ja)).numpy(),
                               np.asarray(tbj.diff(jb, ja)), rtol=1e-14,
                               atol=1e-15)
    np.testing.assert_allclose(tbd.diff_cm(t64(ja), t64(0.1)).numpy(),
                               np.asarray(tbj.diff_cm(ja, 0.1)), rtol=1e-15)
    assert float(tbd.orbital_period(t64(jb))) == pytest.approx(
        float(tbj.orbital_period(jb)), rel=1e-15)


def test_two_body_device_packing_round_trips():
    fe = ttb.FullOrbitalElements(
        pomega=0.3, tau=0.2, cm_position_x=0.01, cm_velocity_y=-0.02,
        elements=ttb.OrbitalElements(1.3, 1.0, 0.4, 0.1))
    e10 = tbd.pack_elements(fe)
    assert e10.dtype == F64 and e10.shape == (10,)
    assert tbd.unpack_elements(e10.numpy()) == fe


# -----------------------------------------------------------------------------
# schemes/binary_step.py
# -----------------------------------------------------------------------------

def pair(over, base=None):
    """The same config in both packages and the same start state: the JAX
    package's fast-step state, and the port's made from it."""
    base = base or {"depth": 3, "block_size": 8}
    jcfg = JB.create_config_template().create().update({**base, **over})
    tcfg = TB.create_config_template().create().update({**base, **over})
    jsd = JB.create_solver_data(jcfg)
    tsd = TB.create_solver_data(tcfg, device="cpu", dtype=F64)
    js = JS.solution_to_arrays(JB.create_solution(jcfg, jsd), jnp.float64)
    ts = TB.fast_state_from_arrays(host(js), tsd)
    return jsd, tsd, js, ts


def host(js):
    return {k: np.asarray(v) for k, v in js.items()}


def assert_elements_close(got, want, name, gauge_atol=None, **bars):
    """Packed elements: all ten at `bars`, or with gauge_atol, the GAUGE
    components at that absolute bar and the rest at `bars`."""
    got, want = np.asarray(got), np.asarray(want)
    if gauge_atol is None:
        np.testing.assert_allclose(got, want, err_msg=name, **bars)
        return
    rest = [j for j in range(10) if j not in GAUGE]
    np.testing.assert_allclose(got[rest], want[rest], err_msg=name, **bars)
    np.testing.assert_allclose(got[GAUGE], want[GAUGE], rtol=0,
                               atol=gauge_atol, err_msg=f"{name} (gauge)")


def assert_states_close(ts, js, state=STATE, totals=TOTALS, work=WORK,
                        elements=ELEMENTS, gauge_atol=None):
    """A port state against a JAX fast-step state (host arrays)."""
    got = TB.fast_state_to_arrays(ts)
    assert got["iteration"] == int(js["iteration"])
    np.testing.assert_allclose(got["time"], js["time"], rtol=1e-14)
    np.testing.assert_allclose(got["conserved"], js["conserved"], **state)
    for key in ("mass_accreted_on", "angular_momentum_accreted_on",
                "integrated_torque_on", "mass_ejected",
                "angular_momentum_ejected"):
        np.testing.assert_allclose(got[key], js[key], err_msg=key, **totals)
    np.testing.assert_allclose(got["work_done_on"], js["work_done_on"],
                               err_msg="work_done_on", **work)
    for key in ("oe_acc", "oe_grav", "oe"):
        assert_elements_close(got[key], js[key], key, gauge_atol, **elements)


@pytest.mark.parametrize("rk_order", [1, 2])
@pytest.mark.parametrize("conserve_p", [1, 0])
def test_fast_step_matches_jax(rk_order, conserve_p):
    """Five device-resident steps with the binary live from t = 0 (an
    eccentric orbit): the state, every accumulated total and the elements
    at the bars above; the info scalars likewise."""
    jsd, tsd, js, ts = pair({"rk_order": rk_order,
                             "conserve_linear_p": conserve_p,
                             "begin_live_binary": 0.0, **ECCENTRIC})
    jstep, tstep = JS.make_fast_step(jsd), TS.make_fast_step(tsd)
    for _ in range(5):
        js, jinfo = jstep(js)
        ts, tinfo = tstep(ts)
    assert not bool(tinfo["retried"]) and not bool(tinfo["invalid"])
    assert_states_close(ts, host(js))
    for key in ("dt", "disk_mass", "disk_angular_momentum"):
        np.testing.assert_allclose(float(tinfo[key]), float(jinfo[key]),
                                   rtol=1e-11, err_msg=key)


def test_fast_step_safe_retry_matches_jax():
    """An over-CFL fixed dt faults the step; the retrying step reruns it at
    dt/10 with theta = 0 and lands where the JAX package's in-graph retry
    lands: same dt, same retried flag, the state at the bars above."""
    over = {"fixed_dt": 1, "cfl_number": 6.0}
    jsd, tsd, js, ts = pair(over)
    js, jinfo = JS.make_fast_step(jsd)(js)
    ts, tinfo = TS.make_fast_step(tsd)(ts)
    assert bool(tinfo["retried"]) and bool(jinfo["retried"])
    assert not bool(tinfo["invalid"]) and not bool(jinfo["invalid"])
    assert float(tinfo["dt"]) == float(jinfo["dt"])
    assert_states_close(ts, host(js), gauge_atol=GAUGE_ATOL)


def test_fast_scan_rows_and_state_match_jax():
    """Eight retry-free steps in one scan: the packed info rows and the
    state against the JAX package's scan (default near-circular binary,
    not live)."""
    jsd, tsd, js, ts = pair({})
    js, jrows = JS.make_fast_scan(jsd)(js, 8)
    ts, trows = TS.make_fast_scan(tsd)(ts, 8)
    assert trows.shape == (8, TS.INFO_WIDTH) and trows.dtype == F64
    np.testing.assert_allclose(trows.numpy(), np.asarray(jrows),
                               rtol=1e-13, atol=0)
    assert_states_close(ts, host(js), gauge_atol=GAUGE_ATOL)


def test_fast_scan_repair_matches_retrying_steps():
    """The driver's fault protocol: a retry-free chunk whose rows flag a
    negative density is rewound, its good steps replayed and the faulted
    step run through the retrying step. The result equals stepping with the
    retrying step throughout (the JAX package's
    test_retry_free_scan_plus_repair_matches_cond_steps, on the port)."""
    cfg = TB.create_config_template().create().update(
        {"depth": 3, "block_size": 8, "fixed_dt": 1, "cfl_number": 3.0,
         "rk_order": 1})
    sd = TB.create_solver_data(cfg, device="cpu", dtype=F64)
    s0 = TS.solution_to_arrays(TB.create_solution(cfg, sd))
    IX = TS.INFO_INDEX
    scan, retrying = TS.make_fast_scan(sd), TS.make_fast_step(sd)

    s_ref, retried = s0, []
    for _ in range(4):
        s_ref, info = retrying(s_ref)
        retried.append(bool(info["retried"]))
        assert not bool(info["invalid"])
    assert any(retried), "the config should fault at least one step"

    s, done = s0, 0
    while done < 4:
        s_prev = s
        s, rows = scan(s, 4 - done)
        inv = rows[:, IX["invalid"]].numpy() > 0
        if not inv.any():
            done = 4
            continue
        bad = int(np.argmax(inv))
        s = s_prev
        if bad:
            s, _ = scan(s, bad)
        s, info = retrying(s)
        assert not bool(info["invalid"])
        done += bad + 1
    assert torch.equal(s["conserved"], s_ref["conserved"])
    assert float(s["time"]) == float(s_ref["time"])


def test_fast_state_crosses_packages():
    """A JAX fast-step state becomes the port's and back unchanged, and
    the Solution converters round-trip."""
    jsd, tsd, js, ts = pair({"conserve_linear_p": 0})
    js = host(JS.make_fast_step(jsd)(js)[0])
    ts = TB.fast_state_from_arrays(js, tsd)
    assert ts["conserved"].shape == (len(tsd.leaves), 8, 8, 3)
    back = TB.fast_state_to_arrays(ts)
    assert set(back) == set(js)
    for key in js:
        np.testing.assert_array_equal(back[key], js[key], err_msg=key)
    sol = TS.arrays_to_solution(ts, TB.Solution)
    again = TB.fast_state_to_arrays(TS.solution_to_arrays(sol))
    for key in js:
        np.testing.assert_array_equal(again[key], js[key], err_msg=key)


# -----------------------------------------------------------------------------
# option resolution and the device
# -----------------------------------------------------------------------------

def config(*args):
    return TB.driver.create_run_config(TB.create_config_template(),
                                       ["binary", *args])


@pytest.mark.parametrize("device,fast,multi", [("cpu", 0, 0),
                                               ("cuda", 1, 16)])
def test_auto_options_resolve_by_device(device, fast, multi):
    """fast_step=-1 and multi_launch=-1 (the defaults) resolve to 1 and 16
    on a CUDA device, as the JAX package resolves them on a TPU, and to 0
    and 0 on the CPU (a unit test: no card is needed to resolve)."""
    cfg = TB.resolve_options(config(), torch.device(device))
    assert cfg.get_int("fast_step") == fast
    assert cfg.get_int("multi_launch") == multi
    assert TB.resolve_multi_launch(-1, device) == multi
    assert TB.resolve_multi_launch(0, "cuda") == 0
    assert TB.resolve_multi_launch(8, "cpu") == 8


@pytest.mark.parametrize("args,fast,multi", [
    (("fast_step=1",), 1, 0), (("multi_launch=4",), 0, 4),
    (("fast_step=1", "multi_launch=4"), 1, 4), (("fast_step=0",), 0, 0)])
def test_explicit_options_are_kept(args, fast, multi):
    cfg = TB.resolve_options(config(*args), torch.device("cpu"))
    assert cfg.get_int("fast_step") == fast
    assert cfg.get_int("multi_launch") == multi


def test_no_card_and_no_selector_raises():
    """Without a card the port does not fall back to the CPU: the solver
    data raises, naming the CPU selector, and the command line (with every
    card hidden) exits non-zero with the same message."""
    cfg = TB.create_config_template().create().update(
        {"depth": 2, "block_size": 8})
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match=TB.DEVICE_SELECTOR):
            TB.create_solver_data(cfg)
    env = {k: v for k, v in os.environ.items() if k != TB.DEVICE_SELECTOR}
    env.update(PYTHONPATH=REPO, CUDA_VISIBLE_DEVICES="")
    cmd = [sys.executable, "-m", "mara3_tpu_torch", "binary", "depth=2",
           "block_size=8", "tfinal=0.005", "outdir=out"]
    proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode != 0
    assert f"{TB.DEVICE_SELECTOR}=cpu" in proc.stderr
    assert not os.path.exists(os.path.join(REPO, "out"))


def test_fast_loop_runs_float32_to_tfinal():
    """The fast loop in float32 (the card's dtype), whose device time is
    re-anchored each chunk to a float64 sum of the dt used, runs to
    tfinal."""
    cfg = TB.resolve_options(config("depth=3", "block_size=8",
                                    "tfinal=0.02", "fast_step=1"),
                             torch.device("cpu"))
    sd = TB.create_solver_data(cfg, device="cpu", dtype=torch.float32)
    state = TB.create_state(cfg, sd)
    final = TB._main_fast(cfg, sd, state, lambda st, _: st)
    assert final.solution.iteration >= 2
    assert final.solution.time / (2 * math.pi) >= 0.02
