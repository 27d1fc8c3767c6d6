"""The port's K-steps-per-launch scan (schemes/binary_step.make_multi_scan
over kernels/binary_multi.advance_k, kernel B3's plain version on the CPU)
against the JAX package's make_multi_scan (kernel B3 in interpret mode),
and against the port's own per-step scan; and the fast driver loop with
multi_launch against the JAX package's main. float64, depth 3 / block 16.

Against the JAX package the ceiling is the JAX test's own bars
(tests/test_binary_multi.py), which its B3 meets against its per-step
scan: that kernel rebuilds cell positions from an iota, the port's from
the geometry's coordinate rows. The near-circular default orbit makes the
perturbation elements' eccentricity and gauge angles ill-conditioned (see
tests/test_torch_binary_step.py), so those three components are held at an
absolute bar, and the live cases run an eccentric binary.

Against the port's per-step scan the multi scan is the same arithmetic in
another grouping: the state and the info rows agree to rtol 1e-14 (they
are equal here), the accumulated totals and elements to rtol 1e-13."""

import os

import h5py
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mara3_tpu.schemes import binary_step as JS
from mara3_tpu.subprograms import binary as JB
from mara3_tpu_torch.kernels import binary_multi as TM
from mara3_tpu_torch.schemes import binary_step as TS
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

F64 = torch.float64
GAUGE = [0, 1, 9]         # pomega, tau, e
GAUGE_ATOL = 1e-8
ECCENTRIC = {"eccentricity": 0.3}
TOTAL_KEYS = ("mass_accreted_on", "angular_momentum_accreted_on",
              "integrated_torque_on", "work_done_on", "mass_ejected",
              "angular_momentum_ejected")
ELEMENT_KEYS = ("oe_acc", "oe_grav", "oe")

# the JAX test's bars per case: (dt and time rtol, state, totals, elements,
# gauge components); gauge None = every element at the elements' bar
JAX_BARS = {
    "rk1": (1e-12, dict(rtol=1e-10, atol=1e-13),
            dict(rtol=1e-8, atol=1e-12), dict(rtol=1e-8, atol=1e-12),
            GAUGE_ATOL),
    "rk2": (1e-12, dict(rtol=1e-10, atol=1e-13),
            dict(rtol=1e-6, atol=1e-10), dict(rtol=1e-6, atol=1e-10),
            GAUGE_ATOL),
    "angmom": (1e-10, dict(rtol=1e-9, atol=1e-12),
               dict(rtol=1e-6, atol=1e-10), dict(rtol=1e-6, atol=1e-10),
               GAUGE_ATOL),
    "live": (1e-8, dict(rtol=1e-8, atol=1e-11),
             dict(rtol=1e-6, atol=1e-9), dict(rtol=1e-6, atol=1e-9), None),
}
CASES = {
    # name: (config, steps, k, live, bars)
    "rk1": ({"rk_order": 1}, 8, 4, False, "rk1"),
    "rk2": ({"rk_order": 2}, 8, 4, False, "rk2"),
    "hllc": ({"rk_order": 1, "riemann": "hllc"}, 4, 4, False, "rk1"),
    "angmom": ({"rk_order": 1, "conserve_linear_p": 0}, 4, 4, False,
               "angmom"),
    "live-rk1": ({"rk_order": 1, "begin_live_binary": 0.0, **ECCENTRIC}, 8,
                 4, True, "live"),
    "live-rk2": ({"rk_order": 2, "begin_live_binary": 0.0, **ECCENTRIC}, 8,
                 4, True, "live"),
}


def setup_pair(over):
    base = {"depth": 3, "block_size": 16}
    jcfg = JB.create_config_template().create().update({**base, **over})
    tcfg = TB.create_config_template().create().update({**base, **over})
    jsd = JB.create_solver_data(jcfg)
    tsd = TB.create_solver_data(tcfg, device="cpu", dtype=F64)
    js = JS.solution_to_arrays(JB.create_solution(jcfg, jsd), jnp.float64)
    ts = TB.fast_state_from_arrays(host(js), tsd)
    return jsd, tsd, js, ts


def host(js):
    return {k: np.asarray(v) for k, v in js.items()}


def assert_elements_close(got, want, name, gauge_atol, **bars):
    got, want = np.asarray(got), np.asarray(want)
    if gauge_atol is None:
        np.testing.assert_allclose(got, want, err_msg=name, **bars)
        return
    rest = [j for j in range(10) if j not in GAUGE]
    np.testing.assert_allclose(got[rest], want[rest], err_msg=name, **bars)
    np.testing.assert_allclose(got[GAUGE], want[GAUGE], rtol=0,
                               atol=gauge_atol, err_msg=f"{name} (gauge)")


def assert_rows_close(trows, jrows, rtol):
    I = TS.INFO_INDEX
    for key in ("dt", "time"):
        np.testing.assert_allclose(trows[:, I[key]], jrows[:, I[key]],
                                   rtol=rtol, err_msg=key)
    np.testing.assert_array_equal(trows[:, I["iteration"]],
                                  jrows[:, I["iteration"]])
    np.testing.assert_array_equal(trows[:, I["invalid"]],
                                  jrows[:, I["invalid"]])


@pytest.mark.parametrize("case", list(CASES))
def test_multi_scan_matches_jax_and_the_per_step_scan(case):
    over, n, k, live, bars = CASES[case]
    t_rtol, state, totals, elements, gauge = JAX_BARS[bars]
    jsd, tsd, js, ts = setup_pair(over)
    js_m, jrows = JS.make_multi_scan(jsd, k_chunk=k, live=live)(dict(js), n)
    ts_m, trows = TS.make_multi_scan(tsd, k_chunk=k)(dict(ts), n)
    jrows, trows = np.asarray(jrows), trows.numpy()
    assert trows.shape == (n, TS.INFO_WIDTH)
    assert not trows[:, TS.INFO_INDEX["invalid"]].any()

    # against the JAX package's B3, at its own test's bars
    assert_rows_close(trows, jrows, t_rtol)
    got, want = TB.fast_state_to_arrays(ts_m), host(js_m)
    assert got["iteration"] == int(want["iteration"]) == n
    np.testing.assert_allclose(got["time"], want["time"], rtol=t_rtol)
    np.testing.assert_allclose(got["conserved"], want["conserved"], **state)
    for key in TOTAL_KEYS:
        np.testing.assert_allclose(got[key], want[key], err_msg=key,
                                   **totals)
    for key in ELEMENT_KEYS:
        assert_elements_close(got[key], want[key], key, gauge, **elements)
    if live:   # the elements moved
        assert not np.array_equal(got["oe"], host(js)["oe"])

    # against the port's own per-step scan, at the tighter bar
    ts_f, frows = TS.make_fast_scan(tsd)(dict(ts), n)
    np.testing.assert_allclose(trows, frows.numpy(), rtol=1e-14, atol=0)
    fast = TB.fast_state_to_arrays(ts_f)
    np.testing.assert_allclose(got["conserved"], fast["conserved"],
                               rtol=1e-14, atol=0)
    for key in TOTAL_KEYS:
        np.testing.assert_allclose(got[key], fast[key], rtol=1e-13,
                                   atol=1e-24, err_msg=key)
    for key in ELEMENT_KEYS:
        np.testing.assert_allclose(got[key], fast[key], rtol=1e-13,
                                   atol=1e-15, err_msg=key)


def test_multi_scan_live_switches_on_mid_launch():
    """A launch that straddles begin_live_binary: the elements stay put
    before it and evolve after it, stage by stage, as in the JAX package
    and in the port's per-step scan."""
    jsd, tsd, js, ts = setup_pair({"rk_order": 1, **ECCENTRIC})
    _, rows = TS.make_fast_scan(tsd)(dict(ts), 2)
    t2 = float(rows[-1, TS.INFO_INDEX["time"]])
    from dataclasses import replace
    jsd = replace(jsd, begin_live_binary=t2)
    tsd = replace(tsd, begin_live_binary=t2)
    js_m, _ = JS.make_multi_scan(jsd, k_chunk=4, live=True)(dict(js), 8)
    ts_m, _ = TS.make_multi_scan(tsd, k_chunk=4)(dict(ts), 8)
    ts_f, _ = TS.make_fast_scan(tsd)(dict(ts), 8)
    _, state, _, elements, _ = JAX_BARS["live"]
    got, want = TB.fast_state_to_arrays(ts_m), host(js_m)
    np.testing.assert_allclose(got["conserved"], want["conserved"], **state)
    assert_elements_close(got["oe"], want["oe"], "oe", None, **elements)
    assert not np.array_equal(got["oe"], host(js)["oe"])
    fast = TB.fast_state_to_arrays(ts_f)
    np.testing.assert_allclose(got["conserved"], fast["conserved"],
                               rtol=1e-14, atol=0)
    np.testing.assert_allclose(got["oe"], fast["oe"], rtol=1e-13, atol=1e-15)


def test_multi_scan_fault_flag_rides_rows():
    """An oversized fixed dt faults inside the launch: the per-step fault
    flags come back in the rows, as the driver's repair needs."""
    from dataclasses import replace
    _, tsd, _, ts = setup_pair({"fixed_dt": 1, "rk_order": 1})
    tsd = replace(tsd, recommended_time_step=50.0, fixed_dt=True)
    _, rows = TS.make_multi_scan(tsd, k_chunk=4)(dict(ts), 4)
    assert rows[:, TS.INFO_INDEX["invalid"]].numpy().any()


def test_multi_scan_scope(monkeypatch):
    """rk_order outside {1, 2} is outside B3's scope: make_multi_scan raises
    NotImplementedError and the driver's scan is the per-step one; a chunk
    that is not a multiple of k runs its remainder as one shorter launch,
    with the per-step scan's results."""
    from dataclasses import replace
    _, tsd, _, ts = setup_pair({})
    with pytest.raises(NotImplementedError, match="rk_order"):
        TS.make_multi_scan(replace(tsd, rk_order=3))
    cfg = TB.create_config_template().create().update(
        {"multi_launch": 4, "fast_step": 1})
    scan = TB.build_scan(cfg, replace(tsd, rk_order=3))
    assert not hasattr(scan, "k_chunk")
    assert TB.build_scan(cfg, tsd).k_chunk == 4

    launched = []
    advance_k = TM.advance_k

    def counting(t, u, e10, t0, mc):
        launched.append(mc.k_steps)
        return advance_k(t, u, e10, t0, mc)

    monkeypatch.setattr(TM, "advance_k", counting)
    s6, rows = TS.make_multi_scan(tsd, k_chunk=4)(dict(ts), 6)
    assert launched == [4, 2]
    assert rows.shape == (6, TS.INFO_WIDTH)
    assert int(s6["iteration"]) == 6
    f6, frows = TS.make_fast_scan(tsd)(dict(ts), 6)
    np.testing.assert_allclose(rows.numpy(), frows.numpy(), rtol=1e-14,
                               atol=0)
    np.testing.assert_allclose(s6["conserved"].numpy(),
                               f6["conserved"].numpy(), rtol=1e-14, atol=0)


def test_advance_k_dispatches_by_device():
    """advance_k runs the plain version for a CPU tensor and never the
    kernel; the kernel's wrapper refuses a CPU tensor."""
    _, tsd, _, ts = setup_pair({})
    t = tsd.advance.tables
    mc = TS.multi_config(tsd, 2)
    before = TM.advance_k_cuda.launches
    u, rows = TM.advance_k(t, ts["conserved"], ts["oe"], ts["time"], mc)
    want = TM.advance_k_plain(t, ts["conserved"], ts["oe"], ts["time"], mc)
    assert TM.advance_k_cuda.launches == before
    assert torch.equal(u, want[0]) and torch.equal(rows, want[1])
    assert rows.shape == (2 * tsd.rk_order, TM.ROWS, TM.LANES)
    assert rows.dtype == F64
    with pytest.raises(ValueError, match="CUDA"):
        TM.advance_k_cuda(t, ts["conserved"], ts["oe"], ts["time"], mc)


# -----------------------------------------------------------------------------
# the fast driver loop
# -----------------------------------------------------------------------------

ARGS = ["binary", "depth=3", "block_size=16", "rk_order=1", "tfinal=0.04",
        "cpi=0.02", "tsi=0.015", "fast_step=1", "multi_launch=4"]


def last_checkpoint(outdir):
    name = sorted(f for f in os.listdir(outdir) if f.startswith("chkpt"))[-1]
    with h5py.File(os.path.join(outdir, name)) as f:
        g = f["solution"]["conserved_u"]
        u = np.stack([g[k][()] for k in sorted(g.keys())])
        return u, f["solution"]["time"][()], f["time_series"][()]


def flat_series(ts):
    """[n, 50] numbers of the time-series records and, per column, whether
    it is a near-circular element's ill-conditioned component."""
    cols, gauge = [], []
    for name in ts.dtype.names:
        v = ts[name]
        if v.dtype.names:          # orbital elements
            for sub in v.dtype.names[:-1]:
                cols.append(v[sub])
                gauge.append(sub in ("pomega", "tau"))
            for sub in v["elements"].dtype.names:
                cols.append(v["elements"][sub])
                gauge.append(sub == "eccentricity")
        else:
            arr = v.reshape(len(ts), -1)
            cols.extend(arr.T)
            gauge.extend([False] * arr.shape[1])
    return np.stack(cols, axis=1), np.array(gauge)


def test_fast_driver_matches_jax(tmp_path):
    """The port's fast loop (multi_launch=4: B3 launches of up to 4 steps,
    chunk planning, time-series replay, checkpoints) against
    the JAX package's main with the same arguments: the last checkpoint's
    state and time at the bars of
    tests/test_subprogram_binary.py::test_multi_launch_driver_matches_per_step
    (time rtol 1e-12, state rtol 1e-9 atol 1e-12), and every time-series
    record at the state's bars (the near-circular perturbation elements'
    ill-conditioned components at 1e-8 absolute)."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert JB.main(ARGS + [f"outdir={jdir}"]) == 0
    assert TB.main(ARGS + [f"outdir={tdir}"], device="cpu", dtype=F64) == 0
    (uj, tj, sj), (ut, tt, st) = last_checkpoint(jdir), last_checkpoint(tdir)
    np.testing.assert_allclose(tt, tj, rtol=1e-12)
    np.testing.assert_allclose(ut, uj, rtol=1e-9, atol=1e-12)
    assert len(st) == len(sj) >= 2
    (ft, gauge), (fj, _) = flat_series(st), flat_series(sj)
    np.testing.assert_allclose(ft[:, ~gauge], fj[:, ~gauge], rtol=1e-9,
                               atol=1e-12)
    np.testing.assert_allclose(ft[:, gauge], fj[:, gauge], rtol=0,
                               atol=GAUGE_ATOL)
