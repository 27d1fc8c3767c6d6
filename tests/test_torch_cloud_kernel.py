"""Kernel B4 (mara3_tpu_torch/csrc/cloud_update.cu) and its plain PyTorch
versions (kernels/cloud_update.py): the temperature floor of the recovery
they share with B5, the four entries against each other and against the
port's scheme, the chunked loop's routes, the wrappers' contract, and the
kernel against the plain versions on a card.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernel and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cloud_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import cloud_update as T4
from mara3_tpu_torch.kernels import sedov_step as T5
from mara3_tpu_torch.kernels import srhd_recover as TREC
from mara3_tpu_torch.physics import srhd
from mara3_tpu_torch.subprograms import cloud as TC
from mara3_tpu_torch.subprograms import sedov as TS

torch.set_num_threads(1)

# B4's plain versions against the scheme (both float64): the same physics
# spelled reciprocal-first and rsqrt-first, and the Newton run from the
# same warm pressure; cells apart by round-off and, where the Newton's
# stopping test flips on an ulp, by its tolerance (the JAX package's own
# kernel-against-jnp bar is rtol 5e-5 in float32)
SCHEME_TOL = dict(rtol=1e-10, atol=1e-14)
# the kernel against the plain versions on the card, float64: those bars
F64_TOL = SCHEME_TOL
# float32: each element within 64 ulps of its cell's largest component
F32_ULPS = 64
F32_ATOL = 1e-30
# a shape no TPU rule allows (the JAX B4 takes nr % 8 == 0, nq % 128 == 0)
ODD_NR = 25          # 50 x 25 cells
STEPS = (1, 3, 17)


def seeded_cloud(nr=ODD_NR, seed=0, dtype=torch.float64, device="cpu",
                 num_decades=2.0):
    """(u [5, Nr, Nq], warm p, rv, qv, dt, jet_static, cfg): the cloud's
    initial state with 2% noise and a polar velocity from a numpy seed, and
    a warm pressure within 10% of the state's."""
    cfg = TC.config_template().create().update(
        {"nr": str(nr), "num_decades": str(num_decades)})
    s = TC.new_solution(cfg, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    u = s.conserved.permute(2, 0, 1).numpy() * (
        1.0 + 0.02 * rng.uniform(-1, 1, (5,) + s.conserved.shape[:2]))
    u[2] = 0.01 * rng.normal(size=u[2].shape) * np.abs(u[0])
    rv, qv = s.radial_vertices, s.polar_vertices
    P = srhd.recover_primitive(torch.tensor(np.moveaxis(u, 0, -1))
                               / TC.cell_volumes(rv, qv)[..., None],
                               TC.GAMMA_LAW_INDEX)
    p = P[..., 4] * torch.tensor(1.0 + 0.1 * rng.uniform(size=u[0].shape))
    return (torch.tensor(u).to(dtype=dtype, device=device).contiguous(),
            p.to(dtype=dtype, device=device).contiguous(),
            rv.to(dtype=dtype, device=device),
            qv.to(dtype=dtype, device=device), TC.grid_dt(s, cfg),
            TC.jet_static(cfg), cfg)


def kernel_args(u, p, rv, qv, dt, jet, n=1, t0=0.3):
    """(inflow rows [n + 1, 5, Nq], geometry) of n steps from t0."""
    rows = TC.inflow_rows(TC.ops.midpoint_on_axis(qv), t0, dt, n, jet)
    return rows, TC.kernel_geometry(rv, qv)


def assert_f32_cells_close(u, u_ref, ulps):
    """Every element of [5, Nr, Nq] within `ulps` float32 ulps of its
    cell's largest component, plus F32_ATOL."""
    bar = ulps * np.finfo(np.float32).eps * np.abs(u_ref).max(axis=0,
                                                              keepdims=True)
    worst = float((np.abs(u - u_ref) / np.maximum(bar, 1e-300)).max())
    assert np.all(np.abs(u - u_ref) <= bar + F32_ATOL), \
        f"{worst:.2f} x the bar of {ulps} ulps of the cell"


# -----------------------------------------------------------------------------
# the recovery's temperature floor (shared with kernel B5)
# -----------------------------------------------------------------------------

def test_floor_off_leaves_the_recovery_as_it_was():
    """tfloor = 0 skips the floor: the primitives and the warm pressure are
    bitwise those of a call without it, and Pt[4] is the carry p, so B5's
    sedov results do not move; a sedov run through B5's plain version
    equals the scheme at its bar."""
    rng = np.random.default_rng(3)
    P = torch.tensor(np.stack([rng.uniform(0.5, 2.0, 300),
                               rng.normal(0.0, 2.0, 300),
                               rng.normal(0.0, 1.0, 300),
                               rng.normal(0.0, 0.5, 300),
                               rng.uniform(0.01, 10.0, 300)], axis=-1))
    Ut = srhd.unstack(srhd.to_conserved_density(P, 4.0 / 3.0))
    p0 = 0.9 * P[:, 4]
    a = TREC.recover_window(Ut, p0)
    b = TREC.recover_window(Ut, p0, 0.0)
    for x, y in zip(a[0], b[0]):
        assert torch.equal(x, y)
    assert torch.equal(a[1], b[1]) and torch.equal(b[0][4], b[1])
    cfg = TS.config_template().create().update({"nr": "40"})
    s = TS.new_solution(cfg, dtype=torch.float64)
    dt = TS.grid_dt(s.vertices)
    got = T5.advance_n_plain(s.conserved, s.vertices, dt, 4, system="srhd")
    want = s.conserved
    for _ in range(4):
        want = TS._step(srhd, want, s.vertices, dt)
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-8,
                               atol=1e-10)


def test_floor_on_floors_the_carry():
    """tfloor > 0: Pt[4] = max(p, tfloor D / W) is cloud's carry; p is the
    pressure before the floor."""
    D = torch.tensor([1.0, 2.0, 0.5], dtype=torch.float64)
    Ut = (D, torch.zeros_like(D), torch.zeros_like(D), torch.zeros_like(D),
          torch.tensor([1e-9, 3.0, 1e-12], dtype=torch.float64))
    Pt, p, done, _ = TREC.recover_window(Ut, torch.zeros_like(D), 1e-3)
    assert bool(done.all())
    # no momentum: W = 1, so the floor is tfloor D
    assert torch.equal(Pt[4], torch.maximum(p, 1e-3 * D))
    assert float(Pt[4][0]) == pytest.approx(1e-3) and float(Pt[4][1]) == \
        pytest.approx(float(p[1]))


# -----------------------------------------------------------------------------
# the four entries, on the CPU
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("method", [1, 2], ids=["pcm", "plm"])
def test_entries_compose_per_cell(method):
    """B4c equals two B4b stages and the average, B4d (rk 2) chained B4c
    steps and B4d (rk 1) chained B4b stages, over 3 steps and bitwise."""
    u, p, rv, qv, dt, jet, _ = seeded_cloud()
    rows, geo = kernel_args(u, p, rv, qv, dt, jet, n=3)
    kw = dict(geo=geo, dt=dt, plm_theta=1.2, method=method, tfloor=1e-8)
    u1, p1 = T4.stage_plain(rows[0], u, p, **kw)
    u2, p2 = T4.stage_plain(rows[1], u1, p1, **kw)
    uc, pc = T4.step_rk2_plain(rows[0], rows[1], u, p, **kw)
    assert torch.equal(uc, 0.5 * u + 0.5 * u2) and torch.equal(pc, p2)
    for rk in (1, 2):
        want, pw = u, p
        for s in range(3):
            if rk == 2:
                want, pw = T4.step_rk2_plain(rows[s], rows[s + 1], want, pw,
                                             **kw)
            else:
                want, pw = T4.stage_plain(rows[s], want, pw, **kw)
        got, pg = T4.run_n_plain(rows, u, p, rk=rk, **kw)
        assert torch.equal(got, want) and torch.equal(pg, pw)


@pytest.mark.parametrize("rk", [1, 2])
@pytest.mark.parametrize("method", [1, 2], ids=["pcm", "plm"])
def test_plain_matches_the_scheme(method, rk):
    """4 steps of B4d's plain version against 4 scheme steps at 50 x 25
    cells (no TPU shape), warm, and a cold first step."""
    u, p, rv, qv, dt, jet, _ = seeded_cloud(seed=1)
    for p0 in (p, torch.zeros_like(p)):
        want, pw, t = u, p0, 0.3
        for _ in range(4):
            want, pw = TC._advance_rk_carry_soa(want, pw, t, rv, qv, jet, dt,
                                                1.2, method, 1e-8, rk,
                                                kernel=False)
            t = t + dt
        rows, geo = kernel_args(u, p, rv, qv, dt, jet, n=4)
        got, pg = T4.run_n_plain(rows, u, p0, geo, dt, 1.2, method, 1e-8,
                                 rk=rk)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SCHEME_TOL)
        np.testing.assert_allclose(pg.numpy(), pw.numpy(), **SCHEME_TOL)


def test_b4a_matches_the_scheme_update():
    """B4a's plain version on the scheme's primitives against the scheme's
    _flux_update (the same stage after recovery, spelled apart)."""
    u, p, rv, qv, dt, jet, _ = seeded_cloud(seed=2)
    g = TC.make_geometry(rv, qv)
    for method in (1, 2):
        want = TC._advance_once(u.permute(1, 2, 0), 0.3, g, jet, dt, 1.2,
                                method, 1e-8, p, kernel=False)
        got = TC._advance_once(u.permute(1, 2, 0), 0.3, g, jet, dt, 1.2,
                               method, 1e-8, p, kernel=True)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SCHEME_TOL)


@pytest.mark.parametrize("multi,kernel,path", [
    (True, None, "scheme[3]"), (True, False, "scheme[3]"),
    (True, True, "plain_b4d_rk2[3]"), (False, True, "plain_b4c[3]")])
def test_advance_n_routes_on_the_cpu(multi, kernel, path):
    """advance_n on a CPU tensor: the scheme, B4d's plain version over the
    inflow stack, or B4c's a step; all reach the same state."""
    u, p, rv, qv, dt, jet, _ = seeded_cloud(seed=4)
    got, _ = TC.advance_n(u, p, 0.3, 3, rv, qv, jet, dt, 1.2, 2, 1e-8, 2,
                          kernel=kernel, multi=multi)
    assert TC.LAST_PATH == path
    want, pw, t = u, p, 0.3
    for _ in range(3):
        want, pw = TC._advance_rk_carry_soa(want, pw, t, rv, qv, jet, dt,
                                            1.2, 2, 1e-8, 2, kernel=False)
        t = t + dt
    np.testing.assert_allclose(got.numpy(), want.numpy(), **SCHEME_TOL)


def test_per_step_route_on_the_cpu():
    u, p, rv, qv, dt, jet, _ = seeded_cloud(seed=5)
    for rk, path in ((1, "plain_b4b[1]"), (2, "plain_b4c[1]")):
        got, _ = TC._advance_rk_carry_soa(u, p, 0.3, rv, qv, jet, dt, 1.2, 2,
                                          1e-8, rk, kernel=True)
        assert TC.LAST_PATH == path
        want, _ = TC._advance_rk_carry_soa(u, p, 0.3, rv, qv, jet, dt, 1.2,
                                           2, 1e-8, rk, kernel=False)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **SCHEME_TOL)


def test_chunked_loop_plans_the_chip_run(monkeypatch):
    """The chunk planner at nr=1024 (2,048 x 1,024, dt = 9.0e-4), with no
    steps taken: 512 steps with a diagnostics write due half a step before
    the end (as chip_smoke.py asks for it) go in chunks of 64, the write
    lands on step 512, and every chunk passes the time it starts at."""
    chunks = []

    def count(us, p, t0, n, *args, **kw):
        chunks.append((n, t0))
        return us, p

    monkeypatch.setattr(TC, "advance_n", count)
    monkeypatch.setattr(TC, "new_solution", lambda cfg, device, dtype: TC
                        .Solution(0.0, 0, 10.0 ** torch.linspace(
                            0.0, 2.0, 2049, dtype=torch.float64),
                            torch.linspace(0.0, np.pi, 1025,
                                           dtype=torch.float64),
                            torch.zeros(2, 2, 5)))
    cfg, state = TC.setup(["cloud", "nr=1024", "rk_order=2"], device="cpu")
    dt = TC.grid_dt(state.solution, cfg)
    cfg = cfg.update({"tfinal": str(512 * dt), "dfi": str(511.5 * dt),
                      "cpi": "1", "tsi": "1", "fast_step": "1"})
    seen = []

    def tasks(st, cfg_):
        for task in TC.TASKS:
            if st.schedule.is_due(task):
                seen.append((task, st.solution.iteration))
                st = TC.State(st.solution,
                              st.schedule.mark_as_completed(task))
        return st

    final = TC.run(cfg, state, tasks=tasks)
    assert final.solution.iteration == 512 == sum(n for n, _ in chunks)
    assert {n for n, _ in chunks} == {64}
    assert ("write_diagnostics", 512) in seen
    t = 0.0
    for n, t0 in chunks:
        assert t0 == t
        t += n * dt


# -----------------------------------------------------------------------------
# the wrappers' contract, checked on the CPU
# -----------------------------------------------------------------------------

def case(dtype=torch.float32):
    u, p, rv, qv, dt, jet, _ = seeded_cloud(nr=8, dtype=dtype)
    rows, geo = kernel_args(u, p, rv, qv, dt, jet, n=2)
    return u, p, rows, geo, dt


@pytest.mark.parametrize("make,match", [
    (lambda u, p, r, g: (u.half(), p, r, g), "float32 or float64|is "),
    (lambda u, p, r, g: (u.transpose(1, 2).contiguous().transpose(1, 2), p,
                         r, g), "contiguous"),
    (lambda u, p, r, g: (u[:, :2].contiguous(), p[:2], r,
                         g._replace(dv=g.dv[:2], dAr=g.dAr[:3],
                                    dAq=g.dAq[:2], invr=g.invr[:2])),
     "nr >= 3"),
    (lambda u, p, r, g: (u[:4].contiguous(), p, r, g), r"u \[5, nr, nq\]"),
    (lambda u, p, r, g: (u, p[:-1], r, g), "p_guess"),
    (lambda u, p, r, g: (u, p, r[:, :3], g), "inflow rows"),
    (lambda u, p, r, g: (u, p, r, g._replace(dAr=g.dAr[:-1])), "dAr"),
    (lambda u, p, r, g: (u, p, r, g._replace(cotq=g.cotq.double())),
     "cotq is"),
    (lambda u, p, r, g: (u, p, r, g), "CUDA tensors"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    u, p, rows, geo, dt = case()
    u, p, rows, geo = make(u, p, rows, geo)
    with pytest.raises(ValueError, match=match):
        T4.run_n_cuda(rows, u, p, geo, dt, 1.2, 2, 1e-8)


def test_every_entry_rejects_unknown_options():
    u, p, rows, geo, dt = case(torch.float64)
    Pe = torch.zeros(5, u.shape[1] + 2, u.shape[2], dtype=u.dtype)
    for fn, args in ((T4.flux_update_plain, (Pe, u, geo, dt, 1.2)),
                     (T4.flux_update_cuda, (Pe, u, geo, dt, 1.2))):
        with pytest.raises(ValueError, match="1 \\(pcm\\) or 2"):
            fn(*args, 3)
    with pytest.raises(ValueError, match="rk 1 or 2"):
        T4.run_n_plain(rows, u, p, geo, dt, 1.2, 2, 1e-8, rk=3)
    with pytest.raises(ValueError, match="Pe"):
        T4.flux_update_plain(Pe[:, 1:], u, geo, dt, 1.2, 2)
    for fn in (T4.stage_cuda, T4.step_rk2_cuda):
        with pytest.raises(ValueError, match="CUDA tensors"):
            fn(*([rows[0]] if fn is T4.stage_cuda else [rows[0], rows[1]]),
               u, p, geo, dt, 1.2, 2, 1e-8)


def test_dispatch_takes_the_plain_versions_on_the_cpu():
    u, p, rows, geo, dt = case(torch.float64)
    counts = [f.launches for f in (T4.flux_update_cuda, T4.stage_cuda,
                                   T4.step_rk2_cuda, T4.run_n_cuda)]
    kw = dict(geo=geo, dt=dt, plm_theta=1.2, method=2, tfloor=1e-8)
    for got, want in (
            (T4.run_n(rows, u, p, **kw), T4.run_n_plain(rows, u, p, **kw)),
            (T4.stage(rows[0], u, p, **kw),
             T4.stage_plain(rows[0], u, p, **kw)),
            (T4.step_rk2(rows[0], rows[1], u, p, **kw),
             T4.step_rk2_plain(rows[0], rows[1], u, p, **kw))):
        assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
    Pe = torch.ones(5, u.shape[1] + 2, u.shape[2], dtype=u.dtype)
    assert torch.equal(T4.flux_update(Pe, u, geo, dt, 1.2, 2),
                       T4.flux_update_plain(Pe, u, geo, dt, 1.2, 2))
    assert counts == [f.launches for f in (
        T4.flux_update_cuda, T4.stage_cuda, T4.step_rk2_cuda, T4.run_n_cuda)]
    with pytest.raises(ValueError, match="no cloud_update kernel"):
        T4.run_n(rows.to("meta"), u.to("meta"), p.to("meta"),
                 T4.Geometry(*(g.to("meta") for g in geo)), dt, 1.2, 2, 1e-8)


# -----------------------------------------------------------------------------
# the kernel on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B4 runs only on a CUDA card (no GPU here)")
    return torch.device("cuda")


def check_close(got, want, dtype):
    g, w = got.cpu().numpy(), want.cpu().numpy()
    assert np.isfinite(g).all()
    if dtype == torch.float64:
        np.testing.assert_allclose(g, w, **F64_TOL)
    elif g.ndim == 3:
        assert_f32_cells_close(g, w, F32_ULPS)
    else:
        assert_f32_cells_close(g[None], w[None], F32_ULPS)


@pytest.mark.cuda
@pytest.mark.parametrize("method", [1, 2], ids=["pcm", "plm"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_matches_plain(cuda_device, dtype, method):
    """B4a-d at 50 x 25 cells, B4d rk 1 and 2 for n in {1, 3, 17}, warm
    and cold; the inputs are not written; one counted call each."""
    u, p, rv, qv, dt, jet, _ = seeded_cloud(dtype=dtype, device=cuda_device)
    copies = u.clone(), p.clone()
    kw = dict(dt=dt, plm_theta=1.2, method=method, tfloor=1e-8)
    for p0 in (p, torch.zeros_like(p)):
        for n in STEPS:
            rows, geo = kernel_args(u, p0, rv, qv, dt, jet, n=n)
            for rk in (1, 2):
                before = T4.run_n_cuda.launches
                got = T4.run_n_cuda(rows, u, p0, geo, rk=rk, **kw)
                torch.cuda.synchronize()
                assert T4.run_n_cuda.launches == before + 1
                want = T4.run_n_plain(rows, u, p0, geo, rk=rk, **kw)
                check_close(got[0], want[0], dtype)
                check_close(got[1], want[1], dtype)
        got = T4.stage_cuda(rows[0], u, p0, geo, **kw)
        check_close(got[0], T4.stage_plain(rows[0], u, p0, geo, **kw)[0],
                    dtype)
        got = T4.step_rk2_cuda(rows[0], rows[1], u, p0, geo, **kw)
        check_close(got[0], T4.step_rk2_plain(rows[0], rows[1], u, p0, geo,
                                               **kw)[0], dtype)
    g = TC.make_geometry(rv, qv)
    got = TC._advance_once(u.permute(1, 2, 0), 0.3, g, jet, dt, 1.2, method,
                           1e-8, p, kernel=True)
    want = TC._advance_once(u.permute(1, 2, 0).cpu(), 0.3,
                            TC.make_geometry(rv.cpu(), qv.cpu()), jet, dt,
                            1.2, method, 1e-8, p.cpu(), kernel=True)
    if dtype == torch.float64:
        np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                                   **F64_TOL)
    assert torch.equal(u, copies[0]) and torch.equal(p, copies[1])


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_cpu(cuda_device):
    """The kernel on the card against the plain version on the CPU,
    float64, 11 RK2 plm steps of B4d at 128 x 64."""
    u, p, rv, qv, dt, jet, _ = seeded_cloud(nr=64, seed=6)
    rows, geo = kernel_args(u, p, rv, qv, dt, jet, n=11)
    kw = dict(dt=dt, plm_theta=1.2, method=2, tfloor=1e-8)
    got = T4.run_n(rows.to(cuda_device), u.to(cuda_device),
                   p.to(cuda_device),
                   T4.Geometry(*(g.to(cuda_device) for g in geo)), **kw)
    want = T4.run_n(rows, u, p, geo, **kw)
    np.testing.assert_allclose(got[0].cpu().numpy(), want[0].numpy(),
                               **F64_TOL)
