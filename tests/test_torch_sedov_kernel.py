"""Kernel B5 (mara3_tpu_torch/csrc/sedov_step.cu) and its plain PyTorch
version (kernels/sedov_step.advance_n_plain): the plain version against the
port's scheme at the JAX package's bars, the SRHD recovery it runs against
the scheme's, its wrapper's contract, and the kernel against the plain
version on a card.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernel and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_sedov_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import sedov_step as T5
from mara3_tpu_torch.kernels import srhd_recover as TREC
from mara3_tpu_torch.physics import euler, srhd
from mara3_tpu_torch.subprograms import sedov as TS

torch.set_num_threads(1)

# B5 against the scheme over several steps: the JAX package's bars for its
# B5 (tests/test_subprograms_1d.py:214-215). Euler differs by the hoisted
# 1/dv and the geometry's rounding; SRHD adds the reciprocal-first Newton
# and (warm) the previous step's pressure as the start, both within the
# Newton's stopping tolerance
SCHEME_TOL = {"euler": dict(rtol=1e-11, atol=1e-13),
              "srhd": dict(rtol=1e-8, atol=1e-10)}
# the kernel against the plain version on the card, float64: those bars
# again (an ulp of difference can move a cell across the Newton's
# stopping test, which moves its pressure by up to the tolerance)
F64_TOL = SCHEME_TOL
# float32: each element within 64 ulps of its cell's largest component
F32_ULPS = 64
F32_ATOL = 1e-30
# a cell count no TPU rule allows (the JAX B5 takes multiples of 128)
ODD_NR = 50
STEPS = [0, 1, 3, 17]


def seeded_sedov(nr, system, seed=0, dtype=torch.float64, device="cpu",
                 flat_edge=True):
    """(u, vertices, dt): the sedov state of `nr` zones per decade with
    each cell scaled by 1 + 5% noise from a numpy seed. With flat_edge the
    outer 24 cells stay as uniform as in a sedov run; the kernel and its
    plain version are compared with noise on every cell."""
    cfg = TS.config_template().create().update(
        {"nr": str(nr), "newtonian": str(int(system == "euler"))})
    s = TS.new_solution(cfg, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    noise = 1.0 + 0.05 * rng.uniform(size=(s.conserved.shape[0], 1))
    if flat_edge:
        noise[-24:] = 1.0
    u = (s.conserved * torch.tensor(noise)).to(dtype=dtype, device=device)
    return u, s.vertices.to(device), TS.grid_dt(s.vertices)


def assert_f32_cells_close(u, u_ref, ulps):
    """Every element of [nr, 5] within `ulps` float32 ulps of its cell's
    largest component, plus F32_ATOL."""
    bar = ulps * np.finfo(np.float32).eps * np.abs(u_ref).max(axis=1,
                                                              keepdims=True)
    worst = float((np.abs(u - u_ref) / np.maximum(bar, 1e-300)).max())
    assert np.all(np.abs(u - u_ref) <= bar + F32_ATOL), \
        f"{worst:.2f} x the bar of {ulps} ulps of the cell"


# -----------------------------------------------------------------------------
# the plain version, on the CPU
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("reconstruct", ["pcm", "plm", "weno5"])
@pytest.mark.parametrize("system", ["euler", "srhd"])
def test_plain_matches_the_scheme(system, reconstruct):
    """6 steps of B5's plain version against 6 scheme steps, at 100 cells
    (no multiple of 128), SRHD warm and cold."""
    u, v, dt = seeded_sedov(ODD_NR, system)
    want = u
    phys = euler if system == "euler" else srhd
    for _ in range(6):
        want = TS._step(phys, want, v, dt, reconstruct, 1.5)
    for warm in (True, False):
        got = T5.advance_n_plain(u, v, dt, 6, reconstruct, 1.5,
                                 system=system, warm=warm)
        np.testing.assert_allclose(got.numpy(), want.numpy(),
                                   **SCHEME_TOL[system])


def test_weno5_outer_face_departs_from_the_scheme_only_off_a_flat_edge():
    """B5's weno5 right state at the outer face reads the scheme's
    zero-gradient stencil (cells nr-1 four times and nr-2), not the TPU
    kernel's (nr-1, nr-1, nr-1, nr-2, nr-3): with the outer three cells
    equal and with them perturbed, B5's plain version matches the scheme
    at every cell."""
    u, v, dt = seeded_sedov(ODD_NR, "euler")
    step = lambda w: TS._step(euler, w, v, dt, "weno5", 1.5)
    plain = lambda w: T5.advance_n_plain(w, v, dt, 1, "weno5", 1.5)
    np.testing.assert_allclose(plain(u).numpy(), step(u).numpy(),
                               **SCHEME_TOL["euler"])
    u[-2] *= 1.5
    u[-3] *= 0.8
    np.testing.assert_allclose(plain(u).numpy(), step(u).numpy(),
                               **SCHEME_TOL["euler"])
    diff = (plain(u) - step(u)).abs().amax(dim=1)
    assert float(diff[-1]) <= 1e-15 * float(u[-1].abs().max())


def test_warm_start_changes_results_within_the_tolerance():
    """Cut into calls, a warm SRHD run restarts its Newton from 0 at each
    call: the results move, by less than the Newton's tolerance."""
    u, v, dt = seeded_sedov(ODD_NR, "srhd", seed=1)
    whole = T5.advance_n_plain(u, v, dt, 8, "plm", 1.5, system="srhd")
    cut = T5.advance_n_plain(T5.advance_n_plain(u, v, dt, 4, "plm", 1.5,
                                                system="srhd"),
                             v, dt, 4, "plm", 1.5, system="srhd")
    np.testing.assert_allclose(cut.numpy(), whole.numpy(),
                               **SCHEME_TOL["srhd"])


def test_recover_window_matches_the_scheme_recovery():
    """kernels/srhd_recover (reciprocal-first, warm or cold) against
    physics/srhd.recover_primitive_t on relativistic states."""
    rng = np.random.default_rng(2)
    n = 400
    P = torch.tensor(np.stack([rng.uniform(0.5, 2.0, n),
                               rng.normal(0.0, 2.0, n),
                               rng.normal(0.0, 1.0, n),
                               rng.normal(0.0, 0.5, n),
                               rng.uniform(0.01, 10.0, n)], axis=-1))
    Ut = srhd.unstack(srhd.to_conserved_density(P, 4.0 / 3.0))
    want = srhd.recover_primitive_t(Ut, 4.0 / 3.0)
    for p0 in (torch.zeros(n, dtype=torch.float64), 1.1 * P[:, 4]):
        got, p, done, updates = TREC.recover_window(Ut, p0)
        assert bool(done.all())
        assert int(updates.min()) >= 1 and int(updates.max()) <= 50
        assert torch.equal(p, got[4])
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.numpy(), w.numpy(), rtol=1e-8,
                                       atol=1e-10)


def test_plain_takes_no_step_and_counts_newton_updates():
    """n = 0 returns u; a step's Newton updates, counted by recover_window
    on the step's conserved densities as chip_smoke.py counts them, lie
    between 1 and 50 a cell, and fewer from the converged pressure."""
    u, v, dt = seeded_sedov(ODD_NR, "srhd")
    assert torch.equal(T5.advance_n_plain(u, v, dt, 0, system="srhd"), u)
    inv_dv = 1.0 / T5.geometry(v, u.dtype)[0]
    Ut = tuple(u[:, k] * inv_dv for k in range(5))
    _, p, _, cold = TREC.recover_window(Ut, torch.zeros_like(inv_dv))
    _, _, _, warm = TREC.recover_window(Ut, p)
    cells = u.shape[0]
    assert cells <= int(cold.sum()) <= cells * 50
    assert int(warm.sum()) < int(cold.sum())


def test_geometry_is_formed_in_float64_then_cast():
    _, v, _ = seeded_sedov(8, "euler")
    g32 = T5.geometry(v, torch.float32)
    g64 = T5.geometry(v, torch.float64)
    assert g32.shape == (4, 16) and torch.equal(g32, g64.to(torch.float32))
    np.testing.assert_allclose(g64[0].numpy(), ((v[1:] ** 3 - v[:-1] ** 3)
                                                / 3).numpy(), rtol=1e-15)


# -----------------------------------------------------------------------------
# the wrapper's contract, checked on the CPU
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("make,match", [
    (lambda u, v: (u.to(torch.float16), v), "float32 or float64"),
    (lambda u, v: (u.t().contiguous().t(), v), "contiguous"),
    (lambda u, v: (u[:2].contiguous(), v[:3]), "nr >= 3"),
    (lambda u, v: (u[:, :4].contiguous(), v), r"u \[nr, 5\]"),
    (lambda u, v: (u, v[:-1]), r"vertices \[nr \+ 1\]"),
    (lambda u, v: (u, v), "CUDA tensor"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    u, v, dt = seeded_sedov(8, "euler", dtype=torch.float32)
    u, v = make(u, v)
    with pytest.raises(ValueError, match=match):
        T5.advance_n_cuda(u, v, dt, 1)


@pytest.mark.parametrize("kw,match", [
    ({"reconstruct": "ppm"}, "pcm, plm or weno5"),
    ({"system": "mhd"}, "euler or srhd"),
    ({"system": "srhd", "gamma": 5.0 / 3.0}, "gamma = 4/3"),
])
def test_both_versions_reject_unknown_options(kw, match):
    u, v, dt = seeded_sedov(8, "euler")
    for fn in (T5.advance_n_plain, T5.advance_n_cuda):
        with pytest.raises(ValueError, match=match):
            fn(u, v, dt, 1, **kw)
    with pytest.raises(ValueError, match="n >= 0"):
        T5.advance_n_plain(u, v, dt, -1)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    u, v, dt = seeded_sedov(ODD_NR, "srhd")
    before = T5.advance_n_cuda.launches
    got = T5.advance_n(u, v, dt, 3, "weno5", system="srhd")
    want = T5.advance_n_plain(u, v, dt, 3, "weno5", system="srhd")
    assert torch.equal(got, want)
    assert T5.advance_n_cuda.launches == before


# -----------------------------------------------------------------------------
# the kernel on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B5 runs only on a CUDA card (no GPU here)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("reconstruct", ["pcm", "plm", "weno5"])
@pytest.mark.parametrize("system", ["euler", "srhd"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_matches_plain(cuda_device, dtype, system, reconstruct):
    """100 and 1,000 cells, n in {0, 1, 3, 17}, SRHD warm and cold; the
    input is not written; one counted call per n > 0."""
    for nr in (ODD_NR, 500):
        u, v, dt = seeded_sedov(nr, system, dtype=dtype, device=cuda_device,
                                flat_edge=False)
        u_copy = u.clone()
        for warm in ((True,) if system == "euler" else (True, False)):
            for n in STEPS:
                kw = dict(reconstruct=reconstruct, system=system, warm=warm)
                before = T5.advance_n_cuda.launches
                got = T5.advance_n_cuda(u, v, dt, n, **kw)
                torch.cuda.synchronize()
                assert T5.advance_n_cuda.launches == before + (n > 0)
                want = T5.advance_n_plain(u, v, dt, n, **kw)
                assert got.shape == u.shape and got.dtype == dtype
                g, w = got.cpu().numpy(), want.cpu().numpy()
                assert np.isfinite(g).all()
                if dtype == torch.float64:
                    np.testing.assert_allclose(g, w, **F64_TOL[system])
                else:
                    assert_f32_cells_close(g, w, F32_ULPS)
        assert torch.equal(u, u_copy)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_cpu(cuda_device):
    """The kernel on the card against the plain version on the CPU,
    float64, 11 SRHD plm steps."""
    u, v, dt = seeded_sedov(128, "srhd", seed=5, flat_edge=False)
    kw = dict(reconstruct="plm", system="srhd")
    got = T5.advance_n(u.to(cuda_device), v.to(cuda_device), dt, 11, **kw)
    want = T5.advance_n(u, v, dt, 11, **kw)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(),
                               **F64_TOL["srhd"])
