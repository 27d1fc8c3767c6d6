"""The column march (mara3_tpu_torch/csrc/iso2d_march.cuh) that kernels B1
(csrc/iso2d_step.cu) and B9 (csrc/iso2d_ladder.cu) run: B9's stage plan,
which its wrapper hands the kernel, checked on the CPU, and both kernels on
the card at shapes that the march's CTA width (64 columns) and chunk height
(up to 64 rows) do not divide.

The plan: B9's stages read only rows that the stage before them wrote
(a stage over output rows [r_lo, r_hi) reads rows [r_lo - 2, r_hi + 2) of
its source), and the last writes the stripe's rows once. On the card (tests
marked `cuda`, skipped without a GPU; run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_iso2d_march.py

): the built kernels' shared memory and occupancy, B1 and B9 against their
plain versions at the bars of tests/test_torch_iso2d_kernel.py, two calls
giving the same bits, and in rk1 HLLE both bit for bit equal to kernel
B10a, whose one-thread-a-cell kernel is not the march: the anchor that the
march kept each cell's arithmetic.

This file imports only the port, so it also runs where jax is not
installed."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.kernels import iso2d_step_v1 as V1
from mara3_tpu_torch.kernels import iso2d_step_v4 as V4

torch.set_num_threads(1)

# the bars of tests/test_torch_iso2d_kernel.py: float64 that of the CPU test
# of the plain version against the JAX B1; float32 each element within 64
# ulps of its cell's largest component
F64_TOL = dict(rtol=1e-13, atol=1e-13)
F32_ULPS = 64
F32_ATOL = 1e-30
KW = dict(cs2=0.5, dtdx=0.1, dtdy=0.12, theta=1.5)
DTYPES = (torch.float32, torch.float64)
# shapes that the march's 64 columns and 64-row chunks do not divide: the
# kernel's least extent, ny < 64, odd
B1_SHAPES = [(4, 4), (5, 130), (100, 36)]
# B9 (nx, ny, TX, G): windows of TX + 2h rows, more than a chunk's 64 in the
# first two
B9_SHAPES = [(256, 36, 128, 2), (130, 5, 65, 2), (4, 4, 4, 1)]
HALO = 2    # the rows a side that a march stage reads beyond its output


def random_state(nx, ny, dtype, device, seed=0):
    """u [3, nx, ny] of density 1-1.2 and speeds ~0.1, from a numpy seed."""
    rng = np.random.default_rng(seed)
    sg = 1.0 + 0.2 * rng.uniform(size=(nx, ny))
    vx = 0.1 * rng.normal(size=(nx, ny))
    vy = 0.1 * rng.normal(size=(nx, ny))
    return torch.tensor(np.stack([sg, sg * vx, sg * vy]), dtype=dtype,
                        device=device)


def random_strips(gi, h, ny, dtype, device, seed):
    """(lo, hi) [gi, 3, h, ny], unrelated to the state they border."""
    return tuple(
        random_state(gi * h, ny, dtype, device, seed + k)
        .reshape(3, gi, h, ny).permute(1, 0, 2, 3).contiguous()
        for k in (0, 1))


def assert_close(got, want):
    """float64 at the CPU bar; float32 each element within F32_ULPS ulps of
    its cell's largest component (axis 0)."""
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.isfinite(g).all()
    if got.dtype == torch.float64:
        np.testing.assert_allclose(g, w, **F64_TOL)
        return
    bar = F32_ULPS * np.finfo(np.float32).eps * np.abs(w).max(
        axis=0, keepdims=True)
    worst = float((np.abs(g - w) / np.maximum(bar, 1e-300)).max())
    assert np.all(np.abs(g - w) <= bar + F32_ATOL), \
        f"{worst:.2f} x the bar of {F32_ULPS} ulps of the cell"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernels B1 and B9 run only on a CUDA card (no GPU here)")
    return torch.device("cuda")


# -----------------------------------------------------------------------------
# the plan, checked on the CPU
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("TX,G,rk", [(256, 4, 1), (256, 4, 2), (128, 2, 1),
                                     (128, 2, 2), (65, 2, 1), (20, 1, 2),
                                     (4, 1, 1), (4, 1, 2), (32, 3, 1)])
def test_b9_stages_read_only_rows_the_stage_before_wrote(TX, G, rk):
    """Per stripe: the strips hold the window's rows [0, TX + 2h); each
    stage reads rows [r_lo - 2, r_hi + 2) from rows its source holds, and
    its base (rk2's step start) at its output rows; its output rows shrink
    by 2 a side a stage; the last writes the stripe's rows [h, h + TX)
    once; the window buffers are never read and written by one stage, but
    for the Heun average in place over the step's start."""
    h = 2 * G * rk
    plan = V4.stage_plan(TX, G, rk)
    assert len(plan) == G * rk
    valid = {V4.STRIPS: (0, TX + 2 * h)}
    written = np.zeros(TX + 2 * h, dtype=int)
    for k, (src, base, dst, r_lo, r_hi) in enumerate(plan):
        assert (r_lo, r_hi) == (2 * (k + 1), TX + 2 * h - 2 * (k + 1))
        assert src != dst and src != V4.OUT and dst != V4.STRIPS
        lo, hi = valid[src]
        assert lo <= r_lo - HALO and r_hi + HALO <= hi
        if base != V4.NONE:
            # the step's start: the strips, then X, averaged into X in
            # place (or into the output)
            assert rk == 2 and k % 2 == 1
            assert base == (V4.STRIPS if k == 1 else V4.WIN_X)
            assert dst in (V4.WIN_X, V4.OUT)
            blo, bhi = valid[base]
            assert blo <= r_lo and r_hi <= bhi
        else:
            assert rk == 1 or k % 2 == 0
        valid[dst] = (r_lo, r_hi)
        if dst == V4.OUT:
            assert k == len(plan) - 1
            written[r_lo:r_hi] += 1
    assert (written[h:h + TX] == 1).all()
    assert written.sum() == TX


def test_b9_allocates_the_window_buffers_its_plan_uses():
    used = lambda TX, G, rk: {r for s in V4.stage_plan(TX, G, rk)
                              for r in s[:3] if r != V4.NONE}
    assert used(16, 1, 1) == {V4.STRIPS, V4.OUT}
    assert used(16, 1, 2) == {V4.STRIPS, V4.WIN_Y, V4.OUT}
    assert used(16, 2, 1) == {V4.STRIPS, V4.WIN_X, V4.OUT}
    assert used(32, 4, 1) == used(32, 2, 2) == {
        V4.STRIPS, V4.WIN_X, V4.WIN_Y, V4.OUT}


# -----------------------------------------------------------------------------
# the kernels on the card
# -----------------------------------------------------------------------------

CARD_DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                      ids=["f64", "f32"])


@pytest.mark.cuda
@CARD_DTYPES
@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
def test_march_kernels_fit_on_the_card(cuda_device, riemann, dtype):
    """B1's and B9's march kernels (one kernel, built into both libraries):
    the same resources, static shared memory within 48 KB, and two CTAs
    or more an SM."""
    b1 = TK.kernel_info(dtype, riemann)
    assert V4.kernel_info(dtype, riemann) == b1
    assert 0 < b1["static_smem"] <= 48 * 1024
    assert b1["ctas_per_sm"] >= 2


@pytest.mark.cuda
@CARD_DTYPES
@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
@pytest.mark.parametrize("rk", [1, 2])
def test_b1_matches_plain_where_w_and_r_do_not_divide(cuda_device, rk,
                                                      riemann, dtype):
    """n in {1, 3}; two calls give the same bits."""
    for seed, (nx, ny) in enumerate(B1_SHAPES):
        u = random_state(nx, ny, dtype, cuda_device, seed)
        for n in (1, 3):
            kw = dict(KW, rk_order=rk, riemann=riemann)
            got = TK.advance_n_cuda(u, n, **kw)
            again = TK.advance_n_cuda(u, n, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            assert_close(got, TK.advance_n_plain(u, n, **kw))


@pytest.mark.cuda
@CARD_DTYPES
@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
@pytest.mark.parametrize("rk", [1, 2])
def test_b9_matches_plain_where_windows_exceed_a_chunk(cuda_device, rk,
                                                       riemann, dtype):
    """Windows of TX + 2h rows that R does not divide, periodic and random
    strips; two calls give the same bits."""
    for seed, (nx, ny, TX, G) in enumerate(B9_SHAPES):
        h = 2 * G * rk
        if h > TX:
            continue
        u = random_state(nx, ny, dtype, cuda_device, seed)
        for lo, hi in (V4.build_x_strips(u, TX, h),
                       random_strips(nx // TX, h, ny, dtype, cuda_device, 9)):
            kw = dict(KW, G=G, TX=TX, rk_order=rk, riemann=riemann)
            got = V4.step_v4_strips_cuda(u, lo, hi, **kw)
            again = V4.step_v4_strips_cuda(u, lo, hi, **kw)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            assert_close(got, V4.step_v4_strips_plain(u, lo, hi, **kw))


@pytest.mark.cuda
@CARD_DTYPES
def test_b1_and_b9_are_bitwise_b10a_in_rk1_hlle(cuda_device, dtype):
    """B10a (one thread a cell from the periodically extended state, not
    the march) is the anchor: G steps of B1, and of B9 on periodic strips,
    give its bits."""
    for seed, (nx, ny) in enumerate(B1_SHAPES):
        u = random_state(nx, ny, dtype, cuda_device, seed)
        got = TK.advance_n_cuda(u, 2, **KW)
        want = V1.advance_n_v1(u, 2, **KW)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (nx, ny)
    for seed, (nx, ny, TX, G) in enumerate(B9_SHAPES):
        u = random_state(nx, ny, dtype, cuda_device, seed)
        got = V4.advance_n_v4(u, G, G=G, TX=TX, **KW)
        want = V1.advance_n_v1(u, G, **KW)
        torch.cuda.synchronize()
        assert torch.equal(got, want), (nx, ny, TX, G)
