"""Kernel B5's segment march (mara3_tpu_torch/csrc/sedov_step.cu), checked
on the CPU through what its wrapper hands the kernel: the segment plan
(kernels/sedov_step.march_plan) and the march itself as plain PyTorch
(advance_n_segments: segments recovered apart, their halos and warm
pressures through an edge buffer), against the plain version bit for bit
and the JAX B5 in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mara3_tpu.kernels import sedov_step as J5
from mara3_tpu_torch.kernels import resident_loop as R
from mara3_tpu_torch.kernels import sedov_step as T5
from mara3_tpu_torch.subprograms import sedov as TS

torch.set_num_threads(1)

H100 = R.H100      # 132 SMs, 227 KB a CTA, 228 KB an SM
# B5's plain version against the JAX B5 in interpret mode
# (tests/test_torch_sedov.py B5_TOL: the same arithmetic)
B5_TOL = dict(rtol=1e-12, atol=1e-14)


def seeded_sedov(nr, system, seed=0, dtype=torch.float64, flat_edge=False):
    """(u, vertices, dt) of the sedov grid of `nr` zones a decade (2 nr
    cells), each cell scaled by 1 + 5% noise from a numpy seed (the outer
    24 cells left as they are with flat_edge)."""
    cfg = TS.config_template().create().update(
        {"nr": str(nr), "newtonian": str(int(system == "euler"))})
    s = TS.new_solution(cfg, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    noise = 1.0 + 0.05 * rng.uniform(size=(s.conserved.shape[0], 1))
    if flat_edge:
        noise[-24:] = 1.0
    u = (s.conserved * torch.tensor(noise)).to(dtype)
    return u, s.vertices, TS.grid_dt(s.vertices)


# -----------------------------------------------------------------------------
# the segment plan
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("nr", [3, 4, 5, 7, 100, 101, 263, 791, 792, 793,
                                1001, 524288, 524289])
@pytest.mark.parametrize("reconstruct", ["pcm", "weno5"])
def test_segments_cover_the_cells_once(nr, reconstruct):
    """Odd counts, counts below the CTA count (396 at three CTAs an SM in
    float32) and the product's 524,288: the segments cover 0 .. nr in
    order, each cell once, each holds at least three cells (the mirrored
    guards and the edge buffer read three), and their lengths differ by
    at most one."""
    plan = T5.march_plan(nr, reconstruct, 4, H100)
    starts = plan.starts
    assert starts.dtype == np.int32 and starts[0] == 0 and starts[-1] == nr
    sizes = np.diff(starts)
    assert plan.ctas == min(H100.sms * T5.CTAS_PER_SM[4], nr // 3)
    assert sizes.min() >= T5.MIN_CELLS and sizes.max() == plan.lmax
    assert sizes.max() - sizes.min() <= 1
    assert H100.fits(plan.smem, T5.CTAS_PER_SM[4])


@pytest.mark.parametrize("reconstruct", ["pcm", "plm", "weno5"])
def test_product_size_is_resident_in_float32_only(reconstruct):
    """524,288 cells: in float32 over 396 CTAs (three an SM, 1,324 cells a
    segment) the state, warm pressure, 1/dv and primitives fit beside the
    face ring (74 KB a CTA); in float64 over 264 (two an SM, 1,986 cells)
    they do not, and the march streams them through device memory with
    only the ring in shared memory."""
    f32 = T5.march_plan(524288, reconstruct, 4, H100)
    f64 = T5.march_plan(524288, reconstruct, 8, H100)
    assert (f32.ctas, f32.lmax, f64.ctas, f64.lmax) == (396, 1324, 264, 1986)
    assert f32.resident and not f64.resident
    assert f32.smem == T5.march_smem(reconstruct, True, 1324, 4)
    assert 73000 < f32.smem < 74000
    assert f64.smem == 5 * T5.RING * 8
    assert not H100.fits(T5.march_smem(reconstruct, True, 1986, 8), 2)


def test_split_starts_spread_the_remainder():
    assert R.split_starts(10, 3).tolist() == [0, 4, 7, 10]
    assert R.split_starts(9, 3).tolist() == [0, 3, 6, 9]


# -----------------------------------------------------------------------------
# the march as plain PyTorch
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("n", [1, 3, 17])
@pytest.mark.parametrize("reconstruct", ["pcm", "plm", "weno5"])
@pytest.mark.parametrize("system", ["euler", "srhd"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_segment_march_equals_plain_bit_for_bit(dtype, system, reconstruct,
                                                n):
    """101 cells (odd) in the plan's segments for 5 SMs (15 segments of 6
    or 7 in float32, 10 of 10 or 11 in float64) and in segments of 3 to 48
    cells: advance_n_segments gives advance_n_plain's bits, SRHD warm and
    cold."""
    u, v, dt = seeded_sedov(51, system, seed=n, dtype=dtype)
    u = u[:101].contiguous()
    v = v[:102].contiguous()
    plan = T5.march_plan(101, reconstruct, u.element_size(),
                         H100._replace(sms=5))
    assert plan.ctas == 5 * T5.CTAS_PER_SM[u.element_size()]
    for warm in ((True,) if system == "euler" else (True, False)):
        kw = dict(reconstruct=reconstruct, system=system, warm=warm)
        want = T5.advance_n_plain(u, v, dt, n, **kw)
        for starts in (plan.starts, [0, 3, 51, 98, 101]):
            got = T5.advance_n_segments(u, v, dt, n, starts, **kw)
            assert torch.equal(got, want), (warm, list(starts))


def test_segment_march_rejects_segments_that_miss_cells():
    u, v, dt = seeded_sedov(8, "euler")
    for starts in ([0, 8, 15], [0, 2, 16], [1, 8, 16]):
        with pytest.raises(ValueError, match="do not cover"):
            T5.advance_n_segments(u, v, dt, 1, starts)


@pytest.mark.parametrize("system,reconstruct", [("srhd", "pcm"),
                                                ("euler", "weno5")])
def test_segment_march_matches_jax_b5_interpret(system, reconstruct):
    """The march as plain PyTorch in 43 segments against the JAX B5 in
    interpret mode, 5 steps at 128 cells, SRHD warm and cold (the outer
    cells flat: the two read other weno5 stencils at the outer face)."""
    u, v, dt = seeded_sedov(64, system, seed=9, flat_edge=True)
    starts = R.split_starts(128, 42)
    for warm in ((True,) if system == "euler" else (False, True)):
        with pltpu.force_tpu_interpret_mode():
            want = np.asarray(J5.advance_n_pallas(
                jnp.asarray(u.numpy()), jnp.asarray(v.numpy()), dt, 5,
                reconstruct, 1.5, system=system, warm=warm, interpret=True))
        got = T5.advance_n_segments(u, v, dt, 5, starts, reconstruct, 1.5,
                                    system=system, warm=warm)
        np.testing.assert_allclose(got.numpy(), want, **B5_TOL)
