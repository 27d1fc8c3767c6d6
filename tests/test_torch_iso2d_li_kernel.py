"""Kernel B8 (mara3_tpu_torch/csrc/iso2d_ladder.cu, the locally isothermal
window step) against its plain PyTorch version (kernels/iso2d_step_li.py),
and its wrappers' contract.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernel and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_iso2d_li_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import iso2d_step_li as TL
from mara3_tpu_torch.kernels import iso2d_step_v2 as V2

torch.set_num_threads(1)

# float32: the kernel rounds each operation as the plain version does
# (--fmad=false, the geometry cast first, sqrt and division correctly
# rounded), so each element is held to 64 ulps of its cell's largest
# component; float64 bit for bit
F32_ULPS = 64
F32_ATOL = 1e-30
DT, THETA = 2e-4, 1.8
# (dx, x0, y0, Lx, Ly, mach2, rsoft2) for 96 x 160 cells: a domain beside
# the origin, and one that straddles r = 0 with Lx != Ly
GEOMS = {"offset": (1.0 / 96, 1.0, 1.0, 1.0, 160 / 96, 100.0, 1e-4),
         "r=0": (1.0 / 96, -0.5, -0.75, 1.0, 160 / 96, 100.0, 1e-2)}


def kw(geom):
    return dict(geom=geom, dtdx=DT / geom[0], dtdy=DT / geom[0], theta=THETA)


def random_state(nx, ny, dtype, device, seed=0):
    """u [3, nx, ny] of density 1-1.2 and speeds ~0.1, from a numpy seed."""
    rng = np.random.default_rng(seed)
    sg = 1.0 + 0.2 * rng.uniform(size=(nx, ny))
    vx = 0.1 * rng.normal(size=(nx, ny))
    vy = 0.1 * rng.normal(size=(nx, ny))
    return torch.tensor(np.stack([sg, sg * vx, sg * vy]), dtype=dtype,
                        device=device)


def assert_close(got, want):
    """float64 bit for bit; float32 each element within F32_ULPS ulps of its
    cell's largest component (axis 0)."""
    if got.dtype == torch.float64:
        assert torch.equal(got, want)
        return
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    assert np.isfinite(g).all()
    bar = F32_ULPS * np.finfo(np.float32).eps * np.abs(w).max(
        axis=0, keepdims=True)
    worst = float((np.abs(g - w) / np.maximum(bar, 1e-300)).max())
    assert np.all(np.abs(g - w) <= bar + F32_ATOL), \
        f"{worst:.2f} x the bar of {F32_ULPS} ulps of the cell"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B8 runs only on a CUDA card (no GPU here)")
    return torch.device("cuda")


# -----------------------------------------------------------------------------
# the wrappers' contract, checked on the CPU
# -----------------------------------------------------------------------------

def test_wrapper_refuses_a_cpu_tensor_and_bf16():
    u = random_state(32, 16, torch.float32, "cpu")
    k = dict(kw(GEOMS["offset"]), G=2, tile=(16, 8))
    strips = V2.build_halo_strips(u, 16, 8, h=4)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TL.step_li_strips_cuda(u, *strips, **k)
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        TL.step_li_strips_cuda(u.to(torch.bfloat16),
                               *(s.to(torch.bfloat16) for s in strips), **k)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    u = random_state(32, 16, torch.float64, "cpu")
    k = dict(kw(GEOMS["r=0"]), G=2, tile=(16, 8))
    before = TL.step_li_strips_cuda.launches
    strips = V2.build_halo_strips(u, 16, 8, h=4)
    assert torch.equal(TL.step_li_strips(u, *strips, **k),
                       TL.step_li_strips_plain(u, *strips, **k))
    assert torch.equal(TL.advance_n_li(u, 4, **k),
                       TL.step_li(TL.step_li(u, **k), **k))
    assert TL.step_li_strips_cuda.launches == before
    with pytest.raises(ValueError, match="no iso2d li step"):
        TL.step_li_strips(u.to("meta"), *(s.to("meta") for s in strips), **k)


# -----------------------------------------------------------------------------
# the kernel on the card
# -----------------------------------------------------------------------------

DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("name", sorted(GEOMS))
@pytest.mark.parametrize("G", [1, 2, 4])
def test_b8_matches_plain(cuda_device, G, name, dtype):
    """96 x 160 in tiles of 32 x 32 and 48 x 80, two CTA sub-tiles each,
    periodic strips: the same bits whatever the CTA, and the plain
    version's; u is not written; one counted launch a call."""
    u = random_state(96, 160, dtype, cuda_device, G)
    u_copy = u.clone()
    k = kw(GEOMS[name])
    for tile in ((32, 32), (48, 80)):
        strips = V2.build_halo_strips(u, *tile, h=2 * G)
        plain = TL.step_li_strips_plain(u, *strips, G=G, tile=tile, **k)
        runs = []
        for cta in (None, (8, 16)):
            before = TL.step_li_strips_cuda.launches
            runs.append(TL.step_li_strips_cuda(u, *strips, G=G, tile=tile,
                                               cta=cta, **k))
            torch.cuda.synchronize()
            assert TL.step_li_strips_cuda.launches == before + 1
        assert torch.equal(runs[0], runs[1])
        assert_close(runs[0], plain)
    assert torch.equal(u, u_copy)


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("G", [1, 4])
def test_b8_matches_plain_with_random_strips(cuda_device, G, dtype):
    """The kernel reads its halo from the strips it is given, not from the
    state."""
    u = random_state(96, 160, dtype, cuda_device, 3)
    noise = random_state(96, 160, dtype, cuda_device, 4)
    strips = V2.build_halo_strips(noise, 32, 32, h=2 * G)
    k = dict(kw(GEOMS["r=0"]), G=G, tile=(32, 32))
    got = TL.step_li_strips_cuda(u, *strips, **k)
    torch.cuda.synchronize()
    assert_close(got, TL.step_li_strips_plain(u, *strips, **k))


@pytest.mark.cuda
@DTYPES
def test_b8_advance_matches_plain(cuda_device, dtype):
    """8 periodic steps, G = 4: advance_n_li through B8 on the card against
    the plain version on the card."""
    u = random_state(96, 160, dtype, cuda_device, 5)
    k = dict(kw(GEOMS["r=0"]), G=4, tile=(32, 32))
    got = TL.advance_n_li(u, 8, **k)
    want = u
    for _ in range(2):
        want = TL.step_li_strips_plain(
            want, *V2.build_halo_strips(want, 32, 32, h=8), **k)
    torch.cuda.synchronize()
    assert_close(got, want)
