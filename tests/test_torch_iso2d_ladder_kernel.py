"""Kernels B9, B10a, B10b and B10c (mara3_tpu_torch/csrc/iso2d_ladder.cu)
against their plain PyTorch versions (kernels/iso2d_step_v4.py, _v1, _v2,
_v3) and kernel B1, the sharded advance on one card, and the wrappers'
contract.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernels and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_iso2d_ladder_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.kernels import iso2d_step_v1 as V1
from mara3_tpu_torch.kernels import iso2d_step_v2 as V2
from mara3_tpu_torch.kernels import iso2d_step_v3 as V3
from mara3_tpu_torch.kernels import iso2d_step_v4 as V4
from mara3_tpu_torch.parallel import iso2d_sharded as TS

torch.set_num_threads(1)

# float64: the bar of the CPU tests of the plain versions against the JAX
# kernels
F64_TOL = dict(rtol=1e-13, atol=1e-13)
# float32: the kernels round each operation as the plain versions do
# (--fmad=false, the scalars cast first), so each element is held to 64
# ulps of its cell's largest component
F32_ULPS = 64
F32_ATOL = 1e-30
KW = dict(cs2=0.5, dtdx=0.1, dtdy=0.12, theta=1.5)


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
    """float64 at the CPU bars; float32 each element within F32_ULPS ulps of
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
        pytest.skip("kernels B9 and B10a-c run only on a CUDA card (no GPU "
                    "here)")
    return torch.device("cuda")


# -----------------------------------------------------------------------------
# the wrappers' contract, checked on the CPU
# -----------------------------------------------------------------------------

def cpu_calls(u, dtype):
    """Each kernel wrapper called on u [3, 32, 16] (CPU) and its inputs, all
    cast to dtype."""
    lo, hi = (s.to(dtype) for s in V4.build_x_strips(u, 16, 4))
    strips = [s.to(dtype) for s in V2.build_halo_strips(u, 16, 8)]
    strips4 = [s.to(dtype) for s in V2.build_halo_strips(u, 16, 8, h=4)]
    ext = V1.extend_periodic(u).to(dtype)
    u = u.to(dtype)
    return {
        "B9": lambda: V4.step_v4_strips_cuda(u, lo, hi, G=2, TX=16, **KW),
        "B10a": lambda: V1.step_v1_cuda(ext, **KW),
        "B10b": lambda: V2.step_v2_strips_cuda(u, *strips, tile=(16, 8),
                                               **KW),
        "B10c": lambda: V3.step_v3_strips_cuda(u, *strips4, G=2,
                                               tile=(16, 8), **KW),
    }


@pytest.mark.parametrize("kernel", ["B9", "B10a", "B10b", "B10c"])
def test_wrappers_refuse_a_cpu_tensor_and_bf16(kernel):
    u = random_state(32, 16, torch.float32, "cpu")
    with pytest.raises(ValueError, match="CUDA tensor"):
        cpu_calls(u, torch.float32)[kernel]()
    call = cpu_calls(u, torch.bfloat16)[kernel]
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        call()


def test_wrappers_reject_shapes_the_kernels_do_not_take():
    u = random_state(32, 16, torch.float32, "cpu")
    lo, hi = V4.build_x_strips(u, 16, 4)
    for bad in (dict(TX=12), dict(TX=16, G=3), dict(TX=16, G=1)):
        with pytest.raises(ValueError):
            V4.step_v4_strips_plain(u, lo, hi, **{"G": 2, **bad}, **KW)
    with pytest.raises(ValueError, match="does not divide"):
        V2.build_halo_strips(u, 12, 8)
    with pytest.raises(ValueError, match="wider than the tile"):
        V2.build_halo_strips(u, 16, 8, h=10)
    with pytest.raises(ValueError, match="multiple of G"):
        V3.advance_n_v3(u, 6, G=4, tile=(16, 8), **KW)


def test_dispatch_takes_the_plain_versions_on_the_cpu():
    u = random_state(32, 16, torch.float64, "cpu")
    counts = lambda: (V4.step_v4_strips_cuda.launches,
                      V1.step_v1_cuda.launches,
                      V2.step_v2_strips_cuda.launches,
                      V3.step_v3_strips_cuda.launches)
    before = counts()
    want = TK.advance_n_plain(u, 4, **KW)
    assert torch.equal(V4.advance_n_v4(u, 4, G=2, TX=16, **KW), want)
    assert torch.equal(V1.advance_n_v1(u, 4, **KW), want)
    assert torch.equal(V2.advance_n_v2(u, 4, tile=(16, 8), **KW), want)
    assert torch.equal(V3.advance_n_v3(u, 4, G=2, tile=(16, 8), **KW), want)
    assert counts() == before


@pytest.mark.parametrize("h", [2, 4, 8, 16])
@pytest.mark.parametrize("itemsize", [4, 8])
def test_cta_tile_fits_its_window_in_shared_memory(h, itemsize):
    cta = V1.cta_tile(h, itemsize)
    assert cta in V1.CTA_TILES
    assert V1.window_bytes(cta, h, itemsize) <= V1.SMEM_BYTES


def test_cta_tile_refuses_a_window_that_fits_nowhere():
    with pytest.raises(ValueError, match="smaller G"):
        V1.cta_tile(32, 8)


# -----------------------------------------------------------------------------
# the kernels on the card
# -----------------------------------------------------------------------------

DTYPES = pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                                 ids=["f64", "f32"])


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
@pytest.mark.parametrize("rk", [1, 2])
def test_b9_matches_plain(cuda_device, rk, riemann, dtype):
    """96 x 160 in stripes of 32 (G = 2) and 40 x 36 in stripes of 20 (G =
    1), with periodic and with random strips; u is not written; one counted
    launch a call."""
    for seed, (nx, ny, TX, G) in enumerate([(96, 160, 32, 2),
                                            (40, 36, 20, 1)]):
        u = random_state(nx, ny, dtype, cuda_device, seed)
        u_copy = u.clone()
        h = 2 * G * rk
        for lo, hi in (V4.build_x_strips(u, TX, h),
                       random_strips(nx // TX, h, ny, dtype, cuda_device, 9)):
            kw = dict(KW, G=G, TX=TX, rk_order=rk, riemann=riemann)
            before = V4.step_v4_strips_cuda.launches
            got = V4.step_v4_strips_cuda(u, lo, hi, **kw)
            torch.cuda.synchronize()
            assert V4.step_v4_strips_cuda.launches == before + 1
            assert_close(got, V4.step_v4_strips_plain(u, lo, hi, **kw))
        assert torch.equal(u, u_copy)


@pytest.mark.cuda
@DTYPES
def test_b10a_matches_plain(cuda_device, dtype):
    for seed, (nx, ny) in enumerate([(96, 160), (37, 45), (4, 7)]):
        ext = V1.extend_periodic(random_state(nx, ny, dtype, cuda_device,
                                              seed))
        got = V1.step_v1_cuda(ext, **KW)
        torch.cuda.synchronize()
        assert_close(got, V1.step_v1_plain(ext, **KW))


@pytest.mark.cuda
@DTYPES
@pytest.mark.parametrize("G", [1, 2, 4])
def test_b10b_b10c_match_plain_at_two_tiles(cuda_device, dtype, G):
    """B10b (G = 1) and B10c: two strip tiles and two CTA sub-tiles give the
    same bits, and match the plain version; random strips too."""
    u = random_state(96, 160, dtype, cuda_device, 3)
    want = TK.advance_n_cuda(u, G, **KW)
    results = []
    for tile in ((32, 32), (48, 80)):
        strips = V2.build_halo_strips(u, *tile, h=2 * G)
        plain = V3.step_v3_strips_plain(u, *strips, G=G, tile=tile, **KW)
        for cta in (None, (8, 16)):
            if G == 1:
                got = V2.step_v2_strips_cuda(u, *strips, tile=tile, cta=cta,
                                             **KW)
            else:
                got = V3.step_v3_strips_cuda(u, *strips, G=G, tile=tile,
                                             cta=cta, **KW)
            torch.cuda.synchronize()
            assert_close(got, plain)
            results.append(got)
    assert all(torch.equal(r, results[0]) for r in results)
    assert_close(results[0], want)
    noise = random_state(96, 160, dtype, cuda_device, 4)
    strips = V2.build_halo_strips(noise, 32, 32, h=2 * G)
    assert_close(V3.step_v3_strips_cuda(u, *strips, G=G, tile=(32, 32),
                                        **KW),
                 V3.step_v3_strips_plain(u, *strips, G=G, tile=(32, 32),
                                         **KW))


@pytest.mark.cuda
@DTYPES
def test_every_ladder_kernel_is_bitwise_b1_in_rk1_hlle(cuda_device, dtype):
    """8 steps of each kernel's periodic wrapper against B1 on the card."""
    u = random_state(96, 160, dtype, cuda_device, 5)
    want = TK.advance_n_cuda(u, 8, **KW)
    runs = {
        "B9": V4.advance_n_v4(u, 8, G=4, TX=32, **KW),
        "B10a": V1.advance_n_v1(u, 8, **KW),
        "B10b": V2.advance_n_v2(u, 8, tile=(32, 32), **KW),
        "B10c": V3.advance_n_v3(u, 8, G=4, tile=(32, 32), **KW),
    }
    torch.cuda.synchronize()
    for name, got in runs.items():
        assert torch.equal(got, want), name


@pytest.mark.cuda
@pytest.mark.parametrize("rk,riemann", [(1, "hlle"), (2, "hllc")])
def test_four_shards_on_one_card_are_bitwise_one_shard(cuda_device, rk,
                                                       riemann):
    """make_advance_v4_sharded over [cuda:0] * 4 at 256 x 128, 8 steps: the
    same bits as one shard and as B1."""
    u = random_state(256, 128, torch.float32, cuda_device, 6)
    kw = dict(KW, TX=32, rk_order=rk, riemann=riemann)
    runs = []
    for n in (4, 1):
        devices = [cuda_device] * n
        adv = TS.make_advance_v4_sharded(devices, G=4, **kw)
        runs.append(TS.gather_state(adv(TS.shard_state(u, devices), 8)))
    want = TK.advance_n_cuda(u, 8, **KW, rk_order=rk, riemann=riemann)
    torch.cuda.synchronize()
    assert torch.equal(runs[0], runs[1])
    assert torch.equal(runs[0], want)
