"""Kernel B1 (mara3_tpu_torch/csrc/iso2d_step.cu) against its plain PyTorch
version (kernels/iso2d_step.advance_n_plain), and its wrapper's contract.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernel and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_iso2d_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import iso2d_step as TK

torch.set_num_threads(1)

# float64: the bar of the CPU test of the plain version against the JAX B1
F64_TOL = dict(rtol=1e-13, atol=1e-13)
# float32: the kernel rounds each operation as the plain version does
# (--fmad=false, the scalars cast first), so each element is held to 64
# ulps of its cell's largest component, with an atol far below the state's
# values
F32_ULPS = 64
F32_ATOL = 1e-30
SHAPES = [(96, 160), (37, 45), (4, 7), (130, 4)]
STEPS = [0, 1, 3, 16]


def random_state(nx, ny, dtype, device, seed=0):
    """u [3, nx, ny] of density 1-1.2 and speeds ~0.1, from a numpy seed."""
    rng = np.random.default_rng(seed)
    sg = 1.0 + 0.2 * rng.uniform(size=(nx, ny))
    vx = 0.1 * rng.normal(size=(nx, ny))
    vy = 0.1 * rng.normal(size=(nx, ny))
    return torch.tensor(np.stack([sg, sg * vx, sg * vy]), dtype=dtype,
                        device=device)


def assert_f32_cells_close(u, u_ref, ulps):
    """Every element of [3, nx, ny] within `ulps` float32 ulps of its cell's
    largest component (axis 0), plus F32_ATOL."""
    bar = ulps * np.finfo(np.float32).eps * np.abs(u_ref).max(axis=0,
                                                              keepdims=True)
    worst = float((np.abs(u - u_ref) / np.maximum(bar, 1e-300)).max())
    assert np.all(np.abs(u - u_ref) <= bar + F32_ATOL), \
        f"{worst:.2f} x the bar of {ulps} ulps of the cell"


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 runs only on a CUDA card (no GPU here)")
    return torch.device("cuda")


# -----------------------------------------------------------------------------
# the wrapper's contract, checked on the CPU
# -----------------------------------------------------------------------------

KW = dict(cs2=0.5, dtdx=0.1, dtdy=0.1, theta=1.5)


def test_f32_cell_bar_catches_a_small_error():
    u = random_state(8, 6, torch.float64, "cpu").numpy()
    assert_f32_cells_close(u, u, F32_ULPS)
    bad = u.copy()
    bad[2, 3, 4] += 1e-4 * np.abs(u[:, 3, 4]).max()
    with pytest.raises(AssertionError):
        assert_f32_cells_close(bad, u, F32_ULPS)


@pytest.mark.parametrize("make,match", [
    (lambda u: u.to(torch.float16), "float32 or float64"),
    (lambda u: u.transpose(1, 2), "contiguous"),
    (lambda u: u[:, :3].contiguous(), "nx, ny >= 4"),
    (lambda u: u[:, :, :2].contiguous(), "nx, ny >= 4"),
    (lambda u: u[:2].contiguous(), r"u \[3, nx, ny\]"),
    (lambda u: u, "CUDA tensor"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    u = random_state(8, 6, torch.float32, "cpu")
    with pytest.raises(ValueError, match=match):
        TK.advance_n_cuda(make(u), 1, **KW)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    u = random_state(9, 6, torch.float64, "cpu")
    before = TK.advance_n_cuda.launches
    got = TK.advance_n(u, 3, rk_order=2, riemann="hllc", **KW)
    want = TK.advance_n_plain(u, 3, rk_order=2, riemann="hllc", **KW)
    assert torch.equal(got, want)
    assert TK.advance_n_cuda.launches == before


# -----------------------------------------------------------------------------
# the kernel on the card
# -----------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
@pytest.mark.parametrize("rk", [1, 2])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_matches_plain(cuda_device, dtype, rk, riemann):
    """Odd shapes, the 4-cell minimum, n in {0, 1, 3, 16}; the input is not
    written; one counted call per n > 0."""
    for seed, (nx, ny) in enumerate(SHAPES):
        u = random_state(nx, ny, dtype, cuda_device, seed)
        u_copy = u.clone()
        for n in STEPS:
            kw = dict(KW, dtdy=0.12, rk_order=rk, riemann=riemann)
            before = TK.advance_n_cuda.launches
            got = TK.advance_n_cuda(u, n, **kw)
            torch.cuda.synchronize()
            assert TK.advance_n_cuda.launches == before + (n > 0)
            want = TK.advance_n_plain(u, n, **kw)
            assert got.shape == u.shape and got.dtype == dtype
            g, w = got.cpu().numpy(), want.cpu().numpy()
            assert np.isfinite(g).all()
            if dtype == torch.float64:
                np.testing.assert_allclose(g, w, **F64_TOL)
            else:
                assert_f32_cells_close(g, w, F32_ULPS)
        assert torch.equal(u, u_copy)


@pytest.mark.cuda
def test_kernel_matches_plain_on_the_cpu(cuda_device):
    """The kernel on the card against the plain version on the CPU,
    float64, 11 RK2 HLLC steps."""
    u = random_state(64, 48, torch.float64, "cpu", seed=5)
    kw = dict(KW, rk_order=2, riemann="hllc")
    got = TK.advance_n(u.to(cuda_device), 11, **kw).cpu().numpy()
    want = TK.advance_n(u, 11, **kw).numpy()
    np.testing.assert_allclose(got, want, **F64_TOL)
