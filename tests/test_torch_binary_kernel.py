"""Kernel B2 (mara3_tpu_torch/csrc/binary_advance.cu) against its plain
PyTorch version (kernels/binary_advance.advance_plain).

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernel and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_binary_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import binary_advance as TK
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

# the bars of the CPU parity tests (tests/test_torch_binary_advance.py)
U_TOL = dict(rtol=1e-12, atol=1e-20)
TOTAL_TOL = dict(rtol=1e-10, atol=1e-17)
# float32: the kernel rounds each operation as the plain version does
# (--fmad=false) but sums the totals in another order, in float64; allow
# 64 ulps of the largest value of each component per advance
F32_ULPS = 64

MATRIX = [
    {"conserve_linear_p": cp, "riemann": rs, "reconstruct_method": rm}
    for cp in (1, 0) for rs in ("hlle", "hllc") for rm in ("plm", "pcm")]
VARIANTS = [
    {"conserve_linear_p": 0, "axisymmetric_cs2": 1, "nu": 1e-3,
     "alpha_cutoff_radius": 0.5},
    {"conserve_linear_p": 1, "axisymmetric_cs2": 1, "riemann": "hllc",
     "alpha_cutoff_radius": 0.5},
]
IDS = ["-".join(f"{k}={v}" for k, v in o.items()) for o in MATRIX + VARIANTS]


def make_case(over, device, dtype, depth=3, seed=0, t=0.7):
    """(solver data, perturbed state, bodies, dt) from a seed."""
    base = {"depth": depth, "block_size": 8, "density_floor": 1e-3}
    cfg = TB.create_config_template().create().update({**base, **over})
    sd = TB.create_solver_data(cfg, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    noise = 1.0 + 0.05 * rng.uniform(-1.0, 1.0,
                                     tuple(sd.initial_conserved.shape))
    u0 = sd.initial_conserved * torch.as_tensor(noise, dtype=dtype,
                                                device=device)
    bodies = TB.bodies_array(TB.two_body.compute_two_body_state(
        TB.two_body.make_full_orbital_elements(TB.create_binary_params(cfg)),
        t))
    return sd, u0.contiguous(), bodies, sd.recommended_time_step


def to_host(result):
    u1, totals, invalid = result
    return (u1.cpu().numpy(), {k: v.cpu().numpy() for k, v in totals.items()},
            bool(invalid))


def assert_close(got, want, u_tol=U_TOL, total_tol=TOTAL_TOL):
    u1, totals, invalid = to_host(got)
    u1_ref, totals_ref, invalid_ref = to_host(want)
    if u_tol is None:     # float32: per-component bar
        eps = np.finfo(np.float32).eps
        bar = F32_ULPS * eps * np.abs(u1_ref).max(axis=(0, 1, 2))
        assert np.all(np.abs(u1 - u1_ref) <= bar)
    else:
        np.testing.assert_allclose(u1, u1_ref, **u_tol)
    assert set(totals) == set(totals_ref)
    for k in totals_ref:
        np.testing.assert_allclose(totals[k], totals_ref[k], **total_tol,
                                   err_msg=k)
    assert invalid == invalid_ref


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B2 runs only on a CUDA card (no GPU here)")
    return torch.device("cuda")


# -----------------------------------------------------------------------------
# the wrapper's contract, checked on the CPU
# -----------------------------------------------------------------------------

def test_cpu_tensor_takes_plain_path():
    """On a CPU tensor the dispatcher runs the plain version and never the
    kernel (whose launch count stays put)."""
    sd, u0, bodies, dt = make_case({}, "cpu", torch.float64, depth=2)
    t = sd.advance.tables
    before = TK.advance_cuda.launches
    got = TK.advance(t, u0, bodies, dt, 1.8)
    want = TK.advance_plain(t, u0, bodies, dt, 1.8)
    assert TK.advance_cuda.launches == before
    assert torch.equal(got[0], want[0])


def test_kernel_wrapper_rejects_cpu_tensors():
    """The kernel's wrapper raises on what the kernel does not take rather
    than running something else."""
    sd, u0, bodies, dt = make_case({}, "cpu", torch.float64, depth=2)
    with pytest.raises(ValueError, match="CUDA"):
        TK.advance_cuda(sd.advance.tables, u0, bodies, dt, 1.8)


def test_kernel_params_layout():
    """The scalar block the CUDA source reads (read_params): 24 doubles and
    the flag bits (axisymmetric, conserve_linear_p, hllc)."""
    cfg = TB.SchemeConfig(
        block_size=8, domain_radius=12.0, mach_number=10.0,
        softening_radius=0.05, sink_radius=0.05, sink_rate=1.0,
        gst_suppr_radius=0.1, density_floor=0.0, alpha=0.1,
        alpha_cutoff_radius=0.0, nu=0.0, axisymmetric_cs2=True,
        conserve_linear_p=False, reconstruct_method="plm", riemann="hllc")
    bodies = np.arange(10.0).reshape(2, 5)
    params, flags = TK.kernel_params(cfg, bodies, 0.25, 1.5)
    assert params.shape == (24,) and params.dtype == np.float64
    assert params[0] == 0.25 and params[1] == 1.5
    np.testing.assert_array_equal(params[2:12], bodies.ravel())
    assert params[15] == 100.0 and params[16] == 10.0
    assert params[22] == 12.0
    assert flags == 0b101


def test_axes_rows_copy_the_geometry():
    """The per-block coordinate rows the kernel reads are exact copies of
    the cell- and face-center arrays the plain version reads."""
    sd, _, _, _ = make_case({}, "cpu", torch.float64, depth=2)
    t = sd.advance.tables
    axes = t.axes.numpy()
    xc, _, _, xf, yf = sd.geometry
    bs = xc.shape[1]
    np.testing.assert_array_equal(
        np.broadcast_to(axes[:, 0, :bs, None], xc.shape[:-1]), xc[..., 0])
    np.testing.assert_array_equal(
        np.broadcast_to(axes[:, 1, None, :bs], xc.shape[:-1]), xc[..., 1])
    np.testing.assert_array_equal(
        np.broadcast_to(axes[:, 2, :, None], xf.shape[:-1]), xf[..., 0])
    np.testing.assert_array_equal(
        np.broadcast_to(axes[:, 3, None, :bs], xf.shape[:-1]), xf[..., 1])
    np.testing.assert_array_equal(
        np.broadcast_to(axes[:, 4, :bs, None], yf.shape[:-1]), yf[..., 0])
    np.testing.assert_array_equal(
        np.broadcast_to(axes[:, 5, None, :], yf.shape[:-1]), yf[..., 1])


# -----------------------------------------------------------------------------
# the kernel on the card
# -----------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("over", MATRIX + VARIANTS, ids=IDS)
def test_kernel_matches_plain_f64(cuda_device, over):
    """float64, at the bars of the CPU parity tests; depth 3 has same,
    coarse and fine faces."""
    sd, u0, bodies, dt = make_case(over, cuda_device, torch.float64)
    t = sd.advance.tables
    before = TK.advance_cuda.launches
    got = TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
    torch.cuda.synchronize()
    assert TK.advance_cuda.launches == before + 1
    assert_close(got, TK.advance_plain(t, u0, bodies, dt, sd.plm_theta))


@pytest.mark.cuda
@pytest.mark.parametrize("over", MATRIX, ids=IDS[:len(MATRIX)])
def test_kernel_matches_plain_f32(cuda_device, over):
    sd, u0, bodies, dt = make_case(over, cuda_device, torch.float32)
    t = sd.advance.tables
    got = TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
    assert_close(got, TK.advance_plain(t, u0, bodies, dt, sd.plm_theta),
                 u_tol=None, total_tol=dict(rtol=1e-4, atol=1e-12))


@pytest.mark.cuda
def test_kernel_safe_mode_and_fault(cuda_device):
    """theta = 0 (the safe-mode retry) at run time, and the fault flag
    under dt x 1e4."""
    sd, u0, bodies, dt = make_case({}, cuda_device, torch.float64, seed=1)
    t = sd.advance.tables
    assert_close(TK.advance_cuda(t, u0, bodies, dt, 0.0),
                 TK.advance_plain(t, u0, bodies, dt, 0.0))
    u0 = sd.initial_conserved.contiguous()
    _, _, invalid = TK.advance_cuda(t, u0, bodies, dt * 1e4, sd.plm_theta)
    _, _, invalid_ref = TK.advance_plain(t, u0, bodies, dt * 1e4,
                                         sd.plm_theta)
    assert bool(invalid) and bool(invalid_ref)


@pytest.mark.cuda
def test_cuda_tensor_takes_kernel(cuda_device):
    """The dispatcher launches the kernel for a CUDA tensor, and the
    wrapper refuses a dtype or a layout it does not take."""
    sd, u0, bodies, dt = make_case({}, cuda_device, torch.float64, depth=2)
    t = sd.advance.tables
    before = TK.advance_cuda.launches
    TK.advance(t, u0, bodies, dt, sd.plm_theta)
    assert TK.advance_cuda.launches == before + 1
    with pytest.raises(TypeError):
        TK.advance_cuda(t, u0.float(), bodies, dt, sd.plm_theta)
    with pytest.raises(ValueError, match="contiguous"):
        TK.advance_cuda(t, u0.transpose(1, 2), bodies, dt, sd.plm_theta)
