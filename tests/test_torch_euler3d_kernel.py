"""Kernel B12 (mara3_tpu_torch/csrc/octree_euler_step.cu) and its plain
PyTorch version (kernels/euler3d_step.advance_n_plain): the wrapper's
contract on the CPU, and the kernel against the plain version on a card.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernel and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_euler3d_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import contextlib
import io

import numpy as np
import pytest
import torch

from mara3_tpu_torch.core.ops import scalar_div
from mara3_tpu_torch.kernels import euler3d_step as T12
from mara3_tpu_torch.mesh import amr3d, euler3d
from mara3_tpu_torch.physics import euler, on_axis
from mara3_tpu_torch.subprograms import blast3d

torch.set_num_threads(1)

GAMMA = blast3d.GAMMA
STEPS = [0, 1, 3, 17]


def seeded(depth, bs, seed=0, dtype=torch.float64, device="cpu"):
    """(mesh, U, dt) of blast3d's octree at depth and bs, each cell's five
    components scaled by 1 + 5% noise from a numpy seed, at the blast's
    first CFL dt."""
    cfg = blast3d.config_template().create().update(
        {"depth": depth, "block_size": bs})
    mesh = blast3d.build_mesh(cfg)
    U = blast3d.new_solution(cfg, mesh, dtype=torch.float64).conserved
    rng = np.random.default_rng(seed)
    U = (U * torch.as_tensor(1.0 + 0.05 * rng.uniform(size=tuple(U.shape)))
         ).to(dtype=dtype, device=device)
    a = float(euler3d.max_signal_speed(U.cpu().double(), GAMMA))
    return mesh, U, 0.3 * blast3d.min_spacing(mesh, bs) / a / 3.0


def parent_advance(mesh, bs, U, dt, steps, g=GAMMA, domain_size=2.0):
    """mesh/euler3d.make_advance's step as it stood before the kernel, line
    for line, without its spans."""
    def face_flux(P, axis):
        n = P.shape[1]
        lo = amr3d._guard(P, mesh, axis, 0).unsqueeze(axis + 1)
        hi = amr3d._guard(P, mesh, axis, 1).unsqueeze(axis + 1)
        Pe = torch.cat([lo, P, hi], dim=axis + 1)
        F = euler.riemann_hlle(Pe.narrow(axis + 1, 0, n + 1),
                               Pe.narrow(axis + 1, 1, n + 1), on_axis(axis),
                               g)
        return amr3d.correct_fluxes(F, axis, mesh)

    dx = torch.as_tensor(domain_size / (1 << mesh.level) / bs).to(
        device=U.device, dtype=U.dtype)
    inv_dx = scalar_div(1.0, dx)[:, None, None, None, None]
    dt_ = torch.full((), dt, dtype=U.dtype, device=U.device)
    n = U.shape[1]
    for _ in range(steps):
        P = euler.recover_primitive(U, g)
        dU = 0.0
        for axis in range(3):
            F = face_flux(P, axis)
            dU = dU + (F.narrow(axis + 1, 1, n) - F.narrow(axis + 1, 0, n))
        U = U - dt_ * inv_dx * dU
    return U


@pytest.mark.parametrize("depth", [3, 4])
def test_face_tables_hold_the_meshs_faces(depth):
    cfg = blast3d.config_template().create().update({"depth": depth})
    mesh = blast3d.build_mesh(cfg)
    faces = T12.face_tables(mesh)
    assert faces.dtype == torch.int32 and faces.is_contiguous()
    assert tuple(faces.shape) == (len(mesh.leaves), 3, 2, 9)
    f = faces.numpy()
    for k, name in enumerate(("case", "same_id", "coarse_id", "tq1", "tq2")):
        assert np.array_equal(f[..., k], getattr(mesh, name)), name
    assert np.array_equal(f[..., 5:], mesh.fine_id)
    # the mesh has every case, so the kernel's three paths are all taken
    assert set(np.unique(f[..., 0])) == {amr3d.SAME, amr3d.COARSE,
                                         amr3d.FINE}


@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_plain_is_the_step_as_it_was(dtype):
    """Bit for bit, across the level jumps of depth 3, block 4."""
    mesh, U, dt = seeded(3, 4, seed=2, dtype=dtype)
    for n in (1, 5):
        want = parent_advance(mesh, 4, U, dt, n)
        assert torch.equal(T12.advance_n_plain(U, mesh, dt, n, GAMMA), want)
        assert torch.equal(euler3d.make_advance(mesh, 4, GAMMA)(U, dt, n),
                           want)


def test_no_step_returns_a_copy_and_the_input_is_kept():
    mesh, U, dt = seeded(3, 4, seed=1)
    U_copy = U.clone()
    for fn in (T12.advance_n_plain, T12.advance_n):
        got = fn(U, mesh, dt, 0, GAMMA)
        assert torch.equal(got, U) and got.data_ptr() != U.data_ptr()
    T12.advance_n_plain(U, mesh, dt, 3, GAMMA)
    assert torch.equal(U, U_copy)


@pytest.mark.parametrize("make,match", [
    (lambda U, f, i: (U[..., :4], f, i), r"B, bs, bs, bs, 5"),
    (lambda U, f, i: (U[:, :3, :3, :3], f, i), "even block size"),
    (lambda U, f, i: (U.half(), f, i.half()), "float32 or float64"),
    (lambda U, f, i: (U, f[:-1], i), "face table"),
    (lambda U, f, i: (U, f.long(), i), "face table"),
    (lambda U, f, i: (U, f, i.float()), "inverse cell sizes"),
    (lambda U, f, i: (U, f, i), "CUDA tensor"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    """Checked before anything touches a card, so a CPU tensor shows each
    refusal; the last is the CPU tensor itself."""
    mesh, U, dt = seeded(3, 4)
    faces = T12.face_tables(mesh)
    inv_dx = scalar_div(1.0, euler3d._spacings(mesh, 4, 2.0, U))
    with pytest.raises(ValueError, match=match):
        T12.advance_n_cuda(*make(U, faces, inv_dx), dt, 1, GAMMA)
    with pytest.raises(ValueError, match="n >= 0"):
        T12.advance_n_cuda(U, faces, inv_dx, dt, -1, GAMMA)
    with pytest.raises(ValueError, match="n >= 0"):
        T12.advance_n_plain(U, mesh, dt, -1, GAMMA)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    mesh, U, dt = seeded(3, 4, seed=3)
    before = T12.advance_n_cuda.launches
    assert torch.equal(T12.advance_n(U, mesh, dt, 4, GAMMA),
                       T12.advance_n_plain(U, mesh, dt, 4, GAMMA))
    assert T12.advance_n_cuda.launches == before
    assert T12.LAST_PATH == "scheme[4]"
    with pytest.raises(ValueError, match="no octree Euler step"):
        T12.advance_n(U.to("meta"), mesh, dt, 1, GAMMA)


# -----------------------------------------------------------------------------
# the kernel on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B12 runs only on a CUDA card (no GPU here)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth,bs", [(3, 8), (4, 16)], ids=["d3b8", "d4b16"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_matches_plain_bit_for_bit(cuda_device, dtype, depth, bs):
    """Trees with every face case (level jumps both ways), n in {0, 1, 3,
    17}; the input is not written; n launches a call."""
    mesh, U, dt = seeded(depth, bs, dtype=dtype, device=cuda_device)
    U_copy = U.clone()
    for n in STEPS:
        before = T12.advance_n_cuda.launches
        got = T12.advance_n(U, mesh, dt, n, GAMMA)
        torch.cuda.synchronize()
        assert T12.advance_n_cuda.launches == before + n
        assert T12.LAST_PATH == f"cuda_b12[{n}]"
        want = T12.advance_n_plain(U, mesh, dt, n, GAMMA)
        assert got.shape == U.shape and got.dtype == dtype
        assert bool(torch.isfinite(got).all())
        assert torch.equal(got, want), (
            f"n = {n}: {int((got != want).sum())} values differ, at most "
            f"{float((got - want).abs().max()):.3e}")
    assert torch.equal(U, U_copy)


@pytest.mark.cuda
def test_kernel_cuts_tiles_at_the_blocks_edge(cuda_device):
    """bs 6 (tiles of 2 x 6 x 6, cut in y and z) and bs 18 (the last
    tiles in y and z cut to 2 cells), float64, 3 steps."""
    for bs in (6, 18):
        mesh, U, dt = seeded(3, bs, seed=4, device=cuda_device)
        got = T12.advance_n(U, mesh, dt, 3, GAMMA)
        assert torch.equal(got, T12.advance_n_plain(U, mesh, dt, 3, GAMMA))


@pytest.mark.cuda
@pytest.mark.parametrize("make,match", [
    (lambda U: U.half(), "float32 or float64"),
    (lambda U: U[:, :7, :7, :7], "even block size"),
    (lambda U: U.transpose(1, 2), "contiguous"),
])
def test_kernel_refuses_a_cuda_tensor_it_does_not_take(cuda_device, make,
                                                       match):
    mesh, U, dt = seeded(3, 8, device=cuda_device)
    with pytest.raises(ValueError, match=match):
        T12.advance_n(make(U), mesh, dt, 1, GAMMA)


@pytest.mark.cuda
def test_blast3d_card_matches_the_cpu(cuda_device):
    """blast3d's make_advance on the card (B12) against the CPU's plain
    version, float64, 11 steps at depth 3, bs 8: the CPU's torch kernels
    are not the card's, so the bar is a tolerance."""
    mesh, U, dt = seeded(3, 8, seed=5)
    advance = euler3d.make_advance(mesh, 8, GAMMA)
    got = advance(U.to(cuda_device), dt, 11)
    assert T12.LAST_PATH == "cuda_b12[11]"
    want = advance(U, dt, 11)
    assert T12.LAST_PATH == "scheme[11]"
    # chip_smoke.py phase 44's bar for the card's run against the CPU's
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=1e-12,
                               atol=1e-14)


@pytest.mark.cuda
def test_blast3d_setup_names_the_kernel(cuda_device):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        blast3d.setup(["blast3d", "depth=2", "block_size=4"],
                      device=cuda_device)
    assert "advance: kernel B12 on " in out.getvalue()
