"""Kernel B7 (mara3_tpu_torch/csrc/sand3d_step.cu) and its plain PyTorch
version (kernels/sand3d_step.advance_n_plain): the wrapper's contract on
the CPU, and the kernel against the plain version on a card.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernel and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_sand3d_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import sand3d_step as T7
from mara3_tpu_torch.subprograms import sand3d as TS

torch.set_num_threads(1)

# the kernel against the plain version: the JAX package's bars for its B7,
# times max |u| (tests/test_sand3d_kernel.py:55-56); both round every
# operation the same way, so they agree bit for bit
BAR = {torch.float64: 1e-13, torch.float32: 5e-6}
# float32 also: each element within 64 ulps of its cell
F32_ULPS = 64
STEPS = [0, 1, 3, 17]
V = (0.5, 0.3, 0.7)


def seeded(depth, bs, seed=0, dtype=torch.float64, device="cpu", v=V):
    """(u, tables) of sand3d's octree at depth and bs, each cell scaled by
    1 + 5% noise from a numpy seed, at velocity v and sand3d's dt."""
    cfg = TS.config_template().create().update(
        {"depth": depth, "block_size": bs})
    mesh = TS.build_mesh(cfg)
    u = TS.new_solution(cfg, mesh, dtype=torch.float64).conserved
    rng = np.random.default_rng(seed)
    u = (u * torch.as_tensor(1.0 + 0.05 * rng.uniform(size=tuple(u.shape)))
         ).to(dtype=dtype, device=device)
    dxb = TS.block_spacings(mesh, bs, dtype, device)
    return u, T7.guard_tables(mesh, dxb, v, TS.time_step(mesh, bs))


def test_plain_takes_no_step_and_keeps_its_input():
    u, tab = seeded(3, 8)
    u_copy = u.clone()
    got = T7.advance_n_plain(u, tab, 0)
    assert torch.equal(got, u) and got.data_ptr() != u.data_ptr()
    T7.advance_n_plain(u, tab, 3)
    assert torch.equal(u, u_copy)


def test_tables_pack_the_lo_faces():
    cfg = TS.config_template().create().update({"depth": 3,
                                                "block_size": 8})
    mesh = TS.build_mesh(cfg)
    dt = TS.time_step(mesh, 8)
    dx = TS.block_spacings(mesh, 8, torch.float32, "cpu")
    tab = T7.guard_tables(mesh, dx, V, dt)
    assert tab.faces.shape == (len(mesh.leaves), 3, 9)
    assert np.array_equal(tab.faces[:, :, 0].numpy(), mesh.case[:, :, 0])
    assert np.array_equal(tab.faces[:, :, 5:].numpy(),
                          mesh.fine_id[:, :, 0])
    # c = v (dt / dx), v and dt rounded to the dtype first
    want = torch.tensor(V, dtype=torch.float32)[:, None] * (
        torch.tensor(dt, dtype=torch.float32) / dx)[None, :]
    assert torch.equal(tab.c, want)


@pytest.mark.parametrize("make,match", [
    (lambda u, t: (u[..., :4], t), "B, bs, bs, bs"),
    (lambda u, t: (u[:, :7, :7, :7], t), "even block size"),
    (lambda u, t: (u[:-1], t), "guard tables of"),
    (lambda u, t: (u.float(), t), "courant factors in"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    u, tab = seeded(3, 8)
    for fn in (T7.advance_n_plain, T7.advance_n_cuda):
        with pytest.raises(ValueError, match=match):
            fn(*make(u, tab), 1)
    with pytest.raises(ValueError, match="n >= 0"):
        T7.advance_n_plain(u, tab, -1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        T7.advance_n_cuda(u, tab, 1)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    u, tab = seeded(3, 8, seed=1)
    before = T7.advance_n_cuda.launches
    assert torch.equal(T7.advance_n(u, tab, 4), T7.advance_n_plain(u, tab, 4))
    assert T7.advance_n_cuda.launches == before
    with pytest.raises(ValueError, match="no sand3d advance"):
        T7.advance_n(u.to("meta"), tab, 1)


# -----------------------------------------------------------------------------
# the kernel on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B7 runs only on a CUDA card (no GPU here)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("depth,bs", [(3, 8), (4, 16)], ids=["d3b8", "d4b16"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_matches_plain(cuda_device, dtype, depth, bs):
    """A tree with all three face cases (d3b8) and the full width (d4b16),
    n in {0, 1, 3, 17}; the input is not written; one counted call per
    n > 0."""
    u, tab = seeded(depth, bs, dtype=dtype, device=cuda_device)
    u_copy = u.clone()
    scale = float(u.abs().max())
    for n in STEPS:
        before = T7.advance_n_cuda.launches
        got = T7.advance_n_cuda(u, tab, n)
        torch.cuda.synchronize()
        assert T7.advance_n_cuda.launches == before + (n > 0)
        want = T7.advance_n_plain(u, tab, n)
        assert got.shape == u.shape and got.dtype == dtype
        g, w = got.cpu().numpy(), want.cpu().numpy()
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, rtol=0, atol=BAR[dtype] * scale)
        if dtype == torch.float32:
            assert np.all(np.abs(g - w)
                          <= F32_ULPS * np.finfo(np.float32).eps * np.abs(w))
    assert torch.equal(u, u_copy)


@pytest.mark.cuda
def test_sand3d_card_matches_the_cpu(cuda_device):
    """sand3d's advance on the card (B7) against the CPU's scheme, float64,
    11 steps at depth 3, bs 8, v = (0.5, 0.5, 0.5)."""
    cfg = TS.config_template().create().update({"depth": 3,
                                                "block_size": 8})
    mesh = TS.build_mesh(cfg)
    u = TS.new_solution(cfg, mesh, dtype=torch.float64).conserved
    dt = TS.time_step(mesh, 8)
    got = TS.make_advance_auto(mesh, 8, TS.VELOCITY, -1, cuda_device)(
        u.to(cuda_device), dt, 11)
    assert TS.LAST_PATH == "cuda_b7[11]"
    want = TS.make_advance_auto(mesh, 8, TS.VELOCITY, -1, "cpu")(u, dt, 11)
    assert TS.LAST_PATH == "scheme[11]"
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), rtol=0,
                               atol=BAR[torch.float64] * float(u.abs().max()))
