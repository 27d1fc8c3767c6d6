"""Kernel B6 (mara3_tpu_torch/csrc/amrsand_step.cu) and its plain PyTorch
version (kernels/amrsand_step.advance_n_plain): the wrapper's contract on
the CPU, and the kernel against the plain version on a card.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernel and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_amrsand_kernel.py

(--noconftest: tests/conftest.py configures jax for the JAX package's
tests)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import amrsand_step as T6
from mara3_tpu_torch.mesh import block_layout as TB
from mara3_tpu_torch.subprograms import amrsand as TA

torch.set_num_threads(1)

# the kernel against the plain version, float64: the JAX package's bar for
# its B6 (tests/test_mesh_amr.py:268-269); both round every operation the
# same way, so they agree bit for bit
F64_TOL = dict(rtol=1e-13, atol=1e-15)
# float32: each element within 64 ulps of its cell
F32_ULPS = 64
STEPS = [0, 1, 3, 17]


def seeded(depth, bs, seed=0, dtype=torch.float64, device="cpu"):
    """(u, tables) of amrsand's quadtree at depth and bs, each cell scaled
    by 1 + 5% noise from a numpy seed."""
    cfg = TA.config_template().create().update(
        {"depth": depth, "block_size": bs})
    s = TA.new_solution(cfg, dtype=torch.float64)
    rng = np.random.default_rng(seed)
    u = s.conserved * torch.as_tensor(
        1.0 + 0.05 * rng.uniform(size=tuple(s.conserved.shape)))
    s = TA.replace(s, conserved=u.to(dtype=dtype, device=device))
    nt = TB.build_neighbor_table(s.leaves)
    return s.conserved, T6.guard_tables(nt, TA.block_spacings(s),
                                        TA.time_step(s))


def test_plain_takes_no_step_and_keeps_its_input():
    u, tab = seeded(3, 8)
    u_copy = u.clone()
    got = T6.advance_n_plain(u, tab, 0)
    assert torch.equal(got, u) and got.data_ptr() != u.data_ptr()
    T6.advance_n_plain(u, tab, 3)
    assert torch.equal(u, u_copy)


def test_tables_pack_the_lo_faces():
    cfg = TA.config_template().create().update({"depth": 3,
                                                "block_size": 8})
    s = TA.new_solution(cfg, dtype=torch.float64)
    nt = TB.build_neighbor_table(s.leaves)
    dt = TA.time_step(s)
    tab = T6.guard_tables(nt, TA.block_spacings(s), dt)
    assert tab.faces.dtype == torch.int32
    for i, f in enumerate(T6.LO_FACES):
        assert np.array_equal(tab.faces[:, i, 0].numpy(), nt.case[:, f])
        assert np.array_equal(tab.faces[:, i, 4].numpy(), nt.fine_id[:, f, 0])
    # c = (0.5 dt, rounded to the dtype) / dx
    dx32 = TA.block_spacings(s).float()
    c32 = T6.guard_tables(nt, dx32, dt).c
    assert torch.equal(c32, torch.tensor(0.5 * dt, dtype=torch.float32)
                       / dx32)


@pytest.mark.parametrize("make,match", [
    (lambda u, t: (u[..., 0], t), "B, bs, bs, 1"),
    (lambda u, t: (u[:, :7, :7], t), "even block size"),
    (lambda u, t: (u[:-1], t), "guard tables of"),
    (lambda u, t: (u.float(), t), "courant factors in"),
])
def test_wrapper_rejects_what_the_kernel_does_not_take(make, match):
    u, tab = seeded(3, 8)
    for fn in (T6.advance_n_plain, T6.advance_n_cuda):
        with pytest.raises(ValueError, match=match):
            fn(*make(u, tab), 1)
    with pytest.raises(ValueError, match="n >= 0"):
        T6.advance_n_plain(u, tab, -1)
    with pytest.raises(ValueError, match="CUDA tensor"):
        T6.advance_n_cuda(u, tab, 1)


def test_dispatch_takes_the_plain_version_on_the_cpu():
    u, tab = seeded(3, 8, seed=1)
    before = T6.advance_n_cuda.launches
    assert torch.equal(T6.advance_n(u, tab, 4), T6.advance_n_plain(u, tab, 4))
    assert T6.advance_n_cuda.launches == before
    with pytest.raises(ValueError, match="no amrsand advance"):
        T6.advance_n(u.to("meta"), tab, 1)


# -----------------------------------------------------------------------------
# the kernel on the card
# -----------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernel B6 runs only on a CUDA card (no GPU here)")
    return torch.device("cuda")


def assert_f32_cells_close(u, u_ref, ulps):
    bar = ulps * np.finfo(np.float32).eps * np.abs(u_ref)
    worst = float((np.abs(u - u_ref) / np.maximum(bar, 1e-300)).max())
    assert np.all(np.abs(u - u_ref) <= bar), \
        f"{worst:.2f} x the bar of {ulps} ulps of the cell"


@pytest.mark.cuda
@pytest.mark.parametrize("depth,bs", [(3, 8), (7, 64)], ids=["d3b8", "d7b64"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernel_matches_plain(cuda_device, dtype, depth, bs):
    """A tree with all three face cases (d3b8) and the full width (d7b64),
    n in {0, 1, 3, 17}; the input is not written; one counted call per
    n > 0."""
    u, tab = seeded(depth, bs, dtype=dtype, device=cuda_device)
    u_copy = u.clone()
    for n in STEPS:
        before = T6.advance_n_cuda.launches
        got = T6.advance_n_cuda(u, tab, n)
        torch.cuda.synchronize()
        assert T6.advance_n_cuda.launches == before + (n > 0)
        want = T6.advance_n_plain(u, tab, n)
        assert got.shape == u.shape and got.dtype == dtype
        g, w = got.cpu().numpy(), want.cpu().numpy()
        assert np.isfinite(g).all()
        if dtype == torch.float64:
            np.testing.assert_allclose(g, w, **F64_TOL)
        else:
            assert_f32_cells_close(g, w, F32_ULPS)
    assert torch.equal(u, u_copy)


@pytest.mark.cuda
def test_amrsand_card_matches_the_cpu(cuda_device):
    """amrsand.advance_n on the card (B6) against the CPU's scheme,
    float64, 11 steps at depth 3, bs 16."""
    u, tab = seeded(3, 16, seed=3)
    cfg = TA.config_template().create().update({"depth": 3,
                                                "block_size": 16})
    s = TA.replace(TA.new_solution(cfg, dtype=torch.float64), conserved=u)
    nt = TB.build_neighbor_table(s.leaves)
    dxb, dt = TA.block_spacings(s), TA.time_step(s)
    got = TA.advance_n(u.to(cuda_device), dxb.to(cuda_device), nt, dt, 11)
    assert TA.LAST_PATH == "cuda_b6[11]"
    want = TA.advance_n(u, dxb, nt, dt, 11)
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), **F64_TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("depth,bs", [(3, 8), (4, 16), (3, 6), (7, 64)],
                         ids=["d3b8", "d4b16", "d3b6", "d7b64"])
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_each_design_matches_plain_bit_for_bit(cuda_device, dtype, depth,
                                               bs):
    """The resident design (where its plan fits: bs a power of two) and
    the launch-a-step design, n in {1, 3, 17}, each bit for bit the plain
    version's; the design None picks is the plan's, and two calls give
    the same bits."""
    u, tab = seeded(depth, bs, seed=depth + bs, dtype=dtype,
                    device=cuda_device)
    plan, _ = T6.plan_for(u)
    assert (plan is not None) == (bs & (bs - 1) == 0)
    designs = ["per_step"] + (["resident"] if plan is not None else [])
    for n in (1, 3, 17):
        want = T6.advance_n_plain(u, tab, n)
        for design in designs:
            got = T6.advance_n_cuda(u, tab, n, design=design)
            torch.cuda.synchronize()
            assert torch.equal(got, want), (design, n)
        T6.advance_n_cuda(u, tab, n)
        assert T6.advance_n_cuda.design == designs[-1]
        again = T6.advance_n_cuda(u, tab, n)
        assert torch.equal(again, want)
    if plan is None:
        with pytest.raises(ValueError, match="do not fit"):
            T6.advance_n_cuda(u, tab, 1, design="resident")


@pytest.mark.cuda
def test_large_blocks_take_the_launch_a_step_design(cuda_device):
    """Depth 7 with blocks of 128 (652 blocks, 42.7 MB in float32) does not
    fit in the card's shared memory; its 3 steps through the launch-a-step
    design are the plain version's bits."""
    u, tab = seeded(7, 128, seed=7, dtype=torch.float32, device=cuda_device)
    plan, _ = T6.plan_for(u)
    assert plan is None
    got = T6.advance_n_cuda(u, tab, 3)
    assert T6.advance_n_cuda.design == "per_step"
    assert torch.equal(got, T6.advance_n_plain(u, tab, 3))
    with pytest.raises(ValueError, match="do not fit"):
        T6.advance_n_cuda(u, tab, 1, design="resident")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_kernels_fit_and_are_co_resident(cuda_device, dtype):
    """At depth 7, block 64 the resident kernel's plan fits, and the
    occupancy calculator puts a CTA on every SM at the plan's shared
    memory; the launch-a-step kernel fits too."""
    u, _ = seeded(7, 64, dtype=dtype, device=cuda_device)
    plan, _ = T6.plan_for(u)
    assert plan is not None and plan.ctas == min(
        u.shape[0], torch.cuda.get_device_properties(0).multi_processor_count)
    info = T6.kernel_info(dtype, "resident", plan.nb_max, 64)
    assert info["dynamic_smem"] == plan.smem
    assert info["ctas_per_sm"] >= 1
    assert T6.kernel_info(dtype, "per_step")["ctas_per_sm"] >= 1
