"""Kernels B2 (mara3_tpu_torch/csrc/binary_advance.cu) and B3
(csrc/binary_multi.cu) against their plain PyTorch versions
(kernels/binary_advance.advance_plain, kernels/binary_multi.advance_k_plain).

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
from mara3_tpu_torch.kernels import binary_multi as TM
from mara3_tpu_torch.models import two_body_device as tbd
from mara3_tpu_torch.schemes import binary_step as TS
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

# the bars of the CPU parity tests (tests/test_torch_binary_advance.py)
U_TOL = dict(rtol=1e-12, atol=1e-20)
TOTAL_TOL = dict(rtol=1e-10, atol=1e-17)
# float32: the kernel rounds each operation as the plain version does
# (--fmad=false), but its sqrt/exp/pow may differ by an ulp and it sums the
# totals in another order, in float64. Each element is held to 64 ulps of
# its cell's largest component per advance (a cell's momenta may cross
# zero, its density may not), with an atol far below the disk's ambient
# density (about 1.5e-9): a bar per cell, as chip_smoke.py holds it, so the
# outer disk is held as tightly as the peak
F32_ULPS = 64
F32_ATOL = 1e-20

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


def assert_f32_cells_close(u, u_ref, ulps):
    """Every element within `ulps` float32 ulps of its cell's largest
    component (the last axis), plus F32_ATOL."""
    bar = ulps * np.finfo(np.float32).eps * np.abs(u_ref).max(
        axis=-1, keepdims=True)
    worst = float((np.abs(u - u_ref) / np.maximum(bar, 1e-300)).max())
    assert np.all(np.abs(u - u_ref) <= bar + F32_ATOL), \
        f"{worst:.2f} x the bar of {ulps} ulps of the cell"


def assert_close(got, want, u_tol=U_TOL, total_tol=TOTAL_TOL):
    u1, totals, invalid = to_host(got)
    u1_ref, totals_ref, invalid_ref = to_host(want)
    if u_tol is None:     # float32: the per-cell bar
        assert_f32_cells_close(u1, u1_ref, F32_ULPS)
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
        pytest.skip("kernels B2 and B3 run only on a CUDA card (no GPU here)")
    return torch.device("cuda")


def test_f32_cell_bar_catches_an_outer_disk_error():
    """The float32 bar is per cell: a 1e-3 relative error in one cell of the
    thin outer disk fails it, though it is far below the mesh's largest
    value."""
    sd, u0, _, _ = make_case({}, "cpu", torch.float32, depth=2)
    u = u0.numpy().astype(np.float64)
    assert_f32_cells_close(u, u, F32_ULPS)
    bad = u.copy()
    b, i, j = np.unravel_index(np.argmin(u[..., 0]), u.shape[:-1])
    bad[b, i, j, 0] *= 1.0 + 1e-3
    with pytest.raises(AssertionError):
        assert_f32_cells_close(bad, u, F32_ULPS)


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


# -----------------------------------------------------------------------------
# B2's device entry and kernel B3 on the card
# -----------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_b2_device_entry_is_bitwise_the_host_entry(cuda_device, dtype):
    """dt, theta and the bodies read from a device buffer give the very
    bits that the same values passed from the host give."""
    sd, u0, bodies, dt = make_case({"conserve_linear_p": 0}, cuda_device,
                                   dtype)
    t = sd.advance.tables
    host = TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
    dev = TK.advance_cuda(t, u0, torch.as_tensor(bodies, device=cuda_device),
                          torch.tensor(dt, dtype=dtype, device=cuda_device),
                          sd.plm_theta)
    assert torch.equal(host[0], dev[0])
    for k in host[1]:
        assert torch.equal(host[1][k], dev[1][k]), k
    assert bool(host[2]) == bool(dev[2])


def multi_case(over, device, dtype, rk, live, k=4, seed=0, bs=16):
    """(tables, state, elements, start time, launch config) of a seeded
    d3 case of an eccentric binary (the element rows of a near-circular
    one are ill-conditioned), live from t = 0 when `live`."""
    base = {"depth": 3, "block_size": bs, "rk_order": rk,
            "density_floor": 1e-3, "eccentricity": 0.3}
    if live:
        base["begin_live_binary"] = 0.0
    cfg = TB.create_config_template().create().update({**base, **over})
    sd = TB.create_solver_data(cfg, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    noise = 1.0 + 0.01 * rng.uniform(-1.0, 1.0,
                                     tuple(sd.initial_conserved.shape))
    u0 = (sd.initial_conserved
          * torch.as_tensor(noise, dtype=dtype, device=device)).contiguous()
    e10 = tbd.pack_elements(TB.create_solution(cfg, sd).orbital_elements,
                            dtype, device)
    t0 = torch.tensor(0.7, dtype=dtype, device=device)
    return sd.advance.tables, u0, e10, t0, TS.multi_config(sd, k)


def assert_multi_close(got, want, dtype, k):
    """B3 against its plain version: the state (float64 at the CPU bars,
    float32 at 64 k ulps of each cell), dt, the stage times and the fault
    flags, the totals, and the element rows."""
    (u, rows), (u_ref, rows_ref) = got, want
    u, u_ref = u.double().cpu().numpy(), u_ref.double().cpu().numpy()
    rows, rows_ref = rows.cpu().numpy(), rows_ref.cpu().numpy()
    f64 = dtype == torch.float64
    if f64:
        np.testing.assert_allclose(u, u_ref, **U_TOL)
    else:
        assert_f32_cells_close(u, u_ref, F32_ULPS * k)
    rtol = 1e-12 if f64 else 1e-5
    for r in (TM.ROW_DT, TM.ROW_TPREV):
        np.testing.assert_allclose(rows[:, r, 0], rows_ref[:, r, 0],
                                   rtol=rtol)
    np.testing.assert_array_equal(rows[:, TM.ROW_INVALID, 0],
                                  rows_ref[:, TM.ROW_INVALID, 0])
    np.testing.assert_allclose(
        rows[:, :9], rows_ref[:, :9],
        **(TOTAL_TOL if f64 else dict(rtol=1e-4, atol=1e-12)))
    np.testing.assert_allclose(rows[:, TM.ROW_DACC:], rows_ref[:, TM.ROW_DACC:],
                               **(dict(rtol=1e-6, atol=1e-9) if f64
                                  else dict(rtol=1e-3, atol=1e-5)))


B3_CASES = [(over, rk, live) for over in MATRIX
            for rk, live in ((1, False), (2, True))]
B3_IDS = [f"{i}-rk{rk}-{'live' if live else 'fixed'}"
          for i, (_, rk, live) in zip(IDS * 2, B3_CASES)]


@pytest.mark.cuda
@pytest.mark.parametrize("over,rk,live", B3_CASES, ids=B3_IDS)
def test_b3_matches_plain_f64(cuda_device, over, rk, live):
    """Four steps in one call against four plain steps, float64; depth 3
    has same, coarse and fine faces."""
    args = multi_case(over, cuda_device, torch.float64, rk, live)
    before = TM.advance_k_cuda.launches
    got = TM.advance_k_cuda(*args)
    torch.cuda.synchronize()
    assert TM.advance_k_cuda.launches == before + 1
    assert_multi_close(got, TM.advance_k_plain(*args), torch.float64, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("over,rk,live", B3_CASES[::2], ids=B3_IDS[::2])
def test_b3_matches_plain_f32(cuda_device, over, rk, live):
    args = multi_case(over, cuda_device, torch.float32, rk, live)
    assert_multi_close(TM.advance_k_cuda(*args),
                       TM.advance_k_plain(*args), torch.float32, 4)


@pytest.mark.cuda
def test_b3_fault_flag_and_dispatch(cuda_device):
    """An oversized fixed dt faults inside the launch, as in the plain
    version; advance_k launches the kernel for a CUDA tensor; the wrapper
    refuses a dtype it was not built for."""
    from dataclasses import replace
    t, u0, e10, t0, mc = multi_case({}, cuda_device, torch.float64, 1,
                                    False)
    mc = replace(mc, fixed_dt=50.0)
    _, rows = TM.advance_k_cuda(t, u0, e10, t0, mc)
    _, rows_ref = TM.advance_k_plain(t, u0, e10, t0, mc)
    assert rows[:, TM.ROW_INVALID, 0].any()
    assert torch.equal(rows[:, TM.ROW_INVALID, 0].cpu(),
                       rows_ref[:, TM.ROW_INVALID, 0].cpu())
    before = TM.advance_k_cuda.launches
    TM.advance_k(t, u0, e10, t0, mc)
    assert TM.advance_k_cuda.launches == before + 1
    with pytest.raises(TypeError):
        TM.advance_k_cuda(t, u0.float(), e10, t0, mc)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_b3_kernels_fit_on_the_card(cuda_device, dtype):
    """Every kernel of B3 has a CTA of its threads resident on an SM, sweep
    2 with its march's shared memory (a piece's box of p and g, its faces);
    the sweeps run at least two CTAs an SM, and sweep 2 one wave of them:
    the card's SMs times that, or one a piece."""
    info = TM.kernel_info(dtype)
    assert set(info) == set(TM.KERNELS)
    for name, k in info.items():
        assert k["ctas_per_sm"] >= 1 and k["registers"] >= 1, name
    assert info["b3_sweep1"]["ctas_per_sm"] >= 2
    assert info["b3_sweep2"]["ctas_per_sm"] >= 2
    R, size = TM.MARCH_ROWS, torch.tensor([], dtype=dtype).element_size()
    box_and_faces = (9 * (R + 2) * 34 + 3 * (R + 1) * 32 + 3 * R * 33) * size
    assert info["b3_sweep2"]["dynamic_smem"] >= box_and_faces
    assert info["b3_sweep2"]["threads"] == 256
    sms = torch.cuda.get_device_properties(cuda_device).multi_processor_count
    for bs in (16, 96):
        t = multi_case({}, cuda_device, dtype, 1, False, bs=bs)[0]
        plan, ctas = TM._device_plan(t)
        assert ctas == min(plan.pieces.shape[0],
                           sms * info["b3_sweep2"]["ctas_per_sm"])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_b3_gives_the_same_bits_twice(cuda_device, dtype):
    """No atomics: two calls on the same input give the same state and
    rows, bit for bit."""
    args = multi_case({"conserve_linear_p": 0}, cuda_device, dtype, 2, True)
    u1, rows1 = TM.advance_k_cuda(*args)
    u2, rows2 = TM.advance_k_cuda(*args)
    assert torch.equal(u1, u2)
    assert torch.equal(rows1, rows2)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("rk,live", [(1, False), (2, True)],
                         ids=["rk1-fixed", "rk2-live"])
def test_b3_block_size_the_tile_does_not_divide(cuda_device, rk, live,
                                                dtype):
    """Block 40 at depth 3: neither type's tile divides it (clipped tiles
    of 8 cells), and every face direction has coarser and finer
    neighbors."""
    args = multi_case({"conserve_linear_p": 0}, cuda_device, dtype, rk,
                      live, bs=40)
    cases = args[0].tab[:, :, 0].cpu()
    for f in range(4):
        assert set(cases[:, f].tolist()) == {0, 1, 2}
    assert_multi_close(TM.advance_k_cuda(*args), TM.advance_k_plain(*args),
                       dtype, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
def test_b3_power_of_two_spacing(cuda_device, dtype):
    """Block 24 at depth 3: every block's spacing is a power of two (as on
    the flagship's d6b96 mesh), so the sweeps multiply by its exact
    inverse where they divide by it elsewhere."""
    args = multi_case({}, cuda_device, dtype, 2, True, bs=24)
    spacing = args[0].spacing64.cpu().numpy()
    assert (np.frexp(spacing)[0] == 0.5).all()
    assert_multi_close(TM.advance_k_cuda(*args), TM.advance_k_plain(*args),
                       dtype, 4)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32])
@pytest.mark.parametrize("ctas", [1, 7])
def test_b3_share_starts_mid_block_across_a_level_jump(cuda_device, ctas,
                                                       dtype):
    """Sweep 2 with one CTA, which marches every piece in turn, and with 7,
    which share them as they claim them: block 40 at depth 3, where pieces
    start inside a block (rows 15 and 30), a full strip of 32 columns sits
    beside a clipped one of 8, and every face direction meets coarser and
    finer neighbours. The state is the card's own wave's bit for bit (rk 1,
    not live: the totals' order does not reach it; a piece's totals do not
    depend on which CTA computed it) and the rows are within the plain
    version's bars."""
    args = multi_case({"conserve_linear_p": 0}, cuda_device, dtype, 1,
                      False, bs=40)
    t = args[0]
    u_card, rows_card = TM.advance_k_cuda(*args)
    plan, _ = TM._device_plan(t)
    assert (plan.pieces[:, 1].cpu() % 32 != 0).any()
    try:
        TM._plans.clear()
        TM._plans.append((t, plan, ctas))
        got = TM.advance_k_cuda(*args)
    finally:
        TM._plans.clear()
    assert torch.equal(got[0], u_card)
    assert torch.equal(got[1], rows_card)
    assert_multi_close(got, TM.advance_k_plain(*args), dtype, 4)
