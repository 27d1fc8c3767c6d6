"""Kernels B11a and B11b (mara3_tpu_torch/csrc/binary_update.cu) and B11c
(csrc/binary_advance_strips.cu) against their plain PyTorch versions
(kernels/binary_update.fused_fluxes_plain, fused_update_plain;
kernels/binary_advance.advance_core_strips_plain), and the variants of
schemes/binary_scheme.make_advance on the card against the same variants on
the CPU.

This file imports only the port, so it also runs where jax is not
installed. The tests marked `cuda` build and launch the kernels and skip
themselves without a GPU; on a card run them with

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_binary_variants_kernel.py

Bars. float64: the CPU parity bars of tests/test_torch_binary_variants.py
(state rtol 1e-12, atol 1e-20, and every cell within 1e-14 of its largest
component; totals rtol 1e-10, atol 1e-17). float32: every element within
64 ulps of its cell's largest component (the kernels round each operation
as the plain versions do, --fmad=false, but their sqrt, exp, pow and tanh
may differ by an ulp), totals rtol 1e-4 (summed in float64 by the kernels,
in float32 by the plain versions)."""

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import binary_advance as TK
from mara3_tpu_torch.kernels import binary_update as TU
from mara3_tpu_torch.mesh import block_layout as TBL
from mara3_tpu_torch.schemes import binary_scheme as TS
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

U_TOL = dict(rtol=1e-12, atol=1e-20)
CELL_TOL = 1e-14
TOTAL_TOL = {torch.float64: dict(rtol=1e-10, atol=1e-17),
             torch.float32: dict(rtol=1e-4, atol=1e-12)}
F32_ULPS = 64
F32_ATOL = 1e-20

SPLIT = [{"conserve_linear_p": cp, "reconstruct_method": rm}
         for cp in (1, 0) for rm in ("plm", "pcm")]
STRIPS = [{**o, "riemann": rs} for o in SPLIT for rs in ("hlle", "hllc")]
ident = lambda o: "-".join(f"{k}={v}" for k, v in o.items())
DTYPES = [torch.float64, torch.float32]
dtype_id = lambda d: str(d)[6:]


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("kernels B11a-c run only on a CUDA card (no GPU here)")
    return torch.device("cuda")


def make_case(over, device, dtype, seed=0, bs=8):
    """(solver data, perturbed state, bodies, dt) from a seed, depth 3
    (same, coarse and fine faces)."""
    base = {"depth": 3, "block_size": bs, "density_floor": 1e-3}
    cfg = TB.create_config_template().create().update({**base, **over})
    sd = TB.create_solver_data(cfg, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    noise = 1.0 + 0.05 * rng.uniform(-1.0, 1.0,
                                     tuple(sd.initial_conserved.shape))
    u0 = sd.initial_conserved * torch.as_tensor(noise, dtype=dtype,
                                                device=device)
    bodies = TB.bodies_array(TB.two_body.compute_two_body_state(
        TB.two_body.make_full_orbital_elements(TB.create_binary_params(cfg)),
        0.7))
    return sd, u0.contiguous(), bodies, sd.recommended_time_step


def assert_state_close(u, u_ref):
    """float64 at the CPU bars, float32 at 64 ulps of each cell."""
    dtype = u.dtype
    u = u.double().cpu().numpy()
    u_ref = u_ref.double().cpu().numpy()
    cell = np.abs(u_ref).max(axis=-1, keepdims=True)
    if dtype == torch.float64:
        np.testing.assert_allclose(u, u_ref, **U_TOL)
        assert np.all(np.abs(u - u_ref) <= CELL_TOL * cell)
    else:
        bar = F32_ULPS * np.finfo(np.float32).eps * cell + F32_ATOL
        worst = float((np.abs(u - u_ref) / bar).max())
        assert np.all(np.abs(u - u_ref) <= bar), f"{worst:.2f} x the bar"


def assert_totals_close(totals, totals_ref, dtype):
    assert set(totals) == set(totals_ref)
    for k in totals_ref:
        np.testing.assert_allclose(totals[k].double().cpu().numpy(),
                                   totals_ref[k].double().cpu().numpy(),
                                   **TOTAL_TOL[dtype], err_msg=k)


# -----------------------------------------------------------------------------
# the wrappers' contract, checked on the CPU
# -----------------------------------------------------------------------------

def test_launch_params_carry_each_kernels_boundary_tolerance():
    """B11a zeroes Lz within 1e-8 R of the domain radius; B11c (as B2)
    within isclose's 1e-8 + 1e-5 R; both travel in slot 23."""
    sd, _, bodies, dt = make_case({}, "cpu", torch.float64)
    cfg = sd.cfg_scheme
    params, _, dyn = TK.launch_params(
        cfg, bodies, dt, 0.0, "cpu",
        TU.split_boundary_tolerance(cfg.domain_radius))
    assert params[23] == 1e-8 * cfg.domain_radius and dyn is None
    params, _, _ = TK.launch_params(cfg, bodies, dt, 1.8, "cpu")
    assert params[23] == TS.boundary_tolerance(cfg.domain_radius)
    assert params[0] == dt and params[1] == 1.8


def test_blockgeo_rebuilds_the_cell_centers():
    """(x0, y0, dx) with x0 + (i + 1/2) dx gives the geometry's cell
    centers to round-off (B11c's positions; ROADMAP.md §C)."""
    sd, _, _, _ = make_case({}, "cpu", torch.float64)
    geo = sd.advance.tables.blockgeo.numpy()
    xc = sd.geometry[0]
    bs = xc.shape[1]
    i = np.arange(bs)
    x = geo[:, 0, None] + (i + 0.5) * geo[:, 2, None]
    y = geo[:, 1, None] + (i + 0.5) * geo[:, 2, None]
    np.testing.assert_allclose(x, xc[:, :, 0, 0], rtol=0, atol=1e-14)
    np.testing.assert_allclose(y, xc[:, 0, :, 1], rtol=0, atol=1e-14)


# -----------------------------------------------------------------------------
# the kernels on the card
# -----------------------------------------------------------------------------

@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=dtype_id)
@pytest.mark.parametrize("over", SPLIT, ids=ident)
def test_b11a_and_b11b_match_plain(cuda_device, over, dtype):
    sd, u0, bodies, dt = make_case(over, cuda_device, dtype)
    t = sd.advance.tables
    cfg = sd.cfg_scheme
    p0, *ext = TS.split_front(t, u0, sd.plm_theta)
    before = (TU.fused_fluxes_cuda.launches, TU.fused_update_cuda.launches)
    fluxes = []
    for axis, args in enumerate(ext):
        xf = t.xf if axis == 0 else t.yf
        got = TU.fused_fluxes_cuda(*args, xf, t.spacing, bodies, axis, cfg)
        torch.cuda.synchronize()
        assert_state_close(got, TU.fused_fluxes_plain(
            *args, xf, t.spacing, bodies, axis, cfg))
        fluxes.append(got)
    args = (u0, p0, *fluxes, t.xc, t.buffer_rate, t.initial_conserved, t.dA,
            dt, bodies, cfg)
    got = TU.fused_update_cuda(*args)
    torch.cuda.synchronize()
    want = TU.fused_update_plain(*args)
    assert_state_close(got[0], want[0])
    assert_totals_close(got[1], want[1], dtype)
    assert bool(got[2]) == bool(want[2])
    assert (TU.fused_fluxes_cuda.launches,
            TU.fused_update_cuda.launches) == (before[0] + 2, before[1] + 1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", DTYPES, ids=dtype_id)
@pytest.mark.parametrize("over", STRIPS, ids=ident)
def test_b11c_matches_plain(cuda_device, over, dtype):
    sd, u0, bodies, dt = make_case(over, cuda_device, dtype)
    t = sd.advance.tables
    cfg = sd.cfg_scheme
    consts = TBL.build_soa_guard(sd.nt, cfg.block_size)
    p0, strips, theta = TS.strips_front(t, sd.nt, consts, u0, sd.plm_theta)
    args = (u0, p0, strips, t.blockgeo, t.initial_conserved, t.spacing, dt,
            bodies, theta, cfg)
    before = TK.advance_core_strips_cuda.launches
    got = TK.advance_core_strips_cuda(*args)
    torch.cuda.synchronize()
    assert TK.advance_core_strips_cuda.launches == before + 1
    want = TK.advance_core_strips_plain(*args)
    assert_state_close(got[0], want[0])
    for g, w in zip(got[1], want[1]):
        assert_state_close(g, w)
    assert_totals_close(got[2], want[2], dtype)


@pytest.mark.cuda
@pytest.mark.parametrize("fused,over", [
    ("split", {"conserve_linear_p": 0}),
    ("jnp_strips", {"conserve_linear_p": 0, "riemann": "hllc"}),
    ("jnp_strips", {"conserve_linear_p": 1})],
    ids=["split", "jnp_strips-hllc", "jnp_strips-u"])
def test_variant_on_the_card_matches_the_cpu(cuda_device, fused, over):
    """make_advance(fused=...) on the card (the kernels) against the same
    variant on the CPU (their plain versions), float64, block 16, with the
    bodies and dt as host numbers and as device tensors."""
    results = []
    for device in (cuda_device, torch.device("cpu")):
        sd, u0, bodies, dt = make_case(over, device, torch.float64, bs=16)
        adv = TS.make_advance(sd.cfg_scheme, sd.nt, sd.geometry,
                              sd.initial_conserved, sd.buffer_rate,
                              device=device, dtype=torch.float64,
                              fused=fused)
        results.append(adv(u0, bodies, dt, sd.plm_theta))
        if device.type == "cuda":
            dev = adv(u0, torch.as_tensor(bodies, device=device),
                      torch.tensor(dt, dtype=torch.float64, device=device),
                      sd.plm_theta)
            assert torch.equal(dev[0], results[0][0])
    (u, tot, inv), (u_ref, tot_ref, inv_ref) = results
    assert_state_close(u, u_ref)
    assert_totals_close(tot, tot_ref, torch.float64)
    assert bool(inv) == bool(inv_ref)
