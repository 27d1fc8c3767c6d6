"""The port's advance variants (schemes/binary_scheme.make_advance with
fused="split" and fused="jnp_strips") against the JAX package's same
variants, whose Pallas kernels B11a-c run in interpret mode, as
tests/test_pallas_kernel.py runs them; and the plain versions of B11a, B11b
(kernels/binary_update.py) and B11c (kernels/binary_advance.py) against the
JAX kernels on the same inputs; and the SoA guard helpers of
mesh/block_layout.py against the JAX package's, bit for bit.

float64 on the CPU, depth 3 (every face case: same, coarse and fine
neighbors) at block 8, and block 16 for a case of each variant.

Bars. Each plain version copies its TPU kernel's arithmetic, but XLA may
fuse a product and a sum into one rounding where torch rounds twice, so the
two differ at round-off:
  - the state: every element at rtol 1e-12, atol 1e-20, the bar of
    tests/test_pallas_kernel.py, and every cell within 1e-14 of its largest
    component (f64 round-off; measured at most 4.3e-16). An element's own
    relative error can reach 1e-10 where a momentum component cancels;
  - the totals: rtol 1e-10, atol 1e-17, test_pallas_kernel.py's bar (sums
    over all cells in another order; measured at most 4.3e-13);
  - the fault flag: equal."""

import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from mara3_tpu.kernels import binary_advance as JBA
from mara3_tpu.kernels import binary_update as JBU
from mara3_tpu.mesh import block_layout as JBL
from mara3_tpu.models import two_body as jtwo_body
from mara3_tpu.schemes import binary_scheme as JS
from mara3_tpu.subprograms import binary as JB
from mara3_tpu_torch.kernels import binary_advance as TK
from mara3_tpu_torch.kernels import binary_update as TU
from mara3_tpu_torch.mesh import block_layout as TBL
from mara3_tpu_torch.schemes import binary_scheme as TS
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

F64 = torch.float64
U_TOL = dict(rtol=1e-12, atol=1e-20)
CELL_TOL = 1e-14
TOTAL_TOL = dict(rtol=1e-10, atol=1e-17)

SPLIT = [{"conserve_linear_p": cp, "reconstruct_method": rm}
         for cp in (1, 0) for rm in ("plm", "pcm")]
STRIPS = [{**o, "riemann": rs} for o in SPLIT for rs in ("hlle", "hllc")]
ident = lambda o: "-".join(f"{k}={v}" for k, v in o.items())


def make_pair(over, bs=8):
    """The same config in both packages (the port on the CPU in f64)."""
    base = {"depth": 3, "block_size": bs, "density_floor": 1e-3}
    jcfg = JB.create_config_template().create().update({**base, **over})
    tcfg = TB.create_config_template().create().update({**base, **over})
    return JB.create_solver_data(jcfg), TB.create_solver_data(
        tcfg, device="cpu", dtype=F64)


def seeded_inputs(jsd, seed=0, t=0.7):
    """A perturbed disk state and the bodies at time t, from a seed."""
    rng = np.random.default_rng(seed)
    u0 = np.asarray(jsd.initial_conserved)
    u0 = u0 * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, u0.shape))
    state = jtwo_body.compute_two_body_state(
        jtwo_body.make_full_orbital_elements(jtwo_body.OrbitalElements()), t)
    return u0, np.array(JB._bodies_array(state))


def assert_state_close(u, u_ref):
    u, u_ref = np.asarray(u), np.asarray(u_ref)
    np.testing.assert_allclose(u, u_ref, **U_TOL)
    cell = np.abs(u_ref).max(axis=-1, keepdims=True)
    worst = float((np.abs(u - u_ref) / np.maximum(cell, 1e-300)).max())
    assert np.all(np.abs(u - u_ref) <= CELL_TOL * cell), worst


def assert_totals_close(totals, totals_ref):
    assert set(totals) == set(totals_ref)
    for k in totals_ref:
        np.testing.assert_allclose(np.asarray(totals[k]),
                                   np.asarray(totals_ref[k]), **TOTAL_TOL,
                                   err_msg=k)


def variant_pair(fused, over, bs=8):
    """(port result, JAX result) of one advance of the variant `fused`."""
    jsd, tsd = make_pair(over, bs)
    u0, bodies = seeded_inputs(jsd)
    dt = jsd.recommended_time_step
    with pltpu.force_tpu_interpret_mode():
        jadv = JS.make_advance(jsd.cfg_scheme, jsd.nt, jsd.geometry,
                               jsd.initial_conserved, jsd.buffer_rate,
                               fused=fused)
        want = jadv(u0, bodies, dt, jsd.plm_theta)
    tadv = TS.make_advance(tsd.cfg_scheme, tsd.nt, tsd.geometry,
                           tsd.initial_conserved, tsd.buffer_rate,
                           device="cpu", dtype=F64, fused=fused)
    got = tadv(torch.as_tensor(u0), bodies, dt, tsd.plm_theta)
    return got, want


def assert_advance_close(got, want):
    assert_state_close(got[0], want[0])
    assert_totals_close(got[1], want[1])
    assert bool(got[2]) == bool(want[2])


@pytest.mark.parametrize("over", SPLIT, ids=ident)
def test_split_matches_jax(over):
    """fused="split": B11a's plain version for each axis, the coarse-fine
    correction and B11b's plain version against the JAX split."""
    assert_advance_close(*variant_pair("split", over))


@pytest.mark.parametrize("over", STRIPS, ids=ident)
def test_jnp_strips_matches_jax(over):
    """fused="jnp_strips": the torch front, B11c's plain version and the
    edge fixup against the JAX jnp_strips advance, HLLE and HLLC."""
    assert_advance_close(*variant_pair("jnp_strips", over))


@pytest.mark.parametrize("fused,over", [
    ("split", {"conserve_linear_p": 0}),
    ("jnp_strips", {"conserve_linear_p": 0, "riemann": "hllc"})],
    ids=["split", "jnp_strips-hllc"])
def test_variants_match_jax_at_block_16(fused, over):
    assert_advance_close(*variant_pair(fused, over, bs=16))


def test_split_with_hllc_raises_as_in_jax():
    jsd, tsd = make_pair({"riemann": "hllc"})
    with pytest.raises(NotImplementedError, match="hlle only"):
        JS.make_advance(jsd.cfg_scheme, jsd.nt, jsd.geometry,
                        jsd.initial_conserved, jsd.buffer_rate,
                        fused="split")
    with pytest.raises(NotImplementedError, match="hlle only"):
        TS.make_advance(tsd.cfg_scheme, tsd.nt, tsd.geometry,
                        tsd.initial_conserved, tsd.buffer_rate,
                        device="cpu", dtype=F64, fused="split")


def test_every_fused_value_and_no_other():
    """None and True are kernel B2 on a card and its plain version, the
    reference-semantics advance, on the CPU: here all three of None, True
    and False give the same bits. An unknown value raises."""
    _, tsd = make_pair({"conserve_linear_p": 0})
    u0 = tsd.initial_conserved
    bodies = TB.bodies_array(TB.two_body.compute_two_body_state(
        TB.two_body.make_full_orbital_elements(
            TB.two_body.OrbitalElements()), 0.3))
    make = lambda fused: TS.make_advance(
        tsd.cfg_scheme, tsd.nt, tsd.geometry, tsd.initial_conserved,
        tsd.buffer_rate, device="cpu", dtype=F64, fused=fused)
    dt = tsd.recommended_time_step
    ref = make(False)(u0, bodies, dt, tsd.plm_theta)
    for fused in (None, True):
        got = make(fused)(u0, bodies, dt, tsd.plm_theta)
        assert torch.equal(got[0], ref[0])
        assert all(torch.equal(got[1][k], ref[1][k]) for k in ref[1])
    for fused in ("split", "jnp_strips"):
        assert make(fused).tables is not None
    with pytest.raises(ValueError, match="fused="):
        make("pallas")


# -----------------------------------------------------------------------------
# the SoA guard helpers
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("bs", [8, 16])
def test_soa_guard_strips_are_bit_equal_to_jax(bs):
    """guard_strips_soa on every axis, and guard_strips_from_edges on an
    edge tensor of its own, equal the JAX package's bit for bit: the
    one-hot products become gathers with the same two-term sums."""
    jsd, tsd = make_pair({}, bs)
    assert {0, 1, 2} <= set(np.unique(tsd.nt.case))
    rng = np.random.default_rng(3)
    B = len(tsd.leaves)
    UT = rng.normal(size=(B, 6, bs, bs))
    jconsts = JBL.build_soa_guard(jsd.nt, bs)
    tconsts = TBL.build_soa_guard(tsd.nt, bs)
    for axis in (0, 1):
        want = JBL.guard_strips_soa(UT, jsd.nt, jconsts, axis)
        got = TBL.guard_strips_soa(torch.as_tensor(UT), tsd.nt, tconsts,
                                   axis)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))
        E = rng.normal(size=(B, 3, 4, bs))
        want = JBL.guard_strips_from_edges(E, jsd.nt, jconsts, axis)
        got = TBL.guard_strips_from_edges(torch.as_tensor(E), tsd.nt,
                                          tconsts, axis)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_soa_guard_strips_of_a_permuted_view():
    """The port's jnp_strips front passes a permuted view of its
    component-last primitives; the strips are those of the copy."""
    _, tsd = make_pair({})
    consts = TBL.build_soa_guard(tsd.nt, 8)
    p = torch.as_tensor(np.random.default_rng(4).normal(
        size=(len(tsd.leaves), 8, 8, 3)))
    for axis in (0, 1):
        a = TBL.guard_strips_soa(p.permute(0, 3, 1, 2), tsd.nt, consts, axis)
        b = TBL.guard_strips_soa(p.permute(0, 3, 1, 2).contiguous(), tsd.nt,
                                 consts, axis)
        assert all(torch.equal(x, y) for x, y in zip(a, b))


# -----------------------------------------------------------------------------
# the kernels' plain versions against the JAX kernels, on the same inputs
# -----------------------------------------------------------------------------

def scheme_tuples(cfg):
    """The JAX kernels' static tuples (binary_scheme.py:393-398, :522)."""
    cfg_tuple = (cfg.softening_radius, cfg.sink_radius, cfg.sink_rate,
                 cfg.mach_number, cfg.axisymmetric_cs2, cfg.conserve_linear_p,
                 cfg.density_floor, cfg.gst_suppr_radius ** 2)
    cfg_flux = (cfg.softening_radius, cfg.mach_number, cfg.axisymmetric_cs2,
                cfg.conserve_linear_p, cfg.alpha, cfg.alpha_cutoff_radius,
                cfg.nu, cfg.domain_radius, cfg.riemann)
    return cfg_tuple, cfg_flux, (cfg.buffer_damping_rate, cfg.domain_radius)


def seeded_case(over, seed=0):
    """(solver data, perturbed state, bodies, dt) of the port, from a
    seed."""
    _, tsd = make_pair(over)
    rng = np.random.default_rng(seed)
    u0 = tsd.initial_conserved * torch.as_tensor(
        1.0 + 0.05 * rng.uniform(-1, 1, tuple(tsd.initial_conserved.shape)))
    bodies = TB.bodies_array(TB.two_body.compute_two_body_state(
        TB.two_body.make_full_orbital_elements(
            TB.two_body.OrbitalElements()), 0.7))
    return tsd, u0, bodies, tsd.recommended_time_step


@pytest.mark.parametrize("cp", [1, 0])
def test_b11a_and_b11b_plain_match_the_jax_kernels(cp):
    """fused_fluxes_plain on each axis and fused_update_plain against the
    JAX fused_fluxes and fused_update in interpret mode, on the split
    front's inputs."""
    tsd, u0, bodies, dt = seeded_case({"conserve_linear_p": cp})
    t = tsd.advance.tables
    cfg = tsd.cfg_scheme
    cfg_tuple, cfg_flux, _ = scheme_tuples(cfg)
    p0, *ext = TS.split_front(t, u0, tsd.plm_theta)
    fluxes = []
    for axis, (p_ex, g_lon, g_tra) in enumerate(ext):
        xf = t.xf if axis == 0 else t.yf
        got = TU.fused_fluxes_plain(p_ex, g_lon, g_tra, xf, t.spacing,
                                    bodies, axis, cfg)
        want = JBU.fused_fluxes(p_ex.numpy(), g_lon.numpy(), g_tra.numpy(),
                                xf.numpy(), t.spacing.numpy(), bodies, axis,
                                cfg_flux[:8], interpret=True)
        assert_state_close(got, want)
        fluxes.append(got)
    got = TU.fused_update_plain(u0, p0, *fluxes, t.xc, t.buffer_rate,
                                t.initial_conserved, t.dA, dt, bodies, cfg)
    want = JBU.fused_update(*(a.numpy() for a in (u0, p0, *fluxes, t.xc,
                                                  t.buffer_rate,
                                                  t.initial_conserved,
                                                  t.dA)),
                            dt, bodies, cfg_tuple, interpret=True)
    assert_advance_close(got, want)


@pytest.mark.parametrize("over", [
    {"conserve_linear_p": 1, "riemann": "hlle"},
    {"conserve_linear_p": 0, "riemann": "hllc"}], ids=ident)
def test_b11c_plain_matches_the_jax_kernel(over):
    """advance_core_strips_plain against the JAX fused_advance_core in
    interpret mode on the jnp_strips front's strips: the update before the
    edge fixup, the four edge fluxes and the totals."""
    tsd, u0, bodies, dt = seeded_case(over, seed=1)
    t = tsd.advance.tables
    cfg = tsd.cfg_scheme
    B = u0.shape[0]
    consts = TBL.build_soa_guard(tsd.nt, cfg.block_size)
    p0, strips, theta = TS.strips_front(t, tsd.nt, consts, u0,
                                        tsd.plm_theta)
    got = TK.advance_core_strips_plain(u0, p0, strips, t.blockgeo,
                                       t.initial_conserved, t.spacing, dt,
                                       bodies, theta, cfg)
    cfg_tuple, cfg_flux, buffer_cfg = scheme_tuples(cfg)
    T = lambda a: np.ascontiguousarray(np.transpose(a.numpy(), (0, 3, 1, 2)))
    want = JBA.fused_advance_core(
        T(u0), T(p0), np.ascontiguousarray(np.transpose(strips.numpy(),
                                                        (0, 1, 3, 2))),
        t.blockgeo.numpy().reshape(B, 1, 3), T(t.initial_conserved),
        t.spacing.numpy().reshape(B, 1, 1), np.ones((B, 1, 1)), dt, bodies,
        theta, B, cfg_tuple, cfg_flux, buffer_cfg, interpret=True)
    u1T, fxlo, fxhi, fylo, fyhi, tt = (np.asarray(a) for a in want)
    assert_state_close(got[0], np.transpose(u1T, (0, 2, 3, 1)))
    for g, w in zip(got[1], (fxlo, fxhi, fylo, fyhi)):
        assert_state_close(g, np.transpose(w, (0, 2, 1)))
    want_totals = {k: tt[r, :2] for r, k in enumerate(TU.UPDATE_TOTALS)}
    want_totals["mass_ejected"] = tt[7, 0]
    want_totals["angular_momentum_ejected"] = tt[8, 0]
    assert_totals_close(got[2], want_totals)


# -----------------------------------------------------------------------------
# the dispatchers
# -----------------------------------------------------------------------------

def test_wrappers_dispatch_by_device():
    """On CPU tensors the dispatchers run the plain versions and count no
    launch; the kernels' wrappers refuse CPU tensors."""
    tsd, u0, bodies, dt = seeded_case({})
    t = tsd.advance.tables
    cfg = tsd.cfg_scheme
    before = (TU.fused_fluxes_cuda.launches, TU.fused_update_cuda.launches,
              TK.advance_core_strips_cuda.launches)
    p0, x, y = TS.split_front(t, u0, tsd.plm_theta)
    fx = TU.fused_fluxes(*x, t.xf, t.spacing, bodies, 0, cfg)
    assert torch.equal(fx, TU.fused_fluxes_plain(*x, t.xf, t.spacing, bodies,
                                                 0, cfg))
    fy = TU.fused_fluxes(*y, t.yf, t.spacing, bodies, 1, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        TU.fused_fluxes_cuda(*x, t.xf, t.spacing, bodies, 0, cfg)
    with pytest.raises(ValueError, match="CUDA"):
        TU.fused_update_cuda(u0, p0, fx, fy, t.xc, t.buffer_rate,
                             t.initial_conserved, t.dA, dt, bodies, cfg)
    strips = torch.zeros(u0.shape[0], 4, 8, 9, dtype=F64)
    with pytest.raises(ValueError, match="CUDA"):
        TK.advance_core_strips_cuda(u0, p0, strips, t.blockgeo,
                                    t.initial_conserved, t.spacing, dt,
                                    bodies, 1.8, cfg)
    assert (TU.fused_fluxes_cuda.launches, TU.fused_update_cuda.launches,
            TK.advance_core_strips_cuda.launches) == before
