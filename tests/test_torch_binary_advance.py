"""The port's flagship advance (mara3_tpu_torch/kernels/binary_advance.py)
against the JAX package's reference-semantics advance
(schemes/binary_scheme.make_advance(fused=False), which
tests/test_pallas_kernel.py pins to the interpret-mode Pallas kernel B2).

The plain-torch path runs here on the CPU in float64. Kernel B2 runs only
on a CUDA card: tests/test_torch_binary_kernel.py holds it to this plain
path there, at the same bars."""

import numpy as np
import pytest
import torch

from mara3_tpu.models import two_body as jtwo_body
from mara3_tpu.subprograms import binary as JB
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

# u1: rtol 1e-12, atol 1e-20; totals: rtol 1e-10, atol 1e-17 — the bars of
# tests/test_pallas_kernel.py::test_chunked_advance_matches_jnp (the same
# arithmetic in another order; the totals are sums over all cells)
U_TOL = dict(rtol=1e-12, atol=1e-20)
TOTAL_TOL = dict(rtol=1e-10, atol=1e-17)

MATRIX = [
    {"conserve_linear_p": cp, "riemann": rs, "reconstruct_method": rm}
    for cp in (1, 0) for rs in ("hlle", "hllc") for rm in ("plm", "pcm")]
# the remaining options kernel B2 covers: axisymmetric cs2, constant-nu
# viscosity with an inner cutoff
VARIANTS = [
    {"conserve_linear_p": 0, "axisymmetric_cs2": 1, "nu": 1e-3,
     "alpha_cutoff_radius": 0.5},
    {"conserve_linear_p": 1, "axisymmetric_cs2": 1, "riemann": "hllc",
     "alpha_cutoff_radius": 0.5},
]


def make_pair(over, depth=3):
    """The same config in both packages (the port on the CPU in f64)."""
    base = {"depth": depth, "block_size": 8, "density_floor": 1e-3}
    jcfg = JB.create_config_template().create().update({**base, **over})
    tcfg = TB.create_config_template().create().update({**base, **over})
    jsd = JB.create_solver_data(jcfg)
    tsd = TB.create_solver_data(tcfg, device="cpu", dtype=torch.float64)
    return jcfg, jsd, tsd


def seeded_inputs(jsd, seed=0, t=0.7):
    """A perturbed disk state and the bodies at time t, from a seed."""
    rng = np.random.default_rng(seed)
    u0 = np.asarray(jsd.initial_conserved)
    u0 = u0 * (1.0 + 0.05 * rng.uniform(-1.0, 1.0, u0.shape))
    state = jtwo_body.compute_two_body_state(
        jtwo_body.make_full_orbital_elements(jtwo_body.OrbitalElements()), t)
    bodies = np.array(JB._bodies_array(state))
    return u0, bodies


def assert_advance_close(got, want):
    u1, totals, invalid = got
    u1_ref, totals_ref, invalid_ref = want
    np.testing.assert_allclose(np.asarray(u1), np.asarray(u1_ref), **U_TOL)
    assert set(totals) == set(totals_ref)
    for k in totals_ref:
        np.testing.assert_allclose(np.asarray(totals[k]),
                                   np.asarray(totals_ref[k]), **TOTAL_TOL,
                                   err_msg=k)
    assert bool(invalid) == bool(invalid_ref)


@pytest.mark.parametrize("over", MATRIX + VARIANTS,
                         ids=lambda o: "-".join(f"{k}={v}"
                                                for k, v in o.items()))
def test_plain_advance_matches_jax(over):
    """depth 3 has same, coarse and fine faces, so both guard cases and
    the coarse-fine flux correction are exercised."""
    _, jsd, tsd = make_pair(over)
    assert {0, 1, 2} <= set(np.unique(tsd.nt.case))
    u0, bodies = seeded_inputs(jsd)
    dt = jsd.recommended_time_step
    want = jsd.advance(u0, bodies, dt, jsd.plm_theta)
    got = tsd.advance(torch.as_tensor(u0), bodies, dt, tsd.plm_theta)
    assert_advance_close(got, want)


def test_safe_mode_theta_zero_matches_jax():
    """The safe-mode retry passes theta = 0 (first order) at run time."""
    _, jsd, tsd = make_pair({})
    u0, bodies = seeded_inputs(jsd, seed=1)
    dt = jsd.recommended_time_step
    assert_advance_close(
        tsd.advance(torch.as_tensor(u0), bodies, dt, 0.0),
        jsd.advance(u0, bodies, dt, 0.0))


def test_fault_flag_matches_jax():
    """dt x 1e4 evacuates cells near the sinks: both packages raise the
    fault flag (the case of test_chunked_advance_fault_flag)."""
    _, jsd, tsd = make_pair({"density_floor": 0.0}, depth=2)
    u0 = np.array(jsd.initial_conserved)
    bodies = np.array(JB._bodies_array(jtwo_body.compute_two_body_state(
        jtwo_body.make_full_orbital_elements(jtwo_body.OrbitalElements()),
        0.0)))
    dt = jsd.recommended_time_step * 1e4
    _, _, inv_ref = jsd.advance(u0, bodies, dt, jsd.plm_theta)
    _, _, inv = tsd.advance(torch.as_tensor(u0), bodies, dt, tsd.plm_theta)
    assert bool(inv_ref) and bool(inv)
