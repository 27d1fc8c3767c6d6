"""The port's modules under the flagship advance held to the JAX package's,
in float64 on the CPU: iso2d physics, PLM, the quadtree, the block layout
and its guard gather, and the two-body model. Inputs are made from a seed
with numpy and fed to both."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mara3_tpu.mathx import plm as jplm
from mara3_tpu.mesh import block_layout as jbl
from mara3_tpu.mesh import tree as jtree
from mara3_tpu.models import two_body as jtb
from mara3_tpu.physics import iso2d as jiso
from mara3_tpu.subprograms import binary as JB
from mara3_tpu_torch.mathx import plm as tplm
from mara3_tpu_torch.mesh import block_layout as tbl
from mara3_tpu_torch.mesh import tree as ttree
from mara3_tpu_torch.models import two_body as ttb
from mara3_tpu_torch.physics import iso2d as tiso
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

RTOL = 1e-13     # float64 round-off: the same formulas, evaluated by two
                 # compilers that may contract or reorder differently


def close(got, want, rtol=RTOL, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def prim(rng, n=64):
    """Primitive states [n, 3] with positive density, cs2 [n], and
    positions [n, 2] away from the origin."""
    P = np.stack([rng.uniform(0.1, 2.0, n), rng.normal(0.0, 1.0, n),
                  rng.normal(0.0, 1.0, n)], axis=-1)
    cs2 = rng.uniform(0.01, 0.5, n)
    x = rng.uniform(0.2, 3.0, (n, 2)) * rng.choice([-1.0, 1.0], (n, 2))
    return P, cs2, x


T = torch.as_tensor


# -----------------------------------------------------------------------------
# physics/iso2d.py and mathx/plm.py
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("name", [
    "to_conserved_per_area", "recover_primitive", "velocity_squared"])
def test_iso2d_pointwise_matches_jax(name):
    P, _, _ = prim(np.random.default_rng(0))
    close(getattr(tiso, name)(T(P)), getattr(jiso, name)(P))


@pytest.mark.parametrize("name", [
    "to_conserved_angmom_per_area", "recover_primitive_angmom",
    "to_conserved_per_area_from_angmom", "angular_momentum"])
def test_iso2d_positional_matches_jax(name):
    P, _, x = prim(np.random.default_rng(1))
    close(getattr(tiso, name)(T(P), T(x)), getattr(jiso, name)(P, x))


@pytest.mark.parametrize("name", [
    "source_terms_conserved_angmom", "max_wavespeed", "gas_pressure"])
def test_iso2d_with_cs2_matches_jax(name):
    P, cs2, _ = prim(np.random.default_rng(2))
    close(getattr(tiso, name)(T(P), T(cs2)), getattr(jiso, name)(P, cs2))


@pytest.mark.parametrize("nhat", [(1.0, 0.0), (0.0, 1.0)])
@pytest.mark.parametrize("name", ["flux", "wavespeeds"])
def test_iso2d_directional_matches_jax(name, nhat):
    P, cs2, _ = prim(np.random.default_rng(3))
    close(getattr(tiso, name)(T(P), nhat, T(cs2)),
          getattr(jiso, name)(P, nhat, cs2))


@pytest.mark.parametrize("nhat", [(1.0, 0.0), (0.0, 1.0)])
@pytest.mark.parametrize("solver", ["riemann_hlle", "riemann_hllc"])
def test_riemann_solvers_match_jax(solver, nhat):
    rng = np.random.default_rng(4)
    Pl, cs2l, _ = prim(rng, 256)
    Pr, cs2r, _ = prim(rng, 256)
    close(getattr(tiso, solver)(T(Pl), T(Pr), T(cs2l), T(cs2r), nhat),
          getattr(jiso, solver)(Pl, Pr, cs2l, cs2r, nhat), atol=1e-15)


def test_hllc_variables_match_jax():
    rng = np.random.default_rng(5)
    Pl, cs2l, _ = prim(rng)
    Pr, cs2r, _ = prim(rng)
    got = tiso.compute_hllc_variables(T(Pl), T(Pr), T(cs2l), T(cs2r),
                                      (1.0, 0.0))
    want = jiso.compute_hllc_variables(Pl, Pr, cs2l, cs2r, (1.0, 0.0))
    assert set(got) == set(want)
    for k in want:
        close(got[k], want[k], atol=1e-15)


def test_contains_invalid_matches_jax():
    P, _, _ = prim(np.random.default_rng(6))
    U = np.array(jiso.to_conserved_per_area(P))
    assert not bool(tiso.contains_invalid(T(U)))
    for bad in (-1e-9, np.nan):
        V = U.copy()
        V[7, 0] = bad
        assert bool(tiso.contains_invalid(T(V))) == bool(
            jiso.contains_invalid(V)) is True


@pytest.mark.parametrize("theta", [0.0, 1.0, 1.8, 2.0])
def test_plm_gradient_matches_jax(theta):
    """Random triples plus flat and monotone ones, where the limiter's
    sign(0) convention decides the result."""
    rng = np.random.default_rng(7)
    y = rng.normal(size=(3, 200))
    y[:, :20] = 1.0                                   # flat: a = b = c = 0
    y[:, 20:40] = np.array([0.0, 1.0, 2.0])[:, None]  # monotone
    y[1, 40:60] = y[0, 40:60]                         # a = 0 only
    close(tplm.plm_gradient(T(y[0]), T(y[1]), T(y[2]), theta),
          jplm.plm_gradient(y[0], y[1], y[2], theta))
    close(tplm.plm_gradient_on_axis(T(y.T), theta, axis=1),
          jplm.plm_gradient_on_axis(y.T, theta, axis=1))


# -----------------------------------------------------------------------------
# mesh/tree.py and mesh/block_layout.py
# -----------------------------------------------------------------------------

def leaves_pair(depth):
    over = {"depth": depth}
    jcfg = JB.create_config_template().create().update(over)
    tcfg = TB.create_config_template().create().update(over)
    return JB.create_leaves(jcfg), TB.create_leaves(tcfg)


@pytest.mark.parametrize("depth", [2, 3, 4, 5, 6])
def test_leaves_match_jax(depth):
    """The port builds leaves with the Python spec; the JAX package with
    its native builder where that is built. Both, and the JAX spec, give
    the same leaves in the same (Hilbert) order."""
    jl, tl = leaves_pair(depth)
    assert list(tl) == list(jl)
    ff = fi = 2.0
    pred = lambda level, r: r < (ff / level ** fi if level > 0
                                 else float("inf"))
    assert list(tl) == jtree.create_quadtree(pred, depth)
    assert ttree.tree_depth(tl) == jtree.tree_depth(jl)


@pytest.mark.parametrize("depth", [2, 3, 4, 5])
def test_neighbor_table_matches_jax(depth):
    jl, tl = leaves_pair(depth)
    got = tbl.build_neighbor_table(tl)
    want = jbl.build_neighbor_table(jl)
    for name in ("case", "same_id", "coarse_id", "coarse_half", "fine_id"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), err_msg=name)
    packed = tbl.pack_neighbor_table(got)
    np.testing.assert_array_equal(packed[..., 0], want.case)
    np.testing.assert_array_equal(packed[..., 4:], want.fine_id)


@pytest.mark.parametrize("depth", [3, 4])
def test_block_geometry_matches_jax(depth):
    jl, tl = leaves_pair(depth)
    for name in ("block_vertices", "block_cell_centers", "block_dx"):
        np.testing.assert_array_equal(getattr(tbl, name)(tl, 8),
                                      getattr(jbl, name)(jl, 8))


@pytest.mark.parametrize("depth", [3, 4])
def test_guard_gather_bitwise_matches_jax(depth):
    """The gather tables are equal and the extended blocks bitwise equal in
    float64, on both axes."""
    jl, tl = leaves_pair(depth)
    bs = 8
    tgg = tbl.build_guard_gather(tbl.build_neighbor_table(tl), bs)
    jgg = jbl.build_guard_gather(jbl.build_neighbor_table(jl), bs)
    np.testing.assert_array_equal(tgg.indices, jgg.indices)
    np.testing.assert_array_equal(tgg.weights, jgg.weights)
    U = np.random.default_rng(8).normal(size=(len(tl), bs, bs, 6))
    for axis in (0, 1):
        got = tbl.extend_blocks_fast(T(U), tgg.to("cpu", torch.float64),
                                     axis)
        want = np.asarray(jbl.extend_blocks_fast(jnp.asarray(U), jgg, axis))
        np.testing.assert_array_equal(got.numpy(), want)


# -----------------------------------------------------------------------------
# models/two_body.py
# -----------------------------------------------------------------------------

ELEMENTS = [dict(), dict(separation=1.3, mass_ratio=0.4),
            dict(eccentricity=0.3, mass_ratio=0.7)]


def full_elements(mod, pomega=0.3, tau=0.2, **kw):
    return mod.FullOrbitalElements(
        pomega=pomega, tau=tau, cm_position_x=0.01, cm_velocity_y=-0.02,
        elements=mod.OrbitalElements(**kw))


def flat_state(s):
    return [getattr(getattr(s, b), f) for b in ("body1", "body2")
            for f in ("mass", "position_x", "position_y", "velocity_x",
                      "velocity_y")]


def flat_elements(e):
    return [e.pomega, e.tau, e.cm_position_x, e.cm_position_y,
            e.cm_velocity_x, e.cm_velocity_y, e.elements.separation,
            e.elements.total_mass, e.elements.mass_ratio,
            e.elements.eccentricity]


@pytest.mark.parametrize("kw", ELEMENTS)
def test_two_body_state_and_elements_match_jax(kw):
    for t in (0.0, 0.9, 7.5):
        ts = ttb.compute_two_body_state(full_elements(ttb, **kw), t)
        js = jtb.compute_two_body_state(full_elements(jtb, **kw), t)
        close(flat_state(ts), flat_state(js))
        close(flat_elements(ttb.compute_orbital_elements(ts, t)),
              flat_elements(jtb.compute_orbital_elements(js, t)),
              atol=1e-13)


def test_two_body_perturbations_match_jax():
    a_t, b_t = full_elements(ttb), full_elements(ttb, pomega=6.2, tau=0.1)
    a_j, b_j = full_elements(jtb), full_elements(jtb, pomega=6.2, tau=0.1)
    close(flat_elements(ttb.diff(a_t, b_t)), flat_elements(jtb.diff(a_j, b_j)))
    close(flat_elements(ttb.diff_cm(a_t, 0.1)),
          flat_elements(jtb.diff_cm(a_j, 0.1)))
    close(ttb.orbital_period(a_t.elements), jtb.orbital_period(a_j.elements))
