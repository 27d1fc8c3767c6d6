"""The port's uniform-grid ladder (mara3_tpu_torch/kernels/iso2d_step_v1.py,
_v2, _v3, _v4: the plain versions of kernels B10a, B10b, B10c and B9)
against the JAX package's Pallas kernels in interpret mode, on the CPU in
float64, and against the port's own kernel B1. Inputs, strips included,
come from numpy seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mara3_tpu.kernels import iso2d_step as J1
from mara3_tpu.kernels import iso2d_step_v2 as J2
from mara3_tpu.kernels import iso2d_step_v3 as J3
from mara3_tpu.kernels import iso2d_step_v4 as J4
from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.kernels import iso2d_step_v1 as V1
from mara3_tpu_torch.kernels import iso2d_step_v2 as V2
from mara3_tpu_torch.kernels import iso2d_step_v3 as V3
from mara3_tpu_torch.kernels import iso2d_step_v4 as V4

torch.set_num_threads(1)

# each plain version against its JAX kernel in interpret mode: the same
# formulas, but XLA's CPU graph fuses multiply-adds, so round-off apart
JAX_TOL = dict(rtol=1e-13, atol=1e-13)
KW = dict(cs2=0.5, dtdx=0.1, dtdy=0.12, theta=1.5)
NX, NY = 64, 128


def random_state(nx, ny, seed=0):
    """u [3, nx, ny] of density 1-1.2 and speeds ~0.1."""
    rng = np.random.default_rng(seed)
    sg = 1.0 + 0.2 * rng.uniform(size=(nx, ny))
    vx = 0.1 * rng.normal(size=(nx, ny))
    vy = 0.1 * rng.normal(size=(nx, ny))
    return np.stack([sg, sg * vx, sg * vy])


def random_strips(gi, h, ny, seed):
    """(lo, hi) [gi, 3, h, ny] of the same kind as random_state, unrelated
    to the state they border."""
    return tuple(np.ascontiguousarray(
        random_state(gi * h, ny, seed + k).reshape(3, gi, h, ny)
        .transpose(1, 0, 2, 3)) for k in (0, 1))


# -----------------------------------------------------------------------------
# the strips and the extension, bit for bit
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("TX,h", [(16, 4), (64, 16), (8, 8)])
def test_build_x_strips_matches_jax(TX, h):
    u = random_state(NX, NY)
    want = J4.build_x_strips(jnp.asarray(u), TX, h)
    got = V4.build_x_strips(torch.tensor(u), TX, h)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


@pytest.mark.parametrize("TX,TY,h", [(32, 128, 8), (16, 64, 4)])
def test_build_halo_strips_matches_jax(TX, TY, h):
    u = random_state(NX, NY, seed=1)
    want = J2.build_halo_strips(jnp.asarray(u), TX, TY, h=h)
    got = V2.build_halo_strips(torch.tensor(u), TX, TY, h=h)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_extend_periodic_is_the_jax_extension_without_its_pad():
    u = random_state(20, 12, seed=2)
    want = np.asarray(J1.extend_periodic_soa(jnp.asarray(u)))
    got = V1.extend_periodic(torch.tensor(u)).numpy()
    assert got.shape == (3, 24, 16)
    np.testing.assert_array_equal(got, want[:, :24, :16])


# -----------------------------------------------------------------------------
# each plain version against its JAX kernel in interpret mode
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("riemann", ["hlle", "hllc"])
@pytest.mark.parametrize("rk", [1, 2])
def test_plain_v4_matches_jax_with_random_strips(rk, riemann):
    """B9's plain version against pallas_step_v4_strips: 2 steps of stripes
    of 32 rows whose strips are random, not the state's neighbors."""
    G, TX = 2, 32
    u = random_state(NX, NY, seed=3)
    lo, hi = random_strips(NX // TX, 2 * G * rk, NY, seed=10)
    kw = dict(KW, G=G, TX=TX, rk_order=rk, riemann=riemann)
    want = J4.pallas_step_v4_strips(jnp.asarray(u), jnp.asarray(lo),
                                    jnp.asarray(hi), interpret=True, **kw)
    got = V4.step_v4_strips_plain(torch.tensor(u), torch.tensor(lo),
                                  torch.tensor(hi), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_plain_v4_advance_matches_jax():
    """advance_n_v4 against advance_n_pallas_v4: 4 periodic rk2 HLLC steps
    in launches of G = 2."""
    u = random_state(NX, NY, seed=4)
    kw = dict(KW, G=2, TX=16, rk_order=2, riemann="hllc")
    want = J4.advance_n_pallas_v4(jnp.asarray(u), 4, interpret=True, **kw)
    got = V4.advance_n_v4(torch.tensor(u), 4, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_plain_v1_matches_jax():
    """B10a's plain version against pallas_step from the same extension."""
    u = random_state(NX, NY, seed=5)
    with pltpu.force_tpu_interpret_mode():
        want = J1.pallas_step(J1.extend_periodic_soa(jnp.asarray(u)),
                              tile=(32, 128), **KW)
    got = V1.step_v1_plain(V1.extend_periodic(torch.tensor(u)), **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize("tile", [(32, 64), (16, 128)])
def test_plain_v2_matches_jax(tile):
    u = random_state(NX, NY, seed=6)
    with pltpu.force_tpu_interpret_mode():
        want = J2.pallas_step_v2(jnp.asarray(u), tile=tile, **KW)
    got = V2.step_v2(torch.tensor(u), tile=tile, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_plain_v2_matches_jax_with_random_strips():
    """The tile kernel reads its halo from the strips it is given, not from
    the state: random strips, one step, against the JAX kernel body
    (_kernel_v2 as pallas_step_v2 calls it, interpret mode)."""
    TX, TY = 32, 64
    u = random_state(NX, NY, seed=7)
    strips = [np.asarray(s) for s in V2.build_halo_strips(
        torch.tensor(random_state(NX, NY, seed=8)), TX, TY)]
    spec = lambda a: pl.BlockSpec((1, 1) + a.shape[2:],
                                  lambda i, j: (i, j, 0, 0, 0),
                                  memory_space=pltpu.VMEM)
    kernel = functools.partial(J2._kernel_v2, **KW)
    with pltpu.force_tpu_interpret_mode():
        want = pl.pallas_call(
            kernel, grid=(NX // TX, NY // TY),
            in_specs=[pl.BlockSpec((3, TX, TY), lambda i, j: (0, i, j),
                                   memory_space=pltpu.VMEM)]
            + [spec(a) for a in strips],
            out_specs=pl.BlockSpec((3, TX, TY), lambda i, j: (0, i, j),
                                   memory_space=pltpu.VMEM),
            out_shape=jax.ShapeDtypeStruct((3, NX, NY), jnp.float64),
        )(jnp.asarray(u), *map(jnp.asarray, strips))
    got = V2.step_v2_strips_plain(torch.tensor(u),
                                  *map(torch.tensor, strips),
                                  tile=(TX, TY), **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize("G,tile", [(2, (32, 64)), (4, (32, 128))])
def test_plain_v3_matches_jax(G, tile):
    u = random_state(NX, NY, seed=9)
    with pltpu.force_tpu_interpret_mode():
        want = J3.pallas_step_v3(jnp.asarray(u), G=G, tile=tile, **KW)
    got = V3.step_v3(torch.tensor(u), G=G, tile=tile, **KW)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


# -----------------------------------------------------------------------------
# every plain version against the port's plain B1, bit for bit
# -----------------------------------------------------------------------------

@pytest.mark.parametrize("name,run,rk,riemann", [
    ("v1", lambda u, n: V1.advance_n_v1(u, n, **KW), 1, "hlle"),
    ("v2", lambda u, n: V2.advance_n_v2(u, n, tile=(16, 20), **KW), 1,
     "hlle"),
    ("v3", lambda u, n: V3.advance_n_v3(u, n, G=4, tile=(24, 20), **KW), 1,
     "hlle"),
    ("v4 rk1 hlle", lambda u, n: V4.advance_n_v4(u, n, G=4, TX=8, **KW), 1,
     "hlle"),
    ("v4 rk2 hllc", lambda u, n: V4.advance_n_v4(
        u, n, G=2, TX=16, rk_order=2, riemann="hllc", **KW), 2, "hllc"),
])
def test_plain_versions_are_bitwise_b1(name, run, rk, riemann):
    """On a 48 x 40 state (no TPU rule allows it), 8 steps."""
    u = torch.tensor(random_state(48, 40, seed=11))
    want = TK.advance_n_plain(u, 8, rk_order=rk, riemann=riemann, **KW)
    assert torch.equal(run(u, 8), want), name
