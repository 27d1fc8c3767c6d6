"""The port's locally isothermal window step (mara3_tpu_torch/kernels/
iso2d_step_li.py: kernel B8's plain version, the periodic advance and the
scheme's step) against the JAX package's iso2d_step_li.py, the Pallas
kernel in interpret mode, on the CPU in float64. Inputs, strips included,
come from numpy seeds."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from mara3_tpu.kernels import iso2d_step_li as JL
from mara3_tpu_torch.kernels import iso2d_step_li as TL
from mara3_tpu_torch.kernels import iso2d_step_v2 as V2

torch.set_num_threads(1)

# the plain version against the JAX kernel in interpret mode: the same
# formulas, but XLA's CPU graph fuses multiply-adds (x*x + y*y among them),
# so round-off apart
JAX_TOL = dict(rtol=1e-13, atol=1e-13)
# the plain window step against the scheme's step (the JAX test holds the
# JAX pair at rtol 1e-6, atol 1e-9): the same physics, the half-slopes and
# the update grouped otherwise; measured in float64 at max |du| 2.2e-16
# (an ulp of the density) over 4 steps, in each geometry
SCHEME_TOL = dict(rtol=1e-14, atol=1e-15)
NX, NY = 64, 128
DT, THETA = 2e-4, 1.8
# (dx, x0, y0, Lx, Ly, mach2, rsoft2): the JAX test's domain [1, 2)^2, one
# that straddles r = 0 (r_s^2 matters there), and one with Lx != Ly
GEOMS = {
    "offset": (1.0 / NX, 1.0, 1.0, 1.0, 2.0, 100.0, 1e-4),
    "r=0": (1.0 / NX, -0.5, -0.5, 1.0, 2.0, 100.0, 1e-2),
    "Lx!=Ly": (0.5 / NX, 0.25, -1.0, 0.5, 1.0, 30.0, 1e-3),
}


def random_state(nx, ny, seed=0):
    """u [3, nx, ny] of density 1-1.2 and speeds ~0.1."""
    rng = np.random.default_rng(seed)
    sg = 1.0 + 0.2 * rng.uniform(size=(nx, ny))
    vx = 0.1 * rng.normal(size=(nx, ny))
    vy = 0.1 * rng.normal(size=(nx, ny))
    return np.stack([sg, sg * vx, sg * vy])


def kw(geom):
    return dict(geom=geom, dtdx=DT / geom[0], dtdy=DT / geom[0], theta=THETA)


@pytest.mark.parametrize("name", sorted(GEOMS))
@pytest.mark.parametrize("G,tile", [(1, (32, 64)), (2, (32, 128)),
                                    (4, (16, 64))])
def test_plain_matches_jax(G, tile, name):
    """One launch of G steps over two or more tiles a side or one of
    them."""
    u = random_state(NX, NY, seed=G)
    with pltpu.force_tpu_interpret_mode():
        want = JL.pallas_step_li(jnp.asarray(u), G=G, tile=tile,
                                 **kw(GEOMS[name]))
    got = TL.step_li(torch.tensor(u), G=G, tile=tile, **kw(GEOMS[name]))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_advance_matches_jax():
    """advance_n_li against advance_n_pallas_li: 8 steps, G = 4."""
    u = random_state(NX, NY, seed=5)
    k = dict(kw(GEOMS["r=0"]), G=4, tile=(32, 64))
    with pltpu.force_tpu_interpret_mode():
        want = JL.advance_n_pallas_li(jnp.asarray(u), 8, **k)
    got = TL.advance_n_li(torch.tensor(u), 8, **k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_scheme_step_matches_jax(name):
    u = random_state(NX, NY, seed=6).transpose(1, 2, 0).copy()
    geom = GEOMS[name]
    want = JL.step_periodic_li_jnp(jnp.asarray(u), geom, DT, THETA)
    got = TL.step_periodic_li(torch.tensor(u), geom, DT, THETA)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


@pytest.mark.parametrize("name", sorted(GEOMS))
def test_plain_matches_the_scheme(name):
    """4 periodic steps in one launch against 4 steps of the scheme."""
    u = random_state(NX, NY, seed=7)
    geom = GEOMS[name]
    want = torch.tensor(u).permute(1, 2, 0).contiguous()
    for _ in range(4):
        want = TL.step_periodic_li(want, geom, DT, THETA)
    got = TL.step_li(torch.tensor(u), G=4, tile=(32, 64), **kw(geom))
    np.testing.assert_allclose(got.numpy(),
                               want.permute(2, 0, 1).numpy(), **SCHEME_TOL)


@pytest.mark.parametrize("G", [1, 2])
def test_plain_matches_jax_with_random_strips(G):
    """The window reads its halo from the strips it is given, not from the
    state: random strips, against the JAX kernel body (_kernel_li as
    pallas_step_li calls it, interpret mode)."""
    TX, TY = 32, 64
    geom = GEOMS["r=0"]
    u = random_state(NX, NY, seed=8)
    strips = [np.asarray(s) for s in V2.build_halo_strips(
        torch.tensor(random_state(NX, NY, seed=9)), TX, TY, h=2 * G)]
    spec = lambda a: pl.BlockSpec((1, 1) + a.shape[2:],
                                  lambda i, j: (i, j, 0, 0, 0),
                                  memory_space=pltpu.VMEM)
    k = kw(geom)
    kernel = functools.partial(JL._kernel_li, G=G, TX=TX, TY=TY, **k)
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
    got = TL.step_li_strips_plain(torch.tensor(u), *map(torch.tensor, strips),
                                  G=G, tile=(TX, TY), **k)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **JAX_TOL)


def test_refusals():
    u = torch.tensor(random_state(32, 16))
    k = kw(GEOMS["offset"])
    strips = V2.build_halo_strips(u, 16, 8, h=4)
    with pytest.raises(ValueError, match="multiple of G"):
        TL.advance_n_li(u, 6, G=4, tile=(16, 8), **k)
    with pytest.raises(ValueError, match="does not divide"):
        TL.step_li(u, G=1, tile=(12, 8), **k)
    with pytest.raises(ValueError, match="wider than the tile"):
        TL.step_li(u, G=8, tile=(16, 8), **k)
    with pytest.raises(ValueError, match="strips of shapes"):
        TL.step_li_strips_plain(u, *strips, G=1, tile=(16, 8), **k)
    with pytest.raises(ValueError, match="geom"):
        TL.step_li_strips_plain(u, *strips, G=2, tile=(16, 8),
                                **dict(k, geom=k["geom"][:6]))
    with pytest.raises(NotImplementedError, match="queue A item 13"):
        TL.step_li(u.to(torch.bfloat16), G=2, tile=(16, 8), **k)
    with pytest.raises(ValueError, match="float32 or float64"):
        TL.step_li(u.to(torch.float16), G=2, tile=(16, 8), **k)
    with pytest.raises(ValueError, match="CUDA tensor"):
        TL.step_li_strips_cuda(u, *strips, G=2, tile=(16, 8), **k)
