"""Kernel B8: G periodic iso2d steps (PLM + HLLE, rk1) of tiles with the
flagship's locally isothermal sound speed, from halo strips 2G wide, as a
CUDA kernel beside its plain PyTorch version.

The counterpart of mara3_tpu/kernels/iso2d_step_li.py (`pallas_step_li`,
:143; its kernel body :55-140): kernel B10c's temporal blocking, with
cs^2 = 1 / (M^2 sqrt(r^2 + r_s^2)) evaluated at every face from the face's
periodically wrapped position, so the cs^2 field never exists in device
memory. geom = (dx, x0, y0, Lx, Ly, mach2, rsoft2), cast to the state's
dtype.

A face's position is formed as the TPU kernel forms it, from its TPU
tile's window: the window's first cell center ox = x0 + (i TX - h + 1/2) dx
(i the tile, h = 2G), moved by (2s) dx (formed in double, then cast) at
step s, then x = ox' + (ii + 3/2 or 2) dx with ii counted in that step's
shrunk window, wrapped as x - Lx floor((x - x0) / Lx). The rounding so
depends on the tile, and the plain version and the kernel both follow it.

- `step_li_strips_plain(u, north, south, west, east, *, G, geom, ...)`:
  each tile's window from the tile and its strips (iso2d_step_v2), G
  `_step_tile`s with the per-face sound speeds.
- `step_li_strips_cuda(...)`: kernel B8 (csrc/iso2d_ladder.cu, B10c's
  window kernel with the sound speed formed per face);
  `step_li_strips_cuda.launches` counts its launches. `step_li_strips`
  takes the plain version for a tensor on the CPU and the kernel for a
  CUDA tensor, never one for the other.
- `step_li(u, *, G, geom, ...)` and `advance_n_li(u, n, *, G, geom, ...)`:
  periodic steps, the strips built before each launch; n % G == 0.
- `step_periodic_li(u0, geom, dt, theta)`: one step of the scheme
  (schemes/iso2d_grid.py) on a component-last [nx, ny, 3] state, the faces'
  cs^2 from the same wrapped positions (step_periodic_li_jnp, :185-215).
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.kernels import iso2d_step_v1 as V1
from mara3_tpu_torch.kernels import iso2d_step_v2 as V2
from mara3_tpu_torch.physics import iso2d
from mara3_tpu_torch.schemes import iso2d_grid


def _cast(u, values):
    """Each of `values` as a 0-d tensor in u's dtype on u's device."""
    return [torch.tensor(v, dtype=u.dtype, device=u.device) for v in values]


def _cs2_at(x, y, mach2, rsoft2):
    """1 / (M^2 sqrt(x^2 + y^2 + r_s^2)), the axisymmetric locally
    isothermal cs^2 (iso2d_step_li.py:30-32)."""
    return torch.reciprocal(mach2 * torch.sqrt(x * x + y * y + rsoft2))


def _wrap(x, lo, L):
    """x wrapped periodically into [lo, lo + L)."""
    return x - L * torch.floor((x - lo) / L)


def _coords(origin, n, d, dx, lo, L):
    """[k, n]: origin[k] + (i + d) dx for i < n, wrapped into [lo, lo + L)
    (the TPU kernel's `pos`, iso2d_step_li.py:63-70)."""
    i = torch.arange(n, dtype=dx.dtype, device=dx.device)
    return _wrap(origin[:, None] + (i + d) * dx, lo, L)


def _faces_cs(ox, oy, NX, NY, g):
    """((cs2, cs) of the x faces [gi, gj, NX-3, NY-4], (cs2, cs) of the y
    faces [gi, gj, NX-4, NY-3]) of windows NX x NY whose cell (0, 0) sits
    at (ox[i], oy[j])."""
    dx, x0, y0, Lx, Ly, mach2, rsoft2, d15, d20 = g
    out = []
    for (ni, di), (nj, dj) in (((NX - 3, d15), (NY - 4, d20)),
                               ((NX - 4, d20), (NY - 3, d15))):
        x = _coords(ox, ni, di, dx, x0, Lx)[:, None, :, None]
        y = _coords(oy, nj, dj, dx, y0, Ly)[None, :, None, :]
        cs2 = _cs2_at(x, y, mach2, rsoft2)
        out.append((cs2, torch.sqrt(cs2)))
    return out


def _check_geom(geom, what):
    if len(geom) != 7:
        raise ValueError(f"{what} takes geom (dx, x0, y0, Lx, Ly, mach2, "
                         f"rsoft2), not {geom!r}")


def step_li_strips_plain(u, north, south, west, east, *, G: int, geom,
                         dtdx: float, dtdy: float, theta: float = 1.8,
                         tile=(128, 512)):
    """G locally isothermal steps of u [3, nx, ny] from its tiles' strips (h
    = 2G): what pallas_step_li computes, as torch ops on u's device."""
    TX, TY = tile
    h = 2 * G
    strips = (north, south, west, east)
    V2.check_tiles(u, TX, TY, h, "iso2d li tile step")
    V2.check_strips(u, strips, TX, TY, h, "iso2d li tile step")
    _check_geom(geom, "iso2d li tile step")
    g = _cast(u, (*geom, 1.5, 2.0))
    dx, x0, y0 = g[:3]
    scalars = TK._scalars(u, 0.0, dtdx, dtdy, theta)
    gi, gj = u.shape[1] // TX, u.shape[2] // TY
    # each tile's window origin, the cell centers (i TX - h + 1/2) dx
    ox = x0 + torch.tensor([i * TX - h + 0.5 for i in range(gi)],
                           dtype=u.dtype, device=u.device) * dx
    oy = y0 + torch.tensor([j * TY - h + 0.5 for j in range(gj)],
                           dtype=u.dtype, device=u.device) * dx
    w = V2.windows(u, strips, TX, TY)
    for s in range(G):
        off, = _cast(u, ((2 * s) * geom[0],))
        w = V1._step_tile(w, scalars, _faces_cs(ox + off, oy + off,
                                                w.shape[-2], w.shape[-1], g))
    return V2.from_tiles(w)


def step_li_strips_cuda(u, north, south, west, east, *, G: int, geom,
                        dtdx: float, dtdy: float, theta: float = 1.8,
                        tile=(128, 512), cta=None):
    """Kernel B8 on contiguous float32 or float64 CUDA tensors: a new
    [3, nx, ny] with G steps applied (u is not written); cta (CX, CY)
    overrides the CTA sub-tile. Raises if the kernel does not build or its
    launch fails."""
    TX, TY = tile
    h = 2 * G
    strips = (north, south, west, east)
    V2.check_tiles(u, TX, TY, h, "iso2d li tile kernel")
    V2.check_strips(u, strips, TX, TY, h, "iso2d li tile kernel")
    _check_geom(geom, "iso2d li tile kernel")
    V1.check_kernel_args("iso2d li tile kernel", u, *strips)
    cx, cy = cta or V1.cta_tile(h, u.element_size())
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        rc = V1.entry("b8_tiles", u.dtype)(
            u.data_ptr(), *(s.data_ptr() for s in strips), out.data_ptr(),
            u.shape[1], u.shape[2], TX, TY, G, cx, cy,
            *(float(v) for v in geom), dtdx, dtdy, theta,
            torch.cuda.current_stream(u.device).cuda_stream)
    V1.raise_on(rc, "iso2d li tile")
    step_li_strips_cuda.launches += 1
    return out


step_li_strips_cuda.launches = 0


def step_li_strips(u, north, south, west, east, *, G: int, geom, dtdx: float,
                   dtdy: float, theta: float = 1.8, tile=(128, 512)):
    """G steps from the tiles and their strips: the plain version for a CPU
    tensor, kernel B8 for a CUDA tensor."""
    kw = dict(G=G, geom=geom, dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile)
    if u.device.type == "cpu":
        return step_li_strips_plain(u, north, south, west, east, **kw)
    if u.device.type == "cuda":
        return step_li_strips_cuda(u, north, south, west, east, **kw)
    raise ValueError(f"no iso2d li step for a tensor on {u.device}")


def step_li(u, *, G: int, geom, dtdx: float, dtdy: float, theta: float = 1.8,
            tile=(128, 512)):
    """G periodic locally isothermal steps of u [3, nx, ny]
    (pallas_step_li)."""
    return step_li_strips(u, *V2.build_halo_strips(u, *tile, h=2 * G), G=G,
                          geom=geom, dtdx=dtdx, dtdy=dtdy, theta=theta,
                          tile=tile)


def advance_n_li(u, n: int, *, G: int = 4, geom, dtdx: float, dtdy: float,
                 theta: float = 1.8, tile=(128, 512)):
    """n periodic steps, G a launch (advance_n_pallas_li); n % G == 0."""
    if n < 0 or n % G:
        raise ValueError(f"advance_n_li takes n a multiple of G={G}, not {n}")
    for _ in range(n // G):
        u = step_li(u, G=G, geom=geom, dtdx=dtdx, dtdy=dtdy, theta=theta,
                    tile=tile)
    return u


def step_periodic_li(u0, geom, dt: float, theta: float = 1.8):
    """One locally isothermal step of the scheme on a periodic component-
    last u0 [nx, ny, 3], the faces' cs^2 from the same wrapped positions as
    the kernel's (step_periodic_li_jnp)."""
    _check_geom(geom, "step_periodic_li")
    nx, ny = u0.shape[0], u0.shape[1]
    dx, x0, y0, Lx, Ly, mach2, rsoft2, half, zero = _cast(u0,
                                                          (*geom, 0.5, 0.0))

    def cs2(ni, nj, di, dj):
        x = _coords(x0[None], ni, di, dx, x0, Lx)[0][:, None]
        y = _coords(y0[None], nj, dj, dx, y0, Ly)[0][None, :]
        return _cs2_at(x, y, mach2, rsoft2)

    Pe = iso2d_grid.extend_periodic2(iso2d.recover_primitive(u0))
    Fx, Fy = iso2d_grid.godunov_fluxes(Pe, cs2(nx + 1, ny, zero, half),
                                       cs2(nx, ny + 1, half, zero), theta)
    return iso2d_grid.flux_divergence_update(u0, Fx, Fy, geom[0], geom[0], dt)
