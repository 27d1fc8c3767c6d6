"""Kernel B10b: one periodic iso2d step (PLM + HLLE, rk1) of tiles from
their four halo strips, as a CUDA kernel beside its plain PyTorch version.

The counterpart of mara3_tpu/kernels/iso2d_step_v2.py (`pallas_step_v2`,
:115, and `build_halo_strips`, :33-97), a rung of the JAX package's kernel
ladder (bench.py's fallbacks, benchmarks/bench_kernel_sweep.py).

- `build_halo_strips(u, TX, TY, h)`: the strips of every TX x TY tile of a
  periodic u [3, nx, ny]: north, south [gi, gj, 3, h, TY + 2h] (the rows
  above and below, corners included) and west, east [gi, gj, 3, TX, h],
  gathered by index; the same values as the JAX function's, for h <= TX,
  TY.
- `step_v2_strips_plain(u, north, south, west, east, ...)`: each tile's
  window assembled from the tile and its strips, one `_step_tile`
  (kernels/iso2d_step_v1.py) a tile; bit-equal to kernel B1's plain version
  for periodic strips.
- `step_v2_strips_cuda(...)`: kernel B10b (csrc/iso2d_ladder.cu, B10c's
  kernel at G = 1: each CTA loads a sub-tile's window into shared memory);
  `step_v2_strips_cuda.launches` counts its launches. `step_v2_strips`
  takes the plain version for a tensor on the CPU and the kernel for a
  CUDA tensor, never one for the other.
- `step_v2(u, tile=...)` and `advance_n_v2(u, n, tile=...)`: periodic steps,
  the strips built before each.

The tile (TX, TY) decides which values come from strips; the CTA works on
sub-tiles of it (iso2d_step_v1.cta_tile), so no tile size is tied to the
TPU's VMEM. nx % TX == 0 and ny % TY == 0, as on the TPU.
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.kernels import iso2d_step_v1 as V1

H = V1.H


def check_tiles(u, TX, TY, h, what):
    """Raise unless u [3, nx, ny] splits into TX x TY tiles with halos of
    0 < h <= TX, TY."""
    if u.dim() != 3 or u.shape[0] != 3:
        raise ValueError(f"{what} takes u [3, nx, ny], not {tuple(u.shape)}")
    _, nx, ny = u.shape
    if TX < 1 or TY < 1 or nx % TX or ny % TY:
        raise ValueError(f"{what}: tile ({TX}, {TY}) does not divide "
                         f"({nx}, {ny})")
    if not 0 < h <= min(TX, TY):
        raise ValueError(f"{what}: halo {h} is wider than the tile "
                         f"({TX}, {TY})")
    V1.check_dtype(u, what)


def build_halo_strips(u, TX: int, TY: int, h: int = H):
    """(north, south, west, east) halo strips of every tile of the periodic
    u [3, nx, ny] (mara3_tpu/kernels/iso2d_step_v2.py:33-97)."""
    check_tiles(u, TX, TY, h, "build_halo_strips")
    _, nx, ny = u.shape
    ar = lambda n: torch.arange(n, device=u.device)
    i, j, k = ar(nx // TX)[:, None], ar(ny // TY)[:, None], ar(h)[None, :]
    cols = (j * TY - h + ar(TY + 2 * h)[None, :]) % ny      # [gj, TY + 2h]
    rows = i * TX + ar(TX)[None, :]                          # [gi, TX]

    def row_strip(r):      # r [gi, h] -> [gi, gj, 3, h, TY + 2h]
        return u[:, r[:, None, :, None], cols[None, :, None, :]] \
            .permute(1, 2, 0, 3, 4).contiguous()

    def col_strip(c):      # c [gj, h] -> [gi, gj, 3, TX, h]
        return u[:, rows[:, None, :, None], c[None, :, None, :]] \
            .permute(1, 2, 0, 3, 4).contiguous()

    return (row_strip((i * TX - h + k) % nx),
            row_strip(((i + 1) * TX + k) % nx),
            col_strip((j * TY - h + k) % ny),
            col_strip(((j + 1) * TY + k) % ny))


def check_strips(u, strips, TX, TY, h, what):
    north, south, west, east = strips
    gi, gj = u.shape[1] // TX, u.shape[2] // TY
    want = [(gi, gj, 3, h, TY + 2 * h)] * 2 + [(gi, gj, 3, TX, h)] * 2
    if [tuple(s.shape) for s in strips] != want:
        raise ValueError(f"{what}: strips of shapes "
                         f"{[tuple(s.shape) for s in strips]}, not {want}")


def windows(u, strips, TX, TY):
    """Each tile's window [gi, gj, 3, TX + 2h, TY + 2h] from u and its
    strips (the TPU kernel's concatenations, iso2d_step_v2.py:108-109)."""
    north, south, west, east = strips
    _, nx, ny = u.shape
    tiles = u.reshape(3, nx // TX, TX, ny // TY, TY).permute(1, 3, 0, 2, 4)
    mid = torch.cat([west, tiles, east], dim=-1)
    return torch.cat([north, mid, south], dim=-2)


def from_tiles(t):
    """[gi, gj, 3, TX, TY] -> [3, gi TX, gj TY]."""
    gi, gj, _, TX, TY = t.shape
    return t.permute(2, 0, 3, 1, 4).reshape(3, gi * TX, gj * TY)


def step_strips_plain(u, strips, *, G, cs2, dtdx, dtdy, theta, tile):
    """G steps of every tile's window, shrinking it by 2 a side a step (v3's
    kernel body; v2's at G = 1)."""
    TX, TY = tile
    check_tiles(u, TX, TY, 2 * G, "iso2d tile step")
    check_strips(u, strips, TX, TY, 2 * G, "iso2d tile step")
    scalars = TK._scalars(u, cs2, dtdx, dtdy, theta)
    w = windows(u, strips, TX, TY)
    for _ in range(G):
        w = V1._step_tile(w, scalars)
    return from_tiles(w)


def step_strips_cuda(u, strips, *, G, cs2, dtdx, dtdy, theta, tile,
                     cta=None):
    """The window kernel (B10b at G = 1, B10c) on contiguous CUDA tensors:
    a new [3, nx, ny]. cta (CX, CY) overrides the CTA sub-tile."""
    TX, TY = tile
    h = 2 * G
    check_tiles(u, TX, TY, h, "iso2d tile kernel")
    check_strips(u, strips, TX, TY, h, "iso2d tile kernel")
    V1.check_kernel_args("iso2d tile kernel", u, *strips)
    cx, cy = cta or V1.cta_tile(h, u.element_size())
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        rc = V1.entry("b10_tiles", u.dtype)(
            u.data_ptr(), *(s.data_ptr() for s in strips), out.data_ptr(),
            u.shape[1], u.shape[2], TX, TY, G, cx, cy, cs2, dtdx, dtdy,
            theta, torch.cuda.current_stream(u.device).cuda_stream)
    V1.raise_on(rc, "iso2d tile")
    return out


def step_v2_strips_plain(u, north, south, west, east, *, cs2: float,
                         dtdx: float, dtdy: float, theta: float = 1.8,
                         tile=(256, 512)):
    """One step of u [3, nx, ny] from its tiles' strips (h = 2): what
    pallas_step_v2 computes, as torch ops on u's device."""
    return step_strips_plain(u, (north, south, west, east), G=1, cs2=cs2,
                             dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile)


def step_v2_strips_cuda(u, north, south, west, east, *, cs2: float,
                        dtdx: float, dtdy: float, theta: float = 1.8,
                        tile=(256, 512), cta=None):
    """Kernel B10b on contiguous float32 or float64 CUDA tensors: a new
    [3, nx, ny] (u is not written). Raises if the kernel does not build or
    its launch fails."""
    out = step_strips_cuda(u, (north, south, west, east), G=1, cs2=cs2,
                           dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile,
                           cta=cta)
    step_v2_strips_cuda.launches += 1
    return out


step_v2_strips_cuda.launches = 0


def step_v2_strips(u, north, south, west, east, *, cs2: float, dtdx: float,
                   dtdy: float, theta: float = 1.8, tile=(256, 512)):
    """One step from the tiles and their strips: the plain version for a
    CPU tensor, kernel B10b for a CUDA tensor."""
    kw = dict(cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile)
    if u.device.type == "cpu":
        return step_v2_strips_plain(u, north, south, west, east, **kw)
    if u.device.type == "cuda":
        return step_v2_strips_cuda(u, north, south, west, east, **kw)
    raise ValueError(f"no iso2d v2 step for a tensor on {u.device}")


def step_v2(u, *, cs2: float, dtdx: float, dtdy: float, theta: float = 1.8,
            tile=(256, 512)):
    """One periodic step of u [3, nx, ny] (pallas_step_v2)."""
    return step_v2_strips(u, *build_halo_strips(u, *tile), cs2=cs2,
                          dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile)


def advance_n_v2(u, n: int, *, cs2: float, dtdx: float, dtdy: float,
                 theta: float = 1.8, tile=(256, 512)):
    """n periodic steps (advance_n_pallas_v2)."""
    for _ in range(n):
        u = step_v2(u, cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile)
    return u
