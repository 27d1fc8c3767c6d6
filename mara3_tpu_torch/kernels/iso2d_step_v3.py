"""Kernel B10c: G periodic iso2d steps (PLM + HLLE, rk1) of tiles in one
launch, from halo strips 2G wide, as a CUDA kernel beside its plain PyTorch
version.

The counterpart of mara3_tpu/kernels/iso2d_step_v3.py (`pallas_step_v3`,
:46; its kernel body :29-43, strips :77-84): temporal blocking, G steps
for one pass over the state, at the price of recomputing each tile's halo.

- `step_v3_strips_plain(u, north, south, west, east, *, G, ...)`: each
  tile's window (TX + 4G) x (TY + 4G) from the tile and its strips
  (iso2d_step_v2.build_halo_strips with h = 2G), G `_step_tile`s that
  shrink it by 2 a side each; bit-equal to kernel B1's plain version for
  periodic strips.
- `step_v3_strips_cuda(...)`: kernel B10c (csrc/iso2d_ladder.cu): each CTA
  loads the window of a CX x CY sub-tile of a tile into shared memory, runs
  the G steps there and writes the sub-tile; `step_v3_strips_cuda.launches`
  counts its launches. `step_v3_strips` takes the plain version for a
  tensor on the CPU and the kernel for a CUDA tensor, never one for the
  other.
- `step_v3(u, *, G, tile)` and `advance_n_v3(u, n, *, G, tile)`: periodic
  steps, the strips built before each launch; n % G == 0.

The TPU's tile sizes suit its VMEM (bench.py runs tile=(64, 1024)) and do
not change the result; here the tile only says which values come from the
strips, and the CTA's sub-tile (iso2d_step_v1.cta_tile) is sized so that
its window of (CX + 4G) x (CY + 4G) x 3 values, with the primitives and
fluxes beside it, fits in shared memory.
"""

from __future__ import annotations

from mara3_tpu_torch.kernels import iso2d_step_v2 as V2


def step_v3_strips_plain(u, north, south, west, east, *, G: int, cs2: float,
                         dtdx: float, dtdy: float, theta: float = 1.8,
                         tile=(128, 512)):
    """G steps of u [3, nx, ny] from its tiles' strips (h = 2G): what
    pallas_step_v3 computes, as torch ops on u's device."""
    return V2.step_strips_plain(u, (north, south, west, east), G=G, cs2=cs2,
                                dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile)


def step_v3_strips_cuda(u, north, south, west, east, *, G: int, cs2: float,
                        dtdx: float, dtdy: float, theta: float = 1.8,
                        tile=(128, 512), cta=None):
    """Kernel B10c on contiguous float32 or float64 CUDA tensors: a new
    [3, nx, ny] with G steps applied (u is not written); cta (CX, CY)
    overrides the CTA sub-tile. Raises if the kernel does not build or its
    launch fails."""
    out = V2.step_strips_cuda(u, (north, south, west, east), G=G, cs2=cs2,
                              dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile,
                              cta=cta)
    step_v3_strips_cuda.launches += 1
    return out


step_v3_strips_cuda.launches = 0


def step_v3_strips(u, north, south, west, east, *, G: int, cs2: float,
                   dtdx: float, dtdy: float, theta: float = 1.8,
                   tile=(128, 512)):
    """G steps from the tiles and their strips: the plain version for a CPU
    tensor, kernel B10c for a CUDA tensor."""
    kw = dict(G=G, cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta, tile=tile)
    if u.device.type == "cpu":
        return step_v3_strips_plain(u, north, south, west, east, **kw)
    if u.device.type == "cuda":
        return step_v3_strips_cuda(u, north, south, west, east, **kw)
    raise ValueError(f"no iso2d v3 step for a tensor on {u.device}")


def step_v3(u, *, G: int, cs2: float, dtdx: float, dtdy: float,
            theta: float = 1.8, tile=(128, 512)):
    """G periodic steps of u [3, nx, ny] (pallas_step_v3)."""
    return step_v3_strips(u, *V2.build_halo_strips(u, *tile, h=2 * G), G=G,
                          cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta,
                          tile=tile)


def advance_n_v3(u, n: int, *, G: int = 4, cs2: float, dtdx: float,
                 dtdy: float, theta: float = 1.8, tile=(128, 512)):
    """n periodic steps, G a launch (advance_n_pallas_v3); n % G == 0."""
    if n < 0 or n % G:
        raise ValueError(f"advance_n_v3 takes n a multiple of G={G}, not {n}")
    for _ in range(n // G):
        u = step_v3(u, G=G, cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta,
                    tile=tile)
    return u
