"""Kernel B10a: one periodic iso2d step (PLM + HLLE, rk1) from the guard-
extended state, as a CUDA kernel beside its plain PyTorch version; and what
the uniform-grid ladder's kernels (B9, B10a-c: csrc/iso2d_ladder.cu) share.

The counterpart of mara3_tpu/kernels/iso2d_step.py (its `pallas_step`,
iso2d_step.py:211, and `_step_tile`). In this package the name
`kernels/iso2d_step.py` belongs to kernel B1, the counterpart of the JAX
package's iso2d_step_v5.py, so this module is `iso2d_step_v1`.

- `extend_periodic(u)`: u [3, nx, ny] with two periodic guard rows and
  columns a side, [3, nx + 4, ny + 4]. The TPU's 8/128 alignment pad of
  `extend_periodic_soa` (iso2d_step.py:238-251) is not ported.
- `step_v1_plain(u_ext, ...)`: one step of the interior, [3, nx, ny]; it
  copies `_step_tile` (iso2d_step.py:150-192), with the arithmetic of
  kernel B1's plain version (kernels/iso2d_step.py), so the two agree bit
  for bit. The scalars are cast to the state's dtype first, as B1's are;
  the TPU kernel bakes them in as Python floats, which in float32 can round
  sqrt(cs2) differently (in float64 they are the same).
- `step_v1_cuda(u_ext, ...)`: kernel B10a, one thread a cell;
  `step_v1_cuda.launches` counts its launches. `step_v1` takes the plain
  version for a tensor on the CPU and the kernel for a CUDA tensor, and
  never falls back from one to the other. `advance_n_v1(u, n)` runs n
  steps, extending the state before each.

Shared with B8, B9, B10b and B10c: `_step_tile` (the plain step of a
window, B8's with its per-face sound speeds), the built library and (for
B8, B10b and B10c) `cta_tile`, the CTA sub-tile whose window fits in
shared memory.
"""

from __future__ import annotations

import ctypes

import torch

from mara3_tpu_torch.kernels import iso2d_step as TK

H = 2             # guard cells a side (the PLM stencil)
DTYPES = (torch.float32, torch.float64)

# Dynamic shared memory a CTA may use on sm_90, and an SM's whole (each CTA
# also holds 1 KB of the system's)
SMEM_BYTES = 232448
SM_SMEM_BYTES = 233472
# CTA sub-tiles (rows, columns) of the window kernels, largest first
CTA_TILES = ((32, 64), (32, 32), (24, 32), (16, 32), (16, 16), (8, 16),
             (8, 8))


def check_dtype(u, what):
    if u.dtype == torch.bfloat16:
        raise NotImplementedError(
            f"{what} takes float32 or float64; bfloat16 is not ported yet: "
            f"ROADMAP.md queue A item 13")
    if u.dtype not in DTYPES:
        raise ValueError(f"{what} takes float32 or float64, not {u.dtype}")


def check_kernel_args(what, *tensors):
    """Raise unless every tensor is contiguous and on the first's CUDA
    device in its dtype."""
    u = tensors[0]
    if u.device.type != "cuda":
        raise ValueError(f"{what} takes a CUDA tensor, not one on "
                         f"{u.device}")
    for t in tensors:
        if not t.is_contiguous():
            raise ValueError(f"{what} takes contiguous tensors")
        if t.device != u.device or t.dtype != u.dtype:
            raise ValueError(f"{what} takes tensors on one device in one "
                             f"dtype")


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def _step_tile(u, scalars, faces=None):
    """One step of the interior of windows [..., 3, WX, WY]: [..., 3, WX-4,
    WY-4] (mara3_tpu/kernels/iso2d_step.py::_step_tile, HLLE). `faces`,
    ((cs2, cs) of the x faces [..., WX-3, WY-4], (cs2, cs) of the y faces
    [..., WX-4, WY-3]), replaces the scalars' constant sound speed (kernel
    B8's locally isothermal step)."""
    cs2, cs, dtdx, dtdy, half_theta = scalars
    (cs2x, csx), (cs2y, csy) = faces or ((cs2, cs), (cs2, cs))
    sg = u[..., 0, :, :]
    vx = u[..., 1, :, :] / sg
    vy = u[..., 2, :, :] / sg

    def faces_x(q):
        gh = TK._plm_half(q[..., :-2, :], q[..., 1:-1, :], q[..., 2:, :],
                          half_theta)
        qc = q[..., 1:-1, :]
        return ((qc[..., :-1, :] + gh[..., :-1, :])[..., 2:-2],
                (qc[..., 1:, :] - gh[..., 1:, :])[..., 2:-2])

    def faces_y(q):
        gh = TK._plm_half(q[..., :-2], q[..., 1:-1], q[..., 2:], half_theta)
        qc = q[..., 1:-1]
        return ((qc[..., :-1] + gh[..., :-1])[..., 2:-2, :],
                (qc[..., 1:] - gh[..., 1:])[..., 2:-2, :])

    (sgl, sgr), (vxl, vxr), (vyl, vyr) = (faces_x(q) for q in (sg, vx, vy))
    fx = TK._hlle_1d(sgl, vxl, vyl, sgr, vxr, vyr, cs2x, csx)
    (sgl, sgr), (vxl, vxr), (vyl, vyr) = (faces_y(q) for q in (sg, vx, vy))
    fy0, fy2, fy1 = TK._hlle_1d(sgl, vyl, vxl, sgr, vyr, vxr, cs2y, csy)
    # for y faces the normal is vy: the solver's f_pn is the y-momentum flux
    u0 = u[..., 2:-2, 2:-2]
    return torch.stack([
        u0[..., q, :, :] - ((f[..., 1:, :] - f[..., :-1, :]) * dtdx
                            + (g[..., 1:] - g[..., :-1]) * dtdy)
        for q, f, g in zip(range(3), fx, (fy0, fy1, fy2))], dim=-3)


def extend_periodic(u):
    """[3, nx, ny] -> [3, nx + 4, ny + 4]: the interior starts at (2, 2),
    the guards wrap periodically."""
    rows = torch.cat([u[:, -H:], u, u[:, :H]], dim=1)
    return torch.cat([rows[:, :, -H:], rows, rows[:, :, :H]], dim=2)


def _check_ext(u_ext, what):
    if u_ext.dim() != 3 or u_ext.shape[0] != 3:
        raise ValueError(f"{what} takes u_ext [3, nx + 4, ny + 4], not "
                         f"{tuple(u_ext.shape)}")
    if min(u_ext.shape[1:]) < TK.MIN_CELLS + 2 * H:
        raise ValueError(f"{what} takes nx, ny >= {TK.MIN_CELLS}")
    check_dtype(u_ext, what)


def step_v1_plain(u_ext, *, cs2: float, dtdx: float, dtdy: float,
                  theta: float = 1.8):
    """One rk1 HLLE step of the interior of u_ext [3, nx + 4, ny + 4]:
    what pallas_step computes, as torch ops on u_ext's device."""
    _check_ext(u_ext, "step_v1_plain")
    return _step_tile(u_ext, TK._scalars(u_ext, cs2, dtdx, dtdy, theta))


# -----------------------------------------------------------------------------
# the CUDA kernels
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_double = ctypes.c_double


def library():
    """The built csrc/iso2d_ladder.cu (kernels B8, B9, B10a-c; compiled on
    first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("iso2d_ladder")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b8_tiles_f32, lib.b8_tiles_f64):
            fn.argtypes = ([_c_void_p] * 6 + [_c_int] * 7 + [_c_double] * 10
                           + [_c_void_p])
            fn.restype = _c_int
        for fn in (lib.b9_strips_f32, lib.b9_strips_f64):
            fn.argtypes = ([_c_void_p] * 6 + [_c_int] * 5
                           + [ctypes.POINTER(_c_int), _c_int]
                           + [_c_double] * 4 + [_c_void_p])
            fn.restype = _c_int
        lib.b9_kernel_info.argtypes = [_c_int] * 2 + [ctypes.POINTER(_c_int)]
        lib.b9_kernel_info.restype = _c_int
        for fn in (lib.b10a_step_f32, lib.b10a_step_f64):
            fn.argtypes = ([_c_void_p] * 2 + [_c_int] * 2 + [_c_double] * 4
                           + [_c_void_p])
            fn.restype = _c_int
        for fn in (lib.b10_tiles_f32, lib.b10_tiles_f64):
            fn.argtypes = ([_c_void_p] * 6 + [_c_int] * 7 + [_c_double] * 4
                           + [_c_void_p])
            fn.restype = _c_int
        lib.ladder_error_string.argtypes = [_c_int]
        lib.ladder_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def entry(name, dtype):
    """The library's C entry `name` for dtype (its _f32 or _f64 form)."""
    return getattr(library(), name + ("_f32" if dtype == torch.float32
                                      else "_f64"))


def raise_on(rc, what):
    if rc != 0:
        raise RuntimeError(f"{what} kernel launch failed: "
                           + library().ladder_error_string(rc).decode())


def window_bytes(cta, h, itemsize):
    """Shared memory of a window kernel's CTA: U, P, FX, FY, each 3 x
    (CX + 2h) x (CY + 2h) values."""
    cx, cy = cta
    return 4 * 3 * (cx + 2 * h) * (cy + 2 * h) * itemsize


def _stage_cells(cta, h):
    """The cells the stages of a window update, over the sub-tile's cells
    times the stages: 1 when h = 2, more as the halo grows."""
    cx, cy = cta
    stages = h // 2
    return sum((cx + 2 * h - 4 * s) * (cy + 2 * h - 4 * s)
               for s in range(1, stages + 1)) / (stages * cx * cy)


def cta_tile(h, itemsize):
    """The CTA sub-tile (CX, CY) of a window kernel for halo h: of those
    whose window fits in shared memory, the one with the fewest updates a
    useful cell, halved where two CTAs fit on an SM (a model of the card,
    not a measurement). Raises if none fits (G too large)."""
    best = None
    for cta in CTA_TILES:
        nbytes = window_bytes(cta, h, itemsize)
        if nbytes > SMEM_BYTES:
            continue
        per_sm = min(2, SM_SMEM_BYTES // (nbytes + 1024))
        cost = _stage_cells(cta, h) / per_sm
        if best is None or cost < best[0]:
            best = (cost, cta)
    if best is None:
        raise ValueError(f"no CTA window of halo {h} fits in shared memory: "
                         f"take a smaller G")
    return best[1]


def step_v1_cuda(u_ext, *, cs2: float, dtdx: float, dtdy: float,
                 theta: float = 1.8):
    """Kernel B10a on a contiguous float32 or float64 CUDA tensor u_ext [3,
    nx + 4, ny + 4]: a new [3, nx, ny]. Raises if the kernel does not build
    or its launch fails."""
    _check_ext(u_ext, "step_v1_cuda")
    check_kernel_args("step_v1_cuda", u_ext)
    nx, ny = u_ext.shape[1] - 2 * H, u_ext.shape[2] - 2 * H
    out = torch.empty((3, nx, ny), dtype=u_ext.dtype, device=u_ext.device)
    with torch.cuda.device(u_ext.device):
        rc = entry("b10a_step", u_ext.dtype)(
            u_ext.data_ptr(), out.data_ptr(), nx, ny, cs2, dtdx, dtdy, theta,
            torch.cuda.current_stream(u_ext.device).cuda_stream)
    raise_on(rc, "iso2d_step_v1")
    step_v1_cuda.launches += 1
    return out


step_v1_cuda.launches = 0


def step_v1(u_ext, *, cs2: float, dtdx: float, dtdy: float,
            theta: float = 1.8):
    """One step from u_ext: the plain version for a CPU tensor, kernel B10a
    for a CUDA tensor."""
    kw = dict(cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta)
    if u_ext.device.type == "cpu":
        return step_v1_plain(u_ext, **kw)
    if u_ext.device.type == "cuda":
        return step_v1_cuda(u_ext, **kw)
    raise ValueError(f"no iso2d v1 step for a tensor on {u_ext.device}")


def advance_n_v1(u, n: int, *, cs2: float, dtdx: float, dtdy: float,
                 theta: float = 1.8):
    """n periodic steps of u [3, nx, ny], extending it before each
    (advance_n_pallas, iso2d_step.py:254-262)."""
    for _ in range(n):
        u = step_v1(extend_periodic(u), cs2=cs2, dtdx=dtdx, dtdy=dtdy,
                    theta=theta)
    return u
