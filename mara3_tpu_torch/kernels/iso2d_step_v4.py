"""Kernel B9: G periodic iso2d steps (PLM + HLLE or HLLC, rk1 or SSP-RK2)
of full-width x-stripes in one call, from caller-built x-halo strips, as
a CUDA kernel beside its plain PyTorch version.

The counterpart of mara3_tpu/kernels/iso2d_step_v4.py
(`pallas_step_v4_strips`, :135; `pallas_step_v4`, :179;
`advance_n_pallas_v4`, :193), the kernel of kh's x-sharded run
(parallel/iso2d_sharded.py) and bench.py's first fallback. Its interface is
kept, so the tests feed both packages the same inputs:

- `build_x_strips(u, TX, h)`: (lo, hi), each [nx / TX, 3, h, ny]: stripe
  i's h rows below and above, wrapping periodically (iso2d_step_v4.py:122).
- `step_v4_strips_plain(u, lo, hi, *, G, ..., TX, rk_order, riemann)`: G
  steps of every stripe's window [3, TX + 2h, ny] (h = 2 G rk_order), y
  periodic by roll, x consuming 2 rows a side a stage: `_step_stripe`
  (:48-92) and `_step_stripe_rk2` (:95-102). The scalars are cast to the
  state's dtype first, as `_kernel_v4` casts them (:109-113). The
  arithmetic is kernel B1's plain version's (kernels/iso2d_step.py), so
  for periodic strips the two agree bit for bit.
- `step_v4_strips_cuda(...)`: kernel B9 (csrc/iso2d_ladder.cu), a C loop
  of G (rk1) or 2 G (rk2) launches of kernel B1's column march
  (csrc/iso2d_march.cuh) over every stripe's
  window [3, TX + 2h, ny]: the first stage reads the stripe's rows and
  its strips, the middle ones two window buffers [nx / TX, 3, TX + 2h, ny]
  that the wrapper allocates, the last writes the stripe's rows of the
  output; `stage_plan` is that sequence, tested on the CPU.
  `step_v4_strips_cuda.launches` counts its calls. `step_v4_strips` takes
  the plain version for a tensor on the CPU and the kernel for a CUDA
  tensor, never one for the other.
- `step_v4(u, ...)` and `advance_n_v4(u, n, ...)`: the periodic wrappers
  (strips built before each call); n is a multiple of G.

float32 and float64; bfloat16 raises (ROADMAP A13). The TPU's ny % 128
rule is not ported; nx % TX == 0 and h <= TX are kept, since the strips
are built from whole stripes.
"""

from __future__ import annotations

import ctypes

import torch

from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.kernels import iso2d_step_v1 as V1


def _step_stripe(u, scalars, riemann):
    """One forward-Euler step of windows [..., 3, NXw, NY]: [..., 3, NXw-4,
    NY], y periodic (iso2d_step_v4.py::_step_stripe)."""
    cs2, cs, dtdx, dtdy, half_theta = scalars
    solve = TK._SOLVERS[riemann]
    sg = u[..., 0, :, :]
    vx = u[..., 1, :, :] / sg
    vy = u[..., 2, :, :] / sg

    def faces_x(q):
        gh = TK._plm_half(q[..., :-2, :], q[..., 1:-1, :], q[..., 2:, :],
                          half_theta)
        qc = q[..., 1:-1, :]
        return qc[..., :-1, :] + gh[..., :-1, :], qc[..., 1:, :] - gh[..., 1:, :]

    def faces_y(q):
        # L/R states at face j + 1/2 for every j (periodic)
        gh = TK._plm_half(torch.roll(q, 1, -1), q, torch.roll(q, -1, -1),
                          half_theta)
        return q + gh, torch.roll(q - gh, -1, -1)

    (sgl, sgr), (vxl, vxr), (vyl, vyr) = (faces_x(q) for q in (sg, vx, vy))
    fx = solve(sgl, vxl, vyl, sgr, vxr, vyr, cs2, cs)
    # y faces only on the rows that survive this step
    (sgl, sgr), (vxl, vxr), (vyl, vyr) = (
        faces_y(q[..., 2:-2, :]) for q in (sg, vx, vy))
    fy0, fy2, fy1 = solve(sgl, vyl, vxl, sgr, vyr, vxr, cs2, cs)
    # for y faces the normal is vy: the solver's f_pn is the y-momentum flux
    u0 = u[..., 2:-2, :]
    return torch.stack([
        u0[..., q, :, :] - ((f[..., 1:, :] - f[..., :-1, :]) * dtdx
                            + (g - torch.roll(g, 1, -1)) * dtdy)
        for q, f, g in zip(range(3), fx, (fy0, fy1, fy2))], dim=-3)


def _check(u, lo, hi, G, TX, rk_order, riemann, what):
    if u.dim() != 3 or u.shape[0] != 3:
        raise ValueError(f"{what} takes u [3, nx, ny], not {tuple(u.shape)}")
    _, nx, ny = u.shape
    if G < 1 or rk_order not in (1, 2) or riemann not in TK.RIEMANN:
        raise ValueError(f"{what} takes G >= 1, rk_order 1 or 2 and riemann "
                         f"hlle or hllc, not {G}, {rk_order}, {riemann!r}")
    h = 2 * G * rk_order
    if TX < 1 or nx % TX or h > TX or ny < TK.MIN_CELLS:
        raise ValueError(f"{what}: stripes of TX={TX} rows with halos of "
                         f"h={h} do not fit u of {nx} x {ny} (nx % TX == 0, "
                         f"h <= TX, ny >= {TK.MIN_CELLS})")
    want = (nx // TX, 3, h, ny)
    if tuple(lo.shape) != want or tuple(hi.shape) != want:
        raise ValueError(f"{what}: strips of {tuple(lo.shape)} and "
                         f"{tuple(hi.shape)}, not {want}")
    V1.check_dtype(u, what)


def build_x_strips(u, TX: int, h: int):
    """x-halo strips of a periodic [3, nx, ny] state: (lo, hi), each [gi,
    3, h, ny], stripe i's h rows below and above."""
    _, nx, ny = u.shape
    if TX < 1 or nx % TX or not 0 < h <= TX:
        raise ValueError(f"build_x_strips: stripes of TX={TX} rows with "
                         f"halos of h={h} do not fit {nx} rows")
    ub = u.reshape(3, nx // TX, TX, ny)
    lo = torch.roll(ub[:, :, TX - h:], 1, 1).permute(1, 0, 2, 3)
    hi = torch.roll(ub[:, :, :h], -1, 1).permute(1, 0, 2, 3)
    return lo.contiguous(), hi.contiguous()


def step_v4_strips_plain(u, lo, hi, *, G: int, cs2: float, dtdx: float,
                         dtdy: float, theta: float = 1.8, TX: int = 512,
                         rk_order: int = 1, riemann: str = "hlle"):
    """G steps of u [3, nx, ny] with caller-built strips lo, hi [nx / TX, 3,
    2 G rk_order, ny]: what pallas_step_v4_strips computes, as torch ops on
    u's device."""
    _check(u, lo, hi, G, TX, rk_order, riemann, "step_v4_strips_plain")
    _, nx, ny = u.shape
    scalars = TK._scalars(u, cs2, dtdx, dtdy, theta)
    w = torch.cat([lo, u.reshape(3, nx // TX, TX, ny).permute(1, 0, 2, 3),
                   hi], dim=2)
    for _ in range(G):
        if rk_order == 1:
            w = _step_stripe(w, scalars, riemann)
        else:
            w2 = _step_stripe(_step_stripe(w, scalars, riemann), scalars,
                              riemann)
            w = 0.5 * (w[..., 4:-4, :] + w2)
    return w.permute(1, 0, 2, 3).reshape(3, nx, ny)


# the roles of B9's stage plan (csrc/iso2d_ladder.cu B9Role): the stripe
# and its strips (the launch's input), the window buffers X and Y, the
# stripe's rows of the output; NONE for no Heun base
STRIPS, WIN_X, WIN_Y, OUT, NONE = 0, 1, 2, 3, -1


def stage_plan(TX: int, G: int, rk_order: int):
    """B9's march stages over a stripe's window of TX + 2h rows (h = 2 G
    rk_order): (src, base, dst, r_lo, r_hi) each, the roles above and the
    output rows [r_lo, r_hi) of the window, which shrink by 2 a side a
    stage. rk1 alternates X and Y; rk2's first stage writes Y and its
    second the Heun average 0.5 * (start + E(Y)) into X in place over the
    step's start (the strips for the first step). The last stage writes
    rows [h, h + TX), the stripe's rows of the output."""
    h = 2 * G * rk_order
    wx = TX + 2 * h
    rows = lambda k: (2 * (k + 1), wx - 2 * (k + 1))
    plan = []
    if rk_order == 1:
        src = STRIPS
        for k in range(G):
            dst = OUT if k == G - 1 else (WIN_X if k % 2 == 0 else WIN_Y)
            plan.append((src, NONE, dst, *rows(k)))
            src = dst
    else:
        start = STRIPS
        for g in range(G):
            plan.append((start, NONE, WIN_Y, *rows(2 * g)))
            plan.append((WIN_Y, start, OUT if g == G - 1 else WIN_X,
                         *rows(2 * g + 1)))
            start = WIN_X
    return plan


def kernel_info(dtype, riemann: str = "hlle"):
    """B9's march kernel's resources (iso2d_step.march_info)."""
    lib = V1.library()
    return TK.march_info(lib.b9_kernel_info, lib.ladder_error_string, dtype,
                         riemann)


def step_v4_strips_cuda(u, lo, hi, *, G: int, cs2: float, dtdx: float,
                        dtdy: float, theta: float = 1.8, TX: int = 512,
                        rk_order: int = 1, riemann: str = "hlle"):
    """Kernel B9 on contiguous float32 or float64 CUDA tensors: a new [3,
    nx, ny] with G steps applied (u is not written). Raises if the kernel
    does not build or a launch fails."""
    _check(u, lo, hi, G, TX, rk_order, riemann, "step_v4_strips_cuda")
    V1.check_kernel_args("step_v4_strips_cuda", u, lo, hi)
    _, nx, ny = u.shape
    h = 2 * G * rk_order
    plan = stage_plan(TX, G, rk_order)
    used = {role for stage in plan for role in stage[:3]}
    window = (nx // TX, 3, TX + 2 * h, ny)
    X, Y = (torch.empty(window, dtype=u.dtype, device=u.device)
            if role in used else None for role in (WIN_X, WIN_Y))
    table = (ctypes.c_int * (5 * len(plan)))(*(v for s in plan for v in s))
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        rc = V1.entry("b9_strips", u.dtype)(
            u.data_ptr(), lo.data_ptr(), hi.data_ptr(), out.data_ptr(),
            X.data_ptr() if X is not None else None,
            Y.data_ptr() if Y is not None else None, nx, ny, TX, h,
            TK.RIEMANN.index(riemann), table, len(plan), cs2, dtdx, dtdy,
            theta, torch.cuda.current_stream(u.device).cuda_stream)
    V1.raise_on(rc, "iso2d_step_v4")
    step_v4_strips_cuda.launches += 1
    return out


step_v4_strips_cuda.launches = 0


def step_v4_strips(u, lo, hi, *, G: int, cs2: float, dtdx: float,
                   dtdy: float, theta: float = 1.8, TX: int = 512,
                   rk_order: int = 1, riemann: str = "hlle"):
    """G steps with caller-built strips: the plain version for a CPU tensor,
    kernel B9 for a CUDA tensor."""
    kw = dict(G=G, cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta, TX=TX,
              rk_order=rk_order, riemann=riemann)
    if u.device.type == "cpu":
        return step_v4_strips_plain(u, lo, hi, **kw)
    if u.device.type == "cuda":
        return step_v4_strips_cuda(u, lo, hi, **kw)
    raise ValueError(f"no iso2d v4 step for a tensor on {u.device}")


def step_v4(u, *, G: int, cs2: float, dtdx: float, dtdy: float,
            theta: float = 1.8, TX: int = 512, rk_order: int = 1,
            riemann: str = "hlle"):
    """G periodic steps of u [3, nx, ny] (pallas_step_v4)."""
    lo, hi = build_x_strips(u, TX, 2 * G * rk_order)
    return step_v4_strips(u, lo, hi, G=G, cs2=cs2, dtdx=dtdx, dtdy=dtdy,
                          theta=theta, TX=TX, rk_order=rk_order,
                          riemann=riemann)


def advance_n_v4(u, n: int, *, G: int = 8, cs2: float, dtdx: float,
                 dtdy: float, theta: float = 1.8, TX: int = 512,
                 rk_order: int = 1, riemann: str = "hlle"):
    """n periodic steps, G a launch (advance_n_pallas_v4); n % G == 0."""
    if n < 0 or G < 1 or n % G:
        raise ValueError(f"advance_n_v4 takes n a multiple of G={G}, not {n}")
    for _ in range(n // G):
        u = step_v4(u, G=G, cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta,
                    TX=TX, rk_order=rk_order, riemann=riemann)
    return u
