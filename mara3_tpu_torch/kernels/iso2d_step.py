"""Kernel B1: n periodic uniform-grid iso2d steps (PLM + HLLE/HLLC, rk1 or
SSP-RK2) as a CUDA kernel beside its plain PyTorch version.

Replaces mara3_tpu/kernels/iso2d_step_v5.py::advance_n_pallas_v5, the
Pallas kernel the JAX package runs on a TPU for every chunk of the kh
subprogram and for bench.py. It computes, per step and on a state
u [3, nx, ny] (the structure-of-arrays image of kh's [nx, ny, 3]): primitive
recovery, the sign-bit minmod half-slopes, the face states, the HLLE or
HLLC flux through every x- and y-face, and the conservative update; for
rk_order 2 the Heun average 0.5 * (u0 + E(E(u0))).

- `advance_n_plain` is the plain PyTorch version. It copies the TPU
  kernel's arithmetic, which is not quite the scheme's
  (schemes/iso2d_grid.py): the half-slope with 0.5 * theta and 0.25 folded
  in (mara3_tpu/kernels/iso2d_step.py::_plm_half), the solvers' own
  operation order (_hlle_1d, _hllc_1d), the update as `* dtdx`
  (iso2d_step_v4.py::_step_stripe), with periodic neighbors from torch.roll
  on both axes. The scalars are cast to the state's dtype first, as the
  TPU kernel casts them.
- `advance_n_cuda` is the kernel's wrapper (csrc/iso2d_step.cu: one launch
  per stage, all n steps issued by one C call on the current stream);
  `advance_n_cuda.launches` counts its calls that launch. Each stage is the
  column march of csrc/iso2d_march.cuh, which kernel B9 (iso2d_step_v4.py)
  runs too: CTAs of 64 columns marching down chunks of up to 64 rows, each
  half-slope and face computed once; `kernel_info` reads the built
  kernel's registers, shared memory and occupancy.
- `advance_n` takes the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor; it never falls back from one to the other.

Not ported, being TPU mechanisms: the padded wrap-row buffers, the 8/128
alignment rules, stage_loop, the hand double-buffered DMA,
input_output_aliases and the VMEM limit. The kernel takes any n >= 0 and
any nx, ny >= 4.
"""

from __future__ import annotations

import ctypes

import torch

RIEMANN = ("hlle", "hllc")
MIN_CELLS = 4     # the smallest extent the kernel takes on either axis


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def _plm_half(yl, y0, yr, half_theta):
    """0.5 * the minmod slope: copysign(min |.|, a) when the three sign bits
    agree, else 0 (mara3_tpu/kernels/iso2d_step.py:58-78)."""
    a = (y0 - yl) * half_theta
    b = (yr - yl) * 0.25
    c = (yr - y0) * half_theta
    sa, sb, sc = torch.signbit(a), torch.signbit(b), torch.signbit(c)
    same = (sa == sb) & (sb == sc)
    minabs = torch.minimum(torch.minimum(torch.abs(a), torch.abs(b)),
                           torch.abs(c))
    return torch.where(same, torch.copysign(minabs, a),
                       torch.zeros_like(a))


def _hlle_1d(sgl, vnl, vtl, sgr, vnr, vtr, cs2, cs):
    """HLLE flux along the face normal from (density, normal velocity,
    transverse velocity) face states: (f_sigma, f_pn, f_pt)
    (mara3_tpu/kernels/iso2d_step.py:81-100)."""
    ap = torch.clamp(torch.maximum(vnl + cs, vnr + cs), min=0.0)
    am = torch.clamp(torch.minimum(vnl - cs, vnr - cs), max=0.0)
    ul1, ul2 = sgl * vnl, sgl * vtl
    ur1, ur2 = sgr * vnr, sgr * vtr
    pl_, pr_ = sgl * cs2, sgr * cs2
    fl0, fl1, fl2 = vnl * sgl, vnl * ul1 + pl_, vnl * ul2
    fr0, fr1, fr2 = vnr * sgr, vnr * ur1 + pr_, vnr * ur2
    den = torch.reciprocal(ap - am)     # 1 / (ap - am), then multiply
    return ((fl0 * ap - fr0 * am - (sgl - sgr) * ap * am) * den,
            (fl1 * ap - fr1 * am - (ul1 - ur1) * ap * am) * den,
            (fl2 * ap - fr2 * am - (ul2 - ur2) * ap * am) * den)


def _hllc_1d(sgl, vnl, vtl, sgr, vnr, vtr, cs2, cs):
    """HLLC flux (Toro 3rd ed. sec 10.6, isothermal) along the face normal:
    (f_sigma, f_pn, f_pt) (mara3_tpu/kernels/iso2d_step.py:103-144)."""
    pl_, pr_ = sgl * cs2, sgr * cs2
    ppvrs = 0.5 * (pl_ + pr_) - 0.25 * (vnr - vnl) * (sgl + sgr) * cs
    pstar = torch.clamp(ppvrs, min=0.0)
    ql = torch.clamp(torch.sqrt(pstar / pl_), min=1.0)
    qr = torch.clamp(torch.sqrt(pstar / pr_), min=1.0)
    sl = vnl - cs * ql
    sr = vnr + cs * qr
    kl = sgl * (sl - vnl)
    kr = sgr * (sr - vnr)
    sstar = (pr_ - pl_ + vnl * kl - vnr * kr) / (kl - kr)
    ul1, ul2 = sgl * vnl, sgl * vtl
    ur1, ur2 = sgr * vnr, sgr * vtr
    fl0, fl1, fl2 = vnl * sgl, vnl * ul1 + pl_, vnl * ul2
    fr0, fr1, fr2 = vnr * sgr, vnr * ur1 + pr_, vnr * ur2
    dl = kl / (sl - sstar)
    dr = kr / (sr - sstar)
    fls = (fl0 + sl * (dl - sgl), fl1 + sl * (dl * sstar - ul1),
           fl2 + sl * (dl * vtl - ul2))
    frs = (fr0 + sr * (dr - sgr), fr1 + sr * (dr * sstar - ur1),
           fr2 + sr * (dr * vtr - ur2))
    use_l, use_ls, use_rs = sl >= 0.0, sstar >= 0.0, sr >= 0.0
    return tuple(
        torch.where(use_l, a, torch.where(use_ls, b, torch.where(use_rs, c, d)))
        for a, b, c, d in zip((fl0, fl1, fl2), fls, frs, (fr0, fr1, fr2)))


_SOLVERS = {"hlle": _hlle_1d, "hllc": _hllc_1d}


def _scalars(u, cs2, dtdx, dtdy, theta):
    """The physics scalars as 0-d tensors in u's dtype (cast first, as the
    TPU kernel casts its scalar operands), with cs = sqrt(cs2) and
    0.5 * theta formed in that dtype."""
    s = lambda v: torch.tensor(v, dtype=u.dtype, device=u.device)
    cs2_, theta_ = s(cs2), s(theta)
    return cs2_, torch.sqrt(cs2_), s(dtdx), s(dtdy), 0.5 * theta_


def _step(u, scalars, riemann):
    """One forward-Euler step of the periodic state u [3, nx, ny]
    (mara3_tpu/kernels/iso2d_step_v4.py::_step_stripe, periodic in x too)."""
    cs2, cs, dtdx, dtdy, half_theta = scalars
    solve = _SOLVERS[riemann]
    sg = u[0]
    vx = u[1] / sg
    vy = u[2] / sg

    def faces(q, dim):
        # L/R states at face i+1/2 for every i: L = q_i + gh_i,
        # R = q_{i+1} - gh_{i+1}
        gh = _plm_half(torch.roll(q, 1, dim), q, torch.roll(q, -1, dim),
                       half_theta)
        return q + gh, torch.roll(q - gh, -1, dim)

    (sgl, sgr), (vxl, vxr), (vyl, vyr) = (faces(q, 0) for q in (sg, vx, vy))
    fx = solve(sgl, vxl, vyl, sgr, vxr, vyr, cs2, cs)
    (sgl, sgr), (vxl, vxr), (vyl, vyr) = (faces(q, 1) for q in (sg, vx, vy))
    fy0, fy2, fy1 = solve(sgl, vyl, vxl, sgr, vyr, vxr, cs2, cs)
    # for y faces the normal is vy: the solver's f_pn is the y-momentum flux
    return torch.stack([
        u[q] - ((f - torch.roll(f, 1, 0)) * dtdx
                + (g - torch.roll(g, 1, 1)) * dtdy)
        for q, f, g in zip(range(3), fx, (fy0, fy1, fy2))])


def _check_args(u, n, rk_order, riemann):
    if u.dim() != 3 or u.shape[0] != 3:
        raise ValueError(f"iso2d advance takes u [3, nx, ny], not "
                         f"{tuple(u.shape)}")
    if min(u.shape[1], u.shape[2]) < MIN_CELLS:
        raise ValueError(f"iso2d advance takes nx, ny >= {MIN_CELLS}, not "
                         f"{tuple(u.shape[1:])}")
    if n < 0:
        raise ValueError(f"iso2d advance takes n >= 0, not {n}")
    if rk_order not in (1, 2):
        raise ValueError(f"iso2d advance takes rk_order 1 or 2, not "
                         f"{rk_order}")
    if riemann not in RIEMANN:
        raise ValueError(f"iso2d advance takes riemann hlle or hllc, not "
                         f"{riemann!r}")


def advance_n_plain(u, n: int, *, cs2: float, dtdx: float, dtdy: float,
                    theta: float = 1.8, rk_order: int = 1,
                    riemann: str = "hlle"):
    """n periodic steps of u [3, nx, ny]: what advance_n_pallas_v5 computes,
    as torch ops on u's device."""
    _check_args(u, n, rk_order, riemann)
    scalars = _scalars(u, cs2, dtdx, dtdy, theta)
    for _ in range(n):
        if rk_order == 1:
            u = _step(u, scalars, riemann)
        else:
            u = 0.5 * (u + _step(_step(u, scalars, riemann), scalars,
                                 riemann))
    return u


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_double = ctypes.c_double


def _library():
    """The built csrc/iso2d_step.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("iso2d_step")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b1_advance_n_f32, lib.b1_advance_n_f64):
            fn.argtypes = ([_c_void_p] * 3 + [_c_int] * 5 + [_c_double] * 4
                           + [_c_void_p])
            fn.restype = _c_int
        lib.b1_kernel_info.argtypes = [_c_int] * 2 + [ctypes.POINTER(_c_int)]
        lib.b1_kernel_info.restype = _c_int
        lib.b1_error_string.argtypes = [_c_int]
        lib.b1_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def march_info(entry, error_string, dtype, riemann):
    """The march kernel's resources for dtype, through a library's `entry`
    (b1_kernel_info or b9_kernel_info): registers and local_bytes a thread,
    static_smem a CTA, ctas_per_sm (the occupancy calculator's on the
    current card)."""
    out = (_c_int * 4)()
    rc = entry(int(dtype == torch.float64), RIEMANN.index(riemann), out)
    if rc != 0:
        raise RuntimeError("march kernel info: "
                           + error_string(rc).decode())
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "ctas_per_sm"), out))


def kernel_info(dtype, riemann: str = "hlle"):
    """B1's march kernel's resources (march_info)."""
    lib = _library()
    return march_info(lib.b1_kernel_info, lib.b1_error_string, dtype,
                      riemann)


def advance_n_cuda(u, n: int, *, cs2: float, dtdx: float, dtdy: float,
                   theta: float = 1.8, rk_order: int = 1,
                   riemann: str = "hlle"):
    """Kernel B1 on a contiguous float32 or float64 CUDA tensor u [3, nx,
    ny]: a new tensor with n steps applied (u is not written). Raises if
    the kernel does not build or a launch fails."""
    _check_args(u, n, rk_order, riemann)
    if u.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"advance_n_cuda takes float32 or float64, not "
                         f"{u.dtype}")
    if not u.is_contiguous():
        raise ValueError("advance_n_cuda takes a contiguous tensor")
    if u.device.type != "cuda":
        raise ValueError(f"advance_n_cuda takes a CUDA tensor, not one on "
                         f"{u.device}")
    if n == 0:
        return u.clone()
    lib = _library()
    out = torch.empty_like(u)
    scratch = torch.empty_like(u)
    fn = lib.b1_advance_n_f32 if u.dtype == torch.float32 \
        else lib.b1_advance_n_f64
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = fn(u.data_ptr(), out.data_ptr(), scratch.data_ptr(), u.shape[1],
            u.shape[2], n, rk_order, RIEMANN.index(riemann), cs2, dtdx, dtdy,
            theta, stream)
    if rc != 0:
        raise RuntimeError("iso2d_step kernel launch failed: "
                           + lib.b1_error_string(rc).decode())
    advance_n_cuda.launches += 1
    return out


advance_n_cuda.launches = 0


def advance_n(u, n: int, *, cs2: float, dtdx: float, dtdy: float,
              theta: float = 1.8, rk_order: int = 1, riemann: str = "hlle"):
    """n steps of u [3, nx, ny] in one call: the plain version for a CPU
    tensor, kernel B1 for a CUDA tensor."""
    kw = dict(cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta, rk_order=rk_order,
              riemann=riemann)
    if u.device.type == "cpu":
        return advance_n_plain(u, n, **kw)
    if u.device.type == "cuda":
        return advance_n_cuda(u, n, **kw)
    raise ValueError(f"no iso2d advance for a tensor on {u.device}")
