"""Kernel B4: the cloud subprogram's SRHD stage on the (r, theta) mesh, as a
CUDA kernel beside its plain PyTorch version.

Replaces the four Pallas entries of mara3_tpu/kernels/cloud_update.py, which
the JAX package runs on a TPU for the cloud subprogram:

- B4a `flux_update` (:200 fused_flux_update): a stage after recovery, from
  the BC-extended primitives Pe [5, nr + 2, nq];
- B4b `stage` (:462 fused_stage): one stage, the SRHD Newton inside;
- B4c `step_rk2` (:770 fused_step_rk2): a whole RK2 step, two stages and
  the Shu-Osher average 0.5 u0 + 0.5 u2;
- B4d `run_n` (:910 fused_run_rk2): n whole steps (rk 1 or 2) from the
  inflow stack [n + 1, 5, nq], step s reading rows s and s + 1. Unlike the
  TPU entry it takes any n >= 1, odd too.

States are SoA: u [5, nr, nq] extrinsic (U * dv per cell), the warm
pressure p [nr, nq]. A stage returns (u1, p1) with p1 the recovered pressure
of its input, floored at tfloor D / W: the next stage's warm start.

The arithmetic is the TPU kernel's, which is not quite the scheme's
(subprograms/cloud._flux_update): u is multiplied by 1/dv; the Newton is the
reciprocal-first one of kernels/srhd_recover.py from max(p_guess, 0); the
HLLE is spelled rsqrt-first and reciprocal-first (:57-101); the sources
multiply by 1/r (:446-454); the PLM signs are taken by a >= 0 (:46-54); dt
and the scalars are cast to the state's dtype. Both versions take the same
`Geometry`, formed in torch ops from the vertices in the state's dtype:
dv [nr, nq], dAr [nr + 1, nq], dAq [nr, nq + 1], 1/rc [nr] and cot(qc)
[nq].

- `*_plain` are the plain PyTorch versions;
- `*_cuda` are the kernel's wrappers (csrc/cloud_update.cu: one launch a
  stage, all of a call's stages issued by one C call on the current
  stream); `<wrapper>.launches` counts a wrapper's calls that launch;
- `flux_update`, `stage`, `step_rk2` and `run_n` take the plain version for
  a tensor on the CPU and the kernel for a CUDA tensor; they never fall back
  from one to the other.

Not ported, being TPU mechanisms: the TX row tiles, the 8-row alignment and
the manual-DMA padding rows, NQ % 128, the lane rolls and the VMEM limit.
The kernel takes any nr >= 3 and nq >= 3.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from mara3_tpu_torch.kernels import srhd_recover

GAMMA = 4.0 / 3.0
K = 1.0 + 1.0 / (GAMMA - 1.0)     # rho h = rho + p K
METHODS = (1, 2)                  # reconstruct_method: 1 pcm, 2 plm
MIN_CELLS = 3


class Geometry(NamedTuple):
    """The stage's geometry in the state's dtype (subprograms/cloud.py
    kernel_geometry forms it from the vertices)."""
    dv: torch.Tensor     # [nr, nq] cell volumes
    dAr: torch.Tensor    # [nr + 1, nq] radial face areas
    dAq: torch.Tensor    # [nr, nq + 1] polar face areas
    invr: torch.Tensor   # [nr] 1 / rc
    cotq: torch.Tensor   # [nq] tan(pi/2 - qc)


def _check(u, geo: Geometry, method, what):
    if u.dim() != 3 or u.shape[0] != 5:
        raise ValueError(f"{what} takes u [5, nr, nq], not {tuple(u.shape)}")
    nr, nq = u.shape[1], u.shape[2]
    if nr < MIN_CELLS or nq < MIN_CELLS:
        raise ValueError(f"{what} takes nr >= {MIN_CELLS} and nq >= "
                         f"{MIN_CELLS}, not {nr} x {nq}")
    want = {"dv": (nr, nq), "dAr": (nr + 1, nq), "dAq": (nr, nq + 1),
            "invr": (nr,), "cotq": (nq,)}
    for name, shape in want.items():
        g = getattr(geo, name)
        if tuple(g.shape) != shape:
            raise ValueError(f"{what} takes {name} {list(shape)}, not "
                             f"{list(g.shape)}")
        if g.device != u.device or g.dtype != u.dtype:
            raise ValueError(f"{name} is {g.dtype} on {g.device}, u "
                             f"{u.dtype} on {u.device}")
    if method not in METHODS:
        raise ValueError(f"{what} takes reconstruct_method 1 (pcm) or 2 "
                         f"(plm), not {method!r}")


def _check_rows(t, shape, name, u):
    """t has `shape` (None: any) and u's dtype and device."""
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name} must be {list(shape)}, not "
                         f"{list(t.shape)}")
    if t.device != u.device or t.dtype != u.dtype:
        raise ValueError(f"{name} is {t.dtype} on {t.device}, u {u.dtype} "
                         f"on {u.device}")


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def _rcp(x):
    """The exact (correctly rounded) reciprocal, pl.reciprocal(approx=False)."""
    return torch.reciprocal(x)


def _sign(a):
    """1 where a >= 0, else -1 (NaN too), in a's dtype."""
    one = torch.ones_like(a)
    return torch.where(a >= 0, one, -one)


def _plm(yl, y0, yr, theta):
    """cloud_update.py:46-54."""
    a = (y0 - yl) * theta
    b = (yr - yl) * 0.5
    c = (yr - y0) * theta
    sa, sb, sc = _sign(a), _sign(b), _sign(c)
    mn = torch.minimum(torch.minimum(torch.abs(a), torch.abs(b)),
                       torch.abs(c))
    return 0.25 * torch.abs(sa + sb) * (sa + sc) * mn


def _hlle_t(Pl, Pr, axis):
    """The reciprocal-first, rsqrt-first HLLE along r (axis 0) or theta
    (axis 1) of cloud_update.py:57-101."""

    def side(P):
        rho, u1, u2, u3, p = P
        uu = u1 * u1 + u2 * u2 + u3 * u3
        invW = torch.rsqrt(1.0 + uu)
        W = (1.0 + uu) * invW
        hd = rho + p * K
        D = rho * W
        U = (D, W * u1 * hd, W * u2 * hd, W * u3 * hd, W * W * hd - p - D)
        un = u1 if axis == 0 else u2
        vn = un * invW
        c2 = GAMMA * p * _rcp(hd)
        vv = 1.0 - invW * invW
        v2 = vn * vn
        k0 = torch.sqrt(c2 * (1.0 - vv) * (1.0 - vv * c2 - v2 * (1.0 - c2)))
        invd = _rcp(1.0 - vv * c2)
        am = (vn * (1.0 - c2) - k0) * invd
        ap = (vn * (1.0 - c2) + k0) * invd
        F = [vn * U[0], vn * U[1], vn * U[2], vn * U[3], vn * U[4] + p * vn]
        F[1 + axis] = F[1 + axis] + p
        return U, F, am, ap

    Ul, Fl, alm, alp = side(Pl)
    Ur, Fr, arm, arp = side(Pr)
    ap = torch.clamp(torch.maximum(alp, arp), min=0.0)
    am = torch.clamp(torch.minimum(alm, arm), max=0.0)
    inv = _rcp(ap - am)
    return tuple((fl * ap - fr * am - (ul - ur) * ap * am) * inv
                 for fl, fr, ul, ur in zip(Fl, Fr, Ul, Ur))


def _faces(c, axis, theta, method):
    """(L, R) at the faces between neighbours along `axis` of c, with the
    limited slopes zero at both ends of the axis (the guard rows, the pole
    columns)."""
    n = c.shape[axis]
    lo, hi = c.narrow(axis, 0, n - 1), c.narrow(axis, 1, n - 1)
    if method == 1:
        return lo, hi
    g = _plm(c.narrow(axis, 0, n - 2), c.narrow(axis, 1, n - 2),
             c.narrow(axis, 2, n - 2), theta)
    pad = torch.zeros_like(c.narrow(axis, 0, 1))
    g = torch.cat([pad, g, pad], dim=axis)
    return (lo + 0.5 * g.narrow(axis, 0, n - 1),
            hi - 0.5 * g.narrow(axis, 1, n - 1))


def _update(Pe, u, geo: Geometry, dt, theta, method):
    """The stage after recovery: u [5, nr, nq] updated from the
    BC-extended primitives Pe (5-tuple of [nr + 2, nq]) and the geometry."""
    dt = torch.full((), dt, dtype=u.dtype, device=u.device)
    # radial: the nr + 1 faces of the extended rows
    LR = [_faces(c, 0, theta, method) for c in Pe]
    Fr = _hlle_t(tuple(l for l, _ in LR), tuple(r for _, r in LR), 0)
    lr = tuple(-(f[1:] * geo.dAr[1:] - f[:-1] * geo.dAr[:-1]) for f in Fr)
    # polar: the nq - 1 interior faces, zero flux through both poles
    P = tuple(c[1:-1] for c in Pe)
    LR = [_faces(c, 1, theta, method) for c in P]
    Fq = _hlle_t(tuple(l for l, _ in LR), tuple(r for _, r in LR), 1)
    Fq = tuple(torch.nn.functional.pad(f, (1, 1)) for f in Fq)
    lq = tuple(f[:, :-1] * geo.dAq[:, :-1] - f[:, 1:] * geo.dAq[:, 1:]
               for f in Fq)
    # the spherical sources (cloud_update.py:446-454)
    rho, ur, uq, up, pg = P
    invr = geo.invr[:, None]
    cotq = geo.cotq[None, :]
    H = rho + pg * K
    z = torch.zeros_like(pg)
    s0 = (z,
          (2.0 * pg + H * (uq * uq + up * up)) * invr,
          (cotq * pg + H * (up * up * cotq - ur * uq)) * invr,
          -up * H * (ur + uq * cotq) * invr,
          z)
    return torch.stack([u[k] + (lr[k] + lq[k] + s0[k] * geo.dv) * dt
                        for k in range(5)])


def flux_update_plain(Pe, u0, geo: Geometry, dt: float, plm_theta: float,
                      method: int):
    """B4a: u0 [5, nr, nq] updated from the BC-extended primitives Pe
    [5, nr + 2, nq] (the inflow guard row, the interior, the zero-gradient
    guard row)."""
    _check(u0, geo, method, "flux_update")
    _check_rows(Pe, (5, u0.shape[1] + 2, u0.shape[2]), "Pe", u0)
    return _update(tuple(Pe[k] for k in range(5)), u0, geo, dt, plm_theta,
                   method)


def _recover(u, p_guess, geo: Geometry, tfloor):
    """The primitives of u [5, nr, nq] from max(p_guess, 0), floored."""
    inv_dv = _rcp(geo.dv)
    Ut = tuple(u[k] * inv_dv for k in range(5))
    Pt, _, _, _ = srhd_recover.recover_window(
        Ut, torch.clamp(p_guess, min=0.0), tfloor)
    return Pt


def _stage(inflow, u, p, geo, dt, theta, method, tfloor):
    Pt = _recover(u, p, geo, tfloor)
    Pe = tuple(torch.cat([inflow[k][None], c, c[-1:]]) for k, c in
               enumerate(Pt))
    return _update(Pe, u, geo, dt, theta, method), Pt[4]


def _check_stage(inflows, u, p_guess, geo, method, what):
    _check(u, geo, method, what)
    _check_rows(p_guess, u.shape[1:], "p_guess", u)
    if inflows.dim() != 3 or tuple(inflows.shape[1:]) != (5, u.shape[2]):
        raise ValueError(f"{what} takes inflow rows [n + 1, 5, nq], not "
                         f"{list(inflows.shape)}")
    _check_rows(inflows, None, "inflow", u)


def run_n_plain(inflows, u, p_guess, geo: Geometry, dt: float,
                plm_theta: float, method: int, tfloor: float, rk: int = 2):
    """B4d: n = inflows.shape[0] - 1 whole steps of u [5, nr, nq] from the
    warm pressure p_guess [nr, nq]; step s takes inflow row s (and s + 1 for
    rk 2's second stage). Returns (u, the last stage's pressure)."""
    _check_stage(inflows, u, p_guess, geo, method, "run_n")
    if rk not in (1, 2):
        raise ValueError(f"run_n takes rk 1 or 2, not {rk!r}")
    p = p_guess
    for s in range(inflows.shape[0] - 1):
        u1, p = _stage(inflows[s], u, p, geo, dt, plm_theta, method, tfloor)
        if rk == 2:
            u2, p = _stage(inflows[s + 1], u1, p, geo, dt, plm_theta,
                           method, tfloor)
            u1 = 0.5 * u + 0.5 * u2
        u = u1
    return u, p


def stage_plain(inflow, u, p_guess, geo: Geometry, dt: float,
                plm_theta: float, method: int, tfloor: float):
    """B4b: one stage of u with the inflow row [5, nq]: (u1, p1)."""
    return run_n_plain(torch.stack([inflow, inflow]), u, p_guess, geo, dt,
                       plm_theta, method, tfloor, rk=1)


def step_rk2_plain(inflow1, inflow2, u, p_guess, geo: Geometry, dt: float,
                   plm_theta: float, method: int, tfloor: float):
    """B4c: one RK2 step with the inflow rows at t and t + dt: (u, p2)."""
    return run_n_plain(torch.stack([inflow1, inflow2]), u, p_guess, geo, dt,
                       plm_theta, method, tfloor, rk=2)


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_double = ctypes.c_double


def _library():
    """The built csrc/cloud_update.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("cloud_update")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b4_run_f32, lib.b4_run_f64):
            fn.argtypes = ([_c_void_p] * 13 + [_c_int] * 5 + [_c_double] * 4
                           + [_c_void_p])
            fn.restype = _c_int
        for fn in (lib.b4_flux_update_f32, lib.b4_flux_update_f64):
            fn.argtypes = ([_c_void_p] * 8 + [_c_int] * 3 + [_c_double] * 3
                           + [_c_void_p])
            fn.restype = _c_int
        lib.b4_error_string.argtypes = [_c_int]
        lib.b4_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def _check_cuda(u, geo: Geometry, what, *more):
    if u.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"{what} takes float32 or float64, not {u.dtype}")
    if not all(t.is_contiguous() for t in (u, *geo, *more)):
        raise ValueError(f"{what} takes contiguous tensors")
    if u.device.type != "cuda":
        raise ValueError(f"{what} takes CUDA tensors, not ones on "
                         f"{u.device}")


def _raise_on(lib, rc):
    if rc != 0:
        raise RuntimeError("cloud_update kernel launch failed: "
                           + lib.b4_error_string(rc).decode())


def _geo_ptrs(geo: Geometry):
    return (geo.dv.data_ptr(), geo.dAr.data_ptr(), geo.dAq.data_ptr(),
            geo.invr.data_ptr(), geo.cotq.data_ptr())


def _run_cuda(inflows, u, p_guess, geo, dt, theta, method, tfloor, rk):
    """The C loop over the n rk stages; returns (u, p)."""
    lib = _library()
    n = inflows.shape[0] - 1
    out, scr, st = (torch.empty_like(u) for _ in range(3))
    p_out, p_scr = torch.empty_like(p_guess), torch.empty_like(p_guess)
    fn = lib.b4_run_f32 if u.dtype == torch.float32 else lib.b4_run_f64
    stream = torch.cuda.current_stream(u.device).cuda_stream
    _raise_on(lib, fn(u.data_ptr(), out.data_ptr(), scr.data_ptr(),
                      st.data_ptr(), p_guess.data_ptr(), p_out.data_ptr(),
                      p_scr.data_ptr(), inflows.data_ptr(), *_geo_ptrs(geo),
                      u.shape[1], u.shape[2], n, rk, method, dt, theta,
                      tfloor, GAMMA, stream))
    return out, p_out


def flux_update_cuda(Pe, u0, geo: Geometry, dt: float, plm_theta: float,
                     method: int):
    """B4a on contiguous float32 or float64 CUDA tensors: a new u1."""
    _check(u0, geo, method, "flux_update")
    _check_rows(Pe, (5, u0.shape[1] + 2, u0.shape[2]), "Pe", u0)
    _check_cuda(u0, geo, "flux_update_cuda", Pe)
    lib = _library()
    out = torch.empty_like(u0)
    fn = lib.b4_flux_update_f32 if u0.dtype == torch.float32 \
        else lib.b4_flux_update_f64
    stream = torch.cuda.current_stream(u0.device).cuda_stream
    _raise_on(lib, fn(Pe.data_ptr(), u0.data_ptr(), out.data_ptr(),
                      *_geo_ptrs(geo), u0.shape[1], u0.shape[2], method, dt,
                      plm_theta, GAMMA, stream))
    flux_update_cuda.launches += 1
    return out


def stage_cuda(inflow, u, p_guess, geo: Geometry, dt: float,
               plm_theta: float, method: int, tfloor: float):
    """B4b on CUDA tensors: (u1, p1), one launch."""
    rows = inflow[None]
    _check_stage(rows, u, p_guess, geo, method, "stage")
    _check_cuda(u, geo, "stage_cuda", p_guess, rows)
    out = _run_cuda(torch.cat([rows, rows]), u, p_guess, geo, dt, plm_theta,
                    method, tfloor, 1)
    stage_cuda.launches += 1
    return out


def step_rk2_cuda(inflow1, inflow2, u, p_guess, geo: Geometry, dt: float,
                  plm_theta: float, method: int, tfloor: float):
    """B4c on CUDA tensors: (u, p2), two stage launches."""
    rows = torch.stack([inflow1, inflow2])
    _check_stage(rows, u, p_guess, geo, method, "step_rk2")
    _check_cuda(u, geo, "step_rk2_cuda", p_guess, rows)
    out = _run_cuda(rows, u, p_guess, geo, dt, plm_theta, method, tfloor, 2)
    step_rk2_cuda.launches += 1
    return out


def run_n_cuda(inflows, u, p_guess, geo: Geometry, dt: float,
               plm_theta: float, method: int, tfloor: float, rk: int = 2):
    """B4d on CUDA tensors: (u, p) after n = inflows.shape[0] - 1 steps,
    n rk stage launches issued by one C call. u and p_guess are not
    written."""
    _check_stage(inflows, u, p_guess, geo, method, "run_n")
    if rk not in (1, 2):
        raise ValueError(f"run_n takes rk 1 or 2, not {rk!r}")
    _check_cuda(u, geo, "run_n_cuda", p_guess, inflows)
    if inflows.shape[0] == 1:
        return u.clone(), p_guess.clone()
    out = _run_cuda(inflows, u, p_guess, geo, dt, plm_theta, method, tfloor,
                    rk)
    run_n_cuda.launches += 1
    return out


flux_update_cuda.launches = 0
stage_cuda.launches = 0
step_rk2_cuda.launches = 0
run_n_cuda.launches = 0


def _dispatch(plain, cuda, u, args):
    if u.device.type == "cpu":
        return plain(*args)
    if u.device.type == "cuda":
        return cuda(*args)
    raise ValueError(f"no cloud_update kernel for a tensor on {u.device}")


def flux_update(Pe, u0, geo, dt, plm_theta, method):
    """B4a: the plain version for a CPU tensor, the kernel for a CUDA one."""
    return _dispatch(flux_update_plain, flux_update_cuda, u0,
                     (Pe, u0, geo, dt, plm_theta, method))


def stage(inflow, u, p_guess, geo, dt, plm_theta, method, tfloor):
    """B4b: the plain version for a CPU tensor, the kernel for a CUDA one."""
    return _dispatch(stage_plain, stage_cuda, u,
                     (inflow, u, p_guess, geo, dt, plm_theta, method, tfloor))


def step_rk2(inflow1, inflow2, u, p_guess, geo, dt, plm_theta, method,
             tfloor):
    """B4c: the plain version for a CPU tensor, the kernel for a CUDA one."""
    return _dispatch(step_rk2_plain, step_rk2_cuda, u,
                     (inflow1, inflow2, u, p_guess, geo, dt, plm_theta,
                      method, tfloor))


def run_n(inflows, u, p_guess, geo, dt, plm_theta, method, tfloor, rk=2):
    """B4d: the plain version for a CPU tensor, the kernel for a CUDA one."""
    return _dispatch(run_n_plain, run_n_cuda, u,
                     (inflows, u, p_guess, geo, dt, plm_theta, method,
                      tfloor, rk))
