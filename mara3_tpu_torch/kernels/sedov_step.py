"""Kernel B5: n 1D log-radial sedov steps (Euler, or SRHD with its Newton
recovery) as a CUDA kernel beside its plain PyTorch version.

Replaces mara3_tpu/kernels/sedov_step.py:250 (advance_n_pallas), the
Pallas kernel the JAX package runs on a TPU for every chunk of the sedov
subprogram. Per step, on the extrinsic state u [nr, 5] (U * dv per cell):
primitive recovery (Euler's algebraic one, or the SRHD Newton of
kernels/srhd_recover.py warm-started from the previous step's pressure),
pcm, plm or weno5 face states with a reflecting inner guard (the velocity
flips sign) and zero-gradient outer guards, the HLLE flux through all nr + 1
faces, the spherical source, and the update
u + (-(F[r+1] dA[r+1] - F[r] dA[r]) + s dv) dt.

The arithmetic is the TPU kernel's, which is not quite the scheme's
(subprograms/sedov._step): 1/dv is taken once and multiplied in; the
geometry (dv, r0^2, r1^2, rc) is formed from the vertices in their dtype and
then cast to the state's, as is dt; SRHD recovers by the reciprocal-first
Newton. One more place where it departs from the scheme, the TPU
kernel's and copied as it is: the warm start (warm=True). Each step's Newton
starts from the pressure the previous step converged to, and the first step
of every call from 0, so results depend on how a run is cut into calls (by
less than the Newton's stopping tolerance).

One place where the TPU kernel departs from the scheme is not copied: it
reconstructs weno5's right state at the outer face nr from the cells
(nr-1, nr-1, nr-1, nr-2, nr-3) (mara3_tpu/kernels/sedov_step.py:221-222).
This kernel uses the scheme's zero-gradient stencil, (nr-1, nr-1, nr-1,
nr-1, nr-2), so it agrees with the JAX B5 only while the outer three cells
are equal, as they are in every sedov run until the blast reaches the edge.

- `advance_n_plain` is the plain PyTorch version;
- `advance_n_cuda` is the kernel's wrapper (csrc/sedov_step.cu: one launch
  a step, all n issued by one C call on the current stream);
  `advance_n_cuda.launches` counts its calls that launch;
- `advance_n` takes the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor; it never falls back from one to the other.

Not ported, being TPU mechanisms: the [5, S, L] fold and its lane and
sublane rolls, the masked scalar reads, the 128-cell rule and the VMEM
limit. The kernel takes any nr >= 3 and n >= 0.
"""

from __future__ import annotations

import ctypes

import torch

from mara3_tpu_torch.core.ops import div_scalar
from mara3_tpu_torch.kernels import srhd_recover
from mara3_tpu_torch.mathx.plm import plm_gradient
from mara3_tpu_torch.mathx.weno import _weno5_left
from mara3_tpu_torch.physics import euler, srhd

METHODS = ("pcm", "plm", "weno5")
SYSTEMS = ("euler", "srhd")
MIN_CELLS = 3     # the mirrored inner guards are the first three cells
_REFL = (1.0, -1.0, 1.0, 1.0, 1.0)
_NHAT = (1.0, 0.0, 0.0)
_GUARDS = 3


def geometry(vertices, dtype):
    """[4, nr]: dv, r0^2, r1^2 and rc, formed in the vertices' dtype, then
    cast to `dtype` (sedov_step.py:273-278)."""
    r0, r1 = vertices[:-1], vertices[1:]
    dv = div_scalar(r1 * (r1 * r1) - r0 * (r0 * r0), 3.0)
    rc = 0.5 * (r0 + r1)
    return torch.stack([dv, r0 * r0, r1 * r1, rc]).to(dtype)


def _check_args(u, vertices, n, reconstruct, system, gamma):
    if u.dim() != 2 or u.shape[1] != 5:
        raise ValueError(f"sedov advance takes u [nr, 5], not "
                         f"{tuple(u.shape)}")
    if u.shape[0] < MIN_CELLS:
        raise ValueError(f"sedov advance takes nr >= {MIN_CELLS}, not "
                         f"{u.shape[0]}")
    if vertices.dim() != 1 or vertices.shape[0] != u.shape[0] + 1:
        raise ValueError(f"sedov advance takes vertices [nr + 1], not "
                         f"{tuple(vertices.shape)} for nr = {u.shape[0]}")
    if vertices.device != u.device:
        raise ValueError(f"vertices on {vertices.device}, u on {u.device}")
    if n < 0:
        raise ValueError(f"sedov advance takes n >= 0, not {n}")
    if reconstruct not in METHODS:
        raise ValueError(f"sedov advance takes reconstruct pcm, plm or "
                         f"weno5, not {reconstruct!r}")
    if system not in SYSTEMS:
        raise ValueError(f"sedov advance takes system euler or srhd, not "
                         f"{system!r}")
    if system == "srhd" and abs(gamma - srhd_recover.GAMMA) > 1e-12:
        raise ValueError("the in-kernel srhd Newton is written for "
                         "gamma = 4/3")


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def _face_states(Pt, reconstruct, theta):
    """(L, R) 5-tuples at the nr + 1 faces, every face through the
    scheme's guards."""
    nr = Pt[0].shape[0]
    Ls, Rs = [], []
    for c, sgn in zip(Pt, _REFL):
        # ext[j + 3] = cell j for j in -3 .. nr + 2: mirrored with the sign
        # inside, zero-gradient outside (sedov._extend_bc with 3 guards)
        ext = torch.cat([(sgn * c[:_GUARDS]).flip(0), c,
                         c[-1:].expand(_GUARDS)])

        def cells(k):     # cell f + k at the faces f = 0 .. nr
            return ext[_GUARDS + k:_GUARDS + k + nr + 1]

        if reconstruct == "pcm":
            L, R = cells(-1), cells(0)
        elif reconstruct == "plm":
            # the limited slopes of cells -2 .. nr + 1
            g = plm_gradient(ext[:-2], ext[1:-1], ext[2:], theta)
            L = cells(-1) + 0.5 * g[1:nr + 2]
            R = cells(0) - 0.5 * g[2:nr + 3]
        else:
            L = _weno5_left(cells(-3), cells(-2), cells(-1), cells(0),
                            cells(1))
            R = _weno5_left(cells(2), cells(1), cells(0), cells(-1),
                            cells(-2))
        Ls.append(L)
        Rs.append(R)
    if reconstruct == "weno5":
        # positivity fallback to the first-order states
        bad = (Ls[0] <= 0.0) | (Ls[4] <= 0.0) | (Rs[0] <= 0.0) | (Rs[4] <= 0.0)
        L0 = [torch.cat([sgn * c[:1], c]) for c, sgn in zip(Pt, _REFL)]
        R0 = [torch.cat([c, c[-1:]]) for c in Pt]
        Ls = [torch.where(bad, l0, l) for l0, l in zip(L0, Ls)]
        Rs = [torch.where(bad, r0, r) for r0, r in zip(R0, Rs)]
    return tuple(Ls), tuple(Rs)


def _step(U, geo, dt, p_prev, reconstruct, theta, gamma, system):
    """One step of U [5, nr]: (U, the converged pressure or None)."""
    dv, dal, dar, rc = geo
    inv_dv = 1.0 / dv
    Ut = tuple(U[k] * inv_dv for k in range(5))
    p_next = None
    if system == "euler":
        phys = euler
        Pt = euler.recover_primitive_t(Ut, gamma, 0.0)
    else:
        phys = srhd
        p0 = torch.zeros_like(dv) if p_prev is None else \
            torch.clamp(p_prev, min=0.0)
        Pt, p_next, _, _ = srhd_recover.recover_window(Ut, p0)
    L, R = _face_states(Pt, reconstruct, theta)
    F = phys.riemann_hlle_t(L, R, _NHAT, gamma)
    s0 = phys.spherical_geometry_source_terms_radial_t(Pt, rc, gamma)
    U = torch.stack([U[k] + (-(F[k][1:] * dar - F[k][:-1] * dal)
                             + s0[k] * dv) * dt for k in range(5)])
    return U, p_next


def advance_n_plain(u, vertices, dt: float, n: int, reconstruct="pcm",
                    plm_theta=1.5, gamma=4.0 / 3.0, system="euler",
                    warm=True):
    """n steps of the extrinsic state u [nr, 5] on the grid `vertices`
    [nr + 1]: what advance_n_pallas computes, as torch ops on u's device.
    warm=False starts every step's SRHD Newton from p = 0."""
    _check_args(u, vertices, n, reconstruct, system, gamma)
    geo = geometry(vertices, u.dtype)
    dt_ = torch.full((), dt, dtype=u.dtype, device=u.device)
    U = u.t()
    p = None
    for _ in range(n):
        U, p_conv = _step(U, geo, dt_, p, reconstruct, plm_theta, gamma,
                          system)
        p = p_conv if warm else None
    return U.t().contiguous()


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_double = ctypes.c_double


def _library():
    """The built csrc/sedov_step.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("sedov_step")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b5_advance_n_f32, lib.b5_advance_n_f64):
            fn.argtypes = ([_c_void_p] * 6 + [_c_int] * 5 + [_c_double] * 3
                           + [_c_void_p])
            fn.restype = _c_int
        lib.b5_error_string.argtypes = [_c_int]
        lib.b5_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def advance_n_cuda(u, vertices, dt: float, n: int, reconstruct="pcm",
                   plm_theta=1.5, gamma=4.0 / 3.0, system="euler",
                   warm=True):
    """Kernel B5 on a contiguous float32 or float64 CUDA tensor u [nr, 5]
    with its vertices [nr + 1] on the same card: a new tensor with n steps
    applied (u is not written). Raises if the kernel does not build or a
    launch fails."""
    _check_args(u, vertices, n, reconstruct, system, gamma)
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
    geo = geometry(vertices, u.dtype).contiguous()
    out = torch.empty_like(u)
    scratch = torch.empty_like(u)
    # the SRHD warm pressure: zeroed at each call, read by a step from one
    # buffer and written to the other
    warm_srhd = system == "srhd" and warm
    pres = torch.zeros((2, u.shape[0] if warm_srhd else 0), dtype=u.dtype,
                       device=u.device)
    fn = lib.b5_advance_n_f32 if u.dtype == torch.float32 \
        else lib.b5_advance_n_f64
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = fn(u.data_ptr(), out.data_ptr(), scratch.data_ptr(), geo.data_ptr(),
            pres[0].data_ptr(), pres[1].data_ptr(), u.shape[0], n,
            METHODS.index(reconstruct) + 1, int(system == "srhd"),
            int(warm_srhd),
            dt, plm_theta, gamma, stream)
    if rc != 0:
        raise RuntimeError("sedov_step kernel launch failed: "
                           + lib.b5_error_string(rc).decode())
    advance_n_cuda.launches += 1
    return out


advance_n_cuda.launches = 0


def advance_n(u, vertices, dt: float, n: int, reconstruct="pcm",
              plm_theta=1.5, gamma=4.0 / 3.0, system="euler", warm=True):
    """n steps of u [nr, 5] in one call: the plain version for a CPU
    tensor, kernel B5 for a CUDA tensor."""
    args = (u, vertices, dt, n, reconstruct, plm_theta, gamma, system, warm)
    if u.device.type == "cpu":
        return advance_n_plain(*args)
    if u.device.type == "cuda":
        return advance_n_cuda(*args)
    raise ValueError(f"no sedov advance for a tensor on {u.device}")
