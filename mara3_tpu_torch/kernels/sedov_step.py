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
- `march_plan` is the kernel's segments, a pure function of the sizes and
  the card's limits, and `advance_n_segments` the kernel's march as plain
  PyTorch: segments recovered apart, their end primitives handed through
  an edge buffer, each segment's faces and update from its own window. It
  equals advance_n_plain bit for bit (the CPU tests hold it to that);
- `advance_n_cuda` is the kernel's wrapper (csrc/sedov_step.cu: one
  cooperative launch a call, the segment march, with the segments' state
  in shared memory where march_plan says it fits, "resident", else in
  device memory, "streaming"); `advance_n_cuda.design` names the design of
  its last call and `advance_n_cuda.launches` counts its calls that launch;
- `advance_n` takes the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor; it never falls back from one to the other.

Not ported, being TPU mechanisms: the [5, S, L] fold and its lane and
sublane rolls, the masked scalar reads, the 128-cell rule and the VMEM
limit. Keeping a segment's state on the chip for a call is this card's own
design, sized by its shared memory. The kernel takes any nr >= 3 and
n >= 0.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from mara3_tpu_torch.core.ops import div_scalar
from mara3_tpu_torch.kernels import resident_loop, srhd_recover
from mara3_tpu_torch.mathx.plm import plm_gradient
from mara3_tpu_torch.mathx.weno import _weno5_left
from mara3_tpu_torch.physics import euler, srhd

METHODS = ("pcm", "plm", "weno5")
HALO = {"pcm": 1, "plm": 2, "weno5": 3}
DESIGNS = ("resident", "streaming")
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

def _faces(ext, m, reconstruct, theta):
    """(L, R) 5-tuples at the m + 1 faces of a window of m cells, from
    ext[q][k + 3], component q of the window's cell k for k in -3 .. m + 2
    (its guards or halo included)."""
    Ls, Rs = [], []
    for e in ext:
        def cells(k):     # cell f + k at the faces f = 0 .. m
            return e[_GUARDS + k:_GUARDS + k + m + 1]

        if reconstruct == "pcm":
            L, R = cells(-1), cells(0)
        elif reconstruct == "plm":
            # the limited slopes of cells -2 .. m + 1
            g = plm_gradient(e[:-2], e[1:-1], e[2:], theta)
            L = cells(-1) + 0.5 * g[1:m + 2]
            R = cells(0) - 0.5 * g[2:m + 3]
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
        first = [(e[_GUARDS - 1:_GUARDS + m], e[_GUARDS:_GUARDS + m + 1])
                 for e in ext]
        Ls = [torch.where(bad, l0, l) for (l0, _), l in zip(first, Ls)]
        Rs = [torch.where(bad, r0, r) for (_, r0), r in zip(first, Rs)]
    return tuple(Ls), tuple(Rs)


def _face_states(Pt, reconstruct, theta):
    """(L, R) 5-tuples at the nr + 1 faces, every face through the
    scheme's guards: ext[j + 3] = cell j for j in -3 .. nr + 2, mirrored
    with the sign inside, zero-gradient outside (sedov._extend_bc with 3
    guards)."""
    ext = [torch.cat([(sgn * c[:_GUARDS]).flip(0), c,
                      c[-1:].expand(_GUARDS)]) for c, sgn in zip(Pt, _REFL)]
    return _faces(ext, Pt[0].shape[0], reconstruct, theta)


def _recover(Ut, p_prev, gamma, system):
    """(primitives, the converged pressure or None) of Ut: Euler's, or the
    SRHD Newton from max(p_prev, 0) (p_prev None: from 0)."""
    if system == "euler":
        return euler.recover_primitive_t(Ut, gamma, 0.0), None
    p0 = torch.zeros_like(Ut[0]) if p_prev is None else \
        torch.clamp(p_prev, min=0.0)
    Pt, p_next, _, _ = srhd_recover.recover_window(Ut, p0)
    return Pt, p_next


def _update(U, Pt, F, geo, dt, gamma, system):
    """U [5, m] after the fluxes F at its m + 1 faces and the source of its
    primitives Pt, on the geometry rows geo of its cells."""
    dv, dal, dar, rc = geo
    phys = euler if system == "euler" else srhd
    s0 = phys.spherical_geometry_source_terms_radial_t(Pt, rc, gamma)
    return torch.stack([U[k] + (-(F[k][1:] * dar - F[k][:-1] * dal)
                                + s0[k] * dv) * dt for k in range(5)])


def _step(U, geo, dt, p_prev, reconstruct, theta, gamma, system):
    """One step of U [5, nr]: (U, the converged pressure or None)."""
    inv_dv = 1.0 / geo[0]
    Pt, p_next = _recover(tuple(U[k] * inv_dv for k in range(5)), p_prev,
                          gamma, system)
    L, R = _face_states(Pt, reconstruct, theta)
    phys = euler if system == "euler" else srhd
    F = phys.riemann_hlle_t(L, R, _NHAT, gamma)
    return _update(U, Pt, F, geo, dt, gamma, system), p_next


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
# the kernel's segment march, planned and as plain PyTorch
# -----------------------------------------------------------------------------

CTAS_PER_SM = {4: 3, 8: 2}   # csrc/sedov_step.cu CtasPerSm, by itemsize
RING = 512            # kRing: the face ring, two tiles of kThreads faces
EDGE = 3              # kEdge: the edge buffer's cells a segment end


@dataclass(frozen=True)
class MarchPlan:
    """The march's segments: CTA g owns cells starts[g] .. starts[g + 1],
    at most lmax of them; resident when their state stays in shared
    memory for the call; smem the dynamic shared memory a CTA."""
    starts: np.ndarray
    lmax: int
    resident: bool
    smem: int

    @property
    def ctas(self) -> int:
        return len(self.starts) - 1


def march_smem(reconstruct: str, resident: bool, lmax: int,
               itemsize: int) -> int:
    """csrc/sedov_step.cu march_smem: the face ring [5, RING] and, resident,
    the state [5, lmax], warm pressure and 1/dv [lmax] and primitives
    [5, lmax + 2H]."""
    v = 5 * RING
    if resident:
        v += 7 * lmax + 5 * (lmax + 2 * HALO[reconstruct])
    return v * itemsize


def march_plan(nr: int, reconstruct: str, itemsize: int,
               limits: resident_loop.Limits) -> MarchPlan:
    """CTAS_PER_SM[itemsize] CTAs an SM, or fewer where a segment would
    hold fewer than MIN_CELLS (the mirrored guards and the edge buffer read
    three cells of a segment); resident where that many CTAs with their
    segments' state fit on an SM."""
    per_sm = CTAS_PER_SM[itemsize]
    ctas = max(1, min(limits.sms * per_sm, nr // MIN_CELLS))
    lmax = -(-nr // ctas)
    smem = march_smem(reconstruct, True, lmax, itemsize)
    resident = limits.fits(smem, per_sm)
    if not resident:
        smem = march_smem(reconstruct, False, lmax, itemsize)
    return MarchPlan(resident_loop.split_starts(nr, ctas), lmax, resident,
                     smem)


def advance_n_segments(u, vertices, dt: float, n: int, starts,
                       reconstruct="pcm", plm_theta=1.5, gamma=4.0 / 3.0,
                       system="euler", warm=True):
    """advance_n_plain as the kernel marches it: each segment starts[g] ..
    starts[g + 1] recovers its own cells (from its own warm pressures),
    hands the primitives of its first and last EDGE cells through an edge
    buffer, and takes its faces and update from its window of its cells
    and H halo cells a side (the neighbors' edges, or the guards at the
    domain's ends)."""
    _check_args(u, vertices, n, reconstruct, system, gamma)
    starts = [int(x) for x in starts]
    if starts[0] != 0 or starts[-1] != u.shape[0] or min(
            b - a for a, b in zip(starts, starts[1:])) < MIN_CELLS:
        raise ValueError(f"segments {starts} do not cover {u.shape[0]} "
                         f"cells with at least {MIN_CELLS} each")
    segs = list(zip(starts, starts[1:]))
    H = HALO[reconstruct]
    geo = geometry(vertices, u.dtype)
    inv_dv = 1.0 / geo[0]
    dt_ = torch.full((), dt, dtype=u.dtype, device=u.device)
    phys = euler if system == "euler" else srhd
    U = [u[a:b].t() for a, b in segs]
    p = [None] * len(segs)
    for _ in range(n):
        prims, edges = [], []
        for g, (a, b) in enumerate(segs):
            Pt, p_conv = _recover(tuple(U[g][k] * inv_dv[a:b]
                                        for k in range(5)), p[g], gamma,
                                  system)
            p[g] = p_conv if warm else None
            prims.append(Pt)
            edges.append((tuple(c[:EDGE] for c in Pt),
                          tuple(c[-EDGE:] for c in Pt)))
        for g, (a, b) in enumerate(segs):
            Pt, ext = prims[g], []
            for q, sgn in enumerate(_REFL):
                lo = (edges[g - 1][1][q][EDGE - H:] if g > 0
                      else (sgn * Pt[q][:H]).flip(0))
                hi = (edges[g + 1][0][q][:H] if g < len(segs) - 1
                      else Pt[q][-1:].expand(H))
                # the slots past H a side feed no face that is kept
                ext.append(torch.cat([lo[:1].expand(_GUARDS - H), lo, Pt[q],
                                      hi, hi[-1:].expand(_GUARDS - H)]))
            L, R = _faces(ext, b - a, reconstruct, plm_theta)
            F = phys.riemann_hlle_t(L, R, _NHAT, gamma)
            U[g] = _update(U[g], Pt, F, geo[:, a:b], dt_, gamma, system)
    return torch.cat([x.t() for x in U]).contiguous()


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
            fn.argtypes = ([_c_void_p] * 8 + [_c_int] * 8 + [_c_double] * 3
                           + [_c_void_p])
            fn.restype = _c_int
        lib.b5_device_limits.argtypes = [ctypes.POINTER(_c_int)]
        lib.b5_device_limits.restype = _c_int
        lib.b5_kernel_info.argtypes = [_c_int] * 5 + [ctypes.POINTER(_c_int)]
        lib.b5_kernel_info.restype = _c_int
        lib.b5_error_string.argtypes = [_c_int]
        lib.b5_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


_plans: dict = {}


def plan_for(u, reconstruct: str):
    """march_plan for the CUDA tensor u [nr, 5] on its card, and the plan's
    starts on the card; made once for each size, method, type and card."""
    key = (u.shape[0], reconstruct, u.dtype, u.device)
    if key not in _plans:
        lib = _library()
        with torch.cuda.device(u.device):
            limits = resident_loop.device_limits(lib.b5_device_limits)
        plan = march_plan(u.shape[0], reconstruct, u.element_size(), limits)
        _plans[key] = (plan, torch.as_tensor(plan.starts, device=u.device))
    return _plans[key]


def kernel_info(dtype, reconstruct: str, system: str, design: str,
                lmax: int):
    """The resources of B5's march kernel of `design` at segments of lmax
    cells on the current card (resident_loop.kernel_info)."""
    if design not in DESIGNS:
        raise ValueError(f"B5 has designs {DESIGNS}, not {design!r}")
    lib = _library()
    return resident_loop.kernel_info(
        lib.b5_kernel_info, lib.b5_error_string, int(dtype == torch.float64),
        METHODS.index(reconstruct) + 1, int(system == "srhd"),
        int(design == "resident"), lmax)


def advance_n_cuda(u, vertices, dt: float, n: int, reconstruct="pcm",
                   plm_theta=1.5, gamma=4.0 / 3.0, system="euler",
                   warm=True, design=None):
    """Kernel B5 on a contiguous float32 or float64 CUDA tensor u [nr, 5]
    with its vertices [nr + 1] on the same card: a new tensor with n steps
    applied (u is not written). design None takes the resident march where
    march_plan says the segments fit and the streaming march where they do
    not; "resident" or "streaming" asks for one (a resident march that does
    not fit raises). Raises if the kernel does not build or a launch is
    refused or fails."""
    _check_args(u, vertices, n, reconstruct, system, gamma)
    if u.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"advance_n_cuda takes float32 or float64, not "
                         f"{u.dtype}")
    if not u.is_contiguous():
        raise ValueError("advance_n_cuda takes a contiguous tensor")
    if u.device.type != "cuda":
        raise ValueError(f"advance_n_cuda takes a CUDA tensor, not one on "
                         f"{u.device}")
    if design not in (None, *DESIGNS):
        raise ValueError(f"B5 has designs {DESIGNS}, not {design!r}")
    if n == 0:
        return u.clone()
    lib = _library()
    plan, starts = plan_for(u, reconstruct)
    if design is None:
        design = "resident" if plan.resident else "streaming"
    if design == "resident" and not plan.resident:
        raise ValueError(f"{u.shape[0]} {u.dtype} cells do not fit in the "
                         f"card's shared memory")
    resident = design == "resident"
    nr, G = u.shape[0], plan.ctas
    geo = geometry(vertices, u.dtype).contiguous()
    out = torch.empty_like(u)
    edges = torch.empty((2, G, 2, EDGE, 5), dtype=u.dtype, device=u.device)
    warm_srhd = system == "srhd" and warm
    # streaming: the warm pressure (zeroed at each call), 1/dv and the
    # primitives in device memory
    sizes = (0, 0, 0) if resident else (nr if warm_srhd else 0, nr,
                                        5 * (nr + 2 * EDGE * G))
    pw, inv_dv, prim = (torch.zeros(k, dtype=u.dtype, device=u.device)
                        for k in sizes)
    fn = lib.b5_advance_n_f32 if u.dtype == torch.float32 \
        else lib.b5_advance_n_f64
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = fn(u.data_ptr(), out.data_ptr(), geo.data_ptr(), pw.data_ptr(),
            inv_dv.data_ptr(), prim.data_ptr(), starts.data_ptr(),
            edges.data_ptr(), G, plan.lmax, int(resident),
            nr, n, METHODS.index(reconstruct) + 1, int(system == "srhd"),
            int(warm_srhd), dt, plm_theta, gamma, stream)
    if rc != 0:
        raise RuntimeError(f"sedov_step {design} march launch failed: "
                           + lib.b5_error_string(rc).decode())
    advance_n_cuda.launches += 1
    advance_n_cuda.design = design
    return out


advance_n_cuda.launches = 0
advance_n_cuda.design = None


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
