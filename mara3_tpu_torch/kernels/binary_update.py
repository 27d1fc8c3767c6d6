"""Kernels B11a and B11b: the two halves of the flagship advance's "split"
variant (schemes/binary_scheme.make_advance(fused="split")), as CUDA kernels
beside their plain PyTorch versions.

Replaces mara3_tpu/kernels/binary_update.py: `fused_fluxes` (B11a, one
axis's face fluxes, launched once per axis) and `fused_update` (B11b, the
back half after the corrected fluxes). The CUDA source is
csrc/binary_update.cu (with csrc/binary_tpu_flux.cuh, which B11c shares);
its header note gives the design and what bounds it.

Each plain version copies its TPU kernel's arithmetic, not the reference
scheme's: the physical flux vn (sigma v), the HLLE with its reciprocal
1 / (ap - am), the angular-momentum transform before the face-length
scaling, Lz zeroed within 1e-8 R of the domain radius (the reference's
isclose takes 1e-8 + 1e-5 R), and the geometric source grouped
2 (Ek + pg) ramp, then dt. The TPU layout (blocks on the lane axis, lane
padding and its mask) is not carried over: the [B, ...] tensors are taken as
they are.

- `fused_fluxes_plain`, `fused_update_plain`: torch ops; the CPU tests hold
  them to the JAX kernels in interpret mode.
- `fused_fluxes_cuda`, `fused_update_cuda`: the kernels' wrappers, each
  with a `.launches` count.
- `fused_fluxes`, `fused_update`: the plain version for a CPU tensor, the
  kernel for a CUDA tensor; never one for the other.
"""

from __future__ import annotations

import ctypes

import torch

from mara3_tpu_torch.kernels import binary_advance as BA
from mara3_tpu_torch.physics import iso2d
from mara3_tpu_torch.schemes import binary_scheme
from mara3_tpu_torch.schemes.binary_scheme import SchemeConfig

# the totals that B11b's fused_update returns (no work done: the scheme
# forms it from these, binary_scheme.work_done)
UPDATE_TOTALS = binary_scheme.PAIR_TOTALS[:7]


def split_boundary_tolerance(domain_radius: float) -> float:
    """B11a's boundary test: |coord| within 1e-8 R of the domain radius
    (mara3_tpu/kernels/binary_update.py:342)."""
    return 1e-8 * domain_radius


# -----------------------------------------------------------------------------
# the TPU kernels' arithmetic, shared with B11c's plain version
# -----------------------------------------------------------------------------

def tpu_face_flux(axis, pl, pr, gl, gr, hl, hr, x, y, sp, bodies,
                  cfg: SchemeConfig, split_form: bool, tol: float):
    """fhat * face length [..., 3] as B11a (split_form) or B11c computes it:
    pl/pr the cell values beside each face, gl/gr the slopes along its
    normal, hl/hr across it ([..., 3]); x, y the face centers [...]; sp the
    face length, broadcastable to [...]; Lz zeroed where
    | |coord| - R | <= tol. csrc/binary_tpu_flux.cuh is the kernel side."""
    half = (0.5 * sp)[..., None]
    plh = pl + gl * half
    prh = pr - gr * half
    xy = torch.stack([x, y], dim=-1)
    cs2 = binary_scheme.cs2_at_position(xy, bodies, cfg)
    nu = binary_scheme.nu_at_position(xy, cs2, cfg)
    mu = 0.5 * nu * (plh[..., 0] + prh[..., 0])

    cs = torch.sqrt(cs2)
    vnl, vnr = plh[..., 1 + axis], prh[..., 1 + axis]

    def conserved(ph):
        return torch.stack([ph[..., 0], ph[..., 0] * ph[..., 1],
                            ph[..., 0] * ph[..., 2]], dim=-1)

    def physical(vn, U, pres):
        F = [vn * U[..., 0], vn * U[..., 1], vn * U[..., 2]]
        F[1 + axis] = F[1 + axis] + pres
        return torch.stack(F, dim=-1)

    Ul, Ur = conserved(plh), conserved(prh)
    pres_l, pres_r = plh[..., 0] * cs2, prh[..., 0] * cs2
    Fl, Fr = physical(vnl, Ul, pres_l), physical(vnr, Ur, pres_r)

    if cfg.riemann == "hllc" and not split_form:
        # HLLC, Toro 3rd ed. sec 10.6 for isothermal gamma = 1
        # (mara3_tpu/kernels/binary_advance.py:108-135)
        sig_l, sig_r = plh[..., 0], prh[..., 0]
        sigma_bar = 0.5 * (sig_l + sig_r)
        ppvrs = 0.5 * (pres_l + pres_r) - 0.5 * (vnr - vnl) * sigma_bar * cs
        pstar = torch.clamp(ppvrs, min=0.0)
        ql = torch.clamp(torch.sqrt(pstar / pres_l), min=1.0)
        qr = torch.clamp(torch.sqrt(pstar / pres_r), min=1.0)
        sl = vnl - cs * ql
        sr = vnr + cs * qr
        den = sig_l * (sl - vnl) - sig_r * (sr - vnr)
        sstar = (pres_r - pres_l + vnl * sig_l * (sl - vnl)
                 - vnr * sig_r * (sr - vnr)) / den
        dl = sig_l * (sl - vnl) / (sl - sstar)
        dr = sig_r * (sr - vnr) / (sr - sstar)

        def star(d, ph):
            comps = [d, d * ph[..., 1], d * ph[..., 2]]
            comps[1 + axis] = d * sstar
            return torch.stack(comps, dim=-1)

        Fl_star = Fl + (star(dl, plh) - Ul) * sl[..., None]
        Fr_star = Fr + (star(dr, prh) - Ur) * sr[..., None]
        fhat = torch.where(
            sl[..., None] >= 0.0, Fl,
            torch.where(sstar[..., None] >= 0.0, Fl_star,
                        torch.where(sr[..., None] >= 0.0, Fr_star, Fr)))
    else:
        ap = torch.clamp(torch.maximum(vnl + cs, vnr + cs), min=0.0)
        am = torch.clamp(torch.minimum(vnl - cs, vnr - cs), max=0.0)
        apx, amx = ap[..., None], am[..., None]
        if split_form:
            den = 1.0 / (ap - am)
            fhat = (Fl * apx - Fr * amx
                    - (Ul - Ur) * (ap * am)[..., None]) * den[..., None]
        else:
            fhat = (Fl * apx - Fr * amx - (Ul - Ur) * apx * amx) / (apx - amx)

    # viscous stress (subprog_binary_scheme.cpp:220-262)
    fhat = fhat + binary_scheme.viscous_flux(axis, gl, gr, hl, hr, mu)

    if not cfg.conserve_linear_p:
        # (sigma, Sr, Lz) fluxes with Lz zeroed at the domain boundary
        coord = x if axis == 0 else y
        at_boundary = torch.abs(torch.abs(coord) - cfg.domain_radius) <= tol
        fsr = x * fhat[..., 1] + y * fhat[..., 2]
        flz = x * fhat[..., 2] - y * fhat[..., 1]
        flz = torch.where(at_boundary, torch.zeros_like(flz), flz)
        fhat = torch.stack([fhat[..., 0], fsr, flz], dim=-1)
    return fhat * sp[..., None]


def tpu_cell_update(u0, p0, init, br, div, x, y, dA, dt, bodies,
                    cfg: SchemeConfig):
    """(u1, totals) of the sources, update and accounting as B11b and B11c
    compute them: u0, p0, init, div [B, bs, bs, 3]; br, x, y [B, bs, bs];
    dA broadcastable to [B, bs, bs]. The totals are UPDATE_TOTALS ([2]
    each), mass_ejected and angular_momentum_ejected."""
    sigma = u0[..., 0]

    def body_fields(k):
        M, bx, by = bodies[k, 0], bodies[k, 1], bodies[k, 2]
        dxp, dyp = x - bx, y - by
        dr2 = dxp * dxp + dyp * dyp
        grav = -M / (dr2 + cfg.softening_radius ** 2) ** 1.5
        sink = cfg.sink_rate * torch.exp(-dr2 / cfg.sink_radius ** 2 / 2.0)
        return dxp * grav * sigma, dyp * grav * sigma, sink

    z = torch.zeros_like(sigma)
    terms = []
    for k in range(2):
        fgx, fgy, sink = body_fields(k)
        if cfg.conserve_linear_p:
            sg = torch.stack([z, fgx, fgy], dim=-1) * dt
        else:
            sg = torch.stack([z, x * fgx + y * fgy, x * fgy - y * fgx],
                             dim=-1) * dt
        ss = -u0 * sink[..., None] * dt
        terms.append((ss, sg, fgx, fgy))
    sb = (init - u0) * br[..., None] * dt
    floor = (sigma < cfg.density_floor).to(u0.dtype)
    sf = u0 * (0.01 * floor)[..., None]
    (ss1, sg1, _, _), (ss2, sg2, _, _) = terms
    s = sg1 + sg2 + ss1 + ss2 + sb + sf

    if not cfg.conserve_linear_p:
        cs2 = binary_scheme.cs2_at_position(torch.stack([x, y], dim=-1),
                                            bodies, cfg)
        vsq = p0[..., 1] * p0[..., 1] + p0[..., 2] * p0[..., 2]
        Ek = 0.5 * p0[..., 0] * vsq
        pg = p0[..., 0] * cs2
        ramp = 1.0 - torch.exp(-(x * x + y * y) / cfg.gst_suppr_radius ** 2)
        geo = torch.stack([z, 2.0 * (Ek + pg) * ramp * dt, z], dim=-1)
        s = s + geo

    u1 = u0 - div * dt / dA[..., None] + s

    def tot(a):
        return torch.sum(a * dA)

    def lz_of(sv):
        if cfg.conserve_linear_p:
            return x * sv[..., 2] - y * sv[..., 1]
        return sv[..., 2]

    def p_of(sv, comp):
        if cfg.conserve_linear_p:
            return sv[..., 1 + comp]
        r2 = x * x + y * y
        r2 = torch.where(r2 > 0.0, r2, torch.ones_like(r2))
        if comp == 0:
            return (sv[..., 1] * x - sv[..., 2] * y) / r2
        return (sv[..., 1] * y + sv[..., 2] * x) / r2

    rows = {key: [] for key in UPDATE_TOTALS}
    for ss, sg, fgx, fgy in terms:
        rows["mass_accreted_on"].append(-tot(ss[..., 0]))
        rows["angular_momentum_accreted_on"].append(-tot(lz_of(ss)))
        rows["integrated_torque_on"].append(-tot(lz_of(sg)))
        rows["momentum_x_accreted_on"].append(-tot(p_of(ss, 0)))
        rows["momentum_y_accreted_on"].append(-tot(p_of(ss, 1)))
        rows["integrated_force_x_on"].append(-tot(fgx * dt))
        rows["integrated_force_y_on"].append(-tot(fgy * dt))
    totals = {key: torch.stack(v) for key, v in rows.items()}
    totals["mass_ejected"] = -tot(sb[..., 0])
    totals["angular_momentum_ejected"] = -tot(lz_of(sb))
    return u1, totals


# -----------------------------------------------------------------------------
# the plain versions
# -----------------------------------------------------------------------------

def fused_fluxes_plain(p_ex, g_lon_ex, g_tra_ex, xf, spacing, bodies, axis,
                       cfg: SchemeConfig):
    """One axis's fhat * face length, B11a's arithmetic. p_ex, g_*_ex are
    the guard-extended [B, bs+2, bs, 3] (axis 0) or [B, bs, bs+2, 3]
    (axis 1); xf the face centers [B, faces.., 2]; spacing [B]. Returns
    [B, bs+1, bs, 3] or [B, bs, bs+1, 3]."""
    bodies = torch.as_tensor(bodies, dtype=p_ex.dtype, device=p_ex.device)
    n = p_ex.shape[1 + axis]

    def faces(a):
        return a.narrow(1 + axis, 0, n - 1), a.narrow(1 + axis, 1, n - 1)

    (pl, pr), (gl, gr), (hl, hr) = faces(p_ex), faces(g_lon_ex), \
        faces(g_tra_ex)
    sp = spacing.to(p_ex.dtype)[:, None, None]
    return tpu_face_flux(axis, pl, pr, gl, gr, hl, hr, xf[..., 0],
                         xf[..., 1], sp, bodies, cfg, True,
                         split_boundary_tolerance(cfg.domain_radius))


def fused_update_plain(u0, p0, fx, fy, xc, br, init, dA, dt, bodies,
                       cfg: SchemeConfig):
    """B11b's back half: (u1, totals, invalid). u0, p0, init [B, bs, bs, 3];
    fx [B, bs+1, bs, 3]; fy [B, bs, bs+1, 3]; xc [B, bs, bs, 2]; br, dA
    [B, bs, bs]. The totals are UPDATE_TOTALS, mass_ejected and
    angular_momentum_ejected."""
    bodies = torch.as_tensor(bodies, dtype=u0.dtype, device=u0.device)
    div = (fx[:, 1:] - fx[:, :-1]) + (fy[:, :, 1:] - fy[:, :, :-1])
    u1, totals = tpu_cell_update(u0, p0, init, br, div, xc[..., 0],
                                 xc[..., 1], dA, dt, bodies, cfg)
    return u1, totals, iso2d.contains_invalid(u1)


# -----------------------------------------------------------------------------
# the CUDA kernels
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _library():
    """The built csrc/binary_update.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("binary_update")
    if not getattr(lib, "_mara_typed", False):
        if lib.b11_num_totals() != BA.NUM_TOTALS:
            raise RuntimeError("csrc/binary_update.cu sums "
                               f"{lib.b11_num_totals()} totals, not "
                               f"{BA.NUM_TOTALS}")
        for fn in (lib.b11a_fluxes_f32, lib.b11a_fluxes_f64):
            fn.argtypes = [_c_void_p] * 6 + [_c_int] * 3 + [
                _c_void_p, _c_int, _c_void_p, _c_void_p]
            fn.restype = _c_int
        for fn in (lib.b11b_update_f32, lib.b11b_update_f64):
            fn.argtypes = [_c_void_p] * 11 + [_c_int, _c_int, _c_void_p,
                                              _c_int, _c_void_p, _c_void_p]
            fn.restype = _c_int
        lib.b11_num_partials.argtypes = [_c_int, _c_int]
        lib.b11_num_partials.restype = _c_int
        lib.b11_num_totals.argtypes = []
        lib.b11_num_totals.restype = _c_int
        lib.b11_error_string.argtypes = [_c_int]
        lib.b11_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def check_cuda_args(name, dtype, *tensors):
    """Raise unless every tensor is a contiguous CUDA tensor of `dtype`
    (float32 or float64) on one device."""
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"{name} takes float32 or float64, got {dtype}")
    device = tensors[0].device
    for a in tensors:
        if not a.is_cuda:
            raise ValueError(f"{name} takes CUDA tensors")
        if a.dtype != dtype:
            raise TypeError(f"{name} takes {dtype} tensors, got {a.dtype}")
        if not a.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors")
        if a.device != device:
            raise ValueError(f"{name}: tensors on {device} and {a.device}")


def _ptr(a):
    return None if a is None else a.data_ptr()


def fused_fluxes_cuda(p_ex, g_lon_ex, g_tra_ex, xf, spacing, bodies, axis,
                      cfg: SchemeConfig):
    """Kernel B11a on CUDA tensors, with fused_fluxes_plain's meaning.
    Raises if the kernel does not build or its launch fails."""
    B = p_ex.shape[0]
    bs = p_ex.shape[2 - axis]
    ext = (B, bs + 2, bs, 3) if axis == 0 else (B, bs, bs + 2, 3)
    faces = (B, bs + 1, bs) if axis == 0 else (B, bs, bs + 1)
    for a, shape in ((p_ex, ext), (g_lon_ex, ext), (g_tra_ex, ext),
                     (xf, faces + (2,)), (spacing, (B,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"fused_fluxes_cuda (axis {axis}) takes "
                             f"{list(shape)}, got {list(a.shape)}")
    check_cuda_args("fused_fluxes_cuda", p_ex.dtype, p_ex, g_lon_ex,
                    g_tra_ex, xf, spacing)
    lib = _library()
    params, flags, dyn = BA.launch_params(
        cfg, bodies, 0.0, 0.0, p_ex.device,
        split_boundary_tolerance(cfg.domain_radius))
    f = torch.empty(faces + (3,), dtype=p_ex.dtype, device=p_ex.device)
    fn = (lib.b11a_fluxes_f32 if p_ex.dtype == torch.float32
          else lib.b11a_fluxes_f64)
    rc = fn(p_ex.data_ptr(), g_lon_ex.data_ptr(), g_tra_ex.data_ptr(),
            xf.data_ptr(), spacing.data_ptr(), f.data_ptr(), B, bs, axis,
            params.ctypes.data, flags, _ptr(dyn),
            torch.cuda.current_stream(p_ex.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("binary_update B11a launch failed: "
                           + lib.b11_error_string(rc).decode())
    fused_fluxes_cuda.launches += 1
    return f


fused_fluxes_cuda.launches = 0


def fused_update_cuda(u0, p0, fx, fy, xc, br, init, dA, dt, bodies,
                      cfg: SchemeConfig):
    """Kernel B11b on CUDA tensors, with fused_update_plain's meaning.
    Raises if the kernel does not build or its launch fails."""
    B, bs = u0.shape[0], u0.shape[1]
    for a, shape in ((u0, (B, bs, bs, 3)), (p0, (B, bs, bs, 3)),
                     (init, (B, bs, bs, 3)), (fx, (B, bs + 1, bs, 3)),
                     (fy, (B, bs, bs + 1, 3)), (xc, (B, bs, bs, 2)),
                     (br, (B, bs, bs)), (dA, (B, bs, bs))):
        if tuple(a.shape) != shape:
            raise ValueError(f"fused_update_cuda takes {list(shape)}, got "
                             f"{list(a.shape)}")
    check_cuda_args("fused_update_cuda", u0.dtype, u0, p0, fx, fy, xc, br,
                    init, dA)
    lib = _library()
    params, flags, dyn = BA.launch_params(cfg, bodies, dt, 0.0, u0.device)
    u1 = torch.empty_like(u0)
    partials = torch.empty(lib.b11_num_partials(B, bs), BA.NUM_TOTALS,
                           dtype=torch.float64, device=u0.device)
    totals = torch.empty(BA.NUM_TOTALS, dtype=torch.float64,
                         device=u0.device)
    fn = (lib.b11b_update_f32 if u0.dtype == torch.float32
          else lib.b11b_update_f64)
    rc = fn(u0.data_ptr(), p0.data_ptr(), fx.data_ptr(), fy.data_ptr(),
            xc.data_ptr(), br.data_ptr(), init.data_ptr(), dA.data_ptr(),
            u1.data_ptr(), partials.data_ptr(), totals.data_ptr(), B, bs,
            params.ctypes.data, flags, _ptr(dyn),
            torch.cuda.current_stream(u0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("binary_update B11b launch failed: "
                           + lib.b11_error_string(rc).decode())
    fused_update_cuda.launches += 1
    return u1, BA.totals_from_slots(totals, u0.dtype, UPDATE_TOTALS), \
        totals[BA.FAULTS_SLOT] > 0


fused_update_cuda.launches = 0


def fused_fluxes(p_ex, g_lon_ex, g_tra_ex, xf, spacing, bodies, axis,
                 cfg: SchemeConfig):
    """B11a: the plain version for CPU tensors, the kernel for CUDA ones."""
    if p_ex.device.type == "cpu":
        return fused_fluxes_plain(p_ex, g_lon_ex, g_tra_ex, xf, spacing,
                                  bodies, axis, cfg)
    if p_ex.device.type == "cuda":
        return fused_fluxes_cuda(p_ex, g_lon_ex, g_tra_ex, xf, spacing,
                                 bodies, axis, cfg)
    raise ValueError(f"no fused_fluxes for a tensor on {p_ex.device}")


def fused_update(u0, p0, fx, fy, xc, br, init, dA, dt, bodies,
                 cfg: SchemeConfig):
    """B11b: the plain version for CPU tensors, the kernel for CUDA ones."""
    if u0.device.type == "cpu":
        return fused_update_plain(u0, p0, fx, fy, xc, br, init, dA, dt,
                                  bodies, cfg)
    if u0.device.type == "cuda":
        return fused_update_cuda(u0, p0, fx, fy, xc, br, init, dA, dt,
                                 bodies, cfg)
    raise ValueError(f"no fused_update for a tensor on {u0.device}")
