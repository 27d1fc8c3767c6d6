"""Circumbinary-disk scheme core: the flagship hot path.

Port of mara3_tpu/schemes/binary_scheme.py (a re-design of
src/subprog_binary_scheme.cpp over the dense AMR block layout,
mesh/block_layout.py). One advance covers what the reference fans over a
thread pool per tree leaf (advance_u/advance_q,
subprog_binary_scheme.cpp:790-1020):

  recover_primitive -> guard exchange (prims + gradients) -> PLM face
  extrapolation -> HLLE/HLLC + viscous flux -> coarse-fine flux correction
  -> gravity/sink/buffer/floor (+ geometric for Q) sources -> update,
  with all source-term totals reduced to scalars on the device.

Both conservation formulations are supported: linear momentum U and angular
momentum Q (physics_iso2d.hpp:56-97). Faults (negative density, the
reference's thrown exception at subprog_binary_scheme.cpp:726-784) surface
as a value-level flag for the host's safe-mode retry.

The functions here are the plain-torch building blocks. `make_advance`
binds the static tables and returns the advance of
kernels/binary_advance.py, which runs the hand-written CUDA kernel on a
CUDA tensor and these plain functions on a CPU tensor.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from mara3_tpu_torch.physics import iso2d


@dataclass(frozen=True)
class SchemeConfig:
    """Static scheme parameters."""
    block_size: int
    domain_radius: float
    mach_number: float
    softening_radius: float
    sink_radius: float
    sink_rate: float
    gst_suppr_radius: float
    density_floor: float
    alpha: float
    alpha_cutoff_radius: float
    nu: float
    axisymmetric_cs2: bool
    conserve_linear_p: bool
    reconstruct_method: str   # 'plm' or 'pcm'
    buffer_damping_rate: float = 10.0
    riemann: str = "hlle"     # 'hlle' (the reference's pinned choice,
                              # subprog_binary_solver_data.cpp:109) or
                              # 'hllc' (physics_iso2d.hpp:704-712)


# -----------------------------------------------------------------------------
# fields of the binary potential (subprog_binary_scheme.cpp:62-126)
# -----------------------------------------------------------------------------

def grav_vdot_field(x, body_pos, body_mass, softening_radius):
    """Softened gravitational acceleration -G M dr / (dr^2 + rs^2)^(3/2);
    x [..., 2], body_pos [2]."""
    dr = x - body_pos
    dr2 = dr[..., 0] ** 2 + dr[..., 1] ** 2
    rs2 = softening_radius ** 2
    return -dr * (body_mass / (dr2 + rs2) ** 1.5)[..., None]


def grav_phi_field(x, body_pos, body_mass, softening_radius):
    dr = x - body_pos
    dr2 = dr[..., 0] ** 2 + dr[..., 1] ** 2
    return -body_mass / torch.sqrt(dr2 + softening_radius ** 2)


def sink_rate_field(x, sink_pos, sink_radius, sink_rate):
    """Gaussian sink kernel (subprog_binary_scheme.cpp:117-126)."""
    dr = x - sink_pos
    a2 = (dr[..., 0] ** 2 + dr[..., 1] ** 2) / sink_radius ** 2 / 2.0
    return sink_rate * torch.exp(-a2)


def cs2_at_position(x, bodies, cfg: SchemeConfig):
    """Locally isothermal sound speed squared from the binary potential
    (or axisymmetric GM/r), subprog_binary_scheme.cpp:160-175.
    bodies: [2, 5] rows (mass, x, y, vx, vy)."""
    M2 = cfg.mach_number ** 2
    if cfg.axisymmetric_cs2:
        r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
        return 1.0 / r / M2
    phi1 = grav_phi_field(x, bodies[0, 1:3], bodies[0, 0],
                          cfg.softening_radius)
    phi2 = grav_phi_field(x, bodies[1, 1:3], bodies[1, 0],
                          cfg.softening_radius)
    return -(phi1 + phi2) / M2


def nu_at_position(x, cs2, cfg: SchemeConfig):
    """Alpha- or constant-nu viscosity with optional inner cutoff
    (subprog_binary_scheme.cpp:177-193)."""
    r = torch.sqrt(x[..., 0] ** 2 + x[..., 1] ** 2)
    if cfg.alpha_cutoff_radius > 0.0:
        profile = 0.5 * (1.0 + torch.tanh(3.0 * (r - cfg.alpha_cutoff_radius)))
    else:
        profile = torch.ones_like(r)
    if cfg.nu > 0.0:
        return profile * cfg.nu
    scale_height = r / cfg.mach_number
    return profile * cfg.alpha * torch.sqrt(cs2) * scale_height


def viscous_flux(axis, gl, gr, hl, hr, mu):
    """Shear-stress flux (subprog_binary_scheme.cpp:220-262). gl/gr are the
    longitudinal velocity gradients at the two adjacent cells, hl/hr the
    transverse ones; mu the face dynamic viscosity."""
    if axis == 0:
        dx_ux = 0.5 * (gl[..., 1] + gr[..., 1])
        dx_uy = 0.5 * (gl[..., 2] + gr[..., 2])
        dy_ux = 0.5 * (hl[..., 1] + hr[..., 1])
        dy_uy = 0.5 * (hl[..., 2] + hr[..., 2])
        tauxx = mu * (dx_ux - dy_uy)
        tauxy = mu * (dx_uy + dy_ux)
        z = torch.zeros_like(mu)
        return torch.stack([z, -tauxx, -tauxy], dim=-1)
    dx_ux = 0.5 * (hl[..., 1] + hr[..., 1])
    dx_uy = 0.5 * (hl[..., 2] + hr[..., 2])
    dy_ux = 0.5 * (gl[..., 1] + gr[..., 1])
    dy_uy = 0.5 * (gl[..., 2] + gr[..., 2])
    tauyx = mu * (dx_uy + dy_ux)
    tauyy = -mu * (dx_ux - dy_uy)
    z = torch.zeros_like(mu)
    return torch.stack([z, -tauyx, -tauyy], dim=-1)


# -----------------------------------------------------------------------------
# fluxes over blocks
# -----------------------------------------------------------------------------

def _faces_along(a, axis):
    """(left, right) cell values at the bs+1 faces along `axis` of
    guard-extended tensors [B, bs+2, ..]."""
    n = a.shape[1 + axis]
    return a.narrow(1 + axis, 0, n - 1), a.narrow(1 + axis, 1, n - 1)


def block_fluxes(axis, p_ext, g_long_ext, g_tran_ext, xf, face_len, spacing,
                 bodies, cfg: SchemeConfig):
    """fhat * face_length at all faces along `axis`
    (block_fluxes_u, subprog_binary_scheme.cpp:452-500). spacing [B]."""
    pl, pr = _faces_along(p_ext, axis)
    gl, gr = _faces_along(g_long_ext, axis)
    hl, hr = _faces_along(g_tran_ext, axis)

    s = spacing[:, None, None, None]
    pl_hat = pl + gl * 0.5 * s
    pr_hat = pr - gr * 0.5 * s

    cs2 = cs2_at_position(xf, bodies, cfg)
    nu = nu_at_position(xf, cs2, cfg)
    mu = 0.5 * nu * (pl_hat[..., 0] + pr_hat[..., 0])

    nhat = (1.0, 0.0) if axis == 0 else (0.0, 1.0)
    solver = (iso2d.riemann_hllc if cfg.riemann == "hllc"
              else iso2d.riemann_hlle)
    fhat = solver(pl_hat, pr_hat, cs2, cs2, nhat)
    fhat = fhat + viscous_flux(axis, gl, gr, hl, hr, mu)
    return fhat * face_len[..., None]


def boundary_tolerance(domain_radius: float) -> float:
    """|coord| within this of the domain radius marks a boundary face: the
    default tolerances of numpy/jnp isclose (atol 1e-8, rtol 1e-5)."""
    return 1e-8 + 1e-5 * domain_radius


def to_angmom_fluxes(axis, fhat, xf, domain_radius):
    """Linear-momentum fluxes -> (sigma, Sr, Lz) fluxes, with Lz flux zeroed
    at the domain boundary faces (subprog_binary_scheme.cpp:196-214)."""
    x0, x1 = xf[..., 0], xf[..., 1]
    fs = fhat[..., 0]
    fsr = x0 * fhat[..., 1] + x1 * fhat[..., 2]
    flz = x0 * fhat[..., 2] - x1 * fhat[..., 1]
    coord = x0 if axis == 0 else x1
    at_boundary = (torch.abs(torch.abs(coord) - domain_radius)
                   <= boundary_tolerance(domain_radius))
    flz = torch.where(at_boundary, torch.zeros_like(flz), flz)
    return torch.stack([fs, fsr, flz], dim=-1)


def correct_coarse_fine_fluxes(fhat, nt, axis):
    """Replace boundary flux strips adjacent to *finer* neighbors with the
    pairwise-summed (restrict_extrinsic) fine fluxes through the shared face
    (correct_fluxes_{xl,xr,yl,yr}, subprog_binary_scheme.cpp:614-720).
    fhat: [B, bs+1, bs, C] for axis 0 / [B, bs, bs+1, C] for axis 1.
    `nt` is a NeighborTable whose arrays may be numpy or tensors."""
    n = fhat.shape[1 + axis]
    device = fhat.device
    out = fhat.clone()
    for side in (0, 1):
        f = 2 * axis + side
        fine0 = torch.as_tensor(nt.fine_id[:, f, 0], dtype=torch.int64,
                                device=device)
        fine1 = torch.as_tensor(nt.fine_id[:, f, 1], dtype=torch.int64,
                                device=device)
        # fine neighbors' flux through my face = their opposite-side strip
        strip = fhat.select(1 + axis, 0 if side == 1 else n - 1)  # [B, bs, C]
        stitched = torch.cat([strip[fine0], strip[fine1]], dim=1)
        # restrict_extrinsic
        corrected = stitched[:, 0::2] + stitched[:, 1::2]
        mask = (torch.as_tensor(nt.case[:, f], device=device) == 2)[:, None,
                                                                     None]
        pos = 0 if side == 0 else n - 1
        current = fhat.select(1 + axis, pos)
        out.select(1 + axis, pos).copy_(torch.where(mask, corrected, current))
    return out


# -----------------------------------------------------------------------------
# source terms (subprog_binary_scheme.cpp:337-450)
# -----------------------------------------------------------------------------

# the per-body accounting totals ([2] each) an advance returns, besides
# the scalars mass_ejected and angular_momentum_ejected
PAIR_TOTALS = ("mass_accreted_on", "angular_momentum_accreted_on",
               "integrated_torque_on", "momentum_x_accreted_on",
               "momentum_y_accreted_on", "integrated_force_x_on",
               "integrated_force_y_on", "work_done_on")


def _lz_of_u(u, xc):
    return xc[..., 0] * u[..., 2] - xc[..., 1] * u[..., 1]


def source_terms(u0, p0, xc, dA, br, initial_conserved, bodies, dt,
                 cfg: SchemeConfig):
    """Returns (s_total [B,bs,bs,3] with dt applied, totals dict of 0-d or
    [2] tensors). Covers both formulations (source_terms_u/_q)."""
    b1, b2 = bodies[0], bodies[1]
    sigma = u0[..., 0]

    fg1 = grav_vdot_field(xc, b1[1:3], b1[0], cfg.softening_radius) \
        * sigma[..., None]
    fg2 = grav_vdot_field(xc, b2[1:3], b2[0], cfg.softening_radius) \
        * sigma[..., None]

    if cfg.conserve_linear_p:
        def force_to_source(f):
            z = torch.zeros_like(f[..., 0])
            return torch.stack([z, f[..., 0], f[..., 1]], dim=-1)
    else:
        def force_to_source(f):
            z = torch.zeros_like(f[..., 0])
            sr = xc[..., 0] * f[..., 0] + xc[..., 1] * f[..., 1]
            lz = xc[..., 0] * f[..., 1] - xc[..., 1] * f[..., 0]
            return torch.stack([z, sr, lz], dim=-1)

    s_grav_1 = force_to_source(fg1) * dt
    s_grav_2 = force_to_source(fg2) * dt
    sink1 = sink_rate_field(xc, b1[1:3], cfg.sink_radius, cfg.sink_rate)
    sink2 = sink_rate_field(xc, b2[1:3], cfg.sink_radius, cfg.sink_rate)
    s_sink_1 = -u0 * sink1[..., None] * dt
    s_sink_2 = -u0 * sink2[..., None] * dt
    s_buffer = (initial_conserved - u0) * br[..., None] * dt
    s_floor = u0 * 1e-2 * (u0[..., 0] < cfg.density_floor).to(u0.dtype)[
        ..., None]

    def tot(a):
        return torch.sum(a * dA)

    if cfg.conserve_linear_p:
        lz_sink_1 = _lz_of_u(s_sink_1, xc)
        lz_sink_2 = _lz_of_u(s_sink_2, xc)
        lz_grav_1 = _lz_of_u(s_grav_1, xc)
        lz_grav_2 = _lz_of_u(s_grav_2, xc)
        lz_buffer = _lz_of_u(s_buffer, xc)
        dp1 = s_sink_1[..., 1:3]
        dp2 = s_sink_2[..., 1:3]
    else:
        lz_sink_1 = s_sink_1[..., 2]
        lz_sink_2 = s_sink_2[..., 2]
        lz_grav_1 = s_grav_1[..., 2]
        lz_grav_2 = s_grav_2[..., 2]
        lz_buffer = s_buffer[..., 2]
        u_sink_1 = iso2d.to_conserved_per_area_from_angmom(s_sink_1, xc)
        u_sink_2 = iso2d.to_conserved_per_area_from_angmom(s_sink_2, xc)
        dp1 = u_sink_1[..., 1:3]
        dp2 = u_sink_2[..., 1:3]

    totals = {
        "mass_accreted_on": torch.stack([-tot(s_sink_1[..., 0]),
                                         -tot(s_sink_2[..., 0])]),
        "angular_momentum_accreted_on": torch.stack([-tot(lz_sink_1),
                                                     -tot(lz_sink_2)]),
        "integrated_torque_on": torch.stack([-tot(lz_grav_1),
                                             -tot(lz_grav_2)]),
        "momentum_x_accreted_on": torch.stack([-tot(dp1[..., 0]),
                                               -tot(dp2[..., 0])]),
        "momentum_y_accreted_on": torch.stack([-tot(dp1[..., 1]),
                                               -tot(dp2[..., 1])]),
        "integrated_force_x_on": torch.stack([-tot(fg1[..., 0] * dt),
                                              -tot(fg2[..., 0] * dt)]),
        "integrated_force_y_on": torch.stack([-tot(fg1[..., 1] * dt),
                                              -tot(fg2[..., 1] * dt)]),
        "mass_ejected": -tot(s_buffer[..., 0]),
        "angular_momentum_ejected": -tot(lz_buffer),
    }

    s = s_grav_1 + s_grav_2 + s_sink_1 + s_sink_2 + s_buffer + s_floor

    if not cfg.conserve_linear_p:
        # geometric Sr source with near-origin ramp suppression
        # (source_terms_q, subprog_binary_scheme.cpp:421-431)
        sr2 = cfg.gst_suppr_radius ** 2
        r2 = xc[..., 0] ** 2 + xc[..., 1] ** 2
        ramp = 1.0 - torch.exp(-r2 / sr2)
        cs2 = cs2_at_position(xc, bodies, cfg)
        s_geom = iso2d.source_terms_conserved_angmom(p0, cs2) \
            * (ramp * dt)[..., None]
        s = s + s_geom

    totals["work_done_on"] = work_done(totals, bodies)
    return s, totals


def _square_sum(a, b):
    """a*a + b*b with a*a unrounded: round(a*a + round(b*b)), the fused
    multiply-add that XLA compiles `a ** 2 + b ** 2` into. float64 uses
    Dekker's exact product and a two-sum; float32 rounds once in float64."""
    if a.dtype != torch.float64:
        return (a.double() * a.double() + (b * b).double()).to(a.dtype)
    c = b * b
    p = a * a
    t = 134217729.0 * a                     # 2**27 + 1: Veltkamp split
    hi = t - (t - a)
    lo = a - hi
    e = ((hi * hi - p) + 2.0 * hi * lo) + lo * lo   # p + e == a*a exactly
    s = p + c
    v = s - p
    err = (p - (s - v)) + (c - v)           # s + err == p + c exactly
    return s + (err + e)


def work_done(totals, bodies):
    """Accretion work on each body from the accounting totals
    (subprog_binary_scheme.cpp:394-409). A difference of nearly equal
    squares: the rounding of the two square sums decides its last digits,
    so they are rounded as the JAX package's compiled code rounds them.
    Batched over leading axes: bodies [..., 2, 5], totals [..., 2]."""
    ws = []
    for k in range(2):
        M0 = bodies[..., k, 0]
        px0, py0 = M0 * bodies[..., k, 3], M0 * bodies[..., k, 4]
        dM = totals["mass_accreted_on"][..., k]
        dpx = totals["momentum_x_accreted_on"][..., k]
        dpy = totals["momentum_y_accreted_on"][..., k]
        M1 = M0 + dM
        px1, py1 = px0 + dpx, py0 + dpy
        ws.append(0.5 * (_square_sum(px1, py1) / M1
                         - _square_sum(px0, py0) / M0))
    return torch.stack(ws, dim=-1)


# -----------------------------------------------------------------------------
# the advance and the time step
# -----------------------------------------------------------------------------

def make_advance(cfg: SchemeConfig, nt, geometry, initial_conserved,
                 buffer_rate, *, device, dtype, fused=None):
    """Bind the static tables of one mesh. `geometry` is (xc [B,bs,bs,2],
    dA [B,bs,bs], spacing [B], xf [B,bs+1,bs,2], yf [B,bs,bs+1,2]) as host
    numpy float64. Returns advance(u, bodies, dt, plm_theta) ->
    (u1, totals, invalid) on [B, bs, bs, 3] tensors; bodies is a [2, 5]
    host array or tensor of (mass, x, y, vx, vy) rows.

    `fused` selects the variant, with the JAX package's meanings:
      None (auto), True: kernel B2 (kernels/binary_advance.py,
        csrc/binary_advance.cu) on a CUDA tensor; on a CPU tensor B2's
        plain version, the reference-semantics advance;
      "jnp_strips": kernel B11c (csrc/binary_advance_strips.cu) fed by a
        torch front that builds the guard strips from the edge rows'
        slopes, then the coarse-fine edge fixup (_make_advance_strips);
      "split": kernel B11a once per axis, then B11b
        (kernels/binary_update.py, csrc/binary_update.cu); hlle only;
      False: the reference-semantics advance in torch ops, on any device.
    On a CPU tensor each kernel runs its plain version."""
    from mara3_tpu_torch.kernels import binary_advance

    tables = binary_advance.build_tables(cfg, nt, geometry,
                                         initial_conserved, buffer_rate,
                                         device=device, dtype=dtype)
    if fused is None or fused is True:
        def advance(u0, bodies, dt, plm_theta):
            return binary_advance.advance(tables, u0, bodies, dt, plm_theta)
    elif fused is False:
        def advance(u0, bodies, dt, plm_theta):
            return binary_advance.advance_plain(tables, u0, bodies, dt,
                                                plm_theta)
    elif fused == "jnp_strips":
        advance = _make_advance_strips(tables)
    elif fused == "split":
        if cfg.riemann != "hlle":
            raise NotImplementedError(
                "the round-1 split kernels support hlle only; use the "
                "chunked kernel (fused=True) or the jnp path for hllc")
        advance = _make_advance_split(tables)
    else:
        raise ValueError(f"fused={fused!r}: expected None, True, False, "
                         f"'split' or 'jnp_strips'")
    advance.tables = tables
    return advance


def split_front(t, u0, plm_theta):
    """The split advance's torch front (the JAX package's advance_impl,
    mara3_tpu/schemes/binary_scheme.py:401-426): primitive recovery, the
    one-gather guard exchange and the PLM slopes. `t` is the advance's
    kernels.binary_advance.AdvanceTables. Returns (p0, x, y), x and y the
    contiguous (p_ex, g_lon_ex, g_tra_ex) that kernel B11a takes for each
    axis."""
    from mara3_tpu_torch.kernels import binary_advance
    from mara3_tpu_torch.mathx.plm import plm_gradient
    from mara3_tpu_torch.mesh import block_layout
    p0 = binary_advance.recover(t, u0).contiguous()
    strips = block_layout.guard_strips(p0, t.gg)
    p0_ex = block_layout.extend_blocks_fast(p0, t.gg, 0, strips)
    p0_ey = block_layout.extend_blocks_fast(p0, t.gg, 1, strips)
    if t.cfg.reconstruct_method == "plm":
        sp = t.spacing[:, None, None, None]
        gx = plm_gradient(p0_ex[:, :-2], p0_ex[:, 1:-1], p0_ex[:, 2:],
                          plm_theta) / sp
        gy = plm_gradient(p0_ey[:, :, :-2], p0_ey[:, :, 1:-1],
                          p0_ey[:, :, 2:], plm_theta) / sp
    else:
        gx = torch.zeros_like(p0)
        gy = torch.zeros_like(p0)
    G = torch.cat([gx, gy], dim=-1)
    G_strips = block_layout.guard_strips(G, t.gg)
    G_ex = block_layout.extend_blocks_fast(G, t.gg, 0, G_strips)
    G_ey = block_layout.extend_blocks_fast(G, t.gg, 1, G_strips)
    part = lambda a, lo: a[..., lo:lo + 3].contiguous()
    return (p0, (p0_ex, part(G_ex, 0), part(G_ex, 3)),
            (p0_ey, part(G_ey, 3), part(G_ey, 0)))


def _make_advance_split(t):
    """The split advance: split_front, kernel B11a for each axis's fluxes,
    the coarse-fine flux correction, then kernel B11b
    (mara3_tpu/schemes/binary_scheme.py:401-445)."""
    from mara3_tpu_torch.kernels import binary_update
    cfg = t.cfg

    def advance(u0, bodies, dt, plm_theta):
        bodies = torch.as_tensor(bodies, dtype=t.dtype, device=u0.device)
        p0, x, y = split_front(t, u0, plm_theta)
        fx = binary_update.fused_fluxes(*x, t.xf, t.spacing, bodies, 0, cfg)
        fy = binary_update.fused_fluxes(*y, t.yf, t.spacing, bodies, 1, cfg)
        fx = correct_coarse_fine_fluxes(fx, t.nt, axis=0)
        fy = correct_coarse_fine_fluxes(fy, t.nt, axis=1)
        u1, totals, invalid = binary_update.fused_update(
            u0, p0, fx, fy, t.xc, t.buffer_rate, t.initial_conserved, t.dA,
            dt, bodies, cfg)
        totals["work_done_on"] = work_done(totals, bodies)
        return u1, totals, invalid

    return advance


def strips_front(t, nt, consts, u0, plm_theta):
    """The jnp_strips advance's torch front (the JAX package's
    _make_advance_chunked with in_kernel_guards=False,
    mara3_tpu/schemes/binary_scheme.py:580-705): primitive recovery and the
    primitive guard strips, the slopes of each block's edge rows and
    columns (16 per-row plm_gradient calls), their guard strips from the
    neighbors' edges, packed as kernel B11c takes them. `consts` is
    block_layout.build_soa_guard(nt, bs); the arrays of both may be numpy or
    tensors on the run's device. Returns (p0, strips [B, 4, bs, 9]
    (faces x-lo, x-hi, y-lo, y-hi; components p | gx | gy), theta)."""
    from mara3_tpu_torch.kernels import binary_advance
    from mara3_tpu_torch.mathx.plm import plm_gradient
    from mara3_tpu_torch.mesh import block_layout
    bs = t.cfg.block_size
    sp3 = t.spacing[:, None, None]
    edge = (0, 1, bs - 2, bs - 1)
    p0 = binary_advance.recover(t, u0).contiguous()
    pT = p0.permute(0, 3, 1, 2)                         # [B, C, bs, bs]
    pxlo, pxhi = block_layout.guard_strips_soa(pT, nt, consts, 0)
    pylo, pyhi = block_layout.guard_strips_soa(pT, nt, consts, 1)
    theta = plm_theta if t.cfg.reconstruct_method == "plm" else 0.0

    def gx_at_rows(rows):
        """x-slopes at the given rows, [B, C, len(rows), bs]."""
        outs = []
        for r in rows:
            yl = pxlo if r == 0 else pT[:, :, r - 1]
            yr = pxhi if r == bs - 1 else pT[:, :, r + 1]
            outs.append(plm_gradient(yl, pT[:, :, r], yr, theta) / sp3)
        return torch.stack(outs, dim=2)

    def gy_at_rows(rows):
        """y-slopes at the given rows (with the y-guards there)."""
        outs = []
        for r in rows:
            ext = torch.cat([pylo[:, :, r:r + 1], pT[:, :, r],
                             pyhi[:, :, r:r + 1]], dim=2)
            outs.append(plm_gradient(ext[:, :, :-2], ext[:, :, 1:-1],
                                     ext[:, :, 2:], theta) / sp3)
        return torch.stack(outs, dim=2)

    def gy_at_cols(cols):
        outs = []
        for c in cols:
            yl = pylo if c == 0 else pT[:, :, :, c - 1]
            yr = pyhi if c == bs - 1 else pT[:, :, :, c + 1]
            outs.append(plm_gradient(yl, pT[:, :, :, c], yr, theta) / sp3)
        return torch.stack(outs, dim=2)

    def gx_at_cols(cols):
        outs = []
        for c in cols:
            ext = torch.cat([pxlo[:, :, c:c + 1], pT[:, :, :, c],
                             pxhi[:, :, c:c + 1]], dim=2)
            outs.append(plm_gradient(ext[:, :, :-2], ext[:, :, 1:-1],
                                     ext[:, :, 2:], theta) / sp3)
        return torch.stack(outs, dim=2)

    E_G_x = torch.cat([gx_at_rows(edge), gy_at_rows(edge)], dim=1)
    E_G_y = torch.cat([gx_at_cols(edge), gy_at_cols(edge)], dim=1)
    Gxlo, Gxhi = block_layout.guard_strips_from_edges(E_G_x, nt, consts, 0)
    Gylo, Gyhi = block_layout.guard_strips_from_edges(E_G_y, nt, consts, 1)
    # [B, 4, 9, bs] as the JAX package packs them, then the port's
    # component-last [B, 4, bs, 9]
    strips = torch.stack([
        torch.cat([pxlo, Gxlo], dim=1), torch.cat([pxhi, Gxhi], dim=1),
        torch.cat([pylo, Gylo], dim=1), torch.cat([pyhi, Gyhi], dim=1)],
        dim=1).transpose(2, 3).contiguous()
    return p0, strips, theta


def _make_advance_strips(t):
    """The jnp_strips advance: strips_front, kernel B11c, then the
    coarse-fine edge fixup, the fault flag and the totals
    (mara3_tpu/schemes/binary_scheme.py:690-705, :751-797)."""
    from mara3_tpu_torch.kernels import binary_advance
    from mara3_tpu_torch.mesh import block_layout
    cfg = t.cfg
    # the tables on the run's device (t.nt holds the neighbor table's
    # tensors), so the front copies nothing from the host
    nt = t.nt
    consts = block_layout.build_soa_guard(nt, cfg.block_size).to(t.device)
    fine0 = [nt.fine_id[:, f, 0] for f in range(4)]
    fine1 = [nt.fine_id[:, f, 1] for f in range(4)]
    fmask = [(nt.case[:, f] == 2).to(t.dtype)[:, None, None]
             for f in range(4)]

    def advance(u0, bodies, dt, plm_theta):
        bodies = torch.as_tensor(bodies, dtype=t.dtype, device=u0.device)
        p0, strips, theta = strips_front(t, nt, consts, u0, plm_theta)
        u1, edges, totals = binary_advance.advance_core_strips(
            u0, p0, strips, t.blockgeo, t.initial_conserved, t.spacing, dt,
            bodies, theta, cfg)
        return finish(u1, edges, totals, dt, bodies)

    def finish(u1, edges, totals, dt, bodies):
        """The coarse-fine flux correction as an edge fixup: add
        (restrict_extrinsic(fine fluxes) - own flux) dt / dA at the faces
        whose neighbor is finer (correct_fluxes_*,
        subprog_binary_scheme.cpp:614-720), then the fault flag and the
        work done. u1 is B11c's fresh output, edited in place."""
        fxlo, fxhi, fylo, fyhi = edges
        dtdA = (dt / (t.spacing * t.spacing))[:, None, None]

        def restricted(strip, f):
            st = torch.cat([strip[fine0[f]], strip[fine1[f]]], dim=1)
            return st[:, 0::2] + st[:, 1::2]

        u1[:, 0] += (restricted(fxhi, 0) - fxlo) * dtdA * fmask[0]
        u1[:, -1] -= (restricted(fxlo, 1) - fxhi) * dtdA * fmask[1]
        u1[:, :, 0] += (restricted(fyhi, 2) - fylo) * dtdA * fmask[2]
        u1[:, :, -1] -= (restricted(fylo, 3) - fyhi) * dtdA * fmask[3]
        totals["work_done_on"] = work_done(totals, bodies)
        return u1, totals, iso2d.contains_invalid(u1)

    return advance


def make_maximum_timestep(cfg: SchemeConfig, geometry, *, device, dtype):
    """Global min over blocks of spacing / max wavespeed
    (binary::maximum_timestep, subprog_binary_scheme.cpp:1107-1126).
    Returns a 0-d tensor on the state's device."""
    xc, dA, spacing, xf, yf = (torch.as_tensor(a, dtype=dtype, device=device)
                               for a in geometry)

    def bound(u0, bodies):
        return maximum_timestep(cfg, xc, spacing, u0, bodies)

    return bound


def maximum_timestep(cfg: SchemeConfig, xc, spacing, u0, bodies):
    """min over blocks of spacing / max wavespeed, a 0-d tensor; xc
    [B, bs, bs, 2] and spacing [B] are tensors beside u0, bodies a [2, 5]
    host array or tensor."""
    bodies = torch.as_tensor(bodies, dtype=u0.dtype, device=u0.device)
    if cfg.conserve_linear_p:
        p0 = iso2d.recover_primitive(u0)
    else:
        p0 = iso2d.recover_primitive_angmom(u0, xc)
    cs2 = cs2_at_position(xc, bodies, cfg)
    a = iso2d.max_wavespeed(p0, cs2)
    block_dt = spacing / torch.amax(a, dim=(1, 2))
    return torch.min(block_dt)
