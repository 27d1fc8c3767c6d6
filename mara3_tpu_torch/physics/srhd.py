"""Special-relativistic hydrodynamics (gamma-law), 5 components, c = 1.

Port of mara3_tpu/physics/srhd.py (the reference's physics_srhd.hpp).
Primitive P = [rho, u1, u2, u3, p] with u = gamma*beta the spatial
four-velocity; conserved density U = [D, S1, S2, S3, tau]. The tuple forms
(`*_t`) take and return 5-tuples of component tensors. Every formula keeps
the JAX package's operation order.

Primitive recovery is the reference's per-cell Newton iteration on the
pressure (physics_srhd.hpp:364-440) as a masked vector loop: every cell
iterates together, a converged cell freezes, and the loop ends when every
cell has converged or after 50 updates. It runs 5 updates per pass and
reads `all(done)` on the host once per pass (the JAX package's while_loop
check), so a recovery on a CUDA tensor waits for the card once per pass.
Under a profiler each of those host reads counts one `recover_passes`
(app/tracing.py).
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.app import tracing

NUM_COMPONENTS = 5

NEWTON_ITER_MAX = 50
ERROR_TOLERANCE = 1e-10
CHUNK = 5          # masked updates per pass of the Newton loop


def mass_density(P):  return P[..., 0]
def gamma_beta_1(P):  return P[..., 1]
def gamma_beta_2(P):  return P[..., 2]
def gamma_beta_3(P):  return P[..., 3]
def gas_pressure(P):  return P[..., 4]


def gamma_beta_squared(P):
    return P[..., 1] * P[..., 1] + P[..., 2] * P[..., 2] + P[..., 3] * P[..., 3]


def lorentz_factor(P):
    return torch.sqrt(1.0 + gamma_beta_squared(P))


def beta_along(P, nhat):
    n1, n2, n3 = nhat
    return (n1 * P[..., 1] + n2 * P[..., 2] + n3 * P[..., 3]) / lorentz_factor(P)


def enthalpy_density(P, gamma_law_index):
    """rho + p * (1 + 1/(gamma-1)) (physics_srhd.hpp:124-127)."""
    return mass_density(P) + gas_pressure(P) * (1.0 + 1.0 / (gamma_law_index - 1.0))


def specific_enthalpy(P, gamma_law_index):
    return enthalpy_density(P, gamma_law_index) / mass_density(P)


def specific_entropy(P, gamma_law_index):
    return torch.log(gas_pressure(P) / mass_density(P) ** gamma_law_index)


def sound_speed_squared(P, gamma_law_index):
    """gamma p / (rho h) (physics_srhd.hpp:198-201)."""
    return gamma_law_index * gas_pressure(P) / enthalpy_density(P, gamma_law_index)


# -----------------------------------------------------------------------------
# conversions and fluxes (physics_srhd.hpp:204-280)
# -----------------------------------------------------------------------------

def to_conserved_density(P, gamma_law_index):
    W = lorentz_factor(P)
    h = specific_enthalpy(P, gamma_law_index)
    D = mass_density(P) * W
    p = gas_pressure(P)
    return torch.stack([D, D * P[..., 1] * h, D * P[..., 2] * h,
                        D * P[..., 3] * h, D * h * W - p - D], dim=-1)


def flux(P, nhat, gamma_law_index=None, U=None):
    if U is None:
        U = to_conserved_density(P, gamma_law_index)
    v = beta_along(P, nhat)
    p = gas_pressure(P)
    n1, n2, n3 = nhat
    return torch.stack([
        v * U[..., 0],
        v * U[..., 1] + p * n1,
        v * U[..., 2] + p * n2,
        v * U[..., 3] + p * n3,
        v * U[..., 4] + p * v,
    ], dim=-1)


def wavespeeds(P, nhat, gamma_law_index):
    """Relativistic acoustic speeds (physics_srhd.hpp:283-300)."""
    c2 = sound_speed_squared(P, gamma_law_index)
    vn = beta_along(P, nhat)
    uu = gamma_beta_squared(P)
    vv = uu / (1.0 + uu)
    v2 = vn * vn
    k0 = torch.sqrt(c2 * (1.0 - vv) * (1.0 - vv * c2 - v2 * (1.0 - c2)))
    return ((vn * (1.0 - c2) - k0) / (1.0 - vv * c2),
            (vn * (1.0 - c2) + k0) / (1.0 - vv * c2))


def max_wavespeed(P, gamma_law_index):
    """Upper bound on signal speed for CFL (always < 1 = c)."""
    am1, ap1 = wavespeeds(P, (1.0, 0.0, 0.0), gamma_law_index)
    am2, ap2 = wavespeeds(P, (0.0, 1.0, 0.0), gamma_law_index)
    a1 = torch.maximum(torch.abs(am1), torch.abs(ap1))
    a2 = torch.maximum(torch.abs(am2), torch.abs(ap2))
    return torch.maximum(a1, a2)


# -----------------------------------------------------------------------------
# geometry source terms (physics_srhd.hpp:309-362)
# -----------------------------------------------------------------------------

def spherical_geometry_source_terms(P, spherical_radius, polar_angle_theta,
                                    gamma_law_index):
    cotq = torch.tan(torch.pi / 2 - polar_angle_theta)
    ur, uq, up = P[..., 1], P[..., 2], P[..., 3]
    pg = gas_pressure(P)
    H = enthalpy_density(P, gamma_law_index)
    r = spherical_radius
    z = torch.zeros_like(pg)
    return torch.stack([
        z,
        (2.0 * pg + H * (uq * uq + up * up)) / r,
        (cotq * pg + H * (up * up * cotq - ur * uq)) / r,
        -up * H * (ur + uq * cotq) / r,
        z,
    ], dim=-1)


def spherical_geometry_source_terms_radial(P, spherical_radius,
                                           gamma_law_index):
    uq = P[..., 2]
    pg = gas_pressure(P)
    H = enthalpy_density(P, gamma_law_index)
    z = torch.zeros_like(pg)
    return torch.stack([z, (2.0 * pg + H * uq * uq) / spherical_radius,
                        z, z, z], dim=-1)


# -----------------------------------------------------------------------------
# primitive recovery: masked Newton (physics_srhd.hpp:364-440)
# -----------------------------------------------------------------------------

def _newton(D, SS, tau, p0, gm, eps_rel, f_floor):
    """The masked chunked Newton on the pressure from p0: (p, W0, done).
    W0 is the W of each cell's converging update (the reference records W
    before the final p update, then breaks), 1 where a cell never
    converges; a converged cell is frozen."""

    def newton_vars(p):
        q = tau + D + p
        v2 = torch.clamp(SS / (q * q), max=1.0 - 1e-10)
        W2 = 1.0 / (1.0 - v2)
        W = torch.sqrt(W2)
        e = (tau + D * (1.0 - W) + p * (1.0 - W2)) / (D * W)
        d = D / W
        h = 1.0 + e + p / d
        cs2 = gm * p / (d * h)
        f = d * e * (gm - 1.0) - p
        g = v2 * cs2 - 1.0
        return W, f, g

    def one_update(p, Wc, done):
        W, f, g = newton_vars(p)
        p_next = p - f / g
        newly = torch.abs(f) < ERROR_TOLERANCE + f_floor + eps_rel * torch.abs(p)
        # frozen once done; on the converging step the reference still
        # applies the p update before breaking
        p_out = torch.where(done, p, p_next)
        W_out = torch.where(done, Wc, torch.where(newly, W, Wc))
        return p_out, W_out, done | newly

    rec = tracing.recorder()
    p, W0 = p0, torch.ones_like(D)
    done = torch.zeros_like(D, dtype=torch.bool)
    it = 0
    # the while_loop's test, read on the host once per pass of CHUNK updates
    while it < NEWTON_ITER_MAX:
        rec.count("recover_passes")
        if bool(done.all()):
            break
        for _ in range(CHUNK):
            p, W0, done = one_update(p, W0, done)
        it += CHUNK
    return p, W0, done


def recover_primitive(U, gamma_law_index, temperature_floor=0.0,
                      return_fault=False):
    """Iterative pressure solve over all leading axes (see _newton). With
    return_fault=True also returns a bool tensor marking cells where the
    solver failed to converge or produced non-physical output.

    dtype-aware tolerance, as the JAX package's: the relative floor
    8 eps (|tau| + D + |p|) is on only where eps > 1e-12 (float32), so
    float64 keeps the reference's absolute 1e-10."""
    gm = gamma_law_index
    D = U[..., 0]
    tau = U[..., 4]
    SS = U[..., 1] * U[..., 1] + U[..., 2] * U[..., 2] + U[..., 3] * U[..., 3]
    eps = torch.finfo(D.dtype).eps
    if eps > 1e-12:
        eps_rel = 8.0 * eps
        f_floor = eps_rel * (torch.abs(tau) + D)
    else:
        eps_rel = 0.0
        f_floor = 0.0
    p, W0, done = _newton(D, SS, tau, torch.zeros_like(D), gm, eps_rel,
                          f_floor)

    if temperature_floor > 0.0:
        p = torch.maximum(p, temperature_floor * D / W0)

    denom = tau + D + p
    P = torch.stack([D / W0, W0 * U[..., 1] / denom, W0 * U[..., 2] / denom,
                     W0 * U[..., 3] / denom, p], dim=-1)
    if return_fault:
        fault = (~done) | (P[..., 0] <= 0.0) | (P[..., 4] <= 0.0) \
            | torch.isnan(W0)
        return P, fault
    return P


def recovery_failed(U, gamma_law_index, temperature_floor=0.0):
    """True anywhere primitive recovery would have thrown in the reference."""
    _, fault = recover_primitive(U, gamma_law_index, temperature_floor,
                                 return_fault=True)
    return torch.any(fault)


# -----------------------------------------------------------------------------
# HLLE (physics_srhd.hpp:466-490)
# -----------------------------------------------------------------------------

def riemann_hlle(Pl, Pr, nhat, gamma_law_index):
    Ul = to_conserved_density(Pl, gamma_law_index)
    Ur = to_conserved_density(Pr, gamma_law_index)
    alm, alp = wavespeeds(Pl, nhat, gamma_law_index)
    arm, arp = wavespeeds(Pr, nhat, gamma_law_index)
    Fl = flux(Pl, nhat, U=Ul)
    Fr = flux(Pr, nhat, U=Ur)
    ap = torch.clamp(torch.maximum(alp, arp), min=0.0)[..., None]
    am = torch.clamp(torch.minimum(alm, arm), max=0.0)[..., None]
    return (Fl * ap - Fr * am - (Ul - Ur) * ap * am) / (ap - am)


def primitive_from_quantities(mass_density, gamma_beta_1, gamma_beta_2,
                              gamma_beta_3, gas_pressure):
    """P from rho [M/L^3], gamma-beta (dimensionless), p [M/L/T^2]."""
    return torch.stack(torch.broadcast_tensors(
        mass_density, gamma_beta_1, gamma_beta_2, gamma_beta_3,
        gas_pressure), dim=-1)


# -----------------------------------------------------------------------------
# tuple (structure-of-arrays) forms: the same formulas and rounding per cell
# -----------------------------------------------------------------------------

def unstack(P):
    """[..., 5] -> 5-tuple of component tensors."""
    return tuple(P[..., k] for k in range(NUM_COMPONENTS))


def stack(Pt):
    return torch.stack(Pt, dim=-1)


def lorentz_factor_t(Pt):
    return torch.sqrt(1.0 + Pt[1] * Pt[1] + Pt[2] * Pt[2] + Pt[3] * Pt[3])


def to_conserved_density_t(Pt, gamma_law_index):
    rho, u1, u2, u3, p = Pt
    W = lorentz_factor_t(Pt)
    # h = enthalpy_density / rho, spelled as the stacked path rounds it
    h = (rho + p * (1.0 + 1.0 / (gamma_law_index - 1.0))) / rho
    D = rho * W
    return (D, D * u1 * h, D * u2 * h, D * u3 * h, D * h * W - p - D)


def wavespeeds_t(Pt, nhat, gamma_law_index):
    rho, u1, u2, u3, p = Pt
    n1, n2, n3 = nhat
    W = lorentz_factor_t(Pt)
    c2 = gamma_law_index * p / (rho + p * (1.0 + 1.0
                                           / (gamma_law_index - 1.0)))
    vn = (n1 * u1 + n2 * u2 + n3 * u3) / W
    uu = u1 * u1 + u2 * u2 + u3 * u3
    vv = uu / (1.0 + uu)
    v2 = vn * vn
    k0 = torch.sqrt(c2 * (1.0 - vv) * (1.0 - vv * c2 - v2 * (1.0 - c2)))
    return ((vn * (1.0 - c2) - k0) / (1.0 - vv * c2),
            (vn * (1.0 - c2) + k0) / (1.0 - vv * c2))


def flux_t(Pt, nhat, Ut):
    rho, u1, u2, u3, p = Pt
    n1, n2, n3 = nhat
    W = lorentz_factor_t(Pt)
    v = (n1 * u1 + n2 * u2 + n3 * u3) / W
    return (v * Ut[0], v * Ut[1] + p * n1, v * Ut[2] + p * n2,
            v * Ut[3] + p * n3, v * Ut[4] + p * v)


def riemann_hlle_t(Plt, Prt, nhat, gamma_law_index):
    """HLLE on tuples (physics_srhd.hpp:466-490)."""
    Ul = to_conserved_density_t(Plt, gamma_law_index)
    Ur = to_conserved_density_t(Prt, gamma_law_index)
    alm, alp = wavespeeds_t(Plt, nhat, gamma_law_index)
    arm, arp = wavespeeds_t(Prt, nhat, gamma_law_index)
    Fl = flux_t(Plt, nhat, Ul)
    Fr = flux_t(Prt, nhat, Ur)
    ap = torch.clamp(torch.maximum(alp, arp), min=0.0)
    am = torch.clamp(torch.minimum(alm, arm), max=0.0)
    return tuple((fl * ap - fr * am - (ul - ur) * ap * am) / (ap - am)
                 for fl, fr, ul, ur in zip(Fl, Fr, Ul, Ur))


def recover_primitive_t(Ut, gamma_law_index, temperature_floor=0.0,
                        p_guess=None):
    """Tuple form of recover_primitive (the same masked chunked Newton).
    p_guess warm-starts the pressure iteration; the default p = 0 is the
    reference's (physics_srhd.hpp:393). Unlike recover_primitive, the
    relative floor 8 eps (|tau| + D + |p|) is on in every dtype, as in the
    JAX package."""
    gm = gamma_law_index
    D, S1, S2, S3, tau = Ut
    SS = S1 * S1 + S2 * S2 + S3 * S3
    p0 = torch.zeros_like(D) if p_guess is None else \
        torch.clamp(p_guess, min=0.0)
    eps_rel = 8.0 * torch.finfo(D.dtype).eps
    f_floor = eps_rel * (torch.abs(tau) + D)
    p, W0, _ = _newton(D, SS, tau, p0, gm, eps_rel, f_floor)

    if temperature_floor > 0.0:
        p = torch.maximum(p, temperature_floor * D / W0)

    denom = tau + D + p
    return (D / W0, W0 * S1 / denom, W0 * S2 / denom, W0 * S3 / denom, p)


def spherical_geometry_source_terms_t(Pt, spherical_radius,
                                      polar_angle_theta, gamma_law_index):
    rho, ur, uq, up, pg = Pt
    cotq = torch.tan(torch.pi / 2 - polar_angle_theta)
    H = rho + pg * (1.0 + 1.0 / (gamma_law_index - 1.0))
    r = spherical_radius
    z = torch.zeros(torch.broadcast_shapes(pg.shape,
                                           torch.as_tensor(r).shape),
                    dtype=pg.dtype, device=pg.device)
    return (z,
            (2.0 * pg + H * (uq * uq + up * up)) / r,
            (cotq * pg + H * (up * up * cotq - ur * uq)) / r,
            -up * H * (ur + uq * cotq) / r,
            z)


def spherical_geometry_source_terms_radial_t(Pt, spherical_radius,
                                             gamma_law_index):
    rho, ur, uq, up, pg = Pt
    H = rho + pg * (1.0 + 1.0 / (gamma_law_index - 1.0))
    z = torch.zeros_like(pg)
    return (z, (2.0 * pg + H * uq * uq) / spherical_radius, z, z, z)
