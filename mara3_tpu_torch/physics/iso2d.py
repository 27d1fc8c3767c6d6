"""2D isothermal / locally-isothermal thin-disk system, 3 components.

Port of mara3_tpu/physics/iso2d.py (itself a re-design of
src/physics_iso2d.hpp): the parts the flagship binary scheme uses. Primitive
P = [sigma, vx, vy] (physics_iso2d.hpp:156-168). Two conservation
formulations exist, as in the reference:

- linear momentum U = [sigma, sigma*vx, sigma*vy] (physics_iso2d.hpp:64-68)
- angular momentum Q = [sigma, s_r = sigma*(x.v), l_z = sigma*(x ^ v)]
  (physics_iso2d.hpp:86-90), position-dependent.

The sound speed is *per-interface* (locally isothermal disks), so all flux
functions take cs^2 tensors. Every function is plain torch ops over tensors
whose trailing axis is the component axis; the operation order follows the
JAX package term for term, so the two agree to round-off.

Negative densities: the reference throws from recover_primitive
(physics_iso2d.hpp:359); here `contains_invalid` exposes the same fault as a
value, and the driver loop retries the step in safe mode.
"""

from __future__ import annotations

import torch

NUM_COMPONENTS = 3


def sigma(P):       return P[..., 0]
def velocity_x(P):  return P[..., 1]
def velocity_y(P):  return P[..., 2]


def velocity_squared(P):
    return P[..., 1] ** 2 + P[..., 2] ** 2


def velocity_along(P, nhat):
    n1, n2 = nhat[0], nhat[1]
    return n1 * P[..., 1] + n2 * P[..., 2]


def gas_pressure(P, sound_speed_squared):
    """Vertically integrated pressure sigma * cs^2 (physics_iso2d.hpp:225-233)."""
    return sigma(P) * sound_speed_squared


# -----------------------------------------------------------------------------
# conversions (physics_iso2d.hpp:240-300, 351-470)
# -----------------------------------------------------------------------------

def to_conserved_per_area(P):
    s = sigma(P)
    return torch.stack([s, s * P[..., 1], s * P[..., 2]], dim=-1)


def to_conserved_angmom_per_area(P, x):
    """[sigma, sigma*(x.v), sigma*(x cross v)_z] at position x = (x, y)
    (physics_iso2d.hpp:259-269)."""
    s = sigma(P)
    x0, x1 = x[..., 0], x[..., 1]
    vx, vy = P[..., 1], P[..., 2]
    return torch.stack([s,
                        s * (x0 * vx + x1 * vy),
                        s * (x0 * vy - x1 * vx)], dim=-1)


def recover_primitive(U):
    """From linear-momentum conserved state (physics_iso2d.hpp:351-374).
    Raises nothing; see contains_invalid."""
    s = U[..., 0]
    return torch.stack([s, U[..., 1] / s, U[..., 2] / s], dim=-1)


def recover_primitive_angmom(Q, x):
    """From angular-momentum conserved state at position x
    (physics_iso2d.hpp:376-400)."""
    s = Q[..., 0]
    sr = Q[..., 1] / s
    lz = Q[..., 2] / s
    x0, x1 = x[..., 0], x[..., 1]
    r2 = x0 * x0 + x1 * x1
    return torch.stack([s,
                        (sr * x0 - lz * x1) / r2,
                        (sr * x1 + lz * x0) / r2], dim=-1)


def to_conserved_per_area_from_angmom(Q, x):
    """Q -> U at position x (physics_iso2d.hpp:410-430)."""
    s, Sr, Lz = Q[..., 0], Q[..., 1], Q[..., 2]
    x0, x1 = x[..., 0], x[..., 1]
    r2 = x0 * x0 + x1 * x1
    return torch.stack([s,
                        (Sr * x0 - Lz * x1) / r2,
                        (Sr * x1 + Lz * x0) / r2], dim=-1)


def angular_momentum(U, x):
    """l_z = x py - y px (physics_iso2d.hpp:462-466)."""
    return x[..., 0] * U[..., 2] - x[..., 1] * U[..., 1]


def contains_invalid(U):
    """True (a 0-d bool tensor) if any cell has negative (or NaN) surface
    density — the value-level analog of the reference's thrown
    invalid_argument (physics_iso2d.hpp:359)."""
    s = U[..., 0]
    return torch.any(torch.logical_or(s < 0.0, torch.isnan(s)))


# -----------------------------------------------------------------------------
# sources, fluxes, wavespeeds (physics_iso2d.hpp:273-335)
# -----------------------------------------------------------------------------

def source_terms_conserved_angmom(P, sound_speed_squared):
    """Geometric s_r source: d(s_r)/dt = 2*(Ek + pg)
    (physics_iso2d.hpp:273-285)."""
    Ek = 0.5 * sigma(P) * velocity_squared(P)
    pg = gas_pressure(P, sound_speed_squared)
    z = torch.zeros_like(Ek)
    return torch.stack([z, 2.0 * (Ek + pg), z], dim=-1)


def flux(P, nhat, sound_speed_squared):
    """(physics_iso2d.hpp:289-303)."""
    v = velocity_along(P, nhat)
    p = gas_pressure(P, sound_speed_squared)
    s = sigma(P)
    n1, n2 = nhat[0], nhat[1]
    return torch.stack([
        v * s,
        v * s * P[..., 1] + p * n1,
        v * s * P[..., 2] + p * n2,
    ], dim=-1)


def wavespeeds(P, nhat, sound_speed_squared):
    cs = torch.sqrt(sound_speed_squared)
    vn = velocity_along(P, nhat)
    return vn - cs, vn + cs


def max_wavespeed(P, sound_speed_squared):
    """max over x/y axes of |v| + cs (physics_iso2d.hpp:325-333)."""
    cs = torch.sqrt(sound_speed_squared)
    vx = torch.abs(P[..., 1]) + cs
    vy = torch.abs(P[..., 2]) + cs
    return torch.maximum(vx, vy)


# -----------------------------------------------------------------------------
# Riemann solvers (physics_iso2d.hpp:488-712)
# -----------------------------------------------------------------------------

def riemann_hlle(Pl, Pr, cs2_l, cs2_r, nhat):
    """(physics_iso2d.hpp:488-520)."""
    Ul = to_conserved_per_area(Pl)
    Ur = to_conserved_per_area(Pr)
    alm, alp = wavespeeds(Pl, nhat, cs2_l)
    arm, arp = wavespeeds(Pr, nhat, cs2_r)
    Fl = flux(Pl, nhat, cs2_l)
    Fr = flux(Pr, nhat, cs2_r)
    ap = torch.clamp(torch.maximum(alp, arp), min=0.0)[..., None]
    am = torch.clamp(torch.minimum(alm, arm), max=0.0)[..., None]
    return (Fl * ap - Fr * am - (Ul - Ur) * ap * am) / (ap - am)


def compute_hllc_variables(Pl, Pr, cs2_l, cs2_r, nhat):
    """Toro 3rd ed. sec 10.6 intermediate quantities, isothermal gamma=1
    (physics_iso2d.hpp:610-702). Returns a dict for testability, as the
    reference returns a variables struct for its unit tests."""
    ul = velocity_along(Pl, nhat)
    ur = velocity_along(Pr, nhat)
    n1, n2 = nhat[0], nhat[1]

    sigma_l, sigma_r = sigma(Pl), sigma(Pr)
    sigma_bar = 0.5 * (sigma_l + sigma_r)
    al, ar = torch.sqrt(cs2_l), torch.sqrt(cs2_r)
    a_bar = 0.5 * (al + ar)

    press_l = sigma_l * cs2_l
    press_r = sigma_r * cs2_r
    ppvrs = 0.5 * (press_l + press_r) - 0.5 * (ur - ul) * sigma_bar * a_bar
    pstar = torch.clamp(ppvrs, min=0.0)

    ql = torch.clamp(torch.sqrt(pstar / press_l), min=1.0)
    qr = torch.clamp(torch.sqrt(pstar / press_r), min=1.0)

    sl = ul - al * ql
    sr = ur + ar * qr

    den = sigma_l * (sl - ul) - sigma_r * (sr - ur)
    sstar = (press_r - press_l + ul * sigma_l * (sl - ul)
             - ur * sigma_r * (sr - ur)) / den

    # perpendicular velocity components (velocity minus its normal part)
    vperp_l = torch.stack([Pl[..., 1] - n1 * ul, Pl[..., 2] - n2 * ul], dim=-1)
    vperp_r = torch.stack([Pr[..., 1] - n1 * ur, Pr[..., 2] - n2 * ur], dim=-1)

    return dict(ul=ul, ur=ur, sigma_l=sigma_l, sigma_r=sigma_r,
                sigma_bar=sigma_bar, al=al, ar=ar, a_bar=a_bar,
                press_l=press_l, press_r=press_r, ppvrs=ppvrs, pstar=pstar,
                ql=ql, qr=qr, sl=sl, sr=sr, sstar=sstar,
                vperp_l=vperp_l, vperp_r=vperp_r)


def riemann_hllc(Pl, Pr, cs2_l, cs2_r, nhat):
    """HLLC flux, Toro 3rd ed. sec 10.6 (physics_iso2d.hpp:704-712). The
    reference's four-way branch becomes nested `where` selection."""
    v = compute_hllc_variables(Pl, Pr, cs2_l, cs2_r, nhat)
    n1, n2 = nhat[0], nhat[1]

    Ul = to_conserved_per_area(Pl)
    Ur = to_conserved_per_area(Pr)
    Fl = flux(Pl, nhat, v["al"] ** 2)
    Fr = flux(Pr, nhat, v["ar"] ** 2)

    sl, sr, sstar = v["sl"], v["sr"], v["sstar"]

    dl = v["sigma_l"] * (sl - v["ul"]) / (sl - sstar)
    dr = v["sigma_r"] * (sr - v["ur"]) / (sr - sstar)
    Ul_star = torch.stack([
        dl,
        dl * (sstar * n1 + v["vperp_l"][..., 0]),
        dl * (sstar * n2 + v["vperp_l"][..., 1]),
    ], dim=-1)
    Ur_star = torch.stack([
        dr,
        dr * (sstar * n1 + v["vperp_r"][..., 0]),
        dr * (sstar * n2 + v["vperp_r"][..., 1]),
    ], dim=-1)

    Fl_star = Fl + (Ul_star - Ul) * sl[..., None]
    Fr_star = Fr + (Ur_star - Ur) * sr[..., None]

    slp = sl[..., None]
    srp = sr[..., None]
    ssp = sstar[..., None]
    return torch.where(slp >= 0.0, Fl,
           torch.where(ssp >= 0.0, Fl_star,
           torch.where(srp >= 0.0, Fr_star, Fr)))
