"""Newtonian ideal-gas (gamma-law) Euler system, 5 components.

Port of mara3_tpu/physics/euler.py (the reference's physics_euler.hpp).
States are tensors with a trailing component axis: primitive P = [rho, v1,
v2, v3, p], conserved density U = [rho, rho*v, E]; the tuple forms (`*_t`)
take and return 5-tuples of component tensors. Every formula keeps the JAX
package's operation order, so the two agree to round-off.

Not ported yet (ROADMAP.md queue A item 10, with core/matrix.py and
core/dimensional.py): the eigensystem (flux_jacobian, eigenvalues,
right/left_eigenvectors, eigensystem) and the unit-tagged
conserved_quantities. primitive_from_quantities takes plain tensors: the
unit check it makes in the JAX package changes no value.
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.core.ops import div_scalar

NUM_COMPONENTS = 5


# -----------------------------------------------------------------------------
# primitive accessors / thermodynamics (physics_euler.hpp:84-200)
# -----------------------------------------------------------------------------

def mass_density(P):   return P[..., 0]
def velocity_1(P):     return P[..., 1]
def velocity_2(P):     return P[..., 2]
def velocity_3(P):     return P[..., 3]
def gas_pressure(P):   return P[..., 4]


def velocity_squared(P):
    return P[..., 1] * P[..., 1] + P[..., 2] * P[..., 2] + P[..., 3] * P[..., 3]


def velocity_along(P, nhat):
    n1, n2, n3 = nhat
    return n1 * P[..., 1] + n2 * P[..., 2] + n3 * P[..., 3]


def enthalpy_density(P, gamma_law_index):
    """H = u + p = p * (1 + 1/(gamma-1)) (physics_euler.hpp:133-136)."""
    return gas_pressure(P) * (1.0 + 1.0 / (gamma_law_index - 1.0))


def specific_enthalpy(P, gamma_law_index):
    return enthalpy_density(P, gamma_law_index) / mass_density(P)


def specific_entropy(P, gamma_law_index):
    """log(p / rho^gamma) (physics_euler.hpp:146-149)."""
    return torch.log(gas_pressure(P) / mass_density(P) ** gamma_law_index)


def sound_speed_squared(P, gamma_law_index):
    return gamma_law_index * gas_pressure(P) / mass_density(P)


# -----------------------------------------------------------------------------
# conversions and fluxes (physics_euler.hpp:203-268)
# -----------------------------------------------------------------------------

def to_conserved_density(P, gamma_law_index):
    d = mass_density(P)
    return torch.stack([
        d,
        d * P[..., 1],
        d * P[..., 2],
        d * P[..., 3],
        0.5 * d * velocity_squared(P)
        + div_scalar(gas_pressure(P), gamma_law_index - 1.0),
    ], dim=-1)


def recover_primitive(U, gamma_law_index, temperature_floor=0.0):
    """Algebraic primitive recovery with optional temperature floor
    (physics_euler.hpp:555-612)."""
    d = U[..., 0]
    p_squared = U[..., 1] * U[..., 1] + U[..., 2] * U[..., 2] \
        + U[..., 3] * U[..., 3]
    pressure = (U[..., 4] - 0.5 * p_squared / d) * (gamma_law_index - 1.0)
    if temperature_floor > 0.0:
        pressure = torch.where(pressure < 0.0, temperature_floor * d,
                               pressure)
    return torch.stack([d, U[..., 1] / d, U[..., 2] / d, U[..., 3] / d,
                        pressure], dim=-1)


def flux(P, nhat, gamma_law_index=None, U=None):
    """Flux of conserved quantities along `nhat` (physics_euler.hpp:240-268);
    pass a precomputed U to skip the conversion."""
    if U is None:
        U = to_conserved_density(P, gamma_law_index)
    v = velocity_along(P, nhat)
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
    """(vn - cs, vn + cs) (physics_euler.hpp:270-286)."""
    cs = torch.sqrt(sound_speed_squared(P, gamma_law_index))
    vn = velocity_along(P, nhat)
    return vn - cs, vn + cs


def max_wavespeed(P, gamma_law_index):
    """Fastest signal speed over the coordinate axes, for CFL timesteps."""
    cs = torch.sqrt(sound_speed_squared(P, gamma_law_index))
    v = torch.amax(torch.abs(P[..., 1:4]), dim=-1)
    return v + cs


# -----------------------------------------------------------------------------
# geometry source terms (physics_euler.hpp:298-345)
# -----------------------------------------------------------------------------

def spherical_geometry_source_terms(P, spherical_radius, polar_angle_theta,
                                    gamma_law_index):
    """Spherical-polar source terms (physics_euler.hpp:298-320)."""
    cotq = torch.tan(torch.pi / 2 - polar_angle_theta)
    vr, vq, vp = P[..., 1], P[..., 2], P[..., 3]
    pg, d = gas_pressure(P), mass_density(P)
    r = spherical_radius
    z = torch.zeros_like(pg)
    return torch.stack([
        z,
        (2.0 * pg + d * (vq * vq + vp * vp)) / r,
        (cotq * pg + d * (vp * vp * cotq - vr * vq)) / r,
        -vp * d * (vr + vq * cotq) / r,
        z,
    ], dim=-1)


def spherical_geometry_source_terms_radial(P, spherical_radius,
                                           gamma_law_index):
    """1d radial special case (physics_euler.hpp:328-345)."""
    vq = P[..., 2]
    pg, d = gas_pressure(P), mass_density(P)
    z = torch.zeros_like(pg)
    return torch.stack([z, (2.0 * pg + d * vq * vq) / spherical_radius,
                        z, z, z], dim=-1)


# -----------------------------------------------------------------------------
# Roe average and HLLE (physics_euler.hpp:590-640)
# -----------------------------------------------------------------------------

def roe_average(Pl, Pr):
    """sqrt(rho)-weighted primitive average (physics_euler.hpp:590-600)."""
    kl = torch.sqrt(mass_density(Pl))[..., None]
    kr = torch.sqrt(mass_density(Pr))[..., None]
    return (Pr * kr + Pl * kl) / (kr + kl)


def riemann_hlle(Pl, Pr, nhat, gamma_law_index):
    """HLLE flux (physics_euler.hpp:614-640)."""
    Ul = to_conserved_density(Pl, gamma_law_index)
    Ur = to_conserved_density(Pr, gamma_law_index)
    alm, alp = wavespeeds(Pl, nhat, gamma_law_index)
    arm, arp = wavespeeds(Pr, nhat, gamma_law_index)
    Fl = flux(Pl, nhat, U=Ul)
    Fr = flux(Pr, nhat, U=Ur)
    ap = torch.clamp(torch.maximum(alp, arp), min=0.0)[..., None]
    am = torch.clamp(torch.minimum(alm, arm), max=0.0)[..., None]
    return (Fl * ap - Fr * am - (Ul - Ur) * ap * am) / (ap - am)


def primitive_from_quantities(mass_density, velocity_1, velocity_2,
                              velocity_3, gas_pressure):
    """P from rho [M/L^3], v [L/T], p [M/L/T^2], broadcast together."""
    return torch.stack(torch.broadcast_tensors(
        mass_density, velocity_1, velocity_2, velocity_3, gas_pressure),
        dim=-1)


# -----------------------------------------------------------------------------
# tuple (structure-of-arrays) forms: the same formulas and rounding per cell
# -----------------------------------------------------------------------------

def to_conserved_density_t(Pt, gamma_law_index):
    d, v1, v2, v3, p = Pt
    return (d, d * v1, d * v2, d * v3,
            0.5 * d * (v1 * v1 + v2 * v2 + v3 * v3)
            + div_scalar(p, gamma_law_index - 1.0))


def recover_primitive_t(Ut, gamma_law_index, temperature_floor=0.0):
    d, m1, m2, m3, E = Ut
    p_squared = m1 * m1 + m2 * m2 + m3 * m3
    pressure = (E - 0.5 * p_squared / d) * (gamma_law_index - 1.0)
    if temperature_floor > 0.0:
        pressure = torch.where(pressure < 0.0, temperature_floor * d,
                               pressure)
    return (d, m1 / d, m2 / d, m3 / d, pressure)


def flux_t(Pt, nhat, Ut):
    d, v1, v2, v3, p = Pt
    n1, n2, n3 = nhat
    v = n1 * v1 + n2 * v2 + n3 * v3
    return (v * Ut[0], v * Ut[1] + p * n1, v * Ut[2] + p * n2,
            v * Ut[3] + p * n3, v * Ut[4] + p * v)


def wavespeeds_t(Pt, nhat, gamma_law_index):
    d, v1, v2, v3, p = Pt
    n1, n2, n3 = nhat
    cs = torch.sqrt(gamma_law_index * p / d)
    vn = n1 * v1 + n2 * v2 + n3 * v3
    return vn - cs, vn + cs


def riemann_hlle_t(Plt, Prt, nhat, gamma_law_index):
    """HLLE on tuples (physics_euler.hpp:614-640)."""
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


def spherical_geometry_source_terms_radial_t(Pt, spherical_radius,
                                             gamma_law_index):
    d, v1, vq, v3, pg = Pt
    z = torch.zeros_like(pg)
    return (z, (2.0 * pg + d * vq * vq) / spherical_radius, z, z, z)
