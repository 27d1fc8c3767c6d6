"""Two-body orbital mechanics for the plain reference of the flagship.

Plain float64 Python on the host, as the reference C++ code computes it
(model_two_body.hpp): the binary's state from its orbital elements at a
time (Kepler's equation), the inverse map, and the periodic-aware
difference of two element sets. Copied for this benchmark from the
program's host module, so that the reference imports nothing of the
program under test.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace


@dataclass(frozen=True)
class OrbitalElements:
    """(a, M, q, e) (reference orbital_elements_t, model_two_body.hpp:43-51)."""
    separation: float = 1.0
    total_mass: float = 1.0
    mass_ratio: float = 1.0
    eccentricity: float = 0.0


@dataclass(frozen=True)
class FullOrbitalElements:
    """Adds periapse argument, time of last periapse, and CM position/velocity
    (reference full_orbital_elements_t, model_two_body.hpp:53-68)."""
    pomega: float = 0.0
    tau: float = 0.0
    cm_position_x: float = 0.0
    cm_position_y: float = 0.0
    cm_velocity_x: float = 0.0
    cm_velocity_y: float = 0.0
    elements: OrbitalElements = OrbitalElements()

    def __add__(self, o):
        return FullOrbitalElements(
            self.pomega + o.pomega, self.tau + o.tau,
            self.cm_position_x + o.cm_position_x,
            self.cm_position_y + o.cm_position_y,
            self.cm_velocity_x + o.cm_velocity_x,
            self.cm_velocity_y + o.cm_velocity_y,
            OrbitalElements(
                self.elements.separation + o.elements.separation,
                self.elements.total_mass + o.elements.total_mass,
                self.elements.mass_ratio + o.elements.mass_ratio,
                self.elements.eccentricity + o.elements.eccentricity))

    def __sub__(self, o):
        return self + (o * -1.0)

    def __mul__(self, s: float):
        return FullOrbitalElements(
            self.pomega * s, self.tau * s,
            self.cm_position_x * s, self.cm_position_y * s,
            self.cm_velocity_x * s, self.cm_velocity_y * s,
            OrbitalElements(
                self.elements.separation * s,
                self.elements.total_mass * s,
                self.elements.mass_ratio * s,
                self.elements.eccentricity * s))


@dataclass(frozen=True)
class PointMass:
    mass: float = 1.0
    position_x: float = 0.0
    position_y: float = 0.0
    velocity_x: float = 0.0
    velocity_y: float = 0.0


@dataclass(frozen=True)
class TwoBodyState:
    body1: PointMass
    body2: PointMass


def _solve_newton_raphson(f, g, x0, tolerance=1e-10):
    """(reference model_two_body.hpp:131-160)."""
    x = x0
    y = f(x)
    while abs(y) > tolerance:
        x -= y / g(x)
        y = f(x)
    return x


def _clamp(x0, x1, x):
    return min(max(x, x0), x1)


def compute_two_body_state(params, t: float) -> TwoBodyState:
    """Solve Kepler's equation and return both bodies' states at time t
    (reference model_two_body.hpp:168-209 for bare elements; 213-270 for the
    full elements with pomega rotation and CM boost)."""
    if isinstance(params, FullOrbitalElements):
        return _compute_full_state(params, t)

    e = params.eccentricity
    q = params.mass_ratio
    a = params.separation
    omega = 0.0 if a == 0.0 else math.sqrt(params.total_mass / a / a / a)
    mu = q / (1.0 + q)

    def from_E(E):
        b1 = PointMass(
            mass=params.total_mass * (1 - mu),
            position_x=-a * mu * (e - math.cos(E)),
            position_y=+a * mu * math.sin(E) * math.sqrt(1 - e * e),
            velocity_x=-a * mu * omega / (1 - e * math.cos(E)) * math.sin(E),
            velocity_y=+a * mu * omega / (1 - e * math.cos(E)) * math.cos(E)
                       * math.sqrt(1 - e * e))
        b2 = PointMass(
            mass=params.total_mass * mu,
            position_x=-b1.position_x / q,
            position_y=-b1.position_y / q,
            velocity_x=-b1.velocity_x / q,
            velocity_y=-b1.velocity_y / q)
        return TwoBodyState(b1, b2)

    if e > 0.0:
        M = omega * t
        E = _solve_newton_raphson(
            lambda E: E - e * math.sin(E) - M,
            lambda E: 1 - e * math.cos(E), M)
        return from_E(E)
    return from_E(omega * t)


def _compute_full_state(params: FullOrbitalElements, t: float) -> TwoBodyState:
    while t < params.tau:
        t += orbital_period(params.elements)
    local = compute_two_body_state(params.elements, t - params.tau)

    c = math.cos(-params.pomega)
    s = math.sin(-params.pomega)

    def transform(b: PointMass) -> PointMass:
        xr = +b.position_x * c + b.position_y * s
        yr = -b.position_x * s + b.position_y * c
        vxr = +b.velocity_x * c + b.velocity_y * s
        vyr = -b.velocity_x * s + b.velocity_y * c
        return PointMass(b.mass,
                         xr + params.cm_position_x,
                         yr + params.cm_position_y,
                         vxr + params.cm_velocity_x,
                         vyr + params.cm_velocity_y)

    return TwoBodyState(transform(local.body1), transform(local.body2))


def make_full_orbital_elements_with_zeros() -> FullOrbitalElements:
    return FullOrbitalElements(elements=OrbitalElements(0.0, 0.0, 0.0, 0.0))


def make_full_orbital_elements(elements: OrbitalElements) -> FullOrbitalElements:
    return FullOrbitalElements(elements=elements)


def compute_orbital_elements(two_body: TwoBodyState, t: float) -> FullOrbitalElements:
    """Inverse map: point-mass states -> full orbital elements (reference
    model_two_body.hpp:294-402). Raises on unbound orbits as the reference
    throws."""
    c1, c2 = two_body.body1, two_body.body2
    M1, M2 = c1.mass, c2.mass
    M = M1 + M2
    q = M2 / M1

    x_cm = (c1.position_x * M1 + c2.position_x * M2) / M
    y_cm = (c1.position_y * M1 + c2.position_y * M2) / M
    vx_cm = (c1.velocity_x * M1 + c2.velocity_x * M2) / M
    vy_cm = (c1.velocity_y * M1 + c2.velocity_y * M2) / M

    x1 = c1.position_x - x_cm
    y1 = c1.position_y - y_cm
    x2 = c2.position_x - x_cm
    y2 = c2.position_y - y_cm
    # sqrt(x*x + y*y) and the /a/a chains below mirror the reference's
    # exact evaluation order (model_two_body.hpp:323-348): the e == 0.0
    # branch choice hangs on the last bit of 1 - b^2/a^2, so hypot() or
    # a*a regrouping can flip it
    r1 = math.sqrt(x1 * x1 + y1 * y1)
    r2 = math.sqrt(x2 * x2 + y2 * y2)
    vx1 = c1.velocity_x - vx_cm
    vy1 = c1.velocity_y - vy_cm
    vx2 = c2.velocity_x - vx_cm
    vy2 = c2.velocity_y - vy_cm
    vf1 = -vx1 * y1 / r1 + vy1 * x1 / r1
    vf2 = -vx2 * y2 / r2 + vy2 * x2 / r2
    v1 = math.sqrt(vx1 * vx1 + vy1 * vy1)

    E1 = 0.5 * M1 * (vx1 ** 2 + vy1 ** 2)
    E2 = 0.5 * M2 * (vx2 ** 2 + vy2 ** 2)
    L1 = M1 * r1 * vf1
    L2 = M2 * r2 * vf2
    R = r1 + r2
    L = L1 + L2
    E = E1 + E2 - M1 * M2 / R

    if E >= 0.0:
        raise ValueError("compute_orbital_elements "
                         "(two_body_state does not correspond to a bound orbit)")

    a = -0.5 * M1 * M2 / E
    b = math.sqrt(-0.5 * L * L / E * (M1 + M2) / (M1 * M2))
    e = math.sqrt(_clamp(0.0, 1.0, 1.0 - b * b / a / a))
    omega = math.sqrt(M / a / a / a)

    a1 = a * q / (1.0 + q)
    b1 = b * q / (1.0 + q)

    cn = x1 / r1 if e == 0.0 else (1.0 - r1 / a1) / e
    cf = a1 / r1 * (cn - e)
    sn = (y1 / r1 if e == 0.0
          else (vx1 * x1 + vy1 * y1) / (e * v1 * r1)
          * math.sqrt(1.0 - e * e * cn * cn))
    sf = (b1 / r1) * sn

    cE = (e + cf) / (1.0 + e * cf)
    sE = math.sqrt(1.0 - e * e) * sf / (1.0 + e * cf)

    EE = math.atan2(sE, cE)
    MM = EE - e * sE
    tau = t - MM / omega

    ax = +(cn - e) * x1 + sn * math.sqrt(1.0 - e * e) * y1
    ay = +(cn - e) * y1 - sn * math.sqrt(1.0 - e * e) * x1
    pomega = math.atan2(ay, ax)

    return FullOrbitalElements(
        pomega=pomega, tau=tau,
        cm_position_x=x_cm, cm_position_y=y_cm,
        cm_velocity_x=vx_cm, cm_velocity_y=vy_cm,
        elements=OrbitalElements(a, M, q, e))


def orbital_period(elements: OrbitalElements) -> float:
    return 2 * math.pi / math.sqrt(
        elements.total_mass / elements.separation ** 3)


def diff(a: FullOrbitalElements, b: FullOrbitalElements) -> FullOrbitalElements:
    """Periodic-aware perturbation b - a (reference model_two_body.hpp:492-523):
    pomega wraps mod 2*pi, tau wraps mod the orbital period."""
    def wrap(delta, period):
        cands = (delta, delta + period, delta - period)
        return min(cands, key=abs)

    return FullOrbitalElements(
        pomega=wrap(b.pomega - a.pomega, 2 * math.pi),
        tau=wrap(b.tau - a.tau, orbital_period(b.elements)),
        cm_position_x=b.cm_position_x - a.cm_position_x,
        cm_position_y=b.cm_position_y - a.cm_position_y,
        cm_velocity_x=b.cm_velocity_x - a.cm_velocity_x,
        cm_velocity_y=b.cm_velocity_y - a.cm_velocity_y,
        elements=OrbitalElements(
            b.elements.separation - a.elements.separation,
            b.elements.total_mass - a.elements.total_mass,
            b.elements.mass_ratio - a.elements.mass_ratio,
            b.elements.eccentricity - a.elements.eccentricity))


def diff_cm(a: FullOrbitalElements, dt: float) -> FullOrbitalElements:
    """CM drift over dt (reference model_two_body.hpp:525-532)."""
    result = make_full_orbital_elements_with_zeros()
    return replace(result,
                   cm_position_x=a.cm_velocity_x * dt,
                   cm_position_y=a.cm_velocity_y * dt)
