"""Power-law atmosphere and cloud/envelope profiles for the GRB-progenitor run.

Port of mara3_tpu/models/atmosphere.py (the reference's
model_atmosphere.hpp). The profiles take a tensor of radii (or a float) and
keep the JAX package's operation order. They work in CGS, whose values
(r^3 ~ 1e39 cm^3, solar masses ~ 2e33 g) overflow float32, so callers pass
float64 tensors on the CPU and cast only the code-unit ratios to the run's
dtype (subprograms/cloud.new_solution).

The reference's secant solver for the mass coordinate
(model_atmosphere.hpp:58-90) is a masked vector loop that reads `any(active)`
on the host once per update, as the JAX package's while_loop tests it.
"""

from __future__ import annotations

import math
from dataclasses import dataclass, replace

import torch

SOLAR_MASS = 1.989e33    # g   (model_atmosphere.hpp:248)
LIGHT_SPEED = 2.998e10   # cm/s


def _as_tensor(r):
    return torch.as_tensor(r, dtype=torch.float64)


@dataclass(frozen=True)
class PowerLawAtmosphere:
    """Broken power-law rho(r) (reference power_law_atmosphere_model,
    model_atmosphere.hpp:39,103-134): rho = f0 (r/r0)^-n1 inside rc, then
    steeper n2 outside."""
    coefficient: float = 1.0   # f0
    inner_radius: float = 1.0  # r0
    cutoff_radius: float = 1e2  # rc
    inner_index: float = 2.0   # n1
    outer_index: float = 6.0   # n2

    def with_total_mass(self, new_total_mass: float) -> "PowerLawAtmosphere":
        return replace(self,
                       coefficient=new_total_mass / self.total_mass())

    def density_at(self, r):
        f0, r0, rc = self.coefficient, self.inner_radius, self.cutoff_radius
        n1, n2 = self.inner_index, self.outer_index
        r = _as_tensor(r)
        rho_in = f0 * (r / r0) ** -n1
        rho_c = f0 * (rc / r0) ** -n1
        rho_out = rho_c * (r / rc) ** -n2
        return torch.where(r <= rc, rho_in, rho_out)

    def _density_scalar(self, r: float) -> float:
        f0, r0, rc = self.coefficient, self.inner_radius, self.cutoff_radius
        n1, n2 = self.inner_index, self.outer_index
        if r <= rc:
            return f0 * (r / r0) ** -n1
        return f0 * (rc / r0) ** -n1 * (r / rc) ** -n2

    def mass_within_cutoff(self) -> float:
        r0, rc, n1 = self.inner_radius, self.cutoff_radius, self.inner_index
        if n1 == 3.0:
            return 4 * math.pi * (self._density_scalar(rc) * rc ** 3
                                  * math.log(rc / r0))
        return 4 * math.pi * (self._density_scalar(rc) * rc ** 3
                              - self._density_scalar(r0) * r0 ** 3) / (3 - n1)

    def mass_beyond_cutoff(self) -> float:
        if self.outer_index <= 3.0:
            raise ValueError(
                "power_law_atmosphere: outer index (n2) must be greater than 3")
        rc, n2 = self.cutoff_radius, self.outer_index
        return 4 * math.pi * self._density_scalar(rc) * rc ** 3 / (n2 - 3)

    def total_mass(self) -> float:
        return self.mass_within_cutoff() + self.mass_beyond_cutoff()


def _secant_vectorized(f, x1, x2, tolerance=1e-10, max_iter=60):
    """Vectorized secant solve (reference detail::solve_secant,
    model_atmosphere.hpp:58-90): every element iterates until |f| is within
    the tolerance, at most max_iter updates in all."""
    y1 = f(x1)
    y2 = f(x2)
    it = 0
    while it < max_iter and bool((torch.abs(y2) > tolerance).any()):
        active = torch.abs(y2) > tolerance
        x_next = x2 - y2 * (x2 - x1) / (y2 - y1)
        y_next = f(x_next)
        x1, y1, x2, y2 = (torch.where(active, x2, x1),
                          torch.where(active, y2, y1),
                          torch.where(active, x_next, x2),
                          torch.where(active, y_next, y2))
        it += 1
    return x2


@dataclass(frozen=True)
class CloudAndEnvelope:
    """Relativistic envelope gamma*beta(m) over a power-law cloud (reference
    cloud_and_envelop_model, model_atmosphere.hpp:40,167-210 and the inline
    definitions at 248-258)."""
    inner_radius: float = 3e8              # cm
    envelop_mass: float = 0.005 * SOLAR_MASS
    u1: float = 4.0
    m1: float = 1e26
    psi: float = 0.25
    cloud_index: float = 2.0

    def gamma_beta(self, m):
        return self.u1 * (_as_tensor(m) / self.m1) ** -self.psi

    def velocity(self, m):
        u = self.gamma_beta(m)
        return u / torch.sqrt(1.0 + u * u) * LIGHT_SPEED

    def dudm(self, m):
        return -self.psi / _as_tensor(m) * self.gamma_beta(m)

    def radius(self, m, t):
        return self.velocity(m) * t

    def density(self, m, t):
        gamma_squared = 1.0 + self.gamma_beta(m) ** 2
        beta = self.velocity(m) / LIGHT_SPEED
        return (gamma_squared * beta
                / (4 * math.pi * self.radius(m, t) ** 3)
                / torch.abs(self.dudm(m)))

    def cloud_velocity(self):
        return self.velocity(self.envelop_mass)

    def cloud_gamma_beta(self):
        beta = self.cloud_velocity() / LIGHT_SPEED
        return beta / torch.sqrt(1.0 - beta * beta)

    def cloud_outer_boundary(self, t):
        return self.cloud_velocity() * t

    def envelop_outer_boundary(self, t):
        return self.radius(self.m1, t)

    def mass_coordinate(self, r, t):
        """m such that radius(m, t) = r, via vectorized secant on log10
        (reference model_atmosphere.hpp:167-172)."""
        r = _as_tensor(r)

        def f(m):
            return torch.log10(r) - torch.log10(self.radius(m, t))

        m_guess1 = torch.full_like(r, self.m1)
        m_guess2 = torch.full_like(r, self.m1 * 2)
        return _secant_vectorized(f, m_guess1, m_guess2)

    def power_law_cloud(self, r, t):
        r_outer = self.cloud_outer_boundary(t)
        d_outer = self._envelope_density_at(r_outer, t)
        return d_outer * (_as_tensor(r) / r_outer) ** -self.cloud_index

    def _envelope_density_at(self, r, t):
        return self.density(self.mass_coordinate(r, t), t)

    def density_at(self, r, t):
        """Piecewise: power-law cloud inside, envelope, then r^-2 tail
        (reference model_atmosphere.hpp:204-214)."""
        r = _as_tensor(r)
        r_cloud = self.cloud_outer_boundary(t)
        r1 = self.envelop_outer_boundary(t)
        d_env = self._envelope_density_at(torch.clip(r, r_cloud, r1), t)
        d_cloud = self.power_law_cloud(r, t)
        d_tail = self._envelope_density_at(r1, t) * (r / r1) ** -2.0
        return torch.where(r < r_cloud, d_cloud,
                           torch.where(r > r1, d_tail, d_env))

    def gamma_beta_at(self, r, t):
        r = _as_tensor(r)
        r_cloud = self.cloud_outer_boundary(t)
        r1 = self.envelop_outer_boundary(t)
        u_env = self.gamma_beta(self.mass_coordinate(
            torch.clip(r, r_cloud, r1), t))
        u_tail = self.gamma_beta(self.mass_coordinate(r1, t))
        return torch.where(r < r_cloud, self.cloud_gamma_beta(),
                           torch.where(r > r1, u_tail, u_env))

    def velocity_at(self, r, t):
        u = self.gamma_beta_at(r, t)
        return u / torch.sqrt(1.0 + u * u) * LIGHT_SPEED

    def cloud_mass(self, t) -> float:
        n1 = self.cloud_index
        r0 = self.inner_radius
        rc = float(self.cloud_outer_boundary(t))
        d_rc = float(self.density_at(rc, t))
        d_r0 = float(self.density_at(r0, t))
        if n1 == 3.0:
            return 4 * math.pi * d_rc * rc ** 3 * math.log(rc / r0)
        return 4 * math.pi * (d_rc * rc ** 3 - d_r0 * r0 ** 3) / (3 - n1)

    def total_mass(self, t) -> float:
        return self.cloud_mass(t) + self.envelop_mass
