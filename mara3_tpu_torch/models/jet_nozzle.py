"""Structured relativistic jet inflow nozzle.

Port of mara3_tpu/models/jet_nozzle.py (the reference's
model_jet_nozzle.hpp:40-128): a Gaussian-structured jet with total energy
Ej, on-axis Lorentz factor G0, engine duration tj, opening angle qj and
structure exponent as. The polar angle q is a tensor (the inner guard row of
the cloud subprogram, subprog_cloud.cpp:466-493) or a float; the time t is a
float.
"""

from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from mara3_tpu_torch.core.ops import div_scalar

LIGHT_SPEED_CGS = 3e10  # model_jet_nozzle.hpp:44


def _exp(x):
    return torch.exp(x) if isinstance(x, torch.Tensor) else math.exp(x)


def _div(x, c: float):
    """x / c, the quotient correctly rounded on every device."""
    return div_scalar(x, c) if isinstance(x, torch.Tensor) else x / c


@dataclass(frozen=True)
class JetNozzle:
    Ej: float = 1.0   # total explosion energy (erg)
    G0: float = 2.0   # Lorentz factor on-axis at t=0
    tj: float = 1.0   # engine duration (s)
    qj: float = 0.1   # engine opening angle (radian)
    as_: float = 2.0  # structure exponent
    r0: float = 1.0   # inner radius

    def density_at_base(self) -> float:
        """(model_jet_nozzle.hpp:117-120)."""
        return self.Ej / (2 * math.pi * (self.G0 * self.r0 * self.qj) ** 2
                          * self.tj * LIGHT_SPEED_CGS ** 3)

    def luminosity_per_steradian(self, q, t):
        """(model_jet_nozzle.hpp:75-82)."""
        return (self.density_at_base()
                * self.G0 ** 2 * self.r0 ** 2 * LIGHT_SPEED_CGS ** 3
                * _exp(-_div(q, self.qj) ** self.as_)
                * _exp(-t / self.tj))

    def gamma_beta(self, q, t):
        """(model_jet_nozzle.hpp:97-103)."""
        return (self.G0
                * _exp(-0.5 * _div(q, self.qj) ** self.as_)
                * _exp(-0.5 * t / self.tj))
