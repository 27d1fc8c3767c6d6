"""Dimensional analysis: values tagged with their (length, mass, time)
exponents.

Port of mara3_tpu/core/dimensional.py (the reference's compile-time
dimensional values, src/core_dimensional.hpp:42-160). A ``Quantity`` holds a
float or a tensor and its exponents: addition requires identical dimensions,
multiplication sums exponents, and ``require_dims`` checks them at an API
boundary and hands back the bare value. The checks run in Python once per
call, outside any loop over cells; the kernels see bare tensors.
"""

from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Any

import torch


def _fr(x) -> Fraction:
    return x if isinstance(x, Fraction) else Fraction(x)


@dataclass(frozen=True)
class Quantity:
    """A value tagged with (C, G, S) = (length, mass, time) exponents.

    Mirrors dimensional_value_t (core_dimensional.hpp:84-233): + and -
    require identical dims; * and / combine exponents; ``pow(n, d)``
    scales them rationally.
    """

    value: Any
    C: Fraction = Fraction(0)
    G: Fraction = Fraction(0)
    S: Fraction = Fraction(0)

    @property
    def dims(self):
        return (self.C, self.G, self.S)

    def _require_same_dims(self, other: "Quantity", op: str):
        if self.dims != other.dims:
            raise ValueError(
                f"dimension mismatch in {op}: {self.unit_string()} vs "
                f"{other.unit_string()}")

    def unit_string(self) -> str:
        """e.g. 'L^1 M^0 T^-2' (reference to_string, core_dimensional.hpp:78)."""
        return f"L^{self.C} M^{self.G} T^{self.S}"

    def is_dimensionless(self) -> bool:
        return self.dims == (0, 0, 0)

    # -- arithmetic ---------------------------------------------------------------
    def __add__(self, other):
        other = _as_quantity_like(other, self)
        self._require_same_dims(other, "+")
        return Quantity(self.value + other.value, *self.dims)

    def __sub__(self, other):
        other = _as_quantity_like(other, self)
        self._require_same_dims(other, "-")
        return Quantity(self.value - other.value, *self.dims)

    def __neg__(self):
        return Quantity(-self.value, *self.dims)

    def __mul__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value * other.value,
                            self.C + other.C, self.G + other.G,
                            self.S + other.S)
        return Quantity(self.value * other, *self.dims)

    __rmul__ = __mul__

    def __truediv__(self, other):
        if isinstance(other, Quantity):
            return Quantity(self.value / other.value,
                            self.C - other.C, self.G - other.G,
                            self.S - other.S)
        return Quantity(self.value / other, *self.dims)

    def __rtruediv__(self, other):
        return Quantity(other / self.value, -self.C, -self.G, -self.S)

    def pow(self, num: int, den: int = 1):
        """Rational power (reference dimensional_value_t::pow<N,D>)."""
        e = Fraction(num, den)
        return Quantity(self.value ** float(e) if e.denominator != 1
                        else self.value ** e.numerator,
                        self.C * e, self.G * e, self.S * e)

    def sqrt(self):
        v = self.value
        return Quantity(torch.sqrt(v) if isinstance(v, torch.Tensor)
                        else math.sqrt(v),
                        self.C / 2, self.G / 2, self.S / 2)

    # -- comparisons (dimension-checked) -----------------------------------------
    def __lt__(self, other):
        other = _as_quantity_like(other, self)
        self._require_same_dims(other, "<")
        return self.value < other.value

    def __le__(self, other):
        other = _as_quantity_like(other, self)
        self._require_same_dims(other, "<=")
        return self.value <= other.value

    def __gt__(self, other):
        other = _as_quantity_like(other, self)
        self._require_same_dims(other, ">")
        return self.value > other.value

    def __ge__(self, other):
        other = _as_quantity_like(other, self)
        self._require_same_dims(other, ">=")
        return self.value >= other.value

    def __repr__(self):
        return f"{self.value} [{self.unit_string()}]"


def _as_quantity_like(x, template: Quantity) -> Quantity:
    if isinstance(x, Quantity):
        return x
    if template.is_dimensionless():
        return Quantity(x)
    # adding a bare number to a dimensional value is a dimension error,
    # matching the reference where it fails to compile
    raise ValueError(
        f"cannot combine dimensionless {x!r} with {template.unit_string()}")


def make_quantity(value, C=0, G=0, S=0) -> Quantity:
    return Quantity(value, _fr(C), _fr(G), _fr(S))


# Factories mirroring the aliases in core_dimensional.hpp:42-76 -----------------

def make_length(v):        return make_quantity(v, 1, 0, 0)
def make_mass(v):          return make_quantity(v, 0, 1, 0)
def make_time(v):          return make_quantity(v, 0, 0, 1)
def make_rate(v):          return make_quantity(v, 0, 0, -1)
def make_velocity(v):      return make_quantity(v, 1, 0, -1)
def make_area(v):          return make_quantity(v, 2, 0, 0)
def make_volume(v):        return make_quantity(v, 3, 0, 0)
def make_mass_density(v):  return make_quantity(v, -3, 1, 0)
def make_flux(v):          return make_quantity(v, -2, 1, -1)   # mass/area/time
def make_flow(v):          return make_quantity(v, 0, 1, -1)    # mass/time
def make_flow_density(v):  return make_quantity(v, -3, 1, -1)
def make_energy(v):        return make_quantity(v, 2, 1, -2)
def make_force(v):         return make_quantity(v, 1, 1, -2)
def make_momentum(v):      return make_quantity(v, 1, 1, -1)
def make_torque(v):        return make_quantity(v, 2, 1, -2)
def make_angmom(v):        return make_quantity(v, 2, 1, -1)
def make_dimensional(v, C, G, S): return make_quantity(v, C, G, S)


def require_dims(q: Quantity, C, G, S, what: str = "quantity") -> Any:
    """Dimension check at an API boundary: returns the raw value of `q`
    after verifying its exponents (the analog of the reference's
    compile-time signature match, core_dimensional.hpp:108-124). Plain
    numbers and tensors pass as dimensionless only when (C,G,S) == 0."""
    want = (_fr(C), _fr(G), _fr(S))
    if not isinstance(q, Quantity):
        if want == (0, 0, 0):
            return q
        raise ValueError(
            f"{what} must carry units L^{want[0]} M^{want[1]} T^{want[2]}; "
            f"got a bare value")
    if q.dims != want:
        raise ValueError(
            f"{what} has units {q.unit_string()}, expected "
            f"L^{want[0]} M^{want[1]} T^{want[2]}")
    return q.value
