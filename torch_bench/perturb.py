"""The seeded part of a cell's input: a smooth multiplicative field.

A seed draws, with a torch.Generator on the run's device, `MODES` Fourier
modes periodic on the [-1, 1]^2 root domain (integer wave numbers from -3
to 3 on each axis, amplitudes, phases). The field is
1 + amplitude * sum_m a_m sin(pi (kx_m x + ky_m y) + phi_m) / MODES with
a_m in [-1, 1], evaluated in float64 at the positions given. The program
receives the initial state times this field; the reference evaluates the
same field at its own cell centres.
"""

from __future__ import annotations

import math

import torch

MODES = 8


def factor(seed: int, positions, amplitude: float, device):
    """The field at positions [..., 2] (root-domain units, float64 on the
    host or the device), float64 on `device`."""
    g = torch.Generator(device=device)
    g.manual_seed(int(seed))
    draw = torch.rand(MODES, 4, generator=g, device=device,
                      dtype=torch.float64)
    k = torch.floor(draw[:, :2] * 7.0) - 3.0
    a = 2.0 * draw[:, 2] - 1.0
    phase = 2.0 * math.pi * draw[:, 3]
    x = torch.as_tensor(positions, dtype=torch.float64, device=device)
    arg = math.pi * (x[..., None, 0] * k[:, 0] + x[..., None, 1] * k[:, 1]) \
        + phase
    return 1.0 + amplitude * torch.sum(a * torch.sin(arg), dim=-1) / MODES
