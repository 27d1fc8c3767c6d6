"""Post-shock locator diagnostics for 1d profiles.

Port of mara3_tpu/mathx/shock.py (the reference's post_shock_locator.hpp:
74-152): each locator is a fixed-shape masked scan, as in the JAX package.
The profile runs along the last axis; leading axes are a batch (the cloud
subprogram's polar columns, which the JAX package vmaps), with `index` one
integer per profile, and the result has the batch's shape (a 0-d integer
tensor for one profile). torch.argmin returns the first minimum, as
jnp.argmin does.
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.core.ops import difference_on_axis


def _index(index, y):
    """index as an integer tensor on y's device, with a trailing axis to
    broadcast against the profile's."""
    return torch.as_tensor(index, device=y.device)[..., None]


def find_shock_index(specific_entropy_1d):
    """Index of the sharpest entropy drop: argmin of ds (reference
    find_shock_index, post_shock_locator.hpp:74-80)."""
    return torch.argmin(difference_on_axis(specific_entropy_1d, -1), dim=-1)


def find_index_of_maximum_behind(array_1d, index):
    """Walk left from `index` while values keep increasing leftward
    (reference post_shock_locator.hpp:100-118): the index of the local
    maximum at or behind `index`. A cell j in (0, index] continues the
    walk if y[j-1] > y[j]; the walk stops below the trailing run of such
    cells that ends at `index`, at the last cell <= index that does not
    continue it."""
    y = array_1d
    index = _index(index, y)
    idx = torch.arange(y.shape[-1], device=y.device)
    rising_left = torch.cat([torch.zeros_like(y[..., :1], dtype=torch.bool),
                             y[..., :-1] > y[..., 1:]], dim=-1)
    cont = rising_left & (idx <= index) & (idx > 0)
    blocked = torch.where(~cont & (idx <= index), idx,
                          torch.full_like(idx, -1))
    return torch.amax(blocked, dim=-1)


def find_index_of_maximum_pressure_behind(gas_pressure_1d, index):
    """Reference post_shock_locator.hpp:124-128."""
    return find_index_of_maximum_behind(gas_pressure_1d, index)


def find_index_of_pressure_plateau_ahead(gas_pressure_1d, index):
    """Walk right from `index` while d(log p)[i-1] < 0.5 * d(log p)[i-2]
    (reference post_shock_locator.hpp:134-152); returns the first cell where
    the condition fails, or 0 if the walk runs off the grid (the
    reference's bounds-check catch)."""
    m = gas_pressure_1d.shape[-1]
    index = _index(index, gas_pressure_1d)
    dlogp = difference_on_axis(torch.log(gas_pressure_1d), -1)
    i = torch.arange(m, device=dlogp.device)
    zeros = torch.zeros_like(dlogp[..., :1]).expand(
        *dlogp.shape[:-1], 2)
    d1 = torch.cat([zeros, dlogp[..., : m - 2]], dim=-1)
    d2 = torch.cat([zeros[..., :1], dlogp], dim=-1)
    cont = (d2 < 0.5 * d1) & (i >= 2)
    stop = torch.where(~cont & (i >= index), i, torch.full_like(i, m))
    result = torch.amin(stop, dim=-1)
    return torch.where(result == m, torch.zeros_like(result), result)
