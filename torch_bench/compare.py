"""The gaps that decide `correct`, each a plain number that a limit bounds.

state_gap: the largest, over the cells, of the difference between the
program's and the reference's values, over the cell's own scale (its
largest component's magnitude in the reference, or the `floor` where one
is given and larger). A cell the program lacks, or a leaf set that differs,
reads inf.

series_gap: the largest, over the rows and fields compared, of the
difference between the program's and the reference's value over the
field's scale (what its float32 rounding is measured against, given by the
reference with each value). A missing or extra row reads inf.
"""

from __future__ import annotations

import math

import numpy as np


def flatten(value, prefix: str = "") -> dict:
    """{dotted name: float} of a numpy structured row or record, a dict,
    a tuple or array of numbers, a number, or an object's dataclass
    fields."""
    out = {}
    if isinstance(value, dict):
        for name, v in value.items():
            out.update(flatten(v, f"{prefix}{name}."))
        return out
    if isinstance(value, np.void) or (isinstance(value, np.ndarray)
                                      and value.dtype.names):
        for name in value.dtype.names:
            out.update(flatten(value[name], f"{prefix}{name}."))
        return out
    if hasattr(value, "__dataclass_fields__"):
        for name in value.__dataclass_fields__:
            out.update(flatten(getattr(value, name), f"{prefix}{name}."))
        return out
    arr = np.asarray(value, dtype=np.float64)
    if arr.ndim == 0:
        return {prefix[:-1]: float(arr)}
    for i, v in enumerate(arr.reshape(-1)):
        out[f"{prefix}{i}"] = float(v)
    return out


def field_gap(program: dict, reference: dict) -> float:
    """Largest |program - reference| / scale over the reference's fields
    ({name: (value, scale)}); a field the program lacks reads inf."""
    worst = 0.0
    for name, (value, scale) in reference.items():
        if name not in program:
            return math.inf
        d = abs(program[name] - value)
        if not math.isfinite(d):
            return math.inf
        if d > 0:
            worst = max(worst, d / scale if scale > 0 else math.inf)
    return worst


def series_gap(program_rows, reference_rows) -> float:
    if len(program_rows) != len(reference_rows):
        return math.inf
    return max((field_gap(p, r) for p, r in zip(program_rows,
                                                 reference_rows)),
               default=0.0)


def state_gap(program_leaves, program_u, reference_leaves, reference_u,
              floor: float = 0.0) -> float:
    """program_u, reference_u: [B, bs, bs, C] host float64 arrays on their
    own leaves."""
    if set(map(tuple, program_leaves)) != set(map(tuple, reference_leaves)):
        return math.inf
    order = {tuple(leaf): b for b, leaf in enumerate(program_leaves)}
    p = program_u[[order[tuple(leaf)] for leaf in reference_leaves]]
    r = reference_u
    if p.shape != r.shape or not np.all(np.isfinite(p)):
        return math.inf
    scale = np.maximum(np.abs(r).max(axis=-1), floor)
    d = np.abs(p - r).max(axis=-1)
    with np.errstate(divide="ignore", invalid="ignore"):
        g = np.where(d > 0, d / scale, 0.0)
    return float(g.max())
