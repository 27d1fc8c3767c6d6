"""The work model: the operations and bytes a window's work needs, from
the configuration and the shapes alone.

A configuration's file names its work file (`work`), which counts the
scheme's floating-point operations once per zone-update (per stage per
cell, per stage per face and axis, per step per cell) with the derivation
of each term, and the bytes a window must move at least (each input read
once, each output written once). Neither depends on how the program
implements the scheme: a kernel that recomputes, fuses or batches steps
differently needs the same work.
"""

from __future__ import annotations

import json
from pathlib import Path

HERE = Path(__file__).resolve().parent


def _terms(work: dict, key: str, params: dict) -> float:
    total = 0.0
    for term in work[key]:
        ops, needs = term[1], term[2:]
        if needs and needs[0] == "plm" and \
                params.get("reconstruct_method", "plm") != "plm":
            continue
        total += ops
    return total


def ops_per_zone_update(config: dict) -> float:
    """Operations of one zone-update of the configuration's scheme."""
    work = json.loads((HERE / config["work"]).read_text())
    params = config["parameters"]
    if params.get("riemann", "hlle") != "hlle":
        raise NotImplementedError("the work file counts HLLE only")
    stages = work["stages"]
    stages = int(params[stages]) if isinstance(stages, str) else int(stages)
    per_stage = _terms(work, "per_stage_cell", params) \
        + 2 * _terms(work, "per_stage_face", params)
    return stages * per_stage + _terms(work, "per_step_cell", params)


def bytes_per_cell(config: dict) -> float:
    """The values a window moves per cell, times the state's item size."""
    work = json.loads((HERE / config["work"]).read_text())
    values = sum(term[1] for term in work["bytes_per_cell"])
    return values * {"float32": 4, "float64": 8}[config["dtype"]]


def peaks(device_name: str):
    """(operations a second, bytes a second) of the card, or None for a
    card the table does not hold."""
    table = json.loads((HERE / "peaks.json").read_text())
    entry = table.get(device_name)
    return None if entry is None else (entry["float32_ops_per_s"],
                                       entry["bytes_per_s"])


def work_of(config: dict, device_name: str, cells: int) -> dict:
    """What the kernels_roofline reader needs: the per-zone-update
    operations, the window's bytes for `cells` cells, and the card's
    peaks."""
    p = peaks(device_name)
    return {"ops_per_zone_update": ops_per_zone_update(config),
            "bytes": bytes_per_cell(config) * cells,
            "peaks": p}


def least_seconds(work: dict, zone_updates: int) -> float:
    """The larger of the operations over the peak rate and the bytes over
    the bandwidth; None for a card without peaks."""
    if not work or work.get("peaks") is None:
        return None
    ops_s, bytes_s = work["peaks"]
    return max(work["ops_per_zone_update"] * zone_updates / ops_s,
               work["bytes"] / bytes_s)
