"""The check that decides `correct`, on the CPU at a size a test run holds:
a sound run passes; the control (the reference in bfloat16 put in the
program's place) and each fault a cell can have, planted in the timed path
underneath a whole run, fail. The chip's look is skipped: the runs go
through harness.run_cell on the CPU, the program at the product path's
settings (fast_step=1, and multi_launch=16 for binary: B3's plain
version), the flagship at depth 3 / block 16, the sandbox at depth 4 /
block 16. A fault of the exchange between chips has no cell to be planted
in: every cell runs on one chip.

    python -m pytest torch_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import time

import pytest
import torch

from torch_bench import harness, spec

SMALL = {"binary": ["depth=3", "block_size=16", "fast_step=1",
                    "multi_launch=16"],
         "amrsand": ["depth=4", "block_size=16", "fast_step=1"]}
CELLS = {"binary": "binary-d6b96.record", "amrsand": "amrsand-d7b64.static"}
SEED = 2 ** 31 + 12345


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell(system: str) -> spec.Cell:
    """The system's cell with its checked first steps lengthened: the
    flagship's to 0.05 orbits (a dozen steps of the small mesh, where the
    cell's own 0.0085 orbits would be two), the sandbox's to t = 0.21 with
    regrid=1 and its trees held to the reference's, so that two regrids
    (trees and remapped state) are checked too."""
    cell = spec.Cell(CELLS[system])
    if system == "binary":
        cell.traffic = dict(cell.traffic, check_until=0.05)
    else:
        cell.traffic = dict(cell.traffic, check_until=0.21, argv=["regrid=1"],
                            limits=dict(cell.traffic["limits"],
                                        tree_mismatch=0))
    return cell


def _run(system: str, seed: int = SEED) -> dict:
    return harness.run_cell(_cell(system), seed, 0.3, False, "cpu",
                            time.perf_counter(), argv=SMALL[system])


@pytest.mark.parametrize("system", sorted(CELLS))
def test_a_sound_run_is_correct(system):
    result = _run(system)
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("system", sorted(CELLS))
def test_the_control_is_not_correct(system):
    cell = _cell(system)
    s = spec.system(system)(cell, "cpu", SMALL[system])
    gaps = s.control(SEED, 12 if system == "binary" else 120)
    limits = cell.traffic["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps


def _broken_state(monkeypatch, system, fault):
    """Break the state where the timed path produces it: the step leaves
    it unchanged, or updates only the first half of the blocks, or alters
    the largest value by 5%."""

    def spoil(u_in, u_out):
        if fault == "unchanged":
            return u_in.clone()
        out = u_out.clone()
        if fault == "half":
            half = u_in.shape[0] // 2
            out[half:] = u_in[half:]
        else:
            flat = out.view(-1)
            flat[torch.argmax(flat.abs())] *= 1.05
        return out

    if system == "binary":
        from mara3_tpu_torch.kernels import binary_multi
        real = binary_multi.advance_k

        def advance_k(tables, u, *args, **kw):
            u_out, rows = real(tables, u, *args, **kw)
            return spoil(u, u_out), rows

        monkeypatch.setattr(binary_multi, "advance_k", advance_k)
    else:
        from mara3_tpu_torch.subprograms import amrsand
        real = amrsand.advance_n

        def advance_n(u0, *args, **kw):
            return spoil(u0, real(u0, *args, **kw))

        monkeypatch.setattr(amrsand, "advance_n", advance_n)


@pytest.mark.parametrize("fault", ["unchanged", "half", "altered"])
@pytest.mark.parametrize("system", sorted(CELLS))
def test_a_broken_step_is_not_correct(monkeypatch, system, fault):
    _broken_state(monkeypatch, system, fault)
    result = _run(system)
    assert not result["correct"], result["checks"]


def test_a_tree_off_the_reference_is_not_correct(monkeypatch):
    """The program's regrid refines nothing: its trees differ."""
    from mara3_tpu_torch.mesh import regrid
    monkeypatch.setattr(regrid, "propose_leaves",
                        lambda leaves, *a, **k: list(leaves))
    result = _run("amrsand")
    assert not result["correct"], result["checks"]
    assert result["checks"]["tree_mismatch"]["value"] > 0


def test_an_altered_row_is_not_correct(monkeypatch):
    from mara3_tpu_torch.subprograms import binary
    real = binary.time_series_sample

    def sample(solution, sd):
        row = real(solution, sd)
        row["disk_mass"] *= 1.0 + 1e-2
        return row

    monkeypatch.setattr(binary, "time_series_sample", sample)
    result = _run("binary")
    assert not result["correct"], result["checks"]
    assert result["checks"]["series_gap"]["value"] > \
        result["checks"]["series_gap"]["limit"]
