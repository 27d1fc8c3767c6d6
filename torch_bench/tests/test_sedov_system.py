"""The sedov system (systems/sedov.py), its plain reference
(reference/sedov.py) and its work file, on the CPU at nr = 256 (512
cells) with fast_step=1, as the card runs the chunked loop.

- In float64 the system's path (setup, the chunked loop, the task runner,
  the row) agrees with the reference to round-off.
- Through harness.run_cell in float32, at the cell's own limits: a sound
  run is correct; the bfloat16 control is not; nor is a run whose step
  leaves the state unchanged, alters one cell, whose row's shock radius is
  altered, or whose Newton is cut to one update.
- The reference imports neither the program nor JAX; BENCHMARK.json has
  no problem; the work file's count is the sum of its stated terms.

    python -m pytest torch_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import pytest
import torch

from torch_bench import harness, spec
from torch_bench.systems import sedov as system_module
from torch_bench.work import model

CELL = "sedov-524288.srhd"
SMALL = ["nr=256", "fast_step=1"]
SEED = 2 ** 31 + 12345
STEPS = 200
# the grid of nr = 256: dt = 0.4 (v[1] - v[0])
DT = 0.4 * (10.0 ** (-0.5 + 2.5 / 512) - 10.0 ** -0.5)


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell() -> spec.Cell:
    """The cell with its checked first steps at STEPS of the small grid
    (the cell's own 400 steps of the full grid are under one step here)."""
    cell = spec.Cell(CELL)
    cell.traffic = dict(cell.traffic, check_until=(STEPS - 0.4) * DT,
                        probe=8 * DT)
    return cell


def _run(seed: int = SEED) -> dict:
    return harness.run_cell(_cell(), seed, 0.2, False, "cpu",
                            time.perf_counter(), argv=SMALL)


def test_the_path_agrees_with_the_reference_in_float64(monkeypatch):
    monkeypatch.setattr(system_module.System, "dtype", torch.float64)
    s, outputs = harness.checked_start(_cell(), SEED, "cpu", SMALL)
    assert outputs["iteration"] == STEPS
    gaps = s.gaps(outputs, SEED)
    assert gaps["state_gap"] < 1e-13, gaps
    assert gaps["series_gap"] < 1e-12, gaps


def test_a_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"zone_updates_per_s", "setup_s"}


def test_the_control_is_not_correct():
    cell = _cell()
    s = spec.system("sedov")(cell, "cpu", SMALL)
    gaps = s.control(SEED, STEPS)
    limits = cell.traffic["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.parametrize("fault", ["unchanged", "one_cell", "row", "newton"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    from mara3_tpu_torch.physics import srhd
    from mara3_tpu_torch.subprograms import sedov
    if fault == "newton":
        monkeypatch.setattr(srhd, "NEWTON_ITER_MAX", 1)
        monkeypatch.setattr(srhd, "CHUNK", 1)
    elif fault == "row":
        real_row = sedov.compute_time_series_data

        def row(s, system):
            out = real_row(s, system)
            return dict(out, shock_radius=out["shock_radius"] * 1.05)

        monkeypatch.setattr(sedov, "compute_time_series_data", row)
    else:
        real = sedov.advance_n

        def advance_n(u0, *args, **kw):
            if fault == "unchanged":
                return u0.clone()
            out = real(u0, *args, **kw).clone()
            flat = out.view(-1)
            flat[torch.argmax(flat.abs())] *= 1.05
            return out

        monkeypatch.setattr(sedov, "advance_n", advance_n)
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_reference_imports_neither_program_nor_jax():
    code = ("import sys; import torch_bench.reference.sedov; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mara3_tpu_torch', 'mara3_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=spec.ROOT,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_the_benchmark_has_no_problem():
    assert spec.problems(spec.benchmark()) == []


def test_the_work_count_is_its_terms():
    config = spec.Cell(CELL).config
    work = json.loads((model.HERE / config["work"]).read_text())
    terms = work["per_stage_cell"]
    assert model.ops_per_zone_update(config) == \
        pytest.approx(sum(t[1] for t in terms))
    assert model.ops_per_zone_update(config) == \
        pytest.approx(work["ops_per_zone_update"])
    newton = [t for t in terms if t[0].startswith("Newton")]
    assert len(newton) == 1
    assert newton[0][1] == pytest.approx(
        32 * work["newton_updates_per_cell_step"])
    assert f"x {work['newton_updates_per_cell_step']} updates" in newton[0][0]
    assert work["per_stage_face"] == [] and work["stages"] == 1
