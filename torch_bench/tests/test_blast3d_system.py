"""The blast3d system (systems/blast3d.py), its work file and the readers
octree_host_us_per_step and octree_guard_host_pct, on the CPU at depth 4,
block 4: the cell's own tree (344 leaves on levels 2 to 4) with blocks of
4^3, so that the blast front crosses the jumps from level 4 to 3 within
the cell's own checked steps (to t = 0.02, 27 steps here). At depth 3 the
jumps lie at |x| = 1/2, which the front does not reach in a test's steps,
and a skipped flux correction would not show.

- In float64 the system's path (setup, the windows, the task runner)
  agrees with the reference to round-off.
- Through harness.run_cell in float32, at the cell's own limits: a sound
  run is correct; the bfloat16 control is not; nor is a run whose step
  leaves the state unchanged, alters one cell, halves dt inside the timed
  path, or skips the coarse-fine flux correction.
- The seed's field is periodic on the box and finite.
- The work file's count is the sum of its stated terms.
- The two readers: their arithmetic on a synthetic store, the window they
  keep to, None where there is nothing to read, and plausible values from
  blast3d's own spans under torch.profiler.

    python -m pytest torch_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import time

import pytest
import torch

from mara3_tpu_torch.app import tracing
from torch_bench import harness, record, spec
from torch_bench.reference import octree
from torch_bench.systems import blast3d as system_module
from torch_bench.work import model

CELL = "blast3d-d4b16.snapshots"
SMALL = ["block_size=4"]
SEED = 2 ** 31 + 12345
# the first window's dt at block 4: cfl dx_min / sqrt(gamma 10 / 1) / 3
DT = 0.3 * (1.0 / 32) / (5.0 / 3.0 * 10.0) ** 0.5 / 3.0
STEPS = 27                 # to the cell's check_until, 0.02
MS = 1_000_000
T0 = 1_000 * 10**9          # the window starts 1,000 s into perf_counter


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell() -> spec.Cell:
    """The cell with a short probe (the checked steps are the cell's)."""
    cell = spec.Cell(CELL)
    cell.traffic = dict(cell.traffic, probe=4 * DT)
    return cell


def _run(seed: int = SEED) -> dict:
    return harness.run_cell(_cell(), seed, 0.2, False, "cpu",
                            time.perf_counter(), argv=SMALL)


def test_the_path_agrees_with_the_reference_in_float64(monkeypatch):
    monkeypatch.setattr(system_module.System, "dtype", torch.float64)
    s, outputs = harness.checked_start(_cell(), SEED, "cpu", SMALL)
    assert outputs["iteration"] == STEPS
    assert len(outputs["leaves"]) == 344
    gaps = s.gaps(outputs, SEED)
    assert gaps["state_gap"] < 1e-13, gaps
    assert gaps["totals_gap"] < 1e-13, gaps


def test_a_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert set(result["checks"]) == {"state_gap", "totals_gap"}
    assert set(result["metrics"]) == {"zone_updates_per_s", "setup_s"}


def test_the_control_is_not_correct():
    cell = _cell()
    s = spec.system("blast3d")(cell, "cpu", SMALL)
    gaps = s.control(SEED, STEPS)
    limits = cell.traffic["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.parametrize("fault", ["unchanged", "one_cell", "half_dt",
                                   "no_correction"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    from mara3_tpu_torch.mesh import amr3d, euler3d
    if fault == "no_correction":
        monkeypatch.setattr(amr3d, "correct_fluxes",
                            lambda F, axis, mesh: F)
    else:
        real = euler3d.make_advance

        def make_advance(*args, **kwargs):
            advance = real(*args, **kwargs)

            def faulty(U, dt, steps):
                if fault == "unchanged":
                    return U.clone()
                if fault == "half_dt":
                    return advance(U, dt / 2, steps)
                out = advance(U, dt, steps).clone()
                flat = out.view(-1)
                flat[torch.argmax(flat.abs())] *= 1.05
                return out
            return faulty

        monkeypatch.setattr(euler3d, "make_advance", make_advance)
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_seed_field_is_periodic_on_the_box_and_finite():
    # the field at the cell centres and one box (2 in [-1, 1]^3 units)
    # over on any axis: the cells across each seam are neighbours
    x = octree.cell_centres(octree.create(2), 4)
    f = lambda pos: system_module.seed_field(SEED, pos, 0.05, "cpu")
    for shift in ([2.0, 0, 0], [0, 2.0, 0], [0, 0, -2.0], [2.0, -2.0, 2.0]):
        assert torch.allclose(f(x + torch.tensor(shift, dtype=torch.float64)),
                              f(x), rtol=0, atol=1e-14)
    assert torch.isfinite(f(x)).all()
    assert f(x).std() > 1e-3 and (f(x) - 1).abs().max() < 0.05 * 1.05


def test_the_work_count_is_its_terms():
    config = spec.Cell(CELL).config
    work = json.loads((model.HERE / config["work"]).read_text())
    assert work["per_stage_face"] == [] and work["per_step_cell"] == []
    assert work["stages"] == 1
    cell = sum(t[1] for t in work["per_stage_cell"])
    assert model.ops_per_zone_update(config) == cell == \
        work["ops_per_zone_update"] == 12 + 3 * 95 + 35
    assert model.bytes_per_cell(config) == 10 * 4


# -- octree_host_us_per_step, octree_guard_host_pct ------------------------

def _store():
    """Two chunks from T0, each a launch of two steps: steps of 4, 6, 5 and
    5 ms, each with three guards of 0.5 ms and three corrections of 0.25
    ms (2.25 ms of each step's time; 9 of 20 ms in all). A chunk with a
    step before the window (set-up)."""
    S = tracing.Span
    out = [S("mara3.chunk", T0 - 50 * MS, T0 - 10 * MS, None, 0, {}),
           S("mara3.step", T0 - 50 * MS, T0 - 40 * MS, 0, 0, {})]
    t = T0
    for lengths in ((4, 6), (5, 5)):
        c = len(out)
        out.append(S("mara3.chunk", t, t + 11 * MS, None, 0, {}))
        launch = len(out)
        out.append(S("mara3.launch", t, t + 10 * MS, c, 0, {}))
        for length in lengths:
            step = len(out)
            out.append(S("mara3.step", t, t + length * MS, launch, 0, {}))
            u = t
            for _ in range(3):
                out.append(S("mara3.guard", u, u + MS // 2, step, 0, {}))
                out.append(S("mara3.correct", u + MS // 2, u + 3 * MS // 4,
                             step, 0, {}))
                u += 3 * MS // 4
            t += length * MS
        t += 1 * MS
    return out


def _window(start_ns=T0, end_ns=T0 + 22 * MS):
    """A window a microsecond wider on each side than its stamps, as the
    harness's is around the loop's spans."""
    return record.Record((start_ns - 1000) * 1e-9, (end_ns + 1000) * 1e-9,
                         [], 0, 0.0, 1, 1)


@pytest.fixture
def store(monkeypatch):
    spans = _store()
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counts", lambda: {})
    return spans


def test_octree_readers_arithmetic(store):
    host = spec.reader("octree_host_us_per_step")
    share = spec.reader("octree_guard_host_pct")
    # 20 ms over 4 steps; 9 ms of octree spans in 20; the set-up's step
    # left out
    assert host(_window()) == pytest.approx(5000.0)
    assert share(_window()) == pytest.approx(100 * 9 / 20)
    # a window that ends inside the second chunk's first step: the first
    # chunk's two steps alone are read
    assert host(_window(end_ns=T0 + 15 * MS)) == pytest.approx(5000.0)
    assert share(_window(end_ns=T0 + 15 * MS)) == pytest.approx(
        100 * 4.5 / 10)
    # a window with no chunk: nothing to read
    assert host(_window(T0 - 9 * MS, T0 - 1 * MS)) is None
    assert share(_window(T0 - 9 * MS, T0 - 1 * MS)) is None


def test_octree_readers_read_nothing_without_step_spans(monkeypatch):
    # the parent program records chunks but no step
    spans = [s for s in _store() if s.name in ("mara3.chunk",
                                               "mara3.launch")]
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counts", lambda: {})
    assert spec.reader("octree_host_us_per_step")(_window()) is None
    assert spec.reader("octree_guard_host_pct")(_window()) is None


def test_octree_readers_read_blast3d_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    s = spec.system("blast3d")(_cell(), "cpu", SMALL)
    s.setup(SEED)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        start = time.perf_counter()
        s.advance(8.5 * DT)
        end = time.perf_counter()
    rec = record.Record(start, end, [], 0, 0.0, 344, 64)
    steps = [x for x in tracing.spans() if x.name == "mara3.step"]
    assert len(steps) == s.iteration() == 9
    us = spec.reader("octree_host_us_per_step")(rec)
    assert us == pytest.approx(sum(x.end_ns - x.start_ns for x in steps)
                               / len(steps) * 1e-3)
    assert 0.0 < us < (end - start) * 1e6 / len(steps)
    assert 0.0 < spec.reader("octree_guard_host_pct")(rec) < 100.0
