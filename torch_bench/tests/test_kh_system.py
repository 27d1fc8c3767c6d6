"""The kh system (systems/kh.py), its work file and the output_wall_pct
reader, on the CPU at N = 32 with fast_step=1 (B1's plain version, as
the card runs B1).

- Through harness.run_cell in float32, at the cell's own limits: a sound
  run is correct; the bfloat16 control is not; nor is a run whose step
  leaves the state unchanged, alters one cell, halves dt inside the timed
  path, or whose row's kinetic energy is altered.
- The seed's field is periodic on the box.
- The work file's count is the sum of its stated terms, and the same
  whichever path (fast_step) runs the scheme.
- output_wall_pct: its arithmetic on a synthetic store, the window it
  keeps to, None where there is nothing to read, and a plausible share
  from kh's own spans under torch.profiler.

    python -m pytest torch_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import sys
import time

import pytest
import torch

from mara3_tpu_torch.app import tracing
from torch_bench import harness, perturb, record, spec
from torch_bench.reference import kh as ref
from torch_bench.work import model

CELL = "kh-2048.rows"
N = 32
SMALL = [f"N={N}", "fast_step=1"]
SEED = 2 ** 31 + 12345
STEPS = 64
# the grid of N = 32: dt = cfl dx / (mach cs + cs)
DT = 0.3 / N / 1.5
MS = 1_000_000
T0 = 1_000 * 10**9          # the window starts 1,000 s into perf_counter


@pytest.fixture(autouse=True)
def _threads():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cell() -> spec.Cell:
    """The cell with its checked first steps at STEPS of the small grid
    (the cell's own 512 steps of the full grid are 8 here)."""
    cell = spec.Cell(CELL)
    cell.traffic = dict(cell.traffic, check_until=STEPS * DT, probe=8 * DT)
    return cell


def _run(seed: int = SEED) -> dict:
    return harness.run_cell(_cell(), seed, 0.2, False, "cpu",
                            time.perf_counter(), argv=SMALL)


def test_a_sound_run_is_correct():
    result = _run()
    assert result["correct"], result["checks"]
    assert result["attempted"] > 0
    assert set(result["metrics"]) == {"zone_updates_per_s", "setup_s"}


def test_the_control_is_not_correct():
    cell = _cell()
    s = spec.system("kh")(cell, "cpu", SMALL)
    gaps = s.control(SEED, STEPS)
    limits = cell.traffic["limits"]
    assert any(gaps[k] > limits[k] for k in limits), gaps


@pytest.mark.parametrize("fault", ["unchanged", "one_cell", "half_dt",
                                   "row"])
def test_a_planted_fault_is_not_correct(monkeypatch, fault):
    from mara3_tpu_torch.subprograms import kh
    if fault == "row":
        real_row = kh.compute_time_series_data

        def row(s, cfg):
            out = real_row(s, cfg)
            return dict(out, kinetic_energy=out["kinetic_energy"] * 1.01)

        monkeypatch.setattr(kh, "compute_time_series_data", row)
    else:
        real = kh.advance_n

        def advance_n(u, n, **kw):
            if fault == "unchanged":
                return u.clone()
            if fault == "half_dt":
                return real(u, n, **dict(kw, dt=kw["dt"] / 2))
            out = real(u, n, **kw).clone()
            flat = out.view(-1)
            flat[torch.argmax(flat.abs())] *= 1.05
            return out

        monkeypatch.setattr(kh, "advance_n", advance_n)
    result = _run()
    assert not result["correct"], result["checks"]


def test_the_seed_field_is_periodic_on_the_box():
    # the field at the cell centres and one box (2 in [-1, 1]^2 units)
    # over on either axis: the cells across each seam are neighbours
    x = ref.positions(N, "cpu")
    f = lambda pos: perturb.factor(SEED, pos, 0.05, "cpu")
    for shift in ([2.0, 0.0], [0.0, 2.0], [-2.0, 2.0]):
        assert torch.allclose(f(x + torch.tensor(shift, dtype=torch.float64)),
                              f(x), rtol=0, atol=1e-14)
    assert f(x).std() > 1e-3


def test_the_work_count_is_its_terms():
    config = spec.Cell(CELL).config
    work = json.loads((model.HERE / config["work"]).read_text())
    cell = sum(t[1] for t in work["per_stage_cell"])
    face = sum(t[1] for t in work["per_stage_face"])
    assert model.ops_per_zone_update(config) == pytest.approx(
        cell + 2 * face)
    assert model.ops_per_zone_update(config) == pytest.approx(
        work["ops_per_zone_update"])
    assert work["per_step_cell"] == [] and work["stages"] == "rk_order"
    assert model.bytes_per_cell(config) == 6 * 4


@pytest.mark.parametrize("fast_step", [0, 1])
def test_the_work_count_is_the_same_on_either_path(fast_step):
    config = spec.Cell(CELL).config
    other = dict(config, parameters=spec.parameters(
        config, [f"fast_step={fast_step}"]))
    assert model.ops_per_zone_update(other) == \
        model.ops_per_zone_update(config)
    assert model.bytes_per_cell(other) == model.bytes_per_cell(config)


# -- output_wall_pct ------------------------------------------------------

def _store():
    """Three chunks of 10 ms from T0, each ending on outputs of 2, 0 and
    3 ms; a chunk with a 5 ms output before the window (set-up)."""
    S = tracing.Span
    out = [S("mara3.chunk", T0 - 50 * MS, T0 - 10 * MS, None, 0, {}),
           S("mara3.output", T0 - 50 * MS, T0 - 45 * MS, 0, 0, {})]
    t = T0
    for output in (2, 0, 3):
        c = len(out)
        out.append(S("mara3.chunk", t, t + 10 * MS, None, 0, {}))
        if output:
            out.append(S("mara3.output", t, t + output * MS, c, 0,
                         {"task": "write_time_series"}))
        t += 10 * MS
    return out


def _window(start_ns=T0, end_ns=T0 + 30 * MS):
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


def test_output_wall_pct_arithmetic(store):
    read = spec.reader("output_wall_pct")
    # 5 ms of outputs in a 30 ms window; the set-up's output left out
    assert read(_window()) == pytest.approx(100 * 5 / 30, rel=1e-3)
    # a window that ends before the last output: 2 ms of 21
    assert read(_window(end_ns=T0 + 21 * MS)) == pytest.approx(
        100 * 2 / 21, rel=1e-3)
    # a window with no chunk: nothing to read
    assert read(_window(T0 - 9 * MS, T0 - 1 * MS)) is None


def test_output_wall_pct_reads_nothing_without_the_tracer(monkeypatch):
    monkeypatch.setitem(sys.modules, "mara3_tpu_torch.app.tracing", None)
    monkeypatch.delattr("mara3_tpu_torch.app.tracing", raising=False)
    assert spec.reader("output_wall_pct")(_window()) is None


def test_output_wall_pct_reads_kh_under_the_profiler():
    from torch.profiler import ProfilerActivity, profile
    s = spec.system("kh")(_cell(), "cpu", SMALL)
    s.setup(SEED)
    tracing.clear()
    with profile(activities=[ProfilerActivity.CPU]):
        start = time.perf_counter()
        # to a time between two rows, so that every row is a loop's task
        # call (run()'s closing call at tfinal is not traced)
        s.advance((STEPS + 0.5) * DT)
        end = time.perf_counter()
    rec = record.Record(start, end, [], 0, 0.0, 1, N * N)
    share = spec.reader("output_wall_pct")(rec)
    outputs = [x for x in tracing.spans() if x.name == "mara3.output"]
    assert len(outputs) == len(s.rows) > 1
    assert 0.0 < share < 100.0
