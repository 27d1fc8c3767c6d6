"""The flagship fast loop's chunk plan (subprograms/binary.plan_chunk and
steps_to).

- On synthetic dt rows: with a constant dt the chunk ends on the step the
  due falls on; with the coming steps at the plan's own bound, or falling,
  the due never falls before the chunk's last step; tfinal, the next
  regrid and MAX_CHUNK each bound the chunk; the first two chunks are one
  step each (dt, then its rise).
- The loop on the CPU in float64 at depth 3 / block 8, through the
  per-step scan and B3's plain version (multi_launch=16), against the same
  loop with one step a chunk: the same rows, the same conserved state, time
  and iteration bit for bit, the totals and elements within 1e-13; with a
  fixed dt, no step replayed and at least 9 in 10 planned chunks ending on
  their due.
"""

from __future__ import annotations

import contextlib
import functools
import io
from dataclasses import replace

import numpy as np
import pytest
import torch

from mara3_tpu_torch.app import tracing
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

DT = 1.3e-3
FAR = 1e9


def clock(t0, dts):
    """The times after each of `dts` from t0."""
    return t0 + np.cumsum(dts)


@pytest.mark.parametrize("frac", [0.01, 0.5, 0.99])
@pytest.mark.parametrize("steps", [1, 2, 7, 22, TB.MAX_CHUNK])
def test_constant_dt_ends_on_the_due(steps, frac):
    t0 = 3.7
    due = t0 + (steps - 1 + frac) * DT        # reached on step `steps`
    n = TB.plan_chunk(t0, np.full(5, DT), due, None, FAR)
    assert n == steps
    times = clock(t0, np.full(n, DT))
    assert times[-1] >= due and (n == 1 or times[-2] < due)


@pytest.mark.parametrize("coming", ["at_bound", "falling"])
@pytest.mark.parametrize("slope", [2e-3, 0.0, -2e-3])
@pytest.mark.parametrize("gap", [0.3, 1.7, 5.5, 21.94, 87.2])
def test_the_due_never_falls_before_the_last_step(gap, slope, coming):
    """`slope` is the last steps' change of dt, relative, a step; the
    coming steps rise at the plan's bound (its largest dt plus its largest
    rise times the steps ahead), or fall by the history's largest fall."""
    history = DT * (1 + slope * np.arange(6))
    rise = max(np.diff(history).max(), 0.0)
    fall = max(-np.diff(history).min(), DT * 2e-3)
    ahead = np.arange(1, TB.MAX_CHUNK + 1)
    dts = (history.max() + rise * ahead if coming == "at_bound"
           else history[-1] - fall * ahead)
    t0 = 11.0
    due = t0 + gap * DT
    n = TB.plan_chunk(t0, history, due, None, FAR)
    times = clock(t0, dts)
    assert n == 1 or times[n - 2] < due
    if coming == "at_bound":
        assert times[n - 1] >= due             # the due is the last step


@pytest.mark.parametrize("stop,expect", [
    ("tfinal", 10), ("regrid", 5), ("max_chunk", TB.MAX_CHUNK),
    ("due", 3), ("past", 1)])
def test_tfinal_the_regrid_and_the_cap_bound_the_chunk(stop, expect):
    t0 = 1.0
    at = {"tfinal": 9.5, "regrid": 4.5, "due": 2.5, "past": -0.5}
    times = {k: (t0 + at[k] * DT if k == stop else t0 + 1000 * DT)
             for k in ("tfinal", "regrid", "due")}
    if stop == "past":                           # a stop already passed
        times["due"] = t0 + at["past"] * DT
    n = TB.plan_chunk(t0, np.full(3, DT), times["due"], times["regrid"],
                      times["tfinal"])
    assert n == expect
    # without regrid the regrid time is not a stop
    if stop == "regrid":
        assert TB.plan_chunk(t0, np.full(3, DT), times["due"], None,
                             times["tfinal"]) == TB.MAX_CHUNK


@pytest.mark.parametrize("dts", [None, np.array([DT])])
def test_the_first_chunks_learn_dt_and_its_rise(dts):
    assert TB.plan_chunk(0.0, dts, 10 * DT, 20 * DT, 30 * DT) == 1


def test_a_stop_beyond_the_cap_reads_one_past_it():
    dts = np.full(4, DT)
    assert TB.steps_to(0.0, dts, 1000 * DT) == TB.MAX_CHUNK + 1
    assert TB.steps_to(0.0, dts, (TB.MAX_CHUNK - 0.5) * DT) == TB.MAX_CHUNK


# ---- the loop -------------------------------------------------------------

ARGV = ["binary", "depth=3", "block_size=8", "fast_step=1", "outdir=."]
# dt fixed at CFL 0.2 (no fault on this mesh), a row every 6.7 steps: 59
# steps; the CFL dt, which swings threefold within a quarter orbit on this
# coarse mesh (so the plan misses dues and replays), a row every 4-9
# steps: 36 steps
DT_MODES = {"fixed": ["fixed_dt=1", "cfl_number=0.2", "tsi=0.045",
                      "tfinal=0.4"],
            "cfl": ["tsi=0.05", "tfinal=0.3"]}
EXACT = ("time", "disk_mass", "disk_angular_momentum")


def _tasks(st, sd):
    schedule = st.schedule
    for task in ("write_diagnostics", "write_checkpoint"):
        if schedule.is_due(task):
            schedule = schedule.mark_as_completed(task)
    st = replace(st, schedule=schedule)
    if schedule.is_due("record_time_series"):
        st = TB.record_time_series(st, sd)
    return st


@functools.lru_cache(maxsize=None)
def loop_run(multi: int, dt_mode: str, one_step: bool):
    """One float64 run of the fast loop under the profiler: (its rows, the
    final row, conserved state, time, iteration, the tracer's counters,
    its progress lines)."""
    from torch.profiler import ProfilerActivity, profile
    tracing.clear()
    out = io.StringIO()
    with pytest.MonkeyPatch.context() as mp:
        if one_step:
            mp.setattr(TB, "plan_chunk", lambda *args: 1)
        with contextlib.redirect_stdout(out), \
                profile(activities=[ProfilerActivity.CPU]):
            cfg, sd, state = TB.setup(
                ARGV + [f"multi_launch={multi}"] + DT_MODES[dt_mode],
                device="cpu", dtype=torch.float64)
            final = TB.run(cfg, sd, state, tasks=_tasks)
    counts = tracing.counts()
    tracing.clear()
    s = final.solution
    lines = [ln for ln in out.getvalue().splitlines() if ln.startswith("[")]
    return (np.stack(final.time_series),
            TB.time_series_sample(s, final.solver_data),
            s.conserved.numpy().copy(), s.time, s.iteration, counts, lines)


def _same_row_fields(a, b):
    for name in a.dtype.names:
        if name in EXACT:
            np.testing.assert_array_equal(a[name], b[name], err_msg=name)
        elif a.dtype[name].names:
            _same_row_fields(a[name], b[name])
        else:
            np.testing.assert_allclose(a[name], b[name], rtol=1e-13,
                                       atol=1e-13 * np.abs(b[name]).max(),
                                       err_msg=name)


@pytest.mark.parametrize("dt_mode", ["fixed", "cfl"])
@pytest.mark.parametrize("multi", [0, 16])
def test_planned_chunks_match_one_step_chunks(multi, dt_mode):
    rows, last, u, t, it, _, lines = loop_run(multi, dt_mode, False)
    rows1, last1, u1, t1, it1, _, lines1 = loop_run(multi, dt_mode, True)
    assert len(lines) < len(lines1) == it1   # longer chunks than one step
    assert rows.shape == rows1.shape and len(rows) > 4
    _same_row_fields(rows, rows1)
    _same_row_fields(last, last1)
    np.testing.assert_array_equal(u, u1)
    assert t == t1 and it == it1


@pytest.mark.parametrize("multi", [0, 16])
def test_planned_chunks_end_on_their_dues(multi):
    rows, _, _, _, _, counts, lines = loop_run(multi, "fixed", False)
    assert counts.get("replay_steps", 0) == 0
    assert counts["planned_to_due"] >= len(rows) - 2
    assert counts["planned_due_hits"] >= 0.9 * counts["planned_to_due"]
    assert len(lines) <= 1.3 * len(rows) + 2     # the two learning chunks
