"""The spans and counters of sedov's chunked loop (subprograms/sedov.py
`_run_fast`) and of the SRHD Newton (physics/srhd.py), on the CPU at
nr = 32 in float64 with fast_step=1 and B5's plain version in the loop,
as on the card, where the steps' Newton runs inside the kernel and only
the rows and the diagnostics recover through physics/srhd.py.

- Under torch.profiler, every count is held to one kept apart from the
  tracer: the chunks to the progress lines, `steps` to the iterations
  advanced, `outputs.write_time_series` and `outputs.write_diagnostics`
  to what the task runner did, each chunk holds one plan and one launch
  and is waited for and printed once, and every recovery
  (`mara3.recover`) reads its Newton's convergence at least once
  (`recover_passes`).
- The final state is bit for bit the same with the recorder on and off.
- With no profiler running, a run records nothing.
"""

from __future__ import annotations

import contextlib
import io
import re
from collections import Counter
from dataclasses import replace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mara3_tpu_torch.app import tracing
from mara3_tpu_torch.subprograms import sedov as TS

torch.set_num_threads(1)

F64 = torch.float64
PROGRESS = re.compile(r"^\[(\d+)\] t=")
# 64 cells, dt = 0.0119: a row every 9 steps, a diagnostics write every
# 21, a checkpoint every 42; 51 steps
ARGV = ["sedov", "nr=32", "fast_step=1", "tfinal=0.6", "tsi=0.1",
        "dfi=0.25", "cpi=0.5"]


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


class Runner:
    """run_tasks without the files: the rows, the diagnostic fields (and
    the row a diagnostics file carries), the checkpoint's host copy; it
    counts what it did."""

    def __init__(self):
        self.done = Counter()

    def __call__(self, state, cfg):
        schedule, s = state.schedule, state.solution
        system = TS.hydro_system(cfg)
        if schedule.is_due("write_checkpoint"):
            self.done["write_checkpoint"] += 1
            s.conserved.cpu().numpy()
            schedule = schedule.mark_as_completed("write_checkpoint")
        if schedule.is_due("write_diagnostics"):
            self.done["write_diagnostics"] += 1
            TS.make_diagnostic_fields(s, system)
            TS.compute_time_series_data(s, system)
            schedule = schedule.mark_as_completed("write_diagnostics")
        if schedule.is_due("write_time_series"):
            self.done["write_time_series"] += 1
            TS.compute_time_series_data(s, system)
            schedule = schedule.mark_as_completed("write_time_series")
        return replace(state, schedule=schedule)


def _run(monkeypatch, traced: bool):
    """The loop from the run's start (its first tasks done, as run() does
    them): (the final state, the runner, the progress lines, the start's
    iteration)."""
    advance = TS.advance_n

    def b5_plain(u, vertices, dt, newtonian, n, reconstruct="pcm",
                 plm_theta=1.5, kernel=None):
        return advance(u, vertices, dt, newtonian, n, reconstruct, plm_theta,
                       True)

    monkeypatch.setattr(TS, "advance_n", b5_plain)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        cfg, state = TS.setup(ARGV, device="cpu", dtype=F64)
        runner = Runner()
        state = runner(state, cfg)
        runner.done.clear()
        if traced:
            with profile(activities=[ProfilerActivity.CPU]):
                final = TS._run_fast(cfg, state, runner)
        else:
            final = TS._run_fast(cfg, state, runner)
    lines = [ln for ln in out.getvalue().splitlines() if PROGRESS.match(ln)]
    return final, runner, lines, state.solution.iteration


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def test_the_loop_records_its_spans_and_counters(monkeypatch):
    final, runner, lines, start = _run(monkeypatch, traced=True)
    spans, counts = tracing.spans(), tracing.counts()
    chunks = [i for i, s in enumerate(spans) if s.name == "mara3.chunk"]
    assert len(chunks) == len(lines) > 0
    assert counts["steps"] == final.solution.iteration - start
    assert sum(spans[i].attrs["steps"] for i in chunks) == counts["steps"]
    for task in TS.TASKS:
        assert counts.get(f"outputs.{task}", 0) == runner.done[task] > 0
    # a chunk's wait and line come in a later chunk, or in its own where a
    # task due drains it, or after the last chunk
    for i in chunks:
        names = Counter(s.name for s in _children(spans, i))
        assert names["mara3.plan"] == names["mara3.launch"] == 1
        assert names["mara3.print"] <= 1 and names["mara3.wait"] <= 2
        assert names["mara3.output"] <= 1
    for name in ("mara3.wait", "mara3.print"):
        assert sum(s.name == name for s in spans) == len(chunks)
    outputs = [s for s in spans if s.name == "mara3.output"]
    assert len(outputs) == sum(
        any(s.name == "mara3.output" for s in _children(spans, i))
        for i in chunks)
    assert all(s.end_ns is not None and spans[s.parent].start_ns
               <= s.start_ns <= s.end_ns <= spans[s.parent].end_ns
               for s in spans if s.parent is not None)
    # a recovery for each row and two for each diagnostics write, each
    # inside an output, each reading its Newton's convergence at least once
    recoveries = [s for s in spans if s.name == "mara3.recover"]
    assert len(recoveries) == (runner.done["write_time_series"]
                               + 2 * runner.done["write_diagnostics"])
    assert all(spans[s.parent].name == "mara3.output" for s in recoveries)
    assert counts["recover_passes"] >= len(recoveries)


def test_the_recorder_leaves_the_state_bit_for_bit(monkeypatch):
    untraced, _, lines, _ = _run(monkeypatch, traced=False)
    # untraced, the store keeps only the set-up's phase span
    assert [s.name for s in tracing.spans()] == ["mara3.setup"]
    assert tracing.counts() == {}
    traced, _, traced_lines, _ = _run(monkeypatch, traced=True)
    assert torch.equal(untraced.solution.conserved, traced.solution.conserved)
    assert untraced.solution.time == traced.solution.time
    assert [ln.split(" kzps=")[0] for ln in lines] == \
        [ln.split(" kzps=")[0] for ln in traced_lines]


def test_a_recovery_counts_its_passes():
    """recover_passes counts the host reads of all(done): one for each
    pass of five updates begun, and one more for the read that ends the
    loop."""
    cfg, state = TS.setup(["sedov", "nr=32"], device="cpu", dtype=F64)
    with profile(activities=[ProfilerActivity.CPU]):
        TS.primitives_of(state.solution, TS.hydro_system(cfg))
    # at rest, the Newton from p = 0 converges in two updates: one pass,
    # then the read that finds every cell done
    assert tracing.counts()["recover_passes"] == 2
    # the set-up's phase span, kept with no profiler, then the recovery
    assert [s.name for s in tracing.spans()] == ["mara3.setup",
                                                 "mara3.recover"]
