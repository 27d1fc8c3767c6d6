"""The flagship fast loop's chunk in flight (subprograms/binary._main_fast),
on the CPU in float64 at depth 3 / block 16, through the per-step scan and
B3's plain version, with a log of what the loop did in order: each scan
call (a launch, or a replay), each row sample (of what), each call of the
task runner with a diagnostics due, each regrid and each printed line.

- The next chunk's launch comes before this chunk's row is read on the
  host, before its `mara3.output` and before its progress line; its
  device part (row_values) was enqueued before that launch.
- A fault (one injected into a chunk's rows, and the mesh's own early
  one), a due inside a chunk (its replay), a diagnostics due and a regrid
  all drain: nothing is launched ahead of them.
- Each launch after the first is counted once: `chunks_in_flight` where
  the chunk before had not ended on the host, else the chunk before
  counted `drains`; the last chunk, at tfinal, drains too.
- The rows, the schedule's time-series task, the state and `replay_steps`
  equal those of a run whose every chunk drains (a diagnostics due every
  chunk).
"""

from __future__ import annotations

import contextlib
import io
import re
import sys
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mara3_tpu_torch.app import tracing
from mara3_tpu_torch.schemes import binary_step
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

# a row every 2-3 steps (most chunks end on their due, some miss it and
# replay); this mesh faults once early and retries in safe mode
ARGV = ["binary", "depth=3", "block_size=16", "fast_step=1", "tsi=0.015",
        "tfinal=0.15", "outdir=.", "dfi=100", "cpi=100"]
PROGRESS = re.compile(r"^\[(\d+)\] orbits=")
LAUNCHES = ["multi_launch=0", "multi_launch=4"]


class Logged:
    """One float64 run of the fast loop under the profiler, with its log:
    ("launch", n) and ("replay", n) for the scan's calls, ("sample", kind)
    for time_series_sample's (kind: the class of what it was given),
    ("diagnostics",) for the task runner's calls with that task due,
    ("regrid",), and ("line", text) for each printed line. `fault_at`
    marks step 1 of the launch of that number (from 1) as faulted."""

    def __init__(self, monkeypatch, extra=(), fault_at=None, device="cpu",
                 dtype=torch.float64):
        self.log = []
        launches = []
        build, sample, regrid = (TB.build_scan, TB.time_series_sample,
                                 TB.apply_regrid)

        def logged_build_scan(cfg, sd):
            scan = build(cfg, sd)

            def logged(s, n):
                kind = ("replay" if sys._getframe(1).f_code.co_name
                        == "replay" else "launch")
                self.log.append((kind, n))
                s, rows = scan(s, n)
                if kind == "launch":
                    launches.append(n)
                    if len(launches) == fault_at:
                        assert n > 1
                        rows = rows.clone()
                        rows[1, binary_step.INFO_INDEX["invalid"]] = 1.0
                return s, rows
            return logged

        def logged_sample(solution, sd):
            self.log.append(("sample", type(solution).__name__))
            return sample(solution, sd)

        def logged_regrid(*args, **kwargs):
            self.log.append(("regrid",))
            return regrid(*args, **kwargs)

        monkeypatch.setattr(TB, "build_scan", logged_build_scan)
        monkeypatch.setattr(TB, "time_series_sample", logged_sample)
        monkeypatch.setattr(TB, "apply_regrid", logged_regrid)

        log = self.log

        class Lines(io.TextIOBase):
            def write(self, text):
                log.extend(("line", ln) for ln in text.splitlines()
                           if ln.strip())
                return len(text)

        tracing.clear()
        with contextlib.redirect_stdout(Lines()), \
                profile(activities=[ProfilerActivity.CPU]):
            cfg, sd, state = TB.setup(ARGV + list(extra), device=device,
                                      dtype=dtype)
            self.log.clear()
            self.final = TB.run(cfg, sd, state, tasks=self.tasks)
        self.spans, self.counts = tracing.spans(), tracing.counts()
        tracing.clear()

    def tasks(self, st, sd):
        schedule = st.schedule
        if schedule.is_due("write_diagnostics"):
            self.log.append(("diagnostics",))
        for task in ("write_diagnostics", "write_checkpoint"):
            if schedule.is_due(task):
                schedule = schedule.mark_as_completed(task)
        st = replace(st, schedule=schedule)
        if schedule.is_due("record_time_series"):
            st = TB.record_time_series(st, sd)
        return st

    def unended(self):
        """For each entry of the log, the chunks launched before it whose
        progress line had not been printed."""
        out, n = [], 0
        for entry in self.log:
            out.append(n)
            if entry[0] == "launch":
                n += 1
            elif entry[0] == "line" and PROGRESS.match(entry[1]):
                n -= 1
        return out

    def at(self, kind, text=None):
        """The unended chunks at each log entry of `kind` (whose line
        starts with `text`)."""
        return [n for entry, n in zip(self.log, self.unended())
                if entry[0] == kind and (text is None
                                         or entry[1].startswith(text))]


@pytest.fixture(scope="module")
def runs():
    """The runs shared by the tests: by scan, a plain one and one whose
    every chunk drains on a diagnostics due."""
    return ({k: logged([k]) for k in LAUNCHES},
            {k: logged([k, "dfi=1e-6"]) for k in LAUNCHES})


def logged(extra, fault_at=None, **kwargs):
    """A Logged run, its wrappers taken off after it."""
    with pytest.MonkeyPatch.context() as mp:
        return Logged(mp, extra, fault_at, **kwargs)


@pytest.mark.parametrize("launch", LAUNCHES)
def test_the_next_launch_comes_before_the_rows_read_output_and_print(
        runs, launch):
    run = runs[0][launch]
    lines = run.at("line", "[")
    chunks = [s for s in run.spans if s.name == tracing.CHUNK]
    assert len(lines) == len(chunks) == len(run.at("launch")) > 4
    # a line printed with two chunks unended is one printed after the
    # next chunk's launch; most chunks end that way
    in_flight = lines.count(2)
    assert set(lines) <= {1, 2} and in_flight > len(lines) / 2
    assert lines[-1] == 1                    # the last chunk drains
    # a row of a chunk that went ahead is read after the next launch, one
    # of a drained chunk before it
    rows = [n for entry, n in zip(run.log, run.unended())
            if entry[:1] == ("sample",) and entry[1] != "Solution"]
    assert len(rows) == run.counts["outputs.record_time_series"]
    assert set(rows) <= {1, 2} and rows.count(2) > 0
    # in the spans: a chunk's row output and line before its own wait are
    # the chunk before's, after this chunk's launch
    ahead = {"mara3.output": 0, "mara3.print": 0}
    for i, c in enumerate(run.spans):
        if c.name != tracing.CHUNK:
            continue
        kids = [s for s in run.spans if s.parent is not None
                and run.spans[s.parent].parent == i
                or s.parent == i]
        launch_end = next(s.end_ns for s in kids if s.name == "mara3.launch")
        wait_start = next(s.start_ns for s in kids if s.name == "mara3.wait")
        for s in kids:
            if s.name in ahead and s.start_ns < wait_start:
                assert s.start_ns >= launch_end, s.name
                ahead[s.name] += 1
    assert ahead == {"mara3.output": rows.count(2),
                     "mara3.print": in_flight}
    # every launch after the first either went ahead or followed a drain
    assert run.counts["chunks_in_flight"] == in_flight
    assert run.counts["drains"] == lines.count(1)
    assert run.counts["chunks_in_flight"] + run.counts["drains"] == \
        len(chunks)


@pytest.mark.parametrize("launch", LAUNCHES)
def test_faults_and_replays_drain(runs, launch):
    """The mesh's own fault and every replay to a due inside a chunk come
    before the next launch, and their chunk drains."""
    run = runs[0][launch]
    assert run.counts["retries"] == 1
    assert run.at("line", "negative density") == [1]
    assert run.counts["replay_steps"] == sum(
        n for kind, *rest in run.log if kind == "replay"
        for n in rest) > 0
    assert set(run.at("replay")) == {1}
    # the chunk of each replay prints its line before the next launch
    unended = run.unended()
    for i, entry in enumerate(run.log):
        if entry[0] == "replay":
            line = next(j for j in range(i, len(run.log))
                        if run.log[j][0] == "line"
                        and PROGRESS.match(run.log[j][1]))
            assert unended[line] == 1


def test_an_injected_fault_is_repaired_before_the_next_launch(runs):
    """A fault marked in a later chunk's rows: the chunk is rewound, its
    good step replayed and the faulted one retried before anything else
    is launched, and it counts a drain."""
    base = runs[0]["multi_launch=4"]
    lines = base.at("line", "[")
    # a chunk of two or more steps that went ahead
    launches = [entry for entry in base.log if entry[0] == "launch"]
    k = next(k for k in range(5, len(lines) - 1)
             if lines[k] == 2 and launches[k][1] > 1)
    run = logged(["multi_launch=4"], fault_at=k + 1)
    assert run.counts["retries"] == 2
    assert run.at("line", "negative density") == [1, 1]
    # the repair's replay of the good step and its retry follow the
    # faulted launch, and the chunk's line comes before the next launch
    i, following = [j for j, e in enumerate(run.log) if e[0] == "launch"][
        k:k + 2]
    replay = run.log.index(("replay", 1), i)
    retry, line = (next(j for j in range(replay, len(run.log))
                        if run.log[j][0] == "line"
                        and run.log[j][1].startswith(text))
                   for text in ("negative density", "["))
    assert i < replay < retry < line < following
    assert run.counts["drains"] == base.counts["drains"] + 1


def test_diagnostics_and_regrids_drain():
    run = logged(["multi_launch=4", "dfi=0.035", "regrid=1", "rgi=0.02"])
    assert len(run.at("regrid")) > 3
    # nothing is on the card at a regrid, and only the chunk being ended
    # at a diagnostics task inside the loop
    assert set(run.at("regrid")) == {0}
    diagnostics = run.at("diagnostics")
    assert len(diagnostics) > 3
    assert diagnostics[0] == 0 and set(diagnostics[1:]) <= {0, 1}
    assert diagnostics.count(1) > 2
    assert run.counts["chunks_in_flight"] > 0
    assert run.counts["chunks_in_flight"] + run.counts["drains"] == \
        len(run.at("line", "["))


def assert_same_bits(run, drained):
    """`run` went ahead on some chunks, `drained` on none, through the
    same chunks, rows, state and replays."""
    assert "chunks_in_flight" not in drained.counts
    assert drained.counts["drains"] == len(drained.at("line", "["))
    assert run.counts["chunks_in_flight"] > 0
    assert [e for e in run.log if e[0] in ("launch", "replay")] == \
        [e for e in drained.log if e[0] in ("launch", "replay")]
    a, b = run.final, drained.final
    assert np.stack(a.time_series).tobytes() == \
        np.stack(b.time_series).tobytes()
    assert a.schedule.at("record_time_series") == \
        b.schedule.at("record_time_series")
    assert torch.equal(a.solution.conserved, b.solution.conserved)
    assert a.solution == replace(b.solution, conserved=a.solution.conserved)
    assert run.counts.get("replay_steps") == drained.counts.get(
        "replay_steps")
    assert run.at("line", "[") != drained.at("line", "[")


@pytest.mark.parametrize("launch", LAUNCHES)
def test_a_run_that_drains_every_chunk_has_the_same_bits(runs, launch):
    assert_same_bits(runs[0][launch], runs[1][launch])


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float64, torch.float32],
                         ids=["f64", "f32"])
def test_on_the_card_chunks_in_flight_keep_the_bits(dtype):
    """On a card, through kernel B3, a chunk that goes ahead has its row
    copied into pinned memory behind an event before the next launch and
    read after it: the same bits as a run whose every chunk drains."""
    if not torch.cuda.is_available():
        pytest.skip("the pinned copy behind an event runs only on a CUDA "
                    "card (no GPU here)")
    run, drained = (logged(["multi_launch=4"] + extra, device="cuda",
                           dtype=dtype) for extra in ([], ["dfi=1e-6"]))
    assert_same_bits(run, drained)
