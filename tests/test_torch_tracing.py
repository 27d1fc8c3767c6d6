"""The port's tracer (mara3_tpu_torch/app/tracing.py) and the spans and
counters of its fast driver loops, on the CPU with fast_step=1: binary's
and amrsand's at depth 3 / block 16, and tiny runs of the fixed-dt loops
of kh, cloud, sand3d and blast3d.

- With no profiler running, a run records nothing and never opens a
  profiler range.
- Under torch.profiler, every count is held to one kept apart from the
  tracer: the chunks to the progress lines, the steps to the iterations
  advanced, the rows to the rows added, the replayed steps to a wrapper
  around the scan, the retries and regrids to their lines; each child lies
  inside its parent, each chunk is waited for once (in a fixed-dt loop
  after the next chunk's launch or before a host read) and its line
  printed after that wait, and the span names are among the profiler's
  events.
- MARA3_PROFILE_DIR: an error raised inside a run comes out as itself, a
  profiler that does not start leaves an untraced run, and a clean run
  writes both files.
"""

from __future__ import annotations

import contextlib
import io
import json
import re
import sys
from dataclasses import replace

import pytest
import torch

from mara3_tpu_torch.app import subprogram, tracing
from mara3_tpu_torch.app.device import DEVICE_SELECTOR
from mara3_tpu_torch.subprograms import amrsand as TA
from mara3_tpu_torch.subprograms import binary as TB
from mara3_tpu_torch.subprograms import blast3d, cloud, kh, sand3d

torch.set_num_threads(1)

F64 = torch.float64
PROGRESS = re.compile(r"^\[(\d+)\] ")
# a time-series row every 2-3 steps, so that dues fall inside chunks and
# are replayed; this mesh faults once early and retries in safe mode
BINARY = ["binary", "depth=3", "block_size=16", "fast_step=1", "tsi=0.015",
          "tfinal=0.15", "outdir=."]
AMRSAND = ["amrsand", "depth=3", "block_size=16", "fast_step=1",
           "tfinal=0.25", "dfi=0.1"]
REGRID = {"binary": ["regrid=1", "rgi=0.02"],
          "amrsand": ["regrid=1", "rgi=0.05"]}
# the other fixed-dt loops, each with tfinal off every due so that the
# tasks write nothing after the loop; cloud runs its loop after its first
# tasks, as sedov's tests run sedov's
FIXED_DT = {
    "kh": (kh, ["kh", "N=32", "precision=f64", "tfinal=0.055", "cpi=0.02",
                "dfi=0.04", "tsi=0.01"]),
    # dt = 0.0403: a row every 3 steps
    "cloud": (cloud, ["cloud", "nr=24", "fast_step=1", "tfinal=0.65",
                      "cpi=0.5", "tsi=0.1", "dfi=0.25"]),
    "sand3d": (sand3d, ["sand3d", "depth=3", "block_size=8", "tfinal=0.11",
                        "dfi=0.04"]),
    "blast3d": (blast3d, ["blast3d", "depth=2", "block_size=4",
                          "tfinal=0.07", "dfi=0.02"]),
}
PROGRAMS = ["binary", "amrsand", *FIXED_DT]


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


class Run:
    """One run of a fast driver loop from setup, its standard output kept
    and the program's own outputs counted by its task runner: the rows it
    recorded, the outputs it wrote (by task), the scan's replayed steps and
    the regrids."""

    def __init__(self, monkeypatch, program: str, extra=(), kernel=False):
        from collections import Counter
        self.program, self.rows_by_runner = program, 0
        self.writes, self.replayed, self.regrids = Counter(), [], 0
        if program in FIXED_DT:
            self.argv = FIXED_DT[program][1] + list(extra)
            return
        module = TB if program == "binary" else TA
        regrid = module.apply_regrid

        def counting_regrid(*args, **kwargs):
            self.regrids += 1
            return regrid(*args, **kwargs)

        monkeypatch.setattr(module, "apply_regrid", counting_regrid)
        if program == "binary":
            build = TB.build_scan

            def counting_build_scan(cfg, sd):
                scan = build(cfg, sd)

                def counted(s, n):
                    if sys._getframe(1).f_code.co_name == "replay":
                        self.replayed.append(n)
                    return scan(s, n)
                return counted

            monkeypatch.setattr(TB, "build_scan", counting_build_scan)
        elif kernel:
            # B6's plain version in place of the scheme, so that the loop
            # goes through kernel_tables and its cache
            advance = TA.advance_n
            monkeypatch.setattr(TA, "_TABLES_CACHE", {})
            monkeypatch.setattr(
                TA, "advance_n",
                lambda *a, **k: advance(*a, **{**k, "kernel": True}))
        self.argv = (BINARY if program == "binary" else AMRSAND) + list(extra)

    def binary_tasks(self, st, sd):
        schedule = st.schedule
        for task in ("write_diagnostics", "write_checkpoint"):
            if schedule.is_due(task):
                schedule = schedule.mark_as_completed(task)
        st = replace(st, schedule=schedule)
        if schedule.is_due("record_time_series"):
            self.rows_by_runner += 1
            st = TB.record_time_series(st, sd)
        return st

    def tasks(self, st, cfg):
        """Every due task marked done, and counted, without its file."""
        schedule = st.schedule
        for task in schedule:
            if task.is_due:
                self.writes[task.name] += 1
                schedule = schedule.mark_as_completed(task.name)
        return replace(st, schedule=schedule)

    def __call__(self):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            if self.program == "binary":
                cfg, sd, state = TB.setup(self.argv, device="cpu", dtype=F64)
                self.start = state.solution.iteration
                final = TB.run(cfg, sd, state, tasks=self.binary_tasks)
                self.rows = len(final.time_series) - len(state.time_series)
            elif self.program == "amrsand":
                cfg, state = TA.setup(self.argv, device="cpu", dtype=F64)
                self.start = state.solution.iteration
                final = TA.run(cfg, state, tasks=self.tasks)
            elif self.program == "cloud":
                cfg, state = cloud.setup(self.argv, device="cpu", dtype=F64)
                state = self.tasks(state, cfg)
                self.writes.clear()
                self.start = state.solution.iteration
                final = cloud._run_fast(cfg, state, self.tasks)
            else:
                module = FIXED_DT[self.program][0]
                kw = {} if module is kh else {"dtype": F64}
                cfg, state = module.setup(self.argv, device="cpu", **kw)
                self.start = state.solution.iteration
                final = module.run(cfg, state, tasks=self.tasks)
        self.final = final
        self.lines = out.getvalue().splitlines()
        self.progress = [int(m.group(1)) for m in map(PROGRESS.match,
                                                      self.lines) if m]
        return self

    def lines_with(self, text: str) -> int:
        return sum(line.startswith(text) for line in self.lines)


def traced(run: Run):
    """(the store's spans, its counters, the profiler's event names, the
    number of the profiler's events of each name)."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        run()
    events = Counter(e.name() for e in prof.profiler.kineto_results.events())
    return tracing.spans(), tracing.counts(), set(events), events


@pytest.mark.parametrize("program", PROGRAMS)
def test_untraced_run_records_nothing(monkeypatch, program):
    entered = []

    class StandIn:
        def __init__(self, name, *args, **kwargs):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False

    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast", StandIn)
    monkeypatch.setattr(torch.profiler, "record_function", StandIn)
    run = Run(monkeypatch, program)()
    assert run.progress and run.final.solution.iteration > run.start
    assert tracing.spans() == [] and tracing.counts() == {}
    assert entered == []


def _check_tree(spans, in_flight=True):
    """Every child inside its parent; every span in a chunk carries the
    chunk's iteration; one wait a chunk. Binary's chunk holds its own
    wait; a fixed-dt loop (`in_flight`) waits for a chunk after its launch,
    in the same chunk, a later one or after the last, and prints its line
    after the wait."""
    for s in spans:
        assert s.end_ns is not None and s.start_ns <= s.end_ns
        if s.parent is not None:
            p = spans[s.parent]
            assert p.start_ns <= s.start_ns and s.end_ns <= p.end_ns, s.name
            if s.name != tracing.CHUNK:
                assert s.chunk == p.chunk
    chunks = [i for i, s in enumerate(spans) if s.name == tracing.CHUNK]
    for i in chunks:
        assert spans[i].chunk == spans[i].attrs["iteration"]
        waits = [c for c in spans if c.parent == i
                 and c.name == "mara3.wait"]
        assert len(waits) == 1 or (in_flight and len(waits) <= 2)
    if in_flight:
        def named(name):
            return [s for s in spans if s.name == name and (
                s.parent is None or spans[s.parent].name == tracing.CHUNK)]
        launches, waits, prints = map(named, ("mara3.launch", "mara3.wait",
                                              "mara3.print"))
        assert len(launches) == len(waits) == len(prints) == len(chunks)
        assert all(w.start_ns >= l.end_ns and p.start_ns >= w.end_ns
                   for l, w, p in zip(launches, waits, prints))


@pytest.mark.parametrize("program", PROGRAMS)
def test_traced_run_counts_what_the_loop_did(monkeypatch, program):
    run = Run(monkeypatch, program)
    spans, counts, names, _ = traced(run)
    _check_tree(spans, program != "binary")
    chunks = [s for s in spans if s.name == tracing.CHUNK]
    assert len(chunks) == len(run.progress) > 1
    # each chunk starts where the last progress line left off
    assert [c.attrs["iteration"] for c in chunks] == \
        [run.start] + run.progress[:-1]
    assert [c.attrs["steps"] for c in chunks] == [
        b - a for a, b in zip([run.start] + run.progress, run.progress)]
    assert counts["steps"] == run.final.solution.iteration - run.start
    outputs = [s for s in spans if s.name == "mara3.output"]
    if program == "binary":
        rows = [s for s in outputs
                if s.attrs["task"] == "record_time_series"]
        assert len(rows) == counts["outputs.record_time_series"] \
            == run.rows - run.rows_by_runner > 0
        assert counts["replay_steps"] == sum(run.replayed) > 0
        assert counts["retries"] == run.lines_with("negative density") == 1
        assert counts["table_builds"] == 1
        assert {"mara3.replay", "mara3.sample", "mara3.repair",
                "mara3.mark", "mara3.tables"} <= {s.name for s in spans}
    elif program == "amrsand":
        assert len(outputs) == counts["outputs.write_diagnostics"] \
            == run.writes["write_diagnostics"] == 3
    else:
        assert {k: v for k, v in counts.items()
                if k.startswith("outputs.")} == {
            f"outputs.{task}": n for task, n in run.writes.items()}
        assert sum(run.writes.values()) >= len(outputs) > 1
        assert sum(len(s.attrs["task"].split("+")) for s in outputs) == \
            sum(run.writes.values())
    assert {s.name for s in spans} <= names
    assert {"mara3.chunk", "mara3.plan", "mara3.launch", "mara3.wait",
            "mara3.output", "mara3.print"} <= names


@pytest.mark.parametrize("program", ["binary", "amrsand"])
def test_traced_regrids_and_table_builds(monkeypatch, program):
    run = Run(monkeypatch, program, REGRID[program], kernel=True)
    spans, counts, _, _ = traced(run)
    _check_tree(spans, program != "binary")
    regrids = [s for s in spans if s.name == "mara3.regrid"]
    assert len(regrids) == counts["regrids"] == run.regrids > 1
    assert all(spans[s.parent].name == tracing.CHUNK for s in regrids)
    changes = counts.get("tree_changes", 0)
    assert changes >= 1
    # binary prints a line for a regrid that changes the tree, amrsand one
    # for every regrid
    lines = run.lines_with("regrid:")
    assert lines == (changes if program == "binary" else len(regrids))
    # the first tables, then one build for each new tree
    assert counts["table_builds"] == 1 + changes
    tables = [s for s in spans if s.name == "mara3.tables"]
    if program == "binary":
        # the scan is rebuilt inside the regrid that changed the tree
        assert sum(s.parent is not None
                   and spans[s.parent].name == "mara3.regrid"
                   for s in tables) == changes
    else:
        # B6's tables are looked up at every launch, built on a miss
        assert len(tables) == len(run.progress)
        assert all(spans[s.parent].name == "mara3.launch" for s in tables)


def test_chunks_of_more_than_one_b3_launch_stay_off_the_timeline(
        monkeypatch):
    """With one step a B3 launch (its plain version), the profiler sees
    the one-step chunks and their launches, and no longer chunk."""
    run = Run(monkeypatch, "binary", ["multi_launch=1", "tfinal=0.08"])
    spans, _, _, events = traced(run)
    _check_tree(spans, in_flight=False)
    chunks = [s for s in spans if s.name == tracing.CHUNK]
    short = sum(c.attrs["steps"] == 1 for c in chunks)
    assert 0 < short < len(chunks)
    assert events["mara3.chunk"] == events["mara3.launch"] == short
    assert events["mara3.plan"] == len(chunks)


def test_summary_takes_the_union_of_the_children():
    ms = 1_000_000
    S = tracing.Span
    store = [S("mara3.chunk", 0, 10 * ms, None, 0, {}),
             S("mara3.launch", 1 * ms, 4 * ms, 0, 0, {}),
             S("mara3.wait", 3 * ms, 6 * ms, 0, 0, {}),      # overlaps
             S("mara3.print", 8 * ms, 9 * ms, 0, 0, {}),
             S("mara3.chunk", 10 * ms, 12 * ms, None, 10, {}),
             S("mara3.chunk", 12 * ms, None, None, 20, {})]  # still open
    got = tracing.summary(store)
    assert got["mara3.chunk"]["count"] == 2
    assert got["mara3.chunk"]["total_ms"] == pytest.approx(12.0)
    assert got["mara3.chunk"]["self_ms"] == pytest.approx(10 - 6 + 2)
    assert got["mara3.wait"] == {"count": 1, "total_ms": pytest.approx(3.0),
                                 "self_ms": pytest.approx(3.0)}


class Boom(Exception):
    pass


def _cli(monkeypatch, tmp_path, *argv):
    monkeypatch.setenv(tracing.PROFILE_DIR, str(tmp_path / "profile"))
    monkeypatch.setenv(DEVICE_SELECTOR, "cpu")
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        code = subprogram.main(["mara3_tpu_torch", *argv])
    return code, out.getvalue()


def test_profile_dir_lets_a_run_error_through(monkeypatch, tmp_path):
    def failing(argv, *, device=None):
        with tracing.recorder().span(tracing.CHUNK, iteration=0):
            raise Boom("inside the traced loop")

    monkeypatch.setitem(subprogram._REGISTRY, "failing", failing)
    with pytest.raises(Boom, match="inside the traced loop"):
        _cli(monkeypatch, tmp_path, "failing")
    assert not torch._C._autograd._profiler_enabled()
    assert not (tmp_path / "profile").exists()


def test_profile_dir_runs_untraced_when_the_profiler_does_not_start(
        monkeypatch, tmp_path):
    class NoProfiler:
        def __init__(self, *args, **kwargs):
            pass

        def start(self):
            raise RuntimeError("no profiler here")

    monkeypatch.setattr(torch.profiler, "profile", NoProfiler)
    code, out = _cli(monkeypatch, tmp_path, *AMRSAND[:-2], "tfinal=0.02",
                     f"outdir={tmp_path}")
    assert code == 0
    said = [line for line in out.splitlines() if "profiler" in line]
    assert len(said) == 1 and "untraced" in said[0]
    assert tracing.spans() == []
    assert not (tmp_path / "profile").exists()


def test_profile_dir_writes_the_trace_and_the_spans(monkeypatch, tmp_path):
    code, out = _cli(monkeypatch, tmp_path, *AMRSAND, f"outdir={tmp_path}")
    assert code == 0
    progress = sum(bool(PROGRESS.match(line)) for line in out.splitlines())
    trace = json.loads((tmp_path / "profile" / "amrsand.trace.json")
                       .read_text())
    events = {e.get("name") for e in trace["traceEvents"]}
    assert {"mara3.chunk", "mara3.launch", "mara3.wait"} <= events
    summary = json.loads((tmp_path / "profile" / "amrsand.spans.json")
                         .read_text())
    chunk = summary["spans"]["mara3.chunk"]
    assert chunk["count"] == progress
    assert 0 < chunk["self_ms"] <= chunk["total_ms"]
    assert summary["counts"]["steps"] == 32
    assert summary["counts"]["outputs.write_diagnostics"] == 3
