"""The port's tracer (mara3_tpu_torch/app/tracing.py) and the spans and
counters of its fast driver loops, on the CPU with fast_step=1: binary's
and amrsand's at depth 3 / block 16, and tiny runs of the fixed-dt loops
of kh, cloud, sand3d and blast3d.

- With no profiler running, a run records only its set-up's phase spans
  and counters, and never opens a profiler range.
- Under torch.profiler, every count is held to one kept apart from the
  tracer: the chunks to the progress lines, the steps to the iterations
  advanced, the rows to the rows added, the replayed steps to a wrapper
  around the scan, the retries and regrids to their lines; each child lies
  inside its parent, each chunk is waited for once (in a fixed-dt loop
  after the next chunk's launch or before a host read) and its line
  printed after that wait, and the span names are among the profiler's
  events. blast3d's octree step records a `mara3.step` a step with three
  `mara3.guard` and three `mara3.correct` inside, and its loop one
  `wavespeed_reads` a window; on the CPU `octree_kernel_steps` stays 0,
  and on a card (marked `cuda`) it equals `steps`.
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

    def __init__(self, monkeypatch, program: str, extra=(), kernel=False,
                 device="cpu"):
        from collections import Counter
        self.program, self.rows_by_runner = program, 0
        self.device = device
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
                cfg, state = module.setup(self.argv, device=self.device,
                                          **kw)
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


PHASES = {"mara3.setup", "mara3.build", "mara3.tables"}


@pytest.mark.parametrize("program", PROGRAMS)
def test_untraced_run_records_only_phase_spans(monkeypatch, program):
    """Without a profiler the store keeps the set-up's phase spans and
    counters (one `mara3.setup`; binary's `mara3.tables`, one a run) and
    none of the loop's, and no profiler range is opened."""
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
    spans = tracing.spans()
    assert {s.name for s in spans} <= PHASES
    assert [s.name for s in spans].count("mara3.setup") == 1
    assert all(s.end_ns is not None for s in spans)
    assert set(tracing.counts()) <= {"kernel_builds", "table_builds"}
    if program == "binary":
        assert tracing.counts()["table_builds"] == \
            [s.name for s in spans].count("mara3.tables") == 1
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
        # B6's tables are looked up at every launch and built, a span each
        # build, on a miss: the first launch's and each new tree's
        assert len(tables) == counts["table_builds"] < len(run.progress)
        assert all(spans[s.parent].name == "mara3.launch" for s in tables)


def test_blast3d_records_its_steps_guards_and_wavespeed_reads(monkeypatch):
    """One `mara3.step` a step advanced, inside the chunk's launch; three
    `mara3.guard` and three `mara3.correct` inside each step, in turn; one
    `wavespeed_reads` a window (a chunk, one advance call each)."""
    run = Run(monkeypatch, "blast3d")
    spans, counts, names, _ = traced(run)
    _check_tree(spans)
    steps = [i for i, s in enumerate(spans) if s.name == "mara3.step"]
    assert len(steps) == counts["steps"] == \
        run.final.solution.iteration - run.start > 1
    assert all(spans[spans[i].parent].name == "mara3.launch" for i in steps)
    for i in steps:
        inside = [s.name for s in spans if s.parent == i]
        assert inside == ["mara3.guard", "mara3.correct"] * 3
    parts = [s for s in spans if s.name in ("mara3.guard", "mara3.correct")]
    assert len(parts) == 6 * len(steps)
    assert all(spans[s.parent].name == "mara3.step" for s in parts)
    chunks = [s for s in spans if s.name == tracing.CHUNK]
    assert counts["wavespeed_reads"] == len(chunks) == len(run.progress) > 1
    assert {"mara3.step", "mara3.guard", "mara3.correct"} <= names


def test_blast3d_plain_step_counts_no_kernel_steps(monkeypatch):
    """On the CPU the octree step is B12's plain version: the counter of
    the kernel's steps stays 0 while `steps` counts the run's."""
    run = Run(monkeypatch, "blast3d")
    _, counts, _, _ = traced(run)
    assert counts["steps"] == run.final.solution.iteration - run.start > 1
    assert counts.get("octree_kernel_steps", 0) == 0


@pytest.mark.cuda
def test_blast3d_on_the_card_counts_every_step_as_a_kernel_step(
        monkeypatch):
    """On the card every step is kernel B12's: `octree_kernel_steps`
    equals `steps`, no step records a host span, and each window's line
    names the kernel."""
    if not torch.cuda.is_available():
        pytest.skip("kernel B12 runs only on a CUDA card (no GPU here)")
    run = Run(monkeypatch, "blast3d", device="cuda")
    spans, counts, _, _ = traced(run)
    _check_tree(spans)
    assert counts["octree_kernel_steps"] == counts["steps"] == \
        run.final.solution.iteration - run.start > 1
    assert not [s for s in spans if s.name in ("mara3.step", "mara3.guard",
                                               "mara3.correct")]
    windows = [line for line in run.lines if PROGRESS.match(line)]
    assert windows and all(re.search(r"\[cuda_b12\[\d+\]\]$", line)
                           for line in windows)


def test_blast3d_step_untraced_records_nothing(monkeypatch):
    from mara3_tpu_torch.mesh import euler3d
    entered = []
    monkeypatch.setattr(torch._C._profiler, "_RecordFunctionFast",
                        lambda name, *a, **k: entered.append(name))
    with contextlib.redirect_stdout(io.StringIO()):
        cfg, state = blast3d.setup(["blast3d", "depth=2", "block_size=4"],
                                   device="cpu", dtype=F64)
    u = state.solution.conserved
    euler3d.make_advance(state.mesh, 4, blast3d.GAMMA)(u, 1e-3, 3)
    # the set-up's phase span, and nothing of the steps
    assert [s.name for s in tracing.spans()] == ["mara3.setup"]
    assert tracing.counts() == {}
    assert entered == []


def test_chunks_of_more_than_one_b3_launch_go_on_the_timeline(
        monkeypatch):
    """With one step a B3 launch (its plain version), every chunk, the
    longer ones of several launches included, is on the profiler's
    timeline with its plan, its launch, a `mara3.call` a step, its
    post-read work and the rows' outputs: every span of the store is an
    event of the profiler."""
    from collections import Counter
    run = Run(monkeypatch, "binary", ["multi_launch=1", "tfinal=0.08"])
    spans, _, _, events = traced(run)
    _check_tree(spans, in_flight=False)
    chunks = [s for s in spans if s.name == tracing.CHUNK]
    assert sum(c.attrs["steps"] > 1 for c in chunks) > 0
    assert events["mara3.chunk"] == events["mara3.launch"] == \
        events["mara3.plan"] == len(chunks)
    assert {k: v for k, v in events.items() if k.startswith("mara3.")} \
        == Counter(s.name for s in spans)
    assert {"mara3.call", "mara3.post", "mara3.output"} <= set(events)
    assert all(s.attrs["steps"] == 1 for s in spans if s.name == "mara3.call")


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
    assert {s.name for s in tracing.spans()} == {"mara3.setup"}
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
    # no card, no device events: no idle gap to put down to a span
    assert summary["idle_by_span"] == []
    assert summary["spans"]["mara3.setup"]["count"] == 1
    chunk = summary["spans"]["mara3.chunk"]
    assert chunk["count"] == progress
    assert 0 < chunk["self_ms"] <= chunk["total_ms"]
    assert summary["counts"]["steps"] == 32
    assert summary["counts"]["outputs.write_diagnostics"] == 3


def test_the_tracer_stands_on_record_function_fast():
    """Every span on the timeline is a `torch._C._profiler.
    _RecordFunctionFast` range, a private name of PyTorch: a PyTorch that
    lacks it or records it as something else breaks every traced run."""
    fast = getattr(getattr(torch._C, "_profiler", None),
                   "_RecordFunctionFast", None)
    assert fast is not None, (
        "app/tracing.py opens its spans as torch._C._profiler."
        "_RecordFunctionFast ranges, which this PyTorch lacks")
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.recorder().span("mara3.footing"):
            pass
    events = [e for e in prof.profiler.kineto_results.events()
              if e.name() == "mara3.footing"]
    assert len(events) == 1, (
        "a torch._C._profiler._RecordFunctionFast range no longer shows as "
        "a host event of the profiler")
    assert [s.name for s in tracing.spans()] == ["mara3.footing"]


def _fake_build(monkeypatch, tmp_path):
    """kernels/_build with its libraries under tmp_path, a build that only
    writes the library's file (and counts itself) and a loader that opens
    nothing."""
    from mara3_tpu_torch.kernels import _build
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_loaded", {})
    builds = []

    def build(name, verbose=False):
        path = _build.library_path(name)
        if not path.exists():
            builds.append(name)
            path.write_bytes(b"")
        return path

    monkeypatch.setattr(_build, "build", build)
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: ("lib", path))
    return _build, builds


def test_build_span_says_whether_nvcc_ran(monkeypatch, tmp_path):
    """Without a profiler: the first load of a library is a `mara3.build`
    span with `built` true when it had to be built and counts
    `kernel_builds`; a process that finds the library loads it (`built`
    false, no count); a second load in the process records nothing."""
    _build, builds = _fake_build(monkeypatch, tmp_path)
    assert not torch._C._autograd._profiler_enabled()
    _build.load("binary_multi")
    _build.load("binary_multi")
    monkeypatch.setattr(_build, "_loaded", {})      # a new process
    _build.load("binary_multi")
    spans = tracing.spans()
    assert builds == ["binary_multi"]
    assert [(s.name, s.attrs) for s in spans] == [
        ("mara3.build", {"kernel": "binary_multi", "built": True}),
        ("mara3.build", {"kernel": "binary_multi", "built": False})]
    assert all(s.end_ns is not None and s.parent is None for s in spans)
    assert tracing.counts() == {"kernel_builds": 1}


def test_phase_spans_go_on_the_timeline_under_a_profiler(monkeypatch,
                                                         tmp_path):
    """Under a profiler a phase span is a profiler range too, and a build
    inside the set-up is its child."""
    from torch.profiler import ProfilerActivity, profile
    _build, _ = _fake_build(monkeypatch, tmp_path)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with tracing.phase("mara3.setup"):
            _build.load("sedov_step")
    names = [e.name() for e in prof.profiler.kineto_results.events()]
    assert names.count("mara3.setup") == names.count("mara3.build") == 1
    setup, build = tracing.spans()
    assert (setup.name, build.name, build.parent) == \
        ("mara3.setup", "mara3.build", 0)


MS = 1_000_000


def _synthetic_store():
    """A chunk (off the timeline, store only) from 0 to 100 ms, holding a
    launch (1-10 ms) with one B3 call (2-9 ms) inside and a row's output
    (50-60 ms); a second chunk from 100 to 130 ms; nothing after."""
    S = tracing.Span
    return [S("mara3.chunk", 0, 100 * MS, None, 0, {"iteration": 0}),
            S("mara3.launch", 1 * MS, 10 * MS, 0, 0, {}),
            S("mara3.call", 2 * MS, 9 * MS, 1, 0, {"steps": 16}),
            S("mara3.output", 50 * MS, 60 * MS, 0, 0, {"task": "row"}),
            S("mara3.chunk", 100 * MS, 130 * MS, None, 22,
              {"iteration": 22})]


def test_idle_by_span_labels_each_gap_by_its_innermost_span():
    """Gaps between the device's events, on the profiler's clock (here the
    store's plus 5 s), put down to the innermost span over their middle: a
    gap in the B3 call, one in the chunk's own glue (the chunk off the
    timeline), one in the output, one in the next chunk, one after every
    span; gaps under 5 us and overlapping events are not gaps."""
    offset = 5 * 10**9

    def on(a_ms, b_ms):                 # an event on the profiler's clock
        return ("kernel", (a_ms * MS + offset) * 1e-9,
                (b_ms * MS + offset) * 1e-9)

    device = [on(0, 3), on(2.5, 4),     # overlapping: busy 0-4
              on(8, 20),                # gap 4-8 (middle 6): the call
              on(30, 52),               # gap 20-30 (middle 25): the chunk
              on(58, 110),              # gap 52-58 (middle 55): the output
              on(110.002, 115),         # 2 us: no gap
              on(125, 140),             # gap 115-125: the second chunk
              on(150, 151)]             # gap 140-150: no span
    store = _synthetic_store()
    got = tracing.idle_by_span(device, store, offset)
    assert [row[0] for row in got] == ["mara3.chunk", tracing.NO_SPAN,
                                       "mara3.output", "mara3.call"]
    by = {row[0]: row[1:] for row in got}
    assert by["mara3.chunk"][0] == pytest.approx(0.020, abs=1e-9)
    assert by["mara3.chunk"][1] == 2
    assert by["mara3.call"] == [pytest.approx(0.004, abs=1e-9), 1]
    assert by["mara3.output"] == [pytest.approx(0.006, abs=1e-9), 1]
    assert by[tracing.NO_SPAN] == [pytest.approx(0.010, abs=1e-9), 1]
    # each gap alone, between the two events around it, in time order
    gaps = [(on(2.5, 4), on(8, 20)), (on(8, 20), on(30, 52)),
            (on(30, 52), on(58, 110)), (on(110.002, 115), on(125, 140)),
            (on(125, 140), on(150, 151))]
    assert [tracing.idle_by_span(list(g), store, offset)[0][0]
            for g in gaps] == ["mara3.call", "mara3.chunk", "mara3.output",
                               "mara3.chunk", tracing.NO_SPAN]
    # a span still open covers every gap after its start
    still_open = [*store[:4], store[4]._replace(end_ns=None)]
    assert tracing.idle_by_span(device, still_open, offset)[0] == [
        "mara3.chunk", pytest.approx(0.030, abs=1e-9), 3]
    # with no store, every gap is outside any span
    assert tracing.idle_by_span(device, [], offset) == [
        [tracing.NO_SPAN, pytest.approx(0.040, abs=1e-9), 5]]


def test_spans_on_the_timeline_map_onto_the_profilers_clock(monkeypatch):
    """Under the CPU profiler every span of a short binary run (the
    set-up, the tables, the loop's spans, each B3 call) is a profiler event
    of its name, and each maps onto its event, the n-th span of a name onto
    the n-th event, within 50 us at both ends. A preempted stamp can miss
    by a time slice, so the run may be made three times; a mapping that is
    off misses every time."""
    from collections import Counter

    from torch.profiler import ProfilerActivity, profile
    worst = []
    run = Run(monkeypatch, "binary", ["multi_launch=1", "tfinal=0.03"])
    for _ in range(3):
        tracing.clear()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            run()
        events = {}
        for e in prof.profiler.kineto_results.events():
            if e.name().startswith("mara3."):
                events.setdefault(e.name(), []).append(
                    (e.start_ns(), e.start_ns() + e.duration_ns()))
        events = {k: sorted(v) for k, v in events.items()}
        spans = tracing.spans()
        # every span is on the timeline, none is left off it
        assert Counter(s.name for s in spans) == \
            Counter({k: len(v) for k, v in events.items()})
        assert {"mara3.setup", "mara3.tables", "mara3.chunk", "mara3.call",
                "mara3.output"} <= set(events)
        misses, seen = [], Counter()
        for s in spans:
            start, end = events[s.name][seen[s.name]]
            seen[s.name] += 1
            misses.append(max(abs(start - tracing.profiler_ns(s.start_ns)),
                              abs(end - tracing.profiler_ns(s.end_ns))))
        worst.append(max(misses))
        if worst[-1] <= 50_000:
            break
    assert min(worst) <= 50_000, worst


def test_each_b3_call_is_a_span_on_the_timeline(monkeypatch):
    """With 2 steps a B3 launch (its plain version), every call of the
    scan is a `mara3.call` (attribute `steps`) on the profiler's timeline:
    inside the chunk's launch, calls of 2 steps and a shorter last one
    that add up to the chunk's steps; inside a replay or a repair, the
    replayed steps."""
    run = Run(monkeypatch, "binary", ["multi_launch=2", "tfinal=0.08"])
    spans, counts, _, events = traced(run)
    _check_tree(spans, in_flight=False)
    calls = [s for s in spans if s.name == "mara3.call"]
    assert events["mara3.call"] == len(calls) > 0
    parent = {i: spans[s.parent].name for i, s in enumerate(spans)
              if s.name == "mara3.call"}
    assert set(parent.values()) <= {"mara3.launch", "mara3.replay",
                                    "mara3.repair"}
    assert sum(s.attrs["steps"] for i, s in enumerate(spans)
               if parent.get(i) in ("mara3.replay", "mara3.repair")) == \
        counts["replay_steps"]
    chunks = [i for i, s in enumerate(spans) if s.name == tracing.CHUNK]
    longer = 0
    for c in chunks:
        launch = next(i for i, s in enumerate(spans)
                      if s.parent == c and s.name == "mara3.launch")
        steps = [s.attrs["steps"] for s in spans if s.parent == launch]
        assert steps and all(k == 2 for k in steps[:-1]) and \
            1 <= steps[-1] <= 2
        longer += len(steps) > 1
        repaired = any(s.name == "mara3.repair" and
                       spans[s.parent].parent == c for s in spans)
        if not repaired:
            assert sum(steps) == spans[c].attrs["steps"]
    assert longer > 0
