"""The fixed-dt driver loops' shared pieces, on the CPU: the chunk plan
(app/driver.steps_to_next_stop), the -1 "auto" flag (app/device.
resolve_auto), the progress line (app/driver.progress_line), the traced
task call (app/driver.traced_outputs), one chunk's timed launch and wait
(app/performance.timed_launch, wait) and the chunks left in flight
(app/driver.ChunksInFlight), alone and in the loops of amrsand, sedov and
kh. A stand-in for the CUDA timing events logs where the loops record
and wait on them.
"""

from __future__ import annotations

import contextlib
import io
import re
from dataclasses import replace

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mara3_tpu_torch.app import driver, performance, tracing
from mara3_tpu_torch.app.config import ConfigTemplate
from mara3_tpu_torch.app.device import resolve_auto
from mara3_tpu_torch.app.performance import timed_launch
from mara3_tpu_torch.app.schedule import Schedule
from mara3_tpu_torch.subprograms import amrsand, kh, sedov
from torch_bench import record

# chip_smoke.py's match of a chunked loop's line and what it ran
CHIP_SMOKE = re.compile(r"kzps=[0-9.]+ \[([a-z0-9_]+)\[(\d+)\]\]")


@pytest.fixture(autouse=True)
def empty_store():
    tracing.clear()
    yield
    tracing.clear()


@pytest.mark.parametrize("t, dt, tfinal, dues, steps", [
    # kh: 0.05 / dt is 512.0000000000001 in float64, 512 only through EPS
    pytest.param(0.0, 0.3 / 2048 / 1.5, 1.0, [0.05], 512, id="kh-512"),
    # amrsand-d7b64: dt = 2^-13 to the diagnostics due dfi = 1
    pytest.param(0.0, 2.0 ** -13, 2.0, [1.0], 8192, id="amrsand-dfi"),
    # sedov-524288: 0.1 / dt = 72,003.2 to the first row
    pytest.param(0.0, 1.3888270137263348e-6, 1.0, [0.1, 0.1, 1.0], 72004,
                 id="sedov-tsi"),
    # a due less than EPS ahead has been reached and is ignored
    pytest.param(0.5, 2.0 ** -7, 1.0, [0.5 + 1e-13], 64, id="due-reached"),
    pytest.param(0.0, 0.1, 0.25, [0.5, 1.0], 3, id="tfinal-nearest"),
    # a regrid (0.1) nearer than the diagnostics due (0.5)
    pytest.param(0.0, 2.0 ** -7, 1.0, [0.5, 0.1], 13, id="regrid-nearest"),
    pytest.param(0.0, 1.0, 10.0, [0.3], 1, id="under-one-step"),
])
def test_steps_to_next_stop(t, dt, tfinal, dues, steps):
    assert driver.steps_to_next_stop(t, dt, tfinal, dues) == steps


def test_the_kh_case_needs_eps():
    dt = 0.3 / 2048 / 1.5
    assert 0.05 / dt > 512 and 512 * dt < 0.05


@pytest.mark.parametrize("value, device, resolved", [
    (-1, "cpu", 0), (-1, "cuda", 1), (-1, "cuda:1", 1),
    (-1, torch.device("cpu"), 0), (0, "cuda", 0), (1, "cpu", 1),
    (16, "cpu", 16),
])
def test_resolve_auto(value, device, resolved):
    cfg = ConfigTemplate().item("flag", -1).create().update({"flag": value})
    assert resolve_auto(cfg, "flag", device) == resolved


class Log(io.TextIOBase):
    """Standard output, line by line, and the stand-in events' records and
    waits, in one list of entries."""

    def __init__(self):
        self.entries, self.events, self._part = [], 0, ""

    def writable(self):
        return True

    def write(self, s):
        self._part += s
        *done, self._part = self._part.split("\n")
        self.entries.extend(("line", line) for line in done)
        return len(s)

    def of(self, kind):
        return [e for e in self.entries if e[0] == kind]


class StandInEvent:
    """A CUDA timing event's stand-in. Chunk c records events 2c (before
    its launch) and 2c + 1 (after it); waiting on the latter logs ("wait",
    c), and the time between the two reads `ms`."""

    def __init__(self, log, ms):
        self.log, self.index, self.ms = log, log.events, ms
        log.events += 1
        log.entries.append(("record", self.index))

    def synchronize(self):
        self.log.entries.append(("wait", self.index // 2))

    def elapsed_time(self, end):
        return self.ms


@pytest.fixture
def log(monkeypatch):
    """A Log, and StandInEvents of 2 ms in place of CUDA's on any
    device."""
    log = Log()
    monkeypatch.setattr(performance, "record_event",
                        lambda device: StandInEvent(log, 2.0))
    return log


def _line(*args) -> str:
    """The line ChunksInFlight prints for a chunk of `args` (steps,
    iteration, time, zones, ms, path), ms from the stand-in events."""
    steps, iteration, time, zones, ms, path = args
    out = Log()
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(performance, "record_event",
                   lambda device: StandInEvent(out, ms))
        with contextlib.redirect_stdout(out):
            chunks = driver.ChunksInFlight(tracing.recorder(), "cpu")
            with chunks.launch():
                pass
            chunks.end(steps, iteration, time, zones, path)
            chunks.drain()
    assert out.entries[-1][1] == driver.progress_line(*args)
    return "".join(line + "\n" for _, line in out.of("line"))


@pytest.mark.parametrize("args, line", [
    ((256, 8192, 1.0, 652 * 64 * 64, 2.5, "cuda_b6[256]"),
     "[8192] t=1.0000000 kzps=273468620.80 [cuda_b6[256]]\n"),
    ((11, 11, 0.0123456789, 100, 0.0, "plain_b5_srhd_pcm[11]"),
     "[0011] t=0.0123457 kzps=1100000000000.00 [plain_b5_srhd_pcm[11]]\n"),
])
def test_the_progress_line(args, line):
    got = _line(*args)
    assert got == line
    m = record.PROGRESS.match(got)
    assert m and int(m.group(1)) == args[1] and float(m.group(2)) == \
        pytest.approx(args[2], abs=1e-7)
    m = CHIP_SMOKE.search(got)
    assert m and args[5] == f"{m.group(1)}[{m.group(2)}]"
    assert tracing.spans() == [] and tracing.counts() == {}


def _schedule(*due):
    s = Schedule.create("write_checkpoint", "write_diagnostics",
                        "write_time_series")
    for name in due:
        s = s.mark_as_due(name)
    return s


@pytest.mark.parametrize("due", [
    (), ("write_diagnostics",), ("write_checkpoint", "write_time_series")])
def test_traced_outputs(due):
    with profile(activities=[ProfilerActivity.CPU]):
        rec = tracing.recorder()
        with rec.span(tracing.CHUNK, iteration=0):
            chunks = driver.ChunksInFlight(rec, "cpu")
            with chunks.launch():
                pass
            chunks.end(3, 3, 0.3, 10, "scheme[3]")
            assert driver.due_tasks(_schedule(*due)) == list(due)
            chunks.drain()
            with driver.traced_outputs(rec, _schedule(*due)) as got:
                assert got == list(due)
    spans = tracing.spans()
    outputs = [s for s in spans if s.name == "mara3.output"]
    assert [s.attrs["task"] for s in outputs] == (["+".join(due)] if due
                                                  else [])
    assert [s.name for s in spans[1:4]] == ["mara3.launch", "mara3.wait",
                                            "mara3.print"]
    assert all(s.parent == 0 for s in spans[1:])
    assert spans[0].attrs == {"iteration": 0, "steps": 3}
    assert tracing.counts() == {"steps": 3, "drains": 1,
                                **{f"outputs.{name}": 1 for name in due}}


def test_timed_launch_on_the_cpu(monkeypatch):
    def no_sync(*args, **kwargs):
        raise AssertionError("synchronized")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    with profile(activities=[ProfilerActivity.CPU]):
        rec = tracing.recorder()
        with rec.span(tracing.CHUNK, iteration=0):
            with timed_launch(rec, torch.device("cpu")) as launch:
                torch.ones(8).sum()
            ms = launch.ms
            performance.wait(rec, launch)
    chunk, *children = tracing.spans()
    assert [s.name for s in children] == ["mara3.launch", "mara3.wait"]
    assert all(s.parent == 0 for s in children)
    first, then = children
    assert first.end_ns <= then.start_ns
    # no event off the card: the ms is the launch's wall time, read before
    # the launch opens and after it closes, and the wait keeps it
    assert launch.start is None and launch.end is None
    assert launch.ms == ms
    assert first.end_ns - first.start_ns - 1000 <= ms * 1e6
    assert ms * 1e6 <= then.start_ns - chunk.start_ns + 1000


def test_timed_launch_untraced_records_nothing():
    with timed_launch(tracing.recorder(), torch.device("cpu")) as launch:
        pass
    performance.wait(tracing.recorder(), launch)
    assert launch.ms >= 0 and tracing.spans() == []


def test_timed_launch_waits_on_its_end_event_only_in_the_wait(log):
    with timed_launch(tracing.recorder(), torch.device("cpu")) as launch:
        log.entries.append(("launch",))
    assert log.entries == [("record", 0), ("launch",), ("record", 1)]
    performance.wait(tracing.recorder(), launch)
    assert log.entries[-1] == ("wait", 0) and launch.ms == 2.0


# -----------------------------------------------------------------------------
# chunks in flight
# -----------------------------------------------------------------------------

def _chunks(chunks, log, steps, wait_after=()):
    """Chunks of 4 steps and 10 zones, t = 0.5 a chunk, through `chunks`
    on the CPU; chunk c's launch logs ("launch", c) and, for c in
    `wait_after`, the loop calls wait() after its end; then drain()."""
    with contextlib.redirect_stdout(log):
        for c in range(steps):
            with chunks.launch():
                log.entries.append(("launch", c))
            chunks.end(4, 4 * (c + 1), 0.5 * (c + 1), 10, "scheme[4]")
            if c in wait_after:
                chunks.wait()
        chunks.drain()


def _progress(c):
    return ("line", f"[{4 * (c + 1):04d}] t={0.5 * (c + 1):.7f} "
                    f"kzps=20.00 [scheme[4]]")


def test_the_next_launch_comes_before_the_wait_and_the_line_after_it(log):
    _chunks(driver.ChunksInFlight(tracing.recorder(), "cpu"), log, 3)
    assert log.entries == [
        ("record", 0), ("launch", 0), ("record", 1),
        ("record", 2), ("launch", 1), ("record", 3), ("wait", 0),
        _progress(0),
        ("record", 4), ("launch", 2), ("record", 5), ("wait", 1),
        _progress(1),
        ("wait", 2), _progress(2)]


def test_a_wait_keeps_the_line_for_the_next_end(log):
    """wait() after chunk 0: chunk 1 is launched with nothing in flight,
    and chunk 0's line follows chunk 1's launch without a second wait."""
    _chunks(driver.ChunksInFlight(tracing.recorder(), "cpu"), log, 2,
            wait_after=(0,))
    assert log.entries == [
        ("record", 0), ("launch", 0), ("record", 1), ("wait", 0),
        ("record", 2), ("launch", 1), ("record", 3), _progress(0),
        ("wait", 1), _progress(1)]


@pytest.mark.parametrize("steps, wait_after, in_flight, drains", [
    (4, (), 3, 1), (4, (1,), 2, 2), (3, (0, 1, 2), 0, 3), (1, (), 0, 1)])
def test_chunks_in_flight_and_drains_count(log, steps, wait_after,
                                           in_flight, drains):
    with profile(activities=[ProfilerActivity.CPU]):
        rec = tracing.recorder()
        with rec.span(tracing.CHUNK, iteration=0):
            _chunks(driver.ChunksInFlight(rec, "cpu"), log, steps,
                    wait_after)
    counts = tracing.counts()
    assert counts == {"steps": 4 * steps, "drains": drains,
                      **({"chunks_in_flight": in_flight} if in_flight
                         else {})}
    names = [s.name for s in tracing.spans()]
    assert names.count("mara3.wait") == steps
    assert names.count("mara3.print") == steps


def test_chunks_in_flight_untraced_records_nothing(log):
    _chunks(driver.ChunksInFlight(tracing.recorder(), "cpu"), log, 3,
            wait_after=(1,))
    assert tracing.spans() == [] and tracing.counts() == {}
    assert len(log.of("line")) == 3


class Synchronized(driver.ChunksInFlight):
    """The loops as they were before chunks in flight: each chunk waited
    for as soon as it has been launched."""

    def end(self, *line):
        super().end(*line)
        self._wait(self.last)


def _waited_all(log) -> bool:
    """Whether every chunk launched so far has been waited on."""
    return len(log.of("wait")) * 2 == log.events


def _task_runner(log):
    """A task runner that writes nothing: it logs ("tasks", iteration, the
    due names), checks that a due task finds no chunk in flight, and marks
    the due tasks done."""
    def tasks(state, cfg):
        due = tuple(driver.due_tasks(state.schedule))
        log.entries.append(("tasks", state.solution.iteration, due))
        if due:
            assert _waited_all(log), "a task ran with a chunk in flight"
        schedule = state.schedule
        for name in due:
            schedule = schedule.mark_as_completed(name)
        return replace(state, schedule=schedule)
    return tasks


LOOPS = {
    # a diagnostics due every 0.1 (13 chunks of 16, 4 and 1 steps at
    # dt 2^-7), the tree static
    "amrsand": (amrsand, ["amrsand", "depth=3", "block_size=8",
                          "tfinal=0.25", "dfi=0.1", "fast_step=1"]),
    # and a regrid every 0.05 besides
    "amrsand-regrid": (amrsand, ["amrsand", "depth=3", "block_size=8",
                                 "tfinal=0.25", "dfi=0.1", "fast_step=1",
                                 "regrid=1", "rgi=0.05"]),
    # a row every 0.05, the checkpoints and diagnostics at 0.1 and 0.2
    "sedov": (sedov, ["sedov", "nr=16", "tfinal=0.2", "tsi=0.05",
                      "dfi=0.1", "cpi=0.1", "newtonian=1", "fast_step=1"]),
    # a row every 0.01: every chunk (8 steps) ends on a due
    "kh": (kh, ["kh", "N=16", "tfinal=0.05", "cpi=0.02", "dfi=0.04",
                "tsi=0.01"]),
}


def _run_loop(name, log, monkeypatch, chunks_class):
    """setup() and run() of LOOPS[name] on the CPU in float64 with
    `chunks_class` for the loop's chunks; returns the final state."""
    module, argv = LOOPS[name]
    monkeypatch.setattr(driver, "ChunksInFlight", chunks_class)
    if module is amrsand:
        apply_regrid = amrsand.apply_regrid

        def regrid(s, cfg):
            assert _waited_all(log), "a regrid with a chunk in flight"
            log.entries.append(("regrid", s.iteration))
            return apply_regrid(s, cfg)

        monkeypatch.setattr(amrsand, "apply_regrid", regrid)
    cfg, state = module.setup(argv, device="cpu", dtype=torch.float64)
    with contextlib.redirect_stdout(log):
        final = module.run(cfg, state, tasks=_task_runner(log))
    return final


def _progress_and_tasks(log):
    """The progress lines' (iteration, time, path) and the task calls, in
    their order."""
    out = []
    for entry in log.entries:
        m = entry[0] == "line" and record.PROGRESS.match(entry[1])
        if m:
            out.append(("progress", int(m.group(1)), float(m.group(2)),
                        CHIP_SMOKE.search(entry[1]).group(0)))
        elif entry[0] in ("tasks", "regrid"):
            out.append(entry)
    return out


@pytest.mark.parametrize("name", list(LOOPS))
def test_the_loops_in_flight_match_the_synchronized_loops(
        name, log, monkeypatch):
    """The final state bit for bit, the progress lines and the task calls
    in their order, as when every chunk is waited for at once; each line
    after its chunk's wait, a drain before each task due, regrid and the
    end, and the order of lines and task calls the loops had."""
    final = _run_loop(name, log, monkeypatch, driver.ChunksInFlight)
    got = _progress_and_tasks(log)
    assert _waited_all(log) and log.events > 4
    # the end's task call after the last wait
    at = [i for i, e in enumerate(log.entries) if e[0] in ("tasks", "wait")]
    assert log.entries[at[-1]][0] == "tasks"
    # chunk c's line after chunk c's wait
    order = [e for e in log.entries if e[0] == "wait"
             or (e[0] == "line" and record.PROGRESS.match(e[1]))]
    assert order[0::2] == [("wait", c) for c in range(log.events // 2)]
    assert all(e[0] == "line" for e in order[1::2])

    sync_log = Log()
    monkeypatch.setattr(performance, "record_event",
                        lambda device: StandInEvent(sync_log, 2.0))
    want = _run_loop(name, sync_log, monkeypatch, Synchronized)
    assert torch.equal(final.solution.conserved, want.solution.conserved)
    assert final.solution.iteration == want.solution.iteration
    assert got == _progress_and_tasks(sync_log)

    # the order the loops had of the lines and the calls with a task due:
    # amrsand and kh call the tasks at the top of each chunk, after the
    # line of the chunk before; sedov after a chunk's launch, before its
    # line; all once more at the end. A call with nothing due (amrsand and
    # kh make one each chunk) may now come before the line of the chunk
    # still in flight.
    progress = [e[1] for e in got if e[0] == "progress"]
    calls = [e for e in got if e[0] == "tasks"]
    due = [e for e in calls[1:-1] if e[2]]
    assert len(due) >= 2
    want_order = [calls[0]]
    for it in progress:
        at = [e for e in due if e[1] == it]
        want_order += at + [it] if name == "sedov" else [it] + at
    want_order.append(calls[-1])
    assert [e[1] if e[0] == "progress" else e for e in got
            if e in due or e[0] == "progress" or e is calls[0]
            or e is calls[-1]] == want_order
    assert len(calls) == (len(due) + 2 if name == "sedov"
                          else len(progress) + 1)
    # a regrid after the chunk's task call and the line of the chunk
    # before it
    regrids = [i for i, e in enumerate(got) if e[0] == "regrid"]
    for i in regrids:
        before = got[:i]
        assert ("tasks", got[i][1]) in [e[:2] for e in before]
        assert [e for e in before if e[0] == "progress"][-1][1] == got[i][1]
    assert (len(regrids) >= 4) == (name == "amrsand-regrid")


@pytest.mark.parametrize("name, in_flight", [
    ("amrsand", True), ("sedov", True), ("kh", False)])
def test_the_loops_count_chunks_in_flight(name, in_flight, log,
                                          monkeypatch):
    """Each launch is in flight unless a drain came before it: in the
    loops' traced counters chunks_in_flight is the chunks less the drains,
    and 0 in kh, whose every chunk ends on a row due."""
    with profile(activities=[ProfilerActivity.CPU]):
        _run_loop(name, log, monkeypatch, driver.ChunksInFlight)
    counts = tracing.counts()
    chunks = len([s for s in tracing.spans() if s.name == tracing.CHUNK])
    assert chunks == log.events // 2
    assert counts.get("chunks_in_flight", 0) == chunks - counts["drains"]
    assert (counts.get("chunks_in_flight", 0) > chunks // 2) == in_flight
