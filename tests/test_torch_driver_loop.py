"""The fixed-dt driver loops' shared pieces, on the CPU: the chunk plan
(app/driver.steps_to_next_stop), the -1 "auto" flag (app/device.
resolve_auto), the progress line and the end of a chunk (app/driver.
end_chunk), the traced task call (app/driver.traced_outputs) and one
chunk's timed call (app/performance.timed_launch).
"""

from __future__ import annotations

import contextlib
import io
import re

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mara3_tpu_torch.app import driver, tracing
from mara3_tpu_torch.app.config import ConfigTemplate
from mara3_tpu_torch.app.device import resolve_auto
from mara3_tpu_torch.app.performance import timed_launch
from mara3_tpu_torch.app.schedule import Schedule
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


def _line(*args) -> str:
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        driver.end_chunk(tracing.recorder(), *args)
    return out.getvalue()


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
            with driver.traced_outputs(rec, _schedule(*due)) as got:
                assert got == list(due)
            driver.end_chunk(rec, 3, 3, 0.3, 10, 1.0, "scheme[3]")
    spans = tracing.spans()
    outputs = [s for s in spans if s.name == "mara3.output"]
    assert [s.attrs["task"] for s in outputs] == (["+".join(due)] if due
                                                  else [])
    assert all(s.parent == 0 for s in spans[1:])
    assert spans[0].attrs == {"iteration": 0, "steps": 3}
    assert tracing.counts() == {"steps": 3,
                                **{f"outputs.{name}": 1 for name in due}}


def test_timed_launch_on_the_cpu(monkeypatch):
    def no_sync(*args, **kwargs):
        raise AssertionError("synchronized on the CPU")

    monkeypatch.setattr(torch.cuda, "synchronize", no_sync)
    with profile(activities=[ProfilerActivity.CPU]):
        rec = tracing.recorder()
        with rec.span(tracing.CHUNK, iteration=0):
            with timed_launch(rec, torch.device("cpu")) as launch:
                torch.ones(8).sum()
    chunk, *children = tracing.spans()
    assert [s.name for s in children] == ["mara3.launch", "mara3.wait"]
    assert all(s.parent == 0 for s in children)
    first, then = children
    assert first.end_ns <= then.start_ns
    # the clock is read before the launch opens and after the wait closes
    assert launch.ms * 1e6 >= then.end_ns - first.start_ns - 1000


def test_timed_launch_untraced_records_nothing():
    with timed_launch(tracing.recorder(), torch.device("cpu")) as launch:
        pass
    assert launch.ms >= 0 and tracing.spans() == []
