"""The readers of the program's spans and counters (loop_host_ms_per_chunk,
output_ms_mean, replay_steps_pct) on a synthetic store: their arithmetic,
the window they keep to, and None where there is nothing to read.

    python -m pytest torch_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import sys

import pytest

from mara3_tpu_torch.app import tracing
from torch_bench import record, spec

READERS = ("loop_host_ms_per_chunk", "output_ms_mean", "replay_steps_pct")
MS = 1_000_000
T0 = 1_000 * 10**9          # the window starts 1,000 s into perf_counter


def _store():
    """Four chunks of 10, 12, 8 and 11 ms, each waiting 6 ms for the
    device: 4, 6, 2 and 5 ms of host work, 4.25 ms a chunk. Three outputs of
    2, 3 and 4 ms, the first with a replay inside. A chunk before the
    window (set-up) that the readers leave out."""
    S = tracing.Span
    out = [S("mara3.chunk", T0 - 50 * MS, T0 - 10 * MS, None, 0, {})]
    t, it = T0, 16
    for k, (length, output) in enumerate(((10, 2), (12, 3), (8, 0),
                                          (11, 4))):
        c = len(out)
        out.append(S("mara3.chunk", t, t + length * MS, None, it,
                     {"iteration": it, "steps": 16}))
        out.append(S("mara3.launch", t, t + 1 * MS, c, it, {}))
        out.append(S("mara3.wait", t + 1 * MS, t + 7 * MS, c, it, {}))
        if output:
            o = len(out)
            out.append(S("mara3.output", t + 7 * MS, t + (7 + output) * MS,
                         c, it, {"task": "record_time_series"}))
            if k == 0:
                out.append(S("mara3.replay", t + 7 * MS, t + 8 * MS, o, it,
                             {}))
        t, it = t + length * MS, it + 16
    return out


def _window(start_ns=T0, end_ns=T0 + 41 * MS):
    """A window a microsecond wider on each side than its stamps, as the
    harness's is around the loop's spans."""
    return record.Record((start_ns - 1000) * 1e-9, (end_ns + 1000) * 1e-9,
                         [], 0, 0.0, 1, 1)


@pytest.fixture
def store(monkeypatch):
    spans = _store()
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    monkeypatch.setattr(tracing, "counts",
                        lambda: {"steps": 64, "replay_steps": 8,
                                 "outputs.record_time_series": 3})
    return spans


def test_readers_arithmetic(store):
    read = {name: spec.reader(name) for name in READERS}
    rec = _window()
    assert read["loop_host_ms_per_chunk"](rec) == pytest.approx(4.25)
    assert read["output_ms_mean"](rec) == pytest.approx(3.0)
    assert read["replay_steps_pct"](rec) == pytest.approx(12.5)


def test_readers_keep_to_the_window(store):
    # a window that ends before the last chunk does holds three: 4, 6, 2
    rec = _window(end_ns=T0 + 35 * MS)
    assert spec.reader("loop_host_ms_per_chunk")(rec) == pytest.approx(4.0)
    assert spec.reader("output_ms_mean")(rec) == pytest.approx(2.5)
    # a window that holds no chunk: nothing to read
    rec = _window(T0 - 9 * MS, T0 - 1 * MS)
    assert all(spec.reader(name)(rec) is None for name in READERS)


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_from_an_empty_store(name):
    tracing.clear()
    assert spec.reader(name)(_window()) is None


@pytest.mark.parametrize("name", READERS)
def test_readers_read_nothing_without_the_tracer(monkeypatch, name):
    # the parent commit's program has no tracing module
    monkeypatch.setitem(sys.modules, "mara3_tpu_torch.app.tracing", None)
    monkeypatch.delattr("mara3_tpu_torch.app.tracing", raising=False)
    assert spec.reader(name)(_window()) is None
