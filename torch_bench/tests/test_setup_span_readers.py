"""The readers of the program's set-up spans (setup_program_s and
setup_build_s) on a synthetic store: their arithmetic, that they read only
the spans that end before the window, and None where there is nothing to
read.

    python -m pytest torch_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import sys

import pytest

from mara3_tpu_torch.app import tracing
from torch_bench import record, spec

READERS = ("setup_program_s", "setup_build_s")
MS = 1_000_000
T0 = 1_000 * 10**9          # the window starts 1,000 s into perf_counter


def _store():
    """A set-up of 900 ms: setup() from 0 to 300 ms with a library loaded
    inside it (100-150 ms); B3's tables from 400 to 420 ms with a build
    inside them (405-415 ms), a second library built by itself from 500 to
    700 ms and the tables again at 800-810 ms; the window's chunk with its
    own tables and a build that straddles the window's start, neither
    read."""
    S = tracing.Span
    base = T0 - 900 * MS
    return [
        S("mara3.setup", base, base + 300 * MS, None, None, {}),
        S("mara3.build", base + 100 * MS, base + 150 * MS, 0, None,
          {"kernel": "binary_multi", "built": False}),
        S("mara3.tables", base + 400 * MS, base + 420 * MS, None, None, {}),
        S("mara3.build", base + 405 * MS, base + 415 * MS, 2, None,
          {"kernel": "binary_update", "built": False}),
        S("mara3.build", base + 500 * MS, base + 700 * MS, None, None,
          {"kernel": "iso2d_step", "built": True}),
        S("mara3.chunk", base + 750 * MS, base + 760 * MS, None, 0, {}),
        S("mara3.tables", base + 800 * MS, base + 810 * MS, None, None, {}),
        S("mara3.build", T0 - 1 * MS, T0 + 5 * MS, None, None,
          {"kernel": "sedov_step", "built": True}),
        S("mara3.chunk", T0, T0 + 40 * MS, None, 16, {"iteration": 16}),
        S("mara3.tables", T0 + 1 * MS, T0 + 2 * MS, 8, 16, {}),
    ]


def _window(start_ns=T0, end_ns=T0 + 41 * MS):
    return record.Record(start_ns * 1e-9, end_ns * 1e-9, [], 0, 0.0, 1, 1)


@pytest.fixture
def store(monkeypatch):
    spans = _store()
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    return spans


def test_set_up_readers_arithmetic(store):
    rec = _window()
    # setup() 300 + tables 20 (its build inside) + build 200 + tables 10
    assert spec.reader("setup_program_s")(rec) == pytest.approx(0.530)
    # builds 50 + 10 + 200 ms, one inside setup() and one inside the tables
    assert spec.reader("setup_build_s")(rec) == pytest.approx(0.260)


def test_set_up_readers_read_only_what_ends_before_the_window(store):
    # a window that starts at 600 ms of the set-up: setup() and the first
    # tables, and of the builds the two that end before it
    rec = _window(T0 - 300 * MS)
    assert spec.reader("setup_program_s")(rec) == pytest.approx(0.320)
    assert spec.reader("setup_build_s")(rec) == pytest.approx(0.060)
    # a window before any span ends: nothing to read
    rec = _window(T0 - 850 * MS)
    assert all(spec.reader(name)(rec) is None for name in READERS)


def test_set_up_readers_overlap_counts_once(monkeypatch):
    S = tracing.Span
    spans = [S("mara3.setup", T0 - 100 * MS, T0 - 40 * MS, None, None, {}),
             S("mara3.build", T0 - 60 * MS, T0 - 20 * MS, None, None,
               {"kernel": "b", "built": True})]
    monkeypatch.setattr(tracing, "spans", lambda: list(spans))
    rec = _window()
    assert spec.reader("setup_program_s")(rec) == pytest.approx(0.080)
    assert spec.reader("setup_build_s")(rec) == pytest.approx(0.040)


@pytest.mark.parametrize("name", READERS)
def test_set_up_readers_read_nothing_from_an_empty_store(name):
    tracing.clear()
    assert spec.reader(name)(_window()) is None


@pytest.mark.parametrize("name", READERS)
def test_set_up_readers_read_nothing_without_the_tracer(monkeypatch, name):
    # a program without the tracing module
    monkeypatch.setitem(sys.modules, "mara3_tpu_torch.app.tracing", None)
    monkeypatch.delattr("mara3_tpu_torch.app.tracing", raising=False)
    assert spec.reader(name)(_window()) is None


def test_set_up_readers_are_listed_for_every_cell():
    bench = spec.benchmark()
    assert spec.problems(bench) == []
    for name in READERS:
        entry = next(m for m in bench["per_layer"] if m["name"] == name)
        assert entry["moves"] == "setup_s" and "workloads" not in entry
        assert entry["source"] == "program_span"
