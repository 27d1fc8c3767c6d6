"""The harness on the CPU: every file found by name, the names and units,
the readers' arithmetic on a synthetic window, the work model, and that
nothing here imports JAX or the JAX package.

    python -m pytest torch_bench/tests -q -p no:cacheprovider
"""

from __future__ import annotations

import json
import re
from pathlib import Path

import pytest

from torch_bench import record, spec
from torch_bench.work import model

HERE = Path(spec.__file__).resolve().parent
BENCH = spec.benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_benchmark_json_has_no_problems():
    assert spec.problems(BENCH) == []


def test_benchmark_json_keys_and_limits():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["torch_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    keys = {"configs": {"name", "source", "file", "reduced", "why"},
            "workloads": {"name", "config", "traffic", "chips", "why"},
            "end_to_end": {"name", "unit", "better", "bound", "source"},
            "per_layer": {"name", "unit", "better", "source", "layer",
                          "moves"}}
    for kind, want in keys.items():
        for item in BENCH[kind]:
            assert set(item) - {"workloads"} == want, item["name"]
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        assert m["moves"] in e2e
        assert m["better"] in ("lower", "higher")
    for item in BENCH["configs"] + BENCH["workloads"]:
        assert 1 <= len(item["why"]) <= 200 and "\n" not in item["why"]
    for w in BENCH["workloads"]:
        assert w["chips"] == 1
        assert w["name"] == f"{w['config']}.{w['traffic']}"


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = spec.Cell(name, BENCH)
    assert cell.config["name"] == cell.entry["config"]
    assert set(cell.traffic["limits"]) >= {"state_gap"}
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s",
                                                    "zone_updates_per_s"}
    assert cell.per_layer
    assert spec.system(cell.config["subprogram"]) is not None


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_loads_by_name(name):
    assert callable(spec.reader(name))


def test_names_and_units_use_the_allowed_characters():
    assert spec.NAME.match("binary-d6b96.record")
    assert not spec.NAME.match("has space")
    assert not spec.NAME.match("a,b") and not spec.NAME.match("a/b")
    assert spec.UNIT.match("us/step") and spec.UNIT.match("zone-updates/s")
    assert not spec.UNIT.match("µs") and not spec.UNIT.match("per second")
    assert spec.problems({**BENCH, "end_to_end": BENCH["end_to_end"] + [
        {"name": "bad name", "unit": "µs", "better": "lower",
         "bound": 0.1, "source": "host_clock"}]})


def test_no_file_imports_jax_or_the_jax_package():
    banned = re.compile(r"^\s*(import|from)\s+(jax|mara3_tpu|benchmarks|bench"
                        r"|chip_smoke)\b(?!_torch)", re.M)
    for path in HERE.rglob("*.py"):
        assert not banned.search(path.read_text()), path


def _window(stall_s: float = 0.0):
    """A synthetic window: chunks of 16 steps every 10 ms on 100 blocks of
    4 zones, progress in orbits, an output every 0.01 orbits (every other
    chunk), and a stall of stall_s before every tenth chunk (a write, a
    replay or a regrid that comes back)."""
    lines, wall, it, t = [], 0.0, 0, 0.0
    for k in range(100):
        wall += 0.010 + (stall_s if k % 10 == 5 else 0.0)
        it, t = it + 16, t + 0.005
        lines.append((wall, f"[{it:04d}] orbits={t:3.7f} kzps=1.00"))
    return record.Record(0.0, wall, lines, 0, 0.0, 100, 4, 0.01)


def test_readers_on_a_window_with_and_without_a_stall():
    read = {m: spec.reader(m) for m in METRICS}
    steady, stalled = _window(), _window(stall_s=0.05)
    assert steady.zone_updates() == 1600 * 400
    assert read["zone_updates_per_s"](steady) == pytest.approx(
        1600 * 400 / 1.0)
    assert read["output_interval_ms_p95"](steady) == pytest.approx(20.0)
    assert len(steady.outputs()) == 50
    assert read["zone_updates_per_s"](stalled) == pytest.approx(
        read["zone_updates_per_s"](steady) / 1.5)
    # 10 stalled intervals in 50: the tail's 95th percentile moves by the
    # stall
    assert read["output_interval_ms_p95"](stalled) == pytest.approx(70.0)
    # no trace: the trace's readers read nothing
    for name in ("loop_gap_ms_per_chunk", "main_kernel_us_per_step",
                 "kernels_roofline", "device_idle_pct"):
        assert read[name](steady) is None


def test_trace_readers_on_a_synthetic_trace():
    from torch_bench import trace
    rec = _window()
    rec.config = {"main_kernels": ["b3_sweep"]}
    rec.work = {"ops_per_zone_update": 990.0, "bytes": 1e6,
                "peaks": (67e12, 3.35e12)}
    rec.trace = trace.reduce({
        "device": [("void b3_sweep1_kernel<float>(Args)", 0.0, 0.4),
                   ("b3_sweep2_kernel", 0.4, 0.6), ("memcpy", 0.7, 0.75)],
        "host": [("aten::copy_", 0.6, 0.7)]})
    read = {m: spec.reader(m) for m in METRICS}
    assert rec.trace["busy_s"] == pytest.approx(0.65)
    assert read["device_idle_pct"](rec) == pytest.approx(35.0)
    assert read["loop_gap_ms_per_chunk"](rec) == pytest.approx(3.5)
    assert read["main_kernel_us_per_step"](rec) == pytest.approx(
        0.6 / 1600 * 1e6)
    expect = 100 * 990.0 * 1600 * 400 / 67e12 / 0.65
    assert read["kernels_roofline"](rec) == pytest.approx(expect)
    assert rec.trace["idle_gaps"][0][0] == "aten::copy_"


def test_regrid_lines_count_their_zones():
    lines = [(0.1, "[0256] t=0.0312500 kzps=1.0 [cuda_b6[256]]"),
             (0.2, "regrid: 10 blocks, depth 8, changed, 12.500 ms on the "
                   "host"),
             (0.3, "[0512] t=0.0625000 kzps=1.0 [cuda_b6[256]]")]
    rec = record.Record(0.0, 1.0, lines, 0, 0.0, 20, 4)
    assert rec.zone_updates() == 256 * 80 + 256 * 40


@pytest.mark.parametrize("name", sorted({w["config"]
                                         for w in BENCH["workloads"]}))
def test_work_model_depends_only_on_the_configuration(name):
    cell = next(spec.Cell(w["name"], BENCH) for w in BENCH["workloads"]
                if w["config"] == name)
    config = cell.config
    ops = model.ops_per_zone_update(config)
    for words in (["multi_launch=4"], ["multi_launch=16"], ["fast_step=0"],
                  ["fast_step=1"]):
        if words[0].split("=")[0] not in config["parameters"]:
            continue
        other = dict(config, parameters=spec.parameters(config, words))
        assert model.ops_per_zone_update(other) == ops
    assert model.bytes_per_cell(config) > 0
    work = model.work_of(config, "NVIDIA H100 80GB HBM3", 1000)
    assert model.least_seconds(work, 10 ** 9) == pytest.approx(
        ops * 10 ** 9 / 67e12)
    assert model.work_of(config, "cpu", 1000)["peaks"] is None


def test_binary_work_counts_the_scheme_options():
    config = spec.Cell("binary-d6b96.record", BENCH).config
    rk1 = dict(config, parameters=spec.parameters(config, ["rk_order=1"]))
    pcm = dict(config, parameters=spec.parameters(
        config, ["reconstruct_method=pcm"]))
    ops = model.ops_per_zone_update(config)
    assert ops == 990
    assert model.ops_per_zone_update(rk1) < ops
    assert model.ops_per_zone_update(pcm) == ops - 2 * 108


def test_traffic_files_name_known_parameters():
    for name in CELLS:
        cell = spec.Cell(name, BENCH)
        spec.parameters(cell.config, cell.traffic["argv"])
        assert cell.traffic["output"] in cell.config["parameters"]
        json.dumps(cell.traffic)
