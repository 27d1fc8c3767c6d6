"""What the benchmark runs, found by name.

BENCHMARK.json at the checkout's root lists the cells, configurations and
metrics. Each configuration's file (`file`) and each cell's traffic file
(`workloads/<cell>.json`) hold the rest; each metric is read by
`metrics/<metric>.py`. Adding a cell, a configuration or a metric adds
files and entries and edits none.
"""

from __future__ import annotations

import importlib
import json
import re
from pathlib import Path

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def benchmark() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _entry(items, name, what):
    for item in items:
        if item["name"] == name:
            return item
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


class Cell:
    """One workload of BENCHMARK.json with its configuration, its traffic
    and the metrics it reports."""

    def __init__(self, name: str, bench: dict | None = None):
        bench = bench or benchmark()
        self.entry = _entry(bench["workloads"], name, "workload")
        self.name = name
        self.chips = int(self.entry["chips"])
        cfg_entry = _entry(bench["configs"], self.entry["config"],
                           "configuration")
        self.config = json.loads((ROOT / cfg_entry["file"]).read_text())
        self.traffic = json.loads(
            (HERE / "workloads" / f"{name}.json").read_text())
        self.end_to_end = [m for m in bench["end_to_end"] if self.has(m)]
        self.per_layer = [m for m in bench["per_layer"] if self.has(m)]

    def has(self, metric: dict) -> bool:
        return "workloads" not in metric or self.name in metric["workloads"]

    def metrics(self, trace: bool):
        return self.per_layer if trace else self.end_to_end


def parameters(config: dict, argv) -> dict:
    """The configuration's parameters with the key=value words of argv
    applied, each in the type of the value it replaces."""
    p = dict(config["parameters"])
    for word in argv:
        key, value = word.split("=", 1)
        p[key] = type(p[key])(float(value)) if not isinstance(p[key], str) \
            else value
    return p


def reader(metric: str):
    """The read(record) function of metrics/<metric>.py."""
    return importlib.import_module(f"torch_bench.metrics.{metric}").read


def system(subprogram: str):
    """The System class of systems/<subprogram>.py."""
    return importlib.import_module(f"torch_bench.systems.{subprogram}").System


def problems(bench: dict) -> list:
    """What in BENCHMARK.json breaks the naming rules or names a file or
    cell that is not there."""
    out = []
    metrics = bench["end_to_end"] + bench["per_layer"]
    named = bench["configs"] + bench["workloads"] + metrics
    for item in named:
        if not NAME.match(item["name"]):
            out.append(f"name {item['name']!r}")
    for kind in ("configs", "workloads"):
        names = [c["name"] for c in bench[kind]]
        if len(set(names)) != len(names):
            out.append(f"two {kind} share a name")
    names = [m["name"] for m in metrics]
    if len(set(names)) != len(names):
        out.append("two metrics share a name")
    cells = {w["name"] for w in bench["workloads"]}
    for m in metrics:
        if not UNIT.match(m["unit"]):
            out.append(f"unit {m['unit']!r} of {m['name']}")
        if not set(m.get("workloads", [])) <= cells:
            out.append(f"{m['name']} lists a cell that is not there")
        if not (HERE / "metrics" / f"{m['name']}.py").exists():
            out.append(f"no reader for {m['name']}")
    for c in bench["configs"]:
        if not (ROOT / c["file"]).exists():
            out.append(f"no file {c['file']}")
        for key in c["reduced"]:
            if not NAME.match(key):
                out.append(f"reduced key {key!r}")
    for w in bench["workloads"]:
        if not NAME.match(w["traffic"]) or not NAME.match(w["config"]):
            out.append(f"traffic or config of {w['name']}")
        if not (HERE / "workloads" / f"{w['name']}.json").exists():
            out.append(f"no traffic file for {w['name']}")
    return out
