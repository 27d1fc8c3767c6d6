"""Subprogram registry and CLI dispatch.

Re-design of the reference's app shell (src/app_subprogram.hpp:40-46,
src/app_main.cpp:53-95): each workload registers a named subprogram; the CLI
dispatches on argv[1], times the whole run, and prints the total execution
time. Usage: ``python -m mara3_tpu_torch <subprogram> [key=val ...]``.

With MARA3_PROFILE_DIR set, the run goes under torch.profiler and leaves
``<dir>/<subprogram>.trace.json`` and ``<dir>/<subprogram>.spans.json``
(app/tracing.py).
"""

from __future__ import annotations

import os
import sys
from typing import Callable, Dict

_REGISTRY: Dict[str, Callable] = {}

# the subprograms this package has ported so far
_SUBPROGRAMS = ("amrsand", "binary", "blast3d", "cloud", "kh", "sand3d",
                "sedov")


def register(name: str):
    """Decorator registering fn(argv, *, device=None) -> int as a
    subprogram."""
    def wrap(fn):
        _REGISTRY[name] = fn
        return fn
    return wrap


def registered() -> Dict[str, Callable]:
    _load_all()
    return dict(_REGISTRY)


def _load_all():
    # import for registration side effects (reference app_main.cpp:41-47)
    import importlib
    for name in _SUBPROGRAMS:
        importlib.import_module(f"mara3_tpu_torch.subprograms.{name}")


def main(argv=None) -> int:
    argv = list(sys.argv if argv is None else argv)
    _load_all()

    if len(argv) < 2 or argv[1] not in _REGISTRY:
        print("subprograms are:")
        for name in sorted(_REGISTRY):
            print(f"    {name}")
        return 0

    from mara3_tpu_torch.app import tracing
    from mara3_tpu_torch.app.device import DEVICE_SELECTOR
    from mara3_tpu_torch.app.performance import time_execution
    # the one place the command line's device selector is read: "cpu" asks
    # for the plain PyTorch versions on the CPU; unset, the run needs a GPU
    device = os.environ.get(DEVICE_SELECTOR) or None
    profile_dir = os.environ.get(tracing.PROFILE_DIR)
    if profile_dir:
        result, perf = tracing.profile_to(profile_dir, argv[1],
                                          time_execution,
                                          _REGISTRY[argv[1]], argv[1:],
                                          device=device)
    else:
        result, perf = time_execution(_REGISTRY[argv[1]], argv[1:],
                                      device=device)
    print(f"total execution time: {perf.execution_time_ms / 1e3:.8f}s")
    return int(result or 0)
