"""The port's benchmark: one run of one cell on the card.

    python3 torch_bench/run.py --workload <cell> --seed <n> --seconds <s>
                               --trace <0|1>

Prints, as its last line of standard output, one JSON object: `correct`,
`attempted` (the window's steps), `failed` (its steps retried in safe
mode), `metrics` (the cell's end-to-end metrics, or with --trace 1 its
per-layer metrics), `device`, with --trace 1 `breakdown`, and last
`checks` (each compared number beside its limit, also the last lines of
standard error). Exits non-zero, printing no result, without a CUDA card,
or when the process holds JAX or the JAX package once the window has
closed (named on standard error).
"""

from __future__ import annotations

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the top-level names the port's process may not hold: JAX, and the JAX
# package it was ported from (whose name the port's begins with)
BANNED = ("jax", "jaxlib", "flax", "mara3_tpu")


def jax_loaded() -> list:
    """The modules in sys.modules whose top-level name is a banned one."""
    return sorted(name for name in sys.modules
                  if name.split(".")[0] in BANNED)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # one process, few threads: the host work of the driver loop is serial
    os.environ.setdefault("OMP_NUM_THREADS", "1")
    sys.path.insert(0, str(ROOT))
    import torch
    torch.set_num_threads(1)
    from torch_bench import harness, spec

    cell = spec.Cell(args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"{args.workload} needs {cell.chips} CUDA card(s); "
              f"found {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    import mara3_tpu_torch  # noqa: F401  (no program: no result)
    try:
        result = harness.run_cell(cell, args.seed, args.seconds,
                                  bool(args.trace), "cuda:0", STARTED)
    except Exception:  # a run that fails is reported as not correct
        traceback.print_exc()
        print("check run 'failed' limit 'completes'", file=sys.stderr)
        device = dict(harness.card("cuda:0"), memory_peak_bytes=int(
            torch.cuda.max_memory_allocated(0)))
        result = {"correct": False, "attempted": 0, "failed": 1,
                  "metrics": {}, "device": device,
                  "checks": {"run": {"value": "failed",
                                     "limit": "completes"}}}
    found = jax_loaded()
    if found:
        print(f"the run loaded JAX or the JAX package: {', '.join(found)}",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
