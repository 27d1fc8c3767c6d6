#!/usr/bin/env python3
"""Count the SRHD Newton updates a cell and step that the sedov-524288
configuration's window needs, for torch_bench/work/sedov.json.

The program (sedov.setup and sedov.run, as the benchmark cell runs it,
float32, on the card) advances the seed's blast to each of --times; at
each, its state, in float64, is handed to the plain reference
(torch_bench/reference/sedov.py) with warm=True, which runs --steps steps,
each step's Newton from the pressure its previous step converged to. The
first step starts from 0 and is not counted. Prints one JSON line a time
and the mean over the times, the count the work file states. The default
times are the midpoints of the thirds of the cell's 45 s window on an
H100, which runs from t = 0.006 to about 2.7.

    python3 tools/torch_sedov_newton_count.py [--times 0.45 1.35 2.25]
        [--steps 64] [--seed N] [--argv key=value ...]
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", default="sedov-524288.srhd")
    ap.add_argument("--times", type=float, nargs="+",
                    default=[0.45, 1.35, 2.25])
    ap.add_argument("--steps", type=int, default=64)
    ap.add_argument("--seed", type=int, default=3_000_000_019)
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--argv", nargs="*", default=[],
                    help="key=value words added to the program's command line")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch_bench import spec
    from torch_bench.reference import sedov as ref

    cell = spec.Cell(args.workload)
    make = spec.system(cell.config["subprogram"])
    system = make(cell, args.device, args.argv)
    with contextlib.redirect_stdout(io.StringIO()):
        system.setup(args.seed)
    counts = []
    for t in args.times:
        with contextlib.redirect_stdout(io.StringIO()):
            system.advance(t)
        u = system.state.solution.conserved.double()
        run = ref.Sedov(system.params, args.device, torch.float64, warm=True)
        u = run.step(u)
        run.updates = run.cell_steps = 0
        u = run.run(u, args.steps)
        counts.append(run.updates / run.cell_steps)
        print(json.dumps({"time": system.now(),
                          "iteration": system.iteration(),
                          "steps": args.steps,
                          "updates_per_cell_step": counts[-1]}), flush=True)
    print(json.dumps({"device": torch.cuda.get_device_name(args.device)
                      if torch.device(args.device).type == "cuda" else "cpu",
                      "mean_updates_per_cell_step":
                          sum(counts) / len(counts)}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
