"""The readings that a cell's limits are set from, on the card.

    python3 torch_bench/calibrate.py --workload <cell> --seeds S [S ...]
        [--control-seeds S [S ...]] [--out FILE]

For each of --seeds, the program's set-up and checked first steps exactly
as a run makes them, then the compared numbers against the float64
reference (the lower readings). For each of --control-seeds, the control:
the reference computed in bfloat16 put in the program's place, over the
same steps, against the float64 reference (the upper readings). One
process for all seeds; prints one JSON line per seed and writes them all
to --out.
"""

from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    ap.add_argument("--device", default="cuda:0")
    ap.add_argument("--argv", nargs="*", default=[],
                    help="key=value words added to the program's command line")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from torch_bench import harness, spec

    cell = spec.Cell(args.workload)
    lines = []
    for seed in args.seeds + args.control_seeds:
        control = seed in args.control_seeds
        t0 = time.perf_counter()
        system, outputs = harness.checked_start(cell, seed, args.device,
                                                args.argv)
        system.free()
        t1 = time.perf_counter()
        if control:
            gaps = system.control(seed, outputs["iteration"])
        else:
            gaps = system.gaps(outputs, seed)
        line = {"seed": seed, "kind": "control" if control else "program",
                "steps": outputs["iteration"], "gaps": gaps,
                "program_s": t1 - t0,
                "reference_s": time.perf_counter() - t1}
        if hasattr(system, "margins"):
            line["regrid_margins"] = system.margins
        lines.append(line)
        print(json.dumps(line), flush=True)
        if torch.cuda.is_available():
            torch.cuda.empty_cache()
    if args.out:
        Path(args.out).write_text("".join(json.dumps(x) + "\n"
                                          for x in lines))
    return 0


if __name__ == "__main__":
    sys.exit(main())
