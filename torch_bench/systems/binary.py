"""The flagship circumbinary disk as a benchmark system.

The program's entry, as users run it: `binary.setup(argv, device, float32)`
and `binary.run(cfg, sd, state, tasks=...)`, with fast_step and
multi_launch at their defaults (on the card: the device-resident loop, B3
at 16 steps a launch). The task runner does what the program's run_tasks
does but write files: at a diagnostics due the finiteness test and the
diagnostic fields copied to the host, at a time-series due the row, at a
checkpoint due the finiteness test, the state copied to the host and the
rows stacked. The progress lines count orbits.

The seed's field (torch_bench/perturb.py) multiplies the initial state's
three components, so the disk's density changes and its velocities do not.
"""

from __future__ import annotations

import math
from dataclasses import replace

import numpy as np
import torch

from torch_bench import compare, perturb, spec
from torch_bench.reference import binary as ref
from torch_bench.reference import mesh


class System:
    def __init__(self, cell, device, argv=()):
        from mara3_tpu_torch.subprograms import binary
        self.program = binary
        self.config, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.argv = (["binary"] + self.config["argv"]
                     + self.traffic["argv"] + list(argv))
        self.params = spec.parameters(self.config, self.argv[1:])
        self.check_until = self.traffic["check_until"]
        self.probe = self.traffic["probe"]

    # -- the program -------------------------------------------------------

    def tasks(self, state, sd):
        b = self.program
        if state.schedule.is_due("write_diagnostics"):
            b.check_finite(state.solution)
            b.diagnostic_fields(state.solution, sd)
            state = replace(state, schedule=state.schedule.mark_as_completed(
                "write_diagnostics"))
        if state.schedule.is_due("record_time_series"):
            state = b.record_time_series(state, sd)
        if state.schedule.is_due("write_checkpoint"):
            b.check_finite(state.solution)
            state.solution.conserved.cpu().numpy()
            if state.time_series:
                np.stack(state.time_series)
            state = replace(state, schedule=state.schedule.mark_as_completed(
                "write_checkpoint"))
        return state

    def setup(self, seed: int):
        self.cfg, self.sd, state = self.program.setup(
            self.argv, device=self.device, dtype=torch.float32)
        bs = self.cfg.get_int("block_size")
        f = perturb.factor(seed, mesh.cell_centres(self.sd.leaves, bs),
                           self.traffic["amplitude"], self.device)
        u = state.solution.conserved
        self.state = replace(state, solution=replace(
            state.solution, conserved=(u * f[..., None].to(u.dtype))))

    def advance(self, until: float):
        """Run the program on from its state to `until` orbits."""
        self.state = self.program.run(self.cfg.set("tfinal", until), self.sd,
                                      self.state, tasks=self.tasks)
        self.sd = self.state.solver_data

    def now(self) -> float:
        return self.state.solution.time / (2 * math.pi)

    def iteration(self) -> int:
        return self.state.solution.iteration

    def blocks(self) -> int:
        return len(self.sd.leaves)

    def zones_per_block(self) -> int:
        return self.cfg.get_int("block_size") ** 2

    def output_every(self) -> float:
        return self.cfg.get_double(self.traffic["output"])

    def outputs(self) -> dict:
        """Host copies of what the check compares: the rows, the final
        state's scalars and conserved values, its leaves and iteration."""
        s = self.state.solution
        return {"rows": [compare.flatten(r) for r in self.state.time_series],
                "scalars": compare.flatten(
                    {k: getattr(s, k) for k in ("time",) + ref.PAIRS
                     + ref.EJECTED + ref.ELEMENT_SETS}),
                "u": s.conserved.double().cpu().numpy(),
                "leaves": [tuple(leaf) for leaf in self.sd.leaves],
                "iteration": int(s.iteration)}

    def free(self):
        self.state = self.sd = None

    # -- the reference ------------------------------------------------------

    def reference(self, seed: int, steps: int, dtype) -> dict:
        """The plain reference from the seed's initial state for `steps`
        steps, in `dtype`: its rows ({field: (value, scale)}), the final
        state's scalars, conserved values and leaves."""
        p = self.params
        run = ref.Binary(p, self.device, dtype)
        bs = int(p["block_size"])
        f = perturb.factor(seed, mesh.cell_centres(run.disk.leaves, bs),
                           self.traffic["amplitude"], self.device)
        s = run.initial(run.disk.u_init * f[..., None].to(dtype))
        tsi = float(p["tsi"]) * 2 * math.pi
        rows, last = [run.row(s)], 0.0
        for _ in range(steps):
            s = run.step(s)
            if s.time - last >= tsi:
                last += tsi
                rows.append(run.row(s))
        return {"rows": rows, "scalars": run.scalars(s),
                "u": s.u.double().cpu().numpy(), "leaves": run.disk.leaves}

    def gaps(self, outputs: dict, seed: int) -> dict:
        """The compared numbers of the program's outputs against the
        float64 reference."""
        r = self.reference(seed, outputs["iteration"], torch.float64)
        return self.judge(outputs, r)

    def control(self, seed: int, steps: int, dtype=torch.bfloat16) -> dict:
        """The compared numbers of the reference computed in `dtype` put in
        the program's place."""
        low = self.reference(seed, steps, dtype)
        outputs = {"rows": [{k: v for k, (v, _) in row.items()}
                            for row in low["rows"]],
                   "scalars": {k: v for k, (v, _) in low["scalars"].items()},
                   "u": low["u"], "leaves": low["leaves"],
                   "iteration": steps}
        return self.judge(outputs, self.reference(seed, steps, torch.float64))

    @staticmethod
    def judge(outputs: dict, r: dict) -> dict:
        return {
            "state_gap": compare.state_gap(outputs["leaves"], outputs["u"],
                                           r["leaves"], r["u"]),
            "series_gap": max(
                compare.series_gap(outputs["rows"], r["rows"]),
                compare.field_gap(outputs["scalars"], r["scalars"]))}
