"""The Kelvin-Helmholtz shear layer as a benchmark system.

The program's entry, as users run it: `kh.setup(argv, device, float32)`
and `kh.run(cfg, state, tasks=...)`, with fast_step at its default (on
the card kernel B1, one call a chunk: each chunk ends on the next task
due). The task runner does what the program's run_tasks does but write
files: at a checkpoint due the state copied to the host and tested for
finiteness; at a diagnostics due the state copied to the host in float64
and tested, and the density and the vorticity (the program's `vorticity`)
formed as the file would carry them; at a time-series due the row (the
program's compute_time_series_data) kept. The progress lines count the
simulation's time.

The seed's field (torch_bench/perturb.py), at each cell centre mapped by
x -> 2 x - 1 onto [-1, 1]^2 (so periodic on the box), multiplies the
initial state's three components: the density changes, the velocities
and so the fixed dt stay as they are.

The check compares the state at `check_until` and the row that the
program's own compute_time_series_data gives for it against the float64
reference's state and row (reference/kh.py).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from torch_bench import compare, perturb, spec
from torch_bench.reference import kh as ref


class System:
    dtype = torch.float32     # the program's, as the configuration runs it

    def __init__(self, cell, device, argv=()):
        from mara3_tpu_torch.app import driver
        from mara3_tpu_torch.subprograms import kh
        self.program, self.driver = kh, driver
        self.config, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.argv = (["kh"] + self.config["argv"] + self.traffic["argv"]
                     + list(argv))
        self.params = spec.parameters(self.config, self.argv[1:])
        self.check_until = self.traffic["check_until"]
        self.probe = self.traffic["probe"]
        self.rows = []

    # -- the program -------------------------------------------------------

    def tasks(self, state, cfg):
        p, s = self.program, state.solution
        schedule = state.schedule
        if schedule.is_due("write_checkpoint"):
            schedule = schedule.mark_as_completed("write_checkpoint")
            self.driver.check_finite("kh", [s.conserved], s.iteration,
                                     s.time)
            s.conserved.cpu().numpy()
        if schedule.is_due("write_diagnostics"):
            u = s.conserved.cpu().numpy().astype("float64")
            self.driver.check_finite("kh", [u], s.iteration, s.time)
            p.vorticity(u, 1.0 / u.shape[0])
            schedule = schedule.mark_as_completed("write_diagnostics")
        if schedule.is_due("write_time_series"):
            self.rows.append(p.compute_time_series_data(s, cfg))
            schedule = schedule.mark_as_completed("write_time_series")
        return replace(state, schedule=schedule)

    def setup(self, seed: int):
        self.cfg, state = self.program.setup(self.argv, device=self.device,
                                             dtype=self.dtype)
        s = state.solution
        f = perturb.factor(seed, ref.positions(s.conserved.shape[0],
                                               self.device),
                           self.traffic["amplitude"], self.device)
        self.state = replace(state, solution=replace(
            s, conserved=s.conserved * f[..., None].to(s.conserved.dtype)))

    def advance(self, until: float):
        """Run the program on from its state to time `until`."""
        self.state = self.program.run(self.cfg.set("tfinal", until),
                                      self.state, tasks=self.tasks)

    def now(self) -> float:
        return self.state.solution.time

    def iteration(self) -> int:
        return self.state.solution.iteration

    def blocks(self) -> int:
        return 1

    def zones_per_block(self) -> int:
        u = self.state.solution.conserved
        return u.shape[0] * u.shape[1]

    def output_every(self) -> float:
        return self.cfg.get_double(self.traffic["output"])

    def outputs(self) -> dict:
        """Host copies of what the check compares: the state, the row the
        program computes from it, and the iteration."""
        s = self.state.solution
        return {"u": s.conserved.double().cpu().numpy(),
                "row": self.program.compute_time_series_data(s, self.cfg),
                "iteration": int(s.iteration)}

    def free(self):
        self.state = None

    # -- the reference ------------------------------------------------------

    def reference(self, seed: int, steps: int, dtype) -> dict:
        """The plain reference from the seed's initial state for `steps`
        steps in `dtype`: its state (float64 on the host), its row and the
        gross momentum its row's momenta are measured against."""
        run = ref.KH(self.params, self.device, dtype)
        f = perturb.factor(seed, ref.positions(run.n, self.device),
                           self.traffic["amplitude"], self.device)
        u = run.run(run.initial(f), steps)
        return {"u": u.double().cpu().numpy(),
                "row": run.row(u, steps * run.dt),
                "gross": run.gross_momentum(u)}

    def gaps(self, outputs: dict, seed: int) -> dict:
        r = self.reference(seed, outputs["iteration"], torch.float64)
        return self.judge(outputs, r)

    def control(self, seed: int, steps: int, dtype=torch.bfloat16) -> dict:
        low = self.reference(seed, steps, dtype)
        return self.judge(dict(low, iteration=steps),
                          self.reference(seed, steps, torch.float64))

    @staticmethod
    def judge(outputs: dict, r: dict) -> dict:
        """state_gap: each cell's largest difference over its largest
        component's magnitude in the reference. series_gap: the rows'
        largest difference, each field over its scale: the time, the
        mass, the kinetic energy and the density's extremes over their own
        values (all positive); both momenta over the gross momentum, the
        sum of |sigma vx| + |sigma vy| over the box, since their totals
        cancel (the y-momentum to about 0) and a float32 state's rounding
        of a total is of the size of its terms, not of the total."""
        u = outputs["u"]
        scale = lambda k, v: (r["gross"] if k.startswith("momentum")
                              else abs(v))
        return {"state_gap": compare.state_gap([(0,)], u[None], [(0,)],
                                               r["u"][None]),
                "series_gap": compare.field_gap(
                    outputs["row"], {k: (v, scale(k, v))
                                     for k, v in r["row"].items()})}
