"""The relativistic Sedov blast as a benchmark system.

The program's entry, as users run it: `sedov.setup(argv, device, float32)`
and `sedov.run(cfg, state, tasks=...)`, with fast_step at its default (on
the card: the chunked loop, one B5 call a chunk of 128, 32, 8 or 1 steps).
The task runner does what the program's run_tasks does but write files:
at a checkpoint due the state copied to the host and tested for
finiteness; at a diagnostics due the state tested, the diagnostic fields
copied to the host and tested, and the row the file carries computed; at
a time-series due the row kept. The progress lines count the simulation's
time.

The seed's field (torch_bench/perturb.py), at each cell's log radius
mapped onto [-1, 1] (second coordinate 0), multiplies the initial state's
five components, so density and pressure change together and the gas
stays at rest.

The check compares the state at `check_until` and the row that the
program's own compute_time_series_data gives for it against the float64
reference's state and row (reference/sedov.py).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from torch_bench import compare, perturb, spec
from torch_bench.reference import sedov as ref


class System:
    dtype = torch.float32     # the program's, as the configuration runs it

    def __init__(self, cell, device, argv=()):
        from mara3_tpu_torch.app import driver
        from mara3_tpu_torch.subprograms import sedov
        self.program, self.driver = sedov, driver
        self.config, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.argv = (["sedov"] + self.config["argv"]
                     + self.traffic["argv"] + list(argv))
        self.params = spec.parameters(self.config, self.argv[1:])
        self.check_until = self.traffic["check_until"]
        self.probe = self.traffic["probe"]
        self.rows = []

    # -- the program -------------------------------------------------------

    def tasks(self, state, cfg):
        p, s = self.program, state.solution
        system = p.hydro_system(cfg)
        schedule = state.schedule
        if schedule.is_due("write_checkpoint"):
            p.check_finite(s)
            s.conserved.cpu().numpy()
            schedule = schedule.mark_as_completed("write_checkpoint")
        if schedule.is_due("write_diagnostics"):
            p.check_finite(s)
            fields = [v.detach().cpu().numpy() for v in
                      p.make_diagnostic_fields(s, system).values()]
            self.driver.check_finite("sedov diagnostics", fields,
                                     s.iteration, s.time)
            p.compute_time_series_data(s, system)
            schedule = schedule.mark_as_completed("write_diagnostics")
        if schedule.is_due("write_time_series"):
            self.rows.append(p.compute_time_series_data(s, system))
            schedule = schedule.mark_as_completed("write_time_series")
        return replace(state, schedule=schedule)

    def setup(self, seed: int):
        self.cfg, state = self.program.setup(self.argv, device=self.device,
                                             dtype=self.dtype)
        s = state.solution
        f = perturb.factor(seed, ref.log_positions(self.params, s.vertices),
                           self.traffic["amplitude"], self.device)
        self.state = replace(state, solution=replace(
            s, conserved=s.conserved * f[:, None].to(s.conserved.dtype)))

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
        return self.state.solution.conserved.shape[0]

    def output_every(self) -> float:
        return self.cfg.get_double(self.traffic["output"])

    def outputs(self) -> dict:
        """Host copies of what the check compares: the state, the row the
        program computes from it, and the iteration."""
        s = self.state.solution
        row = self.program.compute_time_series_data(
            s, self.program.hydro_system(self.cfg))
        return {"u": s.conserved.double().cpu().numpy(), "row": row,
                "iteration": int(s.iteration)}

    def free(self):
        self.state = None

    # -- the reference ------------------------------------------------------

    def reference(self, seed: int, steps: int, dtype) -> dict:
        """The plain reference from the seed's initial state for `steps`
        steps in `dtype`: its state (float64 on the host) and its row."""
        run = ref.Sedov(self.params, self.device, dtype)
        f = perturb.factor(seed, ref.log_positions(self.params, run.v),
                           self.traffic["amplitude"], self.device)
        u = run.run(run.initial(f), steps)
        return {"u": u.double().cpu().numpy(),
                "row": run.row(u, steps * run.dt)}

    def gaps(self, outputs: dict, seed: int) -> dict:
        r = self.reference(seed, outputs["iteration"], torch.float64)
        return self.judge(outputs, r)

    def control(self, seed: int, steps: int, dtype=torch.bfloat16) -> dict:
        low = self.reference(seed, steps, dtype)
        return self.judge(dict(low, iteration=steps),
                          self.reference(seed, steps, torch.float64))

    def judge(self, outputs: dict, r: dict) -> dict:
        """state_gap: each cell's largest difference over its largest
        component's magnitude in the reference. series_gap: the rows'
        largest difference, each field over its scale: the time and the
        radii over their own values, the shock velocity over the speed of
        light."""
        u = outputs["u"]
        return {"state_gap": compare.state_gap([(0,)], u[None], [(0,)],
                                               r["u"][None]),
                "series_gap": compare.field_gap(
                    outputs["row"], {k: (v, self.scale(k, v))
                                     for k, v in r["row"].items()})}

    @staticmethod
    def scale(field: str, value: float) -> float:
        return 1.0 if field == "shock_velocity" else abs(value)
