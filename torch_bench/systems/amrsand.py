"""The AMR sandbox as a benchmark system.

The program's entry, as users run it: `amrsand.setup(argv, device,
float32)` and `amrsand.run(cfg, state, tasks=...)`, with fast_step at its
default (on the card: the chunked loop, one B6 call a chunk). The task
runner does what the program's run_tasks does but write the file: at a
diagnostics due, the state copied to the host and tested for finiteness.
While the first steps run, the runner also keeps the leaf set it sees at
each chunk, so that the check can hold every regrid's tree to the
reference's. The
progress lines count the simulation's time.

The seed's field (torch_bench/perturb.py) multiplies the initial blob.
"""

from __future__ import annotations

from dataclasses import replace

import numpy as np
import torch

from torch_bench import compare, perturb, spec
from torch_bench.reference import amrsand as ref
from torch_bench.reference import mesh


class System:
    def __init__(self, cell, device, argv=()):
        from mara3_tpu_torch.app import driver
        from mara3_tpu_torch.subprograms import amrsand
        self.program, self.driver = amrsand, driver
        self.config, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.argv = (["amrsand"] + self.config["argv"]
                     + self.traffic["argv"] + list(argv))
        self.params = spec.parameters(self.config, self.argv[1:])
        self.check_until = self.traffic["check_until"]
        self.probe = self.traffic["probe"]
        self.trees = None

    # -- the program -------------------------------------------------------

    def tasks(self, state, cfg):
        s = state.solution
        if self.trees is not None:
            self.trees.append((s.iteration, s.leaves))
        if state.schedule.is_due("write_diagnostics"):
            u = s.conserved[..., 0].detach().cpu().numpy()
            self.driver.check_finite("amrsand", [u], s.iteration, s.time)
            state = replace(state, schedule=state.schedule.mark_as_completed(
                "write_diagnostics"))
        return state

    def setup(self, seed: int):
        self.cfg, state = self.program.setup(self.argv, device=self.device,
                                             dtype=torch.float32)
        s = state.solution
        f = perturb.factor(seed, mesh.cell_centres(s.leaves,
                                                   s.conserved.shape[1]),
                           self.traffic["amplitude"], self.device)
        self.state = replace(state, solution=replace(
            s, conserved=s.conserved * f[..., None].to(s.conserved.dtype)))
        self.trees = []

    def advance(self, until: float):
        """Run the program on from its state to time `until`."""
        self.state = self.program.run(self.cfg.set("tfinal", until),
                                      self.state, tasks=self.tasks)

    def now(self) -> float:
        return self.state.solution.time

    def iteration(self) -> int:
        return self.state.solution.iteration

    def blocks(self) -> int:
        return len(self.state.solution.leaves)

    def zones_per_block(self) -> int:
        return self.cfg.get_int("block_size") ** 2

    def output_every(self) -> float:
        return self.cfg.get_double(self.traffic["output"])

    def outputs(self) -> dict:
        """Host copies of what the check compares: the final state and its
        leaves, the leaf set at each chunk, and the iteration. The runner
        stops keeping leaf sets."""
        s = self.state.solution
        trees, self.trees = self.trees, None
        return {"u": s.conserved.double().cpu().numpy(),
                "leaves": [tuple(leaf) for leaf in s.leaves],
                "trees": [(it, tuple(lv)) for it, lv in trees],
                "iteration": int(s.iteration)}

    def free(self):
        self.state = None

    # -- the reference ------------------------------------------------------

    def reference(self, seed: int, steps: int, dtype,
                  program_trees=None) -> dict:
        p = self.params
        bs = int(p["block_size"])
        leaves = ref.initial_leaves(p)
        f = perturb.factor(seed, mesh.cell_centres(leaves, bs),
                           self.traffic["amplitude"], self.device)
        u = torch.as_tensor(ref.gaussian(leaves, bs), device=self.device)
        u = (u * f[..., None]).to(dtype)
        leaves, u, trees, margins, mismatches, tied = ref.Sandbox(
            p, self.device, dtype).run(leaves, u, steps, program_trees)
        return {"u": u.double().cpu().numpy(), "leaves": leaves,
                "trees": trees, "margins": margins,
                "mismatches": mismatches, "tied": tied}

    def gaps(self, outputs: dict, seed: int) -> dict:
        r = self.reference(seed, outputs["iteration"], torch.float64,
                           outputs["trees"])
        self.margins = r["margins"]
        return self.judge(outputs, r)

    def control(self, seed: int, steps: int, dtype=torch.bfloat16) -> dict:
        low = self.reference(seed, steps, dtype)
        return self.judge(
            dict(low, iteration=steps),
            self.reference(seed, steps, torch.float64, low["trees"]))

    @staticmethod
    def judge(outputs: dict, r: dict) -> dict:
        """state_gap over each cell's magnitude or the median cell's,
        whichever is larger, the program's state carried onto the
        reference's leaves where its own differ (a coarser leaf's cells
        repeated, finer ones averaged); tree_mismatch counts the regrids
        whose leaf set differs from the program's beyond a tie at a
        threshold."""
        u = outputs["u"]
        if set(outputs["leaves"]) != set(r["leaves"]):
            u = mesh.carry(outputs["leaves"], torch.as_tensor(u),
                           r["leaves"]).numpy()
        return {
            "state_gap": compare.state_gap(
                r["leaves"], u, r["leaves"], r["u"],
                floor=float(np.median(np.abs(r["u"])))),
            "tree_mismatch": float(r["mismatches"])}
