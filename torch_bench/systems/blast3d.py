"""The 3D blast on the octree as a benchmark system.

The program's entry, as users run it: `blast3d.setup(argv, device,
float32)` and `blast3d.run(cfg, state, tasks=...)`: each output window one
call of the octree step (mesh/euler3d.py, torch operations on the card) at
the dt read from the card at the window's start. The task runner does what
the program's write_diagnostics does but write the file: the state tested
for finiteness, the primitives recovered on the card, the density and the
pressure copied to the host, the task marked. The progress lines count
the simulation's time.

The seed's field is torch_bench/perturb.py's at each cell centre's (x, y)
times the same seed's at its (y, z), both periodic on the [-1, 1]^3 box;
it multiplies all five conserved components, so the gas stays at rest and
its sound speed, and so the first window's dt, are unchanged.

The check compares the state at `check_until` and its five totals
(`euler3d.total_conserved` of the state's float64 copy) against the
float64 reference's (reference/blast3d.py).
"""

from __future__ import annotations

from dataclasses import replace

import torch

from torch_bench import compare, perturb, spec
from torch_bench.reference import blast3d as ref
from torch_bench.reference import octree

MOMENTA = ("momentum_x", "momentum_y", "momentum_z")
TOTALS = ("mass",) + MOMENTA + ("energy",)


def seed_field(seed: int, centres, amplitude: float, device):
    """[...] float64: the seed's field at (x, y) times its field at (y, z)
    of the cell centres [..., 3]."""
    return (perturb.factor(seed, centres[..., [0, 1]], amplitude, device)
            * perturb.factor(seed, centres[..., [1, 2]], amplitude, device))


class System:
    dtype = torch.float32     # the program's, as the configuration runs it

    def __init__(self, cell, device, argv=()):
        from mara3_tpu_torch.app import driver
        from mara3_tpu_torch.mesh import euler3d
        from mara3_tpu_torch.physics import euler
        from mara3_tpu_torch.subprograms import blast3d
        self.program, self.driver = blast3d, driver
        self.euler3d, self.euler = euler3d, euler
        self.config, self.traffic = cell.config, cell.traffic
        self.device = torch.device(device)
        self.argv = (["blast3d"] + self.config["argv"]
                     + self.traffic["argv"] + list(argv))
        self.params = spec.parameters(self.config, self.argv[1:])
        self.check_until = self.traffic["check_until"]
        self.probe = self.traffic["probe"]

    # -- the program -------------------------------------------------------

    def tasks(self, state, cfg):
        if state.schedule.is_due("write_diagnostics"):
            s = state.solution
            self.driver.check_finite("blast3d", [s.conserved], s.iteration,
                                     s.time)
            P = self.euler.recover_primitive(s.conserved,
                                             self.program.GAMMA)
            P[..., 0].cpu().numpy()
            P[..., 4].cpu().numpy()
            state = replace(state, schedule=state.schedule.mark_as_completed(
                "write_diagnostics"))
        return state

    def setup(self, seed: int):
        self.cfg, state = self.program.setup(self.argv, device=self.device,
                                             dtype=self.dtype)
        s = state.solution
        f = seed_field(seed, octree.cell_centres(state.mesh.leaves,
                                                 s.conserved.shape[1],
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
        return len(self.state.mesh.leaves)

    def zones_per_block(self) -> int:
        return self.cfg.get_int("block_size") ** 3

    def output_every(self) -> float:
        return self.cfg.get_double(self.traffic["output"])

    def outputs(self) -> dict:
        """Host copies of what the check compares: the state in float64 and
        its leaves, its five totals, and the iteration."""
        s, mesh = self.state.solution, self.state.mesh
        u = s.conserved.double().cpu()
        totals = self.euler3d.total_conserved(mesh, u.shape[1], u).tolist()
        return {"u": u.numpy(), "leaves": list(mesh.leaves),
                "totals": dict(zip(TOTALS, totals)),
                "iteration": int(s.iteration)}

    def free(self):
        self.state = None

    # -- the reference ------------------------------------------------------

    def reference(self, seed: int, dtype) -> dict:
        """The plain reference from the seed's initial state to
        `check_until` in `dtype`: its state (float64 on the host) and
        leaves, its totals and the gross momentum its momenta are measured
        against."""
        run = ref.Blast(self.params, self.device, dtype)
        f = seed_field(seed, run.centres(), self.traffic["amplitude"],
                       self.device)
        u, _, _, _ = run.run(run.initial(f), self.check_until)
        return {"u": u.double().cpu().numpy(), "leaves": run.leaves,
                "totals": dict(zip(TOTALS, run.totals(u))),
                "gross": run.gross_momentum(u)}

    def gaps(self, outputs: dict, seed: int) -> dict:
        return self.judge(outputs, self.reference(seed, torch.float64))

    def control(self, seed: int, steps: int = None,
                dtype=torch.bfloat16) -> dict:
        """The reference in `dtype` against the float64 one; both run to
        `check_until` at their own dt (`steps`, the program's, is not
        needed)."""
        return self.judge(self.reference(seed, dtype),
                          self.reference(seed, torch.float64))

    @staticmethod
    def judge(outputs: dict, r: dict) -> dict:
        """state_gap: each cell's largest difference over its largest
        component's magnitude in the reference, matched by leaf.
        totals_gap: the largest difference of the five totals, the mass and
        the energy over their own values, the three momenta over the gross
        momentum (sum |rho v| times the cells' volumes), since their totals
        cancel to round-off and a float32 state's rounding of a total is
        of the size of its terms, not of the total."""
        scale = lambda k, v: r["gross"] if k in MOMENTA else abs(v)
        return {"state_gap": compare.state_gap(outputs["leaves"],
                                               outputs["u"], r["leaves"],
                                               r["u"]),
                "totals_gap": compare.field_gap(
                    outputs["totals"], {k: (v, scale(k, v))
                                        for k, v in r["totals"].items()})}
