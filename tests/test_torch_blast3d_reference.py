"""The benchmark's plain octree Euler reference (torch_bench/reference/
blast3d.py and octree.py) against the port's blast3d, on the CPU in
float64: its tree against blast3d.build_mesh's, its first window's dt and
steps and its state after two windows against blast3d.run's, its step
against euler3d.make_advance on a moving state, its totals across the
level jumps; and that it imports nothing of the port or of JAX. The test
marked `cuda` holds it to the port's step on the card at the cell's own
size (this file imports no JAX, so it runs there:
python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_blast3d_reference.py).

The bar: the reference writes the same formulas in another rounding order
(the 2 x 2 means at level jumps as torch's mean where the port sums four
cells in a fixed order, dt and dx applied apart, the normal velocity as
the axis's component where the port forms n . v), so after a few dozen
steps each cell differs by round-off, about 1e-15 of its largest
component; 1e-12 leaves room for the steps' growth, while a scheme that
differs (a level jump left uncorrected, another dt) differs by 1e-6 or
more."""

import contextlib
import io
import os
import subprocess
import sys
from collections import Counter
from dataclasses import replace

import numpy as np
import pytest
import torch

from mara3_tpu_torch.mesh import euler3d as TE
from mara3_tpu_torch.subprograms import blast3d as TB
from torch_bench.reference import blast3d as ref
from torch_bench.reference import octree
from torch_bench.systems.blast3d import seed_field

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
BAR = 1e-12
DFI = 0.005       # windows of about 7 steps at depth 3, block 8


def params(depth=3, block_size=8, dfi=DFI):
    return dict(depth=depth, block_size=block_size, dfi=dfi, cfl=0.3,
                gamma_law_index=TB.GAMMA)


def cell_gap(u, r):
    """Largest |u - r| of a cell over its largest component in r."""
    d = (u - r).abs().amax(dim=-1)
    return float((d / r.abs().amax(dim=-1)).max())


def program_run(argv, seed, until, device="cpu"):
    """blast3d.setup and blast3d.run in float64 from the seeded blast to
    `until`, with a task runner that only marks the diagnostics: (the
    final state, the (dt, steps) of each advance call)."""
    cfg, state = TB.setup(["blast3d"] + argv, device=device, dtype=F64)
    s = state.solution
    f = seed_field(seed, octree.cell_centres(state.mesh.leaves,
                                             s.conserved.shape[1], device),
                   0.05, device)
    state = replace(state, solution=replace(
        s, conserved=s.conserved * f[..., None]))
    windows, make = [], TE.make_advance

    def make_advance(*args, **kwargs):
        advance = make(*args, **kwargs)

        def recorded(U, dt, n):
            windows.append((dt, n))
            return advance(U, dt, n)
        return recorded

    def tasks(st, c):
        if st.schedule.is_due("write_diagnostics"):
            st = replace(st, schedule=st.schedule.mark_as_completed(
                "write_diagnostics"))
        return st

    TE.make_advance, saved = make_advance, TE.make_advance
    try:
        with contextlib.redirect_stdout(io.StringIO()):
            final = TB.run(cfg.set("tfinal", until), state, tasks=tasks)
    finally:
        TE.make_advance = saved
    return final, windows


def on_reference_leaves(final, run):
    """The program's state in the reference's leaf order."""
    slot = {leaf: b for b, leaf in enumerate(final.mesh.leaves)}
    return final.solution.conserved[[slot[leaf] for leaf in run.leaves]]


@pytest.mark.parametrize("depth", [2, 3, 4])
def test_reference_leaves_are_build_mesh_s(depth):
    with contextlib.redirect_stdout(io.StringIO()):
        cfg, _ = TB.setup(["blast3d", f"depth={depth}", "block_size=4"],
                          device="cpu", dtype=F64)
    leaves = octree.create(depth)
    assert len(leaves) == len(set(leaves))
    assert set(leaves) == set(TB.build_mesh(cfg).leaves)
    if depth == 4:
        assert Counter(level for level, _ in leaves) == {2: 32, 3: 248,
                                                         4: 64}


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 12345])
def test_two_windows_are_blast3d_run_s(seed):
    # to a time inside the third window: the first two end on the dues at
    # DFI and 2 DFI, each at the dt read at its start
    until = 2.5 * DFI
    final, windows = program_run(["depth=3", "block_size=8",
                                  f"dfi={DFI}"], seed, until)
    run = ref.Blast(params(), "cpu", F64)
    u0 = run.initial(seed_field(seed, run.centres(), 0.05, "cpu"))
    u, t, steps, mine = run.run(u0, until)
    assert len(windows) == len(mine) == 3
    assert mine[0] == windows[0]                  # dt and steps, exactly
    assert [n for _, n in mine] == [n for _, n in windows]
    for (a, _), (b, _) in zip(mine, windows):
        assert a == pytest.approx(b, rel=1e-14)
    assert steps == final.solution.iteration
    assert t == pytest.approx(final.solution.time, rel=1e-14)
    assert cell_gap(on_reference_leaves(final, run), u) < BAR


def moving_state(run, seed):
    """A conserved state on the reference's leaves with density 1-2,
    speeds about 0.3 and pressure 0.5-1, cell by cell from a numpy seed:
    every face of every case carries flow."""
    rng = np.random.default_rng(seed)
    shape = (len(run.leaves),) + (run.n,) * 3
    rho = 1.0 + rng.uniform(size=shape)
    v = 0.3 * rng.normal(size=shape + (3,))
    p = 0.5 + 0.5 * rng.uniform(size=shape)
    P = torch.tensor(np.concatenate([rho[..., None], v, p[..., None]],
                                    axis=-1), dtype=F64)
    return run.conserved(P)


@pytest.mark.parametrize("seed", [1, 2])
def test_reference_step_is_make_advance_s(seed):
    run = ref.Blast(params(), "cpu", F64)
    mesh = TB.build_mesh(TB.config_template().create().update(
        {"depth": 3, "block_size": 8}))
    u = moving_state(run, seed)
    slot = {leaf: b for b, leaf in enumerate(run.leaves)}
    program_order = [slot[leaf] for leaf in mesh.leaves]
    dt = run.dt(u)
    want = u
    for _ in range(5):
        want = run.step(want, dt)
    got = TE.make_advance(mesh, 8, TB.GAMMA)(u[program_order], dt, 5)
    back = {leaf: b for b, leaf in enumerate(mesh.leaves)}
    got = got[[back[leaf] for leaf in run.leaves]]
    assert cell_gap(got, want) < BAR


def test_totals_are_conserved_across_the_level_jumps(monkeypatch):
    # depth 4, block 4: the cell's tree, the blast front crossing the
    # jumps from level 4 to 3 by t = 0.02, as in the cell's checked steps
    run = ref.Blast(params(depth=4, block_size=4, dfi=0.1), "cpu", F64)
    assert run.faces.count("fine") == 72
    u0 = run.initial(seed_field(5, run.centres(), 0.05, "cpu"))

    def drift(u):
        t0, t1 = run.totals(u0), run.totals(u)
        scale = [t0[0], run.gross_momentum(u), run.gross_momentum(u),
                 run.gross_momentum(u), t0[4]]
        return max(abs(a - b) / s for a, b, s in zip(t1, t0, scale))

    u, _, steps, _ = run.run(u0, 0.02)
    assert steps > 10 and drift(u) < 1e-13
    # the same run with the level jumps left uncorrected is not
    # conservative: the test can see a missing correction
    monkeypatch.setattr(octree.Faces, "correct", lambda self, F, axis: F)
    u, _, _, _ = run.run(u0, 0.02)
    assert drift(u) > 1e-6


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import torch_bench.reference.blast3d; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mara3_tpu_torch', 'mara3_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_reference_agrees_with_the_port_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("the cell's size runs on a CUDA card (no GPU here)")
    # the cell's configuration and checked steps, in float64
    seed = 2 ** 31 + 54321
    final, windows = program_run(["depth=4", "block_size=16", "dfi=0.1"],
                                 seed, 0.02, "cuda")
    run = ref.Blast(params(depth=4, block_size=16, dfi=0.1), "cuda", F64)
    u0 = run.initial(seed_field(seed, run.centres(), 0.05, "cuda"))
    u, _, steps, mine = run.run(u0, 0.02)
    assert mine == windows and steps == final.solution.iteration > 100
    assert cell_gap(on_reference_leaves(final, run), u) < BAR
