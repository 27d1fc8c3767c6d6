"""The benchmark's plain kh reference (torch_bench/reference/kh.py) against
the port's kh, on the CPU in float64: its step against the scheme
(schemes/iso2d_grid.step_periodic_uniform) and kernel B1's plain version
(kernels/iso2d_step.advance_n_plain), its shear layer and dt against
kh.setup's, its row against kh.compute_time_series_data; and that it
imports nothing of the port or of JAX. The test marked `cuda` holds it to
B1 on the card (this file imports no JAX, so it runs there:
python -m pytest --noconftest -p no:cacheprovider -m cuda
tests/test_torch_kh_reference.py).

The bar: the reference writes the same formulas in another rounding
order (a full slope halved at the face where B1 folds the half in, a
division by (ap - am) where B1 multiplies by its reciprocal, dt and dx
applied apart), so after STEPS steps each cell differs by round-off, about
1e-15 of its largest component; 1e-12 leaves room for the steps' growth,
while a scheme that differs (a slope of another theta, a dropped flux
term) differs by 1e-4 or more."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.schemes import iso2d_grid as TG
from mara3_tpu_torch.subprograms import kh as TKH
from torch_bench.reference import kh as ref

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
F64 = torch.float64
N = 32
STEPS = 16
BAR = 1e-12
PARAMS = dict(N=N, cs=1.0, mach=0.5, sigma0=1.0, sigma1=2.0, pert=0.01,
              pert_k=2, plm_theta=1.8, riemann="hlle", rk_order=1, cfl=0.3)


def random_state(seed, device="cpu"):
    """A conserved state [N, N, 3] of density 1-2 with jumps between
    neighbours and speeds ~0.3, from a numpy seed."""
    rng = np.random.default_rng(seed)
    sg = 1.0 + rng.uniform(size=(N, N))
    vx = 0.3 * rng.normal(size=(N, N))
    vy = 0.3 * rng.normal(size=(N, N))
    return torch.tensor(np.stack([sg, sg * vx, sg * vy], axis=-1), dtype=F64,
                        device=device)


def cell_gap(u, r):
    """Largest |u - r| of a cell over its largest component in r."""
    d = (u - r).abs().amax(dim=-1)
    return float((d / r.abs().amax(dim=-1)).max())


def program(u, path, dt):
    """STEPS steps of the port's scheme or of B1's plain version."""
    if path == "scheme":
        for _ in range(STEPS):
            u = TG.step_periodic_uniform(u, 1.0, 1.0 / N, 1.0 / N, dt, 1.8,
                                         "hlle")
        return u
    uT = TK.advance_n_plain(u.permute(2, 0, 1), STEPS, cs2=1.0,
                            dtdx=dt * N, dtdy=dt * N, theta=1.8)
    return uT.permute(1, 2, 0)


@pytest.mark.parametrize("path", ["scheme", "b1_plain"])
@pytest.mark.parametrize("seed", [0, 1, 2])
def test_reference_steps_agree_with_the_port(path, seed):
    run = ref.KH(PARAMS, "cpu", F64)
    u = random_state(seed)
    assert cell_gap(program(u, path, run.dt), run.run(u, STEPS)) < BAR


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 12345])
def test_reference_shear_layer_and_dt_are_kh_setup_s(seed):
    # the seeded initial state and its first steps through kh's own loop
    from torch_bench import perturb
    cfg, state = TKH.setup(["kh", f"N={N}", "fast_step=1"], device="cpu",
                           dtype=F64)
    run = ref.KH(PARAMS, "cpu", F64)
    assert run.dt == state.solution.dt
    f = perturb.factor(seed, ref.positions(N, "cpu"), 0.05, "cpu")
    assert cell_gap(state.solution.conserved, run.initial(
        torch.ones(N, N, dtype=F64))) == 0.0
    u0 = state.solution.conserved * f[..., None]
    assert cell_gap(u0, run.initial(f)) < 1e-15
    s = TKH.run(cfg.set("tfinal", STEPS * run.dt), TKH.State(
        TKH.Solution(0, 0.0, run.dt, u0), state.schedule),
        tasks=lambda st, c: st).solution
    assert s.iteration == STEPS
    assert cell_gap(s.conserved, run.run(run.initial(f), STEPS)) < BAR


@pytest.mark.parametrize("seed", [4, 5])
def test_reference_row_is_kh_s(seed):
    run = ref.KH(PARAMS, "cpu", F64)
    u = random_state(seed)
    mine = run.row(u, 0.25)
    theirs = TKH.compute_time_series_data(TKH.Solution(7, 0.25, run.dt, u),
                                          None)
    assert set(mine) == set(theirs)
    for k, v in mine.items():
        assert v == pytest.approx(theirs[k], rel=1e-14, abs=1e-16), k


def test_reference_imports_nothing_of_the_port():
    code = ("import sys; import torch_bench.reference.kh; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'mara3_tpu_torch', 'mara3_tpu', 'jax', 'jaxlib', 'flax'}))")
    out = subprocess.run([sys.executable, "-c", code],
                         cwd=REPO,
                         capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


@pytest.mark.cuda
def test_reference_agrees_with_b1_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("kernel B1 runs only on a CUDA card (no GPU here)")
    n = 256
    p = dict(PARAMS, N=n)
    run = ref.KH(p, "cuda", F64)
    rng = np.random.default_rng(6)
    sg = 1.0 + rng.uniform(size=(n, n))
    v = 0.3 * rng.normal(size=(2, n, n))
    u = torch.tensor(np.stack([sg, sg * v[0], sg * v[1]], axis=-1),
                     dtype=F64, device="cuda")
    uT = TK.advance_n_cuda(u.permute(2, 0, 1).contiguous(), 64, cs2=1.0,
                           dtdx=run.dt * n, dtdy=run.dt * n, theta=1.8)
    assert cell_gap(uT.permute(1, 2, 0), run.run(u, 64)) < BAR
