"""A run of the port that reaches a non-finite state fails: every loop of
every subprogram tests its state at each checkpoint and diagnostics write
and at its end, and raises driver.NonFiniteState naming the subprogram,
the iteration and the time. One cell of the initial state is set to NaN
through setup(); with the default tasks the first write raises, with tasks
that write nothing the end of the run does. Port-only, on the CPU."""

import pytest
import torch

from mara3_tpu_torch.app.driver import NonFiniteState
from mara3_tpu_torch.subprograms import amrsand, binary, cloud, kh, sand3d
from mara3_tpu_torch.subprograms import sedov

torch.set_num_threads(1)


def _poison(state):
    """state with one cell of its conserved tensor set to NaN."""
    s = state.solution
    u = s.conserved.clone()
    u.view(-1)[u.numel() // 3] = float("nan")
    return binary.replace(state, solution=binary.replace(s, conserved=u))


def _no_writes(state, *_):
    return state


# (subprogram module, argv, needs prepare_filesystem)
RUNS = {
    "kh": (kh, ["kh", "N=16", "tfinal=0.01", "cpi=0.005", "dfi=0.005",
                "tsi=0.005"], True),
    "sedov": (sedov, ["sedov", "nr=16", "tfinal=0.002", "cpi=0.001",
                      "dfi=0.001", "tsi=0.001"], True),
    "cloud": (cloud, ["cloud", "nr=8", "tfinal=0.004", "cpi=0.002",
                      "dfi=0.002", "tsi=0.002"], True),
    "amrsand": (amrsand, ["amrsand", "depth=2", "block_size=8",
                          "tfinal=0.05", "dfi=0.02"], False),
    "sand3d": (sand3d, ["sand3d", "depth=2", "block_size=4", "tfinal=0.05",
                        "dfi=0.02"], False),
}


@pytest.mark.parametrize("writes", [True, False], ids=["write", "end"])
@pytest.mark.parametrize("name", sorted(RUNS))
def test_non_finite_run_raises(tmp_path, monkeypatch, name, writes):
    module, argv, files = RUNS[name]
    monkeypatch.chdir(tmp_path)
    cfg, state = module.setup(argv + [f"outdir={tmp_path / 'out'}"],
                              device="cpu")
    if files:
        module.prepare_filesystem(cfg)
    (tmp_path / "out").mkdir(exist_ok=True)
    state = _poison(state)
    at = "iteration 0, t = 0" if writes else "iteration [1-9]"
    with pytest.raises(NonFiniteState, match=f"{name}: .*{at}"):
        module.run(cfg, state, *(() if writes else (_no_writes,)))


@pytest.mark.parametrize("writes", [True, False], ids=["write", "fault"])
@pytest.mark.parametrize("fast_step", [0, 1])
def test_non_finite_binary_raises(tmp_path, fast_step, writes):
    """The flagship's reference-shaped loop and its device-resident loop
    (B3's plain version on the CPU): the first write raises; with tasks
    that write nothing the loops' own fault check, which counts a NaN
    density as a fault, stops the run after its safe-mode retry."""
    argv = ["binary", "depth=2", "block_size=8", "tfinal=0.002",
            "cpi=0.001", "dfi=0.001", "tsi=0.001", f"fast_step={fast_step}",
            f"multi_launch={4 * fast_step}", f"outdir={tmp_path}"]
    cfg, sd, state = binary.setup(argv, device="cpu")
    state = _poison(state)
    if writes:
        with pytest.raises(NonFiniteState,
                           match="binary: .*iteration 0, t = 0"):
            binary.run(cfg, sd, state)
    else:
        with pytest.raises(binary.NegativeDensityError,
                           match="negative density"):
            binary.run(cfg, sd, state, _no_writes)
