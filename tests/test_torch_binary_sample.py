"""The flagship's output path reads the mesh geometry that the solver data
keeps on the run's device (SolverData.device_geometry), on the CPU.

- The time-series rows and the diagnostic fields keep their bits: each
  equals, byte for byte, the value formed the old way, from the host's
  float64 geometry cast to the run's dtype at every call (old_sample,
  old_diagnostic_fields below keep that expression), for a Solution and
  for the fast step's state, in both formulations (conserve_linear_p).
- After a regrid that changes the tree the sample reads the new tree's
  geometry.
- Under torch.profiler the fast loop counts one `geometry_uploads` per
  solver data and none per row (a regrid that changes the tree counts
  one), records a row for each `outputs.record_time_series`, and reads the
  host once per row, with the per-step scan and with B3's plain version.
"""

from __future__ import annotations

import contextlib
import io
from dataclasses import replace

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from mara3_tpu_torch.app import tracing
from mara3_tpu_torch.physics import iso2d
from mara3_tpu_torch.schemes import binary_step
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

F32 = torch.float32
SMALL = ["binary", "depth=2", "block_size=8", "fast_step=1", "tsi=0.1",
         "tfinal=0.6", "outdir=."]


def _geometry(sd, k):
    """The host float64 geometry cast per call, as the output path did."""
    return torch.as_tensor(sd.geometry[k], dtype=sd.dtype, device=sd.device)


def old_sample(solution, sd):
    dA = _geometry(sd, 1)
    mass = float(torch.sum(solution.conserved[..., 0] * dA))
    if sd.conserve_linear_p:
        lz = iso2d.angular_momentum(solution.conserved, _geometry(sd, 0))
    else:
        lz = solution.conserved[..., 2]
    angmom = float(torch.sum(lz * dA))
    b = TB.two_body.compute_two_body_state(solution.orbital_elements,
                                           solution.time)
    return np.array((
        solution.time, mass, angmom,
        solution.mass_accreted_on, solution.angular_momentum_accreted_on,
        solution.integrated_torque_on, solution.work_done_on,
        solution.mass_ejected, solution.angular_momentum_ejected,
        TB._full_elements_to_np(solution.orbital_elements_acc),
        TB._full_elements_to_np(solution.orbital_elements_grav),
        TB._full_elements_to_np(solution.orbital_elements),
        (b.body1.position_x, b.body1.position_y),
        (b.body2.position_x, b.body2.position_y)),
        dtype=TB.TIME_SERIES_DTYPE)


def old_diagnostic_fields(solution, sd):
    xc = _geometry(sd, 0)
    if sd.conserve_linear_p:
        p0 = iso2d.recover_primitive(solution.conserved)
    else:
        p0 = iso2d.recover_primitive_angmom(solution.conserved, xc)
    r = torch.sqrt(xc[..., 0] ** 2 + xc[..., 1] ** 2)
    vx, vy = p0[..., 1], p0[..., 2]
    return {"sigma": p0[..., 0].numpy(),
            "radial_velocity": ((vx * xc[..., 0] + vy * xc[..., 1])
                                / r).numpy(),
            "phi_velocity": ((-vx * xc[..., 1] + vy * xc[..., 0])
                             / r).numpy()}


def assert_same_bits(solution, sd, state=None):
    """The row of `solution` (of the fast `state` when given) and its
    diagnostic fields equal the old way's, byte for byte."""
    if state is None:
        got, want = TB.time_series_sample(solution, sd), old_sample(solution,
                                                                    sd)
    else:
        got = TB.time_series_sample(state, sd)
        want = old_sample(binary_step.arrays_to_solution(state, TB.Solution),
                          sd)
    assert got.dtype == want.dtype
    assert got.tobytes() == want.tobytes()
    assert got["disk_mass"] == want["disk_mass"]
    assert got["disk_angular_momentum"] == want["disk_angular_momentum"]
    fields = TB.diagnostic_fields(solution, sd)
    for name, value in old_diagnostic_fields(solution, sd).items():
        assert fields[name].dtype == value.dtype
        assert fields[name].tobytes() == value.tobytes(), name


def _run(argv, tasks=None):
    with contextlib.redirect_stdout(io.StringIO()):
        cfg, sd, state = TB.setup(argv, device="cpu", dtype=F32)
        if tasks is None:
            final = TB.run(cfg, sd, state)
        else:
            final = TB.run(cfg, sd, state, tasks=tasks)
    return cfg, state, final


@pytest.mark.parametrize("conserve_linear_p", [0, 1])
def test_rows_and_diagnostics_keep_their_bits(tmp_path, monkeypatch,
                                              conserve_linear_p):
    monkeypatch.chdir(tmp_path)
    _, _, final = _run(SMALL + [f"conserve_linear_p={conserve_linear_p}",
                                "dfi=100", "cpi=100"])
    sd, solution = final.solver_data, final.solution
    assert sd.dtype == F32 and solution.iteration > 0
    assert len(final.time_series) > 2
    assert_same_bits(solution, sd)
    assert_same_bits(solution, sd, binary_step.solution_to_arrays(solution))
    # the resident geometry holds the host's values in the run's dtype
    xc, dA = sd.device_geometry
    assert xc.dtype == dA.dtype == F32
    assert torch.equal(xc, _geometry(sd, 0))
    assert torch.equal(dA, _geometry(sd, 1))


@pytest.mark.parametrize("conserve_linear_p", [0, 1])
def test_a_regrid_samples_the_new_tree(conserve_linear_p):
    cfg = TB.create_config_template().create().update({
        "depth": 4, "block_size": 8, "regrid": 1,
        "conserve_linear_p": conserve_linear_p})
    sd = TB.create_solver_data(cfg, device="cpu", dtype=F32)
    solution = TB.create_solution(cfg, sd)
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]), \
                contextlib.redirect_stdout(io.StringIO()):
            solution2, sd2 = TB.apply_regrid(solution, sd, cfg)
        counts = tracing.counts()
    finally:
        tracing.clear()
    assert sd2 is not sd and len(sd2.leaves) != len(sd.leaves)
    # the new solver data took its geometry to the device once
    assert counts == {"geometry_uploads": 1}
    xc, dA = sd2.device_geometry
    assert xc.shape[0] == dA.shape[0] == len(sd2.leaves)
    assert torch.equal(dA, _geometry(sd2, 1))
    assert_same_bits(solution2, sd2)
    assert_same_bits(solution2, sd2,
                     binary_step.solution_to_arrays(solution2))
    # the public functions return the same floats
    want = old_sample(solution2, sd2)
    assert TB.disk_mass(solution2, sd2) == want["disk_mass"]
    assert TB.disk_angular_momentum(solution2, sd2) == \
        want["disk_angular_momentum"]


class HostReads:
    """The host reads of the device (Tensor.cpu, item, tolist, float)
    made inside each call of time_series_sample."""

    def __init__(self, monkeypatch):
        self.per_sample, self._inside = [], False
        for name in ("cpu", "item", "tolist", "__float__"):
            real = getattr(torch.Tensor, name)
            monkeypatch.setattr(torch.Tensor, name, self._counted(real))
        sample = TB.time_series_sample

        def counted_sample(*args, **kwargs):
            self._inside = True
            self.per_sample.append(0)
            try:
                return sample(*args, **kwargs)
            finally:
                self._inside = False

        monkeypatch.setattr(TB, "time_series_sample", counted_sample)

    def _counted(self, real):
        def method(*args, **kwargs):
            if self._inside:
                self.per_sample[-1] += 1
            return real(*args, **kwargs)
        return method


@pytest.mark.parametrize("launch", ["multi_launch=0", "multi_launch=4"],
                         ids=["per-step-scan", "b3-plain"])
def test_fast_loop_uploads_the_geometry_once(tmp_path, monkeypatch, launch):
    monkeypatch.chdir(tmp_path)
    by_runner = []

    def tasks(st, sd):
        schedule = st.schedule
        for task in ("write_diagnostics", "write_checkpoint"):
            if schedule.is_due(task):
                schedule = schedule.mark_as_completed(task)
        st = replace(st, schedule=schedule)
        if schedule.is_due("record_time_series"):
            by_runner.append(st.solution.iteration)
            st = TB.record_time_series(st, sd)
        return st

    reads = HostReads(monkeypatch)
    tracing.clear()
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            _, state, final = _run(SMALL + [launch], tasks)
        counts = tracing.counts()
    finally:
        tracing.clear()
    rows = len(final.time_series) - len(state.time_series)
    in_loop = rows - len(by_runner)
    assert in_loop > 3
    assert counts["outputs.record_time_series"] == in_loop
    assert counts["geometry_uploads"] == 1
    # every row, the loop's and the task runner's, reads the host once
    assert reads.per_sample == [1] * rows
