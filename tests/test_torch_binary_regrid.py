"""The port's flagship regrid (mara3_tpu_torch/subprograms/binary.py
apply_regrid, and `regrid=1` in both driver loops) against the JAX
package's, float64 on the CPU, at the configuration of
tests/test_subprogram_binary.py::test_binary_dynamic_regrid_conserves_and_tracks
(depth=4 block_size=8 rgi=0.01 tfinal=0.03 cpi=0.015: two regrids, 64 ->
172 -> 184 blocks, that change the tree).

Bars:
  - apply_regrid: the same new leaves and the remapped state bit for bit
    (the remap is the same host numpy in both packages); the conserved
    totals kept to rtol 1e-12, atol 1e-18 (the JAX test's bar);
  - whole runs against the JAX package's main: the last checkpoint's blocks
    (the same leaves), its time at rtol 1e-14, its state at rtol 1e-12,
    atol 1e-20 and every cell within 1e-14 of its largest component
    (measured 1.2e-15), and the time series' mass, angular momentum and
    accounting columns at rtol 1e-12, atol 1e-17;
  - the port's B3 loop (multi_launch=4, kernel B3's plain version) against
    its per-step loop: the state at rtol 1e-14 (the same arithmetic; the
    two are equal here)."""

import os
from dataclasses import replace

import h5py
import numpy as np
import pytest
import torch

from mara3_tpu.subprograms import binary as JB
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

F64 = torch.float64
ARGS = ["binary", "depth=4", "block_size=8", "regrid=1", "rgi=0.01",
        "tfinal=0.03", "cpi=0.015"]
SERIES = ("time", "disk_mass", "disk_angular_momentum", "mass_accreted_on",
          "angular_momentum_accreted_on", "integrated_torque_on",
          "mass_ejected", "angular_momentum_ejected")


def configs(over=()):
    over = {"depth": 4, "block_size": 8, "regrid": 1, "rgi": 0.01,
            "tfinal": 0.03, "cpi": 0.015, **dict(over)}
    return (JB.create_config_template().create().update(over),
            TB.create_config_template().create().update(over))


def last_checkpoint(outdir):
    """(block keys, state, time, time series) of a run's last checkpoint."""
    name = sorted(f for f in os.listdir(outdir) if f.startswith("chkpt"))[-1]
    with h5py.File(os.path.join(outdir, name)) as f:
        g = f["solution"]["conserved_u"]
        keys = sorted(g.keys())
        return (keys, np.stack([g[k][()] for k in keys]),
                f["solution"]["time"][()], f["time_series"][()])


def test_apply_regrid_matches_jax():
    jcfg, tcfg = configs()
    jsd = JB.create_solver_data(jcfg)
    tsd = TB.create_solver_data(tcfg, device="cpu", dtype=F64)
    jsol = JB.create_solution(jcfg, jsd)
    # the same state in both (the two packages' initial disks differ in
    # their last bits)
    tsol = replace(TB.create_solution(tcfg, tsd),
                   conserved=torch.as_tensor(np.array(jsol.conserved)))
    jsol2, jsd2 = JB.apply_regrid(jsol, jsd, jcfg)
    tsol2, tsd2 = TB.apply_regrid(tsol, tsd, tcfg)
    assert len(jsd2.leaves) != len(jsd.leaves), "the indicator refines"
    assert tuple(tsd2.leaves) == tuple(jsd2.leaves)
    np.testing.assert_array_equal(tsol2.conserved.numpy(),
                                  np.asarray(jsol2.conserved))
    for a, b in zip(tsd2.geometry, jsd2.geometry):
        np.testing.assert_array_equal(a, np.asarray(b))
    # the remap keeps the conserved totals
    dA1 = tsd.geometry[1][..., None]
    dA2 = tsd2.geometry[1][..., None]
    tot1 = (tsol.conserved.numpy() * dA1).sum(axis=(0, 1, 2))
    tot2 = (tsol2.conserved.numpy() * dA2).sum(axis=(0, 1, 2))
    np.testing.assert_allclose(tot2, tot1, rtol=1e-12, atol=1e-18)
    # the new solver data is whole: its advance and tables are the new
    # mesh's, on the run's device and dtype
    assert tsd2.advance.tables.xc.shape[0] == len(tsd2.leaves)
    assert tsd2.dtype == F64 and tsd2.device == tsd.device


def test_apply_regrid_keeps_a_stable_tree():
    """A leaf set the indicator leaves as it is returns the same objects."""
    _, tcfg = configs()
    tsd = TB.create_solver_data(tcfg, device="cpu", dtype=F64)
    sol, sd2 = TB.apply_regrid(TB.create_solution(tcfg, tsd), tsd, tcfg)
    sol3, sd3 = TB.apply_regrid(sol, sd2, tcfg)
    sol4, sd4 = TB.apply_regrid(sol3, sd3, tcfg)
    if sd4 is sd3:
        assert sol4 is sol3
    else:               # the second regrid changed the tree: a third may not
        sol5, sd5 = TB.apply_regrid(sol4, sd4, tcfg)
        assert sd5 is sd4 and sol5 is sol4


@pytest.mark.parametrize("loop", [["fast_step=0"],
                                  ["fast_step=1", "multi_launch=0"]],
                         ids=["reference-loop", "fast-loop"])
def test_regrid_run_matches_jax(tmp_path, loop):
    """`regrid=1` through the port's main against the JAX package's main:
    the same final leaves and state."""
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert JB.main(ARGS + loop + [f"outdir={jdir}"]) == 0
    assert TB.main(ARGS + loop + [f"outdir={tdir}"], device="cpu",
                   dtype=F64) == 0
    (kt, ut, tt, st), (kj, uj, tj, sj) = (last_checkpoint(tdir),
                                          last_checkpoint(jdir))
    assert kt == kj and len(kt) == 184
    np.testing.assert_allclose(tt, tj, rtol=1e-14)
    np.testing.assert_allclose(ut, uj, rtol=1e-12, atol=1e-20)
    cell = np.abs(uj).max(axis=-1, keepdims=True)
    assert np.all(np.abs(ut - uj) <= 1e-14 * cell)
    assert len(st) == len(sj) >= 2
    for name in SERIES:
        np.testing.assert_allclose(st[name], sj[name], rtol=1e-12,
                                   atol=1e-17, err_msg=name)


def test_regrid_b3_loop_matches_its_per_step_loop():
    """The fast loop through B3's plain version (multi_launch=4), its
    tables rebuilt at each regrid, against the per-step scan; run() hands
    back the regridded solver data."""
    finals = []
    for k in (4, 0):
        cfg, sd, state = TB.setup(ARGS + ["fast_step=1", f"multi_launch={k}",
                                          "outdir=."], device="cpu",
                                  dtype=F64)
        final = TB.run(cfg, sd, state, tasks=lambda st, _: st)
        sd_end = final.solver_data
        assert len(sd_end.leaves) == 184 != len(sd.leaves)
        assert final.solution.conserved.shape[0] == len(sd_end.leaves)
        finals.append(final.solution)
    a, b = finals
    assert a.iteration == b.iteration
    np.testing.assert_allclose(a.conserved.numpy(), b.conserved.numpy(),
                               rtol=1e-14, atol=0)


def test_regridded_checkpoint_does_not_restart(tmp_path):
    """A checkpoint written after a regrid holds other blocks than the
    leaves the config builds: both packages refuse it (ROADMAP.md §C)."""
    assert TB.main(ARGS + ["fast_step=0", f"outdir={tmp_path}"],
                   device="cpu", dtype=F64) == 0
    path = str(tmp_path / sorted(f for f in os.listdir(tmp_path)
                                 if f.startswith("chkpt"))[-1])
    jcfg, tcfg = configs({"restart": path})
    tsd = TB.create_solver_data(tcfg, device="cpu", dtype=F64)
    with pytest.raises(ValueError, match="restart across a regrid"):
        TB.create_state(tcfg, tsd)
    jsd = JB.create_solver_data(jcfg)
    with pytest.raises(KeyError):
        JB.create_state(jcfg, jsd)
