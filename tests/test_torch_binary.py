"""The port's flagship subprogram (mara3_tpu_torch/subprograms/binary.py)
as a whole against the JAX package's: steps of the driver loop, the CLI,
checkpoints across the two packages, and the port's independence from
jax."""

import os
import subprocess
import sys

import h5py
import numpy as np
import pytest
import torch

from mara3_tpu.app.schedule import Schedule as JSchedule
from mara3_tpu.subprograms import binary as JB
from mara3_tpu_torch.subprograms import binary as TB

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ELEMENT_FIELDS = ("orbital_elements_acc", "orbital_elements_grav",
                  "orbital_elements")
SCALAR_FIELDS = ("mass_accreted_on", "angular_momentum_accreted_on",
                 "integrated_torque_on", "work_done_on", "mass_ejected",
                 "angular_momentum_ejected")


def jax_arrays(s):
    """The JAX package's Solution as plain host values (the form
    mara3_tpu_torch.subprograms.binary.solution_from_arrays takes)."""
    out = {"time": s.time, "iteration": s.iteration,
           "conserved": np.asarray(s.conserved),
           "mass_ejected": s.mass_ejected,
           "angular_momentum_ejected": s.angular_momentum_ejected}
    for key in ("mass_accreted_on", "angular_momentum_accreted_on",
                "integrated_torque_on", "work_done_on"):
        out[key] = tuple(getattr(s, key))
    for key in ELEMENT_FIELDS:
        out[key] = JB._full_elements_to_np(getattr(s, key))
    return out


def flat(record):
    """The ten numbers of a FULL_ORBITAL_DTYPE record."""
    r = np.array(record, dtype=TB.FULL_ORBITAL_DTYPE)
    return np.array([r[k] for k in TB.FULL_ORBITAL_DTYPE.names[:-1]]
                    + [r["elements"][k] for k in TB.ORBITAL_DTYPE.names])


def assert_solutions_close(got, want, u_rtol, rtol):
    """got/want: solution_to_arrays-style dicts. Conserved state at
    u_rtol; accounting totals and orbital elements at rtol (atol 1e-17 on
    the totals, which start at zero; 1e-13 on the elements, order-one
    numbers whose perturbation fields start at zero)."""
    assert got["iteration"] == want["iteration"]
    np.testing.assert_allclose(got["time"], want["time"], rtol=1e-14)
    np.testing.assert_allclose(got["conserved"], want["conserved"],
                               rtol=u_rtol, atol=1e-20)
    for key in SCALAR_FIELDS:
        np.testing.assert_allclose(np.asarray(got[key]),
                                   np.asarray(want[key]), rtol=rtol,
                                   atol=1e-17, err_msg=key)
    for key in ELEMENT_FIELDS:
        np.testing.assert_allclose(flat(got[key]), flat(want[key]),
                                   rtol=rtol, atol=1e-13, err_msg=key)


def pair(over):
    base = {"depth": 3, "block_size": 8, "rk_order": 2}
    jcfg = JB.create_config_template().create().update({**base, **over})
    tcfg = TB.create_config_template().create().update({**base, **over})
    jsd = JB.create_solver_data(jcfg)
    tsd = TB.create_solver_data(tcfg, device="cpu", dtype=torch.float64)
    return jcfg, jsd, tcfg, tsd


@pytest.mark.parametrize("over", [
    {}, {"conserve_linear_p": 0, "riemann": "hllc",
         "begin_live_binary": 0.0}])
def test_five_steps_match_jax(over):
    """Five RK2 steps of next_solution from the same start: conserved state
    at rtol 1e-11, every total and orbital-element field at 1e-10. The
    second case turns the live binary on from t = 0, so the orbital
    elements evolve."""
    jcfg, jsd, tcfg, tsd = pair(over)
    jsol = JB.create_solution(jcfg, jsd)
    tsol = TB.solution_from_arrays(jax_arrays(jsol), tsd)
    for _ in range(5):
        jsol = JB.next_solution(jsol, jsd)
        tsol = TB.next_solution(tsol, tsd)
    assert_solutions_close(TB.solution_to_arrays(tsol), jax_arrays(jsol),
                           1e-11, 1e-10)


def test_initial_state_and_timestep_match_jax():
    jcfg, jsd, tcfg, tsd = pair({"conserve_linear_p": 0})
    np.testing.assert_allclose(tsd.initial_conserved.numpy(),
                               np.asarray(jsd.initial_conserved),
                               rtol=1e-14, atol=1e-20)
    np.testing.assert_allclose(tsd.buffer_rate.numpy(),
                               np.asarray(jsd.buffer_rate), rtol=1e-15)
    assert tsd.recommended_time_step == pytest.approx(
        jsd.recommended_time_step, rel=1e-14)
    assert vars(tsd.cfg_scheme) == vars(jsd.cfg_scheme)
    bodies = np.array(JB._bodies_array(JB.two_body.compute_two_body_state(
        JB.create_solution(jcfg, jsd).orbital_elements, 0.3)))
    np.testing.assert_allclose(
        float(tsd.maximum_timestep(tsd.initial_conserved, bodies)),
        float(jsd.maximum_timestep(jsd.initial_conserved, bodies)),
        rtol=1e-14)


def test_solution_arrays_round_trip():
    jcfg, jsd, tcfg, tsd = pair({})
    sol = TB.next_solution(TB.create_solution(tcfg, tsd), tsd)
    back = TB.solution_from_arrays(TB.solution_to_arrays(sol), tsd)
    assert back.time == sol.time and back.iteration == sol.iteration
    assert torch.equal(back.conserved, sol.conserved)
    for key in SCALAR_FIELDS + ELEMENT_FIELDS:
        assert getattr(back, key) == getattr(sol, key), key


def jax_checkpoint(tmp_path, over, steps=2):
    """A checkpoint written by the JAX package after `steps` steps; returns
    (path, the JAX solver data, the JAX solution)."""
    jcfg, jsd, _, _ = pair(over)
    jcfg = jcfg.update({"outdir": str(tmp_path)})
    sol = JB.create_solution(jcfg, jsd)
    for _ in range(steps):
        sol = JB.next_solution(sol, jsd)
    schedule = JSchedule.create("write_checkpoint", "write_diagnostics",
                                "record_time_series")
    state = JB.State(sol, schedule, (), jcfg)
    JB.write_checkpoint(state, jsd)
    return os.path.join(str(tmp_path), "chkpt.0000.h5"), jsd, sol


@pytest.mark.parametrize("over", [{}, {"conserve_linear_p": 0}])
def test_jax_checkpoint_restarts_in_port(tmp_path, over):
    """restart=<a JAX checkpoint>: the port reads the run config, schedule
    and solution, and its next step is the JAX package's next step."""
    path, jsd, jsol = jax_checkpoint(tmp_path, over)
    cfg = TB.resolve_options(TB.driver.create_run_config(
        TB.create_config_template(), ["binary", f"restart={path}"]), "cpu")
    assert cfg.get_int("conserve_linear_p") == over.get(
        "conserve_linear_p", 1)
    tsd = TB.create_solver_data(cfg, device="cpu", dtype=torch.float64)
    state = TB.create_state(cfg, tsd)
    assert state.schedule.num_times_performed("write_checkpoint") == 1
    assert_solutions_close(TB.solution_to_arrays(state.solution),
                           jax_arrays(jsol), 0.0, 0.0)
    got = TB.next_solution(state.solution, tsd)
    want = JB.next_solution(jsol, jsd)
    assert_solutions_close(TB.solution_to_arrays(got), jax_arrays(want),
                           1e-12, 1e-12)


def test_port_checkpoint_restarts_in_jax(tmp_path):
    """The layout is the JAX package's byte for byte: its reader takes the
    port's checkpoint back."""
    jcfg, jsd, tcfg, tsd = pair({})
    tcfg = tcfg.update({"outdir": str(tmp_path)})
    sol = TB.next_solution(TB.create_solution(tcfg, tsd), tsd)
    state = TB.State(sol, TB.Schedule.create("write_checkpoint"), (), tcfg)
    TB.write_checkpoint(state, tsd)
    with h5py.File(os.path.join(str(tmp_path), "chkpt.0000.h5"), "r") as f:
        assert set(f) == {"solution", "schedule", "run_config",
                          "time_series"}
        jsol = JB.read_solution(f["solution"], jsd)
    assert_solutions_close(jax_arrays(jsol), TB.solution_to_arrays(sol),
                           0.0, 0.0)


def run_port(*args, cwd):
    """The port's command line on the CPU, which its device selector asks
    for (without it, and without a card, the run refuses to start)."""
    env = dict(os.environ, PYTHONPATH=REPO)
    env[TB.DEVICE_SELECTOR] = "cpu"
    return subprocess.run([sys.executable, "-m", "mara3_tpu_torch", *args],
                          cwd=cwd, env=env, capture_output=True, text=True,
                          timeout=300)


def test_cli_run_writes_checkpoint(tmp_path):
    """python -m mara3_tpu_torch binary ...: exits 0, prints the resolved
    fast_step and the kzps lines, and writes chkpt.0000.h5 with the
    solution/schedule/run_config groups; a restart from it continues."""
    out = tmp_path / "run"
    proc = run_port("binary", "depth=2", "block_size=8", "tfinal=0.01",
                    f"outdir={out}", cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr
    assert "fast_step ... 0" in proc.stdout
    assert "kzps=" in proc.stdout
    with h5py.File(out / "chkpt.0000.h5", "r") as f:
        assert {"solution", "schedule", "run_config"} <= set(f)
        assert "conserved_u" in f["solution"]
        assert f["run_config/fast_step"][()] == 0
    restart = run_port("binary", f"restart={out / 'chkpt.0000.h5'}",
                       "tfinal=0.02", cwd=str(tmp_path))
    assert restart.returncode == 0, restart.stderr


def test_cli_lists_subprograms(tmp_path):
    proc = run_port(cwd=str(tmp_path))
    assert proc.returncode == 0 and "binary" in proc.stdout


def test_regrid_option_resolves_and_runs(tmp_path):
    """regrid=1, which slices 1-6 refused, now resolves to itself and runs
    (tests/test_torch_binary_regrid.py holds it to the JAX package)."""
    cfg = TB.driver.create_run_config(TB.create_config_template(),
                                      ["binary", "regrid=1"])
    assert TB.resolve_options(cfg, "cpu").get_int("regrid") == 1
    cfg, sd, state = TB.setup(["binary", "depth=3", "block_size=8",
                               "regrid=1", "rgi=0.005", "tfinal=0.012",
                               f"outdir={tmp_path}"], device="cpu",
                              dtype=torch.float64)
    final = TB.run(cfg, sd, state, tasks=lambda st, _: st)
    assert final.solver_data is not None
    assert final.solution.conserved.shape[0] == len(final.solver_data.leaves)
    assert final.solution.time / (2 * np.pi) >= 0.012


@pytest.mark.parametrize("option,key,value", [
    ("fast_step=1", "fast_step", 1), ("multi_launch=4", "multi_launch", 4)])
def test_ported_options_resolve(option, key, value):
    """fast_step=1 and multi_launch=4, which slice 1 refused, now resolve
    to themselves and run (tests/test_torch_binary_step.py and
    test_torch_binary_multi.py hold their paths to the JAX package)."""
    cfg = TB.driver.create_run_config(TB.create_config_template(),
                                      ["binary", option])
    assert TB.resolve_options(cfg, "cpu").get_int(key) == value


def test_no_jax_in_the_port():
    """Importing the port and running a step, the per-step scan and the
    multi-step scan (kernel B3's plain version), the split and jnp_strips
    advances (kernels B11a-c's plain versions), a regrid, a sedov SRHD step of
    kernel B5's plain version, two cloud steps of kernel B4d's plain
    version, and two amrsand and two sand3d steps of kernels B6's and B7's
    plain versions, a sharded kh advance (B9's plain version), a step of
    B10a-c's, two of B8's and two blast3d steps, loads neither jax nor the
    JAX package, and no source file of the port imports them."""
    code = (
        "import sys, torch\n"
        "from mara3_tpu_torch.subprograms import binary as B\n"
        "from mara3_tpu_torch.app import subprogram\n"
        "subprogram.registered()\n"
        "cfg = B.create_config_template().create().update("
        "{'depth': 2, 'block_size': 8})\n"
        "sd = B.create_solver_data(cfg, device='cpu')\n"
        "B.next_solution(B.create_solution(cfg, sd), sd)\n"
        "from mara3_tpu_torch.schemes import binary_step as S\n"
        "s = S.solution_to_arrays(B.create_solution(cfg, sd))\n"
        "s, rows = S.make_fast_scan(sd)(s, 2)\n"
        "s, rows = S.make_multi_scan(sd, k_chunk=2)(s, 2)\n"
        "assert rows.shape == (2, S.INFO_WIDTH)\n"
        "from mara3_tpu_torch.subprograms import sedov as SD\n"
        "s = SD.new_solution(SD.config_template().create().update("
        "{'nr': 16}))\n"
        "u = SD.advance_n(s.conserved, s.vertices, SD.grid_dt(s.vertices),"
        " False, 1, kernel=True)\n"
        "assert SD.LAST_PATH == 'plain_b5_srhd_pcm[1]', SD.LAST_PATH\n"
        "from mara3_tpu_torch.subprograms import cloud as C\n"
        "c = C.new_solution(C.config_template().create().update("
        "{'nr': 8}))\n"
        "us = c.conserved.permute(2, 0, 1).contiguous()\n"
        "C.advance_n(us, torch.zeros_like(us[0]), 0.0, 2, c.radial_vertices,"
        " c.polar_vertices, C.jet_static(C.config_template().create()),"
        " 1e-3, 1.2, 2, 1e-8, 2, kernel=True)\n"
        "assert C.LAST_PATH == 'plain_b4d_rk2[2]', C.LAST_PATH\n"
        "from mara3_tpu_torch.subprograms import amrsand as A\n"
        "from mara3_tpu_torch.mesh import block_layout as BL\n"
        "a = A.new_solution(A.config_template().create().update("
        "{'depth': 2, 'block_size': 4}))\n"
        "A.advance_n(a.conserved, A.block_spacings(a),"
        " BL.build_neighbor_table(a.leaves), A.time_step(a), 2, kernel=True)\n"
        "assert A.LAST_PATH == 'plain_b6[2]', A.LAST_PATH\n"
        "from mara3_tpu_torch.subprograms import sand3d as S3\n"
        "m = S3.build_mesh(S3.config_template().create().update("
        "{'depth': 1}))\n"
        "g = S3.new_solution(S3.config_template().create().update("
        "{'block_size': 4}), m)\n"
        "S3.make_advance_auto(m, 4, S3.VELOCITY, 1)(g.conserved, 1e-3, 2)\n"
        "assert S3.LAST_PATH == 'plain_b7[2]', S3.LAST_PATH\n"
        "from mara3_tpu_torch.schemes import binary_scheme as BS\n"
        "for v in ('split', 'jnp_strips'):\n"
        "    BS.make_advance(sd.cfg_scheme, sd.nt, sd.geometry,"
        " sd.initial_conserved, sd.buffer_rate, device='cpu',"
        " dtype=torch.float32, fused=v)(sd.initial_conserved,"
        " B.bodies_array(B.two_body.compute_two_body_state("
        "B.create_solution(cfg, sd).orbital_elements, 0.0)), 1e-3, 1.8)\n"
        "B.apply_regrid(B.create_solution(cfg, sd), sd, cfg.set('depth', 3))\n"
        "from mara3_tpu_torch.subprograms import kh as KH\n"
        "from mara3_tpu_torch.kernels import iso2d_step_v1 as V1,"
        " iso2d_step_v2 as V2, iso2d_step_v3 as V3\n"
        "kc = KH.config_template().create().update({'N': 16, 'shards': 2})\n"
        "adv, devs, g = KH.make_sharded_advance(kc, 1e-3, 'cpu')\n"
        "KH.advance_sharded(KH.initial_conserved(kc), 4, adv, devs)\n"
        "assert KH.LAST_PATH == 'sharded_b9[2dev]', KH.LAST_PATH\n"
        "v = KH.initial_conserved(kc).permute(2, 0, 1).contiguous()\n"
        "V1.advance_n_v1(v, 1, cs2=1.0, dtdx=0.1, dtdy=0.1)\n"
        "V2.advance_n_v2(v, 1, cs2=1.0, dtdx=0.1, dtdy=0.1, tile=(8, 8))\n"
        "V3.advance_n_v3(v, 2, G=2, cs2=1.0, dtdx=0.1, dtdy=0.1,"
        " tile=(8, 8))\n"
        "from mara3_tpu_torch.kernels import iso2d_step_li as LI\n"
        "LI.advance_n_li(v, 2, G=2, geom=(1 / 16, 1.0, 1.0, 1.0, 1.0, 100.0,"
        " 1e-4), dtdx=0.01, dtdy=0.01, tile=(8, 8))\n"
        "from mara3_tpu_torch.subprograms import blast3d as B3\n"
        "from mara3_tpu_torch.mesh import euler3d as E3\n"
        "bc = B3.config_template().create().update({'depth': 2,"
        " 'block_size': 4})\n"
        "bm = B3.build_mesh(bc)\n"
        "E3.make_advance(bm, 4)(B3.new_solution(bc, bm).conserved, 1e-3, 2)\n"
        "bad = [m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'mara3_tpu' or m.startswith('mara3_tpu.')]\n"
        "assert not bad, bad\n"
        "print('clean')\n")
    env = dict(os.environ, PYTHONPATH=REPO)
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0 and "clean" in proc.stdout, proc.stderr
    import re
    pattern = re.compile(r"^\s*(import|from)\s+(jax|mara3_tpu)(\.|\s|$)",
                         re.M)
    for root, _, files in os.walk(os.path.join(REPO, "mara3_tpu_torch")):
        for name in files:
            if name.endswith(".py"):
                with open(os.path.join(root, name)) as f:
                    assert not pattern.search(f.read()), name
