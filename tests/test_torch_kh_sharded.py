"""kh's x-sharded run in the port (mara3_tpu_torch/parallel/iso2d_sharded.py,
subprograms/kh.py shards=N) against one shard, kernel B1's plain version
and the JAX package's sharded run (shard_map over the conftest's 8 virtual
CPU devices, B9 in interpret mode), on the CPU in float64."""

import os
import subprocess
import sys

import h5py
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from mara3_tpu.parallel import iso2d_sharded as JS
from mara3_tpu.subprograms import kh as JKH
from mara3_tpu_torch.app.device import DEVICE_SELECTOR
from mara3_tpu_torch.kernels import iso2d_step as TK
from mara3_tpu_torch.parallel import iso2d_sharded as TS
from mara3_tpu_torch.subprograms import kh as TKH

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the port against the JAX package's sharded kernel: the same formulas, but
# XLA's CPU graph fuses multiply-adds (tests/test_torch_iso2d_ladder.py)
JAX_TOL = dict(rtol=1e-13, atol=1e-13)
# kh's files: those of tests/test_torch_kh.py
SCHEME_TOL = dict(rtol=1e-12, atol=1e-14)


def random_state(nx, ny, seed=7):
    rng = np.random.default_rng(seed)
    sg = 1.0 + 0.2 * rng.uniform(size=(nx, ny))
    vx = 0.1 * rng.normal(size=(nx, ny))
    vy = 0.1 * rng.normal(size=(nx, ny))
    return np.stack([sg, sg * vx, sg * vy])


@pytest.mark.parametrize("rk,riemann", [(1, "hlle"), (2, "hllc")])
@pytest.mark.parametrize("n_shards", [2, 4])
def test_sharded_module_matches_one_shard_b1_and_jax(n_shards, rk, riemann):
    """2 grains of G = 2 on 4 x 32-row slabs of stripes of 16 (2 a shard at
    4 shards): bit-equal to one shard and to B1's plain version, and to the
    JAX package's make_advance_v4_sharded at its bar."""
    G, TX, nx, ny = 2, 16, 128, 128
    u = random_state(nx, ny)
    kw = dict(cs2=0.1, dtdx=0.2, dtdy=0.15, theta=1.8, TX=TX, rk_order=rk,
              riemann=riemann)
    ut = torch.tensor(u)
    runs = {}
    for k in (1, n_shards):
        devices = ["cpu"] * k
        adv = TS.make_advance_v4_sharded(devices, G=G, **kw)
        shards = TS.shard_state(ut, devices)
        assert [tuple(s.shape) for s in shards] == [(3, nx // k, ny)] * k
        runs[k] = TS.gather_state(adv(shards, 2 * G))
    assert torch.equal(runs[n_shards], runs[1])
    b1 = TK.advance_n_plain(ut, 2 * G, cs2=0.1, dtdx=0.2, dtdy=0.15,
                            theta=1.8, rk_order=rk, riemann=riemann)
    assert torch.equal(runs[1], b1)
    mesh = Mesh(np.array(jax.devices()[:n_shards]), ("x",))
    jadv = JS.make_advance_v4_sharded(mesh, G=G, interpret=True, **kw)
    want = jadv(JS.shard_state(jnp.asarray(u), mesh), 2 * G)
    np.testing.assert_allclose(runs[n_shards].numpy(), np.asarray(want),
                               **JAX_TOL)


def test_shard_state_and_gather_state_round_trip():
    u = torch.tensor(random_state(24, 8))
    shards = TS.shard_state(u, ["cpu"] * 3)
    assert torch.equal(TS.gather_state(shards), u)
    with pytest.raises(ValueError, match="do not split"):
        TS.shard_state(u, ["cpu"] * 5)
    adv = TS.make_advance_v4_sharded(["cpu"] * 3, G=2, cs2=1.0, dtdx=0.1,
                                     dtdy=0.1, TX=8)
    with pytest.raises(ValueError, match="multiple of G"):
        adv(shards, 3)


def read(path):
    with h5py.File(path, "r") as f:
        if "solution" in f:
            return {k: f["solution"][k][()] for k in f["solution"]}
        return {k: f[k][()] for k in f if k != "run_config"}


def test_cli_sharded_writes_the_jax_package_files(tmp_path):
    """kh N=128 shards=2 in both packages: the same files, the checkpoints'
    solutions, the diagnostics and the time series agreeing at kh's bars,
    the steps in grains of 4."""
    argv = ["kh", "N=128", "tfinal=0.01", "cpi=0.005", "dfi=0.01",
            "tsi=0.0025", "shards=2"]
    assert JKH.main(argv + [f"outdir={tmp_path / 'j'}"]) == 0
    assert TKH.main(argv + [f"outdir={tmp_path / 't'}", "precision=f64"],
                    device="cpu") == 0
    assert TKH.LAST_PATH == "sharded_b9[2dev]"
    files = set(os.listdir(tmp_path / "j"))
    assert files == set(os.listdir(tmp_path / "t"))
    assert {"chkpt.0002.h5", "diagnostics.0001.h5", "time_series.h5"} <= files
    for name in sorted(files):
        want, got = (read(tmp_path / d / name) for d in "jt")
        assert set(want) == set(got), name
        for key in want:
            assert np.shape(want[key]) == np.shape(got[key]), (name, key)
            # the vorticity differences the state over 2 dx: its round-off
            # is the state's times N
            bar = dict(SCHEME_TOL, atol=SCHEME_TOL["atol"] * 128) \
                if key == "vorticity" else SCHEME_TOL
            np.testing.assert_allclose(got[key], want[key], **bar,
                                       err_msg=f"{name} {key}")
        if "iteration" in want:
            assert got["iteration"] == want["iteration"]
            assert want["iteration"] % 4 == 0


def test_cli_shards_on_the_cpu(tmp_path):
    """python -m mara3_tpu_torch kh ... shards=4 with the CPU selector: four
    slabs share the CPU and the chunks run B9's plain version; the state
    ends where shards=1 ends, bit for bit."""
    env = {k: v for k, v in os.environ.items() if k != DEVICE_SELECTOR}
    env.update({"PYTHONPATH": REPO, DEVICE_SELECTOR: "cpu"})
    ends = {}
    for shards in (4, 1):
        out = tmp_path / str(shards)
        proc = subprocess.run(
            [sys.executable, "-m", "mara3_tpu_torch", "kh", "N=64",
             "tfinal=0.02", "cpi=0.02", "dfi=1", "tsi=1", f"outdir={out}",
             f"shards={shards}"], env=env, capture_output=True, text=True,
            timeout=300)
        assert proc.returncode == 0, proc.stderr
        assert f"[sharded_b9[{shards}dev]]" in proc.stdout
        ends[shards] = read(out / "chkpt.0001.h5")["conserved"]
    np.testing.assert_array_equal(ends[4], ends[1])


def test_shards_minus_one_is_one_shard_on_the_cpu():
    cfg = TKH.config_template().create().update({"N": "32", "shards": "-1"})
    _, devices, G = TKH.make_sharded_advance(cfg, 1e-3, "cpu")
    assert devices == [torch.device("cpu")] and G == 4
    cfg = cfg.update({"shards": "4"})
    assert len(TKH.make_sharded_advance(cfg, 1e-3, "cpu")[1]) == 4


def test_more_shards_than_cards_raise_on_cuda(monkeypatch):
    """As in the JAX package, shards > devices raises; shards=-1 takes
    every card (device_count mocked: no card is touched)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    cfg = TKH.config_template().create().update({"N": "64", "shards": "3"})
    with pytest.raises(ValueError, match="shards=3 but only 2 devices"):
        TKH.make_sharded_advance(cfg, 1e-3, "cuda")
    cfg = cfg.update({"shards": "-1"})
    _, devices, _ = TKH.make_sharded_advance(cfg, 1e-3, "cuda")
    assert devices == [torch.device("cuda", 0), torch.device("cuda", 1)]


@pytest.mark.parametrize("over,match", [
    ({"N": "30", "shards": "4"}, "not divisible"),
    ({"N": "64", "shards": "4", "rk_order": "2"}, "use fewer shards"),
])
def test_shard_rules_that_change_what_runs_are_kept(over, match):
    """N must split into the shards, and a stripe must hold the halo of a
    grain (2 G rk_order rows), as in kh.py:255-268; N % 128 (a TPU layout
    rule) is dropped: N=64 shards=4 runs with rk_order=1."""
    cfg = TKH.config_template().create().update(over)
    with pytest.raises(ValueError, match=match):
        TKH.make_sharded_advance(cfg, 1e-3, "cpu")
