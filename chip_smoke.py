#!/usr/bin/env python3
"""Chip smoke test: the PyTorch port's flagship paths on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX. Phases, each of which raises on failure (the script then
exits non-zero and prints no result):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit;
2. build: compiles mara3_tpu_torch/csrc/binary_advance.cu (kernel B2) and
   binary_multi.cu (kernel B3), one nvcc each, started together;
3. B2 parity: kernel B2 against its plain PyTorch version on the card, at
   depth 3 / block 16 over {conserve_linear_p} x {hlle, hllc} x {plm, pcm}
   and at the main path's shape (depth 6 / block 96), each in float64 at
   the CPU parity bars and in float32 at 64 ulps of each cell's largest
   component, element by element; at d6b96 float32 it also times both;
4. B2's device-parameter entry (dt, theta and the bodies read from device
   memory, as the device-resident step runs it) against its host entry:
   bitwise, in float64 and float32;
5. B3 parity: kernel B3 against advance_k_plain on the card at depth 3 /
   block 16, 4 steps per launch, over the 8 configurations above x
   rk_order {1, 2} x live binary {off, on}, float64 at the CPU bars and
   float32 at 64 k ulps of each cell; then depth 6 / block 96, 16 RK2
   steps, in float64 and float32;
6. slice: two RK2 steps through the port's next_solution, kernel on the
   card against the plain version on the CPU, float64, depth 3 / block 16;
7. fast vs reference: 35 steps of make_multi_scan (B3 launches of 16, 16
   and 3 steps), and 3 steps of the per-step scan (B2), each against as
   many steps of next_solution (the reference-shaped step, B2), at d6b96
   float64, at the JAX package's host-vs-fast bar;
8. reference loop: ``binary depth=6 block_size=96 fast_step=0`` through the
   port's setup() and run() for as many RK2 steps as the main path, every
   B2 launch counted (the first slice's main path);
9. main path: ``binary depth=6 block_size=96`` with the defaults (fast_step
   and multi_launch auto: the device-resident loop, up to 16 steps per B3
   launch) through setup() and run() for about 96 steps (``--steps N`` for
   about N), every B3 and B2 launch counted; prints both loops' whole-run
   rates (steps x zones / wall seconds);
10. timing at d6b96 float32, in turns on the card (plain, kernel, kernel,
   plain): one B3 launch of 16 RK2 steps, 16 steps of the per-step scan
   (B2), and advance_k_plain over 16 steps;

then prints one JSON line describing the kernels and, last, the ok line.
``--profile PATH`` also writes torch.profiler tables of a d6b96 B2 advance,
a reference-loop step, a B3 launch and a 64-step chunk of the fast loop to
PATH, with the device's busy share of the step and of the chunk.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json
import math
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from dataclasses import replace

HERE = os.path.dirname(os.path.abspath(__file__))

MATRIX = [{"conserve_linear_p": cp, "riemann": rs, "reconstruct_method": rm}
          for cp in (1, 0) for rs in ("hlle", "hllc") for rm in ("plm", "pcm")]
# float64 bars: those of the CPU parity tests (tests/test_torch_*.py)
F64_U = dict(rtol=1e-12, atol=1e-20)
F64_TOTALS = dict(rtol=1e-10, atol=1e-17)
# float32: the kernels round every operation as the plain versions do
# (built with --fmad=false) but their sqrt/exp/pow may differ by an ulp and
# they sum the totals in another order (in float64). So each element of the
# state is held to 64 ulps of its cell's largest component per advance (a
# cell's momenta may cross zero, its density may not), with an atol far
# below the disk's ambient density (about 1.5e-9); the totals at 1e-4
# relative
F32_ULPS = 64
F32_ATOL = 1e-20
F32_TOTALS = dict(rtol=1e-4, atol=1e-12)
# B3's element rows: float64 at the JAX multi-step test's element bar;
# float32 at a few ulps of elements of order one (the perturbations are
# differences of such elements)
F64_ELEMENTS = dict(rtol=1e-6, atol=1e-9)
F32_ELEMENTS = dict(rtol=1e-3, atol=1e-5)
# phase 7's step counts: a multi scan with a remainder launch, and a few
# steps of the per-step scan
MULTI_STEPS = 35
SCAN_STEPS = 3
# the JAX package's host-vs-fast bar (tests/test_binary_fast_step.py:19-40):
# the host step solves Kepler's equation to a tolerance, the fast one by a
# fixed count of Newton updates
FAST_U = dict(rtol=1e-9, atol=1e-12)
FAST_TOTALS = dict(rtol=1e-7, atol=1e-15)

# The least time the card could take (H100 SXM at 700 W): the bytes over
# 3.35 TB/s or the operations over the float32 rate, whichever is longer.
# Bytes: an advance must read the state, initial_conserved and buffer_rate
# and write the state, 10 values per cell; B3 does so once per launch.
# Operations: counted by hand from csrc/binary_advance_core.cuh and
# csrc/binary_multi.cu for the main path's configuration (PLM, HLLE,
# conserve_linear_p=1, alpha viscosity without a cutoff). An add, subtract,
# multiply, divide, min, max, abs, sqrt, exp or pow counts one; compares,
# selects, index arithmetic, conversions and the float64 sums of the totals
# count none, so the count errs low, and the bound with it.
#   recover_at    2 per cell and stage (two divides)
#   slopes_at   108 per cell and stage (six plm() of 17, each / spacing)
#   update_at   130 per cell and stage (divergence 9, gravity and sinks 48,
#                   buffer and floor 29, the update 12, totals 31, dA 1)
#   face_at     113 per face and stage (face states 18, cs2_at 18, r 4,
#                   nu 5, mu 3, conserved states 4, HLLE 44, viscous
#                   stress 14, face length 3); 2 (bs + 1) bs faces a block
#   the CFL      25 per cell and step (cs2_at 18, wavespeed 6, divide 1)
#   RK2 average   9 per cell and step
# The 67 TFLOP/s float32 peak counts an FMA as two operations. Built with
# --fmad=false, the kernels issue none, so their peak is half of it: one
# operation per lane and cycle, 33.5e12 a second.
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12 / 2
VALUES_PER_CELL = 10
OPS_CELL_STAGE = 2 + 108 + 130
OPS_FACE_STAGE = 113
OPS_CELL_RK2_STEP = 25 + 9


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def allclose(a, b, rtol, atol):
    import numpy as np
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def cell_bar(u, u_ref, dtype, ulps):
    """(max |du|, max |du| in ulps of its cell's largest component), raising
    past the float64 parity bar, or past `ulps` ulps of the cell in
    float32."""
    import numpy as np
    import torch
    u, u_ref = u.double().cpu().numpy(), u_ref.double().cpu().numpy()
    diff = np.abs(u - u_ref)
    err = float(diff.max())
    ulp = np.finfo(str(dtype)[6:]).eps * np.abs(u_ref).max(axis=-1,
                                                           keepdims=True)
    in_ulps = float((diff / ulp).max())
    if dtype == torch.float64:
        check(allclose(u, u_ref, **F64_U), f"f64 state off by {err:.3e}")
    else:
        check(bool(np.all(diff <= ulps * ulp + F32_ATOL)),
              f"f32 state off by {in_ulps:.1f} ulps of its cell")
    return err, in_ulps


def compare(got, want, dtype):
    """Kernel B2's (u1, totals, invalid) against the plain version's."""
    import numpy as np
    import torch
    u1, tot, inv = got
    u1r, totr, invr = want
    err, ulps = cell_bar(u1, u1r, dtype, F32_ULPS)
    bars = F64_TOTALS if dtype == torch.float64 else F32_TOTALS
    for k in totr:
        a = tot[k].double().cpu().numpy()
        b = totr[k].double().cpu().numpy()
        check(allclose(a, b, **bars), f"total {k}: {a} vs {b}")
    check(bool(inv) == bool(invr), "fault flags differ")
    return err, ulps


def compare_multi(got, want, dtype, k):
    """Kernel B3's (state, rows) against advance_k_plain's: the state, dt,
    the stage times, the fault flags, the totals (the work done among them)
    and the element rows."""
    import torch
    from mara3_tpu_torch.kernels import binary_multi as TM
    (u, rows), (u_ref, rows_ref) = got, want
    err, ulps = cell_bar(u, u_ref, dtype, F32_ULPS * k)
    rows, rows_ref = rows.cpu().numpy(), rows_ref.cpu().numpy()
    f64 = dtype == torch.float64
    rtol = 1e-12 if f64 else 1e-5
    for r in (TM.ROW_DT, TM.ROW_TPREV):
        check(allclose(rows[:, r, 0], rows_ref[:, r, 0], rtol, 0.0),
              f"row {r} (dt or time) differs")
    check(bool((rows[:, TM.ROW_INVALID, 0]
                == rows_ref[:, TM.ROW_INVALID, 0]).all()),
          "fault flags differ")
    check(allclose(rows[:, :9], rows_ref[:, :9],
                   **(F64_TOTALS if f64 else F32_TOTALS)), "totals differ")
    check(allclose(rows[:, TM.ROW_DACC:], rows_ref[:, TM.ROW_DACC:],
                   **(F64_ELEMENTS if f64 else F32_ELEMENTS)),
          "live element rows differ")
    return err, ulps


def seeded_case(TB, over, device, dtype, seed=0):
    import numpy as np
    import torch
    cfg = TB.create_config_template().create().update(over)
    sd = TB.create_solver_data(cfg, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    noise = torch.as_tensor(
        1.0 + 0.05 * rng.uniform(-1, 1, tuple(sd.initial_conserved.shape)),
        dtype=dtype, device=device)
    u0 = (sd.initial_conserved * noise).contiguous()
    bodies = TB.bodies_array(TB.two_body.compute_two_body_state(
        TB.two_body.make_full_orbital_elements(TB.create_binary_params(cfg)),
        0.7))
    return sd, u0, bodies, sd.recommended_time_step


def multi_case(TB, over, device, dtype, k, live, seed=0):
    """(tables, state, elements, start time, launch config) of a seeded
    K-step case of an eccentric binary (the element rows of a near-circular
    one are ill-conditioned), live from t = 0 when `live`."""
    import numpy as np
    import torch
    from mara3_tpu_torch.models import two_body_device as tbd
    from mara3_tpu_torch.schemes import binary_step as TS
    over = {**over, "eccentricity": 0.3}
    if live:
        over["begin_live_binary"] = 0.0
    cfg = TB.create_config_template().create().update(over)
    sd = TB.create_solver_data(cfg, device=device, dtype=dtype)
    rng = np.random.default_rng(seed)
    noise = torch.as_tensor(
        1.0 + 0.01 * rng.uniform(-1, 1, tuple(sd.initial_conserved.shape)),
        dtype=dtype, device=device)
    u0 = (sd.initial_conserved * noise).contiguous()
    e10 = tbd.pack_elements(TB.create_solution(cfg, sd).orbital_elements,
                            dtype, device)
    t0 = torch.tensor(0.7, dtype=dtype, device=device)
    return sd.advance.tables, u0, e10, t0, TS.multi_config(sd, k)


def time_ms(fn, reps):
    """Mean device time of fn() over reps calls, by CUDA events."""
    import torch
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / reps


def in_turns(plain, kernel, plain_reps, kernel_reps):
    """(kernel ms, plain ms, the four runs): plain, kernel, kernel, plain
    on one card, the best of each pair."""
    p1, k1, k2, p2 = (time_ms(plain, plain_reps), time_ms(kernel, kernel_reps),
                      time_ms(kernel, kernel_reps), time_ms(plain, plain_reps))
    return min(k1, k2), min(p1, p2), (p1, k1, k2, p2)


def stage_ops(u):
    """Floating-point operations of one flagship stage on the state u
    [B, bs, bs, 3] (the count above the constants)."""
    B, bs = u.shape[0], u.shape[1]
    return B * bs * bs * OPS_CELL_STAGE + 2 * B * (bs + 1) * bs * OPS_FACE_STAGE


def bound(u, ops):
    """(ms, "bytes" or "operations"): the least time the card could take
    for `ops` operations (at the float32 rate) on the state u, moving the
    state, initial_conserved and buffer_rate once."""
    cells = u.shape[0] * u.shape[1] * u.shape[2]
    t_bytes = VALUES_PER_CELL * cells * u.element_size() / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def profile_table(fn, reps):
    """(table, device-busy us per call, device kernels per call) of reps
    calls of fn under torch.profiler; busy is the sum of the kernels'
    device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    # acc_events: keep every event of the window (without it the profiler
    # dropped one of a 64-step chunk's four B3 launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]
    busy = sum(e.self_device_time_total for e in kernels)
    return (events.table(sort_by="cuda_time_total", row_limit=30),
            busy / reps, sum(e.count for e in kernels) / reps)


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def record_only(TB):
    """A task runner that records the time series and writes no files (the
    card's machine has no h5py)."""
    def tasks(state, sd_):
        if state.schedule.is_due("record_time_series"):
            state = TB.record_time_series(state, sd_)
        for task in ("write_checkpoint", "write_diagnostics"):
            if state.schedule.is_due(task):
                state = replace(state, schedule=state.schedule
                                   .mark_as_completed(task))
        return state
    return tasks


def drive(TB, argv, steps, device, outdir):
    """setup() and run() of `argv` cut to about `steps` steps: (cfg, sd,
    final state, log, wall seconds)."""
    import torch
    cfg, sd, state = TB.setup(argv + [f"outdir={outdir}"], device=device,
                              dtype=torch.float32)
    bodies = TB.bodies_array(TB.two_body.compute_two_body_state(
        state.solution.orbital_elements, 0.0))
    dt0 = sd.cfl_number * float(sd.maximum_timestep(
        state.solution.conserved, bodies))
    cfg = cfg.set("tfinal", (steps - 0.5) * dt0 / (2 * math.pi))
    state = replace(state, run_config=cfg)
    print(f"{argv[1:]}: tfinal={cfg.get_double('tfinal'):.6e} orbits "
          f"(about {steps} steps of dt {dt0:.6e})")
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        final = TB.run(cfg, sd, state, tasks=record_only(TB))
    torch.cuda.synchronize()
    return cfg, sd, final, tee.buf.getvalue(), time.perf_counter() - t0


def whole_run_kzps(final, wall):
    """Thousands of zone updates a second over a whole run: its steps times
    its zones over its wall seconds."""
    u = final.solution.conserved
    zones = u.shape[0] * u.shape[1] * u.shape[2]
    return final.solution.iteration * zones / wall / 1e3


def check_final(final, sd, log, retry_notice):
    """The run's end: the state's shape, finite values, positive density,
    a time series; returns (kzps values, retries, min density)."""
    import torch
    u = final.solution.conserved
    bs = sd.cfg_scheme.block_size
    check(tuple(u.shape) == (len(sd.leaves), bs, bs, 3),
          f"state shape {tuple(u.shape)}")
    check(bool(torch.isfinite(u).all()), "non-finite state")
    check(bool((u[..., 0] > 0).all()), "non-positive density")
    check(len(final.time_series) >= 1, "no time series recorded")
    rates = [float(x) for x in re.findall(r"kzps=([0-9.]+)", log)]
    check(len(rates) >= 2, "the loop printed fewer than 2 kzps")
    return rates, log.count(retry_notice), float(u[..., 0].min())


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="also write torch.profiler tables to PATH")
    ap.add_argument("--steps", type=int, default=96,
                    help="about how many RK2 steps each loop runs")
    args = ap.parse_args(argv)

    # ---- phase 1: device ---------------------------------------------------
    if not os.path.isdir(os.path.join(HERE, "mara3_tpu_torch")):
        raise PhaseError("mara3_tpu_torch/ is not beside chip_smoke.py: run "
                         "from the root of a checkout")
    sys.path.insert(0, HERE)
    import numpy as np
    import torch
    check(torch.cuda.is_available(), "torch.cuda.is_available() is false")
    device = torch.device("cuda")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(smi)
    name = torch.cuda.get_device_name(0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- phase 2: build ----------------------------------------------------
    from mara3_tpu_torch.kernels import _build
    from mara3_tpu_torch.kernels import binary_advance as TK
    from mara3_tpu_torch.kernels import binary_multi as TM
    from mara3_tpu_torch.schemes import binary_step as TS
    from mara3_tpu_torch.subprograms import binary as TB
    sources = ("binary_advance", "binary_multi")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(_build.build, sources))
    for src in sources:
        _build.load(src)
    print(f"build: {', '.join(s + '.cu' for s in sources)} in "
          f"{time.perf_counter() - t0:.1f} s ("
          + ", ".join(_build.library_path(s).name for s in sources) + ")")

    # ---- phase 3: B2 against its plain version -----------------------------
    for dtype in (torch.float64, torch.float32):
        worst = (0.0, 0.0)
        for over in MATRIX:
            sd, u0, bodies, dt = seeded_case(
                TB, {"depth": 3, "block_size": 16, "density_floor": 1e-3,
                     **over}, device, dtype)
            t = sd.advance.tables
            got = TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
            torch.cuda.synchronize()
            worst = tuple(map(max, worst, compare(
                got, TK.advance_plain(t, u0, bodies, dt, sd.plm_theta),
                dtype)))
        print(f"B2 parity d3b16 {str(dtype)[6:]}: {len(MATRIX)} configs "
              f"pass, max |du1| {worst[0]:.3e} ({worst[1]:.2f} ulps of its "
              f"cell)")

    # float32 last: the main path's dtype, which is then timed
    for dtype in (torch.float64, torch.float32):
        sd, u0, bodies, dt = seeded_case(
            TB, {"depth": 6, "block_size": 96}, device, dtype)
        t = sd.advance.tables
        got = TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
        torch.cuda.synchronize()
        b2_err, ulps = compare(
            got, TK.advance_plain(t, u0, bodies, dt, sd.plm_theta), dtype)
        print(f"B2 parity d6b96 {str(dtype)[6:]}: max |du1| {b2_err:.3e} "
              f"({ulps:.2f} ulps of its cell)")
    kernel = lambda: TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
    plain = lambda: TK.advance_plain(t, u0, bodies, dt, sd.plm_theta)
    b2_ms, b2_plain_ms, runs = in_turns(plain, kernel, 5, 50)
    zones = u0.shape[0] * u0.shape[1] * u0.shape[2]
    b2_bound = bound(u0, stage_ops(u0))
    print(f"time d6b96 float32: B2 advance {b2_ms:.4f} ms kernel vs "
          f"{b2_plain_ms:.4f} ms plain (runs " + " ".join(
              f"{r:.4f}" for r in runs) + f"); {zones} zones; bound "
          f"{b2_bound[0]:.4f} ms ({b2_bound[1]})")
    if args.profile:
        table, busy, _ = profile_table(kernel, 5)
        with open(args.profile, "w") as f:
            f.write(f"{smi}\nkernel B2 advance, d6b96 float32: "
                    f"{busy:.1f} us of kernels per advance\n{table}\n")
        print(f"profile: B2 advance {busy:.1f} us of kernels per advance")
    del sd, u0, got, t

    # ---- phase 4: B2's device-parameter entry ------------------------------
    for dtype in (torch.float64, torch.float32):
        for depth, bs in ((3, 16), (6, 96)):
            sd, u0, bodies, dt = seeded_case(
                TB, {"depth": depth, "block_size": bs,
                     "conserve_linear_p": 0}, device, dtype)
            t = sd.advance.tables
            host = TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
            dev = TK.advance_cuda(
                t, u0, torch.as_tensor(bodies, device=device),
                torch.tensor(dt, dtype=dtype, device=device), sd.plm_theta)
            check(torch.equal(host[0], dev[0])
                  and all(torch.equal(host[1][k], dev[1][k])
                          for k in host[1])
                  and bool(host[2]) == bool(dev[2]),
                  f"B2 device entry differs from host entry d{depth}b{bs}")
    print("B2 device-parameter entry: bitwise equal to the host entry "
          "(d3b16, d6b96; float64, float32)")
    del sd, u0, t, host, dev

    # ---- phase 5: B3 against its plain version -----------------------------
    for dtype in (torch.float64, torch.float32):
        worst, cases = (0.0, 0.0), 0
        for over in MATRIX:
            for rk in (1, 2):
                for live in (False, True):
                    args_ = multi_case(
                        TB, {"depth": 3, "block_size": 16, "rk_order": rk,
                             "density_floor": 1e-3, **over},
                        device, dtype, 4, live)
                    got = TM.advance_k_cuda(*args_)
                    torch.cuda.synchronize()
                    worst = tuple(map(max, worst, compare_multi(
                        got, TM.advance_k_plain(*args_), dtype, 4)))
                    cases += 1
        print(f"B3 parity d3b16 k=4 {str(dtype)[6:]}: {cases} cases pass, "
              f"max |du| {worst[0]:.3e} ({worst[1]:.2f} ulps of its cell)")
    b3 = {}
    for dtype in (torch.float64, torch.float32):
        args_ = multi_case(TB, {"depth": 6, "block_size": 96}, device, dtype,
                           16, False)
        got = TM.advance_k_cuda(*args_)
        torch.cuda.synchronize()
        b3_err, ulps = compare_multi(got, TM.advance_k_plain(*args_), dtype,
                                     16)
        print(f"B3 parity d6b96 k=16 rk2 {str(dtype)[6:]}: max |du| "
              f"{b3_err:.3e} ({ulps:.2f} ulps of its cell); a grid of "
              f"{TM.grid_size(dtype)} CTAs of 256 threads")
    b3["args"] = args_
    del got

    # ---- phase 6: two RK2 steps, card against CPU --------------------------
    over = {"depth": 3, "block_size": 16}
    cfg = TB.create_config_template().create().update(over)
    sols = []
    for dev_ in (device, torch.device("cpu")):
        sd_ = TB.create_solver_data(cfg, device=dev_, dtype=torch.float64)
        s = TB.create_solution(cfg, sd_)
        for _ in range(2):
            s = TB.next_solution(s, sd_)
        sols.append(TB.solution_to_arrays(s))
    gpu, cpu = sols
    check(allclose(gpu["conserved"], cpu["conserved"], 1e-11, 1e-20),
          "two steps on the card differ from the CPU")
    for key in ("mass_accreted_on", "integrated_torque_on", "work_done_on",
                "mass_ejected"):
        check(allclose(np.asarray(gpu[key]), np.asarray(cpu[key]), 1e-10,
                       1e-17), f"{key} differs between card and CPU")
    print("slice d3b16 float64: 2 RK2 steps on the card match the CPU "
          "(conserved rtol 1e-11, totals rtol 1e-10)")

    # ---- phase 7: the fast path against the reference-shaped step ----------
    cfg = TB.create_config_template().create().update(
        {"depth": 6, "block_size": 96})
    sd = TB.create_solver_data(cfg, device=device, dtype=torch.float64)
    sol = TB.create_solution(cfg, sd)
    s0 = TS.solution_to_arrays(sol)
    before = TM.advance_k_cuda.launches
    multi, _ = TS.make_multi_scan(sd, 16)(s0, MULTI_STEPS)
    check(TM.advance_k_cuda.launches - before == 3,
          f"{MULTI_STEPS} steps took {TM.advance_k_cuda.launches - before} "
          f"B3 launches, not 3")
    per_step, _ = TS.make_fast_scan(sd)(s0, SCAN_STEPS)
    refs = {}
    for i in range(MULTI_STEPS):
        sol = TB.next_solution(sol, sd)
        refs[i + 1] = sol
    fast_err = {}
    for label, got, n in (("multi scan", multi, MULTI_STEPS),
                          ("per-step scan", per_step, SCAN_STEPS)):
        got, want = TS.arrays_to_solution(got, TB.Solution), refs[n]
        u, u_ref = got.conserved.cpu().numpy(), want.conserved.cpu().numpy()
        check(got.iteration == want.iteration == n,
              f"{label}: iteration counts differ")
        check(allclose(np.asarray(got.time), np.asarray(want.time),
                       FAST_U["rtol"], 0.0), f"{label}: times differ")
        check(allclose(u, u_ref, **FAST_U),
              f"{label}: state differs from next_solution's")
        for key in ("mass_accreted_on", "angular_momentum_accreted_on",
                    "integrated_torque_on", "work_done_on"):
            check(allclose(np.asarray(getattr(got, key)),
                           np.asarray(getattr(want, key)), **FAST_TOTALS),
                  f"{label}: {key} differs")
        fast_err[label] = float(np.abs(u - u_ref).max())
    print(f"fast vs reference d6b96 float64: {MULTI_STEPS} steps of the "
          f"multi scan (B3 launches of 16, 16, 3) max |du| "
          f"{fast_err['multi scan']:.3e}; {SCAN_STEPS} steps of the "
          f"per-step scan (B2) max |du| {fast_err['per-step scan']:.3e}; "
          f"each against as many next_solution steps (bar rtol "
          f"{FAST_U['rtol']}, atol {FAST_U['atol']})")
    del sd, sol, refs, multi, per_step, got, want, u, u_ref

    with tempfile.TemporaryDirectory() as outdir:
        # ---- phase 8: the reference-shaped loop ----------------------------
        TK.advance_cuda.launches = TM.advance_k_cuda.launches = 0
        _, sd, final, log, wall = drive(
            TB, ["binary", "depth=6", "block_size=96", "fast_step=0"],
            args.steps, device, outdir)
        ref_b2, ref_b3 = TK.advance_cuda.launches, TM.advance_k_cuda.launches
        steps = final.solution.iteration
        rates, retries, min_rho = check_final(
            final, sd, log, "negative density in updated state")
        check(ref_b3 == 0, f"{ref_b3} B3 launches on the fast_step=0 loop")
        check(ref_b2 >= 2 * steps, f"{ref_b2} B2 launches, {steps} steps")
        ref_rate = whole_run_kzps(final, wall)
        print(f"reference loop: {steps} steps, {ref_b2} B2 launches, "
              f"{retries} retries, {wall:.4f} s wall, whole-run "
              f"{ref_rate:.2f} kzps; kzps median "
              f"{statistics.median(rates):.2f}")
        if args.profile:
            held = {"s": final.solution}

            def step():
                held["s"] = TB.next_solution(held["s"], sd)

            step_ms = time_ms(step, 5)
            table, busy, _ = profile_table(step, 3)
            with open(args.profile, "a") as f:
                f.write(f"d6b96 float32 RK2 step (next_solution): "
                        f"{step_ms:.4f} ms per step, {busy:.1f} us of "
                        f"kernels per step\n{table}\n")
            print(f"profile: reference step {step_ms:.4f} ms, kernels "
                  f"{busy / 1e3:.4f} ms ({100 * busy / 1e3 / step_ms:.1f}% "
                  f"busy)")

        # ---- phase 9: the main path ----------------------------------------
        TK.advance_cuda.launches = TM.advance_k_cuda.launches = 0
        cfg, sd, final, log, wall = drive(
            TB, ["binary", "depth=6", "block_size=96"], args.steps, device,
            outdir)
        b2_launches = TK.advance_cuda.launches
        b3_launches = TM.advance_k_cuda.launches
    check(cfg.get_int("fast_step") == 1 and cfg.get_int("multi_launch") == 16,
          "fast_step/multi_launch did not resolve to 1/16 on the card")
    steps = final.solution.iteration
    rates, retries, min_rho = check_final(final, sd, log,
                                          "step retried in safe mode")
    check(b3_launches >= 3, f"only {b3_launches} B3 launches")
    check(b2_launches == retries, f"{b2_launches} B2 launches on the main "
          f"path for {retries} safe-mode retries")
    deciles = statistics.quantiles(rates, n=10)
    main_rate = whole_run_kzps(final, wall)
    print(f"main path: {steps} steps, {b3_launches} B3 launches (up to 16 "
          f"steps each), {b2_launches} B2 launches, {retries} retries, "
          f"{len(sd.leaves)} blocks of 96x96, {wall:.4f} s wall, "
          f"{len(final.time_series)} time-series samples, min density "
          f"{min_rho:.6e}; whole-run {main_rate:.2f} kzps against the "
          f"reference loop's {ref_rate:.2f} ({main_rate / ref_rate:.3f}x); "
          f"per-chunk kzps median {statistics.median(rates):.2f}, p10 "
          f"{deciles[0]:.2f}, p90 {deciles[-1]:.2f} on {smi}")

    # ---- phase 10: timing at d6b96 float32 ---------------------------------
    t, u0, e10, t0, mc = b3["args"]
    k_zones = u0.shape[0] * u0.shape[1] * u0.shape[2]
    kernel = lambda: TM.advance_k_cuda(t, u0, e10, t0, mc)
    plain = lambda: TM.advance_k_plain(t, u0, e10, t0, mc)
    b3_ms, b3_plain_ms, runs = in_turns(plain, kernel, 1, 5)
    s0 = TS.solution_to_arrays(TB.create_solution(cfg, sd))
    per_step = TS.make_fast_scan(sd)
    scan_ms = min(time_ms(lambda: per_step(s0, 16), 2) for _ in range(2))
    b3_ops = 16 * (2 * stage_ops(u0) + k_zones * OPS_CELL_RK2_STEP)
    b3_bound = bound(u0, b3_ops)
    print(f"time d6b96 float32, 16 RK2 steps: B3 launch {b3_ms:.4f} ms, "
          f"per-step scan (B2) {scan_ms:.4f} ms, advance_k_plain "
          f"{b3_plain_ms:.4f} ms (runs " + " ".join(f"{r:.4f}" for r in runs)
          + f"); bound {b3_bound[0]:.4f} ms ({b3_bound[1]}, {b3_ops:.4e} "
          f"operations; B2 advance bound {b2_bound[0]:.4f} ms, "
          f"{b2_bound[1]})")
    if args.profile:
        table, busy, _ = profile_table(kernel, 2)
        step_ms = time_ms(lambda: per_step(s0, 1), 5)
        stable, sbusy, slaunch = profile_table(lambda: per_step(s0, 1), 3)
        multi = TS.make_multi_scan(sd, 16)
        held = {"s": TS.solution_to_arrays(final.solution)}

        def chunk():
            held["s"], rows = multi(held["s"], 64)
            rows.cpu()

        chunk()
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        chunk()
        chunk_ms = (time.perf_counter() - c0) * 1e3
        ctable, cbusy, _ = profile_table(chunk, 1)
        with open(args.profile, "a") as f:
            f.write(f"kernel B3, one launch of 16 RK2 steps, d6b96 float32: "
                    f"{busy:.1f} us of kernels per launch\n{table}\n"
                    f"per-step scan, one RK2 step, d6b96 float32: "
                    f"{step_ms:.4f} ms, {sbusy:.1f} us of kernels in "
                    f"{slaunch:.0f} kernel launches\n{stable}\n"
                    f"fast loop, a 64-step chunk (4 B3 launches), d6b96 "
                    f"float32: {chunk_ms:.4f} ms wall, {cbusy:.1f} us of "
                    f"kernels\n{ctable}\n")
        print(f"profile: per-step scan {step_ms:.4f} ms a step, kernels "
              f"{sbusy / 1e3:.4f} ms in {slaunch:.0f} launches "
              f"({100 * sbusy / 1e3 / step_ms:.1f}% busy)")
        print(f"profile: B3 launch {busy / 1e3:.4f} ms of kernels; fast "
              f"loop 64-step chunk {chunk_ms:.4f} ms wall, kernels "
              f"{cbusy / 1e3:.4f} ms ({100 * cbusy / 1e3 / chunk_ms:.1f}% "
              f"busy)")

    print(json.dumps({"kernels": [
        {"name": "binary_advance (B2)", "route": "cuda",
         "source": "mara3_tpu_torch/csrc/binary_advance.cu",
         "replaces": "mara3_tpu/kernels/binary_advance.py:678",
         "launches": ref_b2, "max_abs_err": b2_err,
         "ms": b2_ms, "plain_ms": b2_plain_ms, "bound_ms": b2_bound[0],
         "bound_by": b2_bound[1], "library_ms": None},
        {"name": "binary_multi (B3)", "route": "cuda",
         "source": "mara3_tpu_torch/csrc/binary_multi.cu",
         "replaces": "mara3_tpu/kernels/binary_multi.py:860",
         "launches": b3_launches, "max_abs_err": b3_err,
         "ms": b3_ms, "plain_ms": b3_plain_ms, "bound_ms": b3_bound[0],
         "bound_by": b3_bound[1], "library_ms": None}]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    try:
        sys.exit(main())
    except PhaseError as e:
        print(f"chip_smoke: FAILED: {e}", file=sys.stderr)
        sys.exit(1)
