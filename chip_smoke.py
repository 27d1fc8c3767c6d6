#!/usr/bin/env python3
"""Chip smoke test: the PyTorch port's flagship path on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX. Phases, each of which raises on failure (the script then
exits non-zero and prints no result):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit;
2. build: compiles mara3_tpu_torch/csrc/*.cu with nvcc (kernel B2);
3. parity: kernel B2 against its plain PyTorch version on the card, at
   depth 3 / block 16 over {conserve_linear_p} x {hlle, hllc} x {plm, pcm}
   and at the main path's shape (depth 6 / block 96), each in float64 at
   the CPU parity bars and in float32 at 64 ulps of each cell's largest
   component, element by element; at d6b96 float32 it also times both;
4. slice: two RK2 steps through the port's next_solution, kernel on the
   card against the plain version on the CPU, float64, depth 3 / block 16;
5. main path: ``binary depth=6 block_size=96 fast_step=0`` through the
   port's setup() and run() for about 10 RK2 steps (``--steps N`` for
   about N), with every B2 launch counted;

then prints one JSON line describing the kernels and, last, the ok line.
``--profile PATH`` also writes torch.profiler tables of the d6b96 advance
and of a d6b96 step to PATH, with the device's busy share of a step.
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
from dataclasses import replace

HERE = os.path.dirname(os.path.abspath(__file__))

MATRIX = [{"conserve_linear_p": cp, "riemann": rs, "reconstruct_method": rm}
          for cp in (1, 0) for rs in ("hlle", "hllc") for rm in ("plm", "pcm")]
# float64 bars: those of the CPU parity tests (tests/test_torch_*.py)
F64_U = dict(rtol=1e-12, atol=1e-20)
F64_TOTALS = dict(rtol=1e-10, atol=1e-17)
# float32: the kernel rounds every operation as the plain version does
# (built with --fmad=false) but its sqrt/exp/pow may differ by an ulp and it
# sums the totals in another order (in float64). So each element of u1 is
# held to 64 ulps of its cell's largest component (a cell's momenta may
# cross zero, its density may not), with an atol far below the disk's
# ambient density (about 1.5e-9); the totals at 1e-4 relative
F32_ULPS = 64
F32_ATOL = 1e-20
F32_TOTALS = dict(rtol=1e-4, atol=1e-12)


class PhaseError(RuntimeError):
    pass


def check(cond, msg):
    if not cond:
        raise PhaseError(msg)


def allclose(a, b, rtol, atol):
    import numpy as np
    return bool(np.all(np.abs(a - b) <= atol + rtol * np.abs(b)))


def compare(got, want, dtype):
    """(max |du1|, max |du1| in ulps of its cell's largest component) of a
    kernel result against the plain one, raising past the dtype's bar."""
    import numpy as np
    import torch
    u1, tot, inv = got
    u1r, totr, invr = want
    u1, u1r = u1.double().cpu().numpy(), u1r.double().cpu().numpy()
    diff = np.abs(u1 - u1r)
    err = float(diff.max())
    ulp = np.finfo(str(dtype)[6:]).eps * np.abs(u1r).max(axis=-1,
                                                         keepdims=True)
    ulps = float((diff / ulp).max())
    if dtype == torch.float64:
        check(allclose(u1, u1r, **F64_U), f"f64 u1 off by {err:.3e}")
        bars = F64_TOTALS
    else:
        check(bool(np.all(diff <= F32_ULPS * ulp + F32_ATOL)),
              f"f32 u1 off by {ulps:.1f} ulps of its cell")
        bars = F32_TOTALS
    for k in totr:
        a = tot[k].double().cpu().numpy()
        b = totr[k].double().cpu().numpy()
        check(allclose(a, b, **bars), f"total {k}: {a} vs {b}")
    check(bool(inv) == bool(invr), "fault flags differ")
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


def profile_table(fn, reps):
    """(table, device-busy us per call) of reps calls of fn under
    torch.profiler; busy is the sum of the kernels' device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    busy = sum(e.self_device_time_total for e in events
               if e.device_type == DeviceType.CUDA)
    return (events.table(sort_by="cuda_time_total", row_limit=30),
            busy / reps)


class Tee(io.TextIOBase):
    """Writes to the real stdout and keeps a copy."""

    def __init__(self, out):
        self.out, self.buf = out, io.StringIO()

    def write(self, s):
        self.buf.write(s)
        return self.out.write(s)

    def flush(self):
        self.out.flush()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--profile", metavar="PATH",
                    help="also write torch.profiler tables of the d6b96 "
                         "advance and step to PATH")
    ap.add_argument("--steps", type=int, default=10,
                    help="about how many RK2 steps the main path runs")
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
    from mara3_tpu_torch.subprograms import binary as TB
    t0 = time.perf_counter()
    _build.load("binary_advance")
    print(f"build: binary_advance.cu in {time.perf_counter() - t0:.1f} s "
          f"({_build.library_path('binary_advance').name})")

    # ---- phase 3: kernel vs plain on the card -------------------------------
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
        print(f"parity d3b16 {str(dtype)[6:]}: {len(MATRIX)} configs pass, "
              f"max |du1| {worst[0]:.3e} ({worst[1]:.2f} ulps of its cell)")

    # float32 last: the main path's dtype, which is then timed
    for dtype in (torch.float64, torch.float32):
        sd, u0, bodies, dt = seeded_case(
            TB, {"depth": 6, "block_size": 96}, device, dtype)
        t = sd.advance.tables
        got = TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
        torch.cuda.synchronize()
        main_err, ulps = compare(
            got, TK.advance_plain(t, u0, bodies, dt, sd.plm_theta), dtype)
        print(f"parity d6b96 {str(dtype)[6:]}: max |du1| {main_err:.3e} "
              f"({ulps:.2f} ulps of its cell)")
    kernel = lambda: TK.advance_cuda(t, u0, bodies, dt, sd.plm_theta)
    plain = lambda: TK.advance_plain(t, u0, bodies, dt, sd.plm_theta)
    # in turns (plain, kernel, kernel, plain) on one card
    p1, k1, k2, p2 = (time_ms(plain, 5), time_ms(kernel, 50),
                      time_ms(kernel, 50), time_ms(plain, 5))
    ms, plain_ms = min(k1, k2), min(p1, p2)
    zones = u0.shape[0] * u0.shape[1] * u0.shape[2]
    print(f"time d6b96 float32: advance "
          f"{ms:.4f} ms kernel vs {plain_ms:.4f} ms plain "
          f"(runs {k1:.4f} {k2:.4f} / {p1:.4f} {p2:.4f}); "
          f"{zones} zones, {zones / ms / 1e6:.4f} Gzone/s per advance")
    if args.profile:
        table, busy = profile_table(kernel, 5)
        with open(args.profile, "w") as f:
            f.write(f"{smi}\nkernel B2 advance, d6b96 float32: "
                    f"{busy:.1f} us of kernels per advance\n{table}\n")
        print(f"profile: advance {busy:.1f} us of kernels per advance")
    del sd, u0, got, t

    # ---- phase 4: two RK2 steps, card against CPU --------------------------
    over = {"depth": 3, "block_size": 16}
    cfg = TB.create_config_template().create().update(over)
    sols = []
    for dev in (device, torch.device("cpu")):
        sd_ = TB.create_solver_data(cfg, device=dev, dtype=torch.float64)
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

    # ---- phase 5: the main path --------------------------------------------
    print("main path: task runner records the time series only (no "
          "checkpoint or diagnostics files: h5py is optional)")

    def record_only(state, sd_):
        if state.schedule.is_due("record_time_series"):
            state = TB.record_time_series(state, sd_)
        for task in ("write_checkpoint", "write_diagnostics"):
            if state.schedule.is_due(task):
                state = replace(state, schedule=state.schedule
                                   .mark_as_completed(task))
        return state

    with tempfile.TemporaryDirectory() as outdir:
        argv_ = ["binary", "depth=6", "block_size=96", "fast_step=0",
                 f"outdir={outdir}"]
        cfg, sd, state = TB.setup(argv_, device=device, dtype=torch.float32)
        bodies = TB.bodies_array(TB.two_body.compute_two_body_state(
            state.solution.orbital_elements, 0.0))
        dt0 = sd.cfl_number * float(sd.maximum_timestep(
            state.solution.conserved, bodies))
        # run() takes one step past the last that crosses tfinal
        cfg = cfg.set("tfinal", (args.steps - 0.5) * dt0 / (2 * math.pi))
        state = replace(state, run_config=cfg)
        print(f"main path: tfinal={cfg.get_double('tfinal'):.6e} orbits "
              f"(about {args.steps} steps of dt {dt0:.6e})")
        TK.advance_cuda.launches = 0
        tee = Tee(sys.stdout)
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(tee):
            final = TB.run(cfg, sd, state, tasks=record_only)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = TK.advance_cuda.launches
    log = tee.buf.getvalue()
    steps = final.solution.iteration
    retries = log.count("negative density in updated state")
    check(steps >= 5, f"only {steps} steps ran")
    if retries == 0:
        check(launches == 2 * steps,
              f"{launches} B2 launches for {steps} RK2 steps")
    else:
        check(launches >= 2 * steps, f"{launches} launches, {steps} steps")
    u = final.solution.conserved
    check(tuple(u.shape) == (len(sd.leaves), 96, 96, 3),
          f"state shape {tuple(u.shape)}")
    check(bool(torch.isfinite(u).all()), "non-finite state")
    check(bool((u[..., 0] > 0).all()), "non-positive density")
    check(len(final.time_series) >= 1, "no time series recorded")
    rates = [float(x) for x in re.findall(r"kzps=([0-9.]+)", log)]
    check(len(rates) >= 2, "the loop printed fewer than 2 kzps")
    deciles = statistics.quantiles(rates, n=10)
    print(f"main path: {steps} steps, {launches} B2 launches, {retries} "
          f"retries, {len(sd.leaves)} blocks of 96x96, {wall:.2f} s wall, "
          f"min density {float(u[..., 0].min()):.6e}; kzps median "
          f"{statistics.median(rates):.2f}, p10 {deciles[0]:.2f}, p90 "
          f"{deciles[-1]:.2f} on {smi}")
    if args.profile:
        held = {"s": final.solution}

        def step():
            held["s"] = TB.next_solution(held["s"], sd)

        step_ms = time_ms(step, 5)
        table, busy = profile_table(step, 3)
        with open(args.profile, "a") as f:
            f.write(f"d6b96 float32 RK2 step (next_solution): {step_ms:.4f} "
                    f"ms per step, {busy:.1f} us of kernels per step\n"
                    f"{table}\n")
        print(f"profile: step {step_ms:.4f} ms, kernels {busy / 1e3:.4f} ms "
              f"({100 * busy / 1e3 / step_ms:.1f}% busy)")

    print(json.dumps({"kernels": [{
        "name": "binary_advance (B2)", "route": "cuda",
        "source": "mara3_tpu_torch/csrc/binary_advance.cu",
        "replaces": "mara3_tpu/kernels/binary_advance.py:678",
        "launches": launches, "max_abs_err": main_err,
        "ms": ms, "plain_ms": plain_ms}]}))
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
