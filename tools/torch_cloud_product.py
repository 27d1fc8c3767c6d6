#!/usr/bin/env python3
"""The cloud product run through the PyTorch port on one NVIDIA GPU.

Runs ``cloud nr=1024`` (2,048 x 1,024 cells, the defaults: plm theta 1.2,
HLLE, temperature floor 1e-8; rk_order 2, or --rk) for --steps steps (2,048
by default, the run of benchmarks/bench_product_cloud.py) three ways, each
from the initial state formed in its dtype: kernel B4 (B4d calls of 64
steps) in float32 and in float64, and the scheme (the port of the JAX
package's jnp path, torch ops on the card) in float64. After every call it
checks that the state and the warm pressure are finite; when a call is not,
it steps again from the call's start, one step at a time, to the first
step that is not, and prints that step and its first cells. For B4 in
float32 it also runs that step from the same state through B4c's plain
version, through the scheme in float32 and through B4c in float64, which
tells the physics in float32 from the kernel's arithmetic. The last line is
a JSON summary. Needs a CUDA card; imports nothing of JAX.

    python3 tools/torch_cloud_product.py [--steps N] [--rk 1|2]
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

CHUNK = 64


def finite(*ts):
    return all(bool(t.isfinite().all()) for t in ts)


def run(TC, cfg, dtype, kernel, steps, device):
    """Calls of CHUNK steps from the initial state in dtype through B4
    (kernel) or the scheme: (the steps taken while finite, the state, warm
    pressure and time at the start of the first call that went non-finite
    or at the end, wall seconds, the grid)."""
    import torch
    s = TC.new_solution(cfg, dtype=dtype)
    dt = TC.grid_dt(s, cfg)
    jet = TC.jet_static(cfg)
    rk = cfg.get_int("rk_order")
    rv = s.radial_vertices.to(device)
    qv = s.polar_vertices.to(device)
    u = s.conserved.permute(2, 0, 1).to(device).contiguous()
    p = torch.zeros_like(u[0])
    t, done = 0.0, 0
    t0 = time.perf_counter()
    while done < steps:
        n = min(CHUNK, steps - done)
        u1, p1 = TC.advance_n(u, p, t, n, rv, qv, jet, dt, 1.2, 2, 1e-8, rk,
                              kernel=kernel)
        if not finite(u1, p1):
            break
        u, p, t, done = u1, p1, t + n * dt, done + n
    torch.cuda.synchronize()
    return done, u, p, t, time.perf_counter() - t0, (rv, qv, dt, jet, rk)


def first_bad_step(TC, u, p, t, done, grid, kernel):
    """From a call's start (step `done`, time t): (the first step that is
    not finite, the state, pressure and time before it, its bad cells)."""
    rv, qv, dt, jet, rk = grid
    for k in range(CHUNK):
        u1, p1 = TC._advance_rk_carry_soa(u, p, t, rv, qv, jet, dt, 1.2, 2,
                                          1e-8, rk, kernel=kernel)
        if not finite(u1, p1):
            bad = (~u1.isfinite()).any(dim=0) | ~p1.isfinite()
            return done + k + 1, u, p, t, bad
        u, p, t = u1, p1, t + dt
    return None


def compare_at(TC, T4, u, p, t, grid):
    """The bad step from the same float32 state through B4c's plain
    version, the scheme and B4c in float64: {label: finite}."""
    rv, qv, dt, jet, rk = grid
    rows = TC.inflow_rows(TC.ops.midpoint_on_axis(qv), t, dt, 1, jet)
    kw = dict(dt=dt, plm_theta=1.2, method=2, tfloor=1e-8)

    def kernel64():
        geo = TC.kernel_geometry(rv.double(), qv.double())
        rows64 = TC.inflow_rows(TC.ops.midpoint_on_axis(qv.double()), t, dt,
                                1, jet)
        if rk == 2:
            return T4.step_rk2_cuda(rows64[0], rows64[1], u.double(),
                                    p.double(), geo, **kw)
        return T4.stage_cuda(rows64[0], u.double(), p.double(), geo, **kw)

    geo = TC.kernel_geometry(rv, qv)
    plain = (lambda: T4.step_rk2_plain(rows[0], rows[1], u, p, geo, **kw)) \
        if rk == 2 else (lambda: T4.stage_plain(rows[0], u, p, geo, **kw))
    out = {}
    for label, fn in (
            ("B4 plain, float32", plain),
            ("scheme, float32", lambda: TC._advance_rk_carry_soa(
                u, p, t, rv, qv, jet, dt, 1.2, 2, 1e-8, rk, kernel=False)),
            ("B4, float64", kernel64)):
        out[label] = finite(*fn())
        print(f"  {label}: {'finite' if out[label] else 'non-finite'}")
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=2048)
    ap.add_argument("--rk", type=int, default=2, choices=(1, 2))
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA device", file=sys.stderr)
        return 2
    from mara3_tpu_torch.kernels import cloud_update as T4
    from mara3_tpu_torch.subprograms import cloud as TC
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip().splitlines()[0]
    print(smi)
    device = torch.device("cuda")
    cfg = TC.config_template().create().update({"nr": "1024",
                                                "rk_order": str(args.rk)})
    summary = {"steps": args.steps, "rk": args.rk, "device": smi}
    for label, dtype, kernel in (("B4 float32", torch.float32, True),
                                 ("B4 float64", torch.float64, True),
                                 ("scheme float64", torch.float64, False)):
        done, u, p, t, wall, grid = run(TC, cfg, dtype, kernel, args.steps,
                                        device)
        rho = u[0] / TC.kernel_geometry(*grid[:2]).dv
        print(f"{label} rk{args.rk}: {done} of {args.steps} steps finite in "
              f"{wall:.3f} s (t = {t:.7f}); there min density "
              f"{float(rho.min()):.6e}, pressure {float(p.min()):.6e} to "
              f"{float(p.max()):.6e}")
        row = {"finite_steps": done}
        found = first_bad_step(TC, u, p, t, done, grid, kernel) \
            if done < args.steps else None
        if found:
            step, u, p, t, bad = found
            cells = bad.nonzero()[:6].tolist()
            r, q = cells[0]
            print(f"  first non-finite step {step} (t = {t:.7f} before it): "
                  f"{int(bad.sum())} cells, the first (r, theta) {cells}; "
                  f"before the step there u = " + " ".join(
                      f"{float(x):.6e}" for x in u[:, r, q])
                  + f", warm pressure {float(p[r, q]):.6e}")
            row.update(first_bad_step=step, cells=int(bad.sum()),
                       first_cell=cells[0])
            if dtype == torch.float32:
                row["that step"] = compare_at(TC, T4, u, p, t, grid)
        summary[label] = row
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
