#!/usr/bin/env python3
"""Time kernel B3 (csrc/binary_multi.cu) built in other ways: other launch
bounds or float32 tile heights, or with one phase's arithmetic removed.

A variant "S1,S2,TI" builds the source with kSweep1Ctas and kSweep2Ctas
(the CTAs an SM that each sweep's __launch_bounds__ asks registers for)
set to S1 and S2 and the float32 tile's rows to TI
(kernels/binary_multi.TILE follows it). A variant "-PHASE" builds it with
PHASE's arithmetic replaced by a few operations on the same inputs, so its
time shows what the phase costs (its results are wrong, and it is not held
to anything):
  -faces   sweep 2's face flux (face_flux)
  -update  sweep 2's per-cell update (update_cell)
  -totals  sweep 2's running float64 totals but the fault count
  -scalar  b3_stage_end's one-thread section (after the totals' sums)
  -slopes  sweep 1's division (or product) of the limited slopes by the
           spacing (a sum instead)
All variants are built at once, one nvcc each, then run on the flagship's
main-path shape (d6b96 float32, one call of 16 RK2 steps, chip_smoke.py's
phase-10 case). The first is the source as it is; a launch-bound or tile
variant is held to its state (bit for bit: neither changes a cell's
arithmetic) and rows (the totals' summation order follows the tile). Each
is timed by CUDA events in turns (first to last, then last to first, the
best of the two) and split by kernel under torch.profiler. Prints the
card's name and power limit first and a JSON summary last. Needs a CUDA
card and nvcc; imports nothing of JAX.

    python3 tools/torch_b3_variants.py [S1,S2,TI | -PHASE ...]
"""

from __future__ import annotations

import ctypes
import json
import os
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

VARIANTS = ["4,2,32", "4,3,16", "-faces", "-update", "-totals", "-scalar",
            "-slopes"]
# the text that sets the launch bounds and the float32 tile
BOUNDS = "constexpr int kSweep1Ctas = 4, kSweep2Ctas = 3;"
TILE_F32 = "static constexpr int I = 32, J = 32;"
# each phase's removal: (the source's text, its replacement)
PHASES = {
    "faces": ("      face_flux(axis, pl, pr, gL + lo, gR + lo, gL + tr, "
              "gR + tr, x, y,\n                T(a.spacing[fb]), prm, f);",
              "      for (int c = 0; c < 3; ++c)\n"
              "        f[c] = pl[c] - pr[c] + (gL[lo + c] - gR[tr + c]) * x "
              "* y;"),
    "update": ("      update_cell<T>(U, P, in, a.br[idx], div, x, y, dA, "
               "prm, V, acc);",
               "      for (int c = 0; c < 3; ++c)\n"
               "        V[c] = U[c] - div[c] * dA + P[c] * in[c] * "
               "a.br[idx];\n"
               "      for (int q = 0; q < kTotals; ++q) acc[q] = "
               "double(V[q % 3]);"),
    "totals": ("      for (int k = 0; k < kTotals; ++k) sum[k] += acc[k];",
               "      sum[kFaults] += acc[kFaults];"),
    "scalar": ("  const double* tot = a.totals;\n",
               "  if (a.k_steps > 0) return;\n  const double* tot = "
               "a.totals;\n"),
    "slopes": ("        G[c] = inv != T(0) ? gx * inv : gx / sp;\n"
               "        G[3 + c] = inv != T(0) ? gy * inv : gy / sp;",
               "        G[c] = gx + sp;\n        G[3 + c] = gy + sp;"),
}


def replace_once(text, old, new, variant):
    if text.count(old) != 1:
        raise ValueError(f"{variant}: the source no longer has {old!r}")
    return text.replace(old, new)


def source(variant):
    """(the source text of `variant`, the float32 tile's rows)."""
    from mara3_tpu_torch.kernels import _build
    text = (_build.CSRC / "binary_multi.cu").read_text()
    if variant is None:
        return text, 32
    if variant.startswith("-"):
        return replace_once(text, *PHASES[variant[1:]], variant), 32
    s1, s2, ti = (int(v) for v in variant.split(","))
    text = replace_once(text, BOUNDS, f"constexpr int kSweep1Ctas = {s1}, "
                        f"kSweep2Ctas = {s2};", variant)
    return replace_once(text, TILE_F32, f"static constexpr int I = {ti}, "
                        "J = 32;", variant), ti


def build(variant, out_dir):
    """The library of one variant of csrc/binary_multi.cu."""
    from mara3_tpu_torch.kernels import _build
    text, _ = source(variant)
    name = (variant or "source").replace(",", "_").replace("-", "no_")
    cu = os.path.join(out_dir, f"{name}.cu")
    with open(cu, "w") as f:
        f.write(text)
    path = os.path.join(out_dir, f"lib{name}.so")
    cmd = [_build.nvcc_path(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
           "-o", path, cu]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {variant}:\n{proc.stderr}")
    return path


def main(argv=None) -> int:
    import torch

    from chip_smoke import kernel_split, multi_case, time_ms
    from mara3_tpu_torch.kernels import _build
    from mara3_tpu_torch.kernels import binary_multi as TM
    from mara3_tpu_torch.subprograms import binary as TB
    if not torch.cuda.is_available():
        print("torch_b3_variants: needs a CUDA card", file=sys.stderr)
        return 1
    argv = sys.argv[1:] if argv is None else argv
    variants = [None] + (argv or VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    device = torch.device("cuda")
    with tempfile.TemporaryDirectory() as out_dir:
        with ThreadPoolExecutor(len(variants)) as pool:
            paths = list(pool.map(lambda v: build(v, out_dir), variants))
        libs = [ctypes.CDLL(p) for p in paths]

    args = multi_case(TB, {"depth": 6, "block_size": 96}, device,
                      torch.float32, 16, False)

    def use(k):
        _build._loaded["binary_multi"] = libs[k]
        TM.TILE[torch.float32] = (source(variants[k])[1], 32)
        TM._plans.clear()
        return lambda: TM.advance_k_cuda(*args)

    results, ref = [], None
    for k, v in enumerate(variants):
        call = use(k)
        u, rows = call()
        torch.cuda.synchronize()
        ref = ref or (u, rows)
        info = TM.kernel_info(torch.float32)
        r = {"variant": v or "source",
             "split_ms": {n: round(us / 1e3, 4)
                          for n, (us, _) in kernel_split(call, 2).items()},
             "registers": {n: i["registers"] for n, i in info.items()},
             "local_bytes": {n: i["local_bytes"] for n, i in info.items()},
             "ctas_per_sm": {n: i["ctas_per_sm"] for n, i in info.items()}}
        if v is None or not v.startswith("-"):
            r["state_bitwise"] = bool(torch.equal(u, ref[0]))
            r["rows_max_rel"] = float(((rows - ref[1]).abs() / ref[1].abs()
                                       .clamp_min(1e-300)).max())
        results.append(r)
    for order in (range(len(variants)), reversed(range(len(variants)))):
        for k in order:
            results[k].setdefault("ms", []).append(time_ms(use(k), 5))
    for r in results:
        r["ms"] = min(r["ms"])
        held = (f"; state bitwise {r['state_bitwise']}, rows max rel "
                f"{r['rows_max_rel']:.1e}" if "state_bitwise" in r else "")
        print(f"B3 {r['variant']}: {r['ms']:.4f} ms per 16 RK2 steps{held}; "
              f"{r['split_ms']}; registers {r['registers']}; local "
              f"{r['local_bytes']}; CTAs/SM {r['ctas_per_sm']}")
    print(json.dumps({"b3_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
