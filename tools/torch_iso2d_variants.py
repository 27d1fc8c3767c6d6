#!/usr/bin/env python3
"""Time kernels B1 (csrc/iso2d_step.cu) and B9 (csrc/iso2d_ladder.cu) built
in other ways: other march widths and chunk heights, or with one phase's
arithmetic removed.

A variant "W,R" builds the sources with the column march's CTA width W
and most rows R of a chunk (csrc/iso2d_march.cuh kMarchW, kMarchR; one
W for both dtypes, so 32 or 64 builds); "W,R,S" also with the march's
launch bounds asking registers for S CTAs an SM (kMarchCtasPerSm).
Both are held to the source's results bit for bit, since neither changes
a cell's arithmetic. A variant "-PHASE" builds
both sources with PHASE's arithmetic replaced by a few operations on the
same inputs, so its time shows what the phase costs (its results are
wrong, and it is not held to anything):
  -slopes  the sign-bit minmod half-slope (iso2d_cell.cuh plm_half)
  -faces   the Riemann solve of every face (iso2d_cell.cuh riemann)
  -loads   the state's loads from device memory and their index arithmetic
           (each value formed from its row and column instead; the
           primitive recovery stays)
  -update  the conservative update of a cell (iso2d_cell.cuh cell_update)
The phases are found by their text in either design of the sources: the
column march of iso2d_march.cuh, or the earlier shared-memory tiles
(B1's 16 x 32 tiles and B9's windows), so the tool also times a checkout
of the earlier design when copied into its tools/. All builds run at
once, one nvcc each, with -Xptxas=-v; then each variant runs on kh's
2048^2 initial state in float32, rk1 HLLE: B1 as one one-step call and
one 16-step call, B9 as one 4-step call in stripes of 256 rows (kh
shards=1's configuration). Each is timed by CUDA events in turns (first to
last, then last to first, the best of the two). Prints the card's name
and power limit first and a JSON summary last. Needs a CUDA card and
nvcc; imports nothing of JAX.

    python3 tools/torch_iso2d_variants.py [W,R | W,R,S | -PHASE ...]
"""

from __future__ import annotations

import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
from concurrent.futures import ThreadPoolExecutor

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))

MARCH_VARIANTS = ["64,32", "32,64", "64,64,3"]
PHASE_VARIANTS = ["-slopes", "-faces", "-loads", "-update"]
SOURCES = ("iso2d_step", "iso2d_ladder")
B9_TX, B9_G = 256, 4

# each phase's removal: (file, the source's text, its replacement); a phase
# may list texts of either design, and each text present in its file is
# replaced (at least one must be)
PHASES = {
    "slopes": [(
        "iso2d_cell.cuh",
        "  const T a = (y0 - yl) * half_theta;\n"
        "  const T b = (yr - yl) * T(0.25);\n"
        "  const T c = (yr - y0) * half_theta;\n"
        "  const bool sa = signbit(a), sb = signbit(b), sc = signbit(c);\n"
        "  const T m = fmin(fmin(fabs(a), fabs(b)), fabs(c));\n"
        "  return (sa == sb && sb == sc) ? copysign(m, a) : T(0);\n",
        "  return (yr - yl) * half_theta;\n"), (
        "iso2d_cell.cuh",
        "  const T c = (yr - y0) * half_theta;\n"
        "  const T m = fmin(fmin(fabs(a), fabs(b)), fabs(c));\n"
        "  return same_sign(a, b, c) ? copysign(m, a) : T(0);\n",
        "  return (yr - yl) * half_theta;\n")],
    "faces": [(
        "iso2d_cell.cuh",
        "  if (HLLC) {\n"
        "    hllc(sgl, vnl, vtl, sgr, vnr, vtr, cs2, cs, f);\n"
        "  } else {\n"
        "    hlle(sgl, vnl, vtl, sgr, vnr, vtr, cs2, cs, f);\n"
        "  }\n",
        "  f[0] = sgl - sgr;\n  f[1] = vnl * sgl - vnr * sgr + cs2;\n"
        "  f[2] = vtl - vtr + cs;\n")],
    "update": [(
        "iso2d_cell.cuh",
        "  const T d = (fxr - fxl) * p.dtdx + (fyr - fyl) * p.dtdy;\n"
        "  return u - d;\n",
        "  return u - fxr + fyr;\n")],
    "loads": [
        # the column march (iso2d_march.cuh): a row's three values
        ("iso2d_march.cuh",
         "  const T* at = row.ptr + c;\n"
         "  for (int q = 0; q < 3; ++q) v[q] = __ldg(at + q * row.qstride);\n",
         "  for (int q = 0; q < 3; ++q)\n"
         "    v[q] = T(1) + T((c + q) & 63) * T(1e-3) + T(row.qstride & 7);\n"),
        # the earlier B1: its 16 x 32 tile's wrapped loads
        ("iso2d_step.cu",
         "    const long long c = (long long)iso2d::wrap(i0 + a - kHalo, nx) "
         "* ny\n"
         "                        + iso2d::wrap(j0 + b - kHalo, ny);\n"
         "    const T sg = src[c];\n"
         "    P[0][a][b] = sg;\n"
         "    P[1][a][b] = src[plane + c] / sg;\n"
         "    P[2][a][b] = src[2 * plane + c] / sg;\n",
         "    const T sg = T(1) + T(a) * T(1e-3);\n"
         "    P[0][a][b] = sg;\n"
         "    P[1][a][b] = T(b) * T(1e-3) / sg;\n"
         "    P[2][a][b] = T(a + b) * T(1e-3) / sg;\n"),
        # the earlier B9: its window's loads from the stripe and strips
        ("iso2d_ladder.cu",
         "      T v;\n"
         "      if (x < 0) {\n"
         "        v = lo[sq + (long long)(x + h) * ny + y];\n"
         "      } else if (x >= TX) {\n"
         "        v = hi[sq + (long long)(x - TX) * ny + y];\n"
         "      } else {\n"
         "        v = u[q * plane + (long long)(s * TX + x) * ny + y];\n"
         "      }\n",
         "      const T v = T(1) + T((a * 7 + b + int(sq)) & 63) * "
         "T(1e-3);\n")],
}


# the texts that set the march's W, R and launch bounds, in a variant's order
MARCH_CONSTANTS = ("constexpr int kMarchW = ", "constexpr int kMarchR = ",
                   "constexpr int kMarchCtasPerSm = ")


def variant_dir(variant, out_dir):
    """A directory holding csrc/ as it is, with `variant`'s phase removed,
    or with its W, R (and S) set: the two sources and every header."""
    from mara3_tpu_torch.kernels import _build
    name = (variant or "source").replace(",", "_").replace("-", "no_")
    d = os.path.join(out_dir, name)
    os.makedirs(d)
    for path in _build.CSRC.iterdir():
        if path.suffix == ".cuh" or path.stem in SOURCES:
            shutil.copy(path, d)
    if variant and not variant.startswith("-"):
        path = os.path.join(d, "iso2d_march.cuh")
        if not os.path.exists(path):
            raise ValueError(f"{variant}: needs the column march's sources")
        text = open(path).read()
        for const, value in zip(MARCH_CONSTANTS, variant.split(",")):
            if text.count(const) != 1:
                raise ValueError(f"{variant}: the march has no {const!r}")
            text = re.sub(const + r"\d+;", f"{const}{int(value)};", text)
        with open(path, "w") as f:
            f.write(text)
    if variant and variant.startswith("-"):
        hits = 0
        for fname, old, new in PHASES[variant[1:]]:
            path = os.path.join(d, fname)
            if not os.path.exists(path):
                continue
            text = open(path).read()
            hits += text.count(old)
            with open(path, "w") as f:
                f.write(text.replace(old, new))
        if hits == 0:
            raise ValueError(f"{variant}: no source has its text")
    return d


def build(variant, out_dir):
    """{source: (library path, ptxas log)} of one variant."""
    from mara3_tpu_torch.kernels import _build
    d = variant_dir(variant, out_dir)

    def one(src):
        path = os.path.join(d, f"lib{src}.so")
        cmd = [_build.nvcc_path(), "-Xptxas=-v", *_build.NVCC_FLAGS, "-o",
               path, os.path.join(d, f"{src}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {variant} {src}:\n"
                               f"{proc.stderr}")
        return src, (path, proc.stdout + proc.stderr)

    return dict(map(one, SOURCES))


def ptxas_kernels(log):
    """{kernel: "N registers, S B spill stores"} of B1's and B9's float32
    kernels in an nvcc -Xptxas=-v log."""
    found, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"(stage_kernel|stripes_kernel|march_kernel)"
                          r"I(f)(Lb[01]E)?", m.group(1))
            name = k and f"{k.group(1)}<{k.group(3) or ''}>"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = f"{m.group(1)} B spill stores"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            found[name] = f"{m.group(1)} registers, {spill}"
            name = None
    return found


def main(argv=None) -> int:
    import torch

    from chip_smoke import time_ms
    from mara3_tpu_torch.kernels import _build
    from mara3_tpu_torch.kernels import iso2d_step as T1
    from mara3_tpu_torch.kernels import iso2d_step_v4 as V4
    from mara3_tpu_torch.subprograms import kh as KH
    if not torch.cuda.is_available():
        print("torch_iso2d_variants: needs a CUDA card", file=sys.stderr)
        return 1
    argv = sys.argv[1:] if argv is None else argv
    march = (_build.CSRC / "iso2d_march.cuh").exists()
    variants = [None] + (argv or (MARCH_VARIANTS if march else [])
                         + PHASE_VARIANTS)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    with tempfile.TemporaryDirectory() as out_dir:
        with ThreadPoolExecutor(len(variants)) as pool:
            built = dict(zip(variants, pool.map(lambda v: build(v, out_dir),
                                                variants)))
        libs = {v: {s: ctypes.CDLL(p) for s, (p, _) in b.items()}
                for v, b in built.items()}
    cfg = KH.config_template().create().update({"N": "2048"})
    u64 = KH.initial_conserved(cfg, dtype=torch.float64)
    kw = KH.advance_kwargs(cfg, KH.fixed_timestep(cfg, u64))
    base = dict(cs2=kw["cs2"], dtdx=kw["dt"] / kw["dx"],
                dtdy=kw["dt"] / kw["dy"], theta=kw["theta"])
    u = u64.to(torch.float32).permute(2, 0, 1).contiguous().cuda()
    lo, hi = V4.build_x_strips(u, B9_TX, 2 * B9_G)

    def use(v):
        for s in SOURCES:
            _build._loaded[s] = libs[v][s]
        return {
            "b1_step": lambda: T1.advance_n_cuda(u, 1, **base),
            "b1_16": lambda: T1.advance_n_cuda(u, 16, **base),
            "b9_call": lambda: V4.step_v4_strips_cuda(
                u, lo, hi, G=B9_G, TX=B9_TX, **base)}

    results, ref = [], None
    for v in variants:
        calls = use(v)
        outs = {k: f() for k, f in calls.items()}
        torch.cuda.synchronize()
        ref = ref or outs
        r = {"variant": v or "source"}
        for s in SOURCES:
            r[s] = ptxas_kernels(built[v][s][1])
        if v is None or not v.startswith("-"):
            r["bitwise"] = all(torch.equal(outs[k], ref[k]) for k in outs)
        results.append(r)
    reps = {"b1_step": 50, "b1_16": 10, "b9_call": 20}
    for order in (range(len(variants)), reversed(range(len(variants)))):
        for k in order:
            calls = use(variants[k])
            for name, f in calls.items():
                results[k].setdefault(name, []).append(time_ms(f, reps[name]))
    for r in results:
        for name in reps:
            r[name] = min(r[name])
        held = f"; bitwise {r['bitwise']}" if "bitwise" in r else ""
        print(f"{r['variant']}: B1 {r['b1_step']:.4f} ms a step (one-step "
              f"call), {r['b1_16'] / 16:.4f} ms a step in a 16-step call; "
              f"B9 {r['b9_call']:.4f} ms per 4-step call "
              f"({r['b9_call'] / 4:.4f} a step){held}; "
              + "; ".join(f"{s} {r[s]}" for s in SOURCES if s in r))
    print(json.dumps({"iso2d_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
