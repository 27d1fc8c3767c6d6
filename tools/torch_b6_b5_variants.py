#!/usr/bin/env python3
"""Time kernels B6 (csrc/amrsand_step.cu) and B5 (csrc/sedov_step.cu)
built in other ways: an earlier checkout's sources, or with one phase's
arithmetic removed, so that the times split a call's cost among its
phases.

A variant "-PHASE" builds both sources with PHASE's work replaced by a few
operations on the same inputs; its results are wrong, and it is not held
to anything:
  -b6guards   B6's guards from the edge buffer (each guard a constant)
  -b6update   B6's cell update (a cell keeps u; its guards and the
              shuffles go too, having no use)
  -b5newton   B5's SRHD Newton updates (the primitives are formed from the
              warm pressure as it stands)
  -b5faces    B5's HLLE at each face (the flux is L - R)
  -b5update   B5's source and update (U + (F[r+1] - F[r]) * 0, so the
              state stays and the faces are still computed)
  -barrier    the grid barrier of both (a CTA barrier instead)
  -exchange   the grid barrier and the edge buffers' traffic of both (an
              edge read gives 1, an edge write is dropped)
With --parent DIR (the csrc/ of an earlier checkout, for example one
unpacked with git archive), the tool also builds that checkout's
amrsand_step.cu and sedov_step.cu and times them through their own C
interface: B6 one launch a step, B5 one launch a step with two pressure
buffers (the interfaces of the commit before the persistent designs);
their results are held to the source's bit for bit.

All builds run at once, one nvcc each, with -Xptxas=-v. Then, in float32
on the card: B6 on amrsand's depth-7, block-64 initial state (652 blocks)
as one 256-step call in both designs (the resident one and the
launch-a-step one); B5 on sedov's nr=262144 initial state (524,288 cells)
as one 128-step call, SRHD pcm and Euler pcm, in both of its designs (the
resident march and the streaming one). Each is timed by CUDA events in
turns (first variant to last, then last to first, the best of the two).
Prints the card's name and power limit first and a JSON summary last.
Needs a CUDA card and nvcc; imports nothing of JAX.

    python3 tools/torch_b6_b5_variants.py [--parent DIR] [VARIANT ...]
"""

from __future__ import annotations

import argparse
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

SOURCES = ("amrsand_step", "sedov_step")
VARIANTS = ["-b6guards", "-b6update", "-b5newton", "-b5faces",
            "-b5update", "-barrier", "-exchange"]
B6_STEPS, B5_STEPS = 256, 128
AMR_DEPTH, AMR_BS, SEDOV_NR = 7, 64, 262144

# each variant's edits: (file, the source's text, its replacement); every
# text must be in its file
_NO_BARRIER = ("resident_loop.cuh",
               "  cooperative_groups::this_grid().sync();\n",
               "  __syncthreads();\n")
EDITS = {
    "-b6guards": [(
        "amrsand_step.cu",
        "      gs[g] = guard<T>(at, fs + (2 * lb + a) * kFace, bs, p);\n",
        "      gs[g] = T(p) * T(1e-3);\n")],
    "-b6update": [(
        "amrsand_step.cu",
        "          const T v = cur[q] - cb * (T(2) * cur[q] - prev[q] - ym1);\n",
        "          const T v = cur[q];\n")],
    "-b5newton": [(
        "srhd_recover.cuh",
        "  for (; it < kNewtonIterMax && !is_done; ++it) {\n",
        "  for (; it < 0 && !is_done; ++it) {\n")],
    "-b5faces": [(
        "sedov_step.cu",
        "        hlle<T, SRHD>(Lq, Rq, prm.gamma, prm.gm1, prm.K, flux);\n",
        "        for (int q = 0; q < 5; ++q) flux[q] = Lq[q] - Rq[q];\n")],
    "-b5update": [(
        "sedov_step.cu",
        "            U = U + (-(Fhi * darr - Flo * dalr) + s * dvr) * prm.dt;\n",
        "            U = U + (Fhi - Flo) * T(0);\n"), (
        "sedov_step.cu",
        "            a.out[i] = Uin[i] + (-(Fhi * darr - Flo * dalr) + s * dvr)\n"
        "                                * prm.dt;\n",
        "            a.out[i] = Uin[i] + (Fhi - Flo) * T(0);\n")],
    "-barrier": [_NO_BARRIER],
    "-exchange": [_NO_BARRIER, (
        "resident_loop.cuh", "  return __ldcg(p);\n",
        "  (void)p;\n  return T(1);\n"), (
        "resident_loop.cuh", "  __stcg(p, v);\n", "  (void)p;\n  (void)v;\n")],
}


def variant_dir(variant, out_dir, parent):
    """A directory holding the two sources and every header: this
    checkout's with `variant`'s edits, or the parent's."""
    from mara3_tpu_torch.kernels import _build
    d = os.path.join(out_dir, variant.replace("-", "no_"))
    os.makedirs(d)
    src = parent if variant == "parent" else str(_build.CSRC)
    for name in os.listdir(src):
        stem, ext = os.path.splitext(name)
        if ext == ".cuh" or stem in SOURCES:
            shutil.copy(os.path.join(src, name), d)
    for fname, old, new in EDITS.get(variant, []):
        path = os.path.join(d, fname)
        text = open(path).read()
        if old not in text:
            raise ValueError(f"{variant}: {fname} has no {old!r}")
        with open(path, "w") as f:
            f.write(text.replace(old, new))
    return d


def build(variant, out_dir, parent):
    """{source: (library path, ptxas log)} of one variant; a source that
    does not build gives (None, nvcc's output)."""
    from mara3_tpu_torch.kernels import _build
    d = variant_dir(variant, out_dir, parent)

    def one(src):
        path = os.path.join(d, f"lib{src}.so")
        cmd = [_build.nvcc_path(), "-Xptxas=-v", *_build.NVCC_FLAGS, "-o",
               path, os.path.join(d, f"{src}.cu")]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log = proc.stdout + proc.stderr
        return src, (path if proc.returncode == 0 else None, log)

    return dict(map(one, SOURCES))


def ptxas_kernels(log):
    """{kernel: "N registers, S B spill stores"} of the float32 kernels
    in an nvcc -Xptxas=-v log."""
    found, name, spill = {}, None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"(step_kernel|resident_kernel|march_kernel)If"
                          r"(?:Li(\d)E(?:Lb(\d)ELb(\d)E)?)?", m.group(1))
            name = k and k.group(1) + (
                "" if not k.group(2) else f"<C{k.group(2)}>"
                if not k.group(3) else
                f"<m{k.group(2)},srhd{k.group(3)},res{k.group(4)}>")
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


def parent_b6(lib, u, tab, n):
    """The parent's B6 (one launch a step) through its C interface."""
    import torch
    out, scr = torch.empty_like(u), torch.empty_like(u)
    fn = lib.b6_advance_n_f32
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    rc = fn(u.data_ptr(), out.data_ptr(), scr.data_ptr(),
            tab.faces.data_ptr(), tab.c.data_ptr(), u.shape[0], u.shape[1],
            n, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent B6 launch failed ({rc})")
    return out


def parent_b5(lib, u, v, dt, n, system):
    """The parent's B5 (one launch a step, pcm, warm) through its C
    interface."""
    import torch
    from mara3_tpu_torch.kernels import sedov_step as T5
    geo = T5.geometry(v, u.dtype).contiguous()
    out, scr = torch.empty_like(u), torch.empty_like(u)
    pres = torch.zeros((2, u.shape[0]), dtype=u.dtype, device=u.device)
    fn = lib.b5_advance_n_f32
    fn.argtypes = ([ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
                   + [ctypes.c_double] * 3 + [ctypes.c_void_p])
    srhd = int(system == "srhd")
    rc = fn(u.data_ptr(), out.data_ptr(), scr.data_ptr(), geo.data_ptr(),
            pres[0].data_ptr(), pres[1].data_ptr(), u.shape[0], n, 1, srhd,
            srhd, dt, 1.5, 4.0 / 3.0, torch.cuda.current_stream().cuda_stream)
    if rc != 0:
        raise RuntimeError(f"parent B5 launch failed ({rc})")
    return out


def main(argv=None) -> int:
    import torch

    from chip_smoke import time_ms
    from mara3_tpu_torch.kernels import _build
    from mara3_tpu_torch.kernels import amrsand_step as T6
    from mara3_tpu_torch.kernels import sedov_step as T5
    from mara3_tpu_torch.mesh import block_layout as BL
    from mara3_tpu_torch.subprograms import amrsand as AS
    from mara3_tpu_torch.subprograms import sedov as SD
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--parent", metavar="DIR",
                    help="an earlier checkout's csrc/ to time beside")
    ap.add_argument("variants", nargs="*", default=VARIANTS)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("torch_b6_b5_variants: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    variants = ["source"] + args.variants + (["parent"] if args.parent
                                             else [])
    with tempfile.TemporaryDirectory() as out_dir:
        with ThreadPoolExecutor(len(variants)) as pool:
            built = dict(zip(variants, pool.map(
                lambda v: build(v, out_dir, args.parent), variants)))
        libs = {v: {s: ctypes.CDLL(p) for s, (p, _) in b.items() if p}
                for v, b in built.items()}

    f32 = torch.float32
    cfg = AS.config_template().create().update(
        {"depth": AMR_DEPTH, "block_size": AMR_BS})
    s6 = AS.new_solution(cfg, dtype=f32)
    u6 = s6.conserved.cuda()
    tab = T6.guard_tables(BL.build_neighbor_table(s6.leaves),
                          AS.block_spacings(s6).cuda(), AS.time_step(s6))
    s5 = {}
    for system in ("srhd", "euler"):
        c5 = SD.config_template().create().update(
            {"nr": str(SEDOV_NR), "newtonian": str(int(system == "euler"))})
        sol = SD.new_solution(c5, dtype=f32)
        s5[system] = (sol.conserved.cuda(), sol.vertices.cuda(),
                      SD.grid_dt(sol.vertices))

    def calls(v):
        """{case: a call} of variant v, through its built libraries."""
        lib = libs[v]
        out = {}
        if v == "parent":
            if "amrsand_step" in lib:
                out["b6_per_step"] = lambda: parent_b6(
                    lib["amrsand_step"], u6, tab, B6_STEPS)
            if "sedov_step" in lib:
                for system, (u, vv, dt) in s5.items():
                    out[f"b5_{system}_per_step"] = (
                        lambda u=u, vv=vv, dt=dt, system=system: parent_b5(
                            lib["sedov_step"], u, vv, dt, B5_STEPS, system))
            return out
        if "amrsand_step" in lib:
            for design in T6.DESIGNS:
                out[f"b6_{design}"] = (
                    lambda design=design: T6.advance_n_cuda(
                        u6, tab, B6_STEPS, design=design))
        if "sedov_step" in lib:
            for system, (u, vv, dt) in s5.items():
                for design in T5.DESIGNS:
                    out[f"b5_{system}_{design}"] = (
                        lambda u=u, vv=vv, dt=dt, system=system,
                        design=design: T5.advance_n_cuda(
                            u, vv, dt, B5_STEPS, system=system,
                            design=design))
        return out

    def use(v):
        for s, lib in libs[v].items():
            _build._loaded[s] = lib
        return calls(v)

    results, ref = [], {}
    for v in variants:
        r = {"variant": v}
        for s in SOURCES:
            path, log = built[v][s]
            r[s] = ptxas_kernels(log) if path else "build failed: " + \
                log.strip()[-400:]
        outs = {k: f() for k, f in use(v).items()}
        torch.cuda.synchronize()
        if v == "source":
            ref = outs
        if not v.startswith("-"):
            # the parent's per-step results against the source's resident
            # design (or the same design)
            r["bitwise"] = all(
                torch.equal(o, ref.get(k, ref.get(k.replace("per_step",
                                                            "resident"))))
                for k, o in outs.items())
        results.append(r)
        del outs
    reps = 5
    for order in (range(len(variants)), reversed(range(len(variants)))):
        for k in order:
            for name, f in use(variants[k]).items():
                results[k].setdefault(name, []).append(time_ms(f, reps))
    for r in results:
        times = {k: min(v) for k, v in r.items() if isinstance(v, list)}
        r.update(times)
        held = f"; bitwise {r['bitwise']}" if "bitwise" in r else ""
        print(f"{r['variant']}: " + ", ".join(
            f"{k} {t:.4f} ms" for k, t in times.items()) + held + "; "
            + "; ".join(f"{s} {r[s]}" for s in SOURCES))
    src = results[0]
    for r in results[1:]:
        if r["variant"].startswith("-"):
            print(f"{r['variant']} saves " + ", ".join(
                f"{k} {src[k] - r[k]:.4f} ms" for k in src
                if isinstance(src[k], float) and isinstance(r.get(k),
                                                            float)))
    print(json.dumps({"b6_b5_variants": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
