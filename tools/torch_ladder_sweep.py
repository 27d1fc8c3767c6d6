#!/usr/bin/env python3
"""Time the window kernels of csrc/iso2d_ladder.cu at each CTA sub-tile.

Kernels B10b (one step of 256 x 512 tiles) and B10c (four steps of 64 x
1024 tiles) run on kh's 2048^2 initial state in float32, once for every CTA
sub-tile of kernels/iso2d_step_v1.CTA_TILES whose window fits in shared
memory, beside kernel B1's step; each time is the mean of 20 calls by CUDA
events, per step. The tile that `cta_tile` picks is marked. (Kernel B9 is
the column march of csrc/iso2d_march.cuh, which has no sub-tile: its
widths and chunk heights are timed by tools/torch_iso2d_variants.py.)
Prints the card's name and power limit first and a JSON summary last.
Needs a CUDA card; imports nothing of JAX.

    python3 tools/torch_ladder_sweep.py
"""

from __future__ import annotations

import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main() -> int:
    import torch

    from chip_smoke import time_ms
    from mara3_tpu_torch.kernels import iso2d_step as T1
    from mara3_tpu_torch.kernels import iso2d_step_v1 as V1
    from mara3_tpu_torch.kernels import iso2d_step_v2 as V2
    from mara3_tpu_torch.kernels import iso2d_step_v3 as V3
    from mara3_tpu_torch.subprograms import kh as KH
    if not torch.cuda.is_available():
        print("torch_ladder_sweep: needs a CUDA card", file=sys.stderr)
        return 1
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())
    cfg = KH.config_template().create().update({"N": "2048"})
    u64 = KH.initial_conserved(cfg, dtype=torch.float64)
    kw = KH.advance_kwargs(cfg, KH.fixed_timestep(cfg, u64))
    base = dict(cs2=kw["cs2"], dtdx=kw["dt"] / kw["dx"],
                dtdy=kw["dt"] / kw["dy"], theta=kw["theta"])
    u = u64.to(torch.float32).permute(2, 0, 1).contiguous().cuda()
    s2 = V2.build_halo_strips(u, 256, 512)
    s3 = V2.build_halo_strips(u, 64, 1024, h=8)
    # (name, call with a CTA sub-tile, steps a call, halo)
    kernels = [
        ("B10b", lambda c: V2.step_v2_strips_cuda(
            u, *s2, tile=(256, 512), cta=c, **base), 1, 2),
        ("B10c", lambda c: V3.step_v3_strips_cuda(
            u, *s3, G=4, tile=(64, 1024), cta=c, **base), 4, 8)]
    b1 = time_ms(lambda: T1.advance_n_cuda(u, 1, **base), 50)
    print(f"B1 {b1:.4f} ms a step (2048^2 float32 rk1 hlle)")
    summary = {"b1_ms_per_step": b1}
    for name, call, steps, h in kernels:
        picked = V1.cta_tile(h, 4)
        row = {}
        for cta in V1.CTA_TILES:
            if V1.window_bytes(cta, h, 4) > V1.SMEM_BYTES:
                continue
            row[f"{cta[0]}x{cta[1]}"] = time_ms(lambda: call(cta), 20) / steps
        print(f"{name} ms a step: " + ", ".join(
            f"{k} {v:.4f}" + (" (picked)" if k == f"{picked[0]}x{picked[1]}"
                              else "") for k, v in row.items()))
        summary[name] = {"picked": f"{picked[0]}x{picked[1]}", **row}
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main())
