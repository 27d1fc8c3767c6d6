#!/usr/bin/env python3
"""Chip smoke test: the PyTorch port's paths on one NVIDIA GPU.

Run from the root of a checkout: ``python3 chip_smoke.py``. It imports
nothing of JAX. Phases, each of which raises on failure (the script then
exits non-zero and prints no result):

1. device: a CUDA card must be present; prints nvidia-smi's name and power
   limit;
2. build: compiles mara3_tpu_torch/csrc/binary_advance.cu (kernel B2),
   binary_multi.cu (B3), iso2d_step.cu (B1), sedov_step.cu (B5),
   cloud_update.cu (B4), amrsand_step.cu (B6), sand3d_step.cu (B7),
   binary_update.cu (B11a, B11b), binary_advance_strips.cu (B11c) and
   iso2d_ladder.cu (B8, B9, B10a-c), one nvcc each, started together;
   binary_multi.cu, iso2d_step.cu, iso2d_ladder.cu, amrsand_step.cu and
   sedov_step.cu with -Xptxas=-v, whose registers and spills for each B3
   kernel, each column-march kernel (B1's and B9's stage, csrc/
   iso2d_march.cuh), B6's two kernels and B5's march kernels it prints,
   with the march kernels' shared memory and CTAs an SM, and B6's and B5's
   at the main paths' plans (csrc/resident_loop.cuh);
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
   steps, in float64 and float32, each called twice to show the same
   bits;
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
   plain): one B3 call of 16 RK2 steps, 16 steps of the per-step scan
   (B2), and advance_k_plain over 16 steps; then each B3 kernel's device
   time and launches per call (torch.profiler's rows by kernel name), and
   its registers, local memory, shared memory and CTAs per SM in float32
   and float64;
11. B1 parity: kernel B1 (csrc/iso2d_step.cu) against advance_n_plain on
   the card over {hlle, hllc} x {rk1, rk2} x {float64, float32}, at
   96 x 160 (a shape no TPU alignment rule allows) for n in {1, 3, 16} and
   at 2048^2 for 16 steps; float64 at the CPU bars, float32 at 64 ulps of
   each cell's largest component;
12. kh card against CPU: ``kh N=256``, float64, 11 steps, B1 on the card
   against its plain version on the CPU;
13. kh main path: ``kh N=2048`` with the defaults (rk1, hlle, float32)
   through kh.setup() and kh.run() for about 2,000 steps, then ``kh N=2048
   rk_order=2 riemann=hllc`` for 600, every B1 call counted (one per
   chunk); prints the whole-run rate (steps x zones / wall seconds);
14. bench-shaped rate: bench.py's setup (copied here: bench.py imports
   JAX) through B1, the marginal rate between 56 and 4,056 steps, median of
   5 pairs timed with CUDA events, in zone-updates per second;
15. timing at 2048^2 float32, in turns: B1 and advance_n_plain per step and
   per 16-step call, beside the bound and the earlier tile design's times
   (B1_TILE_*);
16. B5 parity: kernel B5 (csrc/sedov_step.cu) against advance_n_plain on
   the card over {euler, srhd (warm and cold)} x {pcm, plm, weno5} x
   {float64, float32}, at 1,000 cells (no TPU rule allows it) for n in
   {1, 3, 17} and at 524,288 cells for 16 steps, each case through both
   designs where the plan allows (the resident march, and the streaming
   one), every case bit for bit the plain version's;
17. sedov card against CPU: ``sedov nr=256`` (SRHD pcm), float64, 11
   steps, B5 on the card against its plain version on the CPU;
18. sedov main path: ``sedov nr=262144`` (524,288 cells) with the defaults
   (SRHD, pcm, float32, the chunked loop: B5 calls of up to 128 steps)
   through sedov.setup() and sedov.run() for 4,096 steps; then
   ``newtonian=1`` for 4,096, ``reconstruct_method=plm`` and ``=weno5``
   for 1,024 each, and ``fast_step=0`` (one B5 call a step) for 256, every
   B5 call counted; prints each run's whole-run rate and B5's design;
19. timing at 524,288 cells float32, in turns: B5 and advance_n_plain per
   step and per 128-step call, Euler pcm and SRHD pcm, on the states the
   main path ended in, beside the bound, and B5's streaming march beside
   its resident one; then a B5 step's floor (a 128-step call at 1,000
   cells) and a time-series row's time at 524,288 cells;
20. B4 parity: kernel B4's four entries (csrc/cloud_update.cu) against
   their plain versions on the card over {pcm, plm} x {B4a, B4b and B4c
   from a warm and a cold pressure, B4d rk1 and rk2} x {float64, float32},
   at 100 x 50 cells (no TPU rule allows it) for B4d n in {1, 3, 17} and at
   2,048 x 1,024 for B4d n = 4; the state and the carried pressure, float64
   at the CPU bars, float32 at 64 ulps of each cell's largest component;
21. cloud card against CPU: ``cloud nr=64`` rk2 plm, float64, 11 steps of
   B4d on the card against its plain version on the CPU;
22. cloud main path: ``cloud nr=1024 rk_order=2`` (2,048 x 1,024 cells)
   with the defaults (float32, the chunked loop: B4d calls of up to 64
   steps) through cloud.setup() and cloud.run() for 256 steps (the run
   stays finite to step 305) with the diagnostics computed at the end;
   then ``cloud nr=1024`` (rk1) for 256, and the per-step loop
   (``fast_step=0``: B4c a step for rk2, B4b for rk1) for 32 each, every B4
   call counted; prints each run's whole-run rate;
23. timing at 2,048 x 1,024 float32 plm, in turns, on the state the main
   path ended in: B4a, one B4b stage, one B4c step and one 64-step B4d call
   against their plain versions, beside the bound; the Newton updates a
   cell; the diagnostics' time at full size;
24. B6 parity: kernel B6 (csrc/amrsand_step.cu) against advance_n_plain on
   the card at depth 3 / block 8 (every face case) and depth 7 / block 64,
   n in {1, 3, 17}, from seeded states, through both designs (resident
   and launch-a-step); float64 at the CPU bars, float32 each element
   within 64 ulps of its cell, and every case bit for bit;
25. amrsand card against CPU: ``amrsand depth=3 block_size=16
   tfinal=0.25`` in float64, with and without ``regrid=1 rgi=0.05``, B6 on
   the card against the scheme on the CPU, the same meshes at the end;
26. amrsand main path: ``amrsand depth=7 block_size=64`` (652 blocks of
   64^2, float32, the chunked loop: B6 calls of up to 256 steps) through
   amrsand.setup() and amrsand.run() to the default tfinal=1.0 (8,192
   steps), with a task runner that copies each diagnostics write's state to
   the host and tests it, writing no files; prints the whole-run rate, B6's
   calls, launches and design, and the writes' wall time; then ``regrid=1
   rgi=0.1 tfinal=0.3`` at the same width, with each regrid's blocks and
   host time, and the time of remap_blocks alone;
27. timing at depth 7 / block 64 float32, in turns: B6 and advance_n_plain
   per step and per 256-step call, the marginal rate between 10 and 110
   steps (bench_all.py:264's window), beside the bound; the launch-a-step
   design beside the resident one; and a step per cell at block 128, whose
   state fits in neither the shared memory nor the L2 (the launch-a-step
   design);
28. B7 parity: kernel B7 (csrc/sand3d_step.cu) against advance_n_plain at
   depth 3 / block 8 and depth 4 / block 16, n in {1, 3, 17}; float64 at
   the CPU bar (1e-13 of max |u|), float32 as in phase 24;
29. sand3d card against CPU: ``sand3d depth=3 block_size=8 tfinal=0.1``
   in float64, B7 on the card against the scheme on the CPU;
30. sand3d main path: ``sand3d depth=4 block_size=16 tfinal=1.0`` (344
   blocks of 16^3, float32, 384 steps in one B7 call) through
   sand3d.setup() and sand3d.run(); then B7's timing as in phase 27, the
   call being the main path's 384 steps;
31. B11 parity: kernels B11a and B11b (the "split" advance) and B11c (the
   "jnp_strips" advance) against their plain versions on the inputs of
   their scheme fronts, at depth 3 / block 16 over {conserve_linear_p} x
   {plm, pcm} (x {hlle, hllc} for B11c) and at d6b96, float64 at the CPU
   bars and float32 at 64 ulps of each cell; then each timed against its
   plain version at d6b96 float32, beside its bound;
32. the variant path: make_advance(fused=v) at d6b96 float32 for v in True,
   "jnp_strips", "split" and False: one advance of each against fused=False
   (64 ulps of each cell), the kernels each launches, and
   benchmarks/bench_flagship.py's marginal rate (5 and 45 advances, the
   bodies and dt on the device), every B11 launch counted;
33. regrid, card against CPU: ``binary depth=4 block_size=8 regrid=1
   rgi=0.01 tfinal=0.03`` in float64 through both loops (fast_step=0 with
   B2; fast_step=1 multi_launch=4 with B3): the same final leaves, the
   state at the CPU bars;
34. regrid at full width: ``binary depth=6 block_size=96 regrid=1
   focus_factor=0.5`` on the main path (fast_step=1, multi_launch=16),
   tfinal and rgi 17 and 3 times the first step's dt: the run starts on 4
   blocks and the regrids refine it toward the flagship's 136 (at the
   default focus no regrid after t = 0 changes the tree). Each regrid's blocks and host time, the B3 launches between
   regrids, the whole-run rate and the finite end; at least two regrids
   must change the tree;
35. ladder parity: kernel B9 (csrc/iso2d_ladder.cu) against its plain
   version over {rk1, rk2} x {hlle, hllc} x {periodic, random strips},
   and B10a, B10b and B10c against theirs, at 96 x 160 (B9 in stripes of
   32, G = 2) and at 2048^2 (bench.py's v4 and v3 configurations, G = 4),
   float64 at the CPU bars and float32 at 64 ulps of each cell; then G
   steps of each kernel's periodic wrapper against B1 in rk1 hlle, bit for
   bit expected (printed; held at the ulp bar if not);
36. the sharded module on one card: make_advance_v4_sharded over 4 shards
   of cuda:0 at 2048^2 float32 for 64 steps, bitwise equal to one shard
   (and compared with B1), rk1 hlle and rk2 hllc;
37. kh sharded, card against CPU: ``kh N=256 shards=-1`` (B9 on the card)
   against ``shards=2`` (B9's plain version on the CPU), float64, 12 steps;
38. kh sharded main path: ``kh N=2048 shards=-1`` (float32, rk1 hlle)
   through kh.setup() and kh.run() for 2,000 steps, then rk2 hllc for
   600, every B9 call counted (one a shard and grain of 4 steps); prints
   the whole-run rates beside phase 13's B1 rates;
39. the ladder's bench-shaped rates: bench.py's run_pallas (B9, G = 4, TX
   = 256) and run_pallas_v3 (B10c, G = 4, tile 64 x 1024) protocol, the
   marginal rate between 52 and 4,052 steps, median of 5 pairs by CUDA
   events, beside phase 14's B1 rate; one step of B10a and B10b with their
   extension or strips; every B10a-c launch counted;
40. timing at 2048^2 float32, in turns: B9 (4 steps a call), B10a, B10b
   and B10c (4 steps a call) against their plain versions, beside the
   bound, B9 also beside the earlier window design's time (B9_WINDOW_*);
   each new phase prints its wall time;
41. B8 parity: kernel B8 (csrc/iso2d_ladder.cu, the locally isothermal
   window step) against its plain version, G in {1, 2, 4} at 96 x 160 in
   tiles of 32 x 32, in a domain beside the origin and one across r = 0,
   with periodic and with random strips, and at the kernel sweep's 8192^2
   (tile 128 x 512, G = 4); float64 at the CPU bars and float32 at 64 ulps
   of each cell, with the count of cases that are bit for bit;
42. B8's path: benchmarks/bench_kernel_sweep.py's lig4 rung (copied here:
   the benchmark imports JAX) at n = 8192 through advance_n_li, the
   marginal rate between 20 and 420 steps, median of 5 pairs by CUDA
   events, every B8 launch counted, the mass conserved; its v3g4 rung
   (B10c) beside it;
43. timing at 8192^2 float32, in turns: B8 and its plain version per
   4-step call, beside the bound; B10c and the strips' build beside them;
44. blast3d card against CPU: ``blast3d depth=3 block_size=8 tfinal=0.06
   dfi=0.03`` in float64, the same windows, the state at rtol 1e-12;
45. blast3d main path: ``blast3d depth=4 block_size=16`` with the defaults
   (344 blocks of 16^3, float32, to t = 0.25) through blast3d.setup() and
   blast3d.run(): the whole-run rate, each window's steps and wall time,
   the finite end and the drift of the totals (blast3d has no kernel in
   either package: its step is torch ops on the card);
46. benchmarks/bench_blast3d.py's protocol at depths 3 and 4, block 16:
   the marginal rate between 100 and 300 steps at dt = 0.1 dx_min / a0 /
   3, median of 3 pairs, the totals' drift, and a step's device kernels
   and busy share under torch.profiler;

then prints one JSON line describing the kernels and, last, the ok line.
``--profile PATH`` also writes torch.profiler tables of a d6b96 B2 advance,
a reference-loop step, a B3 launch, a 64-step chunk of the fast loop, a
64-step kh chunk at 2048^2, a 128-step sedov chunk at 524,288 cells, a
64-step cloud chunk at 2,048 x 1,024, a 256-step amrsand chunk at depth 7
/ block 64 and a 384-step B7 call at depth 4 / block 16 to PATH, with the
device's busy share of the step and of the chunks.
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
# kernel B1 in float64: the bar of the CPU test of its plain version against
# the JAX B1 (tests/test_torch_kh.py)
B1_F64 = dict(rtol=1e-13, atol=1e-13)

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
# Kernel B1 (csrc/iso2d_step.cu), counted the same way per cell and stage,
# as the function needs them (each half-slope once per cell and axis; the
# kernel computes them twice, and its halo cells again):
#   recovery            2 (two divides)
#   half-slopes        66 (3 variables x 2 axes x 11: 3 subtracts, 3
#                          multiplies, 3 abs, 2 min)
#   face states        12 per cell (6 per face, one x- and one y-face a cell)
#   HLLE               96 (48 per face: wave speeds 8, momenta and pressures
#                          6, physical fluxes 8, 1 / (ap - am) 2, fluxes 24)
#   HLLC              114 (57 per face: pressures 2, ppvrs 8, pstar 1, ql and
#                          qr 6, sl, sr 4, kl, kr 4, sstar 7, momenta 4,
#                          physical fluxes 8, at most one star state and
#                          flux 13)
#   update             18 (per component 2 differences, 2 multiplies, add,
#                          subtract)
#   RK2 average         6 per cell and step
# A call of n steps reads the state once and writes it once.
B1_OPS_CELL_STAGE = {"hlle": 2 + 66 + 12 + 96 + 18,
                     "hllc": 2 + 66 + 12 + 114 + 18}
B1_OPS_CELL_RK2_STEP = 6
B1_VALUES_PER_CELL = 6
# Kernel B1's earlier design (16 x 32 shared-memory tiles, every half-slope
# taken twice, before the column march of csrc/iso2d_march.cuh): its times
# at 2048^2 float32 rk1 hlle, one-step call and 16-step call, from PERF.md
# section 6's B1 row (NVIDIA H100 80GB HBM3, 700.00 W); phase 15 prints
# them beside the march's
B1_TILE_STEP_MS, B1_TILE_CALL16_MS = 0.1100, 1.7536
# phase 11: the odd shape and its step counts; phase 13's step counts
B1_ODD_SHAPE = (96, 160)
B1_ODD_STEPS = (1, 3, 16)
KH_N = 2048
KH_STEPS = 2000
KH_RK2_STEPS = 600
# phase 12: kh's card-against-CPU bar (float64)
KH_CARD_CPU = dict(rtol=1e-12, atol=1e-14)
# Kernel B5 (csrc/sedov_step.cu, with csrc/srhd_recover.cuh), counted the
# same way per cell and step, as the function needs them, for pcm. A face's
# two sides are its neighbour cells' primitives, so each cell's side of the
# HLLE (conserved state, wave speeds, physical flux) is needed once, and
# once more a step for the mirrored guard cell at face 0:
#   Euler  147: U / dv 5, recovery 12, HLLE 85 (one side 40: conserved
#               state 12, wave speeds 10, physical flux 18; ap and am 4,
#               the five fluxes 41), source 5, update 40 (8 a component)
#   SRHD   210: U / dv 5, recovery 25 outside the Newton (|S|^2 5, floor 3,
#               1/D 1, final W, 1/(tau + D + p) and the primitives 11, the
#               rest 5), HLLE 138 (one side 93: conserved state 21, wave
#               speeds 46, physical flux 26; ap and am 4, the five fluxes
#               41), source 7, update 40
#   plus 40 a Newton update (3 reciprocals and an rsqrt among them), at the
#   count of updates the run's data needs (b5_newton_per_cell_step)
# plm and weno5 give each face its own two sides, so they add one side a
# cell, and plm 105 a cell (five limited slopes of 17, face states 20),
# weno5 670 (two reconstructions of 67 a component and face).
B5_OPS_CELL_STEP = {"euler": 147, "srhd": 210}
B5_OPS_SIDE = {"euler": 40, "srhd": 93}
B5_OPS_NEWTON_UPDATE = 40
# An n-step call must read the state and the vertices once and write the
# state once (b5_bound). The geometry rows are formed from the vertices,
# and the SRHD warm pressure is scratch zeroed at every call: neither is an
# input or an output of the function.
# kernel B5 in float64: the bars of the CPU tests of its plain version
# against the scheme (tests/test_torch_sedov_kernel.py), which are the JAX
# package's for its B5 (tests/test_subprograms_1d.py:214-215)
B5_F64 = {"euler": dict(rtol=1e-11, atol=1e-13),
          "srhd": dict(rtol=1e-8, atol=1e-10)}
# phase 16: a cell count no TPU rule allows (nr=500: 1,000 cells) and its
# step counts; phases 16-19: the repo's benchmark grid
# (benchmarks/bench_all.py:92-109: 262,144 zones a decade, 524,288 cells)
SEDOV_ODD_NR = 500
B5_ODD_STEPS = (1, 3, 17)
SEDOV_NR = 262144
# phase 18's runs: (extra argv, steps, per-step loop)
SEDOV_RUNS = ((), 4096, False), (("newtonian=1",), 4096, False), \
    (("reconstruct_method=plm",), 1024, False), \
    (("reconstruct_method=weno5",), 1024, False), \
    (("fast_step=0",), 256, True)
SEDOV_ROWS = 4           # time-series rows a run takes after its first
# Kernel B4 (csrc/cloud_update.cu with csrc/srhd_recover.cuh), counted the
# same way per cell and stage, as the function needs them: each limited
# slope once per cell and axis, the two sides of each face's HLLE (pcm: a
# cell's side once per axis, shared by its two faces), one radial and one
# polar face a cell (the extra row of faces and the zero pole faces count
# none):
#   recovery    30 outside the Newton (1/dv and U 6, |S|^2 5, its floor 3,
#                  max(p, 0) 1, 1/D 1, 1/W 1, the temperature floor 3,
#                  1/(tau + D + p) 3, the primitives 7), plus 40 a Newton
#                  update (as B5), at the count the run's data needs
#                  (b4_newton_per_cell_stage)
#   slopes      85 a cell and axis (plm: five limited slopes of 17)
#   face states 20 a face (plm)
#   HLLE side   56 (|u|^2 5, rsqrt and W 3, rho h 2, D 1, U 10, vn 1,
#                  c2 3, vv 2, v2 1, k0 9, 1/(1 - vv c2) 3, am and ap 8,
#                  the physical flux 8)
#   HLLE       46 a face besides its sides (ap, am and 1/(ap - am) 6, the
#                  five fluxes 40)
#   sources     23, update 60 (12 a component), RK2 average 15 a step
# So a stage is 30 + 2 (85 + 20 + 2 x 56 + 46) + 23 + 60 = 639 a cell for
# plm, 30 + 2 (56 + 46) + 23 + 60 = 317 for pcm; B4a, given the
# primitives, 30 fewer. An n-step call must read the state, the warm
# pressure and the vertices once and write the state and the pressure once
# (b4_bound); the geometry rows are formed from the vertices and the inflow
# rows from the time, so neither is an input of the function.
B4_OPS_CELL_STAGE = {1: 317, 2: 639}
B4_OPS_RECOVERY = 30
B4_OPS_NEWTON_UPDATE = 40
B4_OPS_RK2_AVERAGE = 15
# kernel B4 in float64: the bars of the CPU tests of its plain versions
# against the port's scheme (tests/test_torch_cloud_kernel.py)
B4_F64 = dict(rtol=1e-10, atol=1e-14)
# phase 20: a shape no TPU rule allows (nr=50: 100 x 50 cells) and its
# step counts; phases 20-23: the repo's cloud grid
# (benchmarks/bench_product_cloud.py:33-45, BASELINE.md:94: nr=1024,
# 2,048 x 1,024 cells)
CLOUD_ODD_NR = 50
B4_ODD_STEPS = (1, 3, 17)
CLOUD_NR = 1024
CLOUD_BIG_STEPS = 4
# phase 22's runs: (extra argv, steps, per-step loop, the kernel it runs).
# The configuration goes non-finite in float32 at step 306 (rk2) and 290
# (rk1), through the kernel, its plain versions and the scheme alike: the
# inner boundary empties to vacuum (tools/torch_cloud_product.py, ROADMAP
# §C). So the runs stop at 256 steps, four B4d calls of 64.
CLOUD_RUNS = ((("rk_order=2",), 256, False, "b4d"),
              ((), 256, False, "b4d"),
              (("rk_order=2", "fast_step=0"), 32, True, "b4c"),
              (("fast_step=0",), 32, True, "b4b"))
# Kernels B6 (csrc/amrsand_step.cu) and B7 (csrc/sand3d_step.cu), counted
# the same way per cell and step: B6 2 u, two subtracts, the product with c
# and the update (5); B7 three subtracts, three products, two sums and the
# update (9); the guards' averages (on block edges only) count none. A call
# of n steps must read the state and its face table and courant factors
# once and write the state once (b6_bound, b7_bound).
B6_OPS_CELL_STEP = 5
B7_OPS_CELL_STEP = 9
# phases 24-27: the repo's amrsand benchmark configuration
# (benchmarks/bench_all.py:233-266, BASELINE.md:95 "amrsand d8b64": the
# tree is one level deeper than `depth`), 652 blocks of 64^2, and the
# marginal window of bench_all.py:264; phases 28-30: the repo's 3D product
# run (BASELINE.md:505-516), 344 blocks of 16^3
AMR_DEPTH, AMR_BS = 7, 64
AMR_BLOCKS = 652      # the depth-7 tree's leaves (phase 26 checks them)
AMR_MARGINAL = (10, 110)
SAND3D_DEPTH, SAND3D_BS = 4, 16
AMR_STEPS = (1, 3, 17)
# B6 in float64: the JAX package's bar for its B6 against the scheme
# (tests/test_mesh_amr.py:268-269); B7 the JAX bars for its B7, times
# max |u| (tests/test_sand3d_kernel.py:55-56); whole runs, card against
# CPU, the bar of tests/test_torch_amrsand.py's runs
B6_F64 = dict(rtol=1e-13, atol=1e-15)
B7_BAR = {"float64": 1e-13, "float32": 5e-6}
AMR_RUN = dict(rtol=1e-12, atol=1e-14)


# Kernels B11a-c (csrc/binary_update.cu and csrc/binary_advance_strips.cu,
# with csrc/binary_tpu_flux.cuh), counted the same way for the main path's
# configuration (PLM, HLLE, conserve_linear_p=1, alpha viscosity without a
# cutoff):
#   face_flux_tpu 107 a face (the half face 1, face states 12, cs2_at 18, r
#                 4, nu 5, mu 3, cs 1, conserved states 4, pressures 2,
#                 physical fluxes 8, wave speeds 8, B11a's HLLE 24: 1 / (ap -
#                 am) 2, ap am 1, 7 a component; viscous stress 14, face
#                 length 3); B11c's HLLE divides (25), so 108, and forms the
#                 face's position (6): 114
#   update_cell   120 a cell (gravity and sinks 48, buffer and floor 29, the
#                 update 12, totals 31), after the divergence (9)
#   B11c also     slopes 108 a cell (as B2), the position 6, the buffer
#                 rate 10, dA 1
# Bytes, each input read once and each output written once: B11a (both
# axes, as an advance launches it) the extended p, g_lon and g_tra (9 values
# a cell and guard cell) and the face centers (2 a face) in, the fluxes (3 a
# face) out; B11b u0, p0, init, xc, br and dA (13 a cell) and the fluxes (3
# a face) in, u1 (3 a cell) out; B11c u0, p and init (9 a cell), the strips
# (9 a block edge cell, 4 edges) and (x0, y0, dx) in, u1 (3 a cell) and the
# edge fluxes (3 a block edge cell) out.
B11_OPS = {"b11a_face": 107, "b11b_cell": 9 + 120,
           "b11c_cell": 108 + 9 + 120 + 6 + 10 + 1, "b11c_face": 114}
# phases 31-33: the variants' configurations, as tests/test_torch_binary_
# variants_kernel.py has them; the variant path's bar against fused=False
# in float32 (the same bar as each kernel against its plain version: the
# variants differ from the reference in their rounding by a few ulps of a
# cell, measured 1.4 with the plain versions at depth 5 / block 48)
SPLIT = [{"conserve_linear_p": cp, "reconstruct_method": rm}
         for cp in (1, 0) for rm in ("plm", "pcm")]
STRIPS = [{**o, "riemann": rs} for o in SPLIT for rs in ("hlle", "hllc")]
VARIANTS = (True, "jnp_strips", "split", False)
# phase 32: bench_flagship.py's marginal protocol (benchmarks/
# bench_flagship.py:58-80): the best of 3 runs of n1 and of n2 advances,
# each ended by a read of the state
FLAGSHIP_MARGINAL = (5, 45)
# phase 34: the main path from REGRID_START, a regrid every REGRID_EVERY
# and tfinal at REGRID_LENGTH times the first step's dt. At d6b96 with the
# default focus no regrid after t = 0 changes the tree: the sinks pin the
# center blocks at the finest level within a step, and the 2:1 balance holds
# the rest. With focus_factor=0.5 the run starts on 4 blocks, and each
# regrid refines the center a level, halving dt: on the CPU, 4 -> 16 -> 28
# -> 64 -> 100 -> 136 blocks, the flagship's mesh, in about 230 steps.
REGRID_START = ["regrid=1", "focus_factor=0.5"]
REGRID_EVERY, REGRID_LENGTH = 3, 17
# phases 31, 32 and 34: the flagship configuration (d6b96)
FLAGSHIP = {"depth": 6, "block_size": 96}
# phase 33: the regrid run of tests/test_torch_binary_regrid.py, card
# against CPU, at its bars
REGRID_ARGS = ["binary", "depth=4", "block_size=8", "regrid=1", "rgi=0.01",
               "tfinal=0.03"]


# Kernels B9, B10a, B10b and B10c (csrc/iso2d_ladder.cu) do B1's
# arithmetic per cell and stage (B1_OPS_CELL_STAGE, B1_OPS_CELL_RK2_STEP).
# The functions they compute (G steps of each tile or stripe from its
# window, the strips given) need every stage's update on each window, the
# halo included, and a window shrinks by 2 cells a side a stage:
# ladder_bound counts those updates (window_updates). Bytes: each input
# (the state and its strips, or the extended state) read once, the state
# written once. B10a and B10b take one step a call, B9 and B10c G.
# Kernel B9's earlier design (512-thread CTAs of 32 x 32 cells in 48 x 48
# windows): its time per 4-step call at 2048^2 float32 rk1 hlle in stripes
# of 256, from PERF.md section 6's B9 row (NVIDIA H100 80GB HBM3, 700.00
# W); phase 40 prints it beside the march's
B9_WINDOW_CALL_MS = 0.6610
# phase 35's odd shape (no TPU rule allows it): B9 in stripes of 32 with
# G = 2, B10b and B10c in tiles of 32 x 32
LADDER_ODD = (96, 160)
LADDER_ODD_TX, LADDER_ODD_G, LADDER_ODD_TILE = 32, 2, (32, 32)
# bench.py's configurations (bench.py:98-121): v4 with G = 4 and TX = 256,
# v3 with G = 4 and tile (64, 1024); v2 at its default tile
# (iso2d_step_v2.py:116)
LADDER_G, LADDER_TX = 4, 256
LADDER_V2_TILE, LADDER_V3_TILE = (256, 512), (64, 1024)
# phase 36: steps of the sharded module on one card; phase 37: kh card
# against CPU, three grains
SHARDED_STEPS = 64
KH_SHARDED_CPU_STEPS = 12

# Kernel B8 (csrc/iso2d_ladder.cu, the locally isothermal window step) does
# B10c's arithmetic per cell and stage (B1_OPS_CELL_STAGE["hlle"]) and, at
# each of a cell's two faces, forms the face's sound speed: cs^2 = 1 / (M^2
# sqrt(x^2 + y^2 + r_s^2)) 7 (two products, two sums, the sqrt, the product
# with M^2, the division) and cs = sqrt(cs^2) 1. A face's wrapped
# coordinates depend on its row or its column alone (16 a line of faces:
# the position 3 and the wrap 5 an axis), so they count none, and the count
# errs low, as above.
B8_OPS_FACE = 8
# phases 41-43: benchmarks/bench_kernel_sweep.py's lig4 rung (:82-87,
# :135-142): n = 8192, tile 128 x 512, G = 4, geom (1/n, 1, 1, 1, 1, 100,
# 1e-4), dt = 1e-5, the marginal between 20 and 420 steps; its v3g4 rung
# (cs^2 0.01) beside it
LI_N, LI_TILE, LI_G = 8192, (128, 512), 4
LI_DT = 1e-5
LI_MARGINAL = (20, 420)
# phase 41's odd shape (no TPU rule allows it) in tiles of 32 x 32, in a
# domain beside the origin and in one that straddles r = 0 (r_s^2 matters
# there), Lx != Ly in both
LI_ODD, LI_ODD_TILE = (96, 160), (32, 32)
LI_ODD_GEOMS = ((1 / 96, 1.0, 1.0, 1.0, 160 / 96, 100.0, 1e-4),
                (1 / 96, -0.5, -0.75, 1.0, 160 / 96, 100.0, 1e-2))
# phases 44-46: blast3d (no kernel in either package). Card against CPU at
# tests/test_torch_blast3d.py's run and bar; the main path, BASELINE.md:526-
# 535's blast3d_d4b16 product run (344 blocks of 16^3 to t = 0.25 with the
# defaults); benchmarks/bench_blast3d.py's protocol (depths 3 and 4, block
# 16, the marginal between 100 and 300 steps at dt = 0.1 dx_min / a0 / 3,
# the totals' drift under 1e-4 of the larger of mass and energy)
BLAST_CPU_ARGS = ["blast3d", "depth=3", "block_size=8", "tfinal=0.06",
                  "dfi=0.03"]
BLAST_RUN = dict(rtol=1e-12, atol=1e-14)
BLAST_DEPTH, BLAST_BS = 4, 16
BLAST_BENCH_DEPTHS = (3, 4)
BLAST_MARGINAL = (100, 300)
BLAST_DRIFT = 1e-4


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


def kernel_split(fn, reps):
    """{B3 kernel or "other": (device us per call, launches per call)} of
    reps calls of fn under torch.profiler, its rows grouped by kernel
    name."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from mara3_tpu_torch.kernels import binary_multi as TM
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA],
                 acc_events=True) as prof:
        for _ in range(reps):
            fn()
        torch.cuda.synchronize()
    split = {name: [0.0, 0] for name in (*TM.KERNELS, "other")}
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA:
            continue
        name = next((k for k in TM.KERNELS if k + "_kernel" in e.key),
                    "other")
        split[name][0] += e.self_device_time_total / reps
        split[name][1] += e.count / reps
    return {k: tuple(v) for k, v in split.items()}


def march_summary(log):
    """One line per column-march kernel instance (csrc/iso2d_march.cuh) of
    an nvcc -Xptxas=-v log: its type and solver, registers, spills and
    shared memory."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for \S*march_kernelI([fd])Lb([01])",
                      line)
        if m:
            name = (f"march_kernel<{'float' if m.group(1) == 'f' else 'double'}"
                    f", {'hllc' if m.group(2) == '1' else 'hlle'}>")
            continue
        if "Function properties for" in line:
            name = None
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = f"{m.group(1)} B spill stores"
            continue
        m = re.search(r"Used (\d+) registers.*?(\d+) bytes smem", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {spill}, "
                         f"{m.group(2)} B shared")
            name = None
    return lines


def ptxas_summary(log):
    """One line per B3 kernel instance of an nvcc -Xptxas=-v log: its
    registers, stack frame and spills."""
    lines, name, frame = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"(b3_\w+?)_kernelI([fd])", m.group(1))
            dtype = "float32" if k and k.group(2) == "f" else "float64"
            name = k and f"{k.group(1)} {dtype}"
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and name:
            frame = (f"{m.group(1)} B stack, {m.group(2)} B spill stores, "
                     f"{m.group(3)} B spill loads")
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {frame}")
            name = None
    return lines


def kernel_summary(src, log):
    """One line per kernel instance of csrc/<src>.cu's nvcc -Xptxas=-v log
    (B6's step_kernel and resident_kernel, B5's march_kernel<type, method,
    system, design>): its registers and spills."""
    lines, name, spill = [], None, ""
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            k = re.search(r"(step_kernel|resident_kernel|march_kernel)I([fd])"
                          r"(?:Li(\d)E(?:Lb(\d)ELb(\d)E)?)?", m.group(1))
            name = None
            if k:
                parts = ["float32" if k.group(2) == "f" else "float64"]
                if k.group(3) and not k.group(4):
                    parts.append(f"{k.group(3)} columns a lane")
                elif k.group(3):
                    parts += [("pcm", "plm", "weno5")[int(k.group(3)) - 1],
                              ("euler", "srhd")[int(k.group(4))],
                              ("streaming", "resident")[int(k.group(5))]]
                name = f"{src}.cu {k.group(1)}<{', '.join(parts)}>"
            continue
        m = re.search(r"(\d+) bytes spill stores", line)
        if m and name:
            spill = f"{m.group(1)} B spill stores"
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            lines.append(f"{name}: {m.group(1)} registers, {spill}")
            name = None
    return lines


def resident_phase2(logs, smi):
    """Phase 2's lines of kernels B6 and B5 (csrc/resident_loop.cuh):
    ptxas's registers and spills of each kernel, and the occupancy
    calculator's CTAs an SM at the shared memory of the main paths' plans
    (amrsand d7b64, sedov 524,288 cells pcm), which must fit; B6's
    step_kernel and resident_kernel<type, C> (C columns a lane: 1 up to
    block 32, 2 at 64, 4 at 128), B5's march_kernel<type, method, system,
    design>."""
    import torch
    from mara3_tpu_torch.kernels import amrsand_step as T6
    from mara3_tpu_torch.kernels import resident_loop as RL
    from mara3_tpu_torch.kernels import sedov_step as T5
    for src in ("amrsand_step", "sedov_step"):
        lines = kernel_summary(src, logs[src])
        check(len(lines) == (8 if src == "amrsand_step" else 24),
              f"{src}.cu's report lists {len(lines)} kernels")
        for line in lines:
            print(f"ptxas {line}")
    limits = RL.device_limits(T6._library().b6_device_limits)
    print(f"card limits: {limits} ({smi})")
    for dtype in (torch.float32, torch.float64):
        size = torch.empty((), dtype=dtype).element_size()
        plan = T6.resident_plan(AMR_BLOCKS, AMR_BS, size, limits)
        check(plan is not None, f"d{AMR_DEPTH}b{AMR_BS} does not fit")
        for design, nb in (("resident", plan.nb_max), ("per_step", 0)):
            info = T6.kernel_info(dtype, design, nb, AMR_BS)
            check(info["ctas_per_sm"] >= 1, f"B6 {design} fits no CTA")
            print(f"amrsand_step.cu {design} {str(dtype)[6:]} at "
                  f"d{AMR_DEPTH}b{AMR_BS} ({plan.ctas} CTAs of {nb} blocks): "
                  f"{info['registers']} registers, {info['local_bytes']} B "
                  f"local, {info['dynamic_smem']} B shared, "
                  f"{info['ctas_per_sm']} CTAs an SM ({smi})")
        plan = T5.march_plan(2 * SEDOV_NR, "pcm", size, limits)
        design = "resident" if plan.resident else "streaming"
        for system in T5.SYSTEMS:
            info = T5.kernel_info(dtype, "pcm", system, design, plan.lmax)
            check(info["ctas_per_sm"] >= T5.CTAS_PER_SM[size],
                  f"B5 {design} {system} fits {info['ctas_per_sm']} CTAs")
            print(f"sedov_step.cu {design} march {str(dtype)[6:]} {system} "
                  f"pcm at {2 * SEDOV_NR} cells ({plan.ctas} segments of "
                  f"<= {plan.lmax}): {info['registers']} registers, "
                  f"{info['local_bytes']} B local, {info['dynamic_smem']} B "
                  f"shared, {info['ctas_per_sm']} CTAs an SM ({smi})")


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


def drive(TB, argv, steps, device, outdir, rgi_steps=None):
    """setup() and run() of `argv` cut to about `steps` steps of the first
    step's dt, with a regrid every `rgi_steps` such dt when given: (cfg, sd,
    final state, log, wall seconds)."""
    import torch
    cfg, sd, state = TB.setup(argv + [f"outdir={outdir}"], device=device,
                              dtype=torch.float32)
    bodies = TB.bodies_array(TB.two_body.compute_two_body_state(
        state.solution.orbital_elements, 0.0))
    dt0 = sd.cfl_number * float(sd.maximum_timestep(
        state.solution.conserved, bodies))
    cfg = cfg.set("tfinal", (steps - 0.5) * dt0 / (2 * math.pi))
    if rgi_steps:
        cfg = cfg.set("rgi", rgi_steps * dt0 / (2 * math.pi))
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


def b1_bar(got, want, dtype):
    """Kernel B1's state [3, nx, ny] against the plain version's: (max
    |du|, max |du| in ulps of its cell's largest component), raising on a
    non-finite value, past the float64 CPU bar, or past F32_ULPS ulps of the
    cell in float32."""
    import numpy as np
    import torch
    u, r = got.double().cpu().numpy(), want.double().cpu().numpy()
    check(bool(np.isfinite(u).all()), "non-finite B1 state")
    diff = np.abs(u - r)
    ulp = np.finfo(str(dtype)[6:]).eps * np.abs(r).max(axis=0, keepdims=True)
    err, in_ulps = float(diff.max()), float((diff / ulp).max())
    if dtype == torch.float64:
        check(allclose(u, r, **B1_F64), f"B1 f64 state off by {err:.3e}")
    else:
        check(bool(np.all(diff <= F32_ULPS * ulp + F32_ATOL)),
              f"B1 f32 state off by {in_ulps:.1f} ulps of its cell")
    return err, in_ulps


def b1_bound(u, n, rk, riemann):
    """(ms, "bytes" or "operations"): the least time for n steps of kernel
    B1 on u [3, nx, ny], reading and writing the state once."""
    cells = u.shape[1] * u.shape[2]
    ops = n * cells * (rk * B1_OPS_CELL_STAGE[riemann]
                       + (rk == 2) * B1_OPS_CELL_RK2_STEP)
    t_bytes = B1_VALUES_PER_CELL * cells * u.element_size() / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def seeded_iso2d(nx, ny, dtype, device, seed=0):
    """A seeded state [3, nx, ny] of density 1-1.2 and speeds ~0.1."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    sg = 1.0 + 0.2 * rng.uniform(size=(nx, ny))
    vx = 0.1 * rng.normal(size=(nx, ny))
    vy = 0.1 * rng.normal(size=(nx, ny))
    return torch.tensor(np.stack([sg, sg * vx, sg * vy]), dtype=dtype,
                        device=device)


def bench_state(n, device):
    """bench.py's initial state [3, n, n] in float32 (bench.py:30-36)."""
    import torch
    f32 = torch.float32
    x = torch.linspace(-1, 1, n, dtype=f32, device=device)[:, None]
    y = torch.linspace(-1, 1, n, dtype=f32, device=device)[None, :]
    sigma = 1.0 + 0.5 * torch.exp(-(x ** 2 + y ** 2) / 0.1)
    vx = 0.1 * torch.sin(2 * math.pi * y) * torch.ones_like(sigma)
    vy = -0.1 * torch.sin(2 * math.pi * x) * torch.ones_like(sigma)
    return torch.stack([sigma, sigma * vx, sigma * vy], dim=0).contiguous()


def marginal_rate(f, zones, n1, n2, pairs=5):
    """bench.py's protocol on the card: `pairs` marginal rates between n1
    and n2 steps, each point the best of 2, timed with CUDA events; returns
    (median zone-updates per second, spread (max - min) / median, rates)."""
    import torch
    f(n1)
    f(n2)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    stop = torch.cuda.Event(enable_timing=True)

    def once(n):
        start.record()
        f(n)
        stop.record()
        torch.cuda.synchronize()
        return start.elapsed_time(stop) / 1e3

    rates = []
    for _ in range(pairs):
        t1 = min(once(n1) for _ in range(2))
        t2 = min(once(n2) for _ in range(2))
        rates.append(zones * (n2 - n1) / (t2 - t1))
    rates.sort()
    median = rates[len(rates) // 2]
    return median, (rates[-1] - rates[0]) / median, rates


def kh_record_only(KH, samples):
    """kh's task runner that records the time series in `samples` and writes
    no files."""
    def tasks(state, cfg):
        for task in KH.TASKS:
            if state.schedule.is_due(task):
                if task == "write_time_series":
                    samples.append(KH.compute_time_series_data(
                        state.solution, cfg))
                state = KH.State(state.solution,
                                 state.schedule.mark_as_completed(task))
        return state
    return tasks


def drive_kh(KH, wrapper, argv, steps, device):
    """kh's setup() and run() of `argv` cut to `steps` steps, the count of
    the kernel wrapper `wrapper` (B1's, or B9's on the sharded run) set to 0
    just before the run: (final state, log, wall seconds, time-series
    samples, the wrapper's launches)."""
    import torch
    cfg, state = KH.setup(argv, device=device)
    cfg = cfg.set("tfinal", (steps - 0.5) * state.solution.dt)
    print(f"{argv[1:]}: tfinal={cfg.get_double('tfinal'):.6e} ({steps} "
          f"steps of dt {state.solution.dt:.6e})")
    samples = []
    tee = Tee(sys.stdout)
    wrapper.launches = 0
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        final = KH.run(cfg, state, tasks=kh_record_only(KH, samples))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return final, tee.buf.getvalue(), wall, samples, wrapper.launches


def check_kh(final, log, samples, calls, n, steps, path, grain=None,
             shards=1):
    """A kh run's end: the state's shape, finite values, positive density,
    the mass kept, every chunk one B1 call (or, sharded, one B9 call a
    shard and grain of `grain` steps); returns the chunk kzps."""
    import torch
    u = final.solution.conserved
    check(tuple(u.shape) == (n, n, 3) and u.dtype == torch.float32,
          f"kh state {tuple(u.shape)} {u.dtype}")
    check(final.solution.iteration == steps,
          f"kh ran {final.solution.iteration} steps, not {steps}")
    check(bool(torch.isfinite(u).all()), "non-finite kh state")
    check(bool((u[..., 0] > 0).all()), "non-positive kh density")
    chunks = re.findall(r"kzps=([0-9.]+) \[([a-z0-9_]+)\[", log)
    check(len(chunks) >= 1 and all(p == path for _, p in chunks),
          f"kh chunks ran {sorted(set(p for _, p in chunks))}, not {path}")
    want = len(chunks) if grain is None else steps // grain * shards
    check(calls == want, f"{calls} kernel calls for {len(chunks)} chunks "
          f"of {steps} steps, not {want}")
    check(len(samples) >= 2, "kh recorded fewer than 2 time-series samples")
    mass = [r["total_mass"] for r in samples]
    # float32 steps keep the total to round-off of the sum, not exactly
    check(abs(mass[-1] - mass[0]) <= 1e-4 * mass[0],
          f"kh total mass moved from {mass[0]} to {mass[-1]}")
    return [float(r) for r, _ in chunks]


def seeded_sedov(SD, nr, system, dtype, device, seed=0):
    """(u, vertices, dt): the sedov state of `nr` zones per decade, every
    cell scaled by 1 + 5% noise from a numpy seed, the outer edge too, so
    that the kernel's outer-face stencils see distinct cells."""
    import numpy as np
    import torch
    cfg = SD.config_template().create().update(
        {"nr": str(nr), "newtonian": str(int(system == "euler"))})
    s = SD.new_solution(cfg, dtype=torch.float64)
    noise = 1.0 + 0.05 * np.random.default_rng(seed).uniform(
        size=(s.conserved.shape[0], 1))
    u = (s.conserved * torch.tensor(noise)).to(dtype=dtype, device=device)
    return u.contiguous(), s.vertices.to(device), SD.grid_dt(s.vertices)


def b5_bar(got, want, dtype, system):
    """Kernel B5's state [nr, 5] against the plain version's: (max |du|,
    max |du| in ulps of its cell's largest component), raising on a
    non-finite value, past the float64 CPU bar, or past F32_ULPS ulps of
    the cell in float32."""
    import numpy as np
    import torch
    u, r = got.double().cpu().numpy(), want.double().cpu().numpy()
    check(bool(np.isfinite(u).all()), "non-finite B5 state")
    diff = np.abs(u - r)
    ulp = np.finfo(str(dtype)[6:]).eps * np.abs(r).max(axis=1, keepdims=True)
    err, in_ulps = float(diff.max()), float((diff / ulp).max())
    if dtype == torch.float64:
        check(allclose(u, r, **B5_F64[system]),
              f"B5 f64 {system} state off by {err:.3e}")
    else:
        check(bool(np.all(diff <= F32_ULPS * ulp + F32_ATOL)),
              f"B5 f32 {system} state off by {in_ulps:.1f} ulps of its cell")
    return err, in_ulps


def b5_bound(u, vertices, n, system, newton_per_cell_step):
    """(ms, "bytes" or "operations"): the least time for n pcm steps of
    kernel B5 on u [nr, 5], reading u and the vertices once and writing u
    once, with the SRHD Newton at `newton_per_cell_step` updates."""
    cells = u.shape[0]
    ops = n * (cells * (B5_OPS_CELL_STEP[system] + (system == "srhd")
                        * B5_OPS_NEWTON_UPDATE * newton_per_cell_step)
               + B5_OPS_SIDE[system])
    t_bytes = (2 * u.numel() * u.element_size()
               + vertices.numel() * vertices.element_size()) / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def b5_newton_per_cell_step(T5, TREC, u, vertices, dt, n):
    """The SRHD Newton updates a cell that warm pcm steps of B5's plain
    version need from u: (the first step's, from p = 0, as a one-step call
    starts; the mean a step over n steps, each step's conserved densities
    recovered from the previous step's pressure)."""
    import torch
    dv = T5.geometry(vertices, u.dtype)[0]
    inv_dv = 1.0 / dv
    p, counts = torch.zeros_like(dv), []
    for _ in range(n):
        Ut = tuple(u[:, k] * inv_dv for k in range(5))
        _, p, _, updates = TREC.recover_window(Ut, torch.clamp(p, min=0.0))
        counts.append(int(updates.sum()) / u.shape[0])
        u = T5.advance_n_plain(u, vertices, dt, 1, system="srhd")
    return counts[0], sum(counts) / n


def drive_sedov(SD, T5, extra, steps, per_step, device):
    """sedov's setup() and run() at SEDOV_NR with `extra` argv for `steps`
    steps, a time-series row every steps / SEDOV_ROWS steps, B5's count set
    to 0 just before the run: (final state, cfg, log, wall seconds,
    time-series rows, B5 calls)."""
    import torch
    cfg, state = SD.setup(["sedov", f"nr={SEDOV_NR}", *extra], device=device)
    dt = SD.grid_dt(state.solution.vertices)
    # the per-step loop runs while t < tfinal, then one more step
    tfinal = (steps - 0.5) * dt if per_step else steps * dt
    tsi = steps // SEDOV_ROWS * dt
    cfg = cfg.set("tfinal", tfinal).set("tsi", tsi)
    print(f"sedov nr={SEDOV_NR} {' '.join(extra)}: tfinal={tfinal:.6e} "
          f"({steps} steps of dt {dt:.6e})")
    system = SD.hydro_system(cfg)
    rows = []

    def tasks(st, cfg_):
        for task in SD.TASKS:
            if st.schedule.is_due(task):
                if task == "write_time_series":
                    rows.append(SD.compute_time_series_data(st.solution,
                                                            system))
                st = SD.State(st.solution,
                              st.schedule.mark_as_completed(task))
        return st

    tee = Tee(sys.stdout)
    T5.advance_n_cuda.launches = 0
    T5.advance_n_cuda.design = None
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        final = SD.run(cfg, state, tasks=tasks)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (final, cfg, tee.buf.getvalue(), wall, rows,
            T5.advance_n_cuda.launches)


def check_sedov(SD, final, cfg, log, rows, calls, steps, per_step):
    """A sedov run's end: the step count, the state's shape and dtype,
    finite values, positive density and pressure, the shock moved out;
    every chunk one B5 call on the card. Returns the label of what ran."""
    import torch
    s = final.solution
    u = s.conserved
    want = steps + 1 if per_step else steps
    check(s.iteration == want, f"sedov ran {s.iteration} steps, not {want}")
    check(tuple(u.shape) == (2 * SEDOV_NR, 5) and u.dtype == torch.float32
          and u.is_cuda, f"sedov state {tuple(u.shape)} {u.dtype} {u.device}")
    check(bool(torch.isfinite(u).all()), "non-finite sedov state")
    P = SD.primitives_of(s, SD.hydro_system(cfg))
    check(bool((P[:, 0] > 0).all()) and bool((P[:, 4] > 0).all()),
          "non-positive sedov density or pressure")
    check(len(rows) >= 3, f"only {len(rows)} time-series rows")
    radii = [r["shock_radius"] for r in rows]
    check(radii[-1] > radii[0], f"the shock did not move out: {radii}")
    name = SD.system_name(SD.hydro_system(cfg))
    label = f"cuda_b5_{name}_{cfg.get_string('reconstruct_method')}"
    if per_step:
        check(SD.LAST_PATH == f"{label}[1]", f"per-step ran {SD.LAST_PATH}")
        check(calls == want, f"{calls} B5 calls for {want} steps")
    else:
        chunks = re.findall(r"kzps=[0-9.]+ \[([a-z0-9_]+)\[(\d+)\]\]", log)
        check(len(chunks) >= 1 and all(p == label for p, _ in chunks),
              f"sedov chunks ran {sorted(set(p for p, _ in chunks))}")
        check(sum(int(n) for _, n in chunks) == steps
              and max(int(n) for _, n in chunks) == 128,
              "sedov chunks do not add up to the run in calls of <= 128")
        check(calls == len(chunks), f"{calls} B5 calls, {len(chunks)} chunks")
    return label, radii


def seeded_cloud(TC, T4, nr, dtype, device, seed=0):
    """(u [5, Nr, Nq], warm p, inflow rows of 17 steps, geometry, dt,
    rv, qv, jet): cloud's initial state at `nr` with its primitives
    perturbed from a numpy seed (density and radial four-velocity by 2%, a
    polar four-velocity of 0.01, pressure by 10%; perturbing the conserved
    values instead leaves cold cells with no physical recovery in float32),
    on `device` in dtype; the warm pressure is the state's own recovered
    pressure (B4b's plain carry) within 5%."""
    import numpy as np
    import torch
    cfg = TC.config_template().create().update({"nr": str(nr)})
    s = TC.new_solution(cfg, dtype=torch.float64)
    rv64, qv64 = s.radial_vertices.to(device), s.polar_vertices.to(device)
    dv = TC.cell_volumes(rv64, qv64)[..., None]
    P = TC.srhd.recover_primitive(s.conserved.to(device) / dv,
                                  TC.GAMMA_LAW_INDEX)
    rng = np.random.default_rng(seed)

    def noise(scale, kind="uniform"):
        draw = rng.uniform(-1, 1, P.shape[:2]) if kind == "uniform" \
            else rng.normal(size=P.shape[:2])
        return torch.tensor(scale * draw, device=device)

    P[..., 0] *= 1.0 + noise(0.02)
    P[..., 1] *= 1.0 + noise(0.02)
    P[..., 2] = noise(0.01, "normal")
    P[..., 4] *= 1.0 + noise(0.1)
    u = (TC.srhd.to_conserved_density(P, TC.GAMMA_LAW_INDEX) * dv).permute(
        2, 0, 1).to(dtype).contiguous()
    rv = rv64.to(dtype)
    qv = qv64.to(dtype)
    dt, jet = TC.grid_dt(s, cfg), TC.jet_static(cfg)
    rows = TC.inflow_rows(TC.ops.midpoint_on_axis(qv), 0.3, dt,
                          max(B4_ODD_STEPS), jet)
    geo = TC.kernel_geometry(rv, qv)
    _, p = T4.stage_plain(rows[0], u, torch.zeros_like(u[0]), geo, dt, 1.2,
                          2, 1e-8)
    p = p * torch.tensor(1.0 + 0.05 * rng.uniform(size=tuple(p.shape)),
                         dtype=dtype, device=device)
    return u, p.contiguous(), rows, geo, dt, rv, qv, jet


def b4_bar(got, want, dtype):
    """Kernel B4's state [5, Nr, Nq] (or pressure [Nr, Nq]) against the
    plain version's: (max |du|, max |du| in ulps of its cell's largest
    component), raising on a non-finite value, past the float64 CPU bar, or
    past F32_ULPS ulps of the cell in float32."""
    import numpy as np
    import torch
    u, r = got.double().cpu().numpy(), want.double().cpu().numpy()
    if u.ndim == 2:
        u, r = u[None], r[None]
    check(bool(np.isfinite(u).all()), "non-finite B4 result")
    diff = np.abs(u - r)
    ulp = np.finfo(str(dtype)[6:]).eps * np.abs(r).max(axis=0, keepdims=True)
    err = float(diff.max())
    in_ulps = float((diff / np.maximum(ulp, 1e-300)).max())
    if dtype == torch.float64:
        check(allclose(u, r, **B4_F64), f"B4 f64 result off by {err:.3e}")
    else:
        check(bool(np.all(diff <= F32_ULPS * ulp + F32_ATOL)),
              f"B4 f32 result off by {in_ulps:.1f} ulps of its cell")
    return err, in_ulps


def b4_bound(u, rv, qv, stages, method, newton_per_cell_stage, steps=0,
             recover=True):
    """(ms, "bytes" or "operations"): the least time for `stages` stages of
    kernel B4 on u [5, Nr, Nq] with the Newton at `newton_per_cell_stage`
    updates and `steps` RK2 averages, reading the state, the warm pressure
    and the vertices once and writing the state and the pressure once
    (recover=False: B4a, reading the primitives instead of the pressure,
    writing no pressure)."""
    cells = u.shape[1] * u.shape[2]
    per_stage = (B4_OPS_CELL_STAGE[method] + B4_OPS_NEWTON_UPDATE
                 * newton_per_cell_stage) if recover else \
        B4_OPS_CELL_STAGE[method] - B4_OPS_RECOVERY
    ops = cells * (stages * per_stage + steps * B4_OPS_RK2_AVERAGE)
    values = (12 if recover else 15) * cells + rv.numel() + qv.numel()
    t_bytes = values * u.element_size() / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def b4_newton_per_cell_stage(T4, TREC, u, p, rows, geo, dt, rk, n):
    """The Newton updates a cell that n steps of B4's plain version (plm)
    need from (u, p): (the first stage's, the mean a stage), each stage's
    conserved densities recovered from the previous stage's pressure."""
    import torch
    inv_dv = 1.0 / geo.dv
    counts = []

    def count(u_, p_):
        Ut = tuple(u_[k] * inv_dv for k in range(5))
        *_, updates = TREC.recover_window(Ut, torch.clamp(p_, min=0.0),
                                          1e-8)
        counts.append(int(updates.sum()) / u_[0].numel())

    for s in range(n):
        count(u, p)
        u1, p = T4.stage_plain(rows[s], u, p, geo, dt, 1.2, 2, 1e-8)
        if rk == 2:
            count(u1, p)
            u2, p = T4.stage_plain(rows[s + 1], u1, p, geo, dt, 1.2, 2,
                                   1e-8)
            u1 = 0.5 * u + 0.5 * u2
        u = u1
    return counts[0], sum(counts) / len(counts)


# cloud's diagnostics in energy and power units (erg ~ 4e52, erg/s) would
# overflow float32, as the JAX package's do; the port forms them in float64,
# so every field must be finite, and these float64
CLOUD_CGS_FIELDS = ("radial_energy_flow", "total_energy_at_theta",
                    "postshock_flow_power")


def cloud_tasks(TC, fields):
    """cloud's task runner that computes the diagnostics (recording the
    seconds each took in `fields`, and whether every field is finite, those
    in erg and erg/s in float64) and writes no files (the card's machine
    has no h5py)."""
    import torch

    def tasks(st, cfg):
        for task in TC.TASKS:
            if st.schedule.is_due(task):
                if task == "write_diagnostics":
                    t0 = time.perf_counter()
                    f = TC.make_diagnostic_fields(st.solution, cfg)
                    f["finite"] = all(
                        bool(v.isfinite().all()) for v in f.values()
                        if hasattr(v, "isfinite")) and all(
                        v.dtype == torch.float64 for k, v in f.items()
                        if k.startswith(CLOUD_CGS_FIELDS))
                    f["seconds"] = time.perf_counter() - t0
                    fields.append((st.solution.iteration, f))
                st = TC.State(st.solution,
                              st.schedule.mark_as_completed(task))
        return st
    return tasks


def drive_cloud(TC, T4, extra, steps, per_step, device):
    """cloud's setup() and run() at CLOUD_NR with `extra` argv for `steps`
    steps, a diagnostics write due half a step before the end, every B4
    count set to 0 just before the run: (final state, cfg, log, wall
    seconds, diagnostics, B4 counts by entry)."""
    import torch
    cfg, state = TC.setup(["cloud", f"nr={CLOUD_NR}", *extra], device=device)
    dt = TC.grid_dt(state.solution, cfg)
    # the per-step loop runs while t < tfinal, then one more step
    tfinal = (steps - 0.5) * dt if per_step else steps * dt
    cfg = cfg.update({"tfinal": str(tfinal), "dfi": str((steps - 0.5) * dt),
                      "cpi": "100", "tsi": "100"})
    print(f"cloud nr={CLOUD_NR} {' '.join(extra)}: tfinal={tfinal:.6e} "
          f"({steps} steps of dt {dt:.6e})")
    fields = []
    wrappers = {"b4a": T4.flux_update_cuda, "b4b": T4.stage_cuda,
                "b4c": T4.step_rk2_cuda, "b4d": T4.run_n_cuda}
    for w in wrappers.values():
        w.launches = 0
    tee = Tee(sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        final = TC.run(cfg, state, tasks=cloud_tasks(TC, fields))
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (final, cfg, tee.buf.getvalue(), wall, fields,
            {k: w.launches for k, w in wrappers.items()})


def check_cloud(TC, final, cfg, log, fields, counts, steps, per_step,
                entry):
    """A cloud run's end: the step count, the state's shape, dtype and
    device, finite values and positive density; the diagnostics written at
    the end and finite; every chunk (or step) one call of `entry`, no
    other B4 entry launched. Returns the label of what ran."""
    import torch
    s = final.solution
    u = s.conserved
    want = steps + 1 if per_step else steps
    check(s.iteration == want, f"cloud ran {s.iteration} steps, not {want}")
    check(tuple(u.shape) == (2 * CLOUD_NR, CLOUD_NR, 5)
          and u.dtype == torch.float32 and u.is_cuda,
          f"cloud state {tuple(u.shape)} {u.dtype} {u.device}")
    check(bool(torch.isfinite(u).all()), "non-finite cloud state")
    check(bool((u[..., 0] > 0).all()), "non-positive cloud density")
    check(s.pressure is not None and bool(torch.isfinite(s.pressure).all()),
          "no finite warm pressure carried")
    check([it for it, _ in fields] == [0, steps],
          f"diagnostics at {[it for it, _ in fields]}, not [0, {steps}]")
    check(all(f["finite"] for _, f in fields), "non-finite diagnostics")
    rk = cfg.get_int("rk_order")
    others = {k: v for k, v in counts.items() if k != entry and v}
    check(not others, f"cloud launched {others} besides {entry}")
    if per_step:
        label = f"cuda_{entry}"
        check(TC.LAST_PATH == f"{label}[1]", f"per-step ran {TC.LAST_PATH}")
        check(counts[entry] == want, f"{counts[entry]} {entry} calls for "
              f"{want} steps")
    else:
        label = f"cuda_b4d_rk{rk}"
        chunks = re.findall(r"kzps=[0-9.]+ \[([a-z0-9_]+)\[(\d+)\]\]", log)
        check(len(chunks) >= 1 and all(p == label for p, _ in chunks),
              f"cloud chunks ran {sorted(set(p for p, _ in chunks))}")
        check(sum(int(n) for _, n in chunks) == steps
              and max(int(n) for _, n in chunks) == 64,
              "cloud chunks do not add up to the run in calls of <= 64")
        check(counts[entry] == len(chunks),
              f"{counts[entry]} B4d calls, {len(chunks)} chunks")
    return label


def cloud_phases(device, smi, profile):
    """Phases 20-23 (kernel B4 and the cloud subprogram); returns the
    kernels line's entries of B4a-d."""
    import numpy as np
    import torch
    from mara3_tpu_torch.kernels import cloud_update as T4
    from mara3_tpu_torch.kernels import srhd_recover as TREC
    from mara3_tpu_torch.subprograms import cloud as TC

    # ---- phase 20: B4 against its plain versions --------------------------
    errs = {}
    for dtype in (torch.float64, torch.float32):
        worst, cases = (0.0, 0.0), 0
        for nr, seed, steps in ((CLOUD_ODD_NR, 0, B4_ODD_STEPS),
                                (CLOUD_NR, 1, (CLOUD_BIG_STEPS,))):
            u, p, rows, geo, dt, rv, qv, jet = seeded_cloud(
                TC, T4, nr, dtype, device, seed)
            g = TC.make_geometry(rv, qv)
            Pt = TC.srhd.recover_primitive_t(
                tuple(u[k] / g[4] for k in range(5)), TC.GAMMA_LAW_INDEX,
                1e-8, p)
            Pe = torch.stack([torch.cat([rows[0][k][None], c, c[-1:]])
                              for k, c in enumerate(Pt)]).contiguous()
            for method in (1, 2):
                kw = dict(geo=geo, dt=dt, plm_theta=1.2, method=method)
                cases_ = [("b4a", T4.flux_update_cuda(Pe, u, **kw),
                           T4.flux_update_plain(Pe, u, **kw))]
                kw["tfloor"] = 1e-8
                for warm in (True, False):
                    p0 = p if warm else torch.zeros_like(p)
                    cases_ += [
                        ("b4b", T4.stage_cuda(rows[0], u, p0, **kw),
                         T4.stage_plain(rows[0], u, p0, **kw)),
                        ("b4c", T4.step_rk2_cuda(rows[0], rows[1], u, p0,
                                                 **kw),
                         T4.step_rk2_plain(rows[0], rows[1], u, p0, **kw))]
                    cases_ += [("b4d", T4.run_n_cuda(rows[:n + 1], u, p0,
                                                     rk=rk, **kw),
                                T4.run_n_plain(rows[:n + 1], u, p0, rk=rk,
                                               **kw))
                               for n in steps for rk in (1, 2)]
                torch.cuda.synchronize()
                for entry, got, want in cases_:
                    if entry == "b4a":
                        e = b4_bar(got, want, dtype)
                    else:
                        e = b4_bar(got[0], want[0], dtype)
                        b4_bar(got[1], want[1], dtype)
                    worst = tuple(map(max, worst, e))
                    cases += 1
                    if nr == CLOUD_NR and dtype == torch.float32 \
                            and method == 2:
                        errs[entry] = max(errs.get(entry, 0.0), e[0])
            del u, p, rows, geo, g, Pt, Pe, cases_
        print(f"B4 parity {str(dtype)[6:]}: {cases} cases pass ({{b4a, b4b "
              f"and b4c warm and cold, b4d rk1 and rk2}} x {{pcm, plm}} at "
              f"{2 * CLOUD_ODD_NR}x{CLOUD_ODD_NR}, b4d n in {B4_ODD_STEPS}, "
              f"and at {2 * CLOUD_NR}x{CLOUD_NR}, b4d n = {CLOUD_BIG_STEPS}),"
              f" max |du| {worst[0]:.3e} ({worst[1]:.2f} ulps of its cell)")

    # ---- phase 21: cloud, card against CPU ---------------------------------
    cfg64 = TC.config_template().create().update({"nr": "64",
                                                  "rk_order": "2"})
    s64 = TC.new_solution(cfg64, dtype=torch.float64)
    dt64, jet64 = TC.grid_dt(s64, cfg64), TC.jet_static(cfg64)
    runs = []
    for dev_ in (device, torch.device("cpu")):
        us = s64.conserved.permute(2, 0, 1).contiguous().to(dev_)
        runs.append(TC.advance_n(us, torch.zeros_like(us[0]), 0.0, 11,
                                 s64.radial_vertices.to(dev_),
                                 s64.polar_vertices.to(dev_), jet64, dt64,
                                 1.2, 2, 1e-8, 2, kernel=True))
        where = "cuda" if dev_.type == "cuda" else "plain"
        check(TC.LAST_PATH == f"{where}_b4d_rk2[11]",
              f"{dev_} ran {TC.LAST_PATH}")
    (gu, gp), (cu, cp) = runs
    check(allclose(gu.cpu().numpy(), cu.numpy(), **B4_F64)
          and allclose(gp.cpu().numpy(), cp.numpy(), **B4_F64),
          "cloud nr=64: 11 steps on the card differ from the CPU")
    print(f"cloud nr=64 rk2 plm float64: 11 steps of B4d on the card match "
          f"its plain version on the CPU (rtol {B4_F64['rtol']}), max |du| "
          f"{float((gu.cpu() - cu).abs().max()):.3e}")
    del s64, runs, gu, gp, cu, cp

    # ---- phase 22: the cloud main path -------------------------------------
    launches, finals = {}, {}
    for extra, steps, per_step, entry in CLOUD_RUNS:
        final, cfg, log, wall, fields, counts = drive_cloud(
            TC, T4, extra, steps, per_step, device)
        label = check_cloud(TC, final, cfg, log, fields, counts, steps,
                            per_step, entry)
        launches.setdefault(entry, counts[entry])
        finals[extra] = final.solution
        it = final.solution.iteration
        rate = it * 2 * CLOUD_NR * CLOUD_NR / wall
        diag_s = fields[-1][1]["seconds"]
        print(f"cloud main path {' '.join(extra) or 'defaults (rk1)'} "
              f"({label}, float32): {it} steps in {counts[entry]} "
              f"{entry.upper()} calls, {wall:.4f} s wall (the diagnostics "
              f"at the end {diag_s:.4f} s of it), min density "
              f"{float(final.solution.conserved[..., 0].min()):.6e}; "
              f"whole-run {rate:.6e} zone-updates/s on {smi}")
    del final
    launches["b4a"] = 0     # on no run path (as in the JAX package)

    # ---- phase 23: B4 timing at 2,048 x 1,024 float32 ----------------------
    s = finals[("rk_order=2",)]
    u = s.conserved.permute(2, 0, 1).contiguous()
    p = s.pressure.contiguous()
    rv, qv = s.radial_vertices, s.polar_vertices
    cfg = TC.config_template().create().update({"nr": str(CLOUD_NR)})
    dt = TC.grid_dt(s, cfg)
    rows = TC.inflow_rows(TC.ops.midpoint_on_axis(qv), s.time, dt, 64,
                          TC.jet_static(cfg))
    geo = TC.kernel_geometry(rv, qv)
    kw = dict(geo=geo, dt=dt, plm_theta=1.2, method=2, tfloor=1e-8)
    g = TC.make_geometry(rv, qv)
    Pt = TC.srhd.recover_primitive_t(tuple(u[k] / g[4] for k in range(5)),
                                     TC.GAMMA_LAW_INDEX, 1e-8, p)
    Pe = torch.stack([torch.cat([rows[0][k][None], c, c[-1:]])
                      for k, c in enumerate(Pt)]).contiguous()
    first, newton = b4_newton_per_cell_stage(T4, TREC, u, p, rows, geo, dt,
                                             2, 64)
    timed = {
        "b4a": (lambda: T4.flux_update_plain(Pe, u, geo, dt, 1.2, 2),
                lambda: T4.flux_update_cuda(Pe, u, geo, dt, 1.2, 2),
                5, 50, b4_bound(u, rv, qv, 1, 2, 0, recover=False)),
        "b4b": (lambda: T4.stage_plain(rows[0], u, p, **kw),
                lambda: T4.stage_cuda(rows[0], u, p, **kw), 3, 30,
                b4_bound(u, rv, qv, 1, 2, first)),
        "b4c": (lambda: T4.step_rk2_plain(rows[0], rows[1], u, p, **kw),
                lambda: T4.step_rk2_cuda(rows[0], rows[1], u, p, **kw), 2,
                20, b4_bound(u, rv, qv, 2, 2, newton, steps=1)),
        "b4d": (lambda: T4.run_n_plain(rows, u, p, **kw),
                lambda: T4.run_n_cuda(rows, u, p, **kw), 1, 3,
                b4_bound(u, rv, qv, 128, 2, newton, steps=64)),
    }
    times = {}
    for entry, (plain, kernel, pr, kr, bnd) in timed.items():
        k_ms, p_ms, runs = in_turns(plain, kernel, pr, kr)
        times[entry] = (k_ms, p_ms, bnd)
        print(f"time {2 * CLOUD_NR}x{CLOUD_NR} float32 rk2 plm: "
              f"{entry.upper()} {k_ms:.4f} ms vs plain {p_ms:.4f} ms (runs "
              + " ".join(f"{r:.4f}" for r in runs) + f"); bound "
              f"{bnd[0]:.5f} ms ({bnd[1]}) on {smi}")
    print(f"cloud B4: Newton updates a cell {first:.4f} in the first stage, "
          f"{newton:.4f} a stage over 64 RK2 steps from the main path's "
          f"end (B4d 64 steps: {times['b4d'][0] / 128:.5f} ms a stage)")
    TC.make_diagnostic_fields(s, cfg)
    torch.cuda.synchronize()
    d0 = time.perf_counter()
    fields = TC.make_diagnostic_fields(s, cfg)
    torch.cuda.synchronize()
    print(f"cloud diagnostics at {2 * CLOUD_NR}x{CLOUD_NR} float32: "
          f"{(time.perf_counter() - d0) * 1e3:.4f} ms, shock midpoint "
          f"radius on the axis {float(fields['shock_midpoint_radius'][0]):.6e}"
          f" cm on {smi}")
    if profile:
        def chunk():
            TC.advance_n(u, p, s.time, 64, rv, qv, TC.jet_static(cfg), dt,
                         1.2, 2, 1e-8, 2)

        chunk()
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - c0) * 1e3
        table, busy, launched = profile_table(chunk, 1)
        with open(profile, "a") as f:
            f.write(f"cloud chunk of 64 RK2 plm steps at {2 * CLOUD_NR}x"
                    f"{CLOUD_NR} float32 (B4d, its inflow rows and "
                    f"geometry): {chunk_ms:.4f} ms wall, {busy:.1f} us of "
                    f"kernels in {launched:.0f} launches\n{table}\n")
        print(f"profile: cloud 64-step chunk {chunk_ms:.4f} ms wall, kernels "
              f"{busy / 1e3:.4f} ms in {launched:.0f} launches "
              f"({100 * busy / 1e3 / chunk_ms:.1f}% busy)")

    names = {"b4a": ("flux_update", 200), "b4b": ("stage", 462),
             "b4c": ("step_rk2", 770), "b4d": ("run_n", 910)}
    return [{"name": f"cloud_update {fn} ({entry.upper()})", "route": "cuda",
             "source": "mara3_tpu_torch/csrc/cloud_update.cu",
             "replaces": f"mara3_tpu/kernels/cloud_update.py:{line}",
             "launches": launches[entry], "max_abs_err": errs[entry],
             "ms": times[entry][0], "plain_ms": times[entry][1],
             "bound_ms": times[entry][2][0], "bound_by": times[entry][2][1],
             "library_ms": None}
            for entry, (fn, line) in names.items()]


def amr_bar(got, want, dtype, f64_bar):
    """(max |du|, max |du| in float32 ulps of its cell, bit for bit) of a
    one-component state against the plain version's, raising on a
    non-finite value, past `f64_bar` (rtol, atol) in float64, or past
    F32_ULPS ulps of the cell in float32."""
    import numpy as np
    import torch
    g, w = got.double().cpu().numpy(), want.double().cpu().numpy()
    check(bool(np.isfinite(g).all()), "non-finite kernel output")
    diff = np.abs(g - w)
    ulp = np.finfo(np.float32).eps * np.abs(w)
    in_ulps = float((diff / np.maximum(ulp, 1e-300)).max())
    if dtype == torch.float64:
        check(allclose(g, w, **f64_bar), f"f64 state off by {diff.max():.3e}")
    else:
        check(bool(np.all(diff <= F32_ULPS * ulp)),
              f"f32 state off by {in_ulps:.1f} ulps of its cell")
    return float(diff.max()), in_ulps, bool(torch.equal(got, want))


def seeded_amr(AS, S3, BL, T6, T7, kind, depth, bs, dtype, device, seed=0):
    """(u, tables) of amrsand's quadtree (kind "b6") or sand3d's octree
    ("b7") at depth and bs, each cell scaled by 1 + 5% noise from a numpy
    seed, with the subprogram's dt."""
    import numpy as np
    import torch
    if kind == "b6":
        cfg = AS.config_template().create().update(
            {"depth": depth, "block_size": bs})
        s = AS.new_solution(cfg, dtype=torch.float64)
        u0 = s.conserved
    else:
        cfg = S3.config_template().create().update(
            {"depth": depth, "block_size": bs})
        mesh = S3.build_mesh(cfg)
        u0 = S3.new_solution(cfg, mesh, dtype=torch.float64).conserved
    rng = np.random.default_rng(seed)
    u = (u0 * torch.as_tensor(1.0 + 0.05 * rng.uniform(size=tuple(
        u0.shape)))).to(dtype=dtype, device=device).contiguous()
    if kind == "b6":
        s = replace(s, conserved=u)
        return u, T6.guard_tables(BL.build_neighbor_table(s.leaves),
                                  AS.block_spacings(s), AS.time_step(s))
    return u, T7.guard_tables(mesh, S3.block_spacings(mesh, bs, dtype,
                                                      device),
                              S3.VELOCITY, S3.time_step(mesh, bs))


def amr_bound(u, tables, n, ops_cell_step):
    """(ms, "bytes" or "operations"): the least time for n steps of B6 or
    B7 on u, reading u, its face table and courant factors once and writing
    u once."""
    cells = u.numel()
    t_bytes = (2 * cells * u.element_size()
               + tables.faces.numel() * tables.faces.element_size()
               + tables.c.numel() * tables.c.element_size()) / HBM_BYTES_PER_S
    t_ops = n * cells * ops_cell_step / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def amr_tasks(writes):
    """amrsand's and sand3d's task runner: each diagnostics write copies
    the state to the host and tests it for finiteness, as the writers do,
    records (iteration, seconds) in `writes`, and writes no files (the
    card's machine has no h5py)."""
    from mara3_tpu_torch.app import driver

    def tasks(st, cfg):
        if st.schedule.is_due("write_diagnostics"):
            t0 = time.perf_counter()
            s = st.solution
            u = s.conserved.detach().cpu().numpy()
            driver.check_finite("diagnostics", [u], s.iteration, s.time)
            writes.append((s.iteration, time.perf_counter() - t0))
            st = replace(st, schedule=st.schedule.mark_as_completed(
                "write_diagnostics"))
        return st
    return tasks


def drive_amr(module, argv, device, dtype=None, quiet=False):
    """setup() and run() of `argv` through the no-file task runner, B6's
    and B7's counts set to 0 just before the run: (final state, log, wall
    seconds, diagnostics writes, B6 calls, B7 calls)."""
    import torch
    from mara3_tpu_torch.kernels import amrsand_step as T6
    from mara3_tpu_torch.kernels import sand3d_step as T7
    with contextlib.redirect_stdout(io.StringIO()):
        cfg, state = module.setup(argv, device=device, dtype=dtype)
    writes = []
    T6.advance_n_cuda.launches = T7.advance_n_cuda.launches = 0
    tee = Tee(io.StringIO() if quiet else sys.stdout)
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(tee):
        final = module.run(cfg, state, tasks=amr_tasks(writes))
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return (final, tee.buf.getvalue(), wall, writes,
            T6.advance_n_cuda.launches, T7.advance_n_cuda.launches)


def check_amr_chunks(log, label, steps, calls):
    """Every chunk of the log ran `label`, the chunks add up to `steps`
    and each was one counted call; returns the chunks' step counts."""
    chunks = re.findall(r"kzps=[0-9.]+ \[([a-z0-9_]+)\[(\d+)\]\]", log)
    check(len(chunks) >= 1 and all(p == label for p, _ in chunks),
          f"chunks ran {sorted(set(p for p, _ in chunks))}, not {label}")
    check(sum(int(n) for _, n in chunks) == steps,
          f"chunks add up to {sum(int(n) for _, n in chunks)} steps, not "
          f"{steps}")
    check(calls == len(chunks), f"{calls} calls, {len(chunks)} chunks")
    return [int(n) for _, n in chunks]


def amr_phases(device, smi, profile):
    """Phases 24-30 (kernels B6 and B7, the amrsand and sand3d
    subprograms); returns the kernels line's entries of B6 and B7."""
    import numpy as np
    import torch
    from mara3_tpu_torch.kernels import amrsand_step as T6
    from mara3_tpu_torch.kernels import sand3d_step as T7
    from mara3_tpu_torch.mesh import block_layout as BL
    from mara3_tpu_torch.mesh import regrid as RG
    from mara3_tpu_torch.subprograms import amrsand as AS
    from mara3_tpu_torch.subprograms import sand3d as S3
    f64, f32 = torch.float64, torch.float32
    kinds = {"b6": (T6, (3, 8), (AMR_DEPTH, AMR_BS)),
             "b7": (T7, (3, 8), (SAND3D_DEPTH, SAND3D_BS))}
    cpu = torch.device("cpu")

    def kernel_parity(kind):
        """Phases 24 and 28: the kernel against its plain version."""
        T, small, full = kinds[kind]
        err = 0.0
        for dtype in (f64, f32):
            worst, cases, bits = (0.0, 0.0), 0, 0
            for depth, bs in (small, full):
                u, tab = seeded_amr(AS, S3, BL, T6, T7, kind, depth, bs,
                                    dtype, device, seed=depth)
                u_copy = u.clone()
                scale = float(u.abs().max())
                bar = B6_F64 if kind == "b6" else dict(
                    rtol=0.0, atol=B7_BAR["float64"] * scale)
                # B6: each design (the resident one where it fits)
                designs = [{}]
                if kind == "b6":
                    designs = [dict(design=d) for d in T6.DESIGNS
                               if d != "resident" or T6.plan_for(u)[0]]
                for n in AMR_STEPS:
                    want = T.advance_n_plain(u, tab, n)
                    for kw in designs:
                        got = T.advance_n_cuda(u, tab, n, **kw)
                        torch.cuda.synchronize()
                        e = amr_bar(got, want, dtype, bar)
                        worst = (max(worst[0], e[0]), max(worst[1], e[1]))
                        cases += 1
                        bits += e[2]
                        if kind == "b6":
                            check(e[2], f"B6 {kw['design']} n={n} at depth "
                                  f"{depth} block {bs} is not the plain "
                                  f"version's bits")
                        if (depth, bs) == full and dtype == f32:
                            err = max(err, e[0])
                check(torch.equal(u, u_copy), f"{kind} wrote its input")
            print(f"{kind.upper()} parity {str(dtype)[6:]}: {cases} cases "
                  f"pass (depth {small[0]} block {small[1]} with every face "
                  f"case, and depth {full[0]} block {full[1]}; n in "
                  f"{AMR_STEPS}"
                  + ("; the resident and the launch-a-step design"
                     if kind == "b6" else "")
                  + f"), {bits} of them bit for bit, max |du| "
                  f"{worst[0]:.3e} ({worst[1]:.2f} float32 ulps of its cell)")
        return err

    def timing(kind, u, tab, n_call, plain_reps):
        """Phases 27 and 30: the kernel's one-step and n_call-step calls,
        its marginal rate and bound, and its plain version, in turns."""
        T, ops = (T6, B6_OPS_CELL_STEP) if kind == "b6" \
            else (T7, B7_OPS_CELL_STEP)
        cells = u.numel()
        step_ms, step_plain_ms, runs1 = in_turns(
            lambda: T.advance_n_plain(u, tab, 1),
            lambda: T.advance_n_cuda(u, tab, 1), 5, 100)
        call_ms, call_plain_ms, runs_n = in_turns(
            lambda: T.advance_n_plain(u, tab, n_call),
            lambda: T.advance_n_cuda(u, tab, n_call), plain_reps, 10)
        rate, spread, _ = marginal_rate(
            lambda n: T.advance_n_cuda(u, tab, n), cells, *AMR_MARGINAL)
        bnd1 = amr_bound(u, tab, 1, ops)
        bnd = amr_bound(u, tab, n_call, ops)
        floor = 2 * cells * u.element_size() / HBM_BYTES_PER_S * 1e3
        print(f"time {kind.upper()} {cells} cells float32: {step_ms:.5f} ms "
              f"a step (one-step call) vs plain {step_plain_ms:.4f} ms (runs "
              + " ".join(f"{r:.4f}" for r in runs1) + f"); {n_call}-step "
              f"call {call_ms:.4f} ms ({call_ms / n_call:.5f} ms a step) vs "
              f"plain {call_plain_ms:.4f} ms (runs " + " ".join(
                  f"{r:.4f}" for r in runs_n) + f"); marginal "
              f"{rate:.6e} zone-updates/s between {AMR_MARGINAL[0]} and "
              f"{AMR_MARGINAL[1]} steps ({1e3 * cells / rate:.5f} ms a step, "
              f"spread {spread:.3f}); bound {bnd1[0]:.5f} ms a step "
              f"({bnd1[1]}), {bnd[0]:.5f} ms per {n_call} steps ({bnd[1]}); "
              f"a launch-a-step design's byte floor {floor:.5f} ms a step, "
              f"on {smi}")
        return call_ms, call_plain_ms, bnd

    def profiled(label, fn):
        fn()
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - c0) * 1e3
        table, busy, launched = profile_table(fn, 1)
        with open(profile, "a") as f:
            f.write(f"{label}: {chunk_ms:.4f} ms wall, {busy:.1f} us of "
                    f"kernels in {launched:.0f} launches\n{table}\n")
        print(f"profile: {label} {chunk_ms:.4f} ms wall, kernels "
              f"{busy / 1e3:.4f} ms in {launched:.0f} launches "
              f"({100 * busy / 1e3 / chunk_ms:.1f}% busy)")

    # ---- phase 24: B6 against its plain version ---------------------------
    b6_err = kernel_parity("b6")

    # ---- phase 25: amrsand, card against CPU -------------------------------
    for extra in ((), ("regrid=1", "rgi=0.05")):
        argv = ["amrsand", "depth=3", "block_size=16", "tfinal=0.25",
                "dfi=0.1", "fast_step=1", *extra]
        runs = [drive_amr(AS, argv, dev, f64, quiet=True)
                for dev in (device, cpu)]
        (card, log, _, _, calls, _), (host, *_) = runs
        check_amr_chunks(log, "cuda_b6", 32, calls)
        a, b = card.solution, host.solution
        check(a.leaves == b.leaves and a.iteration == b.iteration == 32,
              "amrsand d3b16: the card and the CPU end on other meshes")
        check(allclose(a.conserved.cpu().numpy(), b.conserved.numpy(),
                       **AMR_RUN),
              "amrsand d3b16: the card's run differs from the CPU's")
        regrids = log.count("regrid:")
        print(f"amrsand depth=3 block_size=16 "
              f"{' '.join(extra) or 'static mesh'} float64: 32 "
              f"steps in {calls} B6 calls on the card match the scheme on "
              f"the CPU (rtol {AMR_RUN['rtol']}), max |du| "
              f"{float((a.conserved.cpu() - b.conserved).abs().max()):.3e}, "
              f"{len(a.leaves)} blocks at the end, {regrids} regrids")

    # ---- phase 26: the amrsand main path -----------------------------------
    argv = ["amrsand", f"depth={AMR_DEPTH}", f"block_size={AMR_BS}"]
    T6.advance_n_cuda.design = None
    final, log, wall, writes, b6_launches, b7_calls = drive_amr(AS, argv,
                                                                device)
    b6_design = T6.advance_n_cuda.design
    s = final.solution
    steps = round(1.0 / AS.time_step(s))
    check(s.iteration == steps, f"amrsand ran {s.iteration} steps, not "
                                f"{steps}")
    check(tuple(s.conserved.shape) == (AMR_BLOCKS, AMR_BS, AMR_BS, 1)
          and s.conserved.dtype == f32 and s.conserved.is_cuda,
          f"amrsand state {tuple(s.conserved.shape)} {s.conserved.dtype}")
    check(bool(torch.isfinite(s.conserved).all()), "non-finite amrsand")
    check(b7_calls == 0, "amrsand launched B7")
    chunks = check_amr_chunks(log, "cuda_b6", steps, b6_launches)
    check([it for it, _ in writes] == [0, steps],
          f"diagnostics at {[it for it, _ in writes]}, not [0, {steps}]")
    cells = s.conserved.numel()
    print(f"amrsand main path depth={AMR_DEPTH} block_size={AMR_BS} float32: "
          f"{s.iteration} steps in {b6_launches} B6 calls (the {b6_design} "
          f"design; chunks of {max(chunks)}), {wall:.4f} s "
          f"wall, the {len(writes)} diagnostics writes (a host copy and the "
          f"finiteness test) {sum(w for _, w in writes):.4f} s of it; "
          f"whole-run {s.iteration * cells / wall:.6e} zone-updates/s on "
          f"{smi}")
    s_main, u_main = s, s.conserved
    argv_rg = argv + ["regrid=1", "rgi=0.1", "tfinal=0.3"]
    T6.advance_n_cuda.design = None
    final, log, wall, writes, calls, _ = drive_amr(AS, argv_rg, device,
                                                   quiet=True)
    s = final.solution
    check(bool(torch.isfinite(s.conserved).all()), "non-finite regrid run")
    regrids = re.findall(r"regrid: (\d+) blocks, depth (\d+), (\w+), "
                         r"([0-9.]+) ms on the host", log)
    check(len(regrids) >= 2, f"{len(regrids)} regrids")
    check_amr_chunks(log, "cuda_b6", s.iteration, calls)
    print(f"amrsand depth={AMR_DEPTH} block_size={AMR_BS} regrid=1 rgi=0.1 "
          f"tfinal=0.3 float32: {s.iteration} steps in {calls} B6 calls "
          f"(the {T6.advance_n_cuda.design} design), {wall:.4f} s wall; "
          f"regrids (blocks, depth, host ms): "
          + ", ".join(f"({b}, {d}, {ms})" for b, d, _, ms in regrids)
          + f"; {len(s.leaves)} blocks at the end, on {smi}")
    # the remap alone (get_cell_block per new leaf), at the first regrid
    s0 = AS.new_solution(AS.config_template().create().update(
        {"depth": AMR_DEPTH, "block_size": AMR_BS}))
    host = s0.conserved.numpy()
    new = RG.propose_leaves(s0.leaves, RG.gradient_indicator(
        host, BL.block_dx(s0.leaves, AMR_BS)), 0.3, 0.05, AMR_DEPTH)
    r0 = time.perf_counter()
    RG.remap_blocks(s0.leaves, host, new)
    remap_ms = 1e3 * (time.perf_counter() - r0)
    print(f"amrsand regrid at depth {AMR_DEPTH}: remap_blocks (get_cell_block"
          f" for each of {len(new)} new leaves) {remap_ms:.3f} ms on the "
          f"host")

    # ---- phase 27: B6 timing at d7b64 float32 ------------------------------
    s = s_main
    nt = BL.build_neighbor_table(s.leaves)
    tab = T6.guard_tables(nt, AS.block_spacings(s), AS.time_step(s))
    b6_ms, b6_plain_ms, b6_bnd = timing("b6", u_main, tab, 256, 1)
    check(T6.plan_for(u_main)[0] is not None, "B6 at d7b64 is not resident")
    # the launch-a-step design on the same state, in turns with the resident
    per_step = lambda: T6.advance_n_cuda(u_main, tab, 256, design="per_step")
    resident = lambda: T6.advance_n_cuda(u_main, tab, 256)
    turns = [time_ms(f, 5) for f in (per_step, resident, resident, per_step)]
    print(f"B6 256-step call at d{AMR_DEPTH}b{AMR_BS} float32: resident "
          f"{min(turns[1:3]):.4f} ms, launch-a-step {min(turns[::3]):.4f} ms "
          f"(turns " + " ".join(f"{t:.4f}" for t in turns) + f"), on {smi}")
    # past the L2 and the shared memory: depth 7 with blocks of 128 (42.7
    # MB and its copy), the launch-a-step design
    big, big_tab = seeded_amr(AS, S3, BL, T6, T7, "b6", AMR_DEPTH, 128, f32,
                              device)
    check(T6.plan_for(big)[0] is None, "B6 at d7b128 fits")
    big_ms = time_ms(lambda: T6.advance_n_cuda(big, big_tab, 64), 5) / 64
    rates = [8 * c / (ms * 1e-3) / 1e12 for c, ms in
             ((u_main.numel(), b6_ms / 256), (big.numel(), big_ms))]
    print(f"B6 a step: {b6_ms / 256 * 1e9 / u_main.numel():.4f} ps a cell "
          f"(as {rates[0]:.3f} TB/s read and written) at block {AMR_BS} "
          f"({u_main.numel() * 4 / 1e6:.1f} MB, resident in shared memory), "
          f"{big_ms * 1e9 / big.numel():.4f} ps a cell ({rates[1]:.3f} TB/s)"
          f" at block 128 ({big.numel() * 4 / 1e6:.1f} MB, launch a step), "
          f"64-step calls, on {smi}")
    del big, big_tab
    if profile:
        profiled(f"amrsand chunk of 256 steps at depth {AMR_DEPTH} block "
                 f"{AMR_BS} float32 (B6)", lambda: AS.advance_n(
                     u_main, AS.block_spacings(s), nt, AS.time_step(s), 256))

    # ---- phase 28: B7 against its plain version ---------------------------
    b7_err = kernel_parity("b7")

    # ---- phase 29: sand3d, card against CPU --------------------------------
    argv = ["sand3d", "depth=3", "block_size=8", "tfinal=0.1", "dfi=0.05"]
    (card, log, _, _, _, calls), (host, *_) = [
        drive_amr(S3, argv, dev, f64, quiet=True) for dev in (device, cpu)]
    check_amr_chunks(log, "cuda_b7", card.solution.iteration, calls)
    a, b = card.solution.conserved.cpu(), host.solution.conserved
    scale = float(b.abs().max())
    check(allclose(a.numpy(), b.numpy(), 0.0, 1e-12 * scale),
          "sand3d d3b8: the card's run differs from the CPU's")
    print(f"sand3d depth=3 block_size=8 float64: {card.solution.iteration} "
          f"steps in {calls} B7 calls on the card match the scheme on the "
          f"CPU (atol 1e-12 x max |u|), max |du| "
          f"{float((a - b).abs().max()):.3e}")

    # ---- phase 30: the sand3d main path, and B7 timing ---------------------
    argv = ["sand3d", f"depth={SAND3D_DEPTH}", f"block_size={SAND3D_BS}",
            "tfinal=1.0"]
    final, log, wall, writes, b6_calls, b7_launches = drive_amr(S3, argv,
                                                                device)
    s = final.solution
    steps = round(1.0 / S3.time_step(final.mesh, SAND3D_BS))
    check(s.iteration == steps, f"sand3d ran {s.iteration} steps, not "
                                f"{steps}")
    check(tuple(s.conserved.shape) == (344,) + (SAND3D_BS,) * 3
          and s.conserved.dtype == f32 and s.conserved.is_cuda,
          f"sand3d state {tuple(s.conserved.shape)} {s.conserved.dtype}")
    check(bool(torch.isfinite(s.conserved).all()), "non-finite sand3d")
    check(b6_calls == 0, "sand3d launched B6")
    check_amr_chunks(log, "cuda_b7", steps, b7_launches)
    check([it for it, _ in writes] == [0, steps],
          f"diagnostics at {[it for it, _ in writes]}, not [0, {steps}]")
    cells = s.conserved.numel()
    print(f"sand3d main path depth={SAND3D_DEPTH} block_size={SAND3D_BS} "
          f"tfinal=1.0 float32: {s.iteration} steps in {b7_launches} B7 "
          f"calls, {wall:.4f} s wall, the {len(writes)} diagnostics writes "
          f"{sum(w for _, w in writes):.4f} s of it; whole-run "
          f"{s.iteration * cells / wall:.6e} zone-updates/s on {smi}")
    mesh = final.mesh
    tab = T7.guard_tables(mesh, S3.block_spacings(mesh, SAND3D_BS, f32,
                                                  device),
                          S3.VELOCITY, S3.time_step(mesh, SAND3D_BS))
    b7_ms, b7_plain_ms, b7_bnd = timing("b7", s.conserved, tab, steps, 1)
    if profile:
        profiled(f"sand3d call of {steps} steps at depth {SAND3D_DEPTH} "
                 f"block {SAND3D_BS} float32 (B7)",
                 lambda: T7.advance_n_cuda(s.conserved, tab, steps))

    return [
        {"name": "amrsand_step (B6)", "route": "cuda",
         "source": "mara3_tpu_torch/csrc/amrsand_step.cu",
         "replaces": "mara3_tpu/kernels/amrsand_step.py:118",
         "launches": b6_launches, "max_abs_err": b6_err, "ms": b6_ms,
         "plain_ms": b6_plain_ms, "bound_ms": b6_bnd[0],
         "bound_by": b6_bnd[1], "library_ms": None},
        {"name": "sand3d_step (B7)", "route": "cuda",
         "source": "mara3_tpu_torch/csrc/sand3d_step.cu",
         "replaces": "mara3_tpu/kernels/sand3d_step.py:177",
         "launches": b7_launches, "max_abs_err": b7_err, "ms": b7_ms,
         "plain_ms": b7_plain_ms, "bound_ms": b7_bnd[0],
         "bound_by": b7_bnd[1], "library_ms": None}]


def b11_bound(kind, B, bs, itemsize):
    """(ms, "bytes" or "operations") of kernel B11a (both axes), B11b or
    B11c on B blocks of bs^2 cells (the counts above the constants)."""
    cells, faces = B * bs * bs, B * (bs + 1) * bs
    edge = 4 * B * bs
    if kind == "b11a":
        ops = 2 * faces * B11_OPS["b11a_face"]
        values = 2 * (9 * B * (bs + 2) * bs + 5 * faces)
    elif kind == "b11b":
        ops = cells * B11_OPS["b11b_cell"]
        values = 16 * cells + 6 * faces
    else:
        ops = cells * B11_OPS["b11c_cell"] + 2 * faces * B11_OPS["b11c_face"]
        values = 12 * cells + 12 * edge + 3 * B
    t_bytes = values * itemsize / HBM_BYTES_PER_S
    t_ops = ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def b11_inputs(TB, TS, BL, over, device, dtype, seed=0):
    """A seeded flagship case and its kernels' inputs: (sd, u0, bodies, dt,
    the split front (p0, x, y), the jnp_strips front (p0, strips,
    theta))."""
    sd, u0, bodies, dt = seeded_case(TB, over, device, dtype, seed)
    t = sd.advance.tables
    consts = BL.build_soa_guard(sd.nt, sd.cfg_scheme.block_size)
    return (sd, u0, bodies, dt, TS.split_front(t, u0, sd.plm_theta),
            TS.strips_front(t, sd.nt, consts, u0, sd.plm_theta))


def b11_parity(TU, TK, case, dtype, strips_only=False):
    """Kernels B11a, B11b (unless strips_only) and B11c against their plain
    versions on one case: the largest |du| of each and of B11c's totals,
    in ulps of its cell too. Raises past the bars."""
    import numpy as np
    import torch
    sd, u0, bodies, dt, (p0, x, y), (_, strips, theta) = case
    t, cfg = sd.advance.tables, sd.cfg_scheme
    worst = {}
    if not strips_only:
        fluxes = []
        e = (0.0, 0.0)
        for axis, ext in enumerate((x, y)):
            xf = t.xf if axis == 0 else t.yf
            got = TU.fused_fluxes_cuda(*ext, xf, t.spacing, bodies, axis, cfg)
            torch.cuda.synchronize()
            e = tuple(map(max, e, cell_bar(got, TU.fused_fluxes_plain(
                *ext, xf, t.spacing, bodies, axis, cfg), dtype, F32_ULPS)))
            fluxes.append(got)
        worst["b11a"] = e
        args = (u0, p0, *fluxes, t.xc, t.buffer_rate, t.initial_conserved,
                t.dA, dt, bodies, cfg)
        got = TU.fused_update_cuda(*args)
        torch.cuda.synchronize()
        worst["b11b"] = compare(got, TU.fused_update_plain(*args), dtype)
    args = (u0, p0, strips, t.blockgeo, t.initial_conserved, t.spacing, dt,
            bodies, theta, cfg)
    got = TK.advance_core_strips_cuda(*args)
    torch.cuda.synchronize()
    want = TK.advance_core_strips_plain(*args)
    e = cell_bar(got[0], want[0], dtype, F32_ULPS)
    for g, w in zip(got[1], want[1]):
        e = tuple(map(max, e, cell_bar(g, w, dtype, F32_ULPS)))
    bars = F64_TOTALS if dtype == torch.float64 else F32_TOTALS
    for k in want[2]:
        a = got[2][k].double().cpu().numpy()
        b = want[2][k].double().cpu().numpy()
        check(allclose(a, b, **bars), f"B11c total {k}: {a} vs {b}")
    worst["b11c"] = e
    return worst


def flagship_marginal(advance, u0, bodies, dt, theta, zones):
    """bench_flagship.py's marginal rate (zone-updates/s) of `advance`:
    n1 and n2 advances back to back, each run ended by reading the state to
    the host, the best of 3 of each."""
    import torch
    n1, n2 = FLAGSHIP_MARGINAL

    def run(n):
        u = u0
        for _ in range(n):
            u = advance(u, bodies, dt, theta)[0]
        return u.cpu()

    check(bool(torch.isfinite(run(n1)).all()), "non-finite variant state")
    run(n2)

    def once(n):
        t0 = time.perf_counter()
        run(n)
        return time.perf_counter() - t0

    t1 = min(once(n1) for _ in range(3))
    t2 = min(once(n2) for _ in range(3))
    return zones * (n2 - n1) / max(t2 - t1, 1e-9), (t2 - t1) / (n2 - n1)


def variant_phases(device, smi):
    """Phases 31-34 (kernels B11a-c, the advance variants, and regrid=1);
    returns the kernels line's entries of B11a, B11b and B11c."""
    import numpy as np
    import torch
    from mara3_tpu_torch.kernels import binary_advance as TK
    from mara3_tpu_torch.kernels import binary_multi as TM
    from mara3_tpu_torch.kernels import binary_update as TU
    from mara3_tpu_torch.mesh import block_layout as BL
    from mara3_tpu_torch.schemes import binary_scheme as TS
    from mara3_tpu_torch.subprograms import binary as TB
    f64, f32 = torch.float64, torch.float32
    d3b16 = {"depth": 3, "block_size": 16, "density_floor": 1e-3}
    d6b96 = FLAGSHIP

    # ---- phase 31: B11a-c against their plain versions ---------------------
    for dtype in (f64, f32):
        worst, cases = {}, 0
        for over in STRIPS:
            case = b11_inputs(TB, TS, BL, {**d3b16, **over}, device, dtype)
            e = b11_parity(TU, TK, case, dtype,
                           strips_only=over["riemann"] != "hlle")
            for k, v in e.items():
                worst[k] = tuple(map(max, worst.get(k, (0.0, 0.0)), v))
            cases += 1
        print(f"B11 parity d3b16 {str(dtype)[6:]}: B11a and B11b over "
              f"{len(SPLIT)} configs, B11c over {len(STRIPS)}, pass; max "
              f"|du| " + ", ".join(f"{k.upper()} {v[0]:.3e} ({v[1]:.2f} ulps "
                                   f"of its cell)" for k, v in worst.items()))
    b11_err = {}
    for dtype in (f64, f32):      # float32 last: it is then timed
        case = b11_inputs(TB, TS, BL, d6b96, device, dtype)
        e = b11_parity(TU, TK, case, dtype)
        b11_err = {k: v[0] for k, v in e.items()}
        print(f"B11 parity d6b96 {str(dtype)[6:]}: max |du| " + ", ".join(
            f"{k.upper()} {v[0]:.3e} ({v[1]:.2f} ulps of its cell)"
            for k, v in e.items()))
    sd, u0, bodies, dt, (p0, x, y), (_, strips, theta) = case
    t, cfg = sd.advance.tables, sd.cfg_scheme
    B, bs = u0.shape[0], u0.shape[1]
    fluxes = [TU.fused_fluxes_cuda(*x, t.xf, t.spacing, bodies, 0, cfg),
              TU.fused_fluxes_cuda(*y, t.yf, t.spacing, bodies, 1, cfg)]
    upd = (u0, p0, *fluxes, t.xc, t.buffer_rate, t.initial_conserved, t.dA,
           dt, bodies, cfg)
    adv = (u0, p0, strips, t.blockgeo, t.initial_conserved, t.spacing, dt,
           bodies, theta, cfg)
    timed = {
        "b11a": in_turns(
            lambda: (TU.fused_fluxes_plain(*x, t.xf, t.spacing, bodies, 0,
                                           cfg),
                     TU.fused_fluxes_plain(*y, t.yf, t.spacing, bodies, 1,
                                           cfg)),
            lambda: (TU.fused_fluxes_cuda(*x, t.xf, t.spacing, bodies, 0,
                                          cfg),
                     TU.fused_fluxes_cuda(*y, t.yf, t.spacing, bodies, 1,
                                          cfg)), 5, 50),
        "b11b": in_turns(lambda: TU.fused_update_plain(*upd),
                         lambda: TU.fused_update_cuda(*upd), 5, 50),
        "b11c": in_turns(lambda: TK.advance_core_strips_plain(*adv),
                         lambda: TK.advance_core_strips_cuda(*adv), 5, 50)}
    bounds = {k: b11_bound(k, B, bs, u0.element_size()) for k in timed}
    for k, (ms, plain_ms, runs) in timed.items():
        print(f"time d6b96 float32: {k.upper()} {ms:.4f} ms kernel vs "
              f"{plain_ms:.4f} ms plain (runs " + " ".join(
                  f"{r:.4f}" for r in runs) + f"); bound {bounds[k][0]:.4f} "
              f"ms ({bounds[k][1]}) on {smi}")
    del case, fluxes, upd, adv, strips, p0, x, y

    # ---- phase 32: the variant path ----------------------------------------
    TK.advance_cuda.launches = TM.advance_k_cuda.launches = 0
    TU.fused_fluxes_cuda.launches = TU.fused_update_cuda.launches = 0
    TK.advance_core_strips_cuda.launches = 0
    sd, u0, bodies, dt = seeded_case(TB, d6b96, device, f32)
    bodies_d = torch.as_tensor(bodies, dtype=f32, device=device)
    dt_d = torch.tensor(dt, dtype=f32, device=device)
    zones = u0.shape[0] * u0.shape[1] * u0.shape[2]
    advances = {v: TS.make_advance(sd.cfg_scheme, sd.nt, sd.geometry,
                                   sd.initial_conserved, sd.buffer_rate,
                                   device=device, dtype=f32, fused=v)
                for v in VARIANTS}
    ref = advances[False](u0, bodies, dt, sd.plm_theta)
    rates = {}
    for v in VARIANTS:
        before = (TK.advance_cuda.launches, TU.fused_fluxes_cuda.launches,
                  TU.fused_update_cuda.launches,
                  TK.advance_core_strips_cuda.launches)
        got = advances[v](u0, bodies, dt, sd.plm_theta)
        torch.cuda.synchronize()
        after = (TK.advance_cuda.launches, TU.fused_fluxes_cuda.launches,
                 TU.fused_update_cuda.launches,
                 TK.advance_core_strips_cuda.launches)
        launched = tuple(a - b for a, b in zip(after, before))
        expect = {True: (1, 0, 0, 0), "jnp_strips": (0, 0, 0, 1),
                  "split": (0, 2, 1, 0), False: (0, 0, 0, 0)}[v]
        check(launched == expect, f"fused={v!r} launched (B2, B11a, B11b, "
                                  f"B11c) {launched}, not {expect}")
        err, ulps = compare(got, ref, f32)
        rate, step_s = flagship_marginal(advances[v], u0, bodies_d, dt_d,
                                         sd.plm_theta, zones)
        rates[v] = rate
        print(f"variant fused={v!r} d6b96 float32: one advance against "
              f"fused=False max |du| {err:.3e} ({ulps:.2f} ulps of its "
              f"cell); (B2, B11a, B11b, B11c) launches an advance "
              f"{launched}; marginal {rate:.6e} zone-updates/s "
              f"({1e3 * step_s:.4f} ms an advance, steps "
              f"{FLAGSHIP_MARGINAL[0]} -> {FLAGSHIP_MARGINAL[1]}) on {smi}")
    launches = {"b11a": TU.fused_fluxes_cuda.launches,
                "b11b": TU.fused_update_cuda.launches,
                "b11c": TK.advance_core_strips_cuda.launches}
    check(all(n > 0 for n in launches.values()),
          f"a B11 kernel was not launched on the variant path: {launches}")
    print(f"variant path: B11a {launches['b11a']}, B11b "
          f"{launches['b11b']}, B11c {launches['b11c']}, B2 "
          f"{TK.advance_cuda.launches} launches; B3 "
          f"{TM.advance_k_cuda.launches}")
    del advances, ref, got, u0, sd

    # ---- phase 33: regrid=1, card against CPU ------------------------------
    for loop in (["fast_step=0"], ["fast_step=1", "multi_launch=4"]):
        ends = []
        for dev in (device, torch.device("cpu")):
            with contextlib.redirect_stdout(io.StringIO()):
                cfg_, sd_, state = TB.setup(
                    REGRID_ARGS + loop + ["outdir=."], device=dev, dtype=f64)
                final = TB.run(cfg_, sd_, state, tasks=record_only(TB))
            ends.append((final.solver_data.leaves,
                         final.solution.conserved.cpu().numpy(),
                         final.solution.iteration,
                         len(sd_.leaves)))
        (lg, ug, ig, n0), (lc, uc, ic, _) = ends
        check(lg == lc and ig == ic, f"regrid {loop}: the card ended on "
              f"{len(lg)} blocks after {ig} steps, the CPU on {len(lc)} "
              f"after {ic}")
        check(len(lg) != n0, f"regrid {loop}: the tree did not change")
        cell = np.abs(uc).max(axis=-1, keepdims=True)
        check(allclose(ug, uc, **F64_U)
              and bool(np.all(np.abs(ug - uc) <= 1e-14 * cell)),
              f"regrid {loop}: the card's state differs from the CPU's")
        print(f"regrid d4b8 {' '.join(loop)} float64: {ig} steps, "
              f"{n0} -> {len(lg)} blocks, the same leaves on the card and "
              f"the CPU, max |du| {float(np.abs(ug - uc).max()):.3e}")

    # ---- phase 34: regrid=1 on the main path at full width -----------------
    regrids = []
    apply_regrid = TB.apply_regrid

    def timed_regrid(solution, sd_, cfg_):
        t0 = time.perf_counter()
        out = apply_regrid(solution, sd_, cfg_)
        regrids.append((len(sd_.leaves), len(out[1].leaves),
                        (time.perf_counter() - t0) * 1e3,
                        solution.iteration, TM.advance_k_cuda.launches))
        return out

    TB.apply_regrid = timed_regrid
    TK.advance_cuda.launches = TM.advance_k_cuda.launches = 0
    try:
        with tempfile.TemporaryDirectory() as outdir:
            cfg_, sd0, final, log, wall = drive(
                TB, ["binary"] + [f"{k}={v}" for k, v in FLAGSHIP.items()]
                + REGRID_START, REGRID_LENGTH, device, outdir,
                rgi_steps=REGRID_EVERY)
    finally:
        TB.apply_regrid = apply_regrid
    b3, b2 = TM.advance_k_cuda.launches, TK.advance_cuda.launches
    sd_end = final.solver_data
    rates_, retries, _ = check_final(final, sd_end, log,
                                     "step retried in safe mode")
    changed = [r for r in regrids if r[0] != r[1]]
    check(len(changed) >= 2, f"{len(changed)} regrids changed the tree")
    check(b3 >= 3 and b2 == retries, f"{b3} B3 and {b2} B2 launches")
    steps = final.solution.iteration
    marks = [0] + [r[3] for r in regrids] + [steps]
    blocks = [regrids[0][0]] + [r[1] for r in regrids]
    bs = FLAGSHIP["block_size"]
    updates = sum((b - a) * n * bs * bs
                  for a, b, n in zip(marks, marks[1:], blocks))
    launch_marks = [0] + [r[4] for r in regrids] + [b3]
    for (before, after, ms, it, _), n in zip(
            regrids, np.diff(launch_marks)[:-1]):
        print(f"regrid d6b96 at step {it}: {before} -> {after} blocks in "
              f"{ms:.3f} ms on the host (the scan and B3's tables "
              f"rebuilt when the tree changed); {n} B3 launches before it")
    print(f"regrid main path d6b96 {' '.join(REGRID_START)} float32 "
          f"(fast_step=1, multi_launch=16; tfinal and rgi {REGRID_LENGTH} "
          f"and {REGRID_EVERY} times the first dt): {steps} steps, {b3} B3 "
          f"launches ({launch_marks[-1] - launch_marks[-2]} after the last "
          f"regrid), {b2} B2, {len(changed)} of {len(regrids)} regrids "
          f"changed the tree, {len(sd_end.leaves)} blocks at the end, "
          f"{wall:.4f} s wall; whole-run {updates / wall:.6e} zone-updates/s"
          f" ({updates / wall / 1e3:.2f} kzps); finite, min density "
          f"{float(final.solution.conserved[..., 0].min()):.6e} on {smi}")

    def row(k, name, source, replaces):
        ms, plain_ms, _ = timed[k]
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": launches[k],
                "max_abs_err": b11_err[k], "ms": ms, "plain_ms": plain_ms,
                "bound_ms": bounds[k][0], "bound_by": bounds[k][1],
                "library_ms": None}

    return [
        row("b11a", "binary_update fused_fluxes (B11a, both axes)",
            "mara3_tpu_torch/csrc/binary_update.cu",
            "mara3_tpu/kernels/binary_update.py:350"),
        row("b11b", "binary_update fused_update (B11b)",
            "mara3_tpu_torch/csrc/binary_update.cu",
            "mara3_tpu/kernels/binary_update.py:159"),
        row("b11c", "binary_advance_strips (B11c)",
            "mara3_tpu_torch/csrc/binary_advance_strips.cu",
            "mara3_tpu/kernels/binary_advance.py:417")]


def seeded_strips(gi, h, ny, dtype, device, seed):
    """(lo, hi) [gi, 3, h, ny] of seeded states, unrelated to the state
    they border."""
    return tuple(seeded_iso2d(gi * h, ny, dtype, device, seed + k)
                 .reshape(3, gi, h, ny).permute(1, 0, 2, 3).contiguous()
                 for k in (0, 1))


def window_updates(extent, h, stages):
    """The cells along one axis that a window of extent + 2h updates over
    `stages` stages, shrinking by 2 a side a stage."""
    return sum(extent + 2 * h - 4 * s for s in range(1, stages + 1))


def ladder_bound(tensors, updates, rk2_averages=0, riemann="hlle",
                 face_ops=0):
    """(ms, "bytes" or "operations"): the least time for a ladder kernel's
    call that reads and writes `tensors` once each and does `updates`
    cell-stage updates (with `face_ops` more at each of a cell's two faces)
    and `rk2_averages` Heun averages."""
    nbytes = sum(t.numel() * t.element_size() for t in tensors)
    ops = (updates * (B1_OPS_CELL_STAGE[riemann] + 2 * face_ops)
           + rk2_averages * B1_OPS_CELL_RK2_STEP)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / F32_OPS_PER_S
    return (max(t_bytes, t_ops) * 1e3,
            "bytes" if t_bytes >= t_ops else "operations")


def ladder_phases(device, smi, b1):
    """Phases 35-40 (kernels B9 and B10a-c, kh's x-sharded run); `b1` holds
    phases 13-15's B1 numbers, printed beside. Returns the kernels line's
    entries of B9, B10a, B10b and B10c."""
    import torch
    from mara3_tpu_torch.kernels import iso2d_step as T1
    from mara3_tpu_torch.kernels import iso2d_step_v1 as V1
    from mara3_tpu_torch.kernels import iso2d_step_v2 as V2
    from mara3_tpu_torch.kernels import iso2d_step_v3 as V3
    from mara3_tpu_torch.kernels import iso2d_step_v4 as V4
    from mara3_tpu_torch.parallel import iso2d_sharded as TSH
    from mara3_tpu_torch.subprograms import kh as KH
    f64, f32 = torch.float64, torch.float32
    kh_cfg = KH.config_template().create().update({"N": KH_N})
    kh64 = KH.initial_conserved(kh_cfg, dtype=f64)
    kw = KH.advance_kwargs(kh_cfg, KH.fixed_timestep(kh_cfg, kh64))
    base = dict(cs2=kw["cs2"], dtdx=kw["dt"] / kw["dx"],
                dtdy=kw["dt"] / kw["dy"], theta=kw["theta"])
    keys = ("b9", "b10a", "b10b", "b10c")
    err, bitwise = {}, dict.fromkeys(keys, True)

    # ---- phase 35: B9 and B10a-c against their plain versions and B1 -------
    t0 = time.perf_counter()
    for dtype in (f64, f32):
        worst, cases = dict.fromkeys(keys, (0.0, 0.0)), 0
        big = kh64.to(dtype).permute(2, 0, 1).contiguous().to(device)
        odd = seeded_iso2d(*LADDER_ODD, dtype, device)
        shapes = ((odd, LADDER_ODD_TX, LADDER_ODD_G, LADDER_ODD_TILE,
                   LADDER_ODD_TILE),
                  (big, LADDER_TX, LADDER_G, LADDER_V2_TILE, LADDER_V3_TILE))
        for u, TX, G, tile2, tile3 in shapes:
            pairs = []
            for rk in (1, 2):
                for riemann in ("hlle", "hllc"):
                    h, ny = 2 * G * rk, u.shape[2]
                    k4 = dict(base, G=G, TX=TX, rk_order=rk, riemann=riemann)
                    for strips in (V4.build_x_strips(u, TX, h),
                                   seeded_strips(u.shape[1] // TX, h, ny,
                                                 dtype, device, 7)):
                        pairs.append((
                            "b9", V4.step_v4_strips_cuda(u, *strips, **k4),
                            lambda s=strips, k=k4:
                                V4.step_v4_strips_plain(u, *s, **k)))
            ext = V1.extend_periodic(u)
            s2 = V2.build_halo_strips(u, *tile2)
            s3 = V2.build_halo_strips(u, *tile3, h=2 * G)
            pairs += [
                ("b10a", V1.step_v1_cuda(ext, **base),
                 lambda: V1.step_v1_plain(ext, **base)),
                ("b10b", V2.step_v2_strips_cuda(u, *s2, tile=tile2, **base),
                 lambda: V2.step_v2_strips_plain(u, *s2, tile=tile2,
                                                 **base)),
                ("b10c", V3.step_v3_strips_cuda(u, *s3, G=G, tile=tile3,
                                                **base),
                 lambda: V3.step_v3_strips_plain(u, *s3, G=G, tile=tile3,
                                                 **base))]
            torch.cuda.synchronize()
            for k, got, plain in pairs:
                e = b1_bar(got, plain(), dtype)
                worst[k] = tuple(map(max, worst[k], e))
                cases += 1
                if u is big and k not in err and dtype == f32:
                    err[k] = e[0]   # B9's first: periodic rk1 hlle
            # against B1 in rk1 hlle, G steps of each periodic wrapper
            want = T1.advance_n_cuda(u, G, **base)
            runs = {"b9": V4.advance_n_v4(u, G, G=G, TX=TX, **base),
                    "b10a": V1.advance_n_v1(u, G, **base),
                    "b10b": V2.advance_n_v2(u, G, tile=tile2, **base),
                    "b10c": V3.advance_n_v3(u, G, G=G, tile=tile3, **base)}
            torch.cuda.synchronize()
            for k, got in runs.items():
                if not torch.equal(got, want):
                    bitwise[k] = False
                    b1_bar(got, want, dtype)     # held at the ulp bar
            del pairs, runs, want
        print(f"ladder parity {str(dtype)[6:]}: {cases} cases pass (B9 "
              f"{{rk1, rk2}} x {{hlle, hllc}} x {{periodic, random strips}}"
              f", B10a, B10b, B10c at {LADDER_ODD[0]}x{LADDER_ODD[1]} and "
              f"{KH_N}^2); max |du| against the plain versions: "
              + ", ".join(f"{k} {v[0]:.3e} ({v[1]:.2f} ulps of its cell)"
                          for k, v in worst.items()))
    print("ladder against B1 (rk1 hlle, G steps, both shapes, float64 and "
          "float32): " + ", ".join(
              f"{k} {'bitwise' if v else 'NOT bitwise, within the ulp bar'}"
              for k, v in bitwise.items()))
    del big, odd
    print(f"phase 35: {time.perf_counter() - t0:.1f} s")

    # ---- phase 36: the sharded module, 4 shards on one card ----------------
    t0 = time.perf_counter()
    u = kh64.to(f32).permute(2, 0, 1).contiguous().to(device)
    for rk, riemann in ((1, "hlle"), (2, "hllc")):
        k4 = dict(base, TX=LADDER_TX, rk_order=rk, riemann=riemann)
        runs = []
        for n in (4, 1):
            devices = [device] * n
            adv = TSH.make_advance_v4_sharded(devices, G=LADDER_G, **k4)
            V4.step_v4_strips_cuda.launches = 0
            runs.append(TSH.gather_state(adv(TSH.shard_state(u, devices),
                                             SHARDED_STEPS)))
            want = n * SHARDED_STEPS // LADDER_G
            check(V4.step_v4_strips_cuda.launches == want,
                  f"{V4.step_v4_strips_cuda.launches} B9 calls on {n} "
                  f"shards, not {want}")
        b1_run = T1.advance_n_cuda(u, SHARDED_STEPS, **base, rk_order=rk,
                                   riemann=riemann)
        torch.cuda.synchronize()
        check(torch.equal(runs[0], runs[1]),
              f"4 shards on one card differ from one shard (rk{rk} "
              f"{riemann})")
        same = torch.equal(runs[0], b1_run)
        if not same:
            b1_bar(runs[0], b1_run, f32)
        print(f"sharded {KH_N}^2 float32 rk{rk} {riemann}: "
              f"make_advance_v4_sharded([{device}] * 4) {SHARDED_STEPS} steps"
              f" ({4 * SHARDED_STEPS // LADDER_G} B9 calls) bitwise equal "
              f"to one shard; against B1 "
              + ("bitwise" if same else "within the ulp bar, not bitwise"))
    del runs, b1_run
    print(f"phase 36: {time.perf_counter() - t0:.1f} s")

    # ---- phase 37: kh shards=-1 on the card against shards=2 on the CPU ----
    t0 = time.perf_counter()
    finals, paths = {}, {}
    for where, shards, dev in (("card", -1, device), ("cpu", 2, "cpu")):
        with contextlib.redirect_stdout(io.StringIO()):
            cfg, state = KH.setup(["kh", "N=256", f"shards={shards}"],
                                  device=dev, dtype=f64)
            cfg = cfg.set("tfinal", (KH_SHARDED_CPU_STEPS - 0.5)
                          * state.solution.dt)
            final = KH.run(cfg, state, tasks=kh_record_only(KH, []))
        check(final.solution.iteration == KH_SHARDED_CPU_STEPS,
              f"kh ran {final.solution.iteration} steps on the {where}")
        finals[where], paths[where] = final.solution.conserved.cpu(), \
            KH.LAST_PATH
    ncard = torch.cuda.device_count()
    check(paths == {"card": f"sharded_b9[{ncard}dev]",
                    "cpu": "sharded_b9[2dev]"}, f"kh ran {paths}")
    check(allclose(finals["card"].numpy(), finals["cpu"].numpy(),
                   **KH_CARD_CPU),
          "kh N=256 shards: the card differs from the CPU")
    print(f"kh N=256 float64: {KH_SHARDED_CPU_STEPS} steps of shards=-1 "
          f"({paths['card']}, B9 on the card) match shards=2 on the CPU "
          f"({paths['cpu']}, B9's plain version) at rtol "
          f"{KH_CARD_CPU['rtol']}, max |du| "
          f"{float((finals['card'] - finals['cpu']).abs().max()):.3e}")
    print(f"phase 37: {time.perf_counter() - t0:.1f} s")

    # ---- phase 38: the kh sharded main path at full width ------------------
    t0 = time.perf_counter()
    kh_argv = ["kh", f"N={KH_N}", "shards=-1"]
    final, log, wall, samples, b9_main = drive_kh(
        KH, V4.step_v4_strips_cuda, kh_argv, KH_STEPS, device)
    rates = check_kh(final, log, samples, b9_main, KH_N, KH_STEPS,
                     "sharded_b9", grain=LADDER_G, shards=ncard)
    rate = KH_STEPS * KH_N * KH_N / wall
    print(f"kh sharded main path N={KH_N} shards=-1 ({ncard} card) rk1 hlle "
          f"float32: {KH_STEPS} steps in {b9_main} B9 calls "
          f"({len(rates)} chunks), {wall:.4f} s wall; whole-run {rate:.6e} "
          f"zone-updates/s against B1's {b1['kh']:.6e} (phase 13) on {smi}")
    final, log, wall, samples, calls = drive_kh(
        KH, V4.step_v4_strips_cuda, kh_argv + ["rk_order=2", "riemann=hllc"],
        KH_RK2_STEPS, device)
    check_kh(final, log, samples, calls, KH_N, KH_RK2_STEPS, "sharded_b9",
             grain=LADDER_G, shards=ncard)
    rate2 = KH_RK2_STEPS * KH_N * KH_N / wall
    print(f"kh sharded N={KH_N} rk2 hllc float32: {KH_RK2_STEPS} steps in "
          f"{calls} B9 calls, {wall:.4f} s wall; whole-run {rate2:.6e} "
          f"zone-updates/s against B1's {b1['kh2']:.6e} on {smi}")
    del final
    print(f"phase 38: {time.perf_counter() - t0:.1f} s")

    # ---- phase 39: the bench-shaped rates (the ladder's path) --------------
    t0 = time.perf_counter()
    ub = bench_state(KH_N, device)
    bench_kw = dict(cs2=0.1, dtdx=0.4, dtdy=0.4, theta=1.8)
    wrappers = {"b9": V4.step_v4_strips_cuda, "b10a": V1.step_v1_cuda,
                "b10b": V2.step_v2_strips_cuda, "b10c": V3.step_v3_strips_cuda}
    for w in wrappers.values():
        w.launches = 0
    v4 = lambda n: V4.advance_n_v4(ub, n, G=LADDER_G, TX=LADDER_TX,
                                   **bench_kw)
    v3 = lambda n: V3.advance_n_v3(ub, n, G=LADDER_G, tile=LADDER_V3_TILE,
                                   **bench_kw)
    for f in (v4, v3):
        check(bool(torch.isfinite(f(52)).all()), "non-finite bench state")
    zps4, spread4, _ = marginal_rate(v4, KH_N * KH_N, 52, 4052)
    zps3, spread3, _ = marginal_rate(v3, KH_N * KH_N, 52, 4052)
    step_a = time_ms(lambda: V1.advance_n_v1(ub, 1, **bench_kw), 50)
    step_b = time_ms(lambda: V2.advance_n_v2(ub, 1, tile=LADDER_V2_TILE,
                                             **bench_kw), 50)
    launches = {k: w.launches for k, w in wrappers.items()}
    launches["b9"] = b9_main
    check(all(v > 0 for v in launches.values()),
          f"a ladder kernel was not launched: {launches}")
    print(f"bench-shaped rates (N={KH_N}, rk1 hlle float32, marginal 52 -> "
          f"4052 steps, median of 5, G={LADDER_G}): B9 (TX={LADDER_TX}) "
          f"{zps4:.6e} zone-updates/s (spread {100 * spread4:.1f}%), B10c "
          f"(tile {LADDER_V3_TILE}) {zps3:.6e} ({100 * spread3:.1f}%), "
          f"against B1's {b1['bench']:.6e} (phase 14); one step with its "
          f"extension or strips: B10a {step_a:.4f} ms, B10b (tile "
          f"{LADDER_V2_TILE}) {step_b:.4f} ms, B1 {b1['step_ms']:.4f} ms "
          f"(phase 15); launches in this phase: B10a {launches['b10a']}, "
          f"B10b {launches['b10b']}, B10c {launches['b10c']} (B9 "
          f"{launches['b9']} on phase 38's main path) on {smi}")
    del ub
    print(f"phase 39: {time.perf_counter() - t0:.1f} s")

    # ---- phase 40: timing at 2048^2 float32 --------------------------------
    t0 = time.perf_counter()
    nx, ny = u.shape[1], u.shape[2]
    G, h = LADDER_G, 2 * LADDER_G
    lo, hi = V4.build_x_strips(u, LADDER_TX, h)
    k4 = dict(base, G=G, TX=LADDER_TX)
    ext = V1.extend_periodic(u)
    s2 = V2.build_halo_strips(u, *LADDER_V2_TILE)
    s3 = V2.build_halo_strips(u, *LADDER_V3_TILE, h=h)
    timed = {
        "b9": in_turns(lambda: V4.step_v4_strips_plain(u, lo, hi, **k4),
                       lambda: V4.step_v4_strips_cuda(u, lo, hi, **k4), 2,
                       20),
        "b10a": in_turns(lambda: V1.step_v1_plain(ext, **base),
                         lambda: V1.step_v1_cuda(ext, **base), 3, 50),
        "b10b": in_turns(
            lambda: V2.step_v2_strips_plain(u, *s2, tile=LADDER_V2_TILE,
                                            **base),
            lambda: V2.step_v2_strips_cuda(u, *s2, tile=LADDER_V2_TILE,
                                           **base), 3, 50),
        "b10c": in_turns(
            lambda: V3.step_v3_strips_plain(u, *s3, G=G, tile=LADDER_V3_TILE,
                                            **base),
            lambda: V3.step_v3_strips_cuda(u, *s3, G=G, tile=LADDER_V3_TILE,
                                           **base), 2, 20)}
    bounds = {
        "b9": ladder_bound((u, lo, hi, u), ny * nx // LADDER_TX
                           * window_updates(LADDER_TX, h, G)),
        "b10a": ladder_bound((ext, u), nx * ny),
        "b10b": ladder_bound((u, *s2, u), nx * ny),
        "b10c": ladder_bound((u, *s3, u),
                             tile_updates((nx, ny), LADDER_V3_TILE, G))}
    steps = {"b9": G, "b10a": 1, "b10b": 1, "b10c": G}
    for k, (ms, plain_ms, runs) in timed.items():
        earlier = (f"; the earlier window design {B9_WINDOW_CALL_MS:.4f} ms a "
                   f"call (PERF.md)" if k == "b9" else "")
        print(f"time {KH_N}^2 float32 rk1 hlle {k}: {ms:.4f} ms a call of "
              f"{steps[k]} steps ({ms / steps[k]:.4f} ms a step) vs plain "
              f"{plain_ms:.4f} ms (runs " + " ".join(f"{r:.4f}" for r in runs)
              + f"); bound {bounds[k][0]:.4f} ms ({bounds[k][1]}); B1 "
              f"{b1['step_ms']:.4f} ms a step (phase 15){earlier} on {smi}")
    print(f"phase 40: {time.perf_counter() - t0:.1f} s")

    names = {"b9": ("iso2d_step_v4 (B9)",
                    "mara3_tpu/kernels/iso2d_step_v4.py:135"),
             "b10a": ("iso2d_step v1 (B10a)",
                      "mara3_tpu/kernels/iso2d_step.py:211"),
             "b10b": ("iso2d_step_v2 (B10b)",
                      "mara3_tpu/kernels/iso2d_step_v2.py:115"),
             "b10c": ("iso2d_step_v3 (B10c)",
                      "mara3_tpu/kernels/iso2d_step_v3.py:46")}
    return [{"name": names[k][0], "route": "cuda",
             "source": "mara3_tpu_torch/csrc/iso2d_ladder.cu",
             "replaces": names[k][1], "launches": launches[k],
             "max_abs_err": err[k], "ms": timed[k][0],
             "plain_ms": timed[k][1], "bound_ms": bounds[k][0],
             "bound_by": bounds[k][1], "library_ms": None} for k in keys]


def sweep_state(n, dtype, device):
    """bench_kernel_sweep.py's state [3, n, n] (:27-30): sigma = 1 + 0.2 U,
    momenta 0.1 and -0.05 sigma, from a torch generator of seed 0."""
    import torch
    gen = torch.Generator(device=device).manual_seed(0)
    sigma = 1.0 + 0.2 * torch.rand((n, n), generator=gen, device=device,
                                   dtype=torch.float32)
    return torch.stack([sigma, 0.1 * sigma, -0.05 * sigma]).to(dtype)


def tile_updates(shape, tile, G):
    """The cell-stage updates of G window steps of every tile: each window
    of (TX + 4G) x (TY + 4G) shrinks by 2 a side a stage."""
    (nx, ny), (TX, TY), h = shape, tile, 2 * G
    return (nx // TX) * (ny // TY) * sum(
        (TX + 2 * h - 4 * s) * (TY + 2 * h - 4 * s) for s in range(1, G + 1))


def li_phases(device, smi):
    """Phases 41-43 (kernel B8 and its path, the kernel sweep's lig4 rung).
    Returns B8's entry of the kernels line."""
    import torch
    from mara3_tpu_torch.kernels import iso2d_step_li as TL
    from mara3_tpu_torch.kernels import iso2d_step_v2 as V2
    from mara3_tpu_torch.kernels import iso2d_step_v3 as V3
    f64, f32 = torch.float64, torch.float32
    n = LI_N
    dx = 1.0 / n
    lig = dict(geom=(dx, 1.0, 1.0, 1.0, 1.0, 100.0, 1e-4), dtdx=LI_DT / dx,
               dtdy=LI_DT / dx, theta=1.8, G=LI_G, tile=LI_TILE)
    v3g = dict(cs2=0.01, dtdx=LI_DT / dx, dtdy=LI_DT / dx, theta=1.8,
               G=LI_G, tile=LI_TILE)

    # ---- phase 41: B8 against its plain version ----------------------------
    t0 = time.perf_counter()
    for dtype in (f64, f32):
        worst, cases, bitwise = (0.0, 0.0), 0, 0
        odd = seeded_iso2d(*LI_ODD, dtype, device)
        noise = seeded_iso2d(*LI_ODD, dtype, device, seed=1)
        big = sweep_state(n, dtype, device)
        runs = []
        for G in (1, 2, 4):
            for g in LI_ODD_GEOMS:
                k = dict(geom=g, dtdx=LI_DT / g[0], dtdy=LI_DT / g[0],
                         theta=1.8, G=G, tile=LI_ODD_TILE)
                runs.append((odd, V2.build_halo_strips(odd, *LI_ODD_TILE,
                                                       h=2 * G), k))
            runs.append((odd, V2.build_halo_strips(noise, *LI_ODD_TILE,
                                                   h=2 * G), k))
        runs.append((big, V2.build_halo_strips(big, *LI_TILE, h=2 * LI_G),
                     lig))
        for u, strips, k in runs:
            got = TL.step_li_strips_cuda(u, *strips, **k)
            torch.cuda.synchronize()
            want = TL.step_li_strips_plain(u, *strips, **k)
            e = b1_bar(got, want, dtype)
            worst = tuple(map(max, worst, e))
            cases += 1
            bitwise += bool(torch.equal(got, want))
            if u is big and dtype == f32:
                b8_err = e[0]
            del got, want
        print(f"B8 parity {str(dtype)[6:]}: {cases} cases pass (G in 1, 2, "
              f"4 at {LI_ODD[0]}x{LI_ODD[1]} in tiles {LI_ODD_TILE}, beside "
              f"and across r = 0, periodic and random strips; {n}^2 in tiles "
              f"{LI_TILE}, G = {LI_G}, the sweep's geometry), {bitwise} of "
              f"them bit for bit; max |du| {worst[0]:.3e} ({worst[1]:.2f} "
              f"ulps of its cell)")
        del big, runs
    print(f"phase 41: {time.perf_counter() - t0:.1f} s")

    # ---- phase 42: B8's path, the sweep's lig4 rung ------------------------
    t0 = time.perf_counter()
    ub = sweep_state(n, f32, device)
    mass0 = float(ub[0].double().sum())
    li = lambda m: TL.advance_n_li(ub, m, **lig)
    v3 = lambda m: V3.advance_n_v3(ub, m, **v3g)
    TL.step_li_strips_cuda.launches = 0
    zps, spread, rates = marginal_rate(li, n * n, *LI_MARGINAL)
    out = li(LI_MARGINAL[1])
    torch.cuda.synchronize()
    b8_launches = TL.step_li_strips_cuda.launches
    # marginal_rate's two warm-up calls and 5 pairs of two of each, then one
    want = ((1 + 2 * 5) * sum(LI_MARGINAL) + LI_MARGINAL[1]) // LI_G
    check(b8_launches == want, f"{b8_launches} B8 launches on the lig4 "
                               f"path, not {want}")
    check(bool(torch.isfinite(out).all()), "non-finite lig4 state")
    drift = abs(float(out[0].double().sum()) - mass0) / mass0
    check(drift < 1e-5, f"lig4 mass drift {drift:.3e}")
    zps3, spread3, _ = marginal_rate(v3, n * n, *LI_MARGINAL)
    print(f"lig4 ({n}^2 float32, tile {LI_TILE}, G = {LI_G}, marginal "
          f"{LI_MARGINAL[0]} -> {LI_MARGINAL[1]} steps, median of 5): B8 "
          f"{zps:.6e} zone-updates/s (spread {100 * spread:.1f}%; "
          + " ".join(f"{r:.4e}" for r in rates) + f"), {b8_launches} B8 "
          f"launches; mass drift over {LI_MARGINAL[1]} steps {drift:.3e}; "
          f"v3g4 (B10c, cs^2 0.01) {zps3:.6e} ({100 * spread3:.1f}%) on "
          f"{smi}")
    del out
    print(f"phase 42: {time.perf_counter() - t0:.1f} s")

    # ---- phase 43: timing at 8192^2 float32 --------------------------------
    t0 = time.perf_counter()
    strips = V2.build_halo_strips(ub, *LI_TILE, h=2 * LI_G)
    b8_ms, b8_plain_ms, runs = in_turns(
        lambda: TL.step_li_strips_plain(ub, *strips, **lig),
        lambda: TL.step_li_strips_cuda(ub, *strips, **lig), 1, 10)
    v3_ms = time_ms(lambda: V3.step_v3_strips_cuda(ub, *strips, **v3g), 10)
    strip_ms = time_ms(lambda: V2.build_halo_strips(ub, *LI_TILE,
                                                    h=2 * LI_G), 10)
    updates = tile_updates((n, n), LI_TILE, LI_G)
    b8_bnd = ladder_bound((ub, *strips, ub), updates, face_ops=B8_OPS_FACE)
    v3_bnd = ladder_bound((ub, *strips, ub), updates)
    print(f"time {n}^2 float32 tile {LI_TILE}: B8 {b8_ms:.4f} ms per "
          f"{LI_G}-step call ({b8_ms / LI_G:.4f} ms a step) vs plain "
          f"{b8_plain_ms:.4f} ms (runs " + " ".join(f"{r:.4f}" for r in runs)
          + f"); bound {b8_bnd[0]:.4f} ms ({b8_bnd[1]}, {updates} updates of "
          f"{B1_OPS_CELL_STAGE['hlle'] + 2 * B8_OPS_FACE} operations); B10c "
          f"{v3_ms:.4f} ms (bound {v3_bnd[0]:.4f}, {v3_bnd[1]}); the strips' "
          f"build {strip_ms:.4f} ms a call on {smi}")
    del ub, strips
    print(f"phase 43: {time.perf_counter() - t0:.1f} s")
    return {"name": "iso2d_step_li (B8)", "route": "cuda",
            "source": "mara3_tpu_torch/csrc/iso2d_ladder.cu",
            "replaces": "mara3_tpu/kernels/iso2d_step_li.py:143",
            "launches": b8_launches, "max_abs_err": b8_err, "ms": b8_ms,
            "plain_ms": b8_plain_ms, "bound_ms": b8_bnd[0],
            "bound_by": b8_bnd[1], "library_ms": None}


def blast_totals(mesh, bs, u):
    """[5] totals of u (cast to float64 first, so the sum adds no
    rounding of its own) as numpy."""
    from mara3_tpu_torch.mesh import euler3d as TE
    return TE.total_conserved(mesh, bs, u.double()).cpu().numpy()


def blast_drift(t0, t1):
    """The totals' largest change over the larger of mass and energy
    (bench_blast3d.py: the momenta start at zero)."""
    import numpy as np
    return float(np.abs(t1 - t0).max() / max(abs(t0[0]), abs(t0[4])))


def blast3d_phases(device, smi):
    """Phases 44-46 (the blast3d subprogram, torch ops on the card)."""
    import numpy as np
    import torch
    from mara3_tpu_torch.mesh import euler3d as TE
    from mara3_tpu_torch.subprograms import blast3d as B3
    f64 = torch.float64
    cpu = torch.device("cpu")

    # ---- phase 44: blast3d, card against CPU -------------------------------
    t0 = time.perf_counter()
    (card, log, _, _, _, _), (host, hlog, *_) = [
        drive_amr(B3, BLAST_CPU_ARGS, dev, f64, quiet=True)
        for dev in (device, cpu)]
    lines = lambda text: re.findall(r"^\[(\d+)\] t=(\S+) ", text, re.M)
    check(lines(log) == lines(hlog) and len(lines(log)) == 2,
          f"blast3d windows differ: {lines(log)} on the card, {lines(hlog)} "
          f"on the CPU")
    a, b = card.solution.conserved.cpu(), host.solution.conserved
    check(allclose(a.numpy(), b.numpy(), **BLAST_RUN),
          "blast3d d3b8: the card's run differs from the CPU's")
    print(f"{' '.join(BLAST_CPU_ARGS)} float64: {card.solution.iteration} "
          f"steps in windows {[int(i) for i, _ in lines(log)]} on the card "
          f"match the CPU's (rtol {BLAST_RUN['rtol']}), max |du| "
          f"{float((a - b).abs().max()):.3e}")
    print(f"phase 44: {time.perf_counter() - t0:.1f} s")

    # ---- phase 45: the blast3d main path -----------------------------------
    t0 = time.perf_counter()
    argv = ["blast3d", f"depth={BLAST_DEPTH}", f"block_size={BLAST_BS}"]
    with contextlib.redirect_stdout(io.StringIO()):
        _, start = B3.setup(argv, device=device)
    tot0 = blast_totals(start.mesh, BLAST_BS, start.solution.conserved)
    final, log, wall, writes, _, _ = drive_amr(B3, argv, device)
    s = final.solution
    u = s.conserved
    check(tuple(u.shape) == (len(final.mesh.leaves),) + (BLAST_BS,) * 3
          + (5,) and u.dtype == torch.float32 and u.is_cuda,
          f"blast3d state {tuple(u.shape)} {u.dtype}")
    check(bool(torch.isfinite(u).all()), "non-finite blast3d")
    check(s.time >= 0.25 - 1e-12, f"blast3d ended at t = {s.time}")
    windows = [(int(m), float(k)) for k, m in re.findall(
        r"kzps=([0-9.]+) \[scheme\[(\d+)\]\]", log)]
    check(sum(m for m, _ in windows) == s.iteration,
          f"windows add up to {sum(m for m, _ in windows)}, not "
          f"{s.iteration}")
    defaults = B3.config_template().create()
    due = math.floor(defaults.get_double("tfinal")
                     / defaults.get_double("dfi") + 1e-9) + 1
    check(len(writes) == due and writes[0][0] == 0,
          f"diagnostics at {[it for it, _ in writes]}, not {due} from 0")
    drift = blast_drift(tot0, blast_totals(final.mesh, BLAST_BS, u))
    check(drift < BLAST_DRIFT, f"blast3d totals drift {drift:.3e}")
    zones = u.shape[0] * BLAST_BS ** 3
    print(f"blast3d main path depth={BLAST_DEPTH} block_size={BLAST_BS} "
          f"({u.shape[0]} blocks) float32: {s.iteration} steps to t = {s.time:.6f}, {wall:.4f} s "
          f"wall, the {len(writes)} diagnostics copies "
          f"{sum(w for _, w in writes):.4f} s of it; windows (steps, ms): "
          + ", ".join(f"({m}, {m * zones / k:.1f})" for m, k in windows)
          + f"; whole-run {s.iteration * zones / wall:.6e} zone-updates/s; "
          f"mass and energy drift {drift:.3e} on {smi}")
    print(f"phase 45: {time.perf_counter() - t0:.1f} s")

    # ---- phase 46: bench_blast3d.py's marginal rates -----------------------
    t0 = time.perf_counter()
    for depth in BLAST_BENCH_DEPTHS:
        cfg = B3.config_template().create().update(
            {"depth": depth, "block_size": BLAST_BS})
        mesh = B3.build_mesh(cfg)
        u = B3.new_solution(cfg, mesh, device=device).conserved
        dx_min = 2.0 / (1 << max(1, depth - 1)) / BLAST_BS
        dt = 0.1 * dx_min / float(TE.max_signal_speed(u, B3.GAMMA)) / 3.0
        advance = TE.make_advance(mesh, BLAST_BS, B3.GAMMA)
        zones = u.shape[0] * BLAST_BS ** 3
        zps, spread, _ = marginal_rate(lambda m: advance(u, dt, m), zones,
                                       *BLAST_MARGINAL, pairs=3)
        out = advance(u, dt, BLAST_MARGINAL[1])
        check(bool(torch.isfinite(out).all()), f"non-finite d{depth}b16")
        drift = blast_drift(blast_totals(mesh, BLAST_BS, u),
                            blast_totals(mesh, BLAST_BS, out))
        check(drift < BLAST_DRIFT, f"d{depth}b16 drift {drift:.3e}")
        c0 = time.perf_counter()
        advance(u, dt, 10)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - c0) * 1e2
        _, busy, launched = profile_table(lambda: advance(u, dt, 10), 1)
        print(f"blast3d_d{depth}b{BLAST_BS} ({u.shape[0]} blocks, float32): "
              f"marginal {BLAST_MARGINAL[0]} -> {BLAST_MARGINAL[1]} steps "
              f"{zps:.6e} zone-updates/s (median of 3, spread "
              f"{100 * spread:.1f}%); totals drift {drift:.3e} over "
              f"{BLAST_MARGINAL[1]} steps; a step {step_ms:.4f} ms wall, "
              f"{launched / 10:.0f} device kernels and "
              f"{busy / 10 / 1e3:.4f} ms of them "
              f"({100 * busy / 10 / 1e3 / step_ms:.1f}% busy) on {smi}")
    print(f"phase 46: {time.perf_counter() - t0:.1f} s")


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
    from mara3_tpu_torch.kernels import iso2d_step as T1
    from mara3_tpu_torch.subprograms import kh as KH
    from mara3_tpu_torch.kernels import sedov_step as T5
    from mara3_tpu_torch.kernels import srhd_recover as TREC
    from mara3_tpu_torch.subprograms import sedov as SD
    sources = ("binary_advance", "binary_multi", "iso2d_step", "sedov_step",
               "cloud_update", "amrsand_step", "sand3d_step",
               "binary_update", "binary_advance_strips", "iso2d_ladder")
    t0 = time.perf_counter()
    # the -Xptxas=-v reports of these, kept beside their libraries
    reported = ("binary_multi", "iso2d_step", "iso2d_ladder", "amrsand_step",
                "sedov_step")
    with contextlib.redirect_stdout(io.StringIO()), \
            ThreadPoolExecutor(len(sources)) as pool:
        list(pool.map(lambda s: _build.build(s, verbose=s in reported),
                      sources))
    for src in sources:
        _build.load(src)
    print(f"build: {', '.join(s + '.cu' for s in sources)} in "
          f"{time.perf_counter() - t0:.1f} s ("
          + ", ".join(_build.library_path(s).name for s in sources) + ")")
    logs = {}
    for s in reported:
        check(_build.ptxas_log_path(s).exists(),
              f"no -Xptxas=-v report of {s}.cu")
        logs[s] = _build.ptxas_log_path(s).read_text()
    for line in ptxas_summary(logs["binary_multi"]):
        print(f"ptxas {line}")
    from mara3_tpu_torch.kernels import iso2d_step_v4 as V4
    for src, mod in (("iso2d_step", T1), ("iso2d_ladder", V4)):
        marches = march_summary(logs[src])
        check(len(marches) == 4, f"{src}.cu's report lists "
              f"{len(marches)} march kernels, not 4")
        for line in marches:
            print(f"ptxas {src}.cu {line}")
        for dtype in (torch.float32, torch.float64):
            for riemann in ("hlle", "hllc"):
                info = mod.kernel_info(dtype, riemann)
                print(f"{src}.cu march_kernel {str(dtype)[6:]} {riemann}: "
                      f"{info['registers']} registers, "
                      f"{info['local_bytes']} B local, {info['static_smem']} "
                      f"B shared, {info['ctas_per_sm']} CTAs an SM "
                      f"({smi})")
    resident_phase2(logs, smi)

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
        again = TM.advance_k_cuda(*args_)
        torch.cuda.synchronize()
        check(torch.equal(got[0], again[0]) and torch.equal(got[1], again[1]),
              f"two B3 calls on the same input differ ({dtype})")
        b3_err, ulps = compare_multi(got, TM.advance_k_plain(*args_), dtype,
                                     16)
        print(f"B3 parity d6b96 k=16 rk2 {str(dtype)[6:]}: max |du| "
              f"{b3_err:.3e} ({ulps:.2f} ulps of its cell); two calls give "
              f"the same bits (state and rows)")
    del again
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
    split = kernel_split(kernel, 2)
    total = sum(us for us, _ in split.values())
    check(split["b3_sweep1"][1] == split["b3_sweep2"][1] == 32
          and split["b3_stage_end"][1] == 32,
          f"a 16-step RK2 call ran B3's kernels {split}, not 32 a stage "
          f"kernel")
    print("B3 kernels, one call of 16 RK2 steps at d6b96 float32 "
          "(torch.profiler, device time and launches per call): " + "; ".join(
              f"{name} {us / 1e3:.4f} ms in {n:.0f}"
              for name, (us, n) in split.items())
          + f"; {total / 1e3:.4f} ms of kernels on {smi}")
    for dtype in (torch.float32, torch.float64):
        info = TM.kernel_info(dtype)
        print(f"B3 kernels {str(dtype)[6:]} (cudaFuncGetAttributes, "
              f"occupancy calculator): " + "; ".join(
                  f"{name} {k['registers']} registers, {k['local_bytes']} B "
                  f"local, {k['static_smem'] + k['dynamic_smem']} B shared, "
                  f"{k['threads']} threads, {k['ctas_per_sm']} CTAs/SM"
                  for name, k in info.items()))
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

    # ---- phase 11: B1 against its plain version ---------------------------
    kh_cfg = KH.config_template().create().update({"N": KH_N})
    kh64 = KH.initial_conserved(kh_cfg, dtype=torch.float64)
    kh_kw = KH.advance_kwargs(kh_cfg, KH.fixed_timestep(kh_cfg, kh64))
    b1_kw = dict(cs2=kh_kw["cs2"], dtdx=kh_kw["dt"] / kh_kw["dx"],
                 dtdy=kh_kw["dt"] / kh_kw["dy"], theta=kh_kw["theta"])
    for dtype in (torch.float64, torch.float32):
        worst, cases = (0.0, 0.0), 0
        big = kh64.to(dtype).permute(2, 0, 1).contiguous().to(device)
        odd = seeded_iso2d(*B1_ODD_SHAPE, dtype, device)
        for riemann in ("hlle", "hllc"):
            for rk in (1, 2):
                kw = dict(b1_kw, rk_order=rk, riemann=riemann)
                for u, n in [(odd, k) for k in B1_ODD_STEPS] + [(big, 16)]:
                    got = T1.advance_n_cuda(u, n, **kw)
                    torch.cuda.synchronize()
                    e = b1_bar(got, T1.advance_n_plain(u, n, **kw), dtype)
                    worst = tuple(map(max, worst, e))
                    cases += 1
                    if u is big and (rk, riemann) == (1, "hlle"):
                        b1_err = e[0]
        print(f"B1 parity {str(dtype)[6:]}: {cases} cases pass ({{hlle, "
              f"hllc}} x {{rk1, rk2}} at {B1_ODD_SHAPE[0]}x"
              f"{B1_ODD_SHAPE[1]}, n in {B1_ODD_STEPS}, and {KH_N}^2 16 "
              f"steps), max |du| {worst[0]:.3e} ({worst[1]:.2f} ulps of its "
              f"cell)")
    del big, odd, got

    # ---- phase 12: kh, card against CPU ------------------------------------
    cfg256 = KH.config_template().create().update({"N": 256})
    u256 = KH.initial_conserved(cfg256, dtype=torch.float64)
    kw = dict(KH.advance_kwargs(cfg256, KH.fixed_timestep(cfg256, u256)),
              kernel=True)
    got = KH.advance_n(u256.to(device), 11, **kw)
    check(KH.LAST_PATH == "cuda_b1_rk1[11]", f"card ran {KH.LAST_PATH}")
    want = KH.advance_n(u256, 11, **kw)
    check(KH.LAST_PATH == "plain_b1_rk1[11]", f"CPU ran {KH.LAST_PATH}")
    check(allclose(got.cpu().numpy(), want.numpy(), **KH_CARD_CPU),
          "kh N=256: 11 steps on the card differ from the CPU")
    print(f"kh N=256 float64: 11 steps of B1 on the card match its plain "
          f"version on the CPU (rtol {KH_CARD_CPU['rtol']}), max |du| "
          f"{float((got.cpu() - want).abs().max()):.3e}")

    # ---- phase 13: the kh main path ----------------------------------------
    TK.advance_cuda.launches = TM.advance_k_cuda.launches = 0
    kh_argv = ["kh", f"N={KH_N}"]
    final, log, wall, samples, kh_b1 = drive_kh(
        KH, T1.advance_n_cuda, kh_argv, KH_STEPS, device)
    rates = check_kh(final, log, samples, kh_b1, KH_N, KH_STEPS,
                     "cuda_b1_rk1")
    check(TK.advance_cuda.launches == TM.advance_k_cuda.launches == 0,
          "kh launched B2 or B3")
    kh_rate = KH_STEPS * KH_N * KH_N / wall
    print(f"kh main path N={KH_N} rk1 hlle float32: {KH_STEPS} steps in "
          f"{kh_b1} B1 calls ({len(rates)} chunks), {wall:.4f} s wall, "
          f"{len(samples)} time-series samples, min density "
          f"{float(final.solution.conserved[..., 0].min()):.6e}; whole-run "
          f"{kh_rate:.6e} zone-updates/s ({kh_rate / 1e3:.2f} kzps); chunk "
          f"kzps median {statistics.median(rates):.2f} on {smi}")
    final, log, wall, samples, calls = drive_kh(
        KH, T1.advance_n_cuda, kh_argv + ["rk_order=2", "riemann=hllc"],
        KH_RK2_STEPS, device)
    rates = check_kh(final, log, samples, calls, KH_N, KH_RK2_STEPS,
                     "cuda_b1_rk2")
    kh2_rate = KH_RK2_STEPS * KH_N * KH_N / wall
    print(f"kh N={KH_N} rk2 hllc float32: {KH_RK2_STEPS} steps in {calls} "
          f"B1 calls, {wall:.4f} s wall; whole-run {kh2_rate:.6e} "
          f"zone-updates/s on {smi}")
    del final

    # ---- phase 14: the bench-shaped rate -----------------------------------
    ub = bench_state(KH_N, device)
    bench_kw = dict(cs2=0.1, dtdx=0.4, dtdy=0.4, theta=1.8)
    out = T1.advance_n_cuda(ub, 56, **bench_kw)
    check(bool(torch.isfinite(out).all()), "non-finite bench state")
    zps, spread, zrates = marginal_rate(
        lambda n: T1.advance_n_cuda(ub, n, **bench_kw), KH_N * KH_N, 56, 4056)
    print(f"bench-shaped rate (N={KH_N}, rk1 hlle float32, marginal 56 -> "
          f"4056 steps, median of 5): {zps:.6e} zone-updates/s, spread "
          f"{100 * spread:.1f}% (" + " ".join(f"{r:.4e}" for r in zrates)
          + f") on {smi}")
    del ub, out

    # ---- phase 15: B1 timing at 2048^2 float32 -----------------------------
    u = kh64.to(torch.float32).permute(2, 0, 1).contiguous().to(device)
    kw = dict(b1_kw, rk_order=1, riemann="hlle")
    b1_step_ms, b1_step_plain_ms, runs1 = in_turns(
        lambda: T1.advance_n_plain(u, 1, **kw),
        lambda: T1.advance_n_cuda(u, 1, **kw), 5, 50)
    b1_ms, b1_plain_ms, runs16 = in_turns(
        lambda: T1.advance_n_plain(u, 16, **kw),
        lambda: T1.advance_n_cuda(u, 16, **kw), 1, 10)
    b1_bnd = b1_bound(u, 16, 1, "hlle")
    b1 = {"kh": kh_rate, "kh2": kh2_rate, "bench": zps, "step_ms": b1_step_ms}
    step_bound = b1_bound(u, 1, 1, "hlle")
    print(f"time {KH_N}^2 float32 rk1 hlle: B1 {b1_step_ms:.4f} ms a step "
          f"(one-step call) vs plain {b1_step_plain_ms:.4f} ms (runs "
          + " ".join(f"{r:.4f}" for r in runs1) + f"); 16-step call "
          f"{b1_ms:.4f} ms vs plain {b1_plain_ms:.4f} ms (runs "
          + " ".join(f"{r:.4f}" for r in runs16) + f"); bound "
          f"{step_bound[0]:.4f} ms a step ({step_bound[1]}: also the floor "
          f"of a design that moves the state every step), {b1_bnd[0]:.4f} "
          f"ms per 16 steps ({b1_bnd[1]}); the earlier tile design "
          f"{B1_TILE_STEP_MS:.4f} ms a step, {B1_TILE_CALL16_MS:.4f} ms per "
          f"16 steps (PERF.md) on {smi}")
    if args.profile:
        kh_u = u.permute(1, 2, 0).contiguous()
        kh_adv = dict(kh_kw, kernel=True)
        KH.advance_n(kh_u, 64, **kh_adv)
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        KH.advance_n(kh_u, 64, **kh_adv)
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - c0) * 1e3
        table, busy, launched = profile_table(
            lambda: KH.advance_n(kh_u, 64, **kh_adv), 1)
        with open(args.profile, "a") as f:
            f.write(f"kh chunk of 64 steps at {KH_N}^2 float32 (B1 and the "
                    f"layout copies): {chunk_ms:.4f} ms wall, {busy:.1f} us "
                    f"of kernels in {launched:.0f} launches\n{table}\n")
        print(f"profile: kh 64-step chunk {chunk_ms:.4f} ms wall, kernels "
              f"{busy / 1e3:.4f} ms in {launched:.0f} launches "
              f"({100 * busy / 1e3 / chunk_ms:.1f}% busy)")

    # ---- phase 16: B5 against its plain version ---------------------------
    configs = [(system, rec, warm) for system in ("euler", "srhd")
               for rec in ("pcm", "plm", "weno5")
               for warm in ((True,) if system == "euler" else (True, False))]
    for dtype in (torch.float64, torch.float32):
        worst, cases, bits, runs = (0.0, 0.0), 0, 0, {}
        for system in ("euler", "srhd"):
            odd = seeded_sedov(SD, SEDOV_ODD_NR, system, dtype, device)
            big = seeded_sedov(SD, SEDOV_NR, system, dtype, device, seed=1)
            for system_, rec, warm in configs:
                if system_ != system:
                    continue
                kw = dict(reconstruct=rec, system=system, warm=warm)
                for (u, v, dt), n in ([(odd, k) for k in B5_ODD_STEPS]
                                      + [(big, 16)]):
                    want = T5.advance_n_plain(u, v, dt, n, **kw)
                    plan, _ = T5.plan_for(u, rec)
                    cases += 1
                    for design in T5.DESIGNS[not plan.resident:]:
                        got = T5.advance_n_cuda(u, v, dt, n, design=design,
                                                **kw)
                        torch.cuda.synchronize()
                        e = b5_bar(got, want, dtype, system)
                        check(torch.equal(got, want), f"B5 {design} {system} "
                              f"{rec} n={n} at {u.shape[0]} cells is not "
                              f"the plain version's bits")
                        worst = tuple(map(max, worst, e))
                        bits += 1
                        runs[design] = runs.get(design, 0) + 1
                        if u is big[0] and (system, rec, warm, design) == (
                                "srhd", "pcm", True, "resident"):
                            b5_err = e[0]
            del odd, big
        print(f"B5 parity {str(dtype)[6:]}: {cases} cases pass ({{euler, "
              f"srhd (warm, cold)}} x {{pcm, plm, weno5}} at "
              f"{2 * SEDOV_ODD_NR} cells, n in {B5_ODD_STEPS}, and "
              f"{2 * SEDOV_NR} cells 16 steps) in {bits} runs ("
              + ", ".join(f"{d} {k}" for d, k in runs.items())
              + f"), every run bit for bit the plain version's; max |du| "
              f"{worst[0]:.3e}")
    del got

    # ---- phase 17: sedov, card against CPU ---------------------------------
    cfg256 = SD.config_template().create().update({"nr": "256"})
    s256 = SD.new_solution(cfg256, dtype=torch.float64)
    dt256 = SD.grid_dt(s256.vertices)
    got = SD.advance_n(s256.conserved.to(device), s256.vertices.to(device),
                       dt256, False, 11, kernel=True)
    check(SD.LAST_PATH == "cuda_b5_srhd_pcm[11]", f"card ran {SD.LAST_PATH}")
    want = SD.advance_n(s256.conserved, s256.vertices, dt256, False, 11,
                        kernel=True)
    check(SD.LAST_PATH == "plain_b5_srhd_pcm[11]", f"CPU ran {SD.LAST_PATH}")
    check(allclose(got.cpu().numpy(), want.numpy(), **B5_F64["srhd"]),
          "sedov nr=256: 11 steps on the card differ from the CPU")
    print(f"sedov nr=256 srhd pcm float64: 11 steps of B5 on the card match "
          f"its plain version on the CPU (rtol {B5_F64['srhd']['rtol']}), "
          f"max |du| {float((got.cpu() - want).abs().max()):.3e}")

    # ---- phase 18: the sedov main path -------------------------------------
    sedov_final = {}
    for extra, steps, per_step in SEDOV_RUNS:
        TK.advance_cuda.launches = TM.advance_k_cuda.launches = 0
        T1.advance_n_cuda.launches = 0
        final, cfg, log, wall, rows, calls = drive_sedov(
            SD, T5, extra, steps, per_step, device)
        label, radii = check_sedov(SD, final, cfg, log, rows, calls, steps,
                                   per_step)
        check(TK.advance_cuda.launches == TM.advance_k_cuda.launches
              == T1.advance_n_cuda.launches == 0,
              "sedov launched B1, B2 or B3")
        if not extra:
            b5_launches = calls
        sedov_final[extra] = final.solution
        rate = final.solution.iteration * 2 * SEDOV_NR / wall
        print(f"sedov main path {' '.join(extra) or 'defaults'} ({label}, "
              f"float32): {final.solution.iteration} steps in {calls} B5 "
              f"calls (the {T5.advance_n_cuda.design} march), {wall:.4f} s "
              f"wall, {len(rows)} time-series rows, "
              f"shock radius {radii[0]:.6f} -> {radii[-1]:.6f}; whole-run "
              f"{rate:.6e} zone-updates/s on {smi}")
    del final

    # ---- phase 19: B5 timing at 524,288 cells float32 ----------------------
    b5_time = {}
    for system, extra in (("euler", ("newtonian=1",)), ("srhd", ())):
        s = sedov_final[extra]
        u, v = s.conserved, s.vertices
        dt = SD.grid_dt(v)
        kw = dict(reconstruct="pcm", system=system)
        cold, newton = b5_newton_per_cell_step(T5, TREC, u, v, dt, 128) \
            if system == "srhd" else (0.0, 0.0)
        step_ms, step_plain_ms, runs1 = in_turns(
            lambda: T5.advance_n_plain(u, v, dt, 1, **kw),
            lambda: T5.advance_n_cuda(u, v, dt, 1, **kw), 5, 50)
        call_ms, call_plain_ms, runs128 = in_turns(
            lambda: T5.advance_n_plain(u, v, dt, 128, **kw),
            lambda: T5.advance_n_cuda(u, v, dt, 128, **kw), 1, 10)
        check(T5.plan_for(u, "pcm")[0].resident, "B5 is not resident")
        stream_ms = min(time_ms(lambda: T5.advance_n_cuda(
            u, v, dt, 128, design="streaming", **kw), 10) for _ in range(2))
        bnd = b5_bound(u, v, 128, system, newton)
        step_bnd = b5_bound(u, v, 1, system, cold)
        b5_time[system] = (call_ms, call_plain_ms, bnd)
        print(f"time {2 * SEDOV_NR} cells float32 {system} pcm: B5 "
              f"{step_ms:.4f} ms a step (one-step call) vs plain "
              f"{step_plain_ms:.4f} ms (runs " + " ".join(
                  f"{r:.4f}" for r in runs1) + f"); 128-step call "
              f"{call_ms:.4f} ms ({call_ms / 128:.5f} ms a step; the "
              f"streaming march {stream_ms:.4f} ms) vs plain "
              f"{call_plain_ms:.4f} ms (runs " + " ".join(
                  f"{r:.4f}" for r in runs128) + f"); Newton updates a cell "
              f"{cold:.4f} in a cold step, {newton:.4f} a step over 128 "
              f"warm; bound {step_bnd[0]:.5f} ms a step "
              f"({step_bnd[1]}), {bnd[0]:.4f} ms per 128 steps ({bnd[1]}) "
              f"on {smi}")
    b5_ms, b5_plain_ms, b5_bnd = b5_time["srhd"]
    # the main path's other costs: a B5 step's floor (a 128-step call at
    # 1,000 cells, where the cells take no time), and a time-series row
    s = sedov_final[()]
    u_small, v_small, dt_small = seeded_sedov(SD, SEDOV_ODD_NR, "srhd",
                                              torch.float32, device)
    floor_ms = time_ms(lambda: T5.advance_n_cuda(
        u_small, v_small, dt_small, 128, system="srhd"), 10) / 128
    SD.compute_time_series_data(s, SD.srhd)
    r0 = time.perf_counter()
    for _ in range(3):
        SD.compute_time_series_data(s, SD.srhd)
    row_ms = (time.perf_counter() - r0) * 1e3 / 3
    print(f"sedov srhd pcm float32: a B5 step at {2 * SEDOV_ODD_NR} cells "
          f"{floor_ms:.5f} ms (128-step call); a time-series row at "
          f"{2 * SEDOV_NR} cells {row_ms:.4f} ms on {smi}")
    if args.profile:
        dt = SD.grid_dt(s.vertices)

        def chunk():
            SD.advance_n(s.conserved, s.vertices, dt, False, 128)

        chunk()
        torch.cuda.synchronize()
        c0 = time.perf_counter()
        chunk()
        torch.cuda.synchronize()
        chunk_ms = (time.perf_counter() - c0) * 1e3
        table, busy, launched = profile_table(chunk, 1)
        with open(args.profile, "a") as f:
            f.write(f"sedov chunk of 128 SRHD pcm steps at {2 * SEDOV_NR} "
                    f"cells float32 (B5 and its geometry): {chunk_ms:.4f} ms "
                    f"wall, {busy:.1f} us of kernels in {launched:.0f} "
                    f"launches\n{table}\n")
        print(f"profile: sedov 128-step chunk {chunk_ms:.4f} ms wall, kernels "
              f"{busy / 1e3:.4f} ms in {launched:.0f} launches "
              f"({100 * busy / 1e3 / chunk_ms:.1f}% busy)")

    b4 = cloud_phases(device, smi, args.profile)
    b67 = amr_phases(device, smi, args.profile)
    b11 = variant_phases(device, smi)
    ladder = ladder_phases(device, smi, b1)
    b8 = li_phases(device, smi)
    blast3d_phases(device, smi)

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
         "bound_by": b3_bound[1], "library_ms": None},
        {"name": "iso2d_step (B1)", "route": "cuda",
         "source": "mara3_tpu_torch/csrc/iso2d_step.cu",
         "replaces": "mara3_tpu/kernels/iso2d_step_v5.py:179",
         "launches": kh_b1, "max_abs_err": b1_err,
         "ms": b1_ms, "plain_ms": b1_plain_ms, "bound_ms": b1_bnd[0],
         "bound_by": b1_bnd[1], "library_ms": None},
        {"name": "sedov_step (B5)", "route": "cuda",
         "source": "mara3_tpu_torch/csrc/sedov_step.cu",
         "replaces": "mara3_tpu/kernels/sedov_step.py:250",
         "launches": b5_launches, "max_abs_err": b5_err,
         "ms": b5_ms, "plain_ms": b5_plain_ms, "bound_ms": b5_bnd[0],
         "bound_by": b5_bnd[1], "library_ms": None}, *b4, *b67,
        *b11, *ladder, b8]}))
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
