"""Kernel B3: K complete flagship steps in one launch, as a CUDA kernel
beside its plain PyTorch version.

Replaces mara3_tpu/kernels/binary_multi.py::advance_k_pallas, the Pallas
kernel the JAX package runs on a TPU for every K steps of its default
driver loop (schemes/binary_step.make_multi_scan). Per
step it computes: the bodies from the orbital elements at the carried time
(the fixed-count Kepler solve), primitive recovery and the CFL minimum
(or the fixed dt), then per RK stage the guard exchange, kernel B2's
update (PLM, HLLE/HLLC + viscous fluxes, sources, totals) with the
coarse-fine flux correction and the fault flag; for rk_order 2 the second
stage at t + dt and the 1/2-1/2 average of the state and of the time; and
per stage the accretion work on each body and the orbital-element
perturbations, which move the carried elements once a stage starts after
begin_live_binary. One row of [16, 10] per stage carries the totals (the
work done among them), dt, the fault flag, the stage-start time and the
element rows, in float64: the ROW_* contract of the JAX kernel with its
128-lane padding dropped, the work done added as row 7 and the two
ejected totals moved to row 8. So the scan that runs the kernel only sums
rows (schemes/binary_step.make_multi_scan).

- `advance_k_plain` is the plain PyTorch version: K steps of the port's
  plain advance (kernels/binary_advance.advance_plain), the torch CFL
  reduce and the device two-body module (models/two_body_device.py),
  operation for operation what the kernel computes.
- `advance_k_cuda` is the kernel's wrapper (csrc/binary_multi.cu, one
  cooperative launch per K steps); `advance_k_cuda.launches` counts its
  launches.
- `advance_k` takes the plain version for a tensor on the CPU and the kernel
  for a CUDA tensor; it never falls back from one to the other.

Not ported, being TPU mechanisms: the scoped-VMEM estimate and guard, the
one-hot guard-exchange tables (here B2's indexed gather over the neighbor
table), the pad blocks, and the Mosaic atan2 workaround.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from mara3_tpu_torch.kernels import binary_advance as BA
from mara3_tpu_torch.models import two_body_device as tbd
from mara3_tpu_torch.schemes import binary_scheme

# rows of the per-stage [ROWS, LANES] output: rows 0-7 the per-body totals
# of binary_scheme.PAIR_TOTALS in lanes 0-1, row 8 mass_ejected (lane 0) and
# angular_momentum_ejected (lane 1)
ROW_EJECTED = 8
ROW_DT = 9
ROW_INVALID = 10
ROW_TPREV = 11      # stage-start time, exactly as the stage's hydro saw it
# element rows (lanes 0-9 hold the ten packed element components)
ROW_DACC = 12       # the stage's accretion perturbation diff(E, e_acc)
ROW_DGRV = 13       # the stage's gravitational perturbation diff(E, e_grv)
ROW_OE = 14         # the carried elements after the step (its last stage row)
ROW_OE_STAGE = 15   # the stage-start elements (what the stage's hydro saw)
ROWS, LANES = 16, 10


@dataclass(frozen=True)
class MultiConfig:
    """The scalars of one K-step launch besides the scheme's own."""
    k_steps: int
    rk_order: int                 # 1 or 2
    cfl: float
    theta: float                  # PLM theta; 0 for pcm
    fixed_dt: Optional[float]     # None: dt from the CFL reduce
    live_after: float             # begin_live_binary
    no_accretion_force: bool = False


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def _evolve(mc: MultiConfig, E, totals, bodies, t, dt):
    """The element update of one stage: (E_next, d_acc, d_grv)."""
    d_acc, d_grv = tbd.perturbations(
        E, bodies, totals["mass_accreted_on"],
        totals["momentum_x_accreted_on"], totals["momentum_y_accreted_on"],
        totals["integrated_force_x_on"], totals["integrated_force_y_on"], t,
        mc.no_accretion_force)
    live = (t > mc.live_after).to(E.dtype)
    return E + (d_acc + d_grv + tbd.diff_cm(E, dt)) * live, d_acc, d_grv


def _row(totals, dt, invalid, t, elements):
    """One stage's [ROWS, LANES] float64 row; `elements` maps an element
    row's index to its ten values."""
    row = torch.zeros(ROWS, LANES, dtype=torch.float64, device=dt.device)
    for q, key in enumerate(binary_scheme.PAIR_TOTALS):
        row[q, :2] = totals[key]
    row[ROW_EJECTED, 0] = totals["mass_ejected"]
    row[ROW_EJECTED, 1] = totals["angular_momentum_ejected"]
    row[ROW_DT, 0] = dt
    row[ROW_INVALID, 0] = invalid.to(torch.float64)
    row[ROW_TPREV, 0] = t
    for r, values in elements.items():
        row[r] = values
    return row


def advance_k_plain(t: BA.AdvanceTables, u, e10, t0, mc: MultiConfig):
    """K steps of the plain flagship step: (u_out, rows [K * rk, ROWS,
    LANES] float64). u [B, bs, bs, 3]; e10 [10] and t0 (0-d) in u's dtype,
    on its device."""
    time, E = t0, e10
    rows = []

    def stage(u_, E_, time_, dt):
        bodies = tbd.compute_two_body_state(E_, time_)
        u1, totals, invalid = BA.advance_plain(t, u_, bodies, dt, mc.theta)
        E1, da, dg = _evolve(mc, E_, totals, bodies, time_, dt)
        return u1, totals, invalid, E1, da, dg

    for _ in range(mc.k_steps):
        if mc.fixed_dt is not None:
            dt = torch.full((), mc.fixed_dt, dtype=u.dtype, device=u.device)
        else:
            bodies = tbd.compute_two_body_state(E, time)
            dt = mc.cfl * binary_scheme.maximum_timestep(
                t.cfg, t.xc, t.spacing, u, bodies)
        u1, tot1, inv1, E1, da1, dg1 = stage(u, E, time, dt)
        if mc.rk_order == 1:
            rows.append(_row(tot1, dt, inv1, time, {
                ROW_DACC: da1, ROW_DGRV: dg1, ROW_OE: E1, ROW_OE_STAGE: E}))
            u, time, E = u1, time + dt, E1
            continue
        t2 = time + dt
        u2, tot2, inv2, E2, da2, dg2 = stage(u1, E1, t2, dt)
        E_avg = 0.5 * E + 0.5 * E2
        rows.append(_row(tot1, dt, inv1, time, {
            ROW_DACC: da1, ROW_DGRV: dg1, ROW_OE_STAGE: E}))
        rows.append(_row(tot2, dt, inv2, t2, {
            ROW_DACC: da2, ROW_DGRV: dg2, ROW_OE: E_avg, ROW_OE_STAGE: E1}))
        u = 0.5 * u + 0.5 * u2
        time = 0.5 * time + 0.5 * (t2 + dt)
        E = E_avg
    return u, torch.stack(rows)


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _library():
    """The built csrc/binary_multi.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("binary_multi")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b3_advance_k_f32, lib.b3_advance_k_f64):
            fn.argtypes = ([_c_void_p] * 17 + [_c_int] * 6
                           + [_c_void_p, _c_int, _c_void_p, _c_void_p])
            fn.restype = _c_int
        lib.b3_num_tiles.argtypes = [_c_int, _c_int]
        lib.b3_num_tiles.restype = _c_int
        lib.b3_grid_size.argtypes = [_c_int]
        lib.b3_grid_size.restype = _c_int
        lib.b3_error_string.argtypes = [_c_int]
        lib.b3_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def grid_size(dtype) -> int:
    """CTAs of the cooperative launch for `dtype` on the current card (all
    co-resident: occupancy per SM times the SM count); raises if none
    fits."""
    lib = _library()
    n = lib.b3_grid_size(int(dtype == torch.float64))
    if n <= 0:
        raise RuntimeError("binary_multi kernel cannot be launched "
                           "cooperatively: " + lib.b3_error_string(-n).decode())
    return n


def advance_k_cuda(t: BA.AdvanceTables, u, e10, t0, mc: MultiConfig):
    """Kernel B3 on a CUDA tensor: (u_out, rows), with the meaning of
    advance_k_plain. Raises if the kernel does not build or its launch
    fails."""
    BA._check(t, u, "advance_k_cuda")
    if mc.rk_order not in (1, 2):
        raise ValueError(f"advance_k_cuda takes rk_order 1 or 2, "
                         f"not {mc.rk_order}")
    B, bs = t.xc.shape[0], t.xc.shape[1]
    lib = _library()
    empty = lambda *shape, dtype=t.dtype: torch.empty(shape, dtype=dtype,
                                                      device=u.device)
    out = u.clone()
    s1 = empty(B, bs, bs, 3) if mc.rk_order == 2 else out
    p = empty(B, bs, bs, 3)
    g = empty(B, bs, bs, 6)
    fx = empty(B, bs + 1, bs, 3)
    fy = empty(B, bs, bs + 1, 3)
    tiles = lib.b3_num_tiles(B, bs)
    partials = empty(tiles, BA.NUM_TOTALS, dtype=torch.float64)
    totals = empty(BA.NUM_TOTALS, dtype=torch.float64)
    cfl_part = empty(tiles, dtype=torch.float64)
    start = torch.cat([t0.reshape(1), e10.reshape(10)]).to(torch.float64)
    dyn = empty(12, dtype=torch.float64)
    rows = torch.zeros(mc.k_steps * mc.rk_order, ROWS, LANES,
                       dtype=torch.float64, device=u.device)
    hparams, flags = BA.kernel_params(t.cfg, np.zeros((2, 5)), 0.0, mc.theta)
    mparams = np.array([mc.cfl, mc.fixed_dt or 0.0, mc.live_after],
                       np.float64)
    fn = lib.b3_advance_k_f32 if t.dtype == torch.float32 \
        else lib.b3_advance_k_f64
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = fn(out.data_ptr(), s1.data_ptr(), p.data_ptr(), g.data_ptr(),
            fx.data_ptr(), fy.data_ptr(), t.initial_conserved.data_ptr(),
            t.buffer_rate.data_ptr(), t.tab.data_ptr(), t.axes.data_ptr(),
            t.spacing64.data_ptr(), partials.data_ptr(), totals.data_ptr(),
            cfl_part.data_ptr(),
            start.data_ptr(), dyn.data_ptr(), rows.data_ptr(), B, bs,
            mc.k_steps, mc.rk_order, int(mc.no_accretion_force),
            int(mc.fixed_dt is not None), hparams.ctypes.data, flags,
            mparams.ctypes.data, stream)
    if rc != 0:
        raise RuntimeError("binary_multi kernel launch failed: "
                           + lib.b3_error_string(rc).decode())
    advance_k_cuda.launches += 1
    return out, rows


advance_k_cuda.launches = 0


def advance_k(t: BA.AdvanceTables, u, e10, t0, mc: MultiConfig):
    """K steps in one call: the plain version for a CPU tensor, kernel B3
    for a CUDA tensor."""
    if u.device.type == "cpu":
        return advance_k_plain(t, u, e10, t0, mc)
    if u.device.type == "cuda":
        return advance_k_cuda(t, u, e10, t0, mc)
    raise ValueError(f"no multi-step advance for a tensor on {u.device}")
