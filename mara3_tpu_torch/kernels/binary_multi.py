"""Kernel B3: K complete flagship steps in one call, as CUDA kernels
beside their plain PyTorch version.

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
- `advance_k_cuda` is the kernel's wrapper (csrc/binary_multi.cu: one C
  call per K steps, which issues each stage's sweeps and small scalar
  kernels on the current stream, with no host read between steps);
  `advance_k_cuda.launches` counts its calls. `tile_plan` builds the
  host-side geometry it reads as tables: sweep 1's tiles of each block,
  sweep 2's pieces (tiles of at most MARCH_ROWS rows, which the CTAs of
  one wave claim in turn), the source cells of each guard cell and the
  finer neighbors' faces at each level jump.
- `advance_k` takes the plain version for a tensor on the CPU and the kernel
  for a CUDA tensor; it never falls back from one to the other.

Not ported, being TPU mechanisms: the scoped-VMEM estimate and guard, the
one-hot guard-exchange tables (here indexed gathers over the ring table
of `tile_plan`), the pad blocks, and the Mosaic atan2 workaround.
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
# the tile plan: the host-side geometry of the CUDA kernel
# -----------------------------------------------------------------------------

# sweep 1's tile (csrc/binary_multi.cu Tile<T>): rows along i by columns
# along j, the state's fastest index; clipped at the block's edges
TILE = {torch.float32: (32, 32), torch.float64: (16, 32)}
# sweep 2's pieces (csrc/binary_multi.cu kMarchRows): tiles of at most
# MARCH_ROWS rows of a block's strip of 32 columns, in either dtype
MARCH_ROWS = 15


@dataclass(frozen=True)
class TilePlan:
    """The tables kernel B3 reads in place of the neighbor table (int32
    tensors on the neighbor table's device)."""
    tiles: torch.Tensor   # [T, 5] (block, i0, j0, ni, nj), sweep 1's
    ring: torch.Tensor    # [B, 4, bs, 4] source cells of each guard cell
    fine: torch.Tensor    # [B, 4, bs, 2] finer neighbor's faces, or -1
    pieces: torch.Tensor  # [P, 5] as tiles, sweep 2's


def block_tiles(B: int, bs: int, tile, device="cpu") -> torch.Tensor:
    """[T, 5] int32 (block, i0, j0, ni, nj): each block cut into tiles of
    tile = (ti, tj) cells, those at its upper edges clipped, block by block
    and row by row."""
    ti, tj = tile
    ar = lambda *a: torch.arange(*a, dtype=torch.int32, device=device)
    b, i0, j0 = torch.meshgrid(ar(B), ar(0, bs, ti), ar(0, bs, tj),
                               indexing="ij")
    return torch.stack([b, i0, j0, (bs - i0).clamp(max=ti),
                        (bs - j0).clamp(max=tj)], dim=-1).reshape(-1, 5)


def _faces(tab, bs):
    """Broadcast helpers over [B, 4 faces, bs positions]: the rows of the
    packed table and each face's axis, side and position."""
    col = lambda k: tab[:, :, k, None]
    f = torch.arange(4, dtype=torch.int32, device=tab.device)[None, :, None]
    p = torch.arange(bs, dtype=torch.int32, device=tab.device)[None, None]
    return col, f >> 1, f & 1, p


def ring_sources(tab, bs: int) -> torch.Tensor:
    """[B, 4, bs, 4] int32: the flat cells (b * bs + i) * bs + j from which
    the guard cell outside face f of block b at position p is formed: the
    one cell of a same-level neighbor (a copy) or of a coarser one (the
    matching half-cell), the rest -1; or the four cells of two finer ones
    (the 2x2 mean), in block_layout.build_guard_gather's order. `tab` is
    block_layout.pack_neighbor_table's [B, 4, 6], as it is or as a tensor
    on any device."""
    tab = torch.as_tensor(tab)
    col, axis, side, p = _faces(tab, bs)
    case = col(0)
    cell = lambda nb, e, q: torch.where(axis == 0, (nb * bs + e) * bs + q,
                                        (nb * bs + q) * bs + e)
    nb = torch.where(case == 0, col(1), col(2))
    q = torch.where(case == 0, p, col(3) * (bs // 2) + p // 2)
    one = cell(nb, torch.where(side == 0, bs - 1, 0), q)
    nbf = torch.where(p < bs // 2, col(4), col(5))
    qf = (2 * p) % bs
    e0 = torch.where(side == 0, bs - 2, 1)
    e1 = torch.where(side == 0, bs - 1, 0)
    four = torch.stack([cell(nbf, e0, qf), cell(nbf, e0, qf + 1),
                        cell(nbf, e1, qf), cell(nbf, e1, qf + 1)], dim=-1)
    none = torch.full_like(one, -1)
    single = torch.stack([one, none, none, none], dim=-1)
    return torch.where((case == 2)[..., None], four, single)


def fine_faces(tab, bs: int) -> torch.Tensor:
    """[B, 4, bs, 2] int32: where two finer neighbors meet face f of block
    b, the flat indices of the two finer faces whose fluxes sum to the
    flux at position p (restricted_flux; schemes/binary_scheme.
    correct_coarse_fine_fluxes), in a block's x-faces [bs+1, bs] (faces 0,
    1) or y-faces [bs, bs+1] (faces 2, 3); -1 elsewhere."""
    tab = torch.as_tensor(tab)
    col, axis, side, p = _faces(tab, bs)
    nb = torch.where(p < bs // 2, col(4), col(5))
    q = (2 * p) % bs
    e = torch.where(side == 0, bs, 0)
    face = lambda q_: torch.where(axis == 0, (nb * (bs + 1) + e) * bs + q_,
                                  (nb * bs + q_) * (bs + 1) + e)
    pair = torch.stack([face(q), face(q + 1)], dim=-1)
    return torch.where((col(0) == 2)[..., None], pair, -1)


def march_pieces(tab, bs: int, rows: int) -> torch.Tensor:
    """[P, 5] int32 (block, i0, j0, ni, nj): sweep 2's pieces, the tiles of
    `rows` rows of each block's 32-column strips, in the order its CTAs
    claim them: the costliest first, so that the last pieces, which set
    the kernel's end, are the cheapest. A piece's cost is its rows, then
    its faces on block edges where finer neighbours meet it (each two
    faces recomputed from device memory)."""
    tab = torch.as_tensor(tab)
    t = block_tiles(tab.shape[0], bs, (rows, 32), tab.device).long()
    b, i0, j0, ni, nj = t.unbind(-1)
    fine = tab[b, :, 0] == 2                               # [P, 4]
    on = torch.stack([i0 == 0, i0 + ni == bs, j0 == 0, j0 + nj == bs], -1)
    cost = ((fine & on).long() * torch.stack([nj, nj, ni, ni], -1)).sum(-1)
    order = torch.argsort(ni * 4 * bs + cost, descending=True, stable=True)
    return t[order].to(torch.int32)


def tile_plan(tab, bs: int, tile) -> TilePlan:
    """The tables of one mesh for sweep 1's tile = (ti, tj) and sweep 2's
    pieces, built with torch ops on the device of `tab` (a tensor or an
    array)."""
    tab = torch.as_tensor(tab)
    plan = (block_tiles(tab.shape[0], bs, tile, tab.device),
            ring_sources(tab, bs), fine_faces(tab, bs),
            march_pieces(tab, bs, MARCH_ROWS))
    return TilePlan(*(a.to(torch.int32).contiguous() for a in plan))


def march_ctas(pieces: int, sms: int, ctas_per_sm: int) -> int:
    """Sweep 2's CTAs: as many as the card holds at once, one wave, or one
    a piece where there are fewer pieces."""
    return max(1, min(pieces, sms * ctas_per_sm))


_plans: list = []    # (tables, tile plan, sweep 2's CTAs) of the latest meshes


def _device_plan(t: BA.AdvanceTables):
    """(tile plan, sweep 2's CTAs) of t's mesh on t's device and card,
    built once a mesh (a regrid that changes the tree makes new tables)."""
    for tables, plan, ctas in _plans:
        if tables is t:
            return plan, ctas
    plan = tile_plan(t.tab, t.xc.shape[1], TILE[t.dtype])
    sms = torch.cuda.get_device_properties(t.xc.device).multi_processor_count
    per_sm = kernel_info(t.dtype)["b3_sweep2"]["ctas_per_sm"]
    ctas = march_ctas(plan.pieces.shape[0], sms, per_sm)
    _plans.append((t, plan, ctas))
    del _plans[:-4]
    return plan, ctas


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
# b3_kernel_info's kernels, in its order
KERNELS = ("b3_sweep1", "b3_sweep2", "b3_dt", "b3_stage_end", "b3_init")
CARRY = 22


def _library():
    """The built csrc/binary_multi.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("binary_multi")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b3_advance_k_f32, lib.b3_advance_k_f64):
            fn.argtypes = ([_c_void_p] * 20 + [_c_int] * 11
                           + [_c_void_p, _c_int, _c_void_p, _c_void_p])
            fn.restype = _c_int
        lib.b3_kernel_info.argtypes = [_c_int, _c_int, _c_void_p]
        lib.b3_kernel_info.restype = _c_int
        lib.b3_error_string.argtypes = [_c_int]
        lib.b3_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def kernel_info(dtype) -> dict:
    """Each B3 kernel's resources on the current card for `dtype`: name ->
    dict of registers (a thread), local_bytes (a thread: stack and spills),
    static_smem and dynamic_smem (bytes a CTA), threads (a CTA) and
    ctas_per_sm (the occupancy calculator's)."""
    lib = _library()
    keys = ("registers", "local_bytes", "static_smem", "dynamic_smem",
            "threads", "ctas_per_sm")
    info = {}
    for which, name in enumerate(KERNELS):
        out = (ctypes.c_int * len(keys))()
        rc = lib.b3_kernel_info(int(dtype == torch.float64), which, out)
        if rc != 0:
            raise RuntimeError(f"{name}: " + lib.b3_error_string(rc).decode())
        info[name] = dict(zip(keys, out))
    return info


def advance_k_cuda(t: BA.AdvanceTables, u, e10, t0, mc: MultiConfig):
    """Kernel B3 on a CUDA tensor: (u_out, rows), with the meaning of
    advance_k_plain. Raises if the kernel does not build or a launch
    fails."""
    BA._check(t, u, "advance_k_cuda")
    if mc.rk_order not in (1, 2):
        raise ValueError(f"advance_k_cuda takes rk_order 1 or 2, "
                         f"not {mc.rk_order}")
    B, bs = t.xc.shape[0], t.xc.shape[1]
    lib = _library()
    plan, ctas = _device_plan(t)
    tiles, ring, fine, pieces = plan.tiles, plan.ring, plan.fine, plan.pieces
    empty = lambda *shape, dtype=t.dtype: torch.empty(shape, dtype=dtype,
                                                      device=u.device)
    out = u.clone()
    s1 = empty(B, bs, bs, 3) if mc.rk_order == 2 else out
    p = empty(B, bs, bs, 3)
    g = empty(B, bs, bs, 6)
    partials = empty(BA.NUM_TOTALS, pieces.shape[0], dtype=torch.float64)
    work = empty(mc.k_steps * mc.rk_order, dtype=torch.int32)
    totals = empty(BA.NUM_TOTALS, dtype=torch.float64)
    cfl_part = empty(tiles.shape[0], dtype=torch.float64)
    start = torch.cat([t0.reshape(1), e10.reshape(10)]).to(torch.float64)
    dyn = torch.zeros(12, dtype=torch.float64, device=u.device)
    carry = torch.zeros(CARRY, dtype=torch.float64, device=u.device)
    rows = torch.zeros(mc.k_steps * mc.rk_order, ROWS, LANES,
                       dtype=torch.float64, device=u.device)
    hparams, flags = BA.kernel_params(t.cfg, np.zeros((2, 5)), 0.0, mc.theta)
    mparams = np.array([mc.cfl, mc.fixed_dt or 0.0, mc.live_after],
                       np.float64)
    fn = lib.b3_advance_k_f32 if t.dtype == torch.float32 \
        else lib.b3_advance_k_f64
    ti, tj = TILE[t.dtype]
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = fn(out.data_ptr(), s1.data_ptr(), p.data_ptr(), g.data_ptr(),
            t.initial_conserved.data_ptr(), t.buffer_rate.data_ptr(),
            t.axes.data_ptr(), t.spacing64.data_ptr(), tiles.data_ptr(),
            ring.data_ptr(), fine.data_ptr(), pieces.data_ptr(),
            work.data_ptr(), partials.data_ptr(), totals.data_ptr(),
            cfl_part.data_ptr(), start.data_ptr(), dyn.data_ptr(),
            carry.data_ptr(), rows.data_ptr(), B, bs, tiles.shape[0],
            pieces.shape[0], ctas, ti, tj, mc.k_steps, mc.rk_order,
            int(mc.no_accretion_force), int(mc.fixed_dt is not None),
            hparams.ctypes.data, flags, mparams.ctypes.data, stream)
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
