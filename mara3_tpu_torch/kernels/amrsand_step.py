"""Kernel B6: n first-order upwind steps of the amrsand quadtree advection
at v = (0.5, 0.5), as a CUDA kernel beside its plain PyTorch version.

Replaces mara3_tpu/kernels/amrsand_step.py:118 (advance_n_pallas), the
Pallas kernel the JAX package runs on a TPU for every chunk of the amrsand
subprogram. Per step, on the state u [B, bs, bs, 1] (one component):

- the lo-side guards of each axis (faces x-lo and y-lo: for v > 0 the
  upwind flux reads nothing else), from each neighbor's hi-side edge row
  and, for the fine case, its next-inner row:
  - same level: the edge row;
  - coarser neighbor: row `coarse_half * bs/2 + p // 2` of its edge
    (piecewise-constant prolongation of our half);
  - two finer neighbors: `a = 0.5 * (inner + edge)` per position, then
    `0.5 * a[q] + 0.5 * a[q + 1]` with `q = 2p mod bs`, from the first
    neighbor for p < bs/2 and the second after;
- the update `u - c * (2.0 * u - u_xm1 - u_ym1)`, evaluated left to right,
  with `c = (0.5 * dt) / dxb` per block, formed in the state's dtype.

That is the TPU kernel's arithmetic, which is not quite the scheme's
(subprograms/amrsand._advance: fluxes 0.5 u, their differences, then
`* dt / dxb`): the two agree at round-off. The TPU kernel picks among the
guard cases by multiplying each candidate by a 0/1 mask and summing; this
one selects. For finite states the bits are the same; where a candidate the
face does not use is not finite, the mask product gives NaN and the select
does not.

- `guard_tables` packs a tree's lo-face neighbor ids and cases and the
  per-block c, on the state's device: the only tables either version reads;
- `advance_n_plain` is the plain PyTorch version;
- `advance_n_cuda` is the kernel's wrapper (csrc/amrsand_step.cu: one
  thread a cell, one launch a step, all n issued by one C call on the
  current stream); `advance_n_cuda.launches` counts its calls that launch;
- `advance_n` takes the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor; it never falls back from one to the other.

Not ported, being TPU mechanisms: the one-hot [Bp, Bp] block-selection
matmuls and [bs, bs] column transforms, the padding of the block count to
8, the lane rolls and the VMEM residency. bs must be even (the coarse case
selects a half of the neighbor's edge).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from mara3_tpu_torch.core.ops import scalar_div

LO_FACES = (0, 2)     # x-lo and y-lo in the NeighborTable's face numbering


@dataclass(frozen=True)
class GuardTables:
    """faces [B, 2, 6] int32: (case, same, coarse, coarse_half, fine0,
    fine1) of the x-lo and y-lo faces; c [B] the courant factor
    (0.5 * dt) / dx of each block in the state's dtype."""
    faces: torch.Tensor
    c: torch.Tensor


def guard_tables(nt, dxb, dt: float) -> GuardTables:
    """The tables of a NeighborTable `nt` and per-block spacings `dxb` [B]
    (a tensor in the state's dtype, on its device) for steps of `dt`: c is
    formed as the TPU kernel forms it (amrsand_step.py:136), 0.5 * dt cast
    to the dtype, then divided by dxb."""
    faces = np.stack([nt.case, nt.same_id, nt.coarse_id, nt.coarse_half,
                      nt.fine_id[:, :, 0], nt.fine_id[:, :, 1]],
                     axis=2)[:, LO_FACES].astype(np.int32)
    return GuardTables(
        torch.as_tensor(np.ascontiguousarray(faces), device=dxb.device),
        scalar_div(0.5 * dt, dxb).contiguous())


def _check_args(u, tables: GuardTables, n: int):
    if u.dim() != 4 or u.shape[3] != 1 or u.shape[1] != u.shape[2]:
        raise ValueError(f"amrsand advance takes u [B, bs, bs, 1], not "
                         f"{tuple(u.shape)}")
    bs = u.shape[1]
    if bs < 2 or bs % 2:
        raise ValueError(f"amrsand advance takes an even block size >= 2, "
                         f"not {bs}")
    B = u.shape[0]
    if tuple(tables.faces.shape) != (B, 2, 6) or tuple(tables.c.shape) != (B,):
        raise ValueError(f"guard tables of {tables.faces.shape[0]} blocks "
                         f"for a state of {B}")
    if tables.faces.device != u.device or tables.c.device != u.device:
        raise ValueError(f"guard tables on {tables.faces.device}, u on "
                         f"{u.device}")
    if tables.c.dtype != u.dtype:
        raise ValueError(f"courant factors in {tables.c.dtype}, u in "
                         f"{u.dtype}")
    if n < 0:
        raise ValueError(f"amrsand advance takes n >= 0, not {n}")


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def _lo_guard(edge, inner, face):
    """[B, bs] lo-side guard row of every block, from every block's hi-side
    edge and inner rows [B, bs] along the face's axis and the face's table
    rows face [B, 6]."""
    B, bs = edge.shape
    half = bs // 2
    case, same, coarse, chalf, fine0, fine1 = face.long().unbind(1)
    p = torch.arange(bs, device=edge.device)
    g_same = edge[same]
    g_coarse = edge[coarse[:, None], chalf[:, None] * half + p // 2]
    nb = torch.where(p < half, fine0[:, None], fine1[:, None])
    q = (2 * p) % bs
    a_q = 0.5 * (inner[nb, q] + edge[nb, q])
    a_q1 = 0.5 * (inner[nb, q + 1] + edge[nb, q + 1])
    g_fine = 0.5 * a_q + 0.5 * a_q1
    case = case[:, None]
    return torch.where(case == 0, g_same,
                       torch.where(case == 1, g_coarse, g_fine))


def _step(u, faces, c):
    """One step of u [B, bs, bs]."""
    bs = u.shape[1]
    gx = _lo_guard(u[:, bs - 1, :], u[:, bs - 2, :], faces[:, 0])
    gy = _lo_guard(u[:, :, bs - 1], u[:, :, bs - 2], faces[:, 1])
    u_xm1 = torch.cat([gx[:, None, :], u[:, :-1, :]], dim=1)
    u_ym1 = torch.cat([gy[:, :, None], u[:, :, :-1]], dim=2)
    return u - c[:, None, None] * (2.0 * u - u_xm1 - u_ym1)


def advance_n_plain(u, tables: GuardTables, n: int):
    """n steps of u [B, bs, bs, 1]: what advance_n_pallas computes, as torch
    ops on u's device."""
    _check_args(u, tables, n)
    v = u[..., 0]
    for _ in range(n):
        v = _step(v, tables.faces, tables.c)
    return v[..., None] if n else u.clone()


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _library():
    """The built csrc/amrsand_step.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("amrsand_step")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b6_advance_n_f32, lib.b6_advance_n_f64):
            fn.argtypes = [_c_void_p] * 5 + [_c_int] * 3 + [_c_void_p]
            fn.restype = _c_int
        lib.b6_error_string.argtypes = [_c_int]
        lib.b6_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def advance_n_cuda(u, tables: GuardTables, n: int):
    """Kernel B6 on a contiguous float32 or float64 CUDA tensor u
    [B, bs, bs, 1] with its tables on the same card: a new tensor with n
    steps applied (u is not written). Raises if the kernel does not build or
    a launch fails."""
    _check_args(u, tables, n)
    if u.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"advance_n_cuda takes float32 or float64, not "
                         f"{u.dtype}")
    if u.device.type != "cuda":
        raise ValueError(f"advance_n_cuda takes a CUDA tensor, not one on "
                         f"{u.device}")
    if not (u.is_contiguous() and tables.faces.is_contiguous()
            and tables.c.is_contiguous()):
        raise ValueError("advance_n_cuda takes contiguous tensors")
    if u.numel() >= 2 ** 31:
        raise ValueError(f"advance_n_cuda indexes cells with 32-bit ints; "
                         f"{u.numel()} cells are too many")
    if n == 0:
        return u.clone()
    lib = _library()
    out = torch.empty_like(u)
    scratch = torch.empty_like(u)
    fn = lib.b6_advance_n_f32 if u.dtype == torch.float32 \
        else lib.b6_advance_n_f64
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = fn(u.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            tables.faces.data_ptr(), tables.c.data_ptr(), u.shape[0],
            u.shape[1], n, stream)
    if rc != 0:
        raise RuntimeError("amrsand_step kernel launch failed: "
                           + lib.b6_error_string(rc).decode())
    advance_n_cuda.launches += 1
    return out


advance_n_cuda.launches = 0


def advance_n(u, tables: GuardTables, n: int):
    """n steps of u [B, bs, bs, 1] in one call: the plain version for a CPU
    tensor, kernel B6 for a CUDA tensor."""
    if u.device.type == "cpu":
        return advance_n_plain(u, tables, n)
    if u.device.type == "cuda":
        return advance_n_cuda(u, tables, n)
    raise ValueError(f"no amrsand advance for a tensor on {u.device}")
