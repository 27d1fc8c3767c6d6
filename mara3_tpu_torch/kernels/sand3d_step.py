"""Kernel B7: n first-order upwind steps of the sand3d octree advection at
a velocity v > 0, as a CUDA kernel beside its plain PyTorch version.

Replaces mara3_tpu/kernels/sand3d_step.py:177 (advance_n_pallas), the
Pallas kernel the JAX package runs on a TPU for every chunk of the sand3d
subprogram. Per step, on the state u [B, bs, bs, bs] (x, y, z; z fastest):

- the three lo-side guard faces (for v > 0 the upwind flux reads nothing
  else), from each neighbor's hi face, over the face's tangential axes
  (t1, t2) in increasing order:
  - same level: a copy of the neighbor's face;
  - coarser neighbor: our (tq1, tq2) quarter of its face, prolonged
    piecewise constant: cell (tq1 * bs/2 + t1 // 2, tq2 * bs/2 + t2 // 2);
  - four finer neighbors: the 2x2 tangential mean of child
    k = b2 * 2 + b1's face (b1 = t1 // (bs/2), b2 = t2 // (bs/2)), summed
    as four 0.25-weighted terms in the order of the TPU kernel's R rows,
    (2i, 2j), (2i, 2j + 1), (2i + 1, 2j), (2i + 1, 2j + 1);
- `du = c0 * (u - xm1) + c1 * (u - ym1) + c2 * (u - zm1)`, then `u - du`,
  with `c[a, b] = v[a] * (dt / dxb[b])` formed in the state's dtype.

For v > 0 the conservative flux correction of mesh/amr3d.make_advance is
analytically a no-op (the TPU kernel's docstring, :30-37), so this matches
the scheme at round-off: the fine guard differs from amr3d's `mean` by the
order of its sum. The TPU kernel picks among the guard cases by masked
one-hot products; this one selects (the same bits for finite states).

- `guard_tables` packs a mesh's lo-face ids and cases and the courant
  factors, on the state's device;
- `advance_n_plain` is the plain PyTorch version;
- `advance_n_cuda` is the kernel's wrapper (csrc/sand3d_step.cu: one
  thread a cell, one launch a step, all n issued by one C call on the
  current stream); `advance_n_cuda.launches` counts its calls that launch;
- `advance_n` takes the plain version for a tensor on the CPU and the
  kernel for a CUDA tensor; it never falls back from one to the other.

Not ported, being TPU mechanisms: the transposed [bs^3, Bp] layout (blocks
on the lanes), the one-hot [Bp, Bp] gathers and [bs^2, bs^2] P and R
operators, the padding of the block count to 128 and the VMEM guard. The
state keeps its natural layout. bs must be even.
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from mara3_tpu_torch.core.ops import scalar_div


@dataclass(frozen=True)
class GuardTables:
    """faces [B, 3, 9] int32: (case, same, coarse, tq1, tq2, fine0..fine3)
    of the x-lo, y-lo and z-lo faces; c [3, B] the courant factors
    v[a] * dt / dx[b] in the state's dtype."""
    faces: torch.Tensor
    c: torch.Tensor


def guard_tables(mesh, dxb, v, dt: float) -> GuardTables:
    """The tables of a BlockMesh3D for spacings `dxb` [B] (a tensor in the
    state's dtype, on its device), velocity v and step dt: c is formed as
    the TPU kernel forms it (sand3d_step.py:194), v and dt cast to the
    dtype, dt / dxb, then v times that."""
    lo = (slice(None), slice(None), 0)
    faces = np.concatenate(
        [np.stack([mesh.case[lo], mesh.same_id[lo], mesh.coarse_id[lo],
                   mesh.tq1[lo], mesh.tq2[lo]], axis=2),
         mesh.fine_id[:, :, 0]], axis=2).astype(np.int32)
    vt = torch.as_tensor(np.asarray(v, dtype=np.float64)).to(
        device=dxb.device, dtype=dxb.dtype)
    return GuardTables(
        torch.as_tensor(np.ascontiguousarray(faces), device=dxb.device),
        (vt[:, None] * scalar_div(dt, dxb)[None, :]).contiguous())


def _check_args(u, tables: GuardTables, n: int):
    if u.dim() != 4 or not u.shape[1] == u.shape[2] == u.shape[3]:
        raise ValueError(f"sand3d advance takes u [B, bs, bs, bs], not "
                         f"{tuple(u.shape)}")
    bs = u.shape[1]
    if bs < 2 or bs % 2:
        raise ValueError(f"sand3d advance takes an even block size >= 2, "
                         f"not {bs}")
    B = u.shape[0]
    if tuple(tables.faces.shape) != (B, 3, 9) \
            or tuple(tables.c.shape) != (3, B):
        raise ValueError(f"guard tables of {tables.faces.shape[0]} blocks "
                         f"for a state of {B}")
    if tables.faces.device != u.device or tables.c.device != u.device:
        raise ValueError(f"guard tables on {tables.faces.device}, u on "
                         f"{u.device}")
    if tables.c.dtype != u.dtype:
        raise ValueError(f"courant factors in {tables.c.dtype}, u in "
                         f"{u.dtype}")
    if n < 0:
        raise ValueError(f"sand3d advance takes n >= 0, not {n}")


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def _lo_guard(F, face):
    """[B, bs, bs] lo-side guard face of every block, from every block's hi
    face F [B, bs, bs] (tangential axes t1, t2) and the face's table rows
    face [B, 9]."""
    bs = F.shape[1]
    h = bs // 2
    face = face.long()
    case, same, coarse, tq1, tq2 = face[:, :5].unbind(1)
    t = torch.arange(bs, device=F.device)
    g_same = F[same]
    g_coarse = F[coarse[:, None, None], (tq1[:, None] * h + t // 2)[:, :, None],
                 (tq2[:, None] * h + t // 2)[:, None, :]]
    # child k = b2 * 2 + b1 of the quarter (b1, b2) the cell lies in
    k = (t[None, :] // h) * 2 + (t[:, None] // h)        # [t1, t2]
    child = face[:, 5:][:, k]                            # [B, bs, bs]
    i2 = (2 * (t % h))[:, None]
    j2 = (2 * (t % h))[None, :]
    g_fine = (0.25 * F[child, i2, j2] + 0.25 * F[child, i2, j2 + 1]
              + 0.25 * F[child, i2 + 1, j2] + 0.25 * F[child, i2 + 1, j2 + 1])
    case = case[:, None, None]
    return torch.where(case == 0, g_same,
                       torch.where(case == 1, g_coarse, g_fine))


def _step(u, faces, c):
    """One step of u [B, bs, bs, bs]."""
    bs = u.shape[1]
    gx = _lo_guard(u[:, bs - 1], faces[:, 0])
    gy = _lo_guard(u[:, :, bs - 1], faces[:, 1])
    gz = _lo_guard(u[:, :, :, bs - 1], faces[:, 2])
    xm1 = torch.cat([gx[:, None], u[:, :-1]], dim=1)
    ym1 = torch.cat([gy[:, :, None], u[:, :, :-1]], dim=2)
    zm1 = torch.cat([gz[:, :, :, None], u[:, :, :, :-1]], dim=3)
    c0, c1, c2 = (c[a][:, None, None, None] for a in range(3))
    du = c0 * (u - xm1) + c1 * (u - ym1) + c2 * (u - zm1)
    return u - du


def advance_n_plain(u, tables: GuardTables, n: int):
    """n steps of u [B, bs, bs, bs]: what advance_n_pallas computes, as
    torch ops on u's device."""
    _check_args(u, tables, n)
    v = u
    for _ in range(n):
        v = _step(v, tables.faces, tables.c)
    return v if n else u.clone()


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int


def _library():
    """The built csrc/sand3d_step.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("sand3d_step")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b7_advance_n_f32, lib.b7_advance_n_f64):
            fn.argtypes = [_c_void_p] * 5 + [_c_int] * 3 + [_c_void_p]
            fn.restype = _c_int
        lib.b7_error_string.argtypes = [_c_int]
        lib.b7_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def advance_n_cuda(u, tables: GuardTables, n: int):
    """Kernel B7 on a contiguous float32 or float64 CUDA tensor u
    [B, bs, bs, bs] with its tables on the same card: a new tensor with n
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
    fn = lib.b7_advance_n_f32 if u.dtype == torch.float32 \
        else lib.b7_advance_n_f64
    stream = torch.cuda.current_stream(u.device).cuda_stream
    rc = fn(u.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            tables.faces.data_ptr(), tables.c.data_ptr(), u.shape[0],
            u.shape[1], n, stream)
    if rc != 0:
        raise RuntimeError("sand3d_step kernel launch failed: "
                           + lib.b7_error_string(rc).decode())
    advance_n_cuda.launches += 1
    return out


advance_n_cuda.launches = 0


def advance_n(u, tables: GuardTables, n: int):
    """n steps of u [B, bs, bs, bs] in one call: the plain version for a CPU
    tensor, kernel B7 for a CUDA tensor."""
    if u.device.type == "cpu":
        return advance_n_plain(u, tables, n)
    if u.device.type == "cuda":
        return advance_n_cuda(u, tables, n)
    raise ValueError(f"no sand3d advance for a tensor on {u.device}")
