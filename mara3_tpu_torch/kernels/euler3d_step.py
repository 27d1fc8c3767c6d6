"""Kernel B12: n steps of blast3d's octree Euler scheme (first-order HLLE,
forward Euler, exactly conservative level jumps), as one CUDA launch a step
beside its plain PyTorch version.

It replaces no TPU kernel: the JAX package runs this step as jnp operations
(mara3_tpu/mesh/euler3d.py). On the card the plain version is about 800
small torch kernels a step, each enqueued by the host, so the host paced the
step; the kernel is one launch a step. Per step, on the conserved state
U [B, bs, bs, bs, 5]:

- each cell's primitives (physics/euler.py's recover_primitive);
- per axis, the HLLE flux at each block's n + 1 faces, the outer state of a
  block's boundary face from the face's neighbours (mesh/amr3d.py: the
  same-level neighbour's face cell, or the coarser neighbour's cell,
  prolonged piecewise constant); at a face whose neighbours are finer, the
  2 x 2 mean of the fine side's fluxes (amr3d.correct_fluxes);
- dU summed over the axes in x, y, z order, then U - (dt inv_dx) dU.

- `face_tables` packs a mesh's per-face cases and neighbour ids;
- `advance_n_plain` is the plain version: mesh/euler3d.py's step as it was,
  torch ops on U's device, with its `mara3.step`, `mara3.guard` and
  `mara3.correct` spans;
- `advance_n_cuda` is the kernel's wrapper (csrc/octree_euler_step.cu: one
  launch a step, all n issued by one C call on the current stream);
  `advance_n_cuda.launches` counts its kernel launches, and under
  torch.profiler each call counts its n steps as `octree_kernel_steps`;
- `advance_n` takes the plain version for a tensor on the CPU and the kernel
  for a CUDA tensor; it never falls back from one to the other. `LAST_PATH`
  names what its last call ran: `cuda_b12[n]` or `scheme[n]`.

The kernel takes float32 and float64, any B and any even bs.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from mara3_tpu_torch.app import tracing
from mara3_tpu_torch.core.ops import scalar_div
from mara3_tpu_torch.mesh import amr3d
from mara3_tpu_torch.mesh.euler3d import _spacings
from mara3_tpu_torch.physics import euler, on_axis

LAST_PATH = "unset"   # what the last advance_n ran, e.g. cuda_b12[450]


def face_tables(mesh) -> torch.Tensor:
    """[B, 3, 2, 9] int32 on the host: for each block, axis and side the
    face's (case, same, coarse, tq1, tq2, fine0..fine3), as BlockMesh3D
    holds them."""
    faces = np.concatenate(
        [np.stack([mesh.case, mesh.same_id, mesh.coarse_id, mesh.tq1,
                   mesh.tq2], axis=3), mesh.fine_id], axis=3)
    return torch.as_tensor(np.ascontiguousarray(faces, dtype=np.int32))


def _device_tables(mesh, U, domain_size):
    """(faces, inv_dx) on U's device, inv_dx in its dtype as the plain
    version forms it; made once per mesh, device, dtype, block size and
    domain and kept on the mesh, since a copy from host memory waits for
    the device's queue."""
    tables = mesh.__dict__.setdefault("_b12_tables", {})
    key = (U.device, U.dtype, U.shape[1], domain_size)
    if key not in tables:
        inv_dx = scalar_div(1.0, _spacings(mesh, U.shape[1], domain_size, U))
        tables[key] = (face_tables(mesh).to(U.device), inv_dx.contiguous())
    return tables[key]


def _check_args(U, n: int):
    if U.dim() != 5 or U.shape[4] != 5 \
            or not U.shape[1] == U.shape[2] == U.shape[3]:
        raise ValueError(f"the octree Euler step takes U [B, bs, bs, bs, 5], "
                         f"not {tuple(U.shape)}")
    bs = U.shape[1]
    if bs < 2 or bs % 2:
        raise ValueError(f"the octree Euler step takes an even block size "
                         f">= 2, not {bs}")
    if n < 0:
        raise ValueError(f"the octree Euler step takes n >= 0, not {n}")


# -----------------------------------------------------------------------------
# the plain version
# -----------------------------------------------------------------------------

def advance_n_plain(U, mesh, dt: float, n: int, gamma_law_index=5.0 / 3.0,
                    domain_size=2.0):
    """n steps of U [B, bs, bs, bs, 5] on `mesh`, as torch ops on U's device
    and dtype; U is not written."""
    _check_args(U, n)
    g = gamma_law_index
    rec = tracing.recorder()

    def face_flux(P, axis):
        """[B, ..., n + 1 faces along axis, ..., 5] HLLE per-area fluxes,
        the two guard faces included, then the level-jump correction."""
        bs = P.shape[1]
        with rec.span("mara3.guard"):
            lo = amr3d._guard(P, mesh, axis, 0).unsqueeze(axis + 1)
            hi = amr3d._guard(P, mesh, axis, 1).unsqueeze(axis + 1)
        Pe = torch.cat([lo, P, hi], dim=axis + 1)
        F = euler.riemann_hlle(Pe.narrow(axis + 1, 0, bs + 1),
                               Pe.narrow(axis + 1, 1, bs + 1), on_axis(axis),
                               g)
        with rec.span("mara3.correct"):
            return amr3d.correct_fluxes(F, axis, mesh)

    inv_dx = scalar_div(1.0, _spacings(mesh, U.shape[1], domain_size, U))[
        :, None, None, None, None]
    dt_ = torch.full((), dt, dtype=U.dtype, device=U.device)
    bs = U.shape[1]
    V = U
    for _ in range(n):
        with rec.span("mara3.step"):
            P = euler.recover_primitive(V, g)
            dU = 0.0
            for axis in range(3):
                F = face_flux(P, axis)
                dU = dU + (F.narrow(axis + 1, 1, bs)
                           - F.narrow(axis + 1, 0, bs))
            V = V - dt_ * inv_dx * dU
    return V if n else U.clone()


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
_c_double = ctypes.c_double


def _library():
    """The built csrc/octree_euler_step.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("octree_euler_step")
    if not getattr(lib, "_mara_typed", False):
        for fn in (lib.b12_advance_n_f32, lib.b12_advance_n_f64):
            fn.argtypes = ([_c_void_p] * 5 + [_c_double] * 2 + [_c_int] * 3
                           + [_c_void_p])
            fn.restype = _c_int
        lib.b12_error_string.argtypes = [_c_int]
        lib.b12_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def advance_n_cuda(U, faces, inv_dx, dt: float, n: int,
                   gamma_law_index=5.0 / 3.0):
    """Kernel B12 on a contiguous float32 or float64 CUDA tensor U
    [B, bs, bs, bs, 5], with the mesh's face table `faces` [B, 3, 2, 9]
    int32 and the inverse cell sizes `inv_dx` [B] in U's dtype, both on
    U's card: a new tensor with n steps applied (U is not written). Raises
    if the kernel does not build or a launch fails."""
    _check_args(U, n)
    B = U.shape[0]
    if U.dtype not in (torch.float32, torch.float64):
        raise ValueError(f"advance_n_cuda takes float32 or float64, not "
                         f"{U.dtype}")
    if tuple(faces.shape) != (B, 3, 2, 9) or faces.dtype != torch.int32:
        raise ValueError(f"a face table [{B}, 3, 2, 9] int32 for a state of "
                         f"{B} blocks, not {tuple(faces.shape)} "
                         f"{faces.dtype}")
    if tuple(inv_dx.shape) != (B,) or inv_dx.dtype != U.dtype:
        raise ValueError(f"inverse cell sizes [{B}] in {U.dtype}, not "
                         f"{tuple(inv_dx.shape)} {inv_dx.dtype}")
    if U.device.type != "cuda":
        raise ValueError(f"advance_n_cuda takes a CUDA tensor, not one on "
                         f"{U.device}")
    if faces.device != U.device or inv_dx.device != U.device:
        raise ValueError(f"tables on {faces.device} and {inv_dx.device}, U "
                         f"on {U.device}")
    if not (U.is_contiguous() and faces.is_contiguous()
            and inv_dx.is_contiguous()):
        raise ValueError("advance_n_cuda takes contiguous tensors")
    if U.numel() >= 2 ** 31:
        raise ValueError(f"advance_n_cuda indexes cells with 32-bit ints; "
                         f"{U.numel()} values are too many")
    if n == 0:
        return U.clone()
    lib = _library()
    out = torch.empty_like(U)
    scratch = torch.empty_like(U) if n > 1 else out
    fn = lib.b12_advance_n_f32 if U.dtype == torch.float32 \
        else lib.b12_advance_n_f64
    stream = torch.cuda.current_stream(U.device).cuda_stream
    rc = fn(U.data_ptr(), out.data_ptr(), scratch.data_ptr(),
            faces.data_ptr(), inv_dx.data_ptr(), float(dt),
            float(gamma_law_index), B, U.shape[1], n, stream)
    if rc != 0:
        raise RuntimeError("octree_euler_step kernel launch failed: "
                           + lib.b12_error_string(rc).decode())
    advance_n_cuda.launches += n
    tracing.recorder().count("octree_kernel_steps", n)
    return out


advance_n_cuda.launches = 0


def advance_n(U, mesh, dt: float, n: int, gamma_law_index=5.0 / 3.0,
              domain_size=2.0):
    """n steps of U [B, bs, bs, bs, 5] on `mesh` in one call: the plain
    version for a CPU tensor, kernel B12 for a CUDA tensor."""
    global LAST_PATH
    if U.device.type == "cpu":
        out = advance_n_plain(U, mesh, dt, n, gamma_law_index, domain_size)
        LAST_PATH = f"scheme[{n}]"
        return out
    if U.device.type == "cuda":
        faces, inv_dx = _device_tables(mesh, U, domain_size)
        out = advance_n_cuda(U, faces, inv_dx, dt, n, gamma_law_index)
        LAST_PATH = f"cuda_b12[{n}]"
        return out
    raise ValueError(f"no octree Euler step for a tensor on {U.device}")
