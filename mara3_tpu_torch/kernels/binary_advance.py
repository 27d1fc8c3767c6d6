"""Kernel B2: the flagship circumbinary advance, as a CUDA kernel beside its
plain PyTorch version.

Replaces mara3_tpu/kernels/binary_advance.py::fused_advance_core2, the
Pallas kernel that the JAX package runs for every advance on a TPU
(schemes/binary_scheme.py make_advance(fused=True)). The CUDA source is
csrc/binary_advance.cu; its header note gives the design and what bounds
it (device memory: about 26 live values per cell for a few flops each).

- `advance_plain` is the port of the JAX package's reference-semantics
  advance, make_advance(fused=False): plain torch ops on [B, bs, bs, 3]
  tensors. The CPU tests hold it to the JAX package.
- `advance_cuda` is the kernel's wrapper: primitive recovery and the
  primitive guard gather in torch (as they are jnp in front of the Pallas
  call), then one call into the library that launches the slope,
  face-flux, update, totals and work-done passes on the current stream.
  `advance_cuda.launches` counts its launches.
- `advance` takes the plain version for a tensor on the CPU and the kernel
  for a CUDA tensor; it never falls back from one to the other.

Kernel B11c, the advance of the "jnp_strips" variant, lives here too:
`advance_core_strips_plain`, `advance_core_strips_cuda` (csrc/
binary_advance_strips.cu) and the dispatcher `advance_core_strips`. It
replaces mara3_tpu/kernels/binary_advance.py::fused_advance_core: B2's
advance with the guard strips built by the scheme's torch front, positions
formed from each block's (x0, y0, dx), the TPU kernel's face flux, and no
coarse-fine correction (the scheme's edge fixup applies it).
"""

from __future__ import annotations

import ctypes
from dataclasses import dataclass

import numpy as np
import torch

from mara3_tpu_torch.mathx.plm import plm_gradient
from mara3_tpu_torch.mesh import block_layout
from mara3_tpu_torch.physics import iso2d
from mara3_tpu_torch.schemes import binary_scheme
from mara3_tpu_torch.schemes.binary_scheme import SchemeConfig

@dataclass(frozen=True)
class AdvanceTables:
    """Static per-mesh tensors of one advance, on the run's device."""
    cfg: SchemeConfig
    device: torch.device
    dtype: torch.dtype
    nt: block_layout.NeighborTable        # tensors, for the flux fixup
    gg: block_layout.GuardGather          # tensors, for the guard gather
    xc: torch.Tensor                      # [B, bs, bs, 2]
    dA: torch.Tensor                      # [B, bs, bs]
    spacing: torch.Tensor                 # [B]
    xf: torch.Tensor                      # [B, bs+1, bs, 2]
    yf: torch.Tensor                      # [B, bs, bs+1, 2]
    initial_conserved: torch.Tensor       # [B, bs, bs, 3]
    buffer_rate: torch.Tensor             # [B, bs, bs]
    # what the kernel reads in place of the per-cell geometry
    tab: torch.Tensor                     # [B, 4, 6] int32 neighbor rows
    axes: torch.Tensor                    # [B, 6, bs+1] float64 coordinates
    spacing64: torch.Tensor               # [B] float64
    # what kernel B11c reads in place of positions: each block's cell (0, 0)
    # lower corner and spacing, (x0, y0, dx)
    blockgeo: torch.Tensor                # [B, 3]


def build_tables(cfg: SchemeConfig, nt, geometry, initial_conserved,
                 buffer_rate, *, device, dtype) -> AdvanceTables:
    """Move one mesh's static arrays to the device. `geometry` is the host
    float64 (xc, dA, spacing, xf, yf)."""
    device = torch.device(device)
    as_t = lambda a: torch.as_tensor(
        a if torch.is_tensor(a) else np.asarray(a), dtype=dtype,
        device=device)
    xc, dA, spacing, xf, yf = (np.asarray(a, np.float64) for a in geometry)
    B, bs = xc.shape[0], xc.shape[1]
    # per-block coordinate rows, exact copies of the geometry arrays:
    # cell-center x by i, cell-center y by j, x-face x by i, x-face y by j,
    # y-face x by i, y-face y by j (rows of bs padded to bs+1)
    axes = np.zeros((B, 6, bs + 1), np.float64)
    axes[:, 0, :bs] = xc[:, :, 0, 0]
    axes[:, 1, :bs] = xc[:, 0, :, 1]
    axes[:, 2, :] = xf[:, :, 0, 0]
    axes[:, 3, :bs] = xf[:, 0, :, 1]
    axes[:, 4, :bs] = yf[:, :, 0, 0]
    axes[:, 5, :] = yf[:, 0, :, 1]
    nt_dev = block_layout.NeighborTable(
        *(torch.as_tensor(a, dtype=torch.int64, device=device)
          for a in (nt.case, nt.same_id, nt.coarse_id, nt.coarse_half,
                    nt.fine_id)))
    return AdvanceTables(
        cfg=cfg, device=device, dtype=dtype, nt=nt_dev,
        gg=block_layout.build_guard_gather(nt, bs).to(device, dtype),
        xc=as_t(xc), dA=as_t(dA), spacing=as_t(spacing), xf=as_t(xf),
        yf=as_t(yf),
        initial_conserved=torch.as_tensor(initial_conserved, dtype=dtype,
                                          device=device).contiguous(),
        buffer_rate=as_t(buffer_rate).contiguous(),
        tab=torch.as_tensor(block_layout.pack_neighbor_table(nt),
                            device=device).contiguous(),
        axes=torch.as_tensor(axes, device=device),
        spacing64=torch.as_tensor(spacing, device=device),
        blockgeo=as_t(block_geometry(xc, spacing)))


def block_geometry(xc, spacing) -> np.ndarray:
    """[B, 3] float64 rows (x0, y0, dx): each block's cell (0, 0) lower
    corner and its spacing, from which kernel B11c forms its positions
    (mara3_tpu/schemes/binary_scheme.py:517-519)."""
    x00 = xc[:, 0, 0, 0] - 0.5 * spacing
    y00 = xc[:, 0, 0, 1] - 0.5 * spacing
    return np.stack([x00, y00, spacing], axis=-1)


def recover(t: AdvanceTables, u0):
    if t.cfg.conserve_linear_p:
        return iso2d.recover_primitive(u0)
    return iso2d.recover_primitive_angmom(u0, t.xc)


def advance_plain(t: AdvanceTables, u0, bodies, dt, plm_theta):
    """The reference-semantics advance (the port of the JAX package's
    make_advance(fused=False)): (u1, totals, invalid)."""
    cfg = t.cfg
    bodies = torch.as_tensor(bodies, dtype=t.dtype, device=u0.device)
    p0 = recover(t, u0)
    strips = block_layout.guard_strips(p0, t.gg)
    p0_ex = block_layout.extend_blocks_fast(p0, t.gg, 0, strips)
    p0_ey = block_layout.extend_blocks_fast(p0, t.gg, 1, strips)

    if cfg.reconstruct_method == "plm":
        sp = t.spacing[:, None, None, None]
        gx = plm_gradient(p0_ex[:, :-2], p0_ex[:, 1:-1], p0_ex[:, 2:],
                          plm_theta) / sp
        gy = plm_gradient(p0_ey[:, :, :-2], p0_ey[:, :, 1:-1],
                          p0_ey[:, :, 2:], plm_theta) / sp
    else:
        gx = torch.zeros_like(p0)
        gy = torch.zeros_like(p0)

    # both gradient fields extended with one gather
    G = torch.cat([gx, gy], dim=-1)
    G_strips = block_layout.guard_strips(G, t.gg)
    G_ex = block_layout.extend_blocks_fast(G, t.gg, 0, G_strips)
    G_ey = block_layout.extend_blocks_fast(G, t.gg, 1, G_strips)
    nc = p0.shape[-1]
    gx_ex, gy_ex = G_ex[..., :nc], G_ex[..., nc:]
    gx_ey, gy_ey = G_ey[..., :nc], G_ey[..., nc:]

    face_len_x = t.spacing[:, None, None].expand(t.xf.shape[:-1])
    face_len_y = t.spacing[:, None, None].expand(t.yf.shape[:-1])
    fx = binary_scheme.block_fluxes(0, p0_ex, gx_ex, gy_ex, t.xf, face_len_x,
                                    t.spacing, bodies, cfg)
    fy = binary_scheme.block_fluxes(1, p0_ey, gy_ey, gx_ey, t.yf, face_len_y,
                                    t.spacing, bodies, cfg)
    if not cfg.conserve_linear_p:
        fx = binary_scheme.to_angmom_fluxes(0, fx, t.xf, cfg.domain_radius)
        fy = binary_scheme.to_angmom_fluxes(1, fy, t.yf, cfg.domain_radius)

    fx = binary_scheme.correct_coarse_fine_fluxes(fx, t.nt, axis=0)
    fy = binary_scheme.correct_coarse_fine_fluxes(fy, t.nt, axis=1)

    s, totals = binary_scheme.source_terms(
        u0, p0, t.xc, t.dA, t.buffer_rate, t.initial_conserved, bodies, dt,
        cfg)

    lx = fx[:, 1:] - fx[:, :-1]
    ly = fy[:, :, 1:] - fy[:, :, :-1]
    u1 = u0 - (lx + ly) * dt / t.dA[..., None] + s
    return u1, totals, iso2d.contains_invalid(u1)


# -----------------------------------------------------------------------------
# the CUDA kernel
# -----------------------------------------------------------------------------

_c_void_p = ctypes.c_void_p
_c_int = ctypes.c_int
# the totals the kernels sum (csrc/binary_advance_core.cuh, kTotals): the
# eight per-body totals of PAIR_TOTALS, mass_ejected,
# angular_momentum_ejected, the fault count
NUM_TOTALS = 19
FAULTS_SLOT = 18


def totals_from_slots(totals, dtype, keys=binary_scheme.PAIR_TOTALS):
    """The totals dict of a kernel's float64 [NUM_TOTALS] sums, in `dtype`:
    slot 2 q + body for the per-body total q of PAIR_TOTALS (those of
    `keys`), then mass_ejected and angular_momentum_ejected."""
    tt = totals.to(dtype)
    out = {key: tt[2 * q:2 * q + 2]
           for q, key in enumerate(binary_scheme.PAIR_TOTALS) if key in keys}
    out["mass_ejected"] = tt[16]
    out["angular_momentum_ejected"] = tt[17]
    return out


def _library():
    """The built csrc/binary_advance.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("binary_advance")
    if not getattr(lib, "_mara_typed", False):
        if lib.b2_num_totals() != NUM_TOTALS:
            raise RuntimeError("csrc/binary_advance.cu sums "
                               f"{lib.b2_num_totals()} totals, not "
                               f"{NUM_TOTALS}")
        for fn in (lib.b2_advance_f32, lib.b2_advance_f64):
            fn.argtypes = [_c_void_p] * 14 + [_c_int, _c_int, _c_void_p,
                                              _c_int, _c_void_p]
            fn.restype = _c_int
        for fn in (lib.b2_advance_dev_f32, lib.b2_advance_dev_f64):
            fn.argtypes = [_c_void_p] * 14 + [_c_int, _c_int, _c_void_p,
                                              _c_int, _c_void_p, _c_void_p]
            fn.restype = _c_int
        lib.b2_num_partials.argtypes = [_c_int, _c_int]
        lib.b2_num_partials.restype = _c_int
        lib.b2_num_totals.argtypes = []
        lib.b2_num_totals.restype = _c_int
        lib.b2_error_string.argtypes = [_c_int]
        lib.b2_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def kernel_params(cfg: SchemeConfig, bodies, dt, theta):
    """(params float64 [24], flags) in the layout csrc/binary_advance.cu
    reads (read_params)."""
    bodies = np.asarray(bodies, np.float64).reshape(2, 5)
    params = np.array(
        [dt, theta, *bodies.ravel(),
         cfg.softening_radius ** 2, cfg.sink_radius ** 2, cfg.sink_rate,
         cfg.mach_number ** 2, cfg.mach_number, cfg.density_floor,
         cfg.gst_suppr_radius ** 2, cfg.alpha, cfg.alpha_cutoff_radius,
         cfg.nu, cfg.domain_radius,
         binary_scheme.boundary_tolerance(cfg.domain_radius)], np.float64)
    flags = (int(cfg.axisymmetric_cs2) | int(cfg.conserve_linear_p) << 1
             | int(cfg.riemann == "hllc") << 2)
    return params, flags


def launch_params(cfg: SchemeConfig, bodies, dt, theta, device,
                  boundary_tol=None):
    """(host params, flags, device buffer or None) of a launch: dt, theta
    and the bodies go to the kernels through the host params when they are
    host numbers, and through a device buffer that the kernels read when
    either is a tensor, so the host never waits for them. boundary_tol
    replaces the Lz boundary test's tolerance (B11a's is its own)."""
    if torch.is_tensor(bodies) or torch.is_tensor(dt):
        params, flags = kernel_params(cfg, np.zeros((2, 5)), 0.0, theta)
        dyn = device_params(dt, theta, bodies, device)
    else:
        params, flags = kernel_params(cfg, bodies, dt, theta)
        dyn = None
    if boundary_tol is not None:
        params[23] = boundary_tol
    return params, flags, dyn


def _check(t: AdvanceTables, u0, name="advance_cuda"):
    """Raise unless u0 is what the kernels take: a contiguous CUDA tensor
    [B, bs, bs, 3] of the tables' dtype, on the tables' device."""
    B, bs = t.xc.shape[0], t.xc.shape[1]
    if not u0.is_cuda:
        raise ValueError(f"{name} takes a CUDA tensor")
    if u0.dtype not in (torch.float32, torch.float64) or u0.dtype != t.dtype:
        raise TypeError(f"{name} takes the tables' dtype {t.dtype} "
                        f"(float32 or float64), got {u0.dtype}")
    if tuple(u0.shape) != (B, bs, bs, 3):
        raise ValueError(f"{name} takes [{B}, {bs}, {bs}, 3], "
                         f"got {list(u0.shape)}")
    if not u0.is_contiguous():
        raise ValueError(f"{name} takes a contiguous tensor")
    if u0.device != t.tab.device:
        raise ValueError(f"state on {u0.device}, tables on {t.tab.device}")


def device_params(dt, theta, bodies, device):
    """dt, theta and the bodies as the kernels' float64 device buffer
    (kDynamic doubles), built on the device with no host read."""
    dyn = torch.empty(12, dtype=torch.float64, device=device)
    dyn[0] = dt
    dyn[1] = theta
    dyn[2:] = torch.as_tensor(bodies, device=device).reshape(10)
    return dyn


def advance_cuda(t: AdvanceTables, u0, bodies, dt, plm_theta):
    """Kernel B2 on a CUDA tensor: (u1, totals, invalid), with the same
    meaning as advance_plain. Host numbers for dt and the bodies go to the
    kernels through the launch; when either is a tensor, the kernels read
    dt, theta and the bodies from a device buffer instead, so the host
    never waits for them. Raises if the kernel does not build or its
    launch fails."""
    _check(t, u0)
    cfg = t.cfg
    B, bs = t.xc.shape[0], t.xc.shape[1]
    lib = _library()
    p0 = recover(t, u0).contiguous()
    pg = block_layout.guard_strips(p0, t.gg).contiguous()
    theta = float(plm_theta) if cfg.reconstruct_method == "plm" else 0.0
    params, flags, dyn = launch_params(cfg, bodies, dt, theta, u0.device)

    empty = lambda *shape, dtype=t.dtype: torch.empty(shape, dtype=dtype,
                                                      device=u0.device)
    g = empty(B, bs, bs, 6)
    fx = empty(B, bs + 1, bs, 3)
    fy = empty(B, bs, bs + 1, 3)
    u1 = empty(B, bs, bs, 3)
    partials = empty(lib.b2_num_partials(B, bs), NUM_TOTALS,
                     dtype=torch.float64)
    totals = empty(NUM_TOTALS, dtype=torch.float64)
    f32 = t.dtype == torch.float32
    stream = torch.cuda.current_stream(u0.device).cuda_stream
    args = (u0.data_ptr(), p0.data_ptr(), pg.data_ptr(),
            t.initial_conserved.data_ptr(), t.buffer_rate.data_ptr(),
            t.tab.data_ptr(), t.axes.data_ptr(), t.spacing64.data_ptr(),
            g.data_ptr(), fx.data_ptr(), fy.data_ptr(), u1.data_ptr(),
            partials.data_ptr(), totals.data_ptr(), B, bs,
            params.ctypes.data, flags)
    if dyn is not None:
        fn = lib.b2_advance_dev_f32 if f32 else lib.b2_advance_dev_f64
        rc = fn(*args, dyn.data_ptr(), stream)
    else:
        fn = lib.b2_advance_f32 if f32 else lib.b2_advance_f64
        rc = fn(*args, stream)
    if rc != 0:
        raise RuntimeError("binary_advance kernel launch failed: "
                           + lib.b2_error_string(rc).decode())
    advance_cuda.launches += 1
    return u1, totals_from_slots(totals, t.dtype), totals[FAULTS_SLOT] > 0


advance_cuda.launches = 0


def advance(t: AdvanceTables, u0, bodies, dt, plm_theta):
    """One advance: the plain version for a CPU tensor, kernel B2 for a
    CUDA tensor."""
    if u0.device.type == "cpu":
        return advance_plain(t, u0, bodies, dt, plm_theta)
    if u0.device.type == "cuda":
        return advance_cuda(t, u0, bodies, dt, plm_theta)
    raise ValueError(f"no advance for a tensor on {u0.device}")


# -----------------------------------------------------------------------------
# kernel B11c: the jnp_strips advance, guard strips built outside
# -----------------------------------------------------------------------------

def _iota_positions(geo, n, off, dtype, device):
    """x0 + (k + off) dx for k < n, per block: [B, n] from geo [B, 2] of
    (x0, dx) (the TPU kernel's iota positions,
    mara3_tpu/kernels/binary_advance.py:268-289)."""
    k = torch.arange(n, dtype=dtype, device=device)[None, :]
    return geo[:, 0:1] + (k + off) * geo[:, 1:2]


def advance_core_strips_plain(u0, p, strips, blockgeo, init, spacing, dt,
                              bodies, theta, cfg: SchemeConfig):
    """B11c's arithmetic: (u1, (fxlo, fxhi, fylo, fyhi), totals). u0, p,
    init [B, bs, bs, 3]; strips [B, 4, bs, 9] (faces x-lo, x-hi, y-lo,
    y-hi; components p | gx | gy); blockgeo [B, 3] (x0, y0, dx); spacing
    [B]. u1 is the update before the coarse-fine edge fixup, the edge
    fluxes [B, bs, 3] are the fluxes through the blocks' four edges, and
    the totals are binary_update.UPDATE_TOTALS, mass_ejected and
    angular_momentum_ejected."""
    from mara3_tpu_torch.kernels import binary_update as BU
    from mara3_tpu_torch.mathx.plm import plm_gradient
    dtype, device = u0.dtype, u0.device
    bodies = torch.as_tensor(bodies, dtype=dtype, device=device)
    B, bs = u0.shape[0], u0.shape[1]
    sp = spacing.to(dtype)[:, None, None, None]
    S = strips
    pex = torch.cat([S[:, 0, None, :, :3], p, S[:, 1, None, :, :3]], dim=1)
    pey = torch.cat([S[:, 2, :, None, :3], p, S[:, 3, :, None, :3]], dim=2)
    gx = plm_gradient(pex[:, :-2], pex[:, 1:-1], pex[:, 2:], theta) / sp
    gy = plm_gradient(pey[:, :, :-2], pey[:, :, 1:-1], pey[:, :, 2:],
                      theta) / sp
    G = torch.cat([gx, gy], dim=-1)                       # [B, bs, bs, 6]
    Gex = torch.cat([S[:, 0, None, :, 3:], G, S[:, 1, None, :, 3:]], dim=1)
    Gey = torch.cat([S[:, 2, :, None, 3:], G, S[:, 3, :, None, 3:]], dim=2)

    gx0, gy0, gdx = blockgeo[:, 0:1], blockgeo[:, 1:2], blockgeo[:, 2:3]
    pos = lambda g0, n, off: _iota_positions(
        torch.cat([g0, gdx], dim=1), n, off, dtype, device)
    x = pos(gx0, bs, 0.5)[:, :, None].expand(B, bs, bs)   # cell centers
    y = pos(gy0, bs, 0.5)[:, None, :].expand(B, bs, bs)
    xfx = pos(gx0, bs + 1, 0.0)[:, :, None].expand(B, bs + 1, bs)
    xfy = pos(gy0, bs, 0.5)[:, None, :].expand(B, bs + 1, bs)
    yfx = pos(gx0, bs, 0.5)[:, :, None].expand(B, bs, bs + 1)
    yfy = pos(gy0, bs + 1, 0.0)[:, None, :].expand(B, bs, bs + 1)
    dx = gdx[:, :, None]                                  # [B, 1, 1]

    tol = binary_scheme.boundary_tolerance(cfg.domain_radius)
    fx = BU.tpu_face_flux(0, pex[:, :-1], pex[:, 1:], Gex[:, :-1, :, 0:3],
                          Gex[:, 1:, :, 0:3], Gex[:, :-1, :, 3:6],
                          Gex[:, 1:, :, 3:6], xfx, xfy, dx, bodies, cfg,
                          False, tol)
    fy = BU.tpu_face_flux(1, pey[:, :, :-1], pey[:, :, 1:],
                          Gey[:, :, :-1, 3:6], Gey[:, :, 1:, 3:6],
                          Gey[:, :, :-1, 0:3], Gey[:, :, 1:, 0:3], yfx, yfy,
                          dx, bodies, cfg, False, tol)
    edges = (fx[:, 0], fx[:, bs], fy[:, :, 0], fy[:, :, bs])

    # the buffer damping rate formed from the position, as the TPU kernel
    # forms it (subprog_binary_solver_data.cpp:61-76)
    r_cell = torch.sqrt(x * x + y * y)
    br = cfg.buffer_damping_rate * (
        1.0 + torch.tanh(3.0 * (r_cell - cfg.domain_radius)))
    div = (fx[:, 1:] - fx[:, :-1]) + (fy[:, :, 1:] - fy[:, :, :-1])
    u1, totals = BU.tpu_cell_update(u0, p, init, br, div, x, y, dx * dx, dt,
                                    bodies, cfg)
    return u1, edges, totals


def _library_strips():
    """The built csrc/binary_advance_strips.cu (compiled on first use)."""
    from mara3_tpu_torch.kernels import _build
    lib = _build.load("binary_advance_strips")
    if not getattr(lib, "_mara_typed", False):
        if lib.b11c_num_totals() != NUM_TOTALS:
            raise RuntimeError("csrc/binary_advance_strips.cu sums "
                               f"{lib.b11c_num_totals()} totals, not "
                               f"{NUM_TOTALS}")
        for fn in (lib.b11c_advance_f32, lib.b11c_advance_f64):
            fn.argtypes = [_c_void_p] * 12 + [
                _c_int, _c_int, ctypes.c_double, _c_void_p, _c_int,
                _c_void_p, _c_void_p]
            fn.restype = _c_int
        lib.b11c_num_partials.argtypes = [_c_int, _c_int]
        lib.b11c_num_partials.restype = _c_int
        lib.b11c_num_totals.argtypes = []
        lib.b11c_num_totals.restype = _c_int
        lib.b11c_error_string.argtypes = [_c_int]
        lib.b11c_error_string.restype = ctypes.c_char_p
        lib._mara_typed = True
    return lib


def advance_core_strips_cuda(u0, p, strips, blockgeo, init, spacing, dt,
                             bodies, theta, cfg: SchemeConfig):
    """Kernel B11c on CUDA tensors, with advance_core_strips_plain's
    meaning. Raises if the kernel does not build or its launch fails."""
    from mara3_tpu_torch.kernels import binary_update as BU
    B, bs = u0.shape[0], u0.shape[1]
    for a, shape in ((u0, (B, bs, bs, 3)), (p, (B, bs, bs, 3)),
                     (init, (B, bs, bs, 3)), (strips, (B, 4, bs, 9)),
                     (blockgeo, (B, 3)), (spacing, (B,))):
        if tuple(a.shape) != shape:
            raise ValueError(f"advance_core_strips_cuda takes {list(shape)}, "
                             f"got {list(a.shape)}")
    BU.check_cuda_args("advance_core_strips_cuda", u0.dtype, u0, p, strips,
                       blockgeo, init, spacing)
    lib = _library_strips()
    params, flags, dyn = launch_params(cfg, bodies, dt, float(theta),
                                       u0.device)
    empty = lambda *shape, dtype=u0.dtype: torch.empty(shape, dtype=dtype,
                                                       device=u0.device)
    g = empty(B, bs, bs, 6)
    fx = empty(B, bs + 1, bs, 3)
    fy = empty(B, bs, bs + 1, 3)
    u1 = empty(B, bs, bs, 3)
    partials = empty(lib.b11c_num_partials(B, bs), NUM_TOTALS,
                     dtype=torch.float64)
    totals = empty(NUM_TOTALS, dtype=torch.float64)
    spacing64 = spacing.to(torch.float64)
    fn = (lib.b11c_advance_f32 if u0.dtype == torch.float32
          else lib.b11c_advance_f64)
    rc = fn(u0.data_ptr(), p.data_ptr(), strips.data_ptr(),
            blockgeo.data_ptr(), init.data_ptr(), spacing64.data_ptr(),
            g.data_ptr(), fx.data_ptr(), fy.data_ptr(), u1.data_ptr(),
            partials.data_ptr(), totals.data_ptr(), B, bs,
            cfg.buffer_damping_rate, params.ctypes.data, flags,
            None if dyn is None else dyn.data_ptr(),
            torch.cuda.current_stream(u0.device).cuda_stream)
    if rc != 0:
        raise RuntimeError("binary_advance_strips B11c launch failed: "
                           + lib.b11c_error_string(rc).decode())
    advance_core_strips_cuda.launches += 1
    edges = (fx[:, 0], fx[:, bs], fy[:, :, 0], fy[:, :, bs])
    return u1, edges, totals_from_slots(totals, u0.dtype, BU.UPDATE_TOTALS)


advance_core_strips_cuda.launches = 0


def advance_core_strips(u0, p, strips, blockgeo, init, spacing, dt, bodies,
                        theta, cfg: SchemeConfig):
    """B11c: the plain version for CPU tensors, the kernel for CUDA ones."""
    if u0.device.type == "cpu":
        return advance_core_strips_plain(u0, p, strips, blockgeo, init,
                                         spacing, dt, bodies, theta, cfg)
    if u0.device.type == "cuda":
        return advance_core_strips_cuda(u0, p, strips, blockgeo, init,
                                        spacing, dt, bodies, theta, cfg)
    raise ValueError(f"no advance_core_strips for a tensor on {u0.device}")
