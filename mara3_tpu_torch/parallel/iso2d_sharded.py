"""Kernel B9 on an x-sharded periodic state: the counterpart of
mara3_tpu/parallel/iso2d_sharded.py.

One process, one controller, as the JAX package's shard_map is: a sharded
state is a list of x-slabs [3, nx / N, ny], slab k on devices[k]. Per G
steps each shard makes ONE B9 call (kernels/iso2d_step_v4.py) on its
stripes, on its device's current stream; the only communication is a
pair of 2 G rk_order-row edge strips a shard, taken from its x-neighbors
(periodic) with `tensor.to(neighbor_device, non_blocking=True)`: a peer
copy over NVLink between cards, a device copy on one card (PyTorch orders
such a copy after the work of both devices' current streams). That is the
ppermute of `_local_strips` (iso2d_sharded.py:37-54), and the analog of the
reference's isend/irecv guard exchange (subprog_binary_scheme.cpp:132-142).

Any list of devices is taken, repeats allowed: N shards may share one card,
or the CPU, where B9's plain version runs on each shard. Each stripe's
update depends only on its window, and the windows assembled here hold the
same rows as the single-device `build_x_strips`, so the sharded result is
bit-equal to one shard's with the same TX and G.

torch.distributed is not used: with NCCL two ranks cannot share a card, so
no multi-shard run could be checked on a one-card machine, and a single
controller keeps `python -m mara3_tpu_torch kh shards=4` one process, as in
the JAX package (ROADMAP.md queue A item 11).
"""

from __future__ import annotations

import torch

from mara3_tpu_torch.kernels import iso2d_step_v4 as V4


def shard_state(u, devices):
    """A global [3, nx, ny] state as len(devices) x-slabs, slab k on
    devices[k]; nx % len(devices) == 0."""
    n, nx = len(devices), u.shape[1]
    if n < 1 or nx % n:
        raise ValueError(f"{nx} rows do not split into {n} shards")
    w = nx // n
    return [u[:, k * w:(k + 1) * w].to(devices[k]).contiguous()
            for k in range(n)]


def gather_state(shards, device=None):
    """The global [3, nx, ny] state of the x-slabs, on `device` (default:
    the first shard's)."""
    device = shards[0].device if device is None else device
    return torch.cat([s.to(device) for s in shards], dim=1)


def _local_strips(shards, k, h, TX):
    """Shard k's strips (lo, hi) [gi, 3, h, ny]: interior stripes read
    their neighbor stripes locally; the edge stripes get their rows from
    the x-neighbor shards (periodic)."""
    u = shards[k]
    lo, hi = V4.build_x_strips(u, TX, h)
    n = len(shards)
    if n > 1:
        left, right = shards[(k - 1) % n], shards[(k + 1) % n]
        lo[0] = left[:, left.shape[1] - h:].to(u.device, non_blocking=True)
        hi[-1] = right[:, :h].to(u.device, non_blocking=True)
    return lo, hi


def make_advance_v4_sharded(devices, *, G: int = 8, cs2: float,
                            dtdx: float, dtdy: float, theta: float = 1.8,
                            TX: int = 512, rk_order: int = 1,
                            riemann: str = "hlle"):
    """Distributed n-step advance over a global periodic state x-sharded
    over `devices` (shard_state). Returns ``advance(shards, n)`` -> the new
    shards, n a multiple of G: per G steps, one B9 call (or its plain
    version, on the CPU) a shard from strips of 2 G rk_order rows."""
    devices = [torch.device(d) for d in devices]
    h = 2 * G * rk_order
    kw = dict(G=G, cs2=cs2, dtdx=dtdx, dtdy=dtdy, theta=theta, TX=TX,
              rk_order=rk_order, riemann=riemann)

    def advance(shards, n: int):
        if len(shards) != len(devices) or n < 0 or n % G:
            raise ValueError(f"advance takes {len(devices)} shards and n a "
                             f"multiple of G={G}, not {len(shards)}, {n}")
        for _ in range(n // G):
            strips = [_local_strips(shards, k, h, TX)
                      for k in range(len(shards))]
            shards = [V4.step_v4_strips(u, lo, hi, **kw)
                      for u, (lo, hi) in zip(shards, strips)]
        return shards

    return advance
