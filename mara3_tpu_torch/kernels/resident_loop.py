"""What the wrappers of kernels B6 and B5 share about csrc/resident_loop.cuh,
the persistent step loop (one cooperative launch a call, one grid barrier a
step): the card's limits that their plans read, and a kernel's resources.

A plan is a pure function of the state's sizes and these limits, made
before the launch; the CPU tests build plans with the H100's limits
(H100).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import numpy as np


class Limits(NamedTuple):
    """SMs, shared memory a CTA can opt into, shared memory an SM, and the
    shared memory the system reserves for each CTA (bytes)."""
    sms: int
    smem_optin: int
    smem_per_sm: int
    smem_reserved: int

    def fits(self, smem: int, ctas_per_sm: int) -> bool:
        """Whether ctas_per_sm CTAs of `smem` bytes each fit on one SM."""
        return (smem <= self.smem_optin
                and ctas_per_sm * (smem + self.smem_reserved)
                <= self.smem_per_sm)


# NVIDIA H100 SXM: 132 SMs, 227 KB a CTA, 228 KB an SM, 1 KB reserved a CTA
H100 = Limits(132, 232448, 233472, 1024)


def device_limits(entry) -> Limits:
    """The current card's Limits through a library's `entry`
    (b6_device_limits or b5_device_limits)."""
    out = (ctypes.c_int * 4)()
    rc = entry(out)
    if rc != 0:
        raise RuntimeError(f"cudaDeviceGetAttribute failed ({rc})")
    return Limits(*out)


def split_starts(n: int, parts: int) -> np.ndarray:
    """[parts + 1] int32: n items in `parts` contiguous runs whose lengths
    differ by at most one, the longer first (a CTA owns run g)."""
    q, r = divmod(n, parts)
    sizes = np.full(parts, q, dtype=np.int64)
    sizes[:r] += 1
    return np.concatenate([[0], np.cumsum(sizes)]).astype(np.int32)


def kernel_info(entry, error_string, *args):
    """A kernel's resources through a library's `entry`: registers and
    local_bytes a thread, static_smem and dynamic_smem a CTA, ctas_per_sm
    (the occupancy calculator's on the current card)."""
    out = (ctypes.c_int * 5)()
    rc = entry(*args, out)
    if rc != 0:
        raise RuntimeError("kernel info: " + error_string(rc).decode())
    return dict(zip(("registers", "local_bytes", "static_smem",
                     "ctas_per_sm", "dynamic_smem"), out))
