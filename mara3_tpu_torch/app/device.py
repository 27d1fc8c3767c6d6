"""The run's device, which every subprogram resolves the same way.

The port runs on the CUDA card unless the caller asks for the CPU:
``device="cpu"`` in code, or the environment variable DEVICE_SELECTOR set to
``cpu`` on the command line (read once, by app/subprogram.main). It never
falls back to the CPU unasked.
"""

from __future__ import annotations

import torch

# the environment variable by which the command line asks for the CPU
DEVICE_SELECTOR = "MARA3_TPU_TORCH_DEVICE"


def resolve_device(device=None) -> torch.device:
    """The run's device: `device` when given, else the CUDA card. Raises
    when neither is there: the port never falls back to the CPU unasked."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device: the port runs on an NVIDIA GPU. To run its "
                "plain PyTorch version on the CPU, pass device='cpu', or set "
                f"{DEVICE_SELECTOR}=cpu for the command line")
        device = "cuda"
    return torch.device(device)


def resolve_auto(cfg, key: str, device) -> int:
    """The int `key` of `cfg`, its -1 (auto) resolved: 1 on a CUDA device,
    0 elsewhere."""
    value = cfg.get_int(key)
    return int(torch.device(device).type == "cuda") if value < 0 else value
