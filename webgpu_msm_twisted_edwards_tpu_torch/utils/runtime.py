"""Device resolution and device facts."""

from __future__ import annotations

import subprocess

import torch

#: Device memory assumed for a CPU run (the plain versions): sizes the window
#: groups and point blocks the same way on every CUDA-less host.
CPU_MEMORY_BYTES = 8 * (1 << 30)


def resolve_device(device=None) -> torch.device:
    """`device=None` means the CUDA card.  Without one, only an explicit
    `device="cpu"` runs (on the kernels' plain versions)."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run the "
                "plain PyTorch versions of the kernels"
            )
        return torch.device("cuda")
    return torch.device(device)


def device_memory_bytes(device=None) -> int:
    """Total memory of `device` in bytes (torch.cuda.mem_get_info), or
    CPU_MEMORY_BYTES for the CPU."""
    device = resolve_device(device)
    if device.type == "cuda":
        return int(torch.cuda.mem_get_info(device)[1])
    return CPU_MEMORY_BYTES


def card_info() -> str:
    """The card's name and power limit, as
    `nvidia-smi --query-gpu=name,power.limit --format=csv,noheader` prints
    them."""
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return res.stdout.strip()
