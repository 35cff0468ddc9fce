"""Device resolution, device facts, and copies between the host and the
device."""

from __future__ import annotations

import subprocess
from typing import Any

import numpy as np
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


def device_info(device=None) -> dict[str, Any]:
    """Identity and memory of `device` (default: the CUDA card): backend,
    name, index, device count, process index, the allocator's statistics
    and, on a card, its name and power limit from nvidia-smi."""
    device = resolve_device(device)
    if device.type != "cuda":
        return {"backend": device.type, "kind": device.type, "id": 0, "num_devices": 1,
                "process_index": 0, "memory_stats": None, "card": None}
    index = torch.cuda.current_device() if device.index is None else device.index
    props = torch.cuda.get_device_properties(index)
    stats = torch.cuda.memory_stats(index)
    free, total = torch.cuda.mem_get_info(index)
    return {
        "backend": "cuda",
        "kind": props.name,
        "id": index,
        "num_devices": torch.cuda.device_count(),
        "process_index": 0,
        "memory_stats": {
            "bytes_in_use": stats.get("allocated_bytes.all.current", 0),
            "bytes_limit": total,
            "peak_bytes_in_use": stats.get("allocated_bytes.all.peak", 0),
            "bytes_free": free,
        },
        "compute_capability": f"{props.major}.{props.minor}",
        "multiprocessors": props.multi_processor_count,
        "card": card_info(),
    }


def to_device(arr: np.ndarray, device=None) -> torch.Tensor:
    """A host array on `device` (default: the CUDA card); a uint32 array
    becomes an int32 tensor with the same bits, as the port holds u32
    data."""
    device = resolve_device(device)
    arr = np.array(arr)                      # a writable, contiguous copy
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr).to(device)


def read_back(t: torch.Tensor) -> np.ndarray:
    """A tensor on the host as a numpy array (int32 as uint32, the inverse of
    to_device)."""
    arr = t.detach().cpu().contiguous().numpy()
    return arr.view(np.uint32) if arr.dtype == np.int32 else arr
