"""Device enumeration and selection over torch.cuda (the role of sppark's
util/all_gpus.cpp and util/gpu_t.cuh)."""

from __future__ import annotations

from typing import List, Optional, Union

import torch

from ..util.errors import SpparkError


def all_devices() -> List[torch.device]:
    """Every CUDA device visible to the process."""
    return [torch.device("cuda", i) for i in range(torch.cuda.device_count())]


def accelerator_available() -> bool:
    """True when a CUDA card is usable (sppark's cuda_available,
    util/cuda_available.cu:10-23)."""
    return torch.cuda.is_available()


def ndevices() -> int:
    return torch.cuda.device_count()


def select_device(device_id: int = -1) -> torch.device:
    """Make `device_id` the current CUDA device; -1 returns the current one
    (select_gpu semantics)."""
    if device_id >= 0:
        if device_id >= torch.cuda.device_count():
            raise IndexError(f"device {device_id} out of range "
                             f"({torch.cuda.device_count()} available)")
        torch.cuda.set_device(device_id)
    return torch.device("cuda", torch.cuda.current_device())


def device_props(device_id: int = 0) -> dict:
    p = torch.cuda.get_device_properties(device_id)
    return {
        "id": device_id,
        "name": p.name,
        "capability": (p.major, p.minor),
        "total_memory": p.total_memory,
        "multi_processor_count": p.multi_processor_count,
    }


def resolve(device: Optional[Union[str, torch.device]]) -> torch.device:
    """The device an entry point runs on: None means the CUDA card.  There
    is no silent fall back to the CPU: without a card, None raises and only
    an explicit CPU device runs on the CPU."""
    if device is None:
        if not torch.cuda.is_available():
            raise SpparkError(2, "no CUDA device available; pass "
                                 "device='cpu' to run on the CPU")
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(device)
