"""Process groups for the sharded paths (the role of gpus_t / select_gpu,
util/all_gpus.cpp): the port of sppark_tpu/parallel/mesh.py onto
torch.distributed.

One process drives one device.  A `Mesh` is a process group seen from one
rank: the group, its size, the rank and the rank's device.  The sharded
NTT and MSM run their collectives over `mesh.group` (NCCL on the card,
gloo on the CPU), also in a group of one: nothing is skipped at a world
size of 1.
"""

from __future__ import annotations

import os
import socket
from dataclasses import dataclass
from typing import Any, Optional

import torch
import torch.distributed as dist

from ..ntt.parameters import drop_twiddle_shards
from ..util.errors import SpparkError

_STATE = {"device": None}


@dataclass(frozen=True)
class Mesh:
    """A process group from one rank's side: the group (None: the default
    group), its size, this rank and this rank's device."""

    group: Any
    size: int
    rank: int
    device: torch.device


def free_port() -> int:
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def rank_device(device=None, local_rank: Optional[int] = None
                ) -> torch.device:
    """The device a rank drives: `device` where given, else cuda:LOCAL_RANK.
    Without a card only an explicit CPU device is taken."""
    if device is not None:
        dev = torch.device(device)
        if dev.type == "cuda" and not torch.cuda.is_available():
            raise SpparkError(2, "no CUDA device available; pass "
                                 "device='cpu' to run on the CPU")
        return dev
    if not torch.cuda.is_available():
        raise SpparkError(2, "no CUDA device available; pass device='cpu' "
                             "to run on the CPU")
    if local_rank is None:
        local_rank = int(os.environ.get("LOCAL_RANK", 0))
    return torch.device("cuda", local_rank)


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, device=None) -> int:
    """Start this process's default group; returns the world size.

    The arguments default from the usual torch.distributed environment
    (WORLD_SIZE, RANK, LOCAL_RANK, and MASTER_ADDR / MASTER_PORT for the
    "env://" rendezvous, as torchrun sets them).  With none of them set,
    a world of one at tcp://localhost:<a free port>.  The device is
    cuda:LOCAL_RANK unless `device` says otherwise; the backend NCCL on
    the card and gloo on the CPU.  A rank without a card raises unless it
    was given device="cpu".  A second call returns the world size."""
    if dist.is_initialized():
        return dist.get_world_size()
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    dev = rank_device(device, int(env.get("LOCAL_RANK", rank)))
    if init_method is None:
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            init_method = "env://"
        elif world_size == 1:
            init_method = f"tcp://localhost:{free_port()}"
        else:
            raise SpparkError(2, f"a world of {world_size} needs "
                                 f"MASTER_ADDR and MASTER_PORT or an "
                                 f"init_method")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group("nccl" if dev.type == "cuda" else "gloo",
                            init_method=init_method, world_size=world_size,
                            rank=rank)
    _STATE["device"] = dev
    return world_size


def make_mesh(group=None, device=None) -> Mesh:
    """The mesh of a process group (default: the default group) from this
    rank's side, on `device` (default: the one init_distributed chose)."""
    if not dist.is_initialized():
        raise SpparkError(2, "no process group: call init_distributed() "
                             "first (a world of one where nothing is set)")
    dev = torch.device(device) if device is not None else (
        _STATE["device"] or rank_device())
    return Mesh(group, dist.get_world_size(group), dist.get_rank(group), dev)


def local_mesh(n: Optional[int] = None, device=None) -> Optional[Mesh]:
    """The mesh over the first n ranks (default: all).  Every rank calls
    it; a rank outside the first n gets None."""
    world = dist.get_world_size() if dist.is_initialized() else 0
    if n is None or n == world:
        return make_mesh(None, device)
    if n > world:
        raise ValueError(f"requested {n} ranks, have {world}")
    group = dist.new_group(list(range(n)))
    return make_mesh(group, device) if dist.get_rank() < n else None


def destroy() -> None:
    """End this process's default group and free the sharded NTT's
    twiddle shards, which belong to its ranks."""
    drop_twiddle_shards()
    if dist.is_initialized():
        dist.destroy_process_group()
    _STATE["device"] = None
