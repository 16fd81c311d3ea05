"""Process-group lifecycle and rank queries.

The port of ``horovod_tpu/runtime.py``: one process per card, joined by
``torch.distributed`` (NCCL on CUDA, gloo when the caller asks for the CPU).
The world comes from the launcher's standard environment: ``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR`` and
``MASTER_PORT``. A process started without them is a world of one, whose
rendezvous store listens on a port the OS picks.
"""

from __future__ import annotations

import dataclasses
import datetime
import os

import torch
import torch.distributed as dist


class NotInitializedError(RuntimeError):
    """A runtime query was made before :func:`init`."""


@dataclasses.dataclass(frozen=True)
class _RuntimeState:
    device: torch.device
    rank: int
    size: int
    local_rank: int
    local_size: int
    owns_group: bool  # init() created the process group, shutdown() ends it


_state: _RuntimeState | None = None


def init(device: str | torch.device | None = None) -> None:
    """Join the world (reference ``hvd.init``). ``device`` defaults to the
    card: ``cuda:<LOCAL_RANK>``. Pass ``"cpu"`` for a gloo world on the host.
    Calling it again while initialized is a no-op."""
    global _state
    if _state is not None:
        return
    device = torch.device("cuda" if device is None else device)
    env = os.environ
    rank = int(env.get("RANK", "0"))
    size = int(env.get("WORLD_SIZE", "1"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    local_size = int(env.get("LOCAL_WORLD_SIZE", str(size)))
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "init(): no CUDA device is visible; pass device='cpu' for a "
                "gloo world on the host")
        device = torch.device("cuda", local_rank)
        torch.cuda.set_device(device)
    elif device.type != "cpu":
        raise ValueError(f"init(): unsupported device {device}")
    owns = False
    if not dist.is_initialized():
        backend = "nccl" if device.type == "cuda" else "gloo"
        if "MASTER_ADDR" in env and "MASTER_PORT" in env:
            dist.init_process_group(backend, init_method="env://",
                                    rank=rank, world_size=size)
        elif size == 1:
            # the store binds port 0 itself: no window for another process
            # to take a port picked in advance
            store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                                  timeout=datetime.timedelta(seconds=60))
            dist.init_process_group(backend, store=store, rank=0,
                                    world_size=1)
        else:
            raise RuntimeError(
                f"init(): WORLD_SIZE={size} needs MASTER_ADDR and MASTER_PORT")
        owns = True
    _state = _RuntimeState(device=device, rank=dist.get_rank(),
                           size=dist.get_world_size(), local_rank=local_rank,
                           local_size=local_size, owns_group=owns)


def shutdown() -> None:
    """Leave the world; ends the process group if :func:`init` made it."""
    global _state
    if _state is None:
        return
    if _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _state = None


def is_initialized() -> bool:
    return _state is not None


def _get() -> _RuntimeState:
    if _state is None:
        raise NotInitializedError(
            "horovod_tpu_torch has not been initialized; call hvd.init()")
    return _state


def device() -> torch.device:
    """The device this rank computes and communicates on."""
    return _get().device


def default_device(device: str | torch.device | None = None) -> torch.device:
    """``device`` if given, else the device of :func:`init`'s world, else
    the current card: entry points run on the card unless the caller asks
    for another device."""
    if device is not None:
        return torch.device(device)
    if _state is not None:
        return _state.device
    return torch.device("cuda", torch.cuda.current_device()
                        if torch.cuda.is_available() else 0)


def rank() -> int:
    return _get().rank


def size() -> int:
    return _get().size


def local_rank() -> int:
    return _get().local_rank


def local_size() -> int:
    return _get().local_size


def cross_rank() -> int:
    """Index of this rank's node (homogeneous nodes of ``local_size``)."""
    s = _get()
    return s.rank // s.local_size


def cross_size() -> int:
    s = _get()
    return max(s.size // s.local_size, 1)


def nccl_built() -> bool:
    return dist.is_nccl_available()


def cuda_built() -> bool:
    return torch.backends.cuda.is_built()


def tpu_built() -> bool:
    return False


def xla_built() -> bool:
    return False
