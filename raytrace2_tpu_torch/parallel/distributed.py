"""Multi-process runtime glue (port of ``raytrace2_tpu/parallel/distributed.py``).

Where the JAX package calls ``jax.distributed.initialize`` and builds one
global mesh, the port starts a ``torch.distributed`` process group with one
card per rank. Configuration comes from the arguments or, when they are
absent, from the variables ``torchrun`` sets (``WORLD_SIZE``, ``RANK``,
``MASTER_ADDR``/``MASTER_PORT``); a single process with neither is left
alone, so the same entry points run everywhere.

The backend is named by the caller: ``nccl`` for CUDA tensors across cards,
``gloo`` for the CPU (and for two ranks sharing one card, which NCCL
refuses). Nothing is chosen for it.
"""

from __future__ import annotations

import datetime
import os

import torch
import torch.distributed as dist

BACKENDS = ("nccl", "gloo")


def initialize(backend: str | None = None, init_method: str | None = None,
               world_size: int | None = None, rank: int | None = None,
               timeout_s: float | None = None) -> None:
    """Start the default process group if configured; a no-op otherwise
    (JAX ``distributed.initialize``, :18-34), and when one is running.

    ``init_method`` (``tcp://host:port`` or ``file:///path``) defaults to
    torchrun's ``env://`` when ``MASTER_ADDR`` is set; with neither, a
    single process runs alone and nothing starts. ``timeout_s`` bounds each
    collective, so that a rank whose peer died fails instead of hanging."""
    if dist.is_initialized():
        return
    if init_method is None:
        if "MASTER_ADDR" not in os.environ:
            return  # a single process
        init_method = "env://"
    if backend not in BACKENDS:
        raise ValueError(f"backend must be one of {BACKENDS} (nccl for CUDA, gloo for the "
                         f"CPU), got {backend!r}")
    world_size = int(world_size if world_size is not None else os.environ.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else os.environ.get("RANK", 0))
    kw = {} if timeout_s is None else {"timeout": datetime.timedelta(seconds=timeout_s)}
    dist.init_process_group(backend, init_method=init_method, world_size=world_size,
                            rank=rank, **kw)


def shutdown() -> None:
    """Destroy the default process group, if one runs."""
    if dist.is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def is_primary() -> bool:
    return process_index() == 0


def global_device_count() -> int:
    """The world size: each rank drives one card (or one CPU device)."""
    return dist.get_world_size() if dist.is_initialized() else 1


def local_device(device="cuda") -> torch.device:
    """This rank's device: ``cuda`` without an index becomes
    ``cuda:LOCAL_RANK`` (torchrun's variable; else the rank) modulo the
    cards present; any other device is returned as given."""
    device = torch.device(device)
    if device.type == "cuda" and device.index is None:
        local = int(os.environ.get("LOCAL_RANK", process_index()))
        return torch.device("cuda", local % max(torch.cuda.device_count(), 1))
    return device
