"""Multi-process runtime over ``torch.distributed``.

Counterpart of ``gpuraytracer_tpu/parallel/multihost.py``. Each rank is one
process with one device: ``init_distributed`` joins the process group, the
sharded renderers (``parallel/mesh.py``, ``parallel/fast.py``) render a slice
of the pixels on that device and gather the whole image on every rank, and
rank 0 writes it.

All of this degrades to a single process: ``init_distributed`` does nothing
and returns False when no coordinator is configured, ``sync_hosts`` is a
no-op at world size 1.
"""
from __future__ import annotations

import datetime
import os
import socket
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..utils.host import fetch, resolve_device

# A rank that waits longer than this on a collective raises instead of
# hanging (a peer died, or the ranks issued different collectives).
TIMEOUT = datetime.timedelta(minutes=5)


def _env_int(name: str) -> Optional[int]:
    value = os.environ.get(name)
    return None if value is None else int(value)


def _coordinator_from_env() -> Optional[str]:
    addr = os.environ.get("MASTER_ADDR")
    if not addr:
        return None
    return f"tcp://{addr}:{os.environ.get('MASTER_PORT', '29500')}"


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None,
                     backend: Optional[str] = None,
                     device="cuda") -> bool:
    """Join the process group of a multi-process run.

    The arguments default from torch's launcher environment (``torchrun``):
    ``MASTER_ADDR`` / ``MASTER_PORT``, ``WORLD_SIZE``, ``RANK``; the rank's
    card is ``cuda:{LOCAL_RANK % device_count}`` (``LOCAL_RANK`` defaults to
    the rank), made the current device, or the CPU where ``device`` says so.
    ``coordinator_address`` is ``host:port`` or a ``tcp://`` URL.

    ``backend``: None takes ``nccl`` on cards and ``gloo`` on the CPU. NCCL
    needs a card of its own for every rank on a host: where more ranks than
    cards would share them it raises ``ValueError``; pass ``backend="gloo"``
    to let ranks share a card (its collectives then go through the host).

    Returns True once the group is joined, False (and does nothing) when no
    coordinator is configured: single-process operation."""
    coordinator_address = coordinator_address or _coordinator_from_env()
    if not coordinator_address:
        return False
    if "://" not in coordinator_address:
        coordinator_address = f"tcp://{coordinator_address}"
    world = num_processes if num_processes is not None \
        else _env_int("WORLD_SIZE")
    rank = process_id if process_id is not None else _env_int("RANK")
    if world is None or rank is None:
        raise ValueError("init_distributed needs the world size and the rank "
                         "(arguments, or WORLD_SIZE and RANK)")
    device = resolve_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    if device.type == "cuda":
        count = torch.cuda.device_count()
        local_rank = _env_int("LOCAL_RANK")
        local_rank = rank if local_rank is None else local_rank
        local_world = _env_int("LOCAL_WORLD_SIZE") or world
        if backend == "nccl" and local_world > count:
            raise ValueError(
                f"{local_world} ranks on a host with {count} card(s): NCCL "
                "needs a card of its own for every rank; pass "
                "backend='gloo' to let ranks share a card")
        torch.cuda.set_device(local_rank % count)
    elif backend == "nccl":
        raise ValueError("the nccl backend needs device='cuda'")
    dist.init_process_group(backend, init_method=coordinator_address,
                            world_size=world, rank=rank, timeout=TIMEOUT)
    return True


def free_port() -> int:
    """A TCP port free on localhost now, for a coordinator address."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def is_primary() -> bool:
    """True on the rank that writes files (rank 0, or the only process)."""
    return not dist.is_initialized() or dist.get_rank() == 0


def gather_image(x: torch.Tensor) -> np.ndarray:
    """The whole image on the host of every rank.

    The sharded renderers return the gathered global image on every rank
    already (``mesh.gather``), so this is the device -> host read."""
    return fetch(x)


def sync_hosts(name: str = "barrier") -> None:
    """Barrier across all ranks (around checkpoints and timed windows); a
    no-op in a single process. ``name`` labels the call site."""
    del name
    if dist.is_initialized() and dist.get_world_size() > 1:
        dist.barrier()
