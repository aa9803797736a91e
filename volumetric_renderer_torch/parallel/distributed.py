"""Multi-process initialisation and the ``(hosts, tiles)`` layout.

The JAX package wires a cluster with ``jax.distributed.initialize`` and
builds its mesh over every global device.  Here every rank is one process
on one device, in a ``torch.distributed`` process group: ``nccl`` between
CUDA devices, ``gloo`` on the CPU.  Launch with ``torchrun``, which sets
``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR`` and
``MASTER_PORT``, or pass ``init_method`` (``tcp://host:port`` or
``file:///path``), ``world_size`` and ``rank`` yourself.  Failure model:
fail fast; a crashed rank aborts the job, which restarts from the latest
checkpoint (``utils.checkpoint``).
"""

from __future__ import annotations

import logging
import os
from typing import Optional, Tuple

import torch
import torch.distributed as dist

from volumetric_renderer_torch.parallel.mesh import (
    HOST_AXIS,
    TILE_AXIS,
    group_info,
)

log = logging.getLogger("volumetric_renderer_torch")


def init_distributed(init_method: Optional[str] = None,
                     world_size: Optional[int] = None,
                     rank: Optional[int] = None, *,
                     device=None) -> torch.device:
    """Join the process group of this run; return this rank's device.

    ``device`` is the kind of device the ranks run on (default ``cuda``;
    without a CUDA device that raises, so a run that wants the CPU passes
    ``device="cpu"``); the backend is ``nccl`` for CUDA and ``gloo`` for
    the CPU.  A CUDA rank uses ``cuda:LOCAL_RANK`` (or ``cuda:rank`` modulo
    the device count without ``LOCAL_RANK``).

    With no ``init_method`` and no ``RANK``/``WORLD_SIZE`` in the
    environment this is a single-process run: nothing is initialised and
    ``device`` is returned as given.  An already initialised group is kept.
    """
    device = torch.device("cuda" if device is None else device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"init_distributed: device {device}, but no CUDA "
                           "device is available; pass device='cpu' to run "
                           "on the CPU")
    if dist.is_initialized():
        return _rank_device(device, dist.get_rank())
    env = os.environ
    if init_method is None and not ("RANK" in env and "WORLD_SIZE" in env):
        log.info('{"distributed": "single-process"}')
        return device
    rank = int(env["RANK"]) if rank is None and "RANK" in env else rank
    local = _rank_device(device, rank if rank is not None else 0)
    if local.type == "cuda":
        torch.cuda.set_device(local)
    dist.init_process_group(
        "nccl" if device.type == "cuda" else "gloo",
        init_method=init_method or "env://",
        world_size=-1 if world_size is None else world_size,
        rank=-1 if rank is None else rank)
    log.info('{"distributed": "initialized", "rank": %d, "world": %d, '
             '"backend": "%s"}', dist.get_rank(), dist.get_world_size(),
             dist.get_backend())
    return local


def _rank_device(device: torch.device, rank: int) -> torch.device:
    if device.type != "cuda" or device.index is not None:
        return device
    local = os.environ.get("LOCAL_RANK")
    index = int(local) if local is not None else \
        rank % max(1, torch.cuda.device_count())
    return torch.device("cuda", index)


def pod_mesh(device_type: str, per_host: Optional[int] = None):
    """2D ``(hosts, tiles)`` device mesh over every rank of the default
    group (``torch.distributed.device_mesh.init_device_mesh``).

    ``per_host`` ranks per host (default ``LOCAL_WORLD_SIZE``, which
    ``torchrun`` sets, else every rank on one host).  Image rows shard over
    both axes; a gradient can reduce over ``"tiles"`` within each host and
    then once over ``"hosts"``.
    """
    from torch.distributed.device_mesh import init_device_mesh

    _, _, world = group_info()
    if per_host is None:
        per_host = int(os.environ.get("LOCAL_WORLD_SIZE", world))
    if world % per_host:
        raise ValueError(f"{world} ranks do not split into hosts of "
                         f"{per_host}")
    return init_device_mesh(device_type, (world // per_host, per_host),
                            mesh_dim_names=(HOST_AXIS, TILE_AXIS))


def local_batch_bounds(total_rows: int, group=None) -> Tuple[int, int]:
    """Row range this rank materialises when feeding per-rank data."""
    _, i, n = group_info(group)
    per = -(-total_rows // n)
    return min(total_rows, i * per), min(total_rows, (i + 1) * per)
