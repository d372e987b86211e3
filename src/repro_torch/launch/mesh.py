"""The shard exchange's mesh: one position per participating host.

:func:`make_exchange_mesh` is a FUNCTION (never a module-level constant),
so importing this module touches no process group and no device.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.convert import resolve_device

__all__ = ["make_exchange_mesh"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def make_exchange_mesh(n_hosts: int | None = None, axis: str = "hosts", *,
                       device="cuda") -> DeviceMesh:
    """1-D mesh over the axis ``axis`` for the shard-exchange collectives
    (:mod:`repro_torch.core.exchange`).

    One position per rank of the default process group; ``n_hosts``
    defaults to its world size and must equal it. Without a default
    process group this sets up a world of one (an in-process
    ``HashStore``: no port is bound). ``device`` picks the backend: NCCL
    on ``"cuda"`` (the default), gloo on ``"cpu"``; asking for CUDA where
    torch sees no GPU raises. A fleet initializes its own process group
    first (``init_process_group`` with its address, world size and rank).
    """
    dev = resolve_device(device)
    if dev.type not in _BACKENDS:
        raise ValueError(f"exchange mesh: unsupported device {dev}")
    if not dist.is_initialized():
        dist.init_process_group(backend=_BACKENDS[dev.type],
                                store=dist.HashStore(), rank=0,
                                world_size=1)
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = world
    if n_hosts != world:
        raise ValueError(f"exchange mesh of {n_hosts} hosts over a world "
                         f"of {world} ranks")
    return init_device_mesh(dev.type, (n_hosts,), mesh_dim_names=(axis,))
