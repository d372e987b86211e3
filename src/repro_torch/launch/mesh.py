"""Mesh construction: the production meshes, the small test mesh, the
launcher's ``--mesh`` and the shard exchange's mesh.

Port of ``src/repro/launch/mesh.py``. Every mesh is a ``DeviceMesh``
with named dims over the default process group, whose world size must
equal the product of the dims (a mismatch raises). Without a default
process group one is set up, NCCL on ``"cuda"`` (the default) and gloo
on ``"cpu"``: from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``,
``MASTER_ADDR``, ``MASTER_PORT``) when it is set, else a world of one in
process (an in-process ``HashStore``: no port is bound). A fleet may
also initialize its own first (``init_process_group`` with its address,
world size and rank), and the dry run a fake one of 256 or 512 ranks. Meshes are
made by FUNCTIONS (never module-level constants), so importing this
module touches no process group and no device. The reference's
``axis_types_kwargs`` / ``make_mesh_compat`` are JAX-version shims and
have no counterpart.
"""

from __future__ import annotations

import math
import os
from typing import Sequence

import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh

from repro_torch.convert import resolve_device
from repro_torch.sharding.rules import mesh_shape

__all__ = ["make_production_mesh", "make_small_mesh", "make_exchange_mesh",
           "dp_axes_for", "make_mesh", "parse_mesh"]

_BACKENDS = {"cuda": "nccl", "cpu": "gloo"}


def _ensure_world(device) -> torch.device:
    """The mesh's device; sets up a world of one when no default process
    group exists."""
    dev = resolve_device(device)
    if dev.type not in _BACKENDS and dev.type != "meta":
        raise ValueError(f"mesh: unsupported device {dev}")
    if not dist.is_initialized():
        if dev.type == "meta":
            raise ValueError("mesh on 'meta': initialize a (fake) process "
                             "group first")
        if "RANK" in os.environ and "WORLD_SIZE" in os.environ:
            # a launcher's ranks (torchrun): its address, rank and size
            dist.init_process_group(backend=_BACKENDS[dev.type],
                                    init_method="env://")
        else:
            dist.init_process_group(backend=_BACKENDS[dev.type],
                                    store=dist.HashStore(), rank=0,
                                    world_size=1)
    return dev


def make_mesh(shape: Sequence[int], axes: Sequence[str], *,
              device="cuda") -> DeviceMesh:
    """A ``DeviceMesh`` of ``shape`` with dims named ``axes`` over the
    default process group (set up as a world of one when there is none).
    The world size must equal the product of ``shape``. ``device``
    ``"meta"`` makes a mesh of CPU device type for the dry run's fake
    process group."""
    shape, axes = tuple(int(n) for n in shape), tuple(axes)
    if len(shape) != len(axes):
        raise ValueError(f"mesh shape {shape} and axes {axes} differ in "
                         f"length")
    dev = _ensure_world(device)
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh {'x'.join(map(str, shape))} "
                         f"({math.prod(shape)} positions) over a world of "
                         f"{world} ranks")
    dtype = "cpu" if dev.type == "meta" else dev.type
    return init_device_mesh(dtype, shape, mesh_dim_names=axes)


def make_production_mesh(*, multi_pod: bool = False, device="cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def make_small_mesh(data: int = 1, model: int = 1, *, device="cuda"):
    """Tiny mesh for tests (world size permitting)."""
    return make_mesh((data, model), ("data", "model"), device=device)


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
    _ensure_world(dev)
    world = dist.get_world_size()
    if n_hosts is None:
        n_hosts = world
    if n_hosts != world:
        raise ValueError(f"exchange mesh of {n_hosts} hosts over a world "
                         f"of {world} ranks")
    return init_device_mesh(dev.type, (n_hosts,), mesh_dim_names=(axis,))


def dp_axes_for(mesh) -> tuple[str, ...]:
    """The data-parallel axes present in a mesh (pod spans pods)."""
    names = mesh_shape(mesh)
    return tuple(a for a in ("pod", "data") if a in names)


def parse_mesh(spec: str | None, *, device="cuda"):
    """The launcher's ``--mesh``: ``DxM`` → a ("data", "model") mesh,
    ``PxDxM`` → ("pod", "data", "model"); None for no spec."""
    if not spec:
        return None
    dims = tuple(int(x) for x in spec.split("x"))
    axes = ("data", "model") if len(dims) == 2 else ("pod", "data", "model")
    return make_mesh(dims, axes, device=device)
