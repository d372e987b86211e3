"""Carry state across packages: numpy nests → torch tensors on a device.

The JAX package's arrays reach the port as numpy (``np.asarray`` of a
device array): timeline substrates, pipeline carries and, in later
slices, model parameters. :func:`tree_to_torch` places such a nest on a
torch device with its dtypes kept (int32/int64/float64 stay as they
are). :func:`resolve_device` is the one rule for where the port's entry
points run: on the GPU unless the caller asks for the CPU, and never
quietly on the CPU when the GPU was asked for but is missing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

__all__ = ["resolve_device", "tree_to_torch"]


def resolve_device(device) -> torch.device:
    """``torch.device(device)``, raising if it names CUDA and no GPU is
    visible (the port does not carry on on the CPU in that case)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' was requested but torch sees no GPU; pass "
            "device='cpu' to run the port's plain PyTorch path on the CPU")
    return dev


def tree_to_torch(tree, device="cuda"):
    """Map every numpy array (or numpy scalar) of a nest of dicts, lists,
    tuples and dataclasses to a torch tensor on ``device``, dtype kept.

    Other leaves (ints, floats, strings, None) pass through unchanged.
    Dataclass instances are rebuilt with :func:`dataclasses.replace`, so
    frozen ones work too.
    """
    dev = resolve_device(device)

    def conv(x):
        if isinstance(x, np.ndarray | np.generic):
            return torch.from_numpy(np.array(x)).to(dev)
        if isinstance(x, dict):
            return {k: conv(v) for k, v in x.items()}
        if isinstance(x, list | tuple):
            return type(x)(conv(v) for v in x)
        if dataclasses.is_dataclass(x) and not isinstance(x, type):
            return dataclasses.replace(x, **{
                f.name: conv(getattr(x, f.name))
                for f in dataclasses.fields(x) if f.init})
        return x

    return conv(tree)
