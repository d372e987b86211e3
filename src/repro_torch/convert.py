"""Carry state across packages: numpy nests → torch tensors on a device.

The JAX package's arrays reach the port as numpy (``np.asarray`` of a
device array): timeline substrates, pipeline carries, model parameters
and KV caches. :func:`tree_to_torch` places such a nest on a torch device
with its dtypes kept (int32/int64/float64 stay as they are).
:func:`params_from_jax` and :func:`cache_from_jax` turn the reference
model's layer-stacked pytrees into the port's per-layer lists;
:func:`train_state_from_jax` and :func:`train_state_to_jax` carry a train
state (parameters, AdamW moments and step, compression residuals) across
in both directions.
:func:`resolve_device` is the one rule for where the port's entry points
run: on the GPU unless the caller asks for the CPU, and never quietly on
the CPU when the GPU was asked for but is missing.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["cache_from_jax", "params_from_jax", "resolve_device",
           "train_state_from_jax", "train_state_to_jax", "tree_to_torch"]


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
            if x.dtype.name == "bfloat16":
                # numpy has no native bfloat16: JAX's arrives as
                # ml_dtypes.bfloat16, which torch.from_numpy rejects, so
                # it goes through float32 (exact) and back.
                return torch.from_numpy(np.asarray(x, np.float32)).to(
                    dev, dtype=torch.bfloat16)
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


def _unstack(tree, n: int) -> list:
    """A nest of dicts of tensors stacked on a leading layer axis of
    length ``n`` → a list of ``n`` nests of per-layer tensors."""
    def check(x):
        if isinstance(x, dict):
            return all(check(v) for v in x.values())
        if x.shape[0] != n:
            raise ValueError(f"leading layer axis is {x.shape[0]}, "
                             f"expected {n}")
        return True

    def pick(x, i):
        if isinstance(x, dict):
            return {k: pick(v, i) for k, v in x.items()}
        return x[i]
    check(tree)
    return [pick(tree, i) for i in range(n)]


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """The reference's ``M.init_params`` pytree, as numpy (``np.asarray``
    of each leaf) → the port's params: the same nest of dicts, with
    ``blocks`` unstacked from its leading layer axis into a list of
    per-layer dicts; a MoE block's expert stacks keep their expert axis
    ([E, d, ff] per layer). Dtypes are kept (the reference's master
    weights are float32). The families the port's models run
    (:func:`repro_torch.models.transformer.check_family` raises for the
    others)."""
    from repro_torch.models.transformer import check_family
    check_family(cfg)
    p = tree_to_torch(dict(tree), device)
    p["blocks"] = _unstack(p["blocks"], cfg.n_layers)
    return p


def cache_from_jax(cache, cfg, device="cuda") -> dict:
    """The reference's KV cache ``{"blocks": {"k", "v"}}``, as numpy,
    with [L, B, KV, T, dh] leaves (bfloat16 by default) → the port's
    ``{"blocks": [{"k", "v"} per layer]}``, dtype kept."""
    return {"blocks": _unstack(tree_to_torch(cache["blocks"], device),
                               cfg.n_layers)}


def train_state_from_jax(state, cfg, device="cuda") -> dict:
    """The reference's train state ``{"params", "opt": {"mu", "nu",
    "step"}[, "residuals"]}``, as numpy → the port's: every parameter-
    shaped tree unstacked as :func:`params_from_jax` does, the step an
    int32 scalar tensor. The parameters require grad, as
    ``train.step.init_state``'s do."""
    out = {"params": params_from_jax(state["params"], cfg, device),
           "opt": {"mu": params_from_jax(state["opt"]["mu"], cfg, device),
                   "nu": params_from_jax(state["opt"]["nu"], cfg, device),
                   "step": tree_to_torch(np.asarray(state["opt"]["step"]),
                                         device)}}
    if "residuals" in state:
        out["residuals"] = params_from_jax(state["residuals"], cfg, device)
    for t in tree_leaves(out["params"]):
        t.requires_grad_()
    return out


def _stack(layers: list):
    """A list of per-layer nests → one nest stacked on a leading axis."""
    if isinstance(layers[0], dict):
        return {k: _stack([x[k] for x in layers]) for k in layers[0]}
    return np.stack(layers)


def _params_to_jax(p, cfg) -> dict:
    out = tree_map(lambda t: t.detach().to("cpu").numpy(), p)
    if len(out["blocks"]) != cfg.n_layers:
        raise ValueError(f"{len(out['blocks'])} blocks, expected "
                         f"{cfg.n_layers}")
    out["blocks"] = _stack(out["blocks"])
    return out


def train_state_to_jax(state, cfg) -> dict:
    """The port's train state → the reference's, as numpy, with the
    blocks stacked on a leading layer axis (the inverse of
    :func:`train_state_from_jax`)."""
    out = {"params": _params_to_jax(state["params"], cfg),
           "opt": {"mu": _params_to_jax(state["opt"]["mu"], cfg),
                   "nu": _params_to_jax(state["opt"]["nu"], cfg),
                   "step": state["opt"]["step"].detach().to("cpu").numpy()}}
    if "residuals" in state:
        out["residuals"] = _params_to_jax(state["residuals"], cfg)
    return out
