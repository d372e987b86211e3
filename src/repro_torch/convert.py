"""Carry state across packages: numpy nests → torch tensors on a device.

The JAX package's arrays reach the port as numpy (``np.asarray`` of a
device array): timeline substrates, pipeline carries, model parameters
and KV caches. :func:`tree_to_torch` places such a nest on a torch device
with its dtypes kept (int32/int64/float64 stay as they are).
:func:`params_from_jax` and :func:`cache_from_jax` turn the reference
model's layer-stacked pytrees into the port's per-layer lists (a list
of lists for zamba2's groups, which the reference stacks on two axes);
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


def _layer_axes(cfg, cache: bool = False) -> dict:
    """The reference's layer-stacked subtrees of a parameter tree (or,
    with ``cache``, of a cache) and the lengths of their leading layer
    axes: ``blocks`` [L], ``pairs`` [L/2], zamba2's ``groups`` [groups,
    attn_every] and ``tail`` [rest]; the hybrid cache's ``shared_attn``
    [groups] (the parameters' shared block is not stacked)."""
    from repro_torch.models.transformer import check_family
    check_family(cfg)
    if cfg.family == "ssm":
        return {"pairs": (cfg.n_layers // 2,)}
    if cfg.family != "hybrid":
        return {"blocks": (cfg.n_layers,)}
    n_groups = cfg.n_layers // cfg.attn_every
    tail = cfg.n_layers - n_groups * cfg.attn_every
    out = {"groups": (n_groups, cfg.attn_every)}
    if tail:
        out["tail"] = (tail,)
    if cache:
        out["shared_attn"] = (n_groups,)
    return out


def _unstack(tree, dims: tuple) -> list:
    """A nest of dicts of tensors stacked on leading layer axes of lengths
    ``dims`` → nested lists (one level per axis) of per-layer nests."""
    if not dims:
        return tree
    n = dims[0]

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
    return [_unstack(pick(tree, i), dims[1:]) for i in range(n)]


def _unstack_layers(tree, cfg, device, cache: bool = False) -> dict:
    out = tree_to_torch(dict(tree), device)
    for k, dims in _layer_axes(cfg, cache).items():
        out[k] = _unstack(out[k], dims)
    return out


def params_from_jax(tree, cfg, device="cuda") -> dict:
    """The reference's ``M.init_params`` pytree, as numpy (``np.asarray``
    of each leaf) → the port's params: the same nest of dicts, with
    each layer-stacked subtree (``blocks``, ``pairs``, ``groups``,
    ``tail``) unstacked into per-layer lists (``groups``: a list of
    groups, each a list of layers); a MoE block's expert stacks keep
    their expert axis ([E, d, ff] per layer). Dtypes are kept (the
    reference's master weights are float32)."""
    return _unstack_layers(tree, cfg, device)


def cache_from_jax(cache, cfg, device="cuda") -> dict:
    """The reference's cache (``init_cache``/``prefill``/``decode_step``'s
    tree), as numpy → the port's per-layer lists (KV leaves [L, B, KV,
    T, dh] → per layer [B, KV, T, dh]; recurrent state likewise), dtype
    kept."""
    return _unstack_layers(cache, cfg, device, cache=True)


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


def _stack(layers: list, dims: tuple):
    """Nested lists of per-layer nests, of lengths ``dims`` → one nest
    stacked on leading axes of those lengths."""
    if len(layers) != dims[0]:
        raise ValueError(f"{len(layers)} layers, expected {dims[0]}")
    if len(dims) > 1:
        layers = [_stack(x, dims[1:]) for x in layers]
    if isinstance(layers[0], dict):
        return {k: _stack([x[k] for x in layers], dims[:1])
                for k in layers[0]}
    return np.stack(layers)


def _params_to_jax(p, cfg) -> dict:
    out = tree_map(lambda t: t.detach().to("cpu").numpy(), p)
    for k, dims in _layer_axes(cfg).items():
        out[k] = _stack(out[k], dims)
    return out


def train_state_to_jax(state, cfg) -> dict:
    """The port's train state → the reference's, as numpy, with the
    per-layer lists stacked on leading layer axes (the inverse of
    :func:`train_state_from_jax`)."""
    out = {"params": _params_to_jax(state["params"], cfg),
           "opt": {"mu": _params_to_jax(state["opt"]["mu"], cfg),
                   "nu": _params_to_jax(state["opt"]["nu"], cfg),
                   "step": state["opt"]["step"].detach().to("cpu").numpy()}}
    if "residuals" in state:
        out["residuals"] = _params_to_jax(state["residuals"], cfg)
    return out
