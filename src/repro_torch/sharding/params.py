"""Parameter / cache / batch specs by tree path, and the DTensors they
describe.

Port of ``src/repro/sharding/params.py``. Rules give logical axes for the
*trailing* dims of each named leaf; any extra leading dims are
replicated automatically. Every mapped dim is divisibility-checked
against the mesh extent and degrades to replicated when it doesn't
divide (e.g. 4 KV heads on a 16-way model axis).

The port's trees hold the layer axis unstacked into lists (a path reads
``blocks/0/attn/wq``; zamba2's ``groups/0/1/ssm/in_x``), so a leaf has
no stacked leading axes: its spec is the reference's spec for the
stacked leaf with the stacked entries dropped. :func:`to_shardings` turns
a spec tree into per-leaf DTensor placements and :func:`distribute`
builds the DTensors.
"""

from __future__ import annotations

import re
from typing import Any

import torch

from repro_torch.sharding.rules import AxisRules, P, mesh_shape, placements

__all__ = ["param_specs", "cache_specs", "batch_specs", "spec_for_path",
           "to_shardings", "distribute"]

# (regex on '/'-joined path, logical axes for trailing dims)
_PARAM_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)embed$", (None, "embed_shard")),
    (r"(^|/)lm_head$", (None, "vocab")),
    (r"/attn/w[qkv]$", (None, "heads")),
    (r"/attn/wo$", ("heads", None)),
    (r"/mlp/(up|gate)$", (None, "q_ff")),
    (r"/mlp/down$", ("q_ff", None)),
    (r"/moe/(up|gate|down)$", ("experts", None, None)),
    (r"/moe/router$", (None, None)),
    (r"/ssm/in_[xz]$", (None, "conv_dim")),
    (r"/ssm/out$", ("conv_dim", None)),
    (r"/ssm/conv_x$", (None, "conv_dim")),
    (r"/ssm/in_dt$", (None, "ssm_heads")),
    (r"/ssm/(A_log|D|dt_bias)$", ("ssm_heads",)),
    (r"/ssm/norm/scale$", ("conv_dim",)),
    # xLSTM inner projections replicate (125M model, heads < TP width).
]

_CACHE_RULES: list[tuple[str, tuple]] = [
    (r"(^|/)[kv]$", ("batch", "kv_heads", "kv_seq", None)),
    (r"(^|/)h$", ("batch", "ssm_heads", None, None)),
    (r"(^|/)conv_x$", ("batch", None, "conv_dim")),
    (r"(^|/)conv_bc$", ("batch", None, None)),
    (r"(^|/)C$", ("batch", None, None, None)),
    (r"(^|/)n$", ("batch", None, None)),
    (r"(^|/)m$", ("batch", None)),
    (r"(^|/)[cnh]$", ("batch", None)),
]


def _walk(tree, fn, path: tuple = ()):
    """``tree`` with ``fn(path, leaf)`` at each leaf; ``path`` holds dict
    keys and list indices."""
    if isinstance(tree, dict):
        return {k: _walk(v, fn, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(v, fn, path + (i,))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(path, tree)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


def _extent(rules: AxisRules, mesh_axes) -> int:
    if mesh_axes is None or rules.mesh is None:
        return 1
    axes = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
    shape = mesh_shape(rules.mesh)
    e = 1
    for a in axes:
        e *= shape[a]
    return e


def _safe_spec(shape: tuple[int, ...], trailing: tuple, rules: AxisRules) -> P:
    """Pad leading None; drop axes that don't divide the mesh extent."""
    n_lead = len(shape) - len(trailing)
    if n_lead < 0:          # leaf has fewer dims than the rule (edge case)
        trailing = trailing[-len(shape):] if len(shape) else ()
        n_lead = len(shape) - len(trailing)
    dims: list = [None] * n_lead
    for size, logical in zip(shape[n_lead:], trailing):
        mesh_axes = None if logical is None else rules.mapping.get(logical)
        if mesh_axes is not None and size % _extent(rules, mesh_axes) != 0:
            mesh_axes = None
        dims.append(mesh_axes)
    return P(*dims)


def spec_for_path(path_str: str, shape: tuple[int, ...],
                  rules: AxisRules,
                  rule_table: list[tuple[str, tuple]] | None = None) -> P:
    for pat, trailing in (rule_table or _PARAM_RULES):
        if re.search(pat, path_str):
            return _safe_spec(shape, trailing, rules)
    return P(*([None] * len(shape)))            # replicate by default


def _add_fsdp(spec: P, shape: tuple[int, ...], rules: AxisRules,
              dp_axes: tuple[str, ...], min_size: int) -> P:
    """ZeRO/FSDP: additionally shard the largest unmapped dim over the DP
    axes (params + optimizer states). DTensor then all-gathers weights at
    use sites and reduce-scatters grads."""
    if not dp_axes or not shape:
        return spec
    extent = 1
    mshape = mesh_shape(rules.mesh)
    for a in dp_axes:
        extent *= mshape[a]
    dims = list(spec)
    # biggest eligible dim first (skip tiny leaves: not worth the gather)
    order = sorted(range(len(shape)), key=lambda i: -shape[i])
    for i in order:
        if dims[i] is None and shape[i] % extent == 0 and shape[i] >= min_size:
            dims[i] = dp_axes[0] if len(dp_axes) == 1 else tuple(dp_axes)
            return P(*dims)
    return spec


def _shape(leaf) -> tuple[int, ...]:
    return tuple(leaf.shape) if hasattr(leaf, "shape") else ()


def param_specs(params: Any, rules: AxisRules, *, fsdp: bool = False,
                fsdp_min_size: int = 1024) -> Any:
    """Spec tree matching ``params`` (any tree with parameter paths: a
    train state's ``params``, ``opt/mu``, ``opt/nu`` and ``residual``
    subtrees match the same rules).

    fsdp=True additionally shards each large leaf over the DP axes (ZeRO-3
    posture for train states; leave False for serving params).
    """
    dp = rules.mapping.get("batch") if fsdp else None
    dp_axes: tuple[str, ...] = ()
    if dp is not None and rules.mesh is not None:
        dp_axes = (dp,) if isinstance(dp, str) else tuple(dp)

    def one(path, leaf):
        s = spec_for_path(_path_str(path), _shape(leaf), rules)
        if fsdp and dp_axes:
            s = _add_fsdp(s, _shape(leaf), rules, dp_axes, fsdp_min_size)
        return s
    return _walk(params, one)


def cache_specs(cache: Any, rules: AxisRules) -> Any:
    def one(path, leaf):
        return spec_for_path(_path_str(path), _shape(leaf), rules,
                             rule_table=_CACHE_RULES)
    return _walk(cache, one)


def batch_specs(batch: Any, rules: AxisRules) -> Any:
    """Input batches: leading batch dim over DP axes (if divisible)."""
    def one(_, leaf):
        shape = _shape(leaf)
        trailing = ("batch",) + (None,) * (len(shape) - 1)
        return _safe_spec(shape, trailing, rules)
    return _walk(batch, one)


def _is_spec(x) -> bool:
    return isinstance(x, P)


def _map_specs(fn, spec_tree):
    if _is_spec(spec_tree):
        return fn(spec_tree)
    if isinstance(spec_tree, dict):
        return {k: _map_specs(fn, v) for k, v in spec_tree.items()}
    if isinstance(spec_tree, (list, tuple)):
        return type(spec_tree)(_map_specs(fn, v) for v in spec_tree)
    return spec_tree


def to_shardings(spec_tree: Any, rules: AxisRules) -> Any:
    """Per-leaf DTensor placements of a spec tree on ``rules.dmesh``
    (None without a mesh)."""
    if rules.mesh is None:
        return None
    mesh = rules.dmesh
    return _map_specs(lambda s: placements(s, mesh), spec_tree)


def _local_shape(shape, pl, mesh) -> tuple[int, ...]:
    out = list(shape)
    for place, n in zip(pl, mesh.mesh.shape):
        if place.is_shard():
            out[place.dim] //= int(n)
    return tuple(out)


def distribute(tree: Any, specs: Any, rules: AxisRules) -> Any:
    """``tree`` with every tensor leaf a DTensor on ``rules.dmesh`` placed
    by its spec (a scalar leaf, e.g. a train state's step, stays a plain
    tensor: under ``axis_rules`` plain tensors count as replicated). Every rank holds the same full tensors (the port draws its
    weights from one seed), so each keeps its own shard and nothing is
    sent; a meta tensor becomes a meta DTensor of the same global shape
    (the dry run's parameters)."""
    from torch.distributed.tensor import DTensor, distribute_tensor

    mesh = rules.dmesh
    pls = to_shardings(specs, rules)

    def one(t, pl):
        if (not isinstance(t, torch.Tensor) or isinstance(t, DTensor)
                or t.ndim == 0):
            return t
        if t.device.type == "meta":
            local = torch.empty(_local_shape(t.shape, pl, mesh),
                                dtype=t.dtype, device="meta")
            return DTensor.from_local(local, mesh, pl, run_check=False,
                                      shape=t.shape, stride=t.stride())
        out = distribute_tensor(t.detach(), mesh, pl, src_data_rank=None)
        return out.requires_grad_(t.requires_grad)

    def walk(t, pl):
        if isinstance(t, dict):
            return {k: walk(v, pl[k]) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return type(t)(walk(v, q) for v, q in zip(t, pl))
        return one(t, pl)
    return walk(tree, pls)

