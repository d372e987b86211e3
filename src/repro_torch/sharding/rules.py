"""Logical-axis sharding rules (DP/TP/EP/SP) over a DTensor mesh.

Port of ``src/repro/sharding/rules.py``. Model code never names mesh
axes; it constrains activations by *logical* axes
(``constrain(x, "batch", "seq", "embed")``) and parameters get specs from
:func:`repro_torch.sharding.params.param_specs` by tree path. A per-run
:class:`AxisRules` maps logical axes → mesh axes, chosen by the launcher
from (arch, shape, mesh):

  batch    → ("pod", "data")     data parallelism (both DP axes)
  embed    → None                activations replicated on features (Megatron)
  heads    → "model"             TP over attention heads / SSM heads
  kv_heads → "model" if divisible else None (GQA groups < model shards)
  q_ff     → "model"             column-parallel FFN
  experts  → "model"             expert parallelism
  vocab    → "model"             vocab-parallel logits + loss
  kv_seq   → decode: "model" (flash-decoding split-K) or DP axes for batch=1
  seq      → None (training); "model"-sharded variants are a §Perf knob

Unmappable axes (size not divisible by the mesh axis) degrade to None
(replicated) with a warning collected for the dry-run report.

What JAX does with a ``PartitionSpec`` and ``with_sharding_constraint``
the port does with DTensor: :class:`P` is the spec (one entry per tensor
dim: a mesh axis name, a tuple of them, or None), :func:`placements`
turns it into one ``Shard(d)`` / ``Replicate()`` per mesh dim, and
:func:`constrain` redistributes a DTensor to the rules' placements.

A dim mapped to several mesh axes is split over them major to minor, as
JAX splits it. The rules' only such entry is ``batch → ("pod",
"data")``, and every use of pod and data is that pair (batch, and FSDP
over the DP axes), so the DTensors live on :meth:`AxisRules.dmesh`, the
mesh with such a pair of adjacent axes flattened into one dim named
``"pod+data"`` (major to minor: the same blocks as JAX's). One mesh dim
per tensor dim also keeps DTensor's sharding propagation on its fast
path: over a 3-D mesh with a dim sharded twice it plans each new op's
redistributions by a graph search that takes minutes.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with named
dims (:mod:`repro_torch.launch.mesh`); the rules read its
``mesh_dim_names`` and sizes only.
"""

from __future__ import annotations

import contextlib
import math
import threading
from typing import Iterator, Sequence

import torch

__all__ = ["AxisRules", "P", "axis_rules", "block_of", "blockwise",
           "constrain", "current_rules", "psum_whole",
           "under_current_rules", "whole_middle", "whole_middle_grad",
           "logical_spec", "make_rules", "mesh_shape", "placements"]


class P(tuple):
    """A partition spec: one entry per tensor dim, each a mesh axis name,
    a tuple of names, or None (replicated). Equal to the tuple of its
    entries (``P("data", None) == ("data", None)``)."""

    def __new__(cls, *dims):
        return super().__new__(cls, dims)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"


def mesh_shape(mesh) -> dict[str, int]:
    """{axis name: size} of a named ``DeviceMesh`` (JAX's ``mesh.shape``),
    or of any object with a ``shape`` dict."""
    if mesh is None:
        return {}
    names = getattr(mesh, "mesh_dim_names", None)
    if names is not None:
        return dict(zip(names, mesh.mesh.shape))
    return dict(mesh.shape)


def _axes(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Sequence, mesh) -> tuple:
    """The DTensor placements of ``spec`` on ``mesh``: per mesh dim,
    ``Shard(d)`` for the tensor dim ``d`` whose entry names it (a tuple
    entry names the flattened dim of :meth:`AxisRules.dmesh` when the
    mesh has it), else ``Replicate()``. A mesh axis named by two entries,
    an unknown axis name, or a tuple entry whose axes are not in the
    mesh's order raises ``ValueError``."""
    from torch.distributed.tensor import Replicate, Shard

    names = tuple(mesh.mesh_dim_names)
    out: list = [Replicate()] * len(names)
    seen: set[str] = set()
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if len(axes) > 1 and "+".join(axes) in names:
            axes = ("+".join(axes),)
        idx = []
        for a in axes:
            if a not in names:
                raise ValueError(f"spec {tuple(spec)}: mesh has no axis "
                                 f"{a!r} (axes {names})")
            if a in seen:
                raise ValueError(f"spec {tuple(spec)}: mesh axis {a!r} is "
                                 f"used twice")
            seen.add(a)
            idx.append(names.index(a))
        if idx != sorted(idx):
            raise ValueError(f"spec {tuple(spec)}: entry {axes} must list "
                             f"its mesh axes major to minor {names}")
        for i in idx:
            out[i] = Shard(d)
    return tuple(out)


class AxisRules:
    """Mapping from logical axis names to mesh axis names (or tuples)."""

    def __init__(self, mesh, mapping: dict[str, object]):
        self.mesh = mesh
        self.mapping = dict(mapping)
        self.warnings: list[str] = []

    def spec(self, *logical: str | None) -> P:
        """PartitionSpec for logical axes; a mesh axis may appear once, so
        later duplicates degrade to replicated (e.g. context-parallel
        ``seq``→model colliding with ``vocab``→model on logits)."""
        used: set[str] = set()
        dims: list = []
        for ax in logical:
            mesh_axes = self.mapping.get(ax) if ax else None
            if mesh_axes is not None:
                flat = ((mesh_axes,) if isinstance(mesh_axes, str)
                        else tuple(mesh_axes))
                if any(a in used for a in flat):
                    mesh_axes = None
                else:
                    used.update(flat)
            dims.append(mesh_axes)
        return P(*dims)

    def placements(self, *logical: str | None) -> tuple | None:
        """DTensor placements of :meth:`spec` on :meth:`dmesh` (None
        without a mesh)."""
        if self.mesh is None:
            return None
        return placements(self.spec(*logical), self.dmesh)

    @property
    def dmesh(self):
        """The mesh the DTensors live on: :attr:`mesh` with each mapped
        tuple of several adjacent axes (``("pod", "data")``) flattened
        into one dim ``"pod+data"``; :attr:`mesh` itself when there is
        none. Made once per (mesh, flattening) and shared: making it is
        collective (every rank creates the new dim's process group)."""
        if self.mesh is None:
            return None
        groups = sorted({tuple(v) for v in self.mapping.values()
                         if isinstance(v, (tuple, list)) and len(v) > 1})
        return _flat_mesh(self.mesh, tuple(groups))

    def resolve_divisibility(self, sizes: dict[str, int]) -> "AxisRules":
        """Drop mappings whose dim size isn't divisible by the mesh extent."""
        if self.mesh is None:
            return self
        shape = mesh_shape(self.mesh)
        new = dict(self.mapping)
        for ax, size in sizes.items():
            mesh_axes = new.get(ax)
            if mesh_axes is None:
                continue
            axes = (mesh_axes,) if isinstance(mesh_axes, str) else tuple(mesh_axes)
            extent = 1
            for a in axes:
                extent *= shape[a]
            if size % extent != 0:
                self.warnings.append(
                    f"logical axis {ax!r} (size {size}) not divisible by mesh "
                    f"extent {extent}; replicating")
                new[ax] = None
        r = AxisRules(self.mesh, new)
        r.warnings = self.warnings
        return r


_FLAT: dict = {}


def _flat_mesh(mesh, groups: tuple):
    if not groups:
        return mesh
    key = (id(mesh), groups)
    if key in _FLAT:
        return _FLAT[key][1]
    from torch.distributed.device_mesh import DeviceMesh

    names = list(mesh.mesh_dim_names)
    ranks = mesh.mesh
    for g in groups:
        idx = [names.index(a) for a in g]
        if idx != list(range(idx[0], idx[0] + len(idx))):
            raise ValueError(f"mesh axes {g} are not adjacent and in the "
                             f"mesh's order {tuple(names)}")
        shape = list(ranks.shape)
        shape[idx[0]:idx[-1] + 1] = [math.prod(shape[idx[0]:idx[-1] + 1])]
        ranks = ranks.reshape(shape)
        names[idx[0]:idx[-1] + 1] = ["+".join(g)]
    flat = DeviceMesh(mesh.device_type, ranks, mesh_dim_names=tuple(names))
    _FLAT[key] = (mesh, flat)       # keeps ``mesh`` alive, so id() holds
    return flat


_tls = threading.local()


def current_rules() -> AxisRules | None:
    return getattr(_tls, "rules", None)


@contextlib.contextmanager
def axis_rules(rules: AxisRules | None) -> Iterator[None]:
    """Make ``rules`` current in this thread. With a mesh, plain tensors
    meeting DTensors count as replicated meanwhile (DTensor's implicit
    replication: the model's own index and mask tensors are the same on
    every rank)."""
    prev = current_rules()
    _tls.rules = rules
    dispatcher = None
    if rules is not None and rules.mesh is not None:
        from torch.distributed.tensor import DTensor
        dispatcher = DTensor._op_dispatcher
        prev_implicit = dispatcher._allow_implicit_replication
        dispatcher._allow_implicit_replication = True
    try:
        yield
    finally:
        _tls.rules = prev
        if dispatcher is not None:
            dispatcher._allow_implicit_replication = prev_implicit


def under_current_rules(fn):
    """``fn`` wrapped to run under the rules current now, in whatever
    thread calls it later (an activation checkpoint's recomputation runs
    on the autograd engine's thread)."""
    rules = current_rules()

    def run(*args, **kwargs):
        with axis_rules(rules):
            return fn(*args, **kwargs)
    return run


def logical_spec(*logical: str | None) -> P:
    r = current_rules()
    if r is None:
        return P(*[None] * len(logical))
    return r.spec(*logical)


def constrain(x: torch.Tensor, *logical: str | None) -> torch.Tensor:
    """Redistribute a DTensor to the rules' placements for ``logical``
    (``with_sharding_constraint``); a no-op on a plain tensor and outside
    :func:`axis_rules`. The redistribution is differentiable: its
    backward redistributes the gradient back."""
    r = current_rules()
    if r is None or r.mesh is None or type(x) is torch.Tensor:
        return x
    from torch.distributed.tensor import DTensor
    if not isinstance(x, DTensor):
        return x
    want = placements(r.spec(*logical), x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


# -- default rule sets ---------------------------------------------------------

def make_rules(mesh, *, dp_axes: Sequence[str] = ("data",),
               tp_axis: str | None = "model",
               kv_seq_axis: object = None) -> AxisRules:
    """Standard mapping. ``kv_seq_axis`` set for decode cache sharding."""
    shape = mesh_shape(mesh)
    dp: object = tuple(a for a in dp_axes if mesh is None or a in shape)
    if isinstance(dp, tuple) and len(dp) == 1:
        dp = dp[0]
    mapping: dict[str, object] = {
        "batch": dp,
        "seq": None,
        "seq_act": None,   # residual-stream sequence sharding (Megatron SP)
        "embed": None,
        "heads": tp_axis,
        "kv_heads": tp_axis,
        "head_dim": None,
        "q_ff": tp_axis,
        "ff": tp_axis,
        "experts": tp_axis,
        "vocab": tp_axis,
        "embed_shard": tp_axis,
        "kv_seq": kv_seq_axis,
        "ssm_heads": tp_axis,
        "ssm_state": None,
        "conv_dim": tp_axis,
    }
    return AxisRules(mesh, mapping)


# -- flattening a DTensor -------------------------------------------------------

def whole_middle(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every shard of a middle dim (neither the first nor the
    last) gathered, e.g. the sequence under Megatron SP, as GSPMD
    gathers it at the projections. A matmul or reshape that flattens the
    leading dims needs it: DTensor flattens with the first dim sharded
    alone (torch 2.11 refuses anything else). A plain tensor, or one
    with no such shard, comes back as it is."""
    if type(x) is torch.Tensor or x.ndim < 3:       # the plain fast path
        return x
    placements = getattr(x, "placements", None)
    if placements is None:
        return x
    from torch.distributed.tensor import Replicate
    want = tuple(Replicate() if p.is_shard() and 0 < p.dim < x.ndim - 1
                 else p for p in placements)
    if want == tuple(placements):
        return x
    return x.redistribute(x.device_mesh, want)


class _WholeMiddleGrad(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return whole_middle(grad)


def whole_middle_grad(y: torch.Tensor) -> torch.Tensor:
    """``y``, whose gradient has its middle-dim shards gathered
    (:func:`whole_middle`) before it flows back: a matmul's or a
    reshape's backward flattens the gradient, which may arrive sharded
    on the sequence. A plain tensor comes back as it is."""
    if (type(y) is torch.Tensor or not y.requires_grad
            or getattr(y, "placements", None) is None):
        return y
    return _WholeMiddleGrad.apply(y)


# -- per-block compute ---------------------------------------------------------

def blockwise(fn, ref: torch.Tensor, ref_dims: tuple, args: Sequence,
              out_dims):
    """Run ``fn`` on this rank's (batch, heads) block of its arguments.

    The attention, scan and recurrence cores are local to a block of
    batch rows and heads: GSPMD partitions them so, and DTensor's
    per-op propagation of their 4-D and 5-D contractions is both slow
    and no better. ``ref`` (a DTensor) and ``ref_dims`` = (its batch
    dim, its head dim or None) pick the roles: each mesh dim that shards
    ``ref``'s batch dim splits the batch, each that shards its head dim
    splits the heads, the others split nothing. ``args`` is a sequence
    of ``(value, (batch dim, head dim))``: a tensor argument is placed by
    those roles (sharded on its own dims, replicated where it has none;
    a plain tensor is taken as replicated), anything else passes as it
    is. ``out_dims`` gives each output's (batch dim, head dim), counted
    from the front: a list for a tuple of outputs, one pair for a single
    output. The gradient
    of an argument replicated over a splitting mesh dim is a partial
    sum there. A plain ``ref`` calls ``fn`` on the values as they are.
    """
    values = [a for a, _ in args]
    if type(ref) is torch.Tensor:                     # the plain fast path
        return fn(*values)
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(ref, DTensor):
        return fn(*values)
    mesh = ref.device_mesh
    rb, rh = (None if d is None else d % ref.ndim for d in ref_dims)
    roles = [("b" if pl.is_shard() and pl.dim == rb else
              "h" if pl.is_shard() and pl.dim == rh else None)
             for pl in ref.placements]

    def place(dims, ndim):
        b, h = (None if d is None else d % ndim for d in dims)
        return tuple(Shard(b) if r == "b" and b is not None else
                     Shard(h) if r == "h" and h is not None else Replicate()
                     for r in roles)

    def grad_place(pl):
        return tuple(Partial() if r is not None and not p.is_shard() else p
                     for r, p in zip(roles, pl))

    ins, in_pl, grad_pl = [], [], []
    for value, dims in args:
        if not isinstance(value, torch.Tensor):
            ins.append(value)
            in_pl.append(None)
            grad_pl.append(None)
            continue
        if not isinstance(value, DTensor):
            value = DTensor.from_local(value, mesh,
                                       [Replicate()] * mesh.ndim,
                                       run_check=False)
        pl = place(dims, value.ndim)
        if tuple(value.placements) != pl:
            value = value.redistribute(mesh, pl)
        ins.append(value)
        in_pl.append(pl)
        grad_pl.append(grad_place(pl))
    # output dims are counted from the front (their ndim is not known yet)
    out_pl = (tuple(place(d, 1 << 30) for d in out_dims)
              if isinstance(out_dims, list) else (place(out_dims, 1 << 30),))
    return local_map(fn, out_placements=out_pl, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh)(*ins)


def block_of(t, dim: int) -> tuple[int, int]:
    """(this rank's block index, the number of blocks) along ``dim`` of
    DTensor ``t`` (the mesh dims that shard it, major to minor)."""
    coord = t.device_mesh.get_coordinate()
    r, n = 0, 1
    for pp, size, c in zip(t.placements, t.device_mesh.mesh.shape, coord):
        if pp.is_shard() and pp.dim == dim % t.ndim:
            r, n = r * int(size) + int(c), n * int(size)
    return r, n


class _PsumWhole(torch.autograd.Function):
    """All-reduce (sum) over ``groups`` in turn; the output is whole on
    every rank of them and its gradient arrives whole on each, so each
    rank's partial value takes that gradient as it is."""

    @staticmethod
    def forward(ctx, y, groups):
        import torch.distributed as dist
        y = y.contiguous().clone()
        for g in groups:
            dist.all_reduce(y, group=g)
        return y

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def psum_whole(y: torch.Tensor, groups: Sequence) -> torch.Tensor:
    """Sum ``y`` over the process groups ``groups`` (a shard_map
    ``psum`` whose result is used whole on every rank). On a meta tensor
    (the dry run) it goes through the functional collective, which
    moves no data and is what the dry run's meter counts."""
    if y.device.type == "meta":
        from torch.distributed._functional_collectives import all_reduce
        for g in groups:
            y = all_reduce(y, "sum", g)
        return y
    return _PsumWhole.apply(y, tuple(groups))
