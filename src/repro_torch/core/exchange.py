"""Cross-host shard exchange for the streaming aggregation engine.

ALEA's estimator is multi-worker by design (§4.4): per-region sample
shards collected on each host must be reduced into one set of sufficient
statistics (counts, Σpow, Σpow²) — and, for combination attribution, one
deduplicated combination id space — before confidence intervals are
valid. :mod:`repro_torch.core.streaming` gives the in-process
``merge()``; this module moves it across hosts, two ways:

* **Collective path** — :func:`collective_reduce`. Each rank serializes
  its aggregator into fixed-shape arrays (:func:`pack_shard`) and the
  ranks exchange them with ``torch.distributed`` collectives over a 1-D
  mesh axis (``launch.mesh.make_exchange_mesh``: NCCL on the GPU, gloo
  on the CPU). Region statistics are all-gathered and summed in rank
  order on every rank — not all-reduced, since a collective's own
  float64 reduction order is unspecified and the statistics must repeat
  bit for bit. Combination shards cannot be summed (ids are host-local),
  so their key tables + statistics are all-gathered and every rank folds
  the same ordered union merge — deterministic and identical on all
  ranks. Before the payload the ranks gather each other's (capacity,
  width, kind, domain axis, bounded config): a mismatch raises on every
  rank instead of hanging the collective.

* **Checkpointed path** — :func:`spill_shard` / :func:`gather_shards`.
  Each host atomically spills its shard using the manifest+CRC+rename
  protocol of :mod:`repro_torch.checkpoint.ckpt` (``write_manifest_dir``),
  so hosts can die and rejoin: a crashed spill leaves only an ignored
  ``.tmp-`` directory, a restarted host resumes from its own LATEST
  (:func:`restore_shard`), and the reader merges whatever shards are
  published. Restore is a left-to-right binary reduction tree::

      host_0   host_1   host_2   host_3     (published shards, id order)
         \\       /         \\       /
          m_01               m_23           round 1: pairwise merge()
              \\             /
               \\           /
                m_0123                      round 2 → merged aggregator

  ``merge`` appends a shard's unseen combination rows in the shard's
  local first-appearance order, so *any* order-preserving tree assigns
  the same union ids as a single aggregator fed the concatenated stream
  — id assignment is reduction-shape independent.

Everything but the collective path is numpy and is the JAX package's
exchange line for line, so spills cross between the two packages in
both directions: the wire schemas below are one format.

Shard manifest schema v2: arrays
``counts`` int64[cap], ``psum``/``psumsq`` float64 — 1-D [cap] for
single-domain shards (byte-identical to the schema-v1 layout) or
[cap, C] channel matrices for multi-domain shards (the power-rail
``domains`` plus the total channel, cf.
:func:`repro_torch.core.streaming.channels_for`) — and, for combination
shards, ``combos`` int64[cap, width]; manifest ``meta`` keys ``kind``
("region"|"combination"), ``host_id``, ``epoch``, ``n_rows`` (valid
prefix — rows past it are padding for fixed-shape collectives),
``schema_version`` (2) and ``domains`` (the rail axis). Readers accept
legacy v1 epochs (no ``domains`` key, 1-D statistics) transparently —
they normalize to the single-domain in-memory form — so pre-rail spill
directories keep gathering, including mixed with v2 delta-publishing
hosts; merges refuse mismatched domain axes loudly.

Schema v3 extends v2 for *bounded-state* combination shards
(:mod:`repro_torch.core.sketch`): meta keys ``k`` (heavy-hitters
capacity), ``hash_range`` (``[lo, hi)`` splitmix64 ownership interval)
and ``other_rows`` (count of per-region tail-bucket sentinel rows in the
valid prefix) ride along, and ``schema_version`` becomes 3. The v3 keys
are emitted **only when non-default** — exact, unsharded shards stay
byte-identical v2, so pre-bounded readers and golden spill fixtures are
unaffected. Readers normalize v1/v2 epochs to ``(k=None,
hash_range=None)`` transparently; merging shards whose bounded configs
differ refuses with a typed
:class:`~repro_torch.core.faults.SketchConfigError` (mixed-axis
discipline, same as the domain axis), and delta chains refuse config
drift mid-chain.

**Incremental (delta) spills.** Republishing the full shard every epoch
costs O(rows) bandwidth per epoch — O(run length · rows) per host over a
long-running serving fleet. :class:`ShardSpiller` instead publishes a
full *base* epoch, then per-epoch :class:`ShardDelta` records holding
only the rows that changed (sufficient-statistic rows mutate in place
and new combination rows append monotonically, so an epoch's difference
is a row-sparse overlay plus a combo-row suffix). Every
``compact_every``-th publish it *compacts*: rewrites a fresh full base
and garbage-collects the now-unreachable epoch dirs, keeping the host
directory O(compact window). Readers (:class:`DeltaChain`, used by
:func:`restore_shard` and so :func:`gather_shards`) walk LATEST's
``delta_of`` back-pointers to the base and fold ``base + Σ deltas`` into
a :class:`PackedShard` — hosts publishing full shards and hosts
publishing deltas mix freely under one gather. Changed rows store their
*replacement* values, not arithmetic differences: int64 differencing
would round-trip, but float64 ``prev + (cur - prev)`` does not, and the
gather must stay bit-exact against the full-spill path. A crash between
a delta publish and its compaction is safe: LATEST still names a valid
chain, and compaction GC runs only after the fresh base is durable.

Delta manifest schema: arrays ``idx`` int64[k] (changed-row indices),
``counts`` int64[k] / ``psum``/``psumsq`` float64[k] (replacement values
at those rows) and, for combination shards, ``combos_new``
int64[n_rows - prev_rows, width] (appended key rows); meta adds
``delta_of`` (the epoch this delta builds on), ``base_epoch`` (the chain
base, for validation), and ``prev_rows``.
"""

from __future__ import annotations

import dataclasses
import os
import re
import shutil
import time
import weakref
import zlib
from typing import Callable, Mapping, Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.checkpoint import ckpt
from repro_torch.convert import resolve_device
from repro_torch.core import faults as faults_mod
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.estimator import AggregateFn
from repro_torch.core.faults import (CorruptShardError, DeltaMismatchError,
                                     InjectedCrash, MissingArtifactError,
                                     QuorumError, SketchConfigError,
                                     SpillError, StaleShardError,
                                     TornWriteError, declare_site)
from repro_torch.core.streaming import (StreamingAggregator,
                                        StreamingCombinationAggregator,
                                        channels_for)

__all__ = [
    "PackedShard", "pack_shard", "unpack_shard",
    "collective_reduce", "spill_shard", "restore_shard",
    "read_shard_meta", "gather_shards", "list_spilled_hosts",
    "tree_reduce", "CollectiveExchange", "CheckpointExchange",
    "ShardDelta", "compute_shard_delta", "apply_shard_delta",
    "spill_shard_delta", "DeltaChain", "ShardSpiller",
    "QuorumPolicy", "HostReport", "GatherResult",
]

# \d+ not \d{4}: the :04d dir format zero-pads but never truncates, so
# host ids >= 10000 still publish (and must still gather).
_HOST_DIR_RE = re.compile(r"^host_(\d+)$")

KIND_REGION = "region"
KIND_COMBINATION = "combination"


# -- wire format ---------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class PackedShard:
    """One host's aggregator state as fixed-shape arrays.

    ``n_rows`` is the valid prefix; rows past it are zero padding so
    shards from hosts with different region/combination counts still
    stack into one mesh-reducible array. ``combos`` is the host-local
    combination key table (None for plain region shards) — receivers
    dedupe it lazily at merge via ``CombinationInterner.intern_rows``.

    Schema v2: ``psum``/``psumsq`` carry the channel axis ``[cap, C]``
    (``domains`` rails plus, for D > 1, the total channel — see
    :func:`repro_torch.core.streaming.channels_for`). Single-domain shards
    have C = 1, and serialize 1-D exactly like schema v1 — readers
    normalize either layout into this in-memory form.

    Schema v3 (bounded-state combination shards): ``k`` is the source
    aggregator's heavy-hitters capacity and ``hash_range`` its ``[lo,
    hi)`` splitmix64 ownership interval (``None``/``None`` = exact,
    unsharded — the v1/v2 reading). The config is part of shard
    identity: merges across differing configs refuse with
    :class:`~repro_torch.core.faults.SketchConfigError` rather than silently
    blending incompatible tails. ``tail_folds``/``evictions`` carry the
    source's cumulative fold provenance — without them a restored host
    would render a TAIL disclosure claiming zero folds while its table
    holds ``other`` rows.
    """

    counts: np.ndarray            # int64 [cap]
    psum: np.ndarray              # float64 [cap, C]
    psumsq: np.ndarray            # float64 [cap, C]
    n_rows: int
    combos: np.ndarray | None = None   # int64 [cap, width] or None
    domains: tuple[str, ...] = ("total",)
    k: int | None = None               # heavy-hitters capacity (None = exact)
    hash_range: tuple[int, int] | None = None   # [lo, hi) ownership
    tail_folds: int = 0                # cumulative fold events at pack time
    evictions: int = 0                 # cumulative evictions at pack time

    def __post_init__(self):
        # 1-D statistics are the scalar (v1-layout) form; normalize to
        # the one-channel matrix so every consumer sees [cap, C].
        if self.psum.ndim == 1:
            object.__setattr__(self, "psum", self.psum[:, None])
        if self.psumsq.ndim == 1:
            object.__setattr__(self, "psumsq", self.psumsq[:, None])
        c = channels_for(self.domains)
        if self.psum.shape[1] != c or self.psumsq.shape[1] != c:
            raise ValueError(
                f"shard has {self.psum.shape[1]} channels; domain axis "
                f"{self.domains} requires {c}")

    @property
    def kind(self) -> str:
        return KIND_REGION if self.combos is None else KIND_COMBINATION

    @property
    def capacity(self) -> int:
        return len(self.counts)

    @property
    def num_channels(self) -> int:
        return self.psum.shape[1]

    @property
    def other_rows(self) -> int:
        """Tail-bucket sentinel rows in the valid prefix (0 for region
        shards and exact combination shards)."""
        if self.combos is None or self.n_rows == 0:
            return 0
        return int(sketch_mod.is_other_rows(
            self.combos[:self.n_rows]).sum())

    @property
    def bounded(self) -> bool:
        return self.k is not None or self.hash_range is not None


def _pad(arr: np.ndarray, cap: int) -> np.ndarray:
    if len(arr) > cap:
        raise ValueError(f"shard has {len(arr)} rows > capacity {cap}")
    if len(arr) == cap:
        return arr
    pad = [(0, cap - len(arr))] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad)


def pack_shard(agg: StreamingAggregator | StreamingCombinationAggregator,
               capacity: int | None = None) -> PackedShard:
    """Serialize an aggregator into a :class:`PackedShard`.

    ``capacity`` pads the row dimension to a fixed size; collectives need
    every participating host to pass the same value.
    """
    if isinstance(agg, StreamingCombinationAggregator):
        combos = agg.interner.combo_matrix()
        n_rows = len(combos)
        cap = n_rows if capacity is None else capacity
        hr = agg.hash_range
        return PackedShard(
            counts=_pad(agg.agg.counts[:n_rows], cap),
            psum=_pad(agg.agg.chan_psum[:n_rows], cap),
            psumsq=_pad(agg.agg.chan_psumsq[:n_rows], cap),
            n_rows=n_rows, combos=_pad(combos, cap),
            domains=agg.domains, k=agg.k,
            hash_range=None if hr is None else hr.as_tuple(),
            tail_folds=agg.tail_folds, evictions=agg.evictions)
    n_rows = agg.num_regions
    cap = n_rows if capacity is None else capacity
    return PackedShard(counts=_pad(agg.counts, cap),
                       psum=_pad(agg.chan_psum, cap),
                       psumsq=_pad(agg.chan_psumsq, cap), n_rows=n_rows,
                       domains=agg.domains)


def unpack_shard(shard: PackedShard, *,
                 aggregate_fn: AggregateFn | None = None
                 ) -> StreamingAggregator | StreamingCombinationAggregator:
    """Reconstruct a live aggregator from a packed shard."""
    k = shard.n_rows
    if shard.combos is None:
        return StreamingAggregator.from_statistics(
            shard.counts[:k], shard.psum[:k], shard.psumsq[:k],
            aggregate_fn=aggregate_fn, domains=shard.domains)
    cagg = StreamingCombinationAggregator(aggregate_fn=aggregate_fn,
                                          domains=shard.domains,
                                          k=shard.k,
                                          hash_range=shard.hash_range)
    cagg.merge_table(shard.combos[:k], shard.counts[:k],
                     shard.psum[:k], shard.psumsq[:k],
                     k=shard.k, hash_range=shard.hash_range)
    # Reconstruction never folds (resident <= k by construction), so the
    # packed provenance restores exactly — not additively.
    cagg.tail_folds = shard.tail_folds
    cagg.evictions = shard.evictions
    return cagg


def _merge_shard_into(agg, shard: PackedShard):
    """Fold a packed shard into a live aggregator (kinds must match)."""
    k = shard.n_rows
    if isinstance(agg, StreamingCombinationAggregator):
        if shard.combos is None:
            raise ValueError("cannot merge a region shard into a "
                             "combination aggregator")
        agg.merge_table(shard.combos[:k], shard.counts[:k],
                        shard.psum[:k], shard.psumsq[:k],
                        k=shard.k, hash_range=shard.hash_range)
        # Same tail provenance accounting as merge(): the source's fold
        # history rides along with its statistics.
        agg.tail_folds += shard.tail_folds
        agg.evictions += shard.evictions
        return agg
    if shard.combos is not None:
        raise ValueError("cannot merge a combination shard into a region "
                         "aggregator")
    other = unpack_shard(shard)
    return agg.merge(other)


# -- collective path -----------------------------------------------------------

_KIND_CODE = {KIND_REGION: 0, KIND_COMBINATION: 1}
# Per-rank header fields, gathered before the payload.
_HEADER = ("refused", "kind", "capacity", "width", "domains", "config",
           "local_shards")


def _stack_global(mesh, axis: str, rows: Sequence[np.ndarray]):
    """Stack this rank's rows into the [L, ...] tensor it contributes to
    the collectives over ``axis``, on the mesh's device.

    Each rank passes only its local row(s) — on one rank, every shard —
    and the collectives give every rank the [world · L, ...]
    concatenation in rank order.
    """
    stacked = np.ascontiguousarray(np.stack(rows))
    return torch.from_numpy(stacked).to(mesh.device_type)


def _all_gather(group, t: torch.Tensor) -> torch.Tensor:
    """[L, ...] on every rank → [world · L, ...] in rank order."""
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t.contiguous(), group=group)
    return torch.cat(parts)


def region_allreduce_fn(group):
    """Per-rank body of the region reduction over ``group``.

    Every rank all-gathers the fleet's (counts, Σpow, Σpow²) stacks and
    sums them in rank order, one position after the other, so every rank
    holds the same bits on every run — which an all-reduce, whose
    float64 reduction order the backend chooses, does not promise.
    Module-level (rather than a closure inside :func:`collective_reduce`)
    so the computation that runs on each rank can be named and audited.
    """

    def _ordered_sum(g: torch.Tensor) -> torch.Tensor:
        acc = g[0].clone()
        for h in range(1, g.shape[0]):
            acc += g[h]
        return acc

    def _allreduce(c, s, q):
        return tuple(_ordered_sum(_all_gather(group, a)) for a in (c, s, q))
    return _allreduce


def combo_allgather_fn(group):
    """Per-rank body of the combination-table all-gather over ``group``
    (module-level for the same reason as :func:`region_allreduce_fn`)."""

    def _gather(*arrs):
        return tuple(_all_gather(group, a) for a in arrs)
    return _gather


def _digest(value) -> int:
    return zlib.crc32(repr(value).encode())


def _fleet_header(group, device, fields: dict) -> np.ndarray:
    """Every rank's :data:`_HEADER` fields, [world, len(_HEADER)] int64."""
    row = torch.tensor([[int(fields[k]) for k in _HEADER]], dtype=torch.int64)
    return _all_gather(group, row.to(device)).cpu().numpy()


def _check_fleet(header: np.ndarray, local_err: Exception | None) -> None:
    """Raise, on every rank alike, when any rank refused its shards or
    the ranks disagree on what they are about to exchange."""
    if local_err is not None:
        raise local_err
    col = {k: header[:, i] for i, k in enumerate(_HEADER)}
    refused = np.flatnonzero(col["refused"])
    if refused.size:
        raise ValueError(f"rank(s) {refused.tolist()} refused their shards")

    def differ(k, vals=None):
        vals = col[k] if vals is None else vals
        return len(set(vals.tolist())) > 1

    if differ("kind"):
        raise ValueError("mixed shard kinds across ranks")
    if differ("domains"):
        raise ValueError("mixed shard domain axes across ranks")
    if differ("local_shards"):
        raise ValueError(f"ranks pass different numbers of local shards: "
                         f"{col['local_shards'].tolist()}")
    if differ("capacity"):
        raise ValueError(f"ranks disagree on the shard capacity: "
                         f"{col['capacity'].tolist()}; pass the same "
                         f"capacity= on every rank")
    widths = col["width"][col["width"] > 0]
    if differ("width", widths):
        raise ValueError(f"worker-count mismatch across ranks: "
                         f"{sorted(set(widths.tolist()))}")
    if differ("config"):
        raise SketchConfigError("mixed bounded-state configs across ranks")


def collective_reduce(shards: Sequence[StreamingAggregator |
                                       StreamingCombinationAggregator],
                      *, mesh=None, axis: str = "hosts",
                      capacity: int | None = None, width: int | None = None,
                      aggregate_fn: AggregateFn | None = None,
                      device="cuda"):
    """Reduce aggregator shards over a mesh axis; returns the merge.

    ``shards`` holds this rank's aggregators — in production each host
    passes ``[its local shard]`` against a mesh with one position per
    host; on one rank, every shard goes in the list. Plain region shards
    are all-gathered and summed in rank order; combination shards are
    all-gathered (tables are host-local id spaces, not summable) and
    every rank folds the same ordered union merge, so results are
    identical everywhere. Ranks with different shard counts pass the same
    ``capacity`` (and, where a rank may be idle, ``width``); ranks that
    disagree raise instead of hanging. Without ``mesh``,
    :func:`~repro_torch.launch.mesh.make_exchange_mesh` builds one on
    ``device`` (NCCL on ``"cuda"``, gloo on ``"cpu"``).
    """
    from repro_torch.launch.mesh import make_exchange_mesh

    if not shards:
        raise ValueError("no shards to reduce")
    if mesh is None:
        mesh = make_exchange_mesh(axis=axis, device=device)
    group = mesh.get_group(axis)
    # The reference's local checks, with the verdict held back until the
    # ranks have compared headers: a rank that raised alone would leave
    # the others waiting in the collective.
    local_err = None
    fields = dict(refused=0, kind=0, capacity=0, width=0, domains=0,
                  config=0, local_shards=len(shards))
    try:
        if capacity is None:
            if isinstance(shards[0], StreamingCombinationAggregator):
                capacity = max(len(s.interner) for s in shards)
            else:
                capacity = max(s.num_regions for s in shards)
        packed = [pack_shard(s, capacity) for s in shards]
        kinds = {p.kind for p in packed}
        if len(kinds) != 1:
            raise ValueError(f"mixed shard kinds: {sorted(kinds)}")
        domain_axes = {p.domains for p in packed}
        if len(domain_axes) != 1:
            raise ValueError(
                f"mixed shard domain axes: {sorted(domain_axes)}")
        domains = domain_axes.pop()
        w = 0
        combo_k = combo_hr = None
        if KIND_COMBINATION in kinds:
            # A host that saw no traffic has a width-0 key table; its
            # combos must still stack to the fleet's fixed [cap, width]
            # shape (its n_rows=0 keeps the zero rows out of the merge).
            widths = {p.combos.shape[1] for p in packed
                      if p.combos.shape[1]}
            if width is not None:
                widths.add(width)
            if len(widths) > 1:
                raise ValueError(f"worker-count mismatch across shards: "
                                 f"{sorted(widths)}")
            w = widths.pop() if widths else 0
            # Bounded-state config is part of shard identity (like the
            # domain axis): local shards must agree, and so must ranks.
            configs = {(p.k, p.hash_range) for p in packed}
            if len(configs) > 1:
                raise SketchConfigError(
                    f"mixed bounded-state configs across collective "
                    f"shards: {sorted(configs, key=repr)}")
            combo_k, combo_hr = configs.pop()
        (kind,) = kinds
        fields.update(kind=_KIND_CODE[kind], capacity=capacity, width=w,
                      domains=_digest(domains),
                      config=_digest((combo_k, combo_hr)))
    except (ValueError, SketchConfigError) as e:
        local_err = e
        fields["refused"] = 1
    header = _fleet_header(group, mesh.device_type, fields)
    _check_fleet(header, local_err)
    if KIND_COMBINATION in kinds:
        # The fleet's width: a rank whose shards are all idle pads to it.
        fleet_w = int(header[:, _HEADER.index("width")].max())
        packed = [p if p.combos.shape[1] == fleet_w else dataclasses.replace(
                      p, combos=np.zeros((p.capacity, fleet_w), np.int64))
                  for p in packed]

    if KIND_REGION in kinds:
        counts = _stack_global(mesh, axis, [p.counts for p in packed])
        psum = _stack_global(mesh, axis, [p.psum for p in packed])
        psumsq = _stack_global(mesh, axis, [p.psumsq for p in packed])

        c, s, q = region_allreduce_fn(group)(counts, psum, psumsq)
        # Remote hosts may populate rows past any local shard's n_rows;
        # the merged statistics span the full capacity.
        return unpack_shard(
            PackedShard(counts=c.cpu().numpy(), psum=s.cpu().numpy(),
                        psumsq=q.cpu().numpy(), n_rows=capacity,
                        domains=domains),
            aggregate_fn=aggregate_fn)

    combos = _stack_global(mesh, axis, [p.combos for p in packed])
    counts = _stack_global(mesh, axis, [p.counts for p in packed])
    psum = _stack_global(mesh, axis, [p.psum for p in packed])
    psumsq = _stack_global(mesh, axis, [p.psumsq for p in packed])
    n_rows = _stack_global(
        mesh, axis, [np.asarray([p.n_rows], np.int64) for p in packed])

    g = combo_allgather_fn(group)(combos, counts, psum, psumsq, n_rows)
    g_combos, g_counts, g_psum, g_psumsq, g_rows = (a.cpu().numpy()
                                                    for a in g)
    merged = StreamingCombinationAggregator(aggregate_fn=aggregate_fn,
                                            domains=domains,
                                            k=combo_k,
                                            hash_range=combo_hr)
    for h in range(len(g_rows)):
        k = int(g_rows[h, 0])
        merged.merge_table(g_combos[h, :k], g_counts[h, :k],
                           g_psum[h, :k], g_psumsq[h, :k],
                           k=combo_k, hash_range=combo_hr)
    return merged


# -- checkpointed path ---------------------------------------------------------

_EPOCH_DIR_RE = re.compile(r"^epoch_(\d+)$")


def _host_dir(path: str, host_id: int) -> str:
    return os.path.join(path, f"host_{host_id:04d}")


def _epoch_dir(hd: str, epoch: int) -> str:
    return os.path.join(hd, f"epoch_{epoch:09d}")


def _wire_stats(arr: np.ndarray) -> np.ndarray:
    """[cap, C] channel matrix → wire layout: single-channel shards write
    the 1-D array schema v1 wrote (same data bytes; v1 readers could even
    consume them), multi-channel shards write [cap, C]."""
    return arr[:, 0] if arr.shape[1] == 1 else arr


def _unwire_stats(arr: np.ndarray, domains: tuple[str, ...]) -> np.ndarray:
    """Wire layout → [cap, C]: v1 shards (and v2 single-domain shards)
    store 1-D arrays; reshape to the one-channel matrix."""
    arr = np.asarray(arr, np.float64)
    if arr.ndim == 1:
        arr = arr[:, None]
    c = channels_for(domains)
    if arr.shape[1] != c:
        raise CorruptShardError(
            f"shard statistics have {arr.shape[1]} channels; "
            f"domain axis {domains} requires {c}")
    return arr


def _meta_domains(manifest: dict) -> tuple[str, ...]:
    """Domain axis of an epoch dir; schema v1 manifests (no ``domains``
    key) are single-domain by construction."""
    return tuple(manifest.get("domains", ("total",)))


def _meta_bounds(manifest: dict
                 ) -> tuple[int | None, tuple[int, int] | None, int, int]:
    """``(k, hash_range, tail_folds, evictions)`` of an epoch dir; v1/v2
    manifests (no bounded keys) normalize to the exact, unsharded
    config with zero fold provenance."""
    k = manifest.get("k")
    hr = manifest.get("hash_range")
    return (None if k is None else int(k),
            None if hr is None else (int(hr[0]), int(hr[1])),
            int(manifest.get("tail_folds", 0)),
            int(manifest.get("evictions", 0)))


def _bounds_meta(meta: dict, k: int | None,
                 hash_range: tuple[int, int] | None,
                 tail_folds: int = 0, evictions: int = 0) -> dict:
    """Stamp bounded-state keys onto a manifest meta dict — only when
    non-default, so exact unsharded epochs stay byte-identical schema
    v2 (pre-bounded readers and golden spill fixtures unaffected)."""
    if k is None and hash_range is None:
        return meta
    meta["schema_version"] = 3
    if k is not None:
        meta["k"] = int(k)
    if hash_range is not None:
        meta["hash_range"] = [int(hash_range[0]), int(hash_range[1])]
    meta["tail_folds"] = int(tail_folds)
    meta["evictions"] = int(evictions)
    return meta


def _spill_packed(path: str, host_id: int, epoch: int, shard: PackedShard,
                  *, extra_meta: dict | None = None) -> str:
    hd = _host_dir(path, host_id)
    os.makedirs(hd, exist_ok=True)
    arrays = [shard.counts, _wire_stats(shard.psum),
              _wire_stats(shard.psumsq)]
    meta = {"kind": shard.kind, "host_id": host_id, "epoch": epoch,
            "n_rows": shard.n_rows,
            "schema": ["counts", "psum", "psumsq"],
            "schema_version": 2, "domains": list(shard.domains)}
    _bounds_meta(meta, shard.k, shard.hash_range,
                 shard.tail_folds, shard.evictions)
    if shard.bounded:
        meta["other_rows"] = shard.other_rows
    if extra_meta:
        meta["extra"] = dict(extra_meta)
    if shard.combos is not None:
        arrays.append(shard.combos)
        meta["schema"] = meta["schema"] + ["combos"]
        meta["width"] = int(shard.combos.shape[1])
    final = _epoch_dir(hd, epoch)
    ckpt.write_manifest_dir(final, arrays, meta=meta)
    ckpt.publish_latest(hd, epoch)
    return final


def spill_shard(path: str, host_id: int, epoch: int,
                agg: StreamingAggregator | StreamingCombinationAggregator,
                *, extra_meta: dict | None = None) -> str:
    """Atomically publish one host's full shard at ``epoch``.

    Reuses the checkpoint manifest+CRC+rename protocol: a shard is never
    half-visible, and per-host ``LATEST`` is only advanced after the
    epoch directory is durable. ``extra_meta`` (JSON-serializable) rides
    along under the manifest's ``"extra"`` key — callers stash run-scope
    state a restarted host needs (e.g. elapsed wall time). Returns the
    published directory. For per-epoch publishing use a
    :class:`ShardSpiller`, which spills incremental deltas instead of
    rewriting the full shard every time.
    """
    return _spill_packed(path, host_id, epoch, pack_shard(agg),
                         extra_meta=extra_meta)


def _load_shard(hd: str, epoch: int) -> PackedShard:
    """Load one *full* epoch dir (no chain resolution).

    Accepts all wire schemas: v1 (1-D psum/psumsq, no ``domains`` meta),
    v2 ([cap, C] channel matrices + ``domains``) and v3 (bounded-state
    ``k``/``hash_range`` keys) normalize into the same in-memory
    :class:`PackedShard`.
    """
    d = _epoch_dir(hd, epoch)
    arrays, manifest = ckpt.read_manifest_dir(d)
    try:
        named = dict(zip(manifest["schema"], arrays))
        domains = _meta_domains(manifest)
        k, hash_range, tail_folds, evictions = _meta_bounds(manifest)
        return PackedShard(counts=named["counts"].astype(np.int64),
                           psum=_unwire_stats(named["psum"], domains),
                           psumsq=_unwire_stats(named["psumsq"], domains),
                           n_rows=int(manifest["n_rows"]),
                           combos=named.get("combos"), domains=domains,
                           k=k, hash_range=hash_range,
                           tail_folds=tail_folds, evictions=evictions)
    except (KeyError, TypeError, ValueError, IndexError) as e:
        # The leaves CRC'd clean but the manifest decoded to the wrong
        # structure (a bit flip inside a JSON string still parses):
        # corrupt, not a programming error.
        raise CorruptShardError(f"malformed shard manifest in {d}: "
                                f"{e!r}") from e


def restore_shard(path: str, host_id: int, *,
                  aggregate_fn: AggregateFn | None = None,
                  min_epoch: int | None = None):
    """(aggregator, epoch) from a host's LATEST spill, or None if absent.

    A restarted host calls this to resume accumulating from its last
    durable state instead of re-sampling from zero. If LATEST names a
    delta epoch, the full chain ``base + Σ deltas`` is folded
    transparently (:class:`DeltaChain`), so full-spilling and
    delta-spilling hosts are indistinguishable to readers.

    ``min_epoch`` makes the read strict about recency: a host whose
    LATEST is behind it raises :class:`StaleShardError` instead of
    silently handing back old statistics.

    Concurrent-compaction race: the writer may publish a fresh base and
    GC the chain this reader just resolved from a now-stale LATEST. The
    fold then fails mid-walk — re-reading LATEST finds the new (full)
    base, so a couple of retries make the read lock-free. Failures that
    persist past the retries surface as typed
    :class:`~repro_torch.core.faults.SpillError` subclasses.
    """
    hd = _host_dir(path, host_id)
    last_err = None
    for _attempt in range(3):
        epoch = ckpt.latest_step(hd)
        if epoch is None:
            return None
        if min_epoch is not None and epoch < min_epoch:
            raise StaleShardError(
                f"host {host_id} LATEST epoch {epoch} is behind the "
                f"required watermark {min_epoch}")
        try:
            shard = DeltaChain(hd, epoch).fold()
        except IOError as e:
            last_err = e
            continue
        return unpack_shard(shard, aggregate_fn=aggregate_fn), epoch
    raise last_err


def read_shard_meta(path: str, host_id: int) -> dict | None:
    """Manifest of a host's LATEST shard (no array I/O), or None.

    Includes the caller's ``extra`` dict from :func:`spill_shard`.
    """
    hd = _host_dir(path, host_id)
    epoch = ckpt.latest_step(hd)
    if epoch is None:
        return None
    return ckpt.read_manifest_meta(_epoch_dir(hd, epoch))


def list_spilled_hosts(path: str) -> list[int]:
    """Host ids with at least one published (LATEST-named) shard.

    ``.tmp-`` directories from crashed writers are never inspected.
    """
    if not os.path.isdir(path):
        return []
    out = []
    for name in os.listdir(path):
        m = _HOST_DIR_RE.match(name)
        if m and ckpt.latest_step(os.path.join(path, name)) is not None:
            out.append(int(m.group(1)))
    # Numeric, not lexicographic: host_10000 must sort after host_9999
    # (id order is what makes merged combination ids deterministic).
    return sorted(out)


def tree_reduce(aggs: Sequence):
    """Merge aggregators by an order-preserving binary reduction tree.

    The order preservation is correctness-critical (see module
    docstring): it is what makes merged combination id assignment match
    a single pass over the concatenated stream, for any tree shape.
    """
    aggs = list(aggs)
    if not aggs:
        raise ValueError("nothing to reduce")
    while len(aggs) > 1:
        nxt = [aggs[i].merge(aggs[i + 1])
               for i in range(0, len(aggs) - 1, 2)]
        if len(aggs) % 2:
            nxt.append(aggs[-1])
        aggs = nxt
    return aggs[0]


def gather_shards(path: str, *, aggregate_fn: AggregateFn | None = None,
                  quorum: "QuorumPolicy | None" = None,
                  hash_range=None):
    """Merge every published host shard under ``path`` (reduction tree).

    Hosts are taken in id order and merged by :func:`tree_reduce`, so
    combination ids match a single-host pass over the concatenated
    stream regardless of host count.

    Without ``quorum`` this is the strict, all-or-nothing gather: any
    unreadable host raises (typed — see :mod:`repro_torch.core.faults`) and
    the return value is the merged aggregator. With a
    :class:`QuorumPolicy` the gather degrades instead of failing:
    per-host bounded retries with exponential backoff, corrupt epoch
    tails folded back to the last durable prefix, and a
    :class:`GatherResult` return value carrying full provenance — which
    hosts merged at which effective epoch, which were missing, stale or
    quarantined — so downstream reports disclose coverage instead of
    overstating it.

    ``hash_range`` turns the gather into one shard of a per-range
    shuffle: each restored combination aggregator is projected onto the
    range (:meth:`~repro_torch.core.streaming.StreamingCombinationAggregator.
    filter_range`) before the reduction tree, so a caller owning range
    ``i`` of :meth:`HashRange.split(n) <repro_torch.core.sketch.HashRange.
    split>` folds only its keys and no host ever materializes the union
    table. The ``n`` range-gathers partition every (combination, stats)
    row of the fleet exactly once — same delta-spill + quorum machinery,
    O(union / n) memory per owner. Region shards have no key hash to
    shard by, so combining them with ``hash_range`` raises.
    """
    if quorum is not None:
        return _quorum_gather(path, quorum, aggregate_fn,
                              hash_range=hash_range)
    hosts = list_spilled_hosts(path)
    # Strict mode must not silently shrink the fleet: a host whose LATEST
    # file exists but doesn't parse is corrupt, not "never published"
    # (``list_spilled_hosts`` can't tell the two apart — it hides both).
    for h in _list_host_dirs(path):
        hd = _host_dir(path, h)
        if (h not in hosts
                and os.path.exists(os.path.join(hd, "LATEST"))):
            raise CorruptShardError(f"unreadable LATEST under {hd}")
    if not hosts:
        raise MissingArtifactError(f"no published shards under {path}")
    aggs = []
    for h in hosts:
        restored = restore_shard(path, h, aggregate_fn=aggregate_fn)
        assert restored is not None       # list_spilled_hosts checked LATEST
        aggs.append(_project_range(restored[0], hash_range))
    return tree_reduce(aggs)


def _project_range(agg, hash_range):
    """Project a restored aggregator onto a gather's owned hash range
    (identity when no range is requested)."""
    if hash_range is None:
        return agg
    if not isinstance(agg, StreamingCombinationAggregator):
        raise SketchConfigError(
            "hash-range gather needs combination shards: region rows "
            "have no combination key to hash")
    return agg.filter_range(hash_range)


# -- quorum (degraded-mode) gather ---------------------------------------------

@dataclasses.dataclass(frozen=True)
class QuorumPolicy:
    """How a degraded gather trades completeness for availability.

    Attributes
    ----------
    expected_hosts: the fleet roster. ``None`` means "whatever host
        directories exist on disk" — note that a host which crashed
        before its *first* publish is invisible then, so production
        gathers should pass the roster explicitly.
    min_hosts:     merged-host count below which the gather raises
        :class:`QuorumError` rather than return statistics too partial
        to act on.
    min_epoch:     recency watermark: hosts whose effective epoch falls
        behind it are classified stale (merged but disclosed, or
        excluded when ``drop_stale``).
    watermarks:    per-host monotone epoch watermarks (e.g. the
        ``host_epochs`` of the previous :class:`GatherResult`): a host
        folded back *behind* its own last-seen epoch is flagged stale,
        so coverage can never silently move backwards between gathers.
    retries:       read attempts per host before accepting a degraded
        fold or quarantining.
    backoff:       initial inter-attempt sleep, doubled each retry
        (0 disables sleeping — tests).
    sleep_fn:      how the inter-attempt backoff actually waits; defaults
        to ``time.sleep``. Chaos tests exercising the retry ladder pass
        a recording stub so a multi-retry scenario replays instantly and
        deterministically instead of burning real wall-clock time. Only
        ever called *between* attempts — never after the final failed
        one (there is nothing left to wait for).
    drop_stale:    exclude stale hosts from the merge entirely instead
        of merging-and-disclosing.
    """
    expected_hosts: tuple[int, ...] | None = None
    min_hosts: int = 1
    min_epoch: int | None = None
    watermarks: Mapping[int, int] | None = None
    retries: int = 3
    backoff: float = 0.05
    sleep_fn: Callable[[float], None] = time.sleep
    drop_stale: bool = False


@dataclasses.dataclass(frozen=True)
class HostReport:
    """Per-host provenance of one quorum gather.

    ``status`` is one of:

    * ``"merged"``       — full chain folded at the host's LATEST epoch.
    * ``"degraded"``     — a corrupt/torn tail was quarantined; the host
      merged at an earlier durable epoch (``quarantined_epochs`` lists
      the rolled-back tail).
    * ``"stale"``        — durable state is behind the policy watermark
      (merged unless ``drop_stale``).
    * ``"missing"``      — expected host never published.
    * ``"quarantined"``  — host present but nothing durable was readable;
      excluded from the merge.
    """
    host_id: int
    status: str
    epoch: int | None = None             # effective (merged) epoch
    requested_epoch: int | None = None   # LATEST at gather time
    quarantined_epochs: tuple[int, ...] = ()
    error: str | None = None
    attempts: int = 1

    @property
    def merged(self) -> bool:
        return self.epoch is not None


@dataclasses.dataclass(frozen=True)
class GatherResult:
    """A degraded-mode gather: merged statistics + full provenance."""
    agg: object
    hosts: tuple[HostReport, ...]

    @property
    def complete(self) -> bool:
        """True iff every expected host merged its full LATEST chain —
        the condition under which the merge is bit-exact to a fault-free
        gather of the same hosts."""
        return all(r.status == "merged" for r in self.hosts)

    def _by_status(self, *statuses: str) -> tuple[int, ...]:
        return tuple(r.host_id for r in self.hosts if r.status in statuses)

    @property
    def hosts_merged(self) -> tuple[int, ...]:
        return tuple(r.host_id for r in self.hosts if r.merged)

    @property
    def hosts_missing(self) -> tuple[int, ...]:
        return self._by_status("missing")

    @property
    def hosts_stale(self) -> tuple[int, ...]:
        return self._by_status("stale")

    @property
    def hosts_degraded(self) -> tuple[int, ...]:
        return self._by_status("degraded")

    @property
    def hosts_quarantined(self) -> tuple[int, ...]:
        return self._by_status("quarantined")

    @property
    def host_epochs(self) -> dict[int, int]:
        """Effective merged epoch per merged host — feed back as the next
        gather's ``watermarks`` to pin the monotonicity invariant."""
        return {r.host_id: r.epoch for r in self.hosts if r.merged}

    def coverage(self) -> dict:
        """JSON-able provenance dict (the ``EstimateSet.coverage`` payload)."""
        n = len(self.hosts)
        parts = [f"merged {len(self.hosts_merged)}/{n} hosts"]
        for label, ids in (("missing", self.hosts_missing),
                           ("stale", self.hosts_stale),
                           ("degraded", self.hosts_degraded),
                           ("quarantined", self.hosts_quarantined)):
            if ids:
                parts.append(f"{label}: {list(ids)}")
        return {
            "complete": self.complete,
            "hosts_merged": list(self.hosts_merged),
            "hosts_missing": list(self.hosts_missing),
            "hosts_stale": list(self.hosts_stale),
            "hosts_degraded": list(self.hosts_degraded),
            "hosts_quarantined": list(self.hosts_quarantined),
            "host_epochs": {str(h): e for h, e in self.host_epochs.items()},
            "quarantined_epochs": {
                str(r.host_id): list(r.quarantined_epochs)
                for r in self.hosts if r.quarantined_epochs},
            "summary": "; ".join(parts),
        }

    def estimates(self, t_exec: float, names: Sequence[str], *,
                  alpha: float = 0.05):
        """Estimates with the gather's coverage attached (so reports
        disclose partial fleets instead of presenting degraded statistics
        as complete)."""
        return self.agg.estimates(t_exec, names, alpha=alpha,
                                  coverage=self.coverage())


def _list_host_dirs(path: str) -> list[int]:
    """Every host directory, *including* ones with no/unreadable LATEST
    (:func:`list_spilled_hosts` deliberately hides those)."""
    if not os.path.isdir(path):
        return []
    return sorted(int(m.group(1)) for name in os.listdir(path)
                  if (m := _HOST_DIR_RE.match(name)))


def _restore_degraded(path: str, host_id: int, policy: QuorumPolicy,
                      aggregate_fn: AggregateFn | None):
    """One host's best durable state under bounded retries.

    Returns ``(HostReport, PackedShard | None)``. Retries first — a
    failed fold may be the benign concurrent-compaction race — and only
    accepts a degraded (prefix-fold) result once retries are exhausted,
    so transient races never masquerade as corruption in the provenance.
    """
    hd = _host_dir(path, host_id)
    attempts = max(1, policy.retries)
    delay = policy.backoff
    last_err: Exception | None = None
    best: tuple[PackedShard, int, tuple[int, ...], int] | None = None
    for attempt in range(1, attempts + 1):
        if attempt > 1 and delay > 0:
            # Between attempts only: the final failed attempt falls
            # straight through to the degraded/quarantine verdict with
            # no trailing wait.
            policy.sleep_fn(delay)
            delay *= 2
        epoch = ckpt.latest_step(hd)
        if epoch is None:
            if os.path.exists(os.path.join(hd, "LATEST")):
                last_err = CorruptShardError(f"unreadable LATEST under {hd}")
                continue
            return HostReport(host_id, "missing", attempts=attempt,
                              error="never published"), None
        try:
            chain = DeltaChain(hd, epoch)
            shard, effective, failed = chain.fold_partial()
        except IOError as e:
            last_err = e
            continue
        if not failed:
            return (HostReport(host_id, "merged", epoch=effective,
                               requested_epoch=epoch, attempts=attempt),
                    shard)
        best = (shard, effective, failed, epoch)
        last_err = CorruptShardError(
            f"epochs {list(failed)} unreadable under {hd}")
    if best is not None:
        shard, effective, failed, epoch = best
        return (HostReport(host_id, "degraded", epoch=effective,
                           requested_epoch=epoch,
                           quarantined_epochs=failed,
                           error=str(last_err), attempts=attempts),
                shard)
    # Nothing resolvable through LATEST. Fall back to scanning epoch
    # dirs newest-first for any fully durable chain (covers a corrupt
    # LATEST epoch whose *predecessor* base is intact).
    fallback = _scan_last_durable(hd)
    if fallback is not None:
        shard, effective, failed = fallback
        return (HostReport(host_id, "degraded", epoch=effective,
                           requested_epoch=ckpt.latest_step(hd),
                           quarantined_epochs=failed,
                           error=str(last_err), attempts=attempts),
                shard)
    return (HostReport(host_id, "quarantined",
                       requested_epoch=ckpt.latest_step(hd),
                       error=str(last_err) if last_err else "unreadable",
                       attempts=attempts),
            None)


def _scan_last_durable(hd: str):
    """Newest fully-foldable chain among the published epoch dirs, or
    None. Returns ``(shard, effective_epoch, quarantined_epochs)`` where
    the quarantined set is every published epoch above the durable one.
    """
    try:
        names = os.listdir(hd)
    # audit: allow(no-silent-except) absent host dir == no durable state
    except FileNotFoundError:
        return None
    epochs = sorted((int(m.group(1)) for name in names
                     if (m := _EPOCH_DIR_RE.match(name))), reverse=True)
    for i, e in enumerate(epochs):
        try:
            shard = DeltaChain(hd, e).fold()
        # audit: allow(no-silent-except) fold-back scan: the skipped
        # epochs are returned as the quarantined set, not dropped
        except IOError:
            continue
        return shard, e, tuple(sorted(epochs[:i]))
    return None


def _quorum_gather(path: str, policy: QuorumPolicy,
                   aggregate_fn: AggregateFn | None,
                   hash_range=None) -> GatherResult:
    if policy.expected_hosts is not None:
        roster = sorted(set(int(h) for h in policy.expected_hosts))
    else:
        roster = _list_host_dirs(path)
    reports: list[HostReport] = []
    shards: list[PackedShard] = []
    for h in roster:
        rep, shard = _restore_degraded(path, h, policy, aggregate_fn)
        if shard is not None:
            floor = max(policy.min_epoch or 0,
                        (policy.watermarks or {}).get(h, 0))
            if floor and rep.epoch is not None and rep.epoch < floor:
                err = (f"host {h} effective epoch {rep.epoch} is behind "
                       f"the watermark {floor}")
                if policy.drop_stale:
                    rep = dataclasses.replace(rep, status="stale",
                                              epoch=None, error=err)
                    shard = None
                else:
                    rep = dataclasses.replace(rep, status="stale", error=err)
        reports.append(rep)
        if shard is not None:
            shards.append(shard)
    merged_n = sum(1 for r in reports if r.merged)
    if merged_n < policy.min_hosts:
        detail = "; ".join(f"host {r.host_id}: {r.status}"
                           f" ({r.error})" if r.error else
                           f"host {r.host_id}: {r.status}"
                           for r in reports if not r.merged)
        raise QuorumError(
            f"quorum failed under {path}: {merged_n} host(s) merged, "
            f"policy requires {policy.min_hosts} ({detail or 'no hosts'})")
    # Host-id order + the order-preserving reduction tree keep merged
    # combination ids deterministic, exactly as in the strict gather.
    aggs = [_project_range(unpack_shard(s, aggregate_fn=aggregate_fn),
                           hash_range)
            for s in shards]
    return GatherResult(agg=tree_reduce(aggs) if aggs else None,
                        hosts=tuple(reports))


# -- incremental (delta) spills ------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ShardDelta:
    """Row-sparse difference between two published states of one shard.

    ``idx`` lists the rows whose sufficient statistics changed since the
    ``prev_rows``-row predecessor (including all appended rows); the
    parallel ``counts``/``psum``/``psumsq`` arrays hold those rows'
    *replacement* values. Replacement, not arithmetic difference, is what
    keeps a folded chain bit-exact vs. a full spill: int64 differences
    would round-trip, but float64 ``prev + (cur - prev)`` loses ulps.
    ``combos_new`` carries the appended combination key rows
    (``None`` for region shards) — the interner assigns ids in
    first-appearance order and never reorders, so append-only suffices.
    """

    idx: np.ndarray               # int64 [k] changed-row indices
    counts: np.ndarray            # int64 [k] replacement values at idx
    psum: np.ndarray              # float64 [k, C]
    psumsq: np.ndarray            # float64 [k, C]
    n_rows: int                   # rows after applying
    prev_rows: int                # rows in the state this builds on
    combos_new: np.ndarray | None = None   # int64 [n_rows-prev_rows, width]
    domains: tuple[str, ...] = ("total",)
    k: int | None = None               # bounded-state config (must be
    hash_range: tuple[int, int] | None = None   # chain-constant)
    tail_folds: int = 0                # cumulative provenance at this epoch
    evictions: int = 0                 # (latest-wins metadata, not summed)

    def __post_init__(self):
        if self.psum.ndim == 1:
            object.__setattr__(self, "psum", self.psum[:, None])
        if self.psumsq.ndim == 1:
            object.__setattr__(self, "psumsq", self.psumsq[:, None])

    @property
    def kind(self) -> str:
        return KIND_REGION if self.combos_new is None else KIND_COMBINATION


def compute_shard_delta(prev: PackedShard, cur: PackedShard) -> ShardDelta:
    """Row-sparse delta taking ``prev`` to ``cur``.

    Requires append-only evolution: ``cur``'s first ``prev.n_rows``
    combination key rows must equal ``prev``'s (statistics may change
    freely). Raises :class:`~repro_torch.core.faults.DeltaMismatchError`
    (a ``ValueError`` subclass) otherwise — writers fall back to a fresh
    full base in that case.
    """
    if (prev.combos is None) != (cur.combos is None):
        raise DeltaMismatchError("shard kind changed between epochs")
    if prev.domains != cur.domains:
        raise DeltaMismatchError("shard domain axis changed between epochs")
    if prev.k != cur.k or prev.hash_range != cur.hash_range:
        # Config drift (a k-shrink, a resharding) rewrites row identity;
        # a row-sparse overlay can't express it — fresh full base.
        raise DeltaMismatchError(
            f"bounded-state config changed between epochs: "
            f"(k={prev.k}, hash_range={prev.hash_range}) -> "
            f"(k={cur.k}, hash_range={cur.hash_range})")
    n0, n1 = prev.n_rows, cur.n_rows
    if n1 < n0:
        raise DeltaMismatchError(f"shard shrank: {n1} < {n0} rows")
    if cur.combos is not None and n0:
        if prev.combos.shape[1] != cur.combos.shape[1]:
            raise DeltaMismatchError("worker width changed between epochs")
        if not np.array_equal(prev.combos[:n0], cur.combos[:n0]):
            raise DeltaMismatchError(
                "combination key rows are not append-only")
    changed = ((cur.counts[:n0] != prev.counts[:n0])
               | (cur.psum[:n0] != prev.psum[:n0]).any(axis=1)
               | (cur.psumsq[:n0] != prev.psumsq[:n0]).any(axis=1))
    idx = np.concatenate([np.flatnonzero(changed),
                          np.arange(n0, n1)]).astype(np.int64)
    combos_new = None
    if cur.combos is not None:
        combos_new = np.array(cur.combos[n0:n1], dtype=np.int64)
    return ShardDelta(idx=idx,
                      counts=np.asarray(cur.counts, np.int64)[idx],
                      psum=np.asarray(cur.psum, np.float64)[idx],
                      psumsq=np.asarray(cur.psumsq, np.float64)[idx],
                      n_rows=n1, prev_rows=n0, combos_new=combos_new,
                      domains=cur.domains, k=cur.k,
                      hash_range=cur.hash_range,
                      tail_folds=cur.tail_folds, evictions=cur.evictions)


def _grow_1d(arr: np.ndarray, n: int, dtype) -> np.ndarray:
    out = np.zeros(n, dtype)
    out[:len(arr)] = arr
    return out


def _grow_2d(arr: np.ndarray, n: int, dtype) -> np.ndarray:
    out = np.zeros((n, arr.shape[1]), dtype)
    out[:len(arr)] = arr
    return out


def apply_shard_delta(shard: PackedShard, delta: ShardDelta) -> PackedShard:
    """Fold one delta onto a folded shard state (chain-validating)."""
    if delta.prev_rows != shard.n_rows:
        raise CorruptShardError(f"delta chain mismatch: delta builds on "
                                f"{delta.prev_rows} rows, folded state has "
                                f"{shard.n_rows}")
    if (shard.combos is None) != (delta.combos_new is None):
        raise CorruptShardError(f"delta chain mismatch: {delta.kind} delta "
                                f"over a {shard.kind} base")
    if shard.domains != delta.domains:
        raise CorruptShardError(
            f"delta chain mismatch: domain axis {delta.domains} "
            f"delta over a {shard.domains} base")
    if shard.k != delta.k or shard.hash_range != delta.hash_range:
        raise CorruptShardError(
            f"delta chain mismatch: bounded-state config "
            f"(k={delta.k}, hash_range={delta.hash_range}) delta over a "
            f"(k={shard.k}, hash_range={shard.hash_range}) base")
    n1 = delta.n_rows
    if delta.idx.size and int(delta.idx.max()) >= n1:
        # CRC only covers bytes; a structurally corrupt delta must fail
        # with the same diagnostic class as every other malformation
        # (restore_shard's retry loop catches IOError, not IndexError).
        raise CorruptShardError(f"delta row index {int(delta.idx.max())} "
                                f"out of bounds for {n1} rows")
    counts = _grow_1d(shard.counts[:shard.n_rows], n1, np.int64)
    psum = _grow_2d(shard.psum[:shard.n_rows], n1, np.float64)
    psumsq = _grow_2d(shard.psumsq[:shard.n_rows], n1, np.float64)
    counts[delta.idx] = delta.counts
    psum[delta.idx] = delta.psum
    psumsq[delta.idx] = delta.psumsq
    combos = None
    if shard.combos is not None:
        new = delta.combos_new
        if len(new) != n1 - shard.n_rows:
            raise CorruptShardError(
                f"delta appends {len(new)} combo rows; header "
                f"says {n1 - shard.n_rows}")
        if shard.n_rows == 0:
            combos = np.array(new, dtype=np.int64)
        elif len(new) == 0:
            combos = shard.combos[:shard.n_rows]
        else:
            if new.shape[1] != shard.combos.shape[1]:
                raise CorruptShardError("worker width changed mid-chain")
            combos = np.vstack([shard.combos[:shard.n_rows], new])
    return PackedShard(counts=counts, psum=psum, psumsq=psumsq,
                       n_rows=n1, combos=combos, domains=shard.domains,
                       k=shard.k, hash_range=shard.hash_range,
                       tail_folds=delta.tail_folds,
                       evictions=delta.evictions)


def spill_shard_delta(path: str, host_id: int, epoch: int,
                      delta: ShardDelta, *, delta_of: int, base_epoch: int,
                      extra_meta: dict | None = None) -> str:
    """Atomically publish one incremental delta epoch.

    Same manifest+CRC+rename protocol as full spills; the manifest links
    the chain via ``delta_of`` (the epoch this builds on) and
    ``base_epoch`` (the chain's full base, validated by readers).
    """
    hd = _host_dir(path, host_id)
    os.makedirs(hd, exist_ok=True)
    arrays = [delta.idx, delta.counts, _wire_stats(delta.psum),
              _wire_stats(delta.psumsq)]
    meta = {"kind": delta.kind, "host_id": host_id, "epoch": epoch,
            "n_rows": delta.n_rows, "prev_rows": delta.prev_rows,
            "delta_of": int(delta_of), "base_epoch": int(base_epoch),
            "schema": ["idx", "counts", "psum", "psumsq"],
            "schema_version": 2, "domains": list(delta.domains)}
    _bounds_meta(meta, delta.k, delta.hash_range,
                 delta.tail_folds, delta.evictions)
    if extra_meta:
        meta["extra"] = dict(extra_meta)
    if delta.combos_new is not None:
        arrays.append(delta.combos_new)
        meta["schema"] = meta["schema"] + ["combos_new"]
        meta["width"] = int(delta.combos_new.shape[1])
    final = _epoch_dir(hd, epoch)
    ckpt.write_manifest_dir(final, arrays, meta=meta)
    ckpt.publish_latest(hd, epoch)
    return final


def _load_delta(hd: str, epoch: int) -> ShardDelta:
    d = _epoch_dir(hd, epoch)
    arrays, manifest = ckpt.read_manifest_dir(d)
    try:
        named = dict(zip(manifest["schema"], arrays))
        domains = _meta_domains(manifest)
        k, hash_range, tail_folds, evictions = _meta_bounds(manifest)
        return ShardDelta(idx=named["idx"].astype(np.int64),
                          counts=named["counts"].astype(np.int64),
                          psum=_unwire_stats(named["psum"], domains),
                          psumsq=_unwire_stats(named["psumsq"], domains),
                          n_rows=int(manifest["n_rows"]),
                          prev_rows=int(manifest["prev_rows"]),
                          combos_new=named.get("combos_new"),
                          domains=domains, k=k, hash_range=hash_range,
                          tail_folds=tail_folds, evictions=evictions)
    except (KeyError, TypeError, ValueError, IndexError) as e:
        raise CorruptShardError(f"malformed delta manifest in {d}: "
                                f"{e!r}") from e


class DeltaChain:
    """Reader for one host's published epoch chain.

    Walks ``delta_of`` back-pointers from ``epoch`` (normally LATEST)
    down to the full base, validating linkage as it goes: every link
    must exist (a GC'd or never-published epoch breaks the chain), every
    delta must name the same ``base_epoch``, and folding re-checks row
    monotonicity and kind/width consistency. A chain rooted at a full
    epoch of length 1 is the degenerate (pre-delta) format, so readers
    handle both transparently.
    """

    def __init__(self, host_dir: str, epoch: int):
        self.host_dir = host_dir
        self.epoch = epoch
        links: list[tuple[int, dict]] = []
        e, seen = epoch, set()
        while True:
            if e in seen:
                raise CorruptShardError(f"delta chain cycle at epoch {e} "
                                        f"under {host_dir}")
            seen.add(e)
            try:
                meta = ckpt.read_manifest_meta(_epoch_dir(host_dir, e))
            except FileNotFoundError:
                raise TornWriteError(
                    f"broken delta chain under {host_dir}: epoch {e} is "
                    f"missing (garbage-collected or never published)")
            links.append((e, meta))
            if meta.get("delta_of") is None:
                break
            try:
                e = int(meta["delta_of"])
            except (TypeError, ValueError) as err:
                raise CorruptShardError(
                    f"epoch {e} under {host_dir} has an unusable "
                    f"delta_of pointer: {meta.get('delta_of')!r}") from err
        self._links = links[::-1]          # base first, LATEST last
        self.base_epoch = self._links[0][0]
        kinds = {m.get("kind") for _, m in self._links}
        if len(kinds) != 1:
            raise CorruptShardError(
                f"mixed shard kinds in one chain: {sorted(kinds)}")
        for e_, m in self._links[1:]:
            try:
                base_ref = int(m.get("base_epoch", -1))
            except (TypeError, ValueError):
                base_ref = -1
            if base_ref != self.base_epoch:
                raise CorruptShardError(
                    f"delta epoch {e_} names base "
                    f"{m.get('base_epoch')}; chain resolves to "
                    f"{self.base_epoch}")

    @property
    def epochs(self) -> list[int]:
        """Chain epochs, base first."""
        return [e for e, _ in self._links]

    @property
    def latest_meta(self) -> dict:
        return self._links[-1][1]

    def fold(self) -> PackedShard:
        """``base + Σ deltas`` → the full shard state at ``self.epoch``."""
        shard = _load_shard(self.host_dir, self._links[0][0])
        for e, _meta in self._links[1:]:
            shard = apply_shard_delta(shard, _load_delta(self.host_dir, e))
        return shard

    def fold_partial(self) -> tuple[PackedShard, int, tuple[int, ...]]:
        """Best-effort fold: the base plus the longest intact delta prefix.

        Returns ``(shard, effective_epoch, quarantined_epochs)``. Once a
        link fails to load or apply, every later link is quarantined too
        (deltas carry replacement values against the *immediately*
        preceding state — skipping a link and folding on would merge
        rows computed against state the reader never saw, i.e. silent
        corruption; rolling the whole tail back to the last durable
        prefix can only lose recency, never correctness). Raises if the
        base itself is unreadable — there is then nothing durable to
        fall back to and the caller must quarantine the whole host.
        """
        shard = _load_shard(self.host_dir, self._links[0][0])
        effective = self._links[0][0]
        epochs = self.epochs
        for i, (e, _meta) in enumerate(self._links[1:], start=1):
            try:
                shard = apply_shard_delta(shard,
                                          _load_delta(self.host_dir, e))
            except IOError:
                return shard, effective, tuple(epochs[i:])
            effective = e
        return shard, effective, ()


def _copy_shard(s: PackedShard) -> PackedShard:
    """Deep copy — spiller snapshots must not alias live accumulators."""
    return PackedShard(
        counts=np.array(s.counts, np.int64),
        psum=np.array(s.psum, np.float64),
        psumsq=np.array(s.psumsq, np.float64), n_rows=s.n_rows,
        combos=None if s.combos is None else np.array(s.combos, np.int64),
        domains=s.domains, k=s.k, hash_range=s.hash_range,
        tail_folds=s.tail_folds, evictions=s.evictions)


# Injection seam this module owns (see faults.FAULT_SITES): the publish
# step of ShardSpiller.spill — crash-before-publish, silent straggle,
# transient failure.
_SITE_SPILLER_PUBLISH = declare_site("spiller.publish")


class ShardSpiller:
    """Per-host durable publishing engine: incremental spills + compaction.

    ``mode="delta"`` (default) publishes a full base first, then
    row-sparse :class:`ShardDelta` epochs, and every ``compact_every``-th
    publish rewrites a fresh base and garbage-collects the consumed
    chain — steady-state spill bandwidth scales with rows *touched* per
    epoch, and the host directory stays O(compact window) instead of
    O(run length). ``mode="full"`` republishes the whole shard every
    epoch (each publish also GCs the consumed predecessors — unlike the
    bare :func:`spill_shard` free function, which leaves old epochs in
    place). Readers retry around the GC window (see
    :func:`restore_shard`), so neither mode blocks concurrent gathers.

    Changed-row detection is O(rows touched), not O(rows): once a spiller
    has published an aggregator instance, subsequent deltas come from the
    aggregator's generation-stamped touched-row tracking
    (``rows_touched_since`` — a superset of the rows whose values
    changed, stamped as updates/merges land; reads are non-destructive,
    so several spillers can publish one aggregator to different
    destinations, each against its own watermark), so no host-side
    snapshot of the packed shard is retained or diffed. The exact array
    diff (:func:`compute_shard_delta` against the restored chain) is
    used only for the *first* publish of an aggregator instance this
    spiller hasn't tracked (e.g. after a restore) — which keeps a
    restarted deterministic profiler's idempotent republish an *empty*
    delta — and aggregators without touch tracking fall back to the
    per-epoch snapshot diff.

    Construction restores the on-disk chain (if any): ``resumed`` holds
    the folded aggregator, ``resumed_meta`` the LATEST manifest, and
    ``epoch`` the LATEST epoch — a host killed *anywhere* (mid-delta,
    between a delta publish and its compaction, mid-compaction) resumes
    from exactly what readers can see, so nothing is double-counted.
    """

    def __init__(self, path: str, host_id: int = 0, *, mode: str = "delta",
                 compact_every: int = 16,
                 aggregate_fn: AggregateFn | None = None,
                 faults: "faults_mod.FaultPlan | None" = None):
        if mode not in ("full", "delta"):
            raise ValueError(f"unknown spill mode {mode!r}")
        if compact_every < 1:
            raise ValueError(f"compact_every must be >= 1; "
                             f"got {compact_every}")
        self.path = path
        self.host_id = host_id
        # Captured once (explicit arg or the ambient installed plan):
        # spills may run from worker threads, where contextvars set in
        # the test thread are invisible.
        self._faults = faults_mod.resolve_plan(faults)
        self.mode = mode
        self.compact_every = compact_every
        self._hd = _host_dir(path, host_id)
        self.epoch = 0
        self.resumed = None
        self.resumed_meta: dict | None = None
        self.resumed_dir: str | None = None    # LATEST epoch's directory
        self._published = False
        # Exact-diff base for the first publish of an agg instance this
        # spiller hasn't tracked (restored chains); dropped as soon as
        # dirty tracking takes over — never refreshed per epoch.
        self._prev: PackedShard | None = None
        self._prev_rows = 0                    # rows at `epoch`
        # Weakly held tracked-aggregator identity: a weakref (not id())
        # so a recycled address can never make a fresh aggregator pass
        # as tracked, and the spiller never extends the agg's lifetime.
        self._agg_ref = None
        self._seen_gen = 0      # touch-clock watermark of the last publish
        self._base_epoch: int | None = None
        self._since_base = 0
        latest = ckpt.latest_step(self._hd)
        if latest is not None:
            chain = DeltaChain(self._hd, latest)
            self._prev = chain.fold()
            self._prev_rows = self._prev.n_rows
            self._published = True
            self.epoch = latest
            self._base_epoch = chain.base_epoch
            self._since_base = len(chain.epochs) - 1
            self.resumed = unpack_shard(self._prev,
                                        aggregate_fn=aggregate_fn)
            self.resumed_meta = chain.latest_meta
            self.resumed_dir = _epoch_dir(self._hd, latest)

    def _dirty_delta(self, dirty: np.ndarray,
                     cur: PackedShard) -> ShardDelta:
        """Delta from the aggregator's touched-row set (no prev arrays).

        Valid only for the instance this spiller last published (row
        prefix continuity is then structural: statistics rows mutate in
        place and combination keys only append).
        """
        n0, n1 = self._prev_rows, cur.n_rows
        idx = np.concatenate([dirty[dirty < n0],
                              np.arange(n0, n1)]).astype(np.int64)
        combos_new = None
        if cur.combos is not None:
            combos_new = np.array(cur.combos[n0:n1], dtype=np.int64)
        return ShardDelta(idx=idx,
                          counts=np.asarray(cur.counts, np.int64)[idx],
                          psum=np.asarray(cur.psum, np.float64)[idx],
                          psumsq=np.asarray(cur.psumsq, np.float64)[idx],
                          n_rows=n1, prev_rows=n0,
                          combos_new=combos_new, domains=cur.domains,
                          k=cur.k, hash_range=cur.hash_range,
                          tail_folds=cur.tail_folds,
                          evictions=cur.evictions)

    def spill(self, agg, epoch: int, extra_meta: dict | None = None) -> str:
        """Publish ``agg``'s state as ``epoch`` (delta when profitable)."""
        if self._published and epoch <= self.epoch:
            raise ValueError(f"epoch {epoch} already published "
                             f"(LATEST is {self.epoch})")
        plan = self._faults
        if plan is not None:
            # Named fault seam (chaos harness). All three fire *before*
            # any state mutation, so the spiller — like a real crashed
            # or stalled host — leaves durable state and its own
            # bookkeeping exactly as the previous epoch left them.
            if plan.crash_at(self.host_id, epoch):
                raise InjectedCrash(f"host {self.host_id} crashed "
                                    f"publishing epoch {epoch}")
            if plan.spill_fails(self.host_id, epoch):
                raise SpillError(f"injected transient spill failure "
                                 f"(host {self.host_id}, epoch {epoch})")
            if plan.straggles(self.host_id, epoch):
                # Silent stall: the host keeps running but its durable
                # state stops advancing (the stale-shard failure mode).
                return _epoch_dir(self._hd, self.epoch)
        cur = pack_shard(agg)
        # Touch tracking assumes append-only row identity: a bounded
        # aggregator that has evicted (or shrunk) rewrote combo rows in
        # place, and a dirty-index overlay against the *old* identity
        # would silently corrupt the chain. Such aggregators fall back
        # to the exact snapshot diff, which detects rewrites
        # (DeltaMismatchError) and publishes a fresh full base.
        trackable = (hasattr(agg, "rows_touched_since")
                     and getattr(agg, "append_only", True))
        tracked = (trackable and self._agg_ref is not None
                   and self._agg_ref() is agg)
        full = (self.mode == "full" or not self._published
                or self._since_base + 1 >= self.compact_every)
        delta = None
        gen = agg.touch_generation() if trackable else 0
        if not full:
            if tracked and cur.n_rows >= self._prev_rows:
                delta = self._dirty_delta(
                    agg.rows_touched_since(self._seen_gen), cur)
            elif self._prev is not None:
                try:
                    delta = compute_shard_delta(self._prev, cur)
                except ValueError:
                    delta = None
            # Non-append-only evolution (kind/width/domain change,
            # shrink) or an untracked aggregator instance: a delta
            # can't express it — publish a fresh base.
            full = delta is None
        if full:
            out = _spill_packed(self.path, self.host_id, epoch, cur,
                                extra_meta=extra_meta)
            self._gc_consumed(keep=epoch)
            self._base_epoch = epoch
            self._since_base = 0
        else:
            out = spill_shard_delta(self.path, self.host_id, epoch,
                                    delta, delta_of=self.epoch,
                                    base_epoch=self._base_epoch,
                                    extra_meta=extra_meta)
            self._since_base += 1
        # Advance the watermark only now that the epoch is durable: a
        # failed publish above leaves _seen_gen untouched, so every
        # still-unpublished row reappears in the next attempt's delta.
        if trackable:
            # Touch tracking owns change detection from here on: drop
            # the exact-diff base (if any) — it is never refreshed.
            self._agg_ref = weakref.ref(agg)
            self._seen_gen = gen
            self._prev = None
        else:
            self._agg_ref = None
            self._prev = _copy_shard(cur)
        self._prev_rows = cur.n_rows
        self._published = True
        self.epoch = epoch
        return out

    def _gc_consumed(self, keep: int) -> None:
        """Drop epoch dirs made unreachable by the fresh base ``keep``.

        Runs only after ``keep`` is durable and LATEST points at it, so
        a crash mid-GC leaves extra (ignored) dirs, never a broken
        chain. ``.tmp-`` litter from crashed writers doesn't match the
        epoch pattern and is left alone.
        """
        try:
            names = os.listdir(self._hd)
        # audit: allow(no-silent-except) nothing published -> nothing to GC
        except FileNotFoundError:
            return
        for name in names:
            m = _EPOCH_DIR_RE.match(name)
            if m and int(m.group(1)) != keep:
                shutil.rmtree(os.path.join(self._hd, name),
                              ignore_errors=True)


# -- profiler strategies -------------------------------------------------------

class CollectiveExchange:
    """``exchange=`` strategy: reduce the final shard over a mesh axis.

    Production: every host joins the same process group and each passes
    its local aggregator; on one card, a world of one runs the same
    pack → collective → merge → unpack path. Without ``mesh``, one is
    built on ``device`` at the first :meth:`reduce` (NCCL on ``"cuda"``,
    the default; gloo on ``"cpu"``); asking for CUDA where torch sees no
    GPU raises here.
    """

    def __init__(self, mesh=None, *, axis: str = "hosts",
                 capacity: int | None = None, width: int | None = None,
                 aggregate_fn: AggregateFn | None = None, device="cuda"):
        self.mesh = mesh
        self.axis = axis
        self.capacity = capacity
        self.width = width
        self.aggregate_fn = aggregate_fn
        self.device = (resolve_device(device) if mesh is None
                       else torch.device(mesh.device_type))

    def reduce(self, agg):
        return collective_reduce([agg], mesh=self.mesh, axis=self.axis,
                                 capacity=self.capacity, width=self.width,
                                 aggregate_fn=self.aggregate_fn,
                                 device=self.device)


class CheckpointExchange:
    """``exchange=`` strategy: durable spill + gather via shared storage.

    ``spill()`` may be called per epoch for fault tolerance (the serving
    accountant does); ``reduce()`` publishes the final state and merges
    every host's LATEST shard. ``resumed`` exposes the host's previous
    spill (if any) for *accumulating* callers that replay only the work
    after it; deterministic re-runs (the profiler) must ignore it — they
    regenerate the full shard and republish LATEST idempotently (in
    delta mode, the republish is an empty delta epoch: the regenerated
    state matches the restored chain row for row).

    ``mode="delta"`` (default) publishes incremental epochs with
    compaction every ``compact_every`` publishes; ``mode="full"``
    rewrites the whole shard each epoch (see :class:`ShardSpiller`).
    """

    def __init__(self, path: str, host_id: int = 0, *,
                 aggregate_fn: AggregateFn | None = None,
                 mode: str = "delta", compact_every: int = 16,
                 quorum: QuorumPolicy | None = None,
                 faults: "faults_mod.FaultPlan | None" = None):
        self.path = path
        self.host_id = host_id
        self.aggregate_fn = aggregate_fn
        self.quorum = quorum
        self._spiller = ShardSpiller(path, host_id, mode=mode,
                                     compact_every=compact_every,
                                     aggregate_fn=aggregate_fn,
                                     faults=faults)
        self.resumed = self._spiller.resumed
        self.epoch = self._spiller.epoch

    def spill(self, agg) -> str:
        self.epoch += 1
        return self._spiller.spill(agg, self.epoch)

    def reduce(self, agg):
        """Publish the final state and merge the fleet's LATEST shards.

        With a ``quorum`` policy the merge degrades instead of failing;
        the merged aggregator is returned (keeping the strategy
        interface) and the full :class:`GatherResult` provenance is kept
        on ``self.last_gather`` for callers that disclose coverage.
        """
        self.spill(agg)
        if self.quorum is not None:
            self.last_gather = gather_shards(self.path,
                                             aggregate_fn=self.aggregate_fn,
                                             quorum=self.quorum)
            return self.last_gather.agg
        return gather_shards(self.path, aggregate_fn=self.aggregate_fn)
