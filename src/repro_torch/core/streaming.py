"""Streaming fleet-scale sample aggregation (constant extra memory).

ALEA's accuracy comes from sample volume: a fleet sampling at the paper's
~10 ms period (let alone PowerSensor3-class multi-kHz sensors) produces
billions of (region_id, power) samples — far more than the one-shot
``np.bincount`` path in :mod:`repro_torch.core.estimator` can hold in memory.
This module makes the estimator pipeline *streaming*:

* :class:`StreamingAggregator` folds sample chunks of any size into the
  per-region sufficient statistics (counts, Σpow, Σpow²) behind the same
  pluggable ``AggregateFn`` seam the one-shot path uses, so the CUDA
  ``kernels/sample_attr`` kernel drops in per block. ``merge()`` reduces shards from multiple hosts — the statistics
  are associative+commutative, so any reduction tree is exact.

* :class:`CombinationInterner` replaces ``encode_combinations``'s
  full-matrix ``np.unique(axis=0)`` with incremental hash-interning of
  per-worker region vectors: each chunk is deduplicated locally (sort
  bounded by chunk size) and its unique rows interned into a dict, so the
  multi-worker path runs in one pass with O(chunk + distinct combos)
  memory and no re-sort of previously seen data.

* :class:`StreamingCombinationAggregator` composes the two for §4.4
  combination-level attribution over chunked multi-worker streams.

Statistics carry an optional power-rail domain axis: a ``domains``
axis of D rails stores ``[R, C]`` channel matrices (the rails plus, for
D > 1, the total-power channel — :func:`channels_for`), with the scalar
``psum``/``psumsq`` views unchanged for single-domain streams. The
aggregators also maintain generation-stamped touched-row tracking the
delta spiller (:class:`repro_torch.core.exchange.ShardSpiller`) diffs against
(:meth:`StreamingAggregator.rows_touched_since` — non-destructive, so
any number of spillers consume one aggregator independently).

Peak extra memory is O(chunk + R·C) instead of O(n); see
``benchmarks/aggregation.py`` for the throughput trajectory.
"""

from __future__ import annotations

from typing import Iterable, Sequence

import numpy as np

from repro_torch.core import estimator as estimator_mod
from repro_torch.core import sketch as sketch_mod
from repro_torch.core.estimator import (AggregateFn, EstimateSet,
                                  combination_names_from_matrix,
                                  estimates_from_statistics)
from repro_torch.core.faults import SketchConfigError
from repro_torch.core.sketch import HashRange, combo_hashes

__all__ = [
    "DEFAULT_CHUNK",
    "channels_for",
    "StreamingAggregator",
    "CombinationInterner",
    "StreamingCombinationAggregator",
    "stream_estimate",
]

DEFAULT_CHUNK = 65536

_I64MAX = np.iinfo(np.int64).max


def _as_hash_range(hr) -> HashRange | None:
    """Normalize a hash-range argument (HashRange, (lo, hi) pair, None)."""
    if hr is None or isinstance(hr, HashRange):
        return hr
    lo, hi = hr
    return HashRange(int(lo), int(hi))


def _as_channels(arr, c: int) -> np.ndarray:
    """Normalize pre-aggregated Σ statistics to the [R, C] channel layout
    (1-D arrays are the single-channel scalar form)."""
    arr = np.asarray(arr, dtype=np.float64)
    if arr.ndim == 1:
        if c != 1:
            raise ValueError(
                f"1-D statistics for a {c}-channel aggregator; pass the "
                f"[rows, {c}] channel matrix")
        return arr[:, None]
    if arr.ndim == 2 and arr.shape[1] == c:
        return arr
    raise ValueError(f"statistics shape {arr.shape} does not match "
                     f"{c} channels")


def channels_for(domains: Sequence[str] | int) -> int:
    """Statistic channels for a domain axis (names or rail count): the
    rails, plus a dedicated total-power channel when D > 1 (Σpow² of the
    total is not derivable from per-rail Σpow² — squares don't sum
    across rails — and the estimator's power CI needs it). D = 1 is the
    pre-rail scalar layout: the single rail *is* the total.

    This is THE channel-layout rule — the wire schema
    (:mod:`repro_torch.core.exchange`), the device-pipeline carries and the
    estimator split all derive from it; change it nowhere else.
    """
    d = domains if isinstance(domains, int) else len(domains)
    return d + (1 if d > 1 else 0)


class StreamingAggregator:
    """Constant-memory accumulator of per-region sample statistics.

    Consumes (region_ids, powers) chunks of any size via :meth:`update`;
    holds a [R] ``counts`` int64 accumulator plus [R, C] ``chan_psum`` /
    ``chan_psumsq`` f64 channel accumulators, where the channels are the
    power-rail ``domains`` plus — when multi-domain — the total (see
    :func:`channels_for`). The default single-domain aggregator stores
    exactly the pre-rail (counts, Σpow, Σpow²) triple; ``psum``/``psumsq``
    remain its scalar-total views. ``aggregate_fn`` is the per-chunk
    reducer — defaults to the numpy reference, swap in
    ``kernels.sample_attr.ops.as_aggregate_fn`` for the CUDA kernel
    (applied per channel). :meth:`merge` combines shards (multi-host
    reduction; domain axes must match).

    The aggregator also maintains generation-stamped *touched-row
    tracking* (:meth:`rows_touched_since` / :meth:`touch_generation`):
    every row whose statistics may have changed since a consumer's
    watermark. :class:`repro_torch.core.exchange.ShardSpiller` diffs against
    it instead of deep-copying the full packed shard each publish,
    dropping the O(rows) per-epoch snapshot — and because reads are
    non-destructive, independent spillers can publish one aggregator
    to different destinations without corrupting each other's chains.
    """

    def __init__(self, num_regions: int, *,
                 aggregate_fn: AggregateFn | None = None,
                 domains: Sequence[str] = ("total",)):
        if num_regions < 0:
            raise ValueError(f"num_regions must be >= 0; got {num_regions}")
        self._agg = aggregate_fn or estimator_mod.aggregate_samples_np
        self.domains = tuple(domains)
        if not self.domains:
            raise ValueError("domains must name at least one rail")
        c = channels_for(self.domains)
        self.counts = np.zeros(num_regions, dtype=np.int64)
        self.chan_psum = np.zeros((num_regions, c), dtype=np.float64)
        self.chan_psumsq = np.zeros((num_regions, c), dtype=np.float64)
        # Touched-row tracking, generation-based: every mutation stamps
        # its rows with the current generation, and each consumer (a
        # ShardSpiller) remembers the generation it last published —
        # so multiple independent consumers of one aggregator never
        # steal each other's change sets, and a failed publish needs no
        # repair (the consumer simply doesn't advance).
        self._touch_gen = np.zeros(num_regions, dtype=np.int64)
        self._gen = 1

    @classmethod
    def from_statistics(cls, counts, psum, psumsq, *,
                        aggregate_fn: AggregateFn | None = None,
                        domains: Sequence[str] = ("total",)
                        ) -> "StreamingAggregator":
        """Wrap pre-aggregated sufficient statistics in an aggregator.

        Entry point for the fused device pipeline
        (:mod:`repro_torch.core.device_pipeline`): its final carry lands here so
        merge/exchange/estimates compose identically to host-folded runs.
        ``psum``/``psumsq`` are either 1-D [R] (single-domain) or [R, C]
        channel matrices matching ``domains``.
        """
        counts = np.asarray(counts, dtype=np.int64)
        agg = cls(len(counts), aggregate_fn=aggregate_fn, domains=domains)
        agg.counts += counts
        agg.chan_psum += _as_channels(psum, agg.num_channels)
        agg.chan_psumsq += _as_channels(psumsq, agg.num_channels)
        agg._mark_touched((agg.counts != 0) | agg.chan_psum.any(axis=1)
                          | agg.chan_psumsq.any(axis=1))
        return agg

    @property
    def num_regions(self) -> int:
        return len(self.counts)

    @property
    def num_domains(self) -> int:
        return len(self.domains)

    @property
    def num_channels(self) -> int:
        return self.chan_psum.shape[1]

    @property
    def n_total(self) -> int:
        return int(self.counts.sum())

    # The scalar (total-power) statistics stay first-class: views of the
    # last channel, which at D = 1 is also the only rail — existing
    # consumers of (counts, psum, psumsq) are unaffected by the rails.
    @property
    def psum(self) -> np.ndarray:
        return self.chan_psum[:, -1]

    @psum.setter
    def psum(self, value) -> None:
        self.chan_psum[:, -1] = value

    @property
    def psumsq(self) -> np.ndarray:
        return self.chan_psumsq[:, -1]

    @psumsq.setter
    def psumsq(self, value) -> None:
        self.chan_psumsq[:, -1] = value

    @property
    def rail_psum(self) -> np.ndarray:
        """Per-domain Σpow [R, D] (at D = 1, identical to ``psum``)."""
        return self.chan_psum[:, :self.num_domains]

    @property
    def rail_psumsq(self) -> np.ndarray:
        return self.chan_psumsq[:, :self.num_domains]

    def grow(self, num_regions: int) -> None:
        """Widen the accumulators (new regions observed mid-stream)."""
        extra = num_regions - self.num_regions
        if extra < 0:
            raise ValueError("cannot shrink a StreamingAggregator")
        if extra:
            c = self.num_channels
            self.counts = np.concatenate(
                [self.counts, np.zeros(extra, np.int64)])
            self.chan_psum = np.concatenate(
                [self.chan_psum, np.zeros((extra, c), np.float64)])
            self.chan_psumsq = np.concatenate(
                [self.chan_psumsq, np.zeros((extra, c), np.float64)])
            self._touch_gen = np.concatenate(
                [self._touch_gen, np.zeros(extra, np.int64)])

    def _channels_of(self, powers: np.ndarray) -> np.ndarray:
        """Normalize a powers chunk to the [n, C] channel matrix."""
        powers = np.asarray(powers, dtype=np.float64)
        d, c = self.num_domains, self.num_channels
        if powers.ndim == 1:
            if d > 1:
                raise ValueError(
                    f"scalar powers for a {d}-domain aggregator; pass "
                    f"[n, {d}] per-rail readings")
            return powers[:, None]
        if powers.ndim != 2 or powers.shape[1] not in (d, c):
            raise ValueError(
                f"powers shape {powers.shape} matches neither [n, D={d}] "
                f"rails nor [n, C={c}] channels")
        if powers.shape[1] == c:
            return powers
        return np.concatenate(
            [powers, powers.sum(axis=1, keepdims=True)], axis=1)

    def update(self, region_ids: np.ndarray,
               powers: np.ndarray) -> "StreamingAggregator":
        """Fold one chunk into the accumulators. Returns self (chainable).

        ``powers`` is [n] (single-domain), [n, D] per-rail readings, or a
        precomputed [n, C] channel matrix.
        """
        region_ids = np.asarray(region_ids)
        if len(region_ids) == 0:
            return self
        chan = self._channels_of(powers)
        c = self.num_channels
        if c == 1 or self._agg is not estimator_mod.aggregate_samples_np:
            # Single channel, or a plugged kernel (which fuses counts
            # with its sums on device): one aggregate_fn call per
            # channel, counts taken from the first.
            for j in range(c):
                cc, s, sq = self._agg(region_ids, chan[:, j],
                                      self.num_regions)
                if j == 0:
                    self.counts += np.asarray(cc, dtype=np.int64)
                self.chan_psum[:, j] += np.asarray(s, dtype=np.float64)
                self.chan_psumsq[:, j] += np.asarray(sq, dtype=np.float64)
        else:
            # Default numpy reducer, multi-channel: share one index pass
            # — counts once, then a weighted bincount per channel
            # (aggregate_samples_np would recompute counts C times).
            r = self.num_regions
            self.counts += np.bincount(region_ids,
                                       minlength=r).astype(np.int64)
            for j in range(c):
                w = chan[:, j]
                self.chan_psum[:, j] += np.bincount(region_ids, weights=w,
                                                    minlength=r)
                self.chan_psumsq[:, j] += np.bincount(
                    region_ids, weights=w * w, minlength=r)
        self._touch_gen[region_ids] = self._gen
        return self

    def update_stream(self, chunks: Iterable[tuple[np.ndarray, np.ndarray]]
                      ) -> "StreamingAggregator":
        """Drain an iterator of (region_ids, powers) chunks."""
        for rids, pows in chunks:
            self.update(rids, pows)
        return self

    def merge(self, other: "StreamingAggregator") -> "StreamingAggregator":
        """Fold another shard's statistics into this one (associative)."""
        if other.domains != self.domains:
            raise ValueError(f"domain axis mismatch at merge: "
                             f"{other.domains} != {self.domains}")
        if other.num_regions > self.num_regions:
            self.grow(other.num_regions)
        r = other.num_regions
        self.counts[:r] += other.counts
        self.chan_psum[:r] += other.chan_psum
        self.chan_psumsq[:r] += other.chan_psumsq
        touched = np.zeros(self.num_regions, bool)
        touched[:r] = ((other.counts != 0)
                       | other.chan_psum.any(axis=1)
                       | other.chan_psumsq.any(axis=1))
        self._mark_touched(touched)
        return self

    def statistics(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """(counts, Σpow, Σpow²) — copies, safe to hand across hosts."""
        return self.counts.copy(), self.psum.copy(), self.psumsq.copy()

    def channel_statistics(self) -> tuple[np.ndarray, np.ndarray,
                                          np.ndarray]:
        """(counts [R], Σpow [R, C], Σpow² [R, C]) — copies."""
        return (self.counts.copy(), self.chan_psum.copy(),
                self.chan_psumsq.copy())

    def _mark_touched(self, mask: np.ndarray) -> None:
        self._touch_gen[mask] = self._gen

    def touch_generation(self) -> int:
        """Snapshot the touch clock: rows mutated *after* this call
        stamp a strictly greater generation. A consumer publishes the
        rows of :meth:`rows_touched_since`, then stores this snapshot
        as its new watermark only once the publish is durable — a
        failed publish simply doesn't advance, so nothing is lost."""
        g = self._gen
        self._gen = g + 1
        return g

    def rows_touched_since(self, gen: int) -> np.ndarray:
        """Rows touched after watermark ``gen`` (sorted indices) — a
        superset of the rows whose values actually changed, which is
        all the delta-spill contract needs. Non-destructive: any number
        of consumers read independently with their own watermarks."""
        return np.flatnonzero(self._touch_gen > gen)

    def estimates(self, t_exec: float, names: Sequence[str], *,
                  alpha: float = 0.05, drop_empty: bool = True,
                  coverage=None, tail=None) -> EstimateSet:
        """Finalize into an EstimateSet (vectorized Eq. 4-16).

        ``coverage`` attaches degraded-gather provenance (see
        ``exchange.GatherResult``) so reports disclose partial fleets;
        ``tail`` attaches bounded-mode fold disclosure (the combination
        aggregator passes its :meth:`tail_info`).
        """
        d = self.num_domains
        return estimates_from_statistics(
            self.counts, self.psum, self.psumsq, t_exec, names, alpha=alpha,
            drop_empty=drop_empty,
            rail_psum=self.rail_psum if d > 1 else None,
            rail_psumsq=self.rail_psumsq if d > 1 else None,
            domains=self.domains if d > 1 else None, coverage=coverage,
            tail=tail)


class CombinationInterner:
    """Incremental hash-interning of per-sample worker region vectors.

    Each :meth:`encode` call deduplicates its chunk locally (``np.unique``
    over chunk rows only — the sort is bounded by chunk size) and interns
    the chunk's unique rows into a persistent dict keyed by row bytes.
    Combination ids are assigned in first-appearance order, so ids are
    stream-order dependent but the (id → tuple) table always maps every
    sample to the same combination tuple as the one-shot path.

    The interner also keeps first-class *pressure counters* so operators
    can see when the exact path is about to blow up: ``distinct`` (live
    table size), ``intern_misses`` (total insert-on-miss events — in
    exact mode equal to ``distinct``, diverging once bounded mode
    recycles slots) and ``growth_events`` (crossings of the next
    power-of-two capacity — a proxy for device-table recompiles, which
    grow the packed key table by doubling). They flow to
    ``EstimateSet.coverage`` and ``ServeReport.coverage()``.
    """

    def __init__(self):
        self._table: dict[bytes, int] = {}
        self._combos: list[tuple[int, ...]] = []
        self._width: int | None = None
        self.intern_misses = 0
        self.growth_events = 0
        self._pow2_cap = 0

    def __len__(self) -> int:
        return len(self._combos)

    @property
    def distinct(self) -> int:
        """Live table size (id-space width), a pressure counter."""
        return len(self._combos)

    def _note_miss(self) -> None:
        self.intern_misses += 1
        while len(self._combos) > self._pow2_cap:
            self._pow2_cap = max(1, self._pow2_cap * 2)
            self.growth_events += 1

    @property
    def combos(self) -> list[tuple[int, ...]]:
        """Combination tuples indexed by combination id."""
        return list(self._combos)

    def combo_matrix(self) -> np.ndarray:
        """The key table as an int64 [k, width] matrix (shard wire format).

        This is what a shard serializes: its *local* id space is the row
        order, and receivers dedupe lazily by interning the rows into
        their own table (:meth:`intern_rows`) at merge time.
        """
        w = self._width if self._width is not None else 0
        if not self._combos:
            return np.empty((0, w), dtype=np.int64)
        return np.asarray(self._combos, dtype=np.int64)

    def intern_rows(self, mat: np.ndarray) -> np.ndarray:
        """Intern each row of an int64 [k, width] matrix; returns ids [k].

        The lazy cross-shard dedup primitive: another shard's key table
        maps local id ``i`` → union id ``intern_rows(table)[i]``. Rows are
        hashed as contiguous bytes (no per-row tuple boxing on re-intern).
        """
        mat = np.ascontiguousarray(np.asarray(mat), dtype=np.int64)
        if mat.ndim != 2:
            raise ValueError(f"expected [k, workers]; got shape {mat.shape}")
        if len(mat):
            if self._width is None:
                self._width = mat.shape[1]
            elif mat.shape[1] != self._width:
                raise ValueError(f"worker count mismatch at merge: "
                                 f"{mat.shape[1]} != {self._width}")
        table = self._table
        combos = self._combos
        ids = np.empty(len(mat), dtype=np.int64)
        for k in range(len(mat)):
            key = mat[k].tobytes()
            cid = table.get(key)
            if cid is None:
                cid = len(combos)
                table[key] = cid
                combos.append(tuple(int(v) for v in mat[k]))
                self._note_miss()
            ids[k] = cid
        return ids

    def intern(self, combo: tuple[int, ...]) -> int:
        """Intern a single combination tuple; returns its id."""
        key = np.asarray(combo, dtype=np.int64).tobytes()
        cid = self._table.get(key)
        if cid is None:
            cid = len(self._combos)
            self._table[key] = cid
            self._combos.append(tuple(int(v) for v in combo))
            if self._width is None:
                self._width = len(self._combos[-1])
            self._note_miss()
        return cid

    def find_row(self, row: np.ndarray) -> int | None:
        """Id of an int64 combination row, or None if never interned."""
        key = np.ascontiguousarray(row, dtype=np.int64).tobytes()
        return self._table.get(key)

    def replace(self, cid: int, combo: tuple[int, ...]) -> int:
        """Recycle slot ``cid`` for a new combination (bounded-mode
        eviction). The old key is forgotten; the slot keeps its id. The
        caller owns the statistics handoff (fold-then-zero) — this only
        rewrites identity. Counts as an intern miss (the new key missed),
        but not as table growth (the id space is unchanged)."""
        new = tuple(int(v) for v in combo)
        new_key = np.asarray(new, dtype=np.int64).tobytes()
        if new_key in self._table:
            raise ValueError("replacement combination is already interned")
        old_key = np.asarray(self._combos[cid], dtype=np.int64).tobytes()
        del self._table[old_key]
        self._table[new_key] = cid
        self._combos[cid] = new
        self.intern_misses += 1
        return cid

    def encode(self, region_id_matrix: np.ndarray) -> np.ndarray:
        """Map one chunk [c, workers] of region-id vectors to comb ids [c]."""
        mat = np.ascontiguousarray(np.asarray(region_id_matrix),
                                   dtype=np.int64)
        if mat.ndim != 2:
            raise ValueError(f"expected [n, workers]; got shape {mat.shape}")
        if self._width is None:
            self._width = mat.shape[1]
        elif mat.shape[1] != self._width:
            raise ValueError(f"worker count changed mid-stream: "
                             f"{mat.shape[1]} != {self._width}")
        if len(mat) == 0:
            return np.empty(0, dtype=np.int64)
        uniq, inverse = np.unique(mat, axis=0, return_inverse=True)
        # Hash the contiguous row bytes directly; the tuple form is only
        # materialized on first insertion (steady state re-interns cost a
        # dict lookup per distinct row, no boxing).
        local_to_global = self.intern_rows(uniq)
        return local_to_global[inverse.reshape(-1)]


class StreamingCombinationAggregator:
    """§4.4 combination attribution over chunked multi-worker streams.

    Composes a :class:`CombinationInterner` (growing combination id space)
    with a :class:`StreamingAggregator` that widens as new combinations
    appear. ``merge()`` remaps the other shard's combination ids through
    this shard's interner, so multi-host reductions agree with a single
    stream over the concatenated data.

    **Bounded mode** (``k=``): a space-saving-style heavy-hitters tier
    caps the table at ``k`` identified rows plus one ``other`` row per
    region (``(region, -1, ..., -1)`` — :data:`repro_torch.core.sketch.OTHER`).
    A new combination admitted against a full table either evicts the
    lowest-count resident row (when its chunk weight exceeds that count)
    — folding the victim's full (counts, Σpow, Σpow²) triple into its
    region's ``other`` row first, so *per-region totals stay bit-exact*
    and only tail identity coarsens — or folds straight into ``other``.
    All decisions derive from the deterministic fold counters (never wall
    clock), and rows already carrying samples in the current chunk are
    never its eviction victims (their pending weight isn't folded yet).
    With ``k >= distinct`` the policy never fires and the bounded path is
    bit-exact to exact mode (the pinned oracle). Exact mode (``k=None``)
    stays the default and is completely unchanged.

    **Hash-range ownership** (``hash_range=``): the aggregator declares
    the splitmix64 hash interval of combination keys it owns; ingests
    and merges refuse *identified* rows outside it (and merges refuse
    peers declaring a different range), so a per-range shuffle over
    spilled shards can't double-count. Per-region ``other`` rows are
    exempt from ownership: a bounded shard mints them locally at fold
    time, so a sentinel key's own hash is arbitrary — it lives wherever
    its folds happened, and spilling / re-merging a folded sharded
    table must round-trip. See :meth:`filter_range`.
    """

    def __init__(self, *, aggregate_fn: AggregateFn | None = None,
                 domains: Sequence[str] = ("total",),
                 k: int | None = None, hash_range=None):
        if k is not None and k < 1:
            raise ValueError(f"k must be >= 1 (or None for exact); got {k}")
        self.interner = CombinationInterner()
        self.agg = StreamingAggregator(0, aggregate_fn=aggregate_fn,
                                       domains=domains)
        self.k = None if k is None else int(k)
        self.hash_range = _as_hash_range(hash_range)
        self._other_by_region: dict[int, int] = {}
        self._other_rows: set[int] = set()
        self.tail_folds = 0      # fold events (evictions + tail routings)
        self.evictions = 0       # identified rows evicted (slot recycled)
        self._recycles = 0       # identity rewrites (breaks append-only)

    @classmethod
    def from_table(cls, combo_matrix: np.ndarray, counts: np.ndarray,
                   psum: np.ndarray, psumsq: np.ndarray, *,
                   aggregate_fn: AggregateFn | None = None,
                   domains: Sequence[str] = ("total",),
                   k: int | None = None, hash_range=None
                   ) -> "StreamingCombinationAggregator":
        """Build from a key table + statistics (device-pipeline results,
        deserialized shards): ids are assigned in the table's row order,
        so a table in interner order round-trips exactly. ``psum``/
        ``psumsq`` are 1-D (single-domain) or [k, C] channel matrices.
        ``k``/``hash_range`` reconstruct a bounded/sharded table (its
        ``other`` rows are recognized by their sentinel fields)."""
        agg = cls(aggregate_fn=aggregate_fn, domains=domains, k=k,
                  hash_range=hash_range)
        agg.merge_table(combo_matrix, counts, psum, psumsq, k=k,
                        hash_range=hash_range)
        return agg

    @property
    def n_total(self) -> int:
        return self.agg.n_total

    @property
    def domains(self) -> tuple[str, ...]:
        return self.agg.domains

    @property
    def other_rows(self) -> int:
        """Number of per-region ``other`` (tail bucket) rows."""
        return len(self._other_rows)

    @property
    def resident(self) -> int:
        """Identified (non-``other``) rows currently holding identity."""
        return len(self.interner) - len(self._other_rows)

    @property
    def append_only(self) -> bool:
        """True while no slot has ever been recycled — the structural
        precondition for the spiller's cheap touched-row delta path.
        Once an eviction (or a :meth:`shrink_k` rebuild) rewrites row
        identity, dirty-row deltas would silently misattribute recycled
        slots, so the spiller must fall back to exact diffing."""
        return self._recycles == 0

    def touch_generation(self) -> int:
        """Delegates the spiller's touched-row contract to the inner
        statistics aggregator. Only valid for structural-append-only
        histories — consumers must check :attr:`append_only` (bounded
        mode recycles slots on eviction, rewriting row identity)."""
        return self.agg.touch_generation()

    def rows_touched_since(self, gen: int) -> np.ndarray:
        return self.agg.rows_touched_since(gen)

    # -- bounded-mode internals ----------------------------------------------

    def _sync_rows(self) -> None:
        if len(self.interner) > self.agg.num_regions:
            self.agg.grow(len(self.interner))

    def _other_id(self, region: int) -> int:
        """Id of ``region``'s tail bucket row, interning it on demand."""
        oid = self._other_by_region.get(region)
        if oid is None:
            width = self.interner._width
            oid = self.interner.intern(sketch_mod.other_row(region, width))
            self._other_by_region[region] = oid
            self._other_rows.add(oid)
            self._sync_rows()
        return oid

    def _register_other(self, cid: int, region: int) -> None:
        """Record an already-interned sentinel row as a tail bucket."""
        self._other_by_region.setdefault(region, cid)
        self._other_rows.add(cid)

    def _fold_stats(self, src: int, dst: int) -> None:
        """Move row ``src``'s full statistics triple onto ``dst`` and zero
        ``src`` — addition, so totals are preserved exactly."""
        a = self.agg
        a.counts[dst] += a.counts[src]
        a.chan_psum[dst] += a.chan_psum[src]
        a.chan_psumsq[dst] += a.chan_psumsq[src]
        a.counts[src] = 0
        a.chan_psum[src] = 0.0
        a.chan_psumsq[src] = 0.0
        a._touch_gen[src] = a._gen
        a._touch_gen[dst] = a._gen

    def _find_victim(self, protected: set[int]) -> tuple[int, int]:
        """Lowest-count evictable row (ties → lowest id): never an
        ``other`` row, never a row carrying unfolded weight from the
        chunk in flight (``protected`` — its count is not current yet).
        Returns (id, effective count); the count is ``_I64MAX`` when
        nothing is evictable."""
        n = len(self.interner)
        eff = self.agg.counts[:n].copy()
        masked = self._other_rows | protected
        if masked:
            eff[np.fromiter(masked, np.int64, len(masked))] = _I64MAX
        vid = int(np.argmin(eff))
        return vid, int(eff[vid])

    def _admit_or_fold(self, row: np.ndarray, weight: int,
                       protected: set[int],
                       exhausted: list[bool],
                       floor: list[int]) -> int:
        """Admission decision for one *new* combination carrying
        ``weight`` samples: intern while room, else evict the min-count
        resident (when ``weight`` beats it) or fold into the region's
        ``other`` row. Deterministic — counts and ids only.

        ``exhausted`` and ``floor`` are single-cell scan caches scoped
        to ONE ingest call: both are only valid while the masked
        (chunk-protected) set keeps growing, so a fresh ``[False]`` /
        ``[0]`` pair must be passed per update()/merge_table(). A
        cached floor that outlived its chunk would mask rows protected
        *then* but evictable *now*, permanently inflating the admission
        bar past the true minimum."""
        if self.resident < self.k:
            cid = self.interner.intern(tuple(int(v) for v in row))
            self._sync_rows()
            protected.add(cid)
            return cid
        if weight > floor[0] and not exhausted[0]:
            vid, vcount = self._find_victim(protected)
            if vcount != _I64MAX:
                # Within this ingest, counts only grow and the masked
                # set only widens, so the scanned min stays a valid
                # lower bound — later light arrivals skip the scan.
                floor[0] = vcount
            else:
                # Every resident is masked (chunk-protected or an
                # ``other`` row). The masked set only grows within a
                # chunk, so no victim can appear before the next chunk:
                # skip further scans instead of re-walking the table
                # for every tail arrival.
                exhausted[0] = True
            if weight > vcount:
                # The victim folds into *its own* region's tail bucket
                # (not the arriving row's — regions must never bleed).
                oid = self._other_id(int(self.interner._combos[vid][0]))
                self._fold_stats(vid, oid)
                self.interner.replace(vid, tuple(int(v) for v in row))
                self._recycles += 1
                self.evictions += 1
                self.tail_folds += 1
                protected.add(vid)
                return vid
        self.tail_folds += 1
        return self._other_id(int(row[0]))

    def _check_owned(self, mat: np.ndarray, verb: str) -> None:
        """Refuse identified rows whose key hash falls outside the owned
        range — a live sharded aggregator fails at the mis-routed ingest
        or merge, never by silently accumulating unowned keys that only
        surface at a downstream merge/restore. Sentinel (``other``) rows
        are exempt: folds mint them locally, wherever eviction happens,
        so their placement derives from the fold site, not their hash."""
        if self.hash_range is None or len(mat) == 0:
            return
        ident = ~sketch_mod.is_other_rows(mat)
        if ident.any() and not self.hash_range.owns(
                combo_hashes(mat[ident])).all():
            kind = "shuffle" if verb == "merge" else "ingest"
            raise SketchConfigError(
                f"{verb} offers combination rows outside this "
                f"aggregator's owned hash range "
                f"{self.hash_range.as_tuple()}; mis-routed {kind} — "
                f"route rows to their range owner first")

    # -- ingest ---------------------------------------------------------------

    def update(self, region_id_matrix: np.ndarray,
               powers: np.ndarray) -> "StreamingCombinationAggregator":
        if self.k is None:
            if self.hash_range is not None:
                m = np.ascontiguousarray(np.asarray(region_id_matrix),
                                         dtype=np.int64)
                if m.ndim == 2:
                    self._check_owned(m, "update")
            cids = self.interner.encode(region_id_matrix)
            self._sync_rows()
            self.agg.update(cids, powers)
            return self
        mat = np.ascontiguousarray(np.asarray(region_id_matrix),
                                   dtype=np.int64)
        if mat.ndim != 2:
            raise ValueError(f"expected [n, workers]; got shape {mat.shape}")
        if len(mat) and mat.shape[1] < 2:
            raise SketchConfigError(
                "bounded combination tables need width >= 2 (the region "
                "axis plus at least one folded axis); at width 1 use the "
                "plain StreamingAggregator")
        if len(mat) == 0:
            return self
        if self.interner._width is None:
            self.interner._width = mat.shape[1]
        elif mat.shape[1] != self.interner._width:
            raise ValueError(f"worker count changed mid-stream: "
                             f"{mat.shape[1]} != {self.interner._width}")
        uniq, inverse = np.unique(mat, axis=0, return_inverse=True)
        self._check_owned(uniq, "update")
        weights = np.bincount(inverse.reshape(-1), minlength=len(uniq))
        ids = np.empty(len(uniq), dtype=np.int64)
        protected: set[int] = set()
        exhausted = [False]
        floor = [0]
        missing: list[int] = []
        for i in range(len(uniq)):
            cid = self.interner.find_row(uniq[i])
            if cid is None:
                missing.append(i)
            else:
                ids[i] = cid
                protected.add(cid)
        for i in missing:
            ids[i] = self._admit_or_fold(uniq[i], int(weights[i]),
                                         protected, exhausted, floor)
        self._sync_rows()
        self.agg.update(ids[inverse.reshape(-1)], powers)
        return self

    def update_stream(self, chunks: Iterable[tuple[np.ndarray, np.ndarray]]
                      ) -> "StreamingCombinationAggregator":
        for mat, pows in chunks:
            self.update(mat, pows)
        return self

    # -- merge ----------------------------------------------------------------

    def merge_table(self, combo_matrix: np.ndarray, counts: np.ndarray,
                    psum: np.ndarray, psumsq: np.ndarray, *,
                    k: int | None = None, hash_range=None
                    ) -> "StreamingCombinationAggregator":
        """Fold a shard given by its raw key table + statistics.

        The cross-host merge primitive (lazy id dedup): ``combo_matrix``
        is the shard's local id space in row order, so its local id ``i``
        remaps to ``intern_rows(combo_matrix)[i]`` in the union space.
        Entry point for deserialized shards (:mod:`repro_torch.core.exchange`);
        :meth:`merge` routes through it. Unseen rows are appended in the
        shard's local order, so any left-to-right reduction tree assigns
        the same union ids as one aggregator fed the concatenated stream.

        ``k``/``hash_range`` declare the *source* table's bounded-state
        config. Mismatched configs refuse with
        :class:`~repro_torch.core.faults.SketchConfigError` (typed, never a
        silent union): a source k differing from this aggregator's, a
        sentinel (``other``) row offered to an exact table, a declared
        hash range contradicting this aggregator's, or *identified*
        rows hashing outside this aggregator's owned range. Sentinel
        rows are exempt from the ownership check — a bounded shard
        folds its tail locally, so its own (legitimately produced)
        table carries ``other`` keys whose hashes land anywhere in the
        space; spill/restore and peer merges must accept them. In
        bounded mode, source rows route through the same admission
        policy as live samples and source ``other`` rows fold into the
        matching local tail buckets.
        """
        mat = np.ascontiguousarray(np.asarray(combo_matrix), dtype=np.int64)
        if mat.ndim != 2:
            raise ValueError(f"expected [k, workers]; got shape {mat.shape}")
        src_k = None if k is None else int(k)
        if src_k != self.k:
            raise SketchConfigError(
                f"combination-table k mismatch at merge: source "
                f"k={src_k} vs destination k={self.k}; bounded and exact "
                f"tails cannot be blended — rebuild one side first")
        src_hr = _as_hash_range(hash_range)
        if (src_hr is not None and self.hash_range is not None
                and src_hr != self.hash_range):
            raise SketchConfigError(
                f"hash-range ownership mismatch at merge: source "
                f"{src_hr.as_tuple()} vs destination "
                f"{self.hash_range.as_tuple()}")
        sentinel = sketch_mod.is_other_rows(mat)
        self._check_owned(mat, "merge")
        if sentinel.any() and self.k is None:
            raise SketchConfigError(
                "bounded (top-k + 'other') rows cannot merge into an "
                "exact aggregator; construct the destination with the "
                "matching k")
        if self.k is None:
            # Exact fast path — unchanged from pre-bounded behavior.
            remap = self.interner.intern_rows(mat)
            self._sync_rows()
            if len(remap):
                c = self.agg.num_channels
                np.add.at(self.agg.counts, remap,
                          np.asarray(counts, np.int64))
                np.add.at(self.agg.chan_psum, remap, _as_channels(psum, c))
                np.add.at(self.agg.chan_psumsq, remap,
                          _as_channels(psumsq, c))
                self.agg._touch_gen[remap] = self.agg._gen
            return self
        if len(mat) and mat.shape[1] < 2:
            raise SketchConfigError(
                "bounded combination tables need width >= 2")
        if len(mat) == 0:
            return self
        if self.interner._width is None:
            self.interner._width = mat.shape[1]
        c = self.agg.num_channels
        cnt = np.asarray(counts, dtype=np.int64).reshape(-1)
        ps = _as_channels(psum, c)
        psq = _as_channels(psumsq, c)
        protected: set[int] = set()
        exhausted = [False]
        floor = [0]
        a = self.agg
        for i in range(len(mat)):
            row = mat[i]
            if sentinel[i]:
                tid = self._other_id(int(row[0]))
            else:
                cid = self.interner.find_row(row)
                if cid is None:
                    tid = self._admit_or_fold(row, int(cnt[i]),
                                              protected, exhausted,
                                              floor)
                else:
                    tid = cid
                    protected.add(cid)
            self._sync_rows()
            a.counts[tid] += cnt[i]
            a.chan_psum[tid] += ps[i]
            a.chan_psumsq[tid] += psq[i]
            a._touch_gen[tid] = a._gen
        return self

    def merge(self, other: "StreamingCombinationAggregator"
              ) -> "StreamingCombinationAggregator":
        if other.domains != self.domains:
            raise ValueError(f"domain axis mismatch at merge: "
                             f"{other.domains} != {self.domains}")
        self.merge_table(other.interner.combo_matrix(),
                         other.agg.counts, other.agg.chan_psum,
                         other.agg.chan_psumsq, k=other.k,
                         hash_range=other.hash_range)
        # Tail provenance rides along: folds that happened at the source
        # stay disclosed after the reduction.
        self.tail_folds += other.tail_folds
        self.evictions += other.evictions
        return self

    # -- bounded-state surface -------------------------------------------------

    def shrink_k(self, k: int) -> None:
        """Lower the heavy-hitters capacity in place (overload response:
        the serve ladder's ``degraded`` rung calls this). Never widens —
        eviction is irreversible, so a larger k would only misreport the
        already-folded tail. When the current resident set exceeds the
        new k, the lowest-count rows (ties → lowest id) fold into their
        regions' ``other`` buckets; per-region totals are preserved
        exactly. Works from exact mode too (adopts bounded mode)."""
        k = int(k)
        if k < 1:
            raise ValueError(f"k must be >= 1; got {k}")
        if self.k is not None and k >= self.k:
            return
        if self.resident <= k:
            self.k = k
            return
        n = len(self.interner)
        counts = self.agg.counts[:n]
        # Keep the k highest-count identified rows (other rows keep
        # their slots for free — they are the fold destinations);
        # lexsort's last key is primary, so sort by (-count, id).
        ident = np.asarray([cid for cid in range(n)
                            if cid not in self._other_rows], np.int64)
        order = ident[np.lexsort((ident, -counts[ident]))]
        keep = set(int(v) for v in order[:k])
        folded = [int(v) for v in order[k:]]
        self.k = k
        for cid in folded:
            oid = self._other_id(int(self.interner._combos[cid][0]))
            self._fold_stats(cid, oid)
        # Rewrite identity of the folded slots is impossible in place
        # (their keys must leave the table so future arrivals re-enter
        # admission); rebuild the table without them.
        self._rebuild_without(set(folded))
        self._recycles += len(folded)
        self.evictions += len(folded)
        self.tail_folds += len(folded)

    def _rebuild_without(self, drop: set[int]) -> None:
        """Re-intern every kept row (original id order) into a fresh
        table, remapping statistics; dropped rows must already be zeroed."""
        old = self.interner
        n = len(old)
        keep_ids = [cid for cid in range(n) if cid not in drop]
        fresh = CombinationInterner()
        fresh._width = old._width
        fresh._pow2_cap = old._pow2_cap
        other_by_region: dict[int, int] = {}
        other_rows: set[int] = set()
        for cid in keep_ids:
            nid = fresh.intern(old._combos[cid])
            if cid in self._other_rows:
                other_rows.add(nid)
                other_by_region[int(old._combos[cid][0])] = nid
        # Pressure counters describe the stream's history, not the
        # rebuild — carry them over verbatim.
        fresh.intern_misses = old.intern_misses
        fresh.growth_events = old.growth_events
        a = self.agg
        sel = np.asarray(keep_ids, dtype=np.int64)
        rebuilt = StreamingAggregator(len(keep_ids), aggregate_fn=a._agg,
                                      domains=a.domains)
        rebuilt.counts += a.counts[sel]
        rebuilt.chan_psum += a.chan_psum[sel]
        rebuilt.chan_psumsq += a.chan_psumsq[sel]
        rebuilt._touch_gen[:] = a._touch_gen[sel]
        rebuilt._gen = a._gen
        self.interner = fresh
        self.agg = rebuilt
        self._other_by_region = other_by_region
        self._other_rows = other_rows

    def filter_range(self, hash_range) -> "StreamingCombinationAggregator":
        """Project this table onto a hash range: a new aggregator (same
        k / domains, owning ``hash_range``) holding exactly the rows —
        identified and ``other`` alike — whose key hashes fall inside
        it. The per-range shuffle primitive: ``split(n)`` ranges'
        projections partition the table, so merging each range on its
        owner host and unioning the results never double-counts."""
        hr = _as_hash_range(hash_range)
        if hr is None:
            raise ValueError("filter_range needs a hash range")
        out = StreamingCombinationAggregator(
            aggregate_fn=self.agg._agg, domains=self.domains, k=self.k,
            hash_range=hr)
        mat = self.interner.combo_matrix()
        if len(mat) == 0:
            return out
        keep = hr.owns(combo_hashes(mat))
        n = len(mat)
        out.merge_table(mat[keep], self.agg.counts[:n][keep],
                        self.agg.chan_psum[:n][keep],
                        self.agg.chan_psumsq[:n][keep], k=self.k,
                        hash_range=hr)
        return out

    def interner_pressure(self) -> dict:
        """First-class pressure counters for operators: how close the
        exact path is to blowing up, and what bounded mode folded."""
        out = {
            "distinct": self.interner.distinct,
            "intern_misses": self.interner.intern_misses,
            "growth_events": self.interner.growth_events,
        }
        if self.k is not None:
            out.update(k=self.k, resident=self.resident,
                       other_rows=self.other_rows,
                       tail_folds=self.tail_folds,
                       evictions=self.evictions)
        return out

    def tail_info(self) -> dict | None:
        """TAIL disclosure payload (None in exact mode)."""
        if self.k is None:
            return None
        return {"k": self.k, "resident": self.resident,
                "other_rows": self.other_rows,
                "tail_folds": self.tail_folds,
                "evictions": self.evictions}

    def estimates(self, t_exec: float, names: Sequence[str], *,
                  alpha: float = 0.05, coverage=None
                  ) -> tuple[EstimateSet, list[tuple[int, ...]]]:
        """Finalize into (combination EstimateSet, combination tuples).

        Bounded tables disclose themselves: ``EstimateSet.tail`` carries
        the fold counters (the report's ``TAIL`` line) and the coverage
        mapping gains an ``"interner"`` pressure block. Exact tables
        with no gather coverage keep ``coverage=None`` — byte-identical
        to pre-bounded output."""
        comb_names = combination_names_from_matrix(
            self.interner.combo_matrix(), names)
        cov = coverage
        if cov is not None:
            cov = dict(cov)
            cov["interner"] = self.interner_pressure()
        elif self.k is not None:
            cov = {"complete": True, "interner": self.interner_pressure()}
        est = self.agg.estimates(t_exec, comb_names, alpha=alpha,
                                 coverage=cov, tail=self.tail_info())
        return est, self.interner.combos


def stream_estimate(chunks: Iterable[tuple[np.ndarray, np.ndarray]],
                    t_exec: float, names: Sequence[str], *,
                    alpha: float = 0.05,
                    aggregate_fn: AggregateFn | None = None) -> EstimateSet:
    """One-call streaming estimation: fold chunks, then build estimates."""
    agg = StreamingAggregator(len(names), aggregate_fn=aggregate_fn)
    agg.update_stream(chunks)
    return agg.estimates(t_exec, names, alpha=alpha)
