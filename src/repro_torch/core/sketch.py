"""Bounded-state combination attribution: hashing + ownership primitives.

ALEA's §4.4 multi-worker attribution keys sufficient statistics by
*combination* rows (region, worker, request, ...). The exact
:class:`~repro_torch.core.streaming.CombinationInterner` is O(distinct) host
memory with O(log R) device recompiles — the unbounded-overhead failure
mode the RAPL cost study warns profilers against. This module holds the
two primitives that bound it, shared by the streaming layer, the device
pipeline and the exchange layer:

* **Heavy-hitters tail sentinel** (:data:`OTHER`): a bounded aggregator
  keeps at most ``k`` identified combination rows per table plus one
  ``other`` row per region, ``(region, -1, ..., -1)``. Evicting a row
  folds its full (counts, Σpow, Σpow²) triple — all C channels — into
  its region's ``other`` row, so *per-region totals stay bit-exact* and
  only tail identity coarsens. Sentinel rows pack safely into the
  device-resident int64-key table: any ``-1`` field drives that packed
  word negative, while real rows (fields in ``[0, 2^bits)``) and the
  int64-max padding rows are non-negative, so sentinel keys can never
  collide with either.

* **Hash-range ownership** (:func:`combo_hashes`, :class:`HashRange`):
  combination-key ownership is partitioned across hosts by splitmix64
  hash range so no host holds the union table. The hash is the same
  avalanche construction as the sample clock and the fault mixer
  (:func:`repro_torch.core.faults._mix64`), vectorized over rows — a pure
  function of the combination tuple, so every host agrees on ownership
  without coordination.

Everything here is a pure function of its inputs — no wall clock, no
global state. The module is a member of ``DETERMINISM_CRITICAL_MODULES``
(the ``no-wallclock`` AST pass include list): eviction order in the
streaming layer derives from the deterministic fold counters, and the
hash used for sharding must replay bit-exactly across hosts and restarts.
"""

from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.core.faults import SketchConfigError

__all__ = [
    "OTHER", "SketchConfigError",
    "mix64", "combo_hashes",
    "HashRange", "is_other_rows", "other_row",
]


# Sentinel filling every non-region field of a tail bucket row. The region
# axis (combination column 0) keeps its real id — that is what makes the
# per-region totals contract exact.
OTHER: int = -1

_U64 = np.uint64
_SEED = _U64(0x9E3779B97F4A7C15)
_M1 = _U64(0xBF58476D1CE4E5B9)
_M2 = _U64(0x94D049BB133111EB)
_S30, _S27, _S31 = _U64(30), _U64(27), _U64(31)


def mix64(h: np.ndarray, w: np.ndarray) -> np.ndarray:
    """One splitmix64 absorb+avalanche round, vectorized: ``mix(h + w)``.

    Matches :func:`repro_torch.core.faults._mix64`'s per-word step exactly
    (uint64 wrap-around is the ``& MASK64`` of the scalar version), so
    host-side scalar keys and vectorized row hashes agree bit-for-bit.
    """
    h = (h + w).astype(_U64, copy=False)
    h ^= h >> _S30
    h *= _M1
    h ^= h >> _S27
    h *= _M2
    h ^= h >> _S31
    return h


def combo_hashes(mat: np.ndarray) -> np.ndarray:
    """splitmix64 hash of each combination row: ``[k, W] int -> [k] uint64``.

    Absorbs the row's fields in column order starting from the golden
    seed — the same word-sequence construction as ``faults._mix64``, so
    ``combo_hashes(row[None])[0] == _mix64(*row)`` for any row. Negative
    fields (the :data:`OTHER` sentinel) absorb as their two's-complement
    uint64 image, exactly like the scalar mixer's ``w & MASK64``.
    """
    mat = np.ascontiguousarray(np.asarray(mat, dtype=np.int64))
    if mat.ndim == 1:
        mat = mat[:, None]
    h = np.full(mat.shape[0], _SEED, dtype=_U64)
    with np.errstate(over="ignore"):
        for j in range(mat.shape[1]):
            h = mix64(h, mat[:, j].view(_U64))
    return h


def other_row(region: int, width: int) -> tuple[int, ...]:
    """The tail bucket combination row for ``region`` at table ``width``."""
    if width < 2:
        raise SketchConfigError(
            "bounded combination tables need width >= 2: at width 1 the "
            "region axis is the whole key, so a per-region 'other' bucket "
            "degenerates to the row it would fold")
    return (int(region),) + (OTHER,) * (width - 1)


def is_other_rows(mat: np.ndarray) -> np.ndarray:
    """[k] bool mask of tail bucket rows (any field carries the sentinel)."""
    mat = np.asarray(mat)
    if mat.ndim == 1:
        mat = mat[:, None]
    if mat.shape[0] == 0:
        return np.zeros(0, dtype=bool)
    return (mat < 0).any(axis=1)


@dataclasses.dataclass(frozen=True)
class HashRange:
    """Half-open uint64 hash interval ``[lo, hi)`` owning combination keys.

    ``hi`` may be ``2**64`` (exclusive upper bound of the full space).
    Ranges are plain value objects: equality is ownership equality, and
    the wire schema (v3) carries them as ``[lo, hi]`` integer pairs.
    """
    lo: int
    hi: int

    def __post_init__(self):
        if not (0 <= self.lo < self.hi <= 1 << 64):
            raise ValueError(
                f"hash range must satisfy 0 <= lo < hi <= 2**64; "
                f"got [{self.lo}, {self.hi})")

    @classmethod
    def full(cls) -> "HashRange":
        return cls(0, 1 << 64)

    @classmethod
    def split(cls, n: int) -> tuple["HashRange", ...]:
        """Partition the uint64 hash space into ``n`` contiguous ranges
        (a deterministic, coordination-free shard map: range ``i`` of
        ``n`` is the same on every host)."""
        if n < 1:
            raise ValueError(f"need at least one range; got n={n}")
        bounds = [(i << 64) // n for i in range(n + 1)]
        return tuple(cls(bounds[i], bounds[i + 1]) for i in range(n))

    def owns(self, hashes: np.ndarray) -> np.ndarray:
        """[k] bool mask of hashes inside ``[lo, hi)``."""
        h = np.asarray(hashes, dtype=_U64)
        # hi == 2**64 doesn't fit in uint64; compare inclusively on hi-1.
        return (h >= _U64(self.lo)) & (h <= _U64(self.hi - 1))

    def owns_row(self, combo) -> bool:
        return bool(self.owns(combo_hashes(np.asarray(combo)[None, :]))[0])

    def as_tuple(self) -> tuple[int, int]:
        return (self.lo, self.hi)
