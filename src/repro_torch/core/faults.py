"""Deterministic fault injection + the typed spill-failure hierarchy.

Production fleets fail partially: hosts crash mid-epoch, spill files get
torn or bit-flipped by the storage layer, sensor channels stall, and
background sampler threads die. This module gives the profiling stack a
single, replayable model of those failures:

* A typed error hierarchy rooted at :class:`SpillError` (itself an
  ``IOError`` so existing ``except IOError`` retry loops keep working):
  :class:`CorruptShardError` (bytes present but wrong),
  :class:`TornWriteError` (bytes missing/short) and
  :class:`StaleShardError` (host present but behind the required
  watermark). Tolerance code dispatches on these types instead of
  matching message strings.

* A seeded, frozen :class:`FaultPlan` that injects faults at *named
  seams* — ``ShardSpiller.spill`` (host crashes, silent stragglers,
  transient publish failures, post-publish corruption), ``ckpt`` leaf
  write/read (torn writes, bit flips), ``HostSampler._loop`` (sampler
  thread death) and the trace-sensor bank (per-rail dropouts). Every
  corruption choice (which byte, which bit, how short a truncation) is
  counter-keyed off ``(seed, seam, keys...)`` through a splitmix-style
  mixer — no wall-clock randomness, so a chaos run replays bit-exactly
  and ``FaultPlan()`` (the empty plan) is byte-for-byte a no-op.

Seams accept the plan two ways: explicitly (``faults=`` constructor
parameters on ``ShardSpiller`` / ``HostSampler`` / the sensor banks) or
ambiently via :func:`install` for seams too deep to thread a parameter
through (the ``ckpt`` leaf codec). The ambient plan is a contextvar, so
concurrent tests don't leak plans into each other. Note contextvars do
not propagate into already-running threads: thread-owning seams capture
the active plan at construction time.
"""

from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import re
from typing import Iterator, Sequence

import numpy as np

__all__ = [
    "SpillError", "CorruptShardError", "TornWriteError", "StaleShardError",
    "DeltaMismatchError", "SketchConfigError", "QuorumError",
    "MissingArtifactError",
    "InjectedCrash", "ChannelDropout", "LeafFault", "FaultPlan",
    "install", "active_plan", "resolve_plan",
    "FAULT_SITES", "declare_site", "declared_sites",
]


# -- typed failure hierarchy --------------------------------------------------

class SpillError(IOError):
    """Base for durable-spill failures (subclasses ``IOError`` so the
    pre-existing transient-race retry loops in ``restore_shard`` and the
    gather path catch the typed errors unchanged)."""


class CorruptShardError(SpillError):
    """Published bytes are present but wrong: CRC mismatch, unparseable
    manifest, undecodable leaf. The epoch must be quarantined — its rows
    may never be merged."""


class TornWriteError(SpillError):
    """Published bytes are missing or short: a leaf file truncated or
    deleted after the manifest was published (leaf data files are not
    fsynced — only the manifest is — so a machine crash right after the
    rename can tear them)."""


class StaleShardError(SpillError):
    """A host's latest durable epoch is behind the gather's required
    watermark (straggler, or a corrupt tail folded back past it)."""


class DeltaMismatchError(SpillError, ValueError):
    """Writer-side delta precondition failure: the aggregator did not
    evolve append-only (kind/width/domain change, shrink, rewritten key
    rows), so no delta can express the epoch. Also a ``ValueError`` so
    the spiller's pre-existing fall-back-to-full-base handler catches it
    unchanged."""


class SketchConfigError(SpillError, ValueError):
    """Bounded-attribution configuration mismatch at a merge/gather seam:
    two combination tables disagree on top-k capacity, ``other``-bucket
    layout (sentinel tail rows merged into an exact table), or hash-range
    ownership. Folding them would silently blend incompatible tails, so
    the merge refuses. Also a ``ValueError`` (API-misuse flavor), same
    pattern as :class:`DeltaMismatchError`."""


class QuorumError(SpillError):
    """A quorum gather could not merge the policy's minimum host count."""


class MissingArtifactError(SpillError, FileNotFoundError):
    """No durable artifact was ever published under the requested path
    (no checkpoint step, no shard epoch). Distinct from
    :class:`TornWriteError` — nothing was lost, nothing exists yet. Also
    a ``FileNotFoundError`` so pre-existing absence handlers catch it
    unchanged."""


class InjectedCrash(RuntimeError):
    """Raised by a seam to simulate the process dying at that point.

    Deliberately *not* a :class:`SpillError`: tolerance code must never
    catch it (a real crash isn't catchable); only the chaos harness does.
    """


# -- deterministic counter-keyed randomness -----------------------------------

_MASK64 = (1 << 64) - 1


def _mix64(*words: int) -> int:
    """splitmix64-style avalanche over a word sequence (same construction
    as the sample clock: pure function of its inputs, no global state)."""
    h = 0x9E3779B97F4A7C15
    for w in words:
        h = (h + (w & _MASK64)) & _MASK64
        h ^= h >> 30
        h = (h * 0xBF58476D1CE4E5B9) & _MASK64
        h ^= h >> 27
        h = (h * 0x94D049BB133111EB) & _MASK64
        h ^= h >> 31
    return h


def _key_words(key: str) -> Iterator[int]:
    data = key.encode()
    for i in range(0, len(data), 8):
        yield int.from_bytes(data[i:i + 8], "little")


# -- fault specs --------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ChannelDropout:
    """Rail ``domain`` reads NaN for sample times in ``[t0, t1)``."""
    domain: str
    t0: float
    t1: float


@dataclasses.dataclass(frozen=True)
class LeafFault:
    """Corrupt one durable file at the ckpt leaf codec seam.

    ``match`` is a path substring (e.g. ``"host_0002/epoch_000000005"``
    or a file name like ``"arr_00001"``); every read/write whose path
    contains it is affected. ``kind`` is ``"bitflip"`` (one
    deterministically chosen bit) or ``"truncate"`` (cut to a
    deterministically chosen shorter length). ``stage`` selects whether
    the bytes are corrupted as they are persisted (``"write"`` — models
    storage-layer rot; the manifest CRC still covers the *intended*
    bytes, so readers detect it) or as they are handed to the reader
    (``"read"`` — models a flaky read path).
    """
    match: str
    kind: str = "bitflip"
    stage: str = "write"

    def __post_init__(self):
        if self.kind not in ("bitflip", "truncate"):
            raise ValueError(f"kind must be bitflip|truncate; got {self.kind!r}")
        if self.stage not in ("read", "write"):
            raise ValueError(f"stage must be read|write; got {self.stage!r}")


@dataclasses.dataclass(frozen=True)
class FaultPlan:
    """A seeded, replayable set of faults to inject across the fleet.

    The default-constructed plan injects nothing, and every seam is
    written so that the empty plan is byte-for-byte identical to passing
    no plan at all (the fault-free acceptance invariant).

    Attributes
    ----------
    seed:            keys every deterministic corruption choice.
    crashes:         ``(host_id, epoch)`` pairs — ``ShardSpiller.spill``
                     raises :class:`InjectedCrash` *before* publishing
                     that epoch (the host dies with the epoch in flight).
    stragglers:      ``(host_id, after_epoch)`` pairs — spills for epochs
                     beyond ``after_epoch`` silently do nothing (the
                     host keeps running but its durable state goes stale).
    spill_failures:  ``(host_id, epoch)`` pairs — the publish raises a
                     transient :class:`SpillError` (succeeds if retried
                     at a later epoch); exercises bounded-retry queues.
    leaf_faults:     :class:`LeafFault` specs applied at the ckpt codec.
    sampler_fail_after: sample count after which ``HostSampler``'s
                     control thread raises (None → never).
    dropouts:        :class:`ChannelDropout` specs applied by the trace
                     sensor banks.
    serve_crashes:   engine step-clock values at which ``Engine.step``
                     raises :class:`InjectedCrash` *before* mutating any
                     host or device state for that step (the serving
                     process dies between steps; a restore from the last
                     durable snapshot must replay bit-exactly).
    snapshot_failures: engine step-clock values whose serve snapshot
                     publish raises a transient :class:`SpillError`
                     (succeeds if re-attempted at a later step). Torn /
                     corrupt snapshot *bytes* are modeled by
                     ``leaf_faults`` matching the snapshot paths — the
                     snapshot writer shares the ckpt leaf codec.
    admission_faults: submit sequence numbers (0-based, per scheduler)
                     whose admission raises a transient typed admission
                     error — exercises counted-never-silent rejection
                     paths without a real overload.
    """
    seed: int = 0
    crashes: tuple[tuple[int, int], ...] = ()
    stragglers: tuple[tuple[int, int], ...] = ()
    spill_failures: tuple[tuple[int, int], ...] = ()
    leaf_faults: tuple[LeafFault, ...] = ()
    sampler_fail_after: int | None = None
    dropouts: tuple[ChannelDropout, ...] = ()
    serve_crashes: tuple[int, ...] = ()
    snapshot_failures: tuple[int, ...] = ()
    admission_faults: tuple[int, ...] = ()

    # -- spiller seam ---------------------------------------------------------
    def crash_at(self, host_id: int, epoch: int) -> bool:
        return (host_id, epoch) in self.crashes

    def straggles(self, host_id: int, epoch: int) -> bool:
        return any(h == host_id and epoch > after
                   for h, after in self.stragglers)

    def spill_fails(self, host_id: int, epoch: int) -> bool:
        return (host_id, epoch) in self.spill_failures

    # -- ckpt leaf codec seam -------------------------------------------------
    @staticmethod
    def _canon(path: str) -> str:
        """Canonical path for matching/keying: forward slashes, and the
        write protocol's random ``.tmp-<nonce>`` dir suffix stripped so a
        write-stage fault picks the same byte every replay."""
        return re.sub(r"\.tmp-[0-9a-f]+", "", path.replace("\\", "/"))

    def _faults_for(self, path: str, stage: str) -> list[LeafFault]:
        norm = self._canon(path)
        return [f for f in self.leaf_faults
                if f.stage == stage and f.match in norm]

    def corrupt_bytes(self, path: str, data: bytes, stage: str) -> bytes:
        """Apply matching leaf faults to ``data`` for file ``path``.

        Returns ``data`` unchanged (same object) when nothing matches,
        so the no-fault path stays allocation-free and byte-identical.
        """
        for i, fault in enumerate(self._faults_for(path, stage)):
            if not data:
                continue
            h = _mix64(self.seed, i, len(data), *_key_words(fault.match),
                       *_key_words(self._canon(path)))
            if fault.kind == "bitflip":
                bit = h % (len(data) * 8)
                buf = bytearray(data)
                buf[bit // 8] ^= 1 << (bit % 8)
                data = bytes(buf)
            else:  # truncate — always strictly shorter
                data = data[:h % len(data)]
        return data

    # -- sampler seam ---------------------------------------------------------
    def sampler_should_fail(self, samples_taken: int) -> bool:
        return (self.sampler_fail_after is not None
                and samples_taken >= self.sampler_fail_after)

    # -- serving seam ---------------------------------------------------------
    def serve_crash_at(self, step: int) -> bool:
        return step in self.serve_crashes

    def snapshot_fails(self, step: int) -> bool:
        return step in self.snapshot_failures

    def admission_fails(self, seq: int) -> bool:
        return seq in self.admission_faults

    # -- sensor seam ----------------------------------------------------------
    def dropout_mask(self, domains: Sequence[str],
                     times: np.ndarray) -> np.ndarray | None:
        """[n, D] bool mask (True = channel dropped at that sample time),
        or None when no dropout touches these domains (no-fault fast path).
        """
        hits = [d for d in self.dropouts if d.domain in domains]
        if not hits:
            return None
        t = np.asarray(times, dtype=np.float64)
        mask = np.zeros((t.shape[0], len(domains)), dtype=bool)
        col = {name: j for j, name in enumerate(domains)}
        for d in hits:
            mask[:, col[d.domain]] |= (t >= d.t0) & (t < d.t1)
        return mask


# -- ambient plan (deep seams) ------------------------------------------------

_ACTIVE: contextvars.ContextVar[FaultPlan | None] = contextvars.ContextVar(
    "repro_fault_plan", default=None)


@contextlib.contextmanager
def install(plan: FaultPlan):
    """Make ``plan`` the ambient fault plan within the ``with`` block."""
    token = _ACTIVE.set(plan)
    try:
        yield plan
    finally:
        _ACTIVE.reset(token)


def active_plan() -> FaultPlan | None:
    return _ACTIVE.get()


def resolve_plan(explicit: FaultPlan | None) -> FaultPlan | None:
    """Seam-side plan lookup: an explicit ``faults=`` argument wins,
    otherwise fall back to the ambient installed plan (if any)."""
    return explicit if explicit is not None else _ACTIVE.get()


# -- fault-site registry ------------------------------------------------------
#
# Every module that consults a FaultPlan marks itself with a module-level
# ``_SITE = declare_site("...")`` per injection seam. The canonical list
# below is the single source of truth: a seam name that drifts (typo,
# rename, copy-paste duplicate) would silently decouple chaos configs
# from the code they target, so membership and uniqueness are enforced
# both at import time (here) and statically (the ``fault-site-hygiene``
# pass in :mod:`repro.analysis`). Adding a seam means extending this
# tuple in the same change that declares it.

FAULT_SITES: tuple[str, ...] = (
    "spiller.publish",        # ShardSpiller.spill crash/straggle/fail seam
    "ckpt.leaf_write",        # _write_leaf byte corruption (storage rot)
    "ckpt.leaf_read",         # _read_leaf byte corruption (flaky reads)
    "ckpt.manifest_write",    # write_manifest_dir manifest corruption
    "ckpt.manifest_read",     # read_manifest_meta manifest corruption
    "sampler.loop",           # HostSampler control-thread death
    "sensors.trace_bank",     # trace-sensor per-rail dropouts
    "serve.step.crash",       # Engine.step process-death injection
    "serve.snapshot.write",   # serve snapshot publish failures
    "serve.admission",        # scheduler submit-time transient faults
)

_DECLARED: dict[str, str] = {}


def declare_site(name: str, *, module: str | None = None) -> str:
    """Register a fault-injection seam; returns ``name`` for assignment.

    ``module`` defaults to the caller's ``__name__``. Unknown names and
    cross-module duplicates raise at import time; re-declaring from the
    same module (reload, re-import) is idempotent.
    """
    if name not in FAULT_SITES:
        raise ValueError(
            f"unregistered fault site {name!r}; add it to "
            f"faults.FAULT_SITES in the same change")
    if module is None:
        import sys
        frame = sys._getframe(1)
        module = frame.f_globals.get("__name__", "<unknown>")
    prev = _DECLARED.get(name)
    if prev is not None and prev != module:
        raise ValueError(
            f"fault site {name!r} already declared by {prev}; "
            f"duplicate declaration from {module}")
    _DECLARED[name] = module
    return name


def declared_sites() -> dict[str, str]:
    """Snapshot of declared seams: site name -> declaring module."""
    return dict(_DECLARED)
