"""Serving engine: masked decode steps on the device + a
continuous-batching host scheduler (slot-based, vLLM-lite).

Port of ``src/repro/serve/engine.py``. The device side is the model's
decode step for every decoder family (dense, moe, vlm with KV caches;
ssm and hybrid with recurrent state, the hybrid's shared block with a
KV cache too; prefill fills a slot's cache by teacher-forced decode
steps, decode advances every active slot one token, writes masked to
the slots they belong to; a MoE block is dropless there, so no slot's
tokens depend on the others'), run eagerly on the engine's device,
which defaults to the GPU. The host side packs
requests into fixed slots so the decode step shape stays static. ALEA
regions wrap both so serving energy is attributable per phase: attach a
:class:`PhaseEnergyAccountant` and the engine drains the host sampler's
ring buffer into a StreamingAggregator after every scheduler step — a
serving run of any length holds O(R + drain chunk) profiling state,
never the full sample stream.

The model runs inside :func:`repro_torch.core.regions.opaque`, so its
own regions (``embed``, ``attn``, ``ffn``, ``moe_router``, ``moe_ffn``,
``ssm_decode``, ``mlstm_decode``, ``lm_head``, ...) label a profiler
trace but take no samples: a sample taken during a step lands in the
serving phase around it, as in the reference, whose jitted steps run
their regions only while being traced.

The cache is updated in place (the reference's steps return a new
cache); for the recurrent families the speculative step clones it
twice, the window-start checkpoint (the rollback target) and the verify
step's input, so neither shares a tensor with the cache the steps
write.
"""

from __future__ import annotations

import contextlib
import dataclasses
import functools
from typing import Callable

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import resolve_device
from repro_torch.core import regions as regions_mod
from repro_torch.core.estimator import EstimateSet
from repro_torch.core.faults import InjectedCrash, declare_site, resolve_plan
from repro_torch.core.sampler import HostSampler, RegionMarker
from repro_torch.core.sensors import available_host_sensor
from repro_torch.core.streaming import (StreamingAggregator,
                                        StreamingCombinationAggregator)
from repro_torch.models import model as M
from repro_torch.serve.scheduler import (PriceSignalUnavailableError,
                                         ServeScheduler, ServeTimeoutError)

__all__ = ["ServeConfig", "Request", "Engine", "PhaseEnergyAccountant",
           "ServeTimeoutError", "PriceSignalUnavailableError",
           "JoulesPerToken"]

# Injection seam this module owns (see faults.FAULT_SITES): the engine
# step loop can be killed at a chosen step-clock value, before any state
# mutation, to exercise snapshot/restore.
_SITE_STEP_CRASH = declare_site("serve.step.crash")


class PhaseEnergyAccountant:
    """Constant-memory per-phase energy accounting for serving runs.

    Owns the §4.8 control thread (RegionMarker + HostSampler) and a
    :class:`StreamingAggregator`; callers (the Engine) periodically call
    :meth:`drain` to fold newly collected samples into the per-region
    sufficient statistics and discard them. Region ids come from the
    process-wide registry, so the accumulators grow only with the number
    of distinct phases, not with run length.

    With ``spill_dir`` set, every ``spill_every``-th drain (one drain per
    scheduler step) atomically publishes this host's shard via a
    :class:`repro_torch.core.exchange.ShardSpiller`, so a fleet of serving
    hosts can be reduced with ``gather_shards`` at any time — and a host
    killed mid-run loses at most ``spill_every`` epochs of samples.
    ``spill_mode="delta"`` (the default) publishes only the rows whose
    statistics changed since the last publish plus a periodic compacted
    base (``compact_every``), so steady-state spill bandwidth is O(rows
    touched per epoch), not O(distinct phases) — always-on fleet
    monitoring stays within ALEA's overhead budget. Cross-host
    region ids assume the hosts register serving phases in the same
    order (they do: phase names are code paths, not data).

    Spill failures (full disk, flaky NFS, injected faults) never kill
    the serving loop and never pass silently: a failed publish is
    retried at each subsequent :meth:`drain` up to ``spill_retries``
    consecutive attempts, then counted in :attr:`spill_drops` and
    abandoned until the next scheduled spill point. The aggregator is
    cumulative, so a later successful spill republishes everything a
    dropped one would have — a drop is a durability gap (a crash inside
    it loses those epochs' samples), not data loss in a surviving
    process. The final spill at ``__exit__`` raises instead of
    dropping.
    """

    def __init__(self, *, period: float = 2e-3, jitter: float = 1e-4,
                 seed: int = 0, sensor=None, spill_dir: str | None = None,
                 host_id: int = 0, spill_every: int = 50,
                 spill_mode: str = "delta", compact_every: int = 16,
                 spill_retries: int = 3, faults=None,
                 track_requests: bool = False,
                 max_combinations: int | None = None,
                 buffer_capacity: int | None = None):
        self.marker = RegionMarker()
        self.sampler = HostSampler(self.marker,
                                   sensor or available_host_sensor(),
                                   period=period, jitter=jitter, seed=seed,
                                   buffer_capacity=buffer_capacity)
        self._base_period = period
        # A multi-channel sensor bank (e.g. sensors.HostSensorBank over
        # PKG + DRAM rails) widens the accumulators to one column per
        # rail: estimates() then reports per-phase × per-domain energy.
        self.domains = self.sampler.domains
        self.agg = StreamingAggregator(len(regions_mod.registry.names),
                                       domains=self.domains)
        # Per-request attribution (the serving budget meter): request id
        # becomes a combination axis — width-2 (phase_rid, request_id)
        # rows through the same CombinationInterner path the §4.4
        # multi-worker attribution uses. A sample taken while k requests
        # are in flight is split 1/k across them, so the combination
        # psums partition the phase psums exactly (no double count).
        # ``max_combinations`` bounds that table (heavy-hitters tier):
        # a long-running fleet tracks at most that many identified
        # (phase, request) rows; the tail folds into per-phase `other`
        # buckets, so per-phase totals stay exact while memory stays
        # O(max_combinations) regardless of request count.
        self.track_requests = track_requests
        self.max_combinations = max_combinations
        self.request_agg = (StreamingCombinationAggregator(
            domains=self.domains, k=max_combinations)
            if track_requests else None)
        self._req_energy: dict[int, float] = {}   # cumulative J / request
        self._req_charges: dict[int, float] = {}  # J since last take
        self.spill_dir = spill_dir
        self.host_id = host_id
        self.spill_every = spill_every
        self._epoch = 0
        self._last_spill_epoch: int | None = None
        self._last_spill_path: str | None = None
        self._elapsed_offset = 0.0
        self._spiller = None
        self._ctx: contextlib.ExitStack | None = None
        self.spill_retries = spill_retries
        self.spill_failures = 0          # individual failed attempts
        self.spill_drops = 0             # retry budgets exhausted
        self.last_spill_error: OSError | None = None
        self._spill_pending = False      # retry at next drain
        self._spill_attempts = 0
        if spill_dir is not None:
            # Restart-and-rejoin: a killed host resumes from its own
            # LATEST shard instead of republishing a fresh low-epoch one
            # over it (which would silently drop all pre-crash samples).
            from repro_torch.core.exchange import ShardSpiller
            self._spiller = ShardSpiller(spill_dir, host_id,
                                         mode=spill_mode,
                                         compact_every=compact_every,
                                         faults=faults)
            if self._spiller.resumed is not None:
                self.agg.merge(self._spiller.resumed)
                self._epoch = self._spiller.epoch
                # The restored epoch is already durable: spill() before
                # the next drain must be a no-op, not a republish.
                self._last_spill_epoch = self._epoch
                self._last_spill_path = self._spiller.resumed_dir
                meta = self._spiller.resumed_meta or {}
                # Pre-crash wall time rides in the shard meta; without it
                # estimates() would divide merged counts by only this
                # process's session time, inflating every p_hat.
                self._elapsed_offset = float(
                    meta.get("extra", {}).get("elapsed", 0.0))
        self._last_drain_elapsed = self._elapsed_offset

    def __enter__(self) -> "PhaseEnergyAccountant":
        self._ctx = contextlib.ExitStack()
        self._ctx.enter_context(regions_mod.profiling_session(self.marker))
        self._ctx.enter_context(self.sampler)
        return self

    def __exit__(self, *exc) -> None:
        assert self._ctx is not None
        self._ctx.close()
        self._ctx = None
        self.drain()
        if self._spiller is not None:
            # Final durable publish: a failure here would silently lose
            # the whole tail of the run, so it raises instead of being
            # queued behind drains that will never come.
            self.spill(raise_on_failure=True)

    def drain(self, active_requests=None) -> int:
        """Fold samples collected since the last drain; returns the count.

        Each call is one scheduler epoch; periodic durable spills happen
        here when configured.

        With ``track_requests`` set, ``active_requests`` names the
        request ids in flight while these samples were taken: each
        sample's power is split equally across them and folded into the
        per-(phase, request) combination table, and each request is
        charged its share of the wall-time × mean-power energy since the
        previous drain (consumed by the engine via
        :meth:`take_request_charges` to enforce budgets).
        """
        rids, pows = self.sampler.drain()
        now = self.elapsed
        dt = max(now - self._last_drain_elapsed, 0.0)
        self._last_drain_elapsed = now
        if len(rids):
            names = regions_mod.registry.names
            if len(names) > self.agg.num_regions:
                self.agg.grow(len(names))
            self.agg.update(rids, pows)
            if self.track_requests and active_requests:
                reqs = sorted({int(r) for r in active_requests})
                k = len(reqs)
                pows_arr = np.asarray(pows, np.float64)
                total = (pows_arr if pows_arr.ndim == 1
                         else pows_arr.sum(axis=1))
                share = dt * float(total.mean()) / k
                n = len(rids)
                mat = np.empty((n * k, 2), np.int64)
                for j, r in enumerate(reqs):
                    mat[j * n:(j + 1) * n, 0] = rids
                    mat[j * n:(j + 1) * n, 1] = r
                    self._req_energy[r] = (
                        self._req_energy.get(r, 0.0) + share)
                    self._req_charges[r] = (
                        self._req_charges.get(r, 0.0) + share)
                self.request_agg.update(
                    mat, np.concatenate([pows_arr / k] * k, axis=0))
        self._epoch += 1
        if self.spill_dir is not None and (
                self._spill_pending
                or (self.spill_every > 0
                    and self._epoch % self.spill_every == 0)):
            self.spill()
        return len(rids)

    @property
    def elapsed(self) -> float:
        """Accounted wall time: this session plus any resumed sessions."""
        return self._elapsed_offset + self.sampler.elapsed

    @property
    def epoch(self) -> int:
        """Drain epochs completed (the spill fence's clock)."""
        return self._epoch

    @property
    def last_spill_epoch(self) -> int | None:
        """Epoch of the last durable shard publish, if any — recorded in
        engine snapshots as the energy never-double-count fence."""
        return self._last_spill_epoch

    def spill(self, *, raise_on_failure: bool = False) -> str | None:
        """Durably publish this host's current shard (atomic, CRC'd).

        Idempotent within a drain epoch: a second call before the next
        :meth:`drain` (e.g. a shutdown hook racing the periodic spill)
        returns the already-published directory instead of pushing the
        same epoch through the manifest protocol twice.

        On I/O failure returns ``None`` (unless ``raise_on_failure``)
        and schedules a retry at the next drain; after ``spill_retries``
        consecutive failures the epoch is counted in
        :attr:`spill_drops` and abandoned — never retried forever,
        never dropped silently. Injected crashes
        (:class:`repro_torch.core.faults.InjectedCrash`) are not I/O failures
        and propagate.
        """
        if self._last_spill_epoch == self._epoch:
            self._spill_pending = False
            return self._last_spill_path
        try:
            out = self._spiller.spill(self.agg, self._epoch,
                                      extra_meta={"elapsed": self.elapsed})
        except OSError as e:     # includes the SpillError hierarchy
            self.spill_failures += 1
            self.last_spill_error = e
            self._spill_attempts += 1
            if self._spill_attempts >= self.spill_retries:
                self.spill_drops += 1
                self._spill_attempts = 0
                self._spill_pending = False
            else:
                self._spill_pending = True
            if raise_on_failure:
                raise
            return None
        self._spill_attempts = 0
        self._spill_pending = False
        self._last_spill_epoch = self._epoch
        self._last_spill_path = out
        return out

    # -- serving hooks --------------------------------------------------------
    @property
    def sampling_period(self) -> float:
        """The live sampling period (the control thread reads it each
        iteration, so ladder widening takes effect immediately)."""
        return self.sampler.period

    def scale_period(self, factor: float) -> None:
        """Overload-ladder hook: widen the sampling period so the
        monitor stops competing with overloaded serving work (the
        energy-monitoring-cost critique from PAPERS.md). Scales from the
        construction-time base, so repeated calls don't compound."""
        self.sampler.period = self._base_period * float(factor)

    def reset_period(self) -> None:
        """Undo :meth:`scale_period` on ladder de-escalation."""
        self.sampler.period = self._base_period

    def shrink_tracking(self, max_combinations: int) -> None:
        """Overload-ladder hook: lower (never raise) the per-request
        combination table's heavy-hitters capacity in place. The
        lowest-count (phase, request) rows fold into their phase's
        ``other`` bucket — per-phase totals stay exact, so budgets and
        phase estimates are unaffected; only cold requests' identity
        coarsens. Irreversible by design (eviction already folded the
        tail), so de-escalation does not undo it."""
        if self.request_agg is None:
            return
        self.request_agg.shrink_k(max_combinations)
        self.max_combinations = self.request_agg.k

    def attribution_pressure(self) -> dict | None:
        """Interner pressure counters of the per-request combination
        table (None without ``track_requests``) — the ServeReport's
        ``attribution`` block."""
        if self.request_agg is None:
            return None
        return self.request_agg.interner_pressure()

    @property
    def buffer_overruns(self) -> int:
        """Samples dropped because the bounded ring was full — each one
        counted by the buffer, surfaced here for the ServeReport."""
        return self.sampler.buffer_overruns

    def take_request_charges(self) -> dict[int, float]:
        """Measured per-request joules accumulated since the last call
        (engine-side budget enforcement consumes these every step)."""
        out, self._req_charges = self._req_charges, {}
        return out

    def request_energy(self) -> dict[int, float]:
        """Cumulative measured J per request id (J/request headline)."""
        return dict(self._req_energy)

    def request_phase_energy(self) -> dict[int, dict[str, float]]:
        """Measured per-request × per-phase energy [J].

        The combination view of the same samples :meth:`estimates`
        aggregates per phase: each (phase, request) cell gets
        ``elapsed × psum_cell / n_total``, with psums split 1/k across
        the requests in flight at sample time — summing a phase's cells
        over requests recovers that phase's energy for the sampled
        in-flight intervals (no sample is double-counted).

        Under a bounded table (``max_combinations``) the folded tail
        appears under request id ``-1`` per phase — the per-phase
        ``other`` bucket — so the partition property still holds.
        """
        if self.request_agg is None:
            raise RuntimeError("accountant built without track_requests")
        out: dict[int, dict[str, float]] = {}
        if self.agg.n_total == 0:
            return out
        names = regions_mod.registry.names
        inner = self.request_agg.agg
        scale = self.elapsed / self.agg.n_total
        for cid, (phase_rid, rid) in enumerate(
                self.request_agg.interner.combos):
            e = scale * float(inner.chan_psum[cid].sum())
            out.setdefault(int(rid), {})[names[int(phase_rid)]] = e
        return out

    def estimates(self, alpha: float = 0.05) -> EstimateSet:
        """Per-phase estimates over everything drained so far.

        With a multi-channel sensor bank the table carries the per-phase
        per-domain decomposition (``table.e_rails`` /
        ``EstimateSet.energy_by_domain``).
        """
        if self.agg.n_total == 0:
            raise RuntimeError("no samples collected")
        return self.agg.estimates(self.elapsed,
                                  regions_mod.registry.names, alpha=alpha)

    def domain_energy(self) -> dict[str, dict[str, float]]:
        """Per-phase × per-domain energy [J] drained so far.

        The serving-fleet answer to "which phase burns energy on which
        rail": ``{phase: {domain: joules}}``. Single-channel sensors
        report their one ``"total"`` rail.
        """
        est = self.estimates()
        tbl = est.table
        if tbl.domains is None:
            return {tbl.names[i]: {"total": float(tbl.e_hat[i])}
                    for i in range(len(tbl))}
        return {tbl.names[i]: {d: float(tbl.e_rails[i, j])
                               for j, d in enumerate(tbl.domains)}
                for i in range(len(tbl))}

    @staticmethod
    def gather_estimates(spill_dir: str, t_exec: float,
                         alpha: float = 0.05) -> EstimateSet:
        """Fleet view: merge every host's published shard and estimate."""
        from repro_torch.core.exchange import gather_shards
        merged = gather_shards(spill_dir)
        return merged.estimates(t_exec, regions_mod.registry.names,
                                alpha=alpha)


@functools.lru_cache(maxsize=None)
def _step_fns(cfg: ModelConfig):
    """(masked decode step, slot-state reset), shared across Engines.

    Replaces the reference's ``_jitted_fns`` (two ``jax.jit``-compiled
    functions). Each runs the model eagerly inside
    :func:`regions.opaque`, so the model's own regions take no samples,
    as those of a jitted step do after its trace. Both update the cache
    in place and return it.
    """
    def decode(p, t, c, l, m):
        with regions_mod.opaque():
            return M.decode_step(p, cfg, t, c, l, write_mask=m)

    def reset(c, m):
        with regions_mod.opaque():
            return M.reset_cache_slots(cfg, c, m)
    return decode, reset


@functools.lru_cache(maxsize=None)
def _spec_step_fns(cfg: ModelConfig, window: int, sinks: int):
    """(windowed draft step, multi-position verify step) for
    self-speculative decoding, shared across Engines.

    Replaces the reference's ``_jitted_spec_fns``; run inside
    :func:`regions.opaque` as :func:`_step_fns` are. Both write the
    cache in place: the speculative step clones the window-start cache
    where it keeps it as the recurrent families' rollback checkpoint.
    """
    def draft(p, t, c, l, m):
        with regions_mod.opaque():
            return M.decode_step(p, cfg, t, c, l, write_mask=m,
                                 window=window, sinks=sinks)

    def verify(p, t, c, l, m):
        with regions_mod.opaque():
            return M.decode_verify(p, cfg, t, c, l, write_mask=m)
    return draft, verify


def _host(t) -> np.ndarray:
    """A sampler's output as a host array (waits for the device)."""
    if isinstance(t, torch.Tensor):
        return t.cpu().numpy()
    return np.asarray(t)


def _clone_cache(cache):
    """A deep copy of a cache nest: the steps write the cache in place,
    so a checkpoint must not share its tensors."""
    if isinstance(cache, dict):
        return {k: _clone_cache(v) for k, v in cache.items()}
    if isinstance(cache, list):
        return [_clone_cache(v) for v in cache]
    return cache.clone()


def _leaves(tree):
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _leaves(v)
    elif isinstance(tree, list | tuple):
        for v in tree:
            yield from _leaves(v)
    elif isinstance(tree, torch.Tensor):
        yield tree


@dataclasses.dataclass
class ServeConfig:
    max_batch: int = 8
    max_len: int = 512
    eos_token: int = 0
    cache_dtype: str = "bfloat16"
    # Deterministic energy proxy: J charged per slot per decode step (and
    # per prompt token at prefill) against each request's budget. Replayable
    # under the step clock — measured charges from a track_requests
    # accountant are added on top when one is attached.
    step_energy: float | None = None
    # Overload response (degraded rung): shrink the accountant's
    # per-request combination table to this heavy-hitters capacity when
    # the ladder widens sampling. None leaves the table alone. The
    # shrink is irreversible (the folded tail is gone), so
    # de-escalation restores the sampling period and the speculation
    # length but not the table capacity.
    degraded_max_combinations: int | None = None
    # -- self-speculative decoding (MagicDec-style, same weights) ----------
    # spec_len L >= 2 turns speculation on: each engine step drafts L-1
    # tokens per active slot with sliding-window attention, then one
    # batched verify scores all L positions; the greedy accept-prefix
    # keeps output token-exact to spec_len=0. 0 disables.
    spec_len: int = 0
    # StreamingLLM draft mask geometry: last `spec_window` positions plus
    # the first `spec_sinks` attention-sink positions.
    spec_window: int = 16
    spec_sinks: int = 4
    # Effective speculation length while the overload ladder is widened
    # (the degraded rung's L knob). None = speculation off under
    # overload; de-escalation restores spec_len through the same
    # unwiden edge that restores the sampling period.
    degraded_spec_len: int | None = None
    # Proxy J charged per drafted token (the windowed pass reads
    # O(window+sinks) cache rows instead of O(max_len)). Defaults to
    # step_energy * (spec_window + spec_sinks) / max_len.
    draft_energy: float | None = None


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray          # [S] int32
    max_new_tokens: int = 32
    out_tokens: list[int] = dataclasses.field(default_factory=list)
    done: bool = False
    # -- scheduling contract (engine step clock, never wall clock) ----------
    priority: int = 0               # higher admits first / sheds last
    deadline: int | None = None     # max steps after submit (incl. queue wait)
    energy_budget: float | None = None  # max charged J before mid-decode abort
    status: str = "queued"
    energy_j: float = 0.0           # charged so far (proxy + measured)
    submit_step: int = 0


@dataclasses.dataclass(frozen=True)
class JoulesPerToken:
    """A quotable live J/token price signal (satellite of ROADMAP item 1).

    ``j_per_token`` is total decode-phase energy (serve/decode +
    serve/draft + serve/verify) divided by tokens emitted this session;
    ``lo``/``hi`` carry the same ratio through the phases' summed Wald
    interval bounds (estimator Eq. 16), so the CI reflects sampling
    uncertainty in the energy numerator (the token count is exact).
    """
    j_per_token: float
    lo: float
    hi: float
    alpha: float
    tokens: int
    energy_j: float
    phases: tuple[str, ...]
    domain: str | None = None


# Phases that count toward the J/token quote: the decode hot path in all
# its forms. serve/prefill is admission-side work (priced separately by
# the per-prompt-token proxy) and serve/replay is recovery/rollback
# bookkeeping — charging either to the per-emitted-token price would
# make the quote depend on restore history.
_JPT_PHASES = ("serve/decode", "serve/draft", "serve/verify")


class Engine:
    """Slot-based continuous batching over the pure decode step.

    With ``ServeConfig.spec_len`` set, the engine runs self-speculative
    decoding: each step drafts ``L-1`` tokens per slot with a cheap
    sliding-window pass over the *same* weights, then verifies all L
    positions in one batched target step and emits the greedy-accepted
    prefix plus the verify's bonus token — token-exact to the
    non-speculative engine by construction (see :meth:`step`).

    The engine runs on ``device`` (the GPU unless the caller passes
    ``device="cpu"``): ``params`` must already live there, and the cache
    is made there. Nothing moves to another device on its own.
    """

    def __init__(self, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                 *, sample: Callable | None = None,
                 accountant: PhaseEnergyAccountant | None = None,
                 scheduler: ServeScheduler | None = None, faults=None,
                 device="cuda"):
        dev = resolve_device(device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        stray = sorted({str(t.device) for t in _leaves(params)
                        if t.device != dev})
        if stray:
            raise ValueError(f"Engine on {dev}: params live on {stray}; "
                             f"move them to {dev} first")
        self.device = dev
        self.cfg = cfg
        self.params = params
        self.scfg = serve_cfg
        self.accountant = accountant
        self.scheduler = scheduler or ServeScheduler()
        self.report = self.scheduler.report
        # Deterministic step clock: number of completed engine steps.
        # Deadlines, budgets, snapshots and injected crashes are all
        # keyed on it, never on wall time.
        self.step_count = 0
        self._faults = faults
        self._requests: dict[int, Request] = {}
        B, T = serve_cfg.max_batch, serve_cfg.max_len
        dt = (torch.bfloat16 if serve_cfg.cache_dtype == "bfloat16"
              else torch.float32)
        self.cache = M.init_cache(cfg, B, T, dtype=dt, device=dev)
        self.tokens = np.zeros((B, 1), np.int32)
        self.slot_req: list[Request | None] = [None] * B
        self.slot_len = np.zeros(B, np.int32)
        self.sample = sample or (lambda logits: torch.argmax(logits, -1))
        # Session-local emitted-token counter for the J/token quote
        # (serve/replay work after a restore re-derives cache state for
        # tokens a previous session already emitted and charged, so
        # neither its energy nor its tokens enter the price).
        self._tokens_emitted = 0

        self._draft_step = self._verify_step = None
        if serve_cfg.spec_len:
            if serve_cfg.spec_len < 2:
                raise ValueError(
                    f"spec_len={serve_cfg.spec_len}: speculation needs a "
                    "verify width of at least 2 (1 draft + 1 bonus); use "
                    "0 to disable")
            if serve_cfg.degraded_spec_len is not None and not (
                    2 <= serve_cfg.degraded_spec_len <= serve_cfg.spec_len):
                raise ValueError(
                    f"degraded_spec_len={serve_cfg.degraded_spec_len} must "
                    f"be in [2, spec_len={serve_cfg.spec_len}] or None "
                    "(None = speculation off under overload)")
            if sample is not None:
                # The accept rule compares draft tokens against the
                # verify argmax; a non-greedy sampler would make
                # "token-exact to the baseline" ill-defined.
                raise ValueError(
                    "speculative decoding is token-exact only under the "
                    "default greedy sampler; pass sample=None with "
                    "spec_len > 0")
            self._draft_step, self._verify_step = _spec_step_fns(
                cfg, serve_cfg.spec_window, serve_cfg.spec_sinks)

        # Cache-position contract: every decode step takes a [B] per-slot
        # position vector — each slot's K/V is written at its OWN length
        # (a single scalar would leave gaps for short slots and overwrite
        # live entries of long ones under ragged continuous batching) —
        # plus a [B] write mask confining cache mutation to the slot
        # being prefilled (prefill) / the active slots (decode steps, so
        # free slots' recurrent SSM/xLSTM state doesn't advance on
        # garbage tokens between requests).
        self._decode_masked, self._reset_slots = _step_fns(cfg)

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        """Host array → tensor on the engine's device. The copy from
        pageable memory has read ``a`` when it returns; callers still
        pass fresh buffers, as the reference does."""
        return torch.as_tensor(a, device=self.device)

    # -- host scheduler --------------------------------------------------------
    def _free_slots(self) -> list[int]:
        return [i for i, r in enumerate(self.slot_req) if r is None]

    def _validate(self, req: Request) -> None:
        if len(req.prompt) == 0:
            # Without at least one prompt token there are no logits to
            # sample the first output token from (and the teacher-forced
            # prefill loop below would leave `logits` unbound).
            raise ValueError(f"request {req.rid}: empty prompt")
        if len(req.prompt) + 1 > self.scfg.max_len:
            # The cache ring holds max_len positions; the prompt plus at
            # least the first generated token must fit or the decode
            # write would run past the ring.
            raise ValueError(
                f"request {req.rid}: prompt length {len(req.prompt)} "
                f"does not fit max_len {self.scfg.max_len} "
                f"(need len(prompt) + 1 <= max_len)")

    def submit(self, req: Request) -> None:
        """Queue-admission edge: enqueue for the scheduler to admit as
        slots free up. Raises typed ``AdmissionError`` subclasses on
        rejection — every rejection is counted in :attr:`report` first,
        never silent. ``add_request`` remains the direct-placement path
        (bypasses the queue; returns False when no slot is free)."""
        self._validate(req)
        self._requests[req.rid] = req
        self.scheduler.submit(req, self.step_count)

    def add_request(self, req: Request) -> bool:
        self._validate(req)
        if not self._free_slots():
            return False
        if req.rid not in self.report:
            self.report.open(req.rid, status="queued",
                             step=self.step_count, priority=req.priority)
            req.submit_step = self.step_count
        self._place(req)
        return True

    def _place(self, req: Request) -> None:
        """Prefill ``req`` into the first free slot (caller checked one
        exists) and mark it admitted."""
        s = self._free_slots()[0]
        self.slot_req[s] = req
        self._requests[req.rid] = req
        mask = np.zeros(len(self.slot_req), bool)
        mask[s] = True
        # Zero the claimed slot's cache state: recurrent SSM/xLSTM state
        # is *input* to the next step, so a reused slot would otherwise
        # seed this request with its previous occupant's final state
        # (KV rows are rewritten by prefill anyway).
        self.cache = self._reset_slots(self.cache, self._dev(mask))
        # Prefill via teacher-forced decode steps on this slot (host loop;
        # fine at example scale). Writes are masked to slot s: the decode
        # step runs the whole batch, and without the mask every
        # concurrently-active slot's cache (KV at position t, and any
        # recurrent state) would be stomped at each prompt position.
        cur = self.slot_len.astype(np.int32).copy()
        with regions_mod.region("serve/prefill"):
            for t, tok in enumerate(req.prompt):
                self.tokens[s, 0] = tok
                cur[s] = t
                # Hand the step a FRESH host buffer each time: this loop
                # mutates self.tokens/cur in place while earlier decode
                # steps may still be in flight, and an asynchronous copy
                # from a shared buffer would hand them the *next*
                # iteration's values (the reference saw nondeterministic
                # prefill logits from that).
                logits, self.cache = self._decode_masked(
                    self.params, self._dev(self.tokens.copy()),
                    self.cache, self._dev(cur.copy()), self._dev(mask))
                if self.accountant is not None and t % 32 == 31:
                    # A long prefill is many sampler periods with no
                    # scheduler step in between: drain mid-loop so the
                    # bounded ring can't overrun (satellite of the
                    # never-silent contract — overruns that do happen
                    # are counted, see SampleBuffer.overruns).
                    self.accountant.drain(active_requests=(req.rid,))
        self.slot_len[s] = len(req.prompt)
        self.tokens[s, 0] = int(_host(
            self.sample(logits[s:s + 1, -1, :]))[0])
        rec = self.report.set_status(req.rid, "admitted")
        rec.admit_step = self.step_count
        req.status = "admitted"
        if self.scfg.step_energy is not None:
            self._charge(req, self.scfg.step_energy * len(req.prompt))
        if self.accountant is not None:
            self.accountant.drain(active_requests=(req.rid,))
            self._apply_measured_charges()

    # -- energy charging -------------------------------------------------------
    def _charge(self, req: Request, joules: float) -> None:
        req.energy_j += joules
        if req.rid in self.report:
            self.report.request(req.rid).energy_j = req.energy_j

    def _apply_measured_charges(self) -> None:
        if self.accountant is None or not self.accountant.track_requests:
            return
        for rid, dj in self.accountant.take_request_charges().items():
            req = self._requests.get(rid)
            if req is not None:
                self._charge(req, dj)
        # Pressure counters ride on the report so fleet dashboards see
        # interner growth (and bounded-mode folds) without touching the
        # accountant directly.
        self.report.attribution = self.accountant.attribution_pressure()

    def _widen_sampling(self, factor: float) -> None:
        if self.accountant is not None:
            self.accountant.scale_period(factor)
            if self.scfg.degraded_max_combinations is not None:
                self.accountant.shrink_tracking(
                    self.scfg.degraded_max_combinations)

    def _restore_sampling(self) -> None:
        # The single de-escalation reset path: the scheduler's unwiden
        # edge clears its widened flag (restoring the effective
        # speculation length, which is derived from that flag — see
        # _spec_len_now) and lands here to restore the sampling period.
        if self.accountant is not None:
            self.accountant.reset_period()

    def _spec_len_now(self) -> int:
        """Effective speculation length this step: the configured L,
        shrunk to ``degraded_spec_len`` (or off, when that is None)
        while the overload ladder is widened. A pure function of
        snapshot-carried scheduler state, so restored engines speculate
        identically to the uninterrupted run."""
        L = self.scfg.spec_len
        if not L or not self.scheduler.widened:
            return L
        d = self.scfg.degraded_spec_len
        return 0 if d is None else min(d, L)

    def _draft_energy(self) -> float:
        de = self.scfg.draft_energy
        if de is not None:
            return de
        frac = (self.scfg.spec_window + self.scfg.spec_sinks) / max(
            self.scfg.max_len, 1)
        return self.scfg.step_energy * min(frac, 1.0)

    def step(self) -> list[Request]:
        """One engine step: admit queued requests into free slots, run
        the overload ladder, decode every active slot (one token
        baseline, or one speculation window of up to ``spec_len`` tokens
        — see :meth:`_step_speculative`), charge energy, and enforce
        deadlines/budgets. Returns requests that left their slot this
        step — completed (``done=True``) or aborted (typed status,
        partial ``out_tokens``, ``done=False``)."""
        step = self.step_count
        plan = resolve_plan(self._faults)
        if plan is not None and plan.serve_crash_at(step):
            # Before ANY mutation: a killed step leaves the engine
            # exactly as the previous step published it, so the
            # snapshot/restore contract is bit-exact.
            raise InjectedCrash(
                f"injected crash at engine step {step} "
                f"({_SITE_STEP_CRASH})")
        while self._free_slots():
            req = self.scheduler.admit(step)
            if req is None:
                break
            self._place(req)
        self.scheduler.tick(step, widen_fn=self._widen_sampling,
                            unwiden_fn=self._restore_sampling)
        active = [i for i, r in enumerate(self.slot_req) if r is not None]
        finished: list[Request] = []
        if active:
            L = self._spec_len_now()
            # Speculation needs room for all L cache writes in every
            # active slot; near the ring's end this window falls back to
            # the baseline single-token step (the prefill's shape).
            if L and max(int(self.slot_len[s]) for s in active
                         ) + L <= self.scfg.max_len - 1:
                finished = self._step_speculative(step, active, L)
            else:
                finished = self._step_baseline(step, active)
        if self.accountant is not None:
            # Fold freshly sampled (phase, power) pairs into the
            # streaming accumulators; the raw stream never accumulates.
            rids = tuple(r.rid for r in self.slot_req if r is not None)
            self.accountant.drain(active_requests=rids or None)
            self._apply_measured_charges()
            self.report.buffer_overruns = self.accountant.buffer_overruns
        # Deadline / budget enforcement after this step's work is charged:
        # the violator leaves with partial output and a typed status.
        for s, r in enumerate(self.slot_req):
            if r is None:
                continue
            age = (step + 1) - self.report.request(r.rid).submit_step
            if r.deadline is not None and age >= r.deadline:
                self._release(
                    s, "aborted_deadline", step,
                    error=f"deadline {r.deadline} steps reached "
                          f"(age {age} at end of step {step})")
                finished.append(r)
            elif (r.energy_budget is not None
                    and r.energy_j > r.energy_budget):
                self._release(
                    s, "aborted_budget", step,
                    error=f"charged {r.energy_j:.6g} J exceeds budget "
                          f"{r.energy_budget:.6g} J")
                finished.append(r)
        self.step_count = step + 1
        return finished

    def _step_baseline(self, step: int, active: list[int]) -> list[Request]:
        """Advance every active slot one token (the non-speculative hot
        path, and the speculative engine's fallback near the cache
        ring's end)."""
        finished: list[Request] = []
        # Mask writes to active slots: free slots must not advance
        # their recurrent state on the garbage tokens in their rows.
        mask = np.asarray([r is not None for r in self.slot_req])
        with regions_mod.region("serve/decode"):
            # Fresh host buffers (see prefill loop): the scheduler
            # mutates self.tokens/slot_len right after this dispatch.
            logits, self.cache = self._decode_masked(
                self.params, self._dev(self.tokens.copy()),
                self.cache,
                self._dev(self.slot_len.astype(np.int32)),
                self._dev(mask))
        nxt = _host(self.sample(logits[:, -1, :]))
        for s in active:
            r = self.slot_req[s]
            r.out_tokens.append(int(self.tokens[s, 0]))
            self.slot_len[s] += 1
            self._tokens_emitted += 1
            self.tokens[s, 0] = int(nxt[s])
            if self.scfg.step_energy is not None:
                self._charge(r, self.scfg.step_energy)
            hit_eos = int(nxt[s]) == self.scfg.eos_token
            if (len(r.out_tokens) >= r.max_new_tokens or hit_eos
                    or self.slot_len[s] >= self.scfg.max_len - 1):
                r.done = True
                self._release(s, "completed", step)
                finished.append(r)
        return finished

    def _step_speculative(self, step: int, active: list[int],
                          L: int) -> list[Request]:
        """One speculation window: draft L-1 tokens per slot with the
        windowed pass, verify all L positions in one batched target
        step, emit the greedy-accepted prefix plus the verify's bonus
        token.

        Token-exactness argument, per cache family:

        * The verify step writes each slot's L fresh K/V rows and then
          attends over the full cache under per-position causal masks —
          the same reduction the single-token step performs — so its
          logits are the baseline's logits wherever the input prefix
          matches, which the accept rule guarantees position by
          position (accepted token j+1 must equal argmax of verify
          position j; the first mismatch truncates the window and the
          verify argmax itself is emitted, exactly the token the
          baseline would have produced).
        * KV families (dense/moe/vlm) roll back rejected positions by
          slot length alone: rows past ``slot_len`` are invisible to
          every mask and are rewritten by the next window before they
          can be read. A MoE block is dropless in the verify step as in
          the single-token step, so each position's experts and output
          depend on that position's input alone (a capacity gather
          would let the other rows of the L-wide batch drop it).
        * Recurrent families (ssm/hybrid) advance state once per call,
          so rejected drafts would leave wrong state behind. The
          window-start cache (a clone: the steps write the cache in
          place) is the verify input and the rollback target: after
          acceptance the emitted tokens are replayed from the checkpoint
          through the baseline masked single-token step (bit-exact by
          construction) under the ``serve/replay`` phase.

        The window is atomic on the step clock: the injected-crash site
        fires before any mutation, so snapshots only ever observe
        window boundaries and mid-window kill-and-restore is bit-exact.
        """
        scfg = self.scfg
        rep = self.report
        recurrent = self.cfg.family in ("ssm", "hybrid")
        mask = np.asarray([r is not None for r in self.slot_req])
        # Window-start state (see docstring); only the recurrent
        # families read it, and the steps write the cache in place.
        checkpoint = _clone_cache(self.cache) if recurrent else None
        n0 = self.slot_len.astype(np.int32).copy()

        # Draft matrix row s: [t0, d1, .., d_{L-1}] — the pending token
        # followed by L-1 windowed-greedy proposals.
        draft = np.zeros((len(self.slot_req), L), np.int32)
        draft[:, 0] = self.tokens[:, 0]
        cur = n0.copy()
        toks = self.tokens.copy()
        with regions_mod.region("serve/draft"):
            for j in range(1, L):
                logits, self.cache = self._draft_step(
                    self.params, self._dev(toks.copy()), self.cache,
                    self._dev(cur.copy()), self._dev(mask))
                prop = _host(torch.argmax(logits[:, -1, :], -1))
                draft[:, j] = prop
                toks[:, 0] = prop
                cur += 1

        # One batched target step scores all L positions. KV families
        # verify on the post-draft cache (the draft already wrote rows
        # n0..n0+L-2; verify rewrites n0..n0+L-1 with its own K/V);
        # recurrent families verify from a copy of the checkpoint (the
        # verify writes its input in place; the rollback below needs the
        # checkpoint as it was).
        vin = _clone_cache(checkpoint) if recurrent else self.cache
        with regions_mod.region("serve/verify"):
            vlogits, vcache = self._verify_step(
                self.params, self._dev(draft), vin,
                self._dev(n0.copy()), self._dev(mask))
        v = _host(torch.argmax(vlogits, -1))           # [B, L]
        if not recurrent:
            self.cache = vcache

        # Proxy charges: the windowed draft reads O(window) cache rows
        # per token; the verify is one full-cache sweep per slot
        # regardless of L (the MagicDec bandwidth model — that is the
        # whole win).
        if scfg.step_energy is not None:
            de = self._draft_energy()
            for s in active:
                self._charge(self.slot_req[s],
                             de * (L - 1) + scfg.step_energy)

        # Greedy accept-prefix, mirroring the baseline's per-token
        # emit/finish semantics exactly.
        finished: list[Request] = []
        emitted: dict[int, list[int]] = {}
        for s in active:
            r = self.slot_req[s]
            rec = rep.request(r.rid)
            rep.drafted += L - 1
            rec.spec_drafted += L - 1
            accepted = 0
            seq: list[int] = []
            pend = int(draft[s, 0])
            released = False
            for j in range(L):
                r.out_tokens.append(pend)
                seq.append(pend)
                self.slot_len[s] += 1
                self._tokens_emitted += 1
                nxt = int(v[s, j])
                hit_eos = nxt == scfg.eos_token
                if (len(r.out_tokens) >= r.max_new_tokens or hit_eos
                        or self.slot_len[s] >= scfg.max_len - 1):
                    r.done = True
                    self._release(s, "completed", step)
                    finished.append(r)
                    released = True
                    break
                if j + 1 < L and int(draft[s, j + 1]) == nxt:
                    accepted += 1
                    pend = nxt
                    continue
                pend = nxt          # first mismatch (or bonus token)
                break
            if not released:
                self.tokens[s, 0] = pend
                emitted[s] = seq
            rep.accepted += accepted
            rep.rejected += (L - 1) - accepted
            rec.spec_accepted += accepted
            if accepted < L - 1:
                rep.rollbacks += 1

        if recurrent:
            # Roll back to the window-start checkpoint and replay each
            # surviving slot's emitted tokens through the baseline
            # masked step. Released slots skip replay: admission resets
            # their state before reuse.
            self.cache = checkpoint
            depth = max((len(t) for t in emitted.values()), default=0)
            rcur = n0.copy()
            rtoks = self.tokens.copy()
            with regions_mod.region("serve/replay"):
                for k in range(depth):
                    wmask = np.zeros(len(self.slot_req), bool)
                    for s, t in emitted.items():
                        if k < len(t):
                            wmask[s] = True
                            rtoks[s, 0] = t[k]
                    _, self.cache = self._decode_masked(
                        self.params, self._dev(rtoks.copy()), self.cache,
                        self._dev(rcur.copy()), self._dev(wmask))
                    rcur += wmask
        return finished

    def current_joules_per_token(self, *, alpha: float = 0.05,
                                 max_rel_halfwidth: float = 0.5,
                                 domain: str | None = None
                                 ) -> JoulesPerToken:
        """Live J/token over the decode phases (serve/decode +
        serve/draft + serve/verify), with the streaming Wald CI carried
        through — the admission price-tier signal from ROADMAP item 1.

        Raises :class:`PriceSignalUnavailableError` (typed, never a
        silent bad quote) when no accountant is attached, nothing has
        been emitted or drained yet, any decode phase's CI is invalid
        (estimator Eq. 16 normality guard), or the summed CI halfwidth
        exceeds ``max_rel_halfwidth`` of the estimate. ``domain``
        selects one rail of a multi-channel sensor bank (e.g. "hbm" for
        the accepted-tokens-per-HBM-joule headline).
        """
        if self.accountant is None:
            raise PriceSignalUnavailableError(
                "no accountant attached: the J/token quote needs "
                "measured phase energy, not the step_energy proxy")
        if self._tokens_emitted <= 0:
            raise PriceSignalUnavailableError(
                "no tokens emitted this session yet")
        try:
            est = self.accountant.estimates(alpha)
        except RuntimeError as e:
            raise PriceSignalUnavailableError(
                f"no samples drained yet: {e}") from e
        tbl = est.table
        # Only phases that have actually been sampled participate: a
        # zero-sample row (e.g. serve/draft interned but speculation
        # off) contributes no energy and its Wald guard is vacuously
        # invalid — it must not block the quote.
        idx = [i for i in range(len(tbl)) if tbl.names[i] in _JPT_PHASES
               and int(tbl.n_samples[i]) > 0]
        if not idx:
            raise PriceSignalUnavailableError(
                "no decode-phase samples yet (phases "
                f"{_JPT_PHASES} absent from the estimate table)")
        invalid = [tbl.names[i] for i in idx if not bool(tbl.ci_valid[i])]
        if invalid:
            raise PriceSignalUnavailableError(
                f"Wald CI not yet valid for phase(s) {invalid} "
                "(normality guard n*p>5 — keep serving and re-quote)")
        if domain is None:
            e = float(sum(tbl.e_hat[i] for i in idx))
            lo = float(sum(tbl.e_lo[i] for i in idx))
            hi = float(sum(tbl.e_hi[i] for i in idx))
        else:
            if tbl.domains is None or domain not in tbl.domains:
                raise PriceSignalUnavailableError(
                    f"domain {domain!r} not measured (sensor rails: "
                    f"{tbl.domains})")
            j = tbl.domains.index(domain)
            e = float(sum(tbl.e_rails[i, j] for i in idx))
            lo = float(sum(tbl.e_rails_lo[i, j] for i in idx))
            hi = float(sum(tbl.e_rails_hi[i, j] for i in idx))
        half = 0.5 * (hi - lo)
        if e <= 0.0 or half > max_rel_halfwidth * e:
            raise PriceSignalUnavailableError(
                f"CI too wide to quote: halfwidth {half:.3g} J on "
                f"{e:.3g} J exceeds {max_rel_halfwidth:.0%} "
                "(keep serving and re-quote)")
        t = self._tokens_emitted
        return JoulesPerToken(
            j_per_token=e / t, lo=lo / t, hi=hi / t, alpha=alpha,
            tokens=t, energy_j=e,
            phases=tuple(tbl.names[i] for i in idx), domain=domain)

    def _release(self, s: int, status: str, step: int,
                 error: str | None = None) -> None:
        r = self.slot_req[s]
        r.status = status
        rec = self.report.set_status(r.rid, status, step=step, error=error)
        rec.tokens_out = len(r.out_tokens)
        self.slot_req[s] = None
        self.slot_len[s] = 0

    def run_until_drained(self, requests: list[Request],
                          max_steps: int = 10_000) -> list[Request]:
        """Drive the engine until every pending, queued and in-flight
        request has left its slot. Raises :class:`ServeTimeoutError`
        carrying the undrained request ids if ``max_steps`` elapses with
        work still outstanding — never a silent partial return."""
        done: list[Request] = []
        pending = list(requests)
        for _ in range(max_steps):
            while pending and self._free_slots():
                self.add_request(pending.pop(0))
            done += self.step()
            if (not pending and not len(self.scheduler.queue)
                    and all(r is None for r in self.slot_req)):
                return done
        undrained = sorted(
            [r.rid for r in pending]
            + [r.rid for r in self.slot_req if r is not None]
            + [e[2].rid for e in self.scheduler.queue.snapshot()])
        raise ServeTimeoutError(
            f"{len(undrained)} request(s) undrained after {max_steps} "
            f"steps: {undrained}", undrained)

    # -- durability ------------------------------------------------------------
    def snapshot(self, path: str) -> str:
        """Publish a durable crash-recovery snapshot under ``path``
        (see :mod:`repro_torch.serve.recovery` for the contract)."""
        from repro_torch.serve.recovery import snapshot as _snapshot
        return _snapshot(self, path)

    @classmethod
    def restore(cls, cfg: ModelConfig, params, serve_cfg: ServeConfig,
                path: str, **kwargs) -> "Engine":
        """Rebuild an engine from its last durable snapshot, replaying
        generated prefixes so subsequent tokens are bit-exact with the
        uninterrupted run
        (:func:`repro_torch.serve.recovery.restore_engine`)."""
        from repro_torch.serve.recovery import restore_engine
        return restore_engine(cfg, params, serve_cfg, path, **kwargs)
