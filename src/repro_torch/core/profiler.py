"""EnergyProfiler: one-pass sampling orchestration (paper Fig. 1, §4.8).

Usage, timeline mode (timelines synthesized from dry-run costs):

    prof = EnergyProfiler(period=10e-3)           # runs on the GPU
    est = prof.profile_timeline_streaming(timeline, sensor="rapl")
    print(prof.report(est).table())

Usage, host mode (a real control thread on this machine):

    prof = EnergyProfiler(period=2e-3)
    with prof.host_session() as session:
        ... run code using regions.region(...) ...
    est = session.estimates()

``device`` names where the device pipeline runs: ``"cuda"`` (the
default) or ``"cpu"`` (the plain PyTorch path the CPU tests use). Asking
for the GPU where torch sees none raises.

Where the profiler's own time went: after a profile through the device
pipeline, ``prof.last_trace`` is its record
(:class:`~repro_torch.core.spans.ProfileTrace`): the seconds of each
stage (upload, clock, lookup, sensor, search, fold, miss path, read-back,
estimates) and the counters:

    est = prof.profile_timeline_streaming(timeline, pipeline="device")
    print(prof.last_trace.by_name())
"""

from __future__ import annotations

import contextlib

import numpy as np

from repro_torch.convert import resolve_device
from repro_torch.core import regions as regions_mod
from repro_torch.core import spans
from repro_torch.core.attribution import AttributionReport
from repro_torch.core.estimator import (AggregateFn, EstimateSet,
                                        estimate_combinations,
                                        estimate_regions)
from repro_torch.core.sampler import (HostSampler, RegionMarker,
                                      SampleStream, iter_multiworker_chunks,
                                      iter_sample_chunks, sample_timeline,
                                      sample_timeline_multiworker)
from repro_torch.core.sensors import (Ina231TraceSensor, InstantTraceSensor,
                                      RaplTraceSensor, available_host_sensor)
from repro_torch.core.stream_marker import StreamMarker
from repro_torch.core.streaming import (StreamingAggregator,
                                        StreamingCombinationAggregator)
from repro_torch.core.timeline import Timeline

__all__ = ["EnergyProfiler", "HostSession"]

_SENSORS = {
    "rapl": RaplTraceSensor,
    "ina231": Ina231TraceSensor,
    "instant": InstantTraceSensor,
}


class HostSession:
    """A live host-mode profiling pass.

    ``sensor`` defaults to the best scalar sensor the environment
    permits; passing a :class:`~repro_torch.core.sensors.HostSensorBank`
    makes the session multi-rail — the sampler drains [n, D] power
    matrices and :meth:`estimates` carries per-domain columns, exactly
    like the timeline paths. Samples under ``region`` attribute host
    time: on the GPU a region is current while its work is being queued.
    Under ``jit_marking`` on a CUDA profiler the marker is a
    :class:`~repro_torch.core.stream_marker.StreamMarker`, so
    ``mark_in_jit`` marks in stream order (its library is built here, and
    a failure raises).
    """

    def __init__(self, profiler: "EnergyProfiler", jit_marking: bool,
                 sensor=None):
        self._prof = profiler
        self.marker = (StreamMarker(profiler.device)
                       if jit_marking and profiler.device.type == "cuda"
                       else RegionMarker())
        sensor = available_host_sensor() if sensor is None else sensor
        min_period = (sensor.effective_min_period()
                      if hasattr(sensor, "effective_min_period")
                      else getattr(sensor, "min_period", 0.0))
        if profiler.period < min_period:
            raise ValueError(f"sampling period {profiler.period} below the "
                             f"sensor bank's floor {min_period}")
        self.sampler = HostSampler(
            self.marker, sensor,
            period=profiler.period, jitter=profiler.jitter,
            seed=profiler.seed)
        self._ctx = None
        self._jit_marking = jit_marking

    def __enter__(self) -> "HostSession":
        self._ctx = contextlib.ExitStack()
        self._ctx.enter_context(
            regions_mod.profiling_session(self.marker,
                                          jit_marking=self._jit_marking))
        self._ctx.enter_context(self.sampler)
        return self

    def __exit__(self, *exc) -> None:
        assert self._ctx is not None
        self._ctx.close()

    def stream(self) -> SampleStream:
        return self.sampler.stream()

    def estimates(self, alpha: float = 0.05) -> EstimateSet:
        s = self.stream()
        names = regions_mod.registry.names
        if s.powers.ndim == 2:
            # Banked sensor: aggregate the [n, D] matrix so the estimate
            # set carries per-rail columns (domain_table/domain_csv).
            hi = int(s.region_ids.max()) + 1 if len(s.region_ids) else 0
            agg = StreamingAggregator(max(len(names), hi, 1),
                                      domains=self.sampler.domains)
            if len(s.region_ids):
                agg.update(s.region_ids, s.powers)
            return agg.estimates(s.t_exec, names, alpha=alpha)
        return estimate_regions(s.region_ids, s.powers, s.t_exec,
                                names, alpha=alpha)


class EnergyProfiler:
    """Fine-grain energy profiler with systematic sampling.

    ``last_trace`` is the :class:`~repro_torch.core.spans.ProfileTrace` of
    this profiler's newest profile through the device pipeline (None
    before one): the spans and counters of ALEA's own work, the
    operator's view of what profiling costs beside the profiled program.
    """

    def __init__(self, *, period: float = 10e-3, jitter: float = 200e-6,
                 alpha: float = 0.05, seed: int = 0, device="cuda"):
        if period <= 0:
            raise ValueError("period must be positive")
        self.period = period
        self.jitter = jitter
        self.alpha = alpha
        self.seed = seed
        self.device = resolve_device(device)
        self.last_trace: spans.ProfileTrace | None = None

    # -- timeline mode (numpy, one-shot) -------------------------------------
    def profile_timeline(self, tl: Timeline, *, sensor: str = "rapl",
                         overhead_per_sample: float = 0.0,
                         seed: int | None = None) -> EstimateSet:
        sens = _SENSORS[sensor](tl)
        stream = sample_timeline(
            tl, sens, period=self.period, jitter=self.jitter,
            overhead_per_sample=overhead_per_sample,
            seed=self.seed if seed is None else seed)
        return estimate_regions(stream.region_ids, stream.powers,
                                stream.t_exec, tl.names, alpha=self.alpha)

    def profile_multiworker(self, timelines: list[Timeline], *,
                            sensor: str = "rapl", seed: int | None = None):
        """§4.4: combination-level attribution across concurrent workers."""
        stream = sample_timeline_multiworker(
            timelines, lambda tl: _SENSORS[sensor](tl),
            period=self.period, jitter=self.jitter,
            seed=self.seed if seed is None else seed)
        names = timelines[0].names
        return estimate_combinations(stream.region_ids, stream.powers,
                                     stream.t_exec, names, alpha=self.alpha)

    # -- streaming (fleet-scale) mode ------------------------------------------
    def _resolve_pipeline(self, pipeline: str, aggregate_fn) -> bool:
        """True → device pipeline; False → host-numpy chunk loop.

        ``auto`` prefers the device pipeline whenever it is importable
        (torch is) and no explicit per-chunk ``aggregate_fn`` was plugged
        in (a custom kernel plug implies the host chunk seam), and takes
        the host path when the device path's preconditions don't hold
        (jitter > period breaks its monotone sample clock).
        """
        if pipeline not in ("auto", "device", "host"):
            raise ValueError(f"pipeline must be auto|device|host; "
                             f"got {pipeline!r}")
        if pipeline == "host":
            return False
        if pipeline == "device" and aggregate_fn is not None:
            raise ValueError(
                "aggregate_fn plugs the host chunk seam and would be "
                "silently ignored by the device pipeline; use "
                "pipeline=\"host\" (or drop aggregate_fn)")
        if pipeline == "auto" and (aggregate_fn is not None
                                   or self.jitter > self.period):
            return False
        try:
            import repro_torch.core.device_pipeline  # noqa: F401
        except ImportError:
            if pipeline == "device":
                raise
            return False
        return True

    @contextlib.contextmanager
    def _device_trace(self, path: str, seed: int, workers: int,
                      chunk_size: int):
        """The record of one profile through the device pipeline, with its
        ``alea.profile`` span; kept as :attr:`last_trace`."""
        with spans.record(path, seed=seed, workers=workers,
                          chunk_size=chunk_size) as trace, \
                spans.span("alea.profile", ranged=False):
            self.last_trace = trace
            yield

    def profile_timeline_streaming(self, tl: Timeline, *,
                                   sensor: str = "rapl",
                                   chunk_size: int = 65536,
                                   overhead_per_sample: float = 0.0,
                                   aggregate_fn: AggregateFn | None = None,
                                   seed: int | None = None,
                                   pipeline: str = "auto") -> EstimateSet:
        """Constant-memory profiling: chunked sampling → StreamingAggregator.

        ``pipeline`` selects the backend: ``"device"`` runs the
        device-resident pipeline (:mod:`repro_torch.core.device_pipeline`)
        on ``self.device`` — sample generation, region lookup, sensor
        emulation and the ``sample_attr`` fold, with only the final
        statistics brought back; ``"host"`` keeps the numpy reference
        loop; ``"auto"`` (default) uses the device pipeline.
        ``aggregate_fn`` plugs a kernel into the *host* chunk seam (and so
        implies the host path under ``auto``).
        """
        use_seed = self.seed if seed is None else seed
        if self._resolve_pipeline(pipeline, aggregate_fn):
            from repro_torch.core import device_pipeline as dp
            with self._device_trace("region", use_seed, 1, chunk_size):
                res = dp.run_region_pipeline(
                    tl.to_device(device=self.device),
                    _SENSORS[sensor].make_spec(domains=tl.domain_names),
                    period=self.period, jitter=self.jitter, seed=use_seed,
                    chunk_size=chunk_size,
                    overhead_per_sample=overhead_per_sample)
                with spans.span("alea.estimate"):
                    agg = StreamingAggregator.from_statistics(
                        res.counts,
                        res.psum if tl.num_domains == 1 else np.concatenate(
                            [res.rail_psum, res.psum[:, None]], axis=1),
                        res.psumsq if tl.num_domains == 1 else
                        np.concatenate([res.rail_psumsq,
                                        res.psumsq[:, None]], axis=1),
                        domains=tl.domain_names)
                    return agg.estimates(res.t_exec, tl.names,
                                         alpha=self.alpha)
        sens = _SENSORS[sensor](tl)
        agg = StreamingAggregator(len(tl.names), aggregate_fn=aggregate_fn,
                                  domains=tl.domain_names)
        n = 0
        for rids, pows in iter_sample_chunks(
                tl, sens, period=self.period, jitter=self.jitter,
                overhead_per_sample=overhead_per_sample,
                seed=use_seed, chunk_size=chunk_size):
            agg.update(rids, pows)
            n += len(rids)
        t_exec = tl.t_exec + n * overhead_per_sample
        return agg.estimates(t_exec, tl.names, alpha=self.alpha)

    def profile_multiworker_streaming(self, timelines: list[Timeline], *,
                                      sensor: str = "rapl",
                                      chunk_size: int = 65536,
                                      aggregate_fn: AggregateFn | None = None,
                                      exchange=None,
                                      seed: int | None = None,
                                      pipeline: str = "auto"):
        """§4.4 combination attribution without materializing the stream.

        Chunked multi-worker sampling feeds a
        StreamingCombinationAggregator (incremental combination
        interning), so fleet-scale combination spaces (10⁴–10⁵) stay
        bounded by O(chunk + distinct combinations). With
        ``pipeline="device"`` (the ``auto`` default) the whole chunk loop
        is the device pipeline on ``self.device``
        (:func:`repro_torch.core.device_pipeline.run_combo_pipeline`):
        every worker of a chunk is looked up in one batched step, and
        chunks whose combinations are already in the device-resident key
        table fold through the ``sample_attr`` kernel with no host
        transfer beyond a one-scalar miss flag.

        ``exchange`` selects the cross-host shard-exchange strategy for
        the final reduction (:mod:`repro_torch.core.exchange`): a
        ``CollectiveExchange`` all-reduces this host's aggregator over a
        mesh axis, a ``CheckpointExchange`` spills it durably and merges
        every published host shard — combination ids are deduped lazily
        at merge in both cases. ``None`` keeps the single-host result.

        Restart semantics: sampling here is deterministic in ``seed``,
        so a restarted host re-produces its complete shard and the final
        spill republishes LATEST idempotently — the previous spill is
        deliberately NOT merged in (that would double-count every
        sample). Under the checkpoint exchange's default delta mode the
        idempotent republish is itself incremental: the regenerated
        shard matches the restored chain row for row, so the new epoch
        is an empty delta and gathers stay bit-exact. Incremental
        resume-from-spill is for accumulating consumers
        (``PhaseEnergyAccountant``, direct ``restore_shard``).
        """
        use_seed = self.seed if seed is None else seed
        device = self._resolve_pipeline(pipeline, aggregate_fn)
        with (self._device_trace("combination", use_seed, len(timelines),
                                 chunk_size)
              if device else contextlib.nullcontext()):
            if device:
                from repro_torch.core import device_pipeline as dp
                dtl = dp.DeviceTimeline.from_timelines(timelines,
                                                       device=self.device)
                agg, _n = dp.run_combo_pipeline(
                    dtl, _SENSORS[sensor].make_spec(domains=dtl.domains),
                    period=self.period, jitter=self.jitter, seed=use_seed,
                    chunk_size=chunk_size)
            else:
                agg = StreamingCombinationAggregator(
                    aggregate_fn=aggregate_fn,
                    domains=timelines[0].domain_names)
                agg.update_stream(iter_multiworker_chunks(
                    timelines, lambda tl: _SENSORS[sensor](tl),
                    period=self.period, jitter=self.jitter,
                    seed=use_seed, chunk_size=chunk_size))
            if exchange is not None:
                agg = exchange.reduce(agg)
            t_end = min(tl.t_exec for tl in timelines)
            with spans.span("alea.estimate"):
                return agg.estimates(t_end, timelines[0].names,
                                     alpha=self.alpha)

    # -- host (this machine) mode --------------------------------------------
    def host_session(self, *, jit_marking: bool = False,
                     sensor=None) -> HostSession:
        """A live session on this machine. ``sensor`` accepts any scalar
        host sensor or a :class:`~repro_torch.core.sensors.HostSensorBank`
        (per-rail host profiling, with the bank's failover semantics).
        ``jit_marking`` hands region marking to
        :func:`~repro_torch.core.regions.mark_in_jit` (validation runs)."""
        return HostSession(self, jit_marking, sensor=sensor)

    # -- convenience -----------------------------------------------------------
    def report(self, est: EstimateSet) -> AttributionReport:
        return AttributionReport(est)
