"""EnergyProfiler: one-pass sampling orchestration (paper Fig. 1, §4.8).

Usage, timeline mode (timelines synthesized from dry-run costs):

    prof = EnergyProfiler(period=10e-3)           # runs on the GPU
    est = prof.profile_timeline_streaming(timeline, sensor="rapl")
    print(prof.report(est).table())

``device`` names where the device pipeline runs: ``"cuda"`` (the
default) or ``"cpu"`` (the plain PyTorch path the CPU tests use). Asking
for the GPU where torch sees none raises. Host-mode sessions
(``host_session``) are not ported yet.
"""

from __future__ import annotations

import numpy as np

from repro_torch.convert import resolve_device
from repro_torch.core.attribution import AttributionReport
from repro_torch.core.estimator import (AggregateFn, EstimateSet,
                                        estimate_combinations,
                                        estimate_regions)
from repro_torch.core.sampler import (iter_multiworker_chunks,
                                      iter_sample_chunks, sample_timeline,
                                      sample_timeline_multiworker)
from repro_torch.core.sensors import (Ina231TraceSensor, InstantTraceSensor,
                                      RaplTraceSensor)
from repro_torch.core.streaming import (StreamingAggregator,
                                        StreamingCombinationAggregator)
from repro_torch.core.timeline import Timeline

__all__ = ["EnergyProfiler"]

_SENSORS = {
    "rapl": RaplTraceSensor,
    "ina231": Ina231TraceSensor,
    "instant": InstantTraceSensor,
}


class EnergyProfiler:
    """Fine-grain energy profiler with systematic sampling."""

    def __init__(self, *, period: float = 10e-3, jitter: float = 200e-6,
                 alpha: float = 0.05, seed: int = 0, device="cuda"):
        if period <= 0:
            raise ValueError("period must be positive")
        self.period = period
        self.jitter = jitter
        self.alpha = alpha
        self.seed = seed
        self.device = resolve_device(device)

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
            res = dp.run_region_pipeline(
                tl.to_device(device=self.device),
                _SENSORS[sensor].make_spec(domains=tl.domain_names),
                period=self.period, jitter=self.jitter, seed=use_seed,
                chunk_size=chunk_size,
                overhead_per_sample=overhead_per_sample)
            agg = StreamingAggregator.from_statistics(
                res.counts,
                res.psum if tl.num_domains == 1 else np.concatenate(
                    [res.rail_psum, res.psum[:, None]], axis=1),
                res.psumsq if tl.num_domains == 1 else np.concatenate(
                    [res.rail_psumsq, res.psumsq[:, None]], axis=1),
                domains=tl.domain_names)
            return agg.estimates(res.t_exec, tl.names, alpha=self.alpha)
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
                                      seed: int | None = None,
                                      pipeline: str = "auto"):
        """§4.4 combination attribution without materializing the stream.

        Chunked multi-worker sampling feeds a
        StreamingCombinationAggregator (incremental combination
        interning). Only the host pipeline is ported: the device
        combination pipeline (``run_combo_pipeline``) is the next slice,
        so a call that resolves to the device pipeline raises instead of
        quietly taking the host path. Cross-host ``exchange`` is not
        ported yet either.
        """
        if self._resolve_pipeline(pipeline, aggregate_fn):
            raise NotImplementedError(
                "the device combination pipeline (run_combo_pipeline, "
                "ROADMAP item A3b) is not ported yet; pass "
                "pipeline=\"host\"")
        use_seed = self.seed if seed is None else seed
        agg = StreamingCombinationAggregator(
            aggregate_fn=aggregate_fn, domains=timelines[0].domain_names)
        agg.update_stream(iter_multiworker_chunks(
            timelines, lambda tl: _SENSORS[sensor](tl),
            period=self.period, jitter=self.jitter,
            seed=use_seed, chunk_size=chunk_size))
        t_end = min(tl.t_exec for tl in timelines)
        return agg.estimates(t_end, timelines[0].names, alpha=self.alpha)

    # -- convenience -----------------------------------------------------------
    def report(self, est: EstimateSet) -> AttributionReport:
        return AttributionReport(est)
