"""ALEA core: fine-grain energy profiling with region (basic-block) sampling.

The port's surface covers what its slices have ported so far: the host
numpy modules, the device pipeline (single-worker and combination), the
profiler with its host sessions, the region markers (``core.regions``)
and the cross-host shard exchange (``core.exchange``). Energy
optimisation is not ported yet, and nothing here imports it.
"""

from repro_torch.core.attribution import (AttributionReport,
                                          ValidationResult, validate)
from repro_torch.core.estimator import (AggregateFn, EstimateSet,
                                        EstimateTable, RegionEstimate,
                                        aggregate_samples_np,
                                        estimate_combinations,
                                        estimate_regions,
                                        estimates_from_statistics,
                                        z_quantile)
from repro_torch.core.exchange import (CheckpointExchange,
                                       CollectiveExchange, PackedShard,
                                       collective_reduce, gather_shards,
                                       pack_shard, restore_shard,
                                       spill_shard, unpack_shard)
from repro_torch.core.power_model import (TPU_V5E, HardwareSpec, PowerModel,
                                          PowerModelParams)
from repro_torch.core.profiler import EnergyProfiler, HostSession
from repro_torch.core.regions import profiling_session, region, registry
from repro_torch.core.sampler import (HostSampler, RegionMarker,
                                      SampleBuffer, SampleStream,
                                      iter_multiworker_chunks,
                                      iter_sample_chunks, sample_timeline)
from repro_torch.core.streaming import (CombinationInterner,
                                        StreamingAggregator,
                                        StreamingCombinationAggregator,
                                        stream_estimate)
from repro_torch.core.timeline import (RegionCost, Timeline, ground_truth,
                                       synthesize)

__all__ = [
    "AttributionReport", "ValidationResult", "validate",
    "AggregateFn", "EstimateSet", "EstimateTable", "RegionEstimate",
    "aggregate_samples_np", "estimate_combinations", "estimate_regions",
    "estimates_from_statistics", "z_quantile",
    "CheckpointExchange", "CollectiveExchange", "PackedShard",
    "collective_reduce", "gather_shards", "pack_shard", "restore_shard",
    "spill_shard", "unpack_shard",
    "CombinationInterner", "StreamingAggregator",
    "StreamingCombinationAggregator", "stream_estimate",
    "TPU_V5E", "HardwareSpec", "PowerModel", "PowerModelParams",
    "EnergyProfiler", "HostSession",
    "profiling_session", "region", "registry",
    "HostSampler", "RegionMarker", "SampleBuffer", "SampleStream",
    "iter_multiworker_chunks", "iter_sample_chunks", "sample_timeline",
    "RegionCost", "Timeline", "ground_truth", "synthesize",
]
