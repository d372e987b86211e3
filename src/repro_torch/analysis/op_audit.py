"""Layer 2 of the contract auditor: op audits of the hot paths.

Port of ``src/repro/analysis/jaxpr_audit.py``. The paper's ~1% overhead
cap dies by a thousand cuts that unit tests don't see: a float64 op
creeping into the serve decode step, a carry that stops being updated in
place (a second carry allocated every chunk), a stray ``.item()`` making
the host wait for the device every step. The reference traces its jitted
hot paths into jaxprs; eager PyTorch has no trace to walk, so each path
here runs once, on small inputs, under a ``TorchDispatchMode`` that
records every aten op it issues (:func:`audit_ops`), and reports per
path:

* a **float64-op inventory** (every op with a float64 output, by op) —
  ratcheted against ``x64_budget.json``: counts may only go down;
* **widenings** — ops that output float64 from no float64 input (``_to_copy``
  and the like): implicit promotion rather than deliberate float64 math;
* **host waits** (the budget's ``host_callbacks``) — ops that make the
  host wait for the device: a scalar read, ``nonzero``,
  ``masked_select``, a boolean-mask index, a copy of a CUDA tensor to the
  host;
* **in-place carries** (the budget's ``donated_*``) — each carry leaf a
  step should update in place must come back in the same storage
  (:func:`donation_in_place`, the counterpart of XLA's buffer donation);
* **kernel launches** — the CUDA kernels launch through ``ctypes`` with
  raw pointers, so the dispatch mode never sees them on the card; each
  report also carries the delta of the wrappers' ``.launches`` counters
  over its path (informational, outside the budget).

Audited paths: the device pipeline's region chunk step, combination
chunk step and miss-path fold at D=1 and D=3, the serve decode step plus
the windowed draft and the multi-position verify for each cache family
(dense / moe / ssm / hybrid), and the exchange collectives on a
one-rank process group. Builders take ``device=``: the tests pass
``"cpu"``, ``chip_smoke.py`` ``"cuda"``.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode

__all__ = [
    "OpStats", "PathReport", "audit_ops", "donation_in_place",
    "jit_cache_size", "HOT_PATH_BUILDERS", "audit_hot_paths",
]


# -- walking a path -------------------------------------------------------------

_HOST_WAITS = frozenset({"nonzero", "_local_scalar_dense", "masked_select"})


def _tensors(tree) -> list[torch.Tensor]:
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (list, tuple)):
        return [t for x in tree for t in _tensors(x)]
    if isinstance(tree, dict):
        return [t for x in tree.values() for t in _tensors(x)]
    return []


def _read_inputs(func, args, kwargs) -> list[torch.Tensor]:
    """The tensors an op reads: its tensor arguments except those it
    writes (``copy_``'s destination, an ``out=``)."""
    out = []
    schema_args = func._schema.arguments
    for i, a in enumerate(args):
        info = schema_args[i].alias_info if i < len(schema_args) else None
        if info is None or not info.is_write:
            out.extend(_tensors(a))
    by_name = {a.name: a for a in schema_args}
    for k, v in kwargs.items():
        info = getattr(by_name.get(k), "alias_info", None)
        if info is None or not info.is_write:
            out.extend(_tensors(v))
    return out


def _host_wait(func, args, kwargs, out) -> str | None:
    """The reason ``func`` makes the host wait for the device, or None."""
    name = func.overloadpacket.__name__
    if name in _HOST_WAITS:
        return name
    if name.startswith("index") and len(args) > 1 and any(
            isinstance(i, torch.Tensor) and i.dtype == torch.bool
            for i in (args[1] or ())):
        return f"{name} by a boolean mask"
    if name in ("_to_copy", "copy_"):
        src = args[1] if name == "copy_" else args[0]
        dst = args[0] if name == "copy_" else out
        if (isinstance(src, torch.Tensor) and isinstance(dst, torch.Tensor)
                and src.device.type == "cuda" and dst.device.type == "cpu"):
            return f"{name} device to host"
    return None


@dataclasses.dataclass
class OpStats:
    """Inventory of the aten ops one run of a path issued."""
    eqn_count: int = 0                # ops seen (the reference's equations)
    f64_by_prim: dict = dataclasses.field(default_factory=dict)
    f64_widenings: int = 0
    callback_prims: list = dataclasses.field(default_factory=list)
    ops: list = dataclasses.field(default_factory=list)

    @property
    def f64_ops(self) -> int:
        return sum(self.f64_by_prim.values())

    @property
    def host_callbacks(self) -> int:
        return len(self.callback_prims)


class _Recorder(TorchDispatchMode):
    def __init__(self, stats: OpStats):
        super().__init__()
        self.stats = stats

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        s = self.stats
        name = str(func)
        s.eqn_count += 1
        s.ops.append(name)
        wait = _host_wait(func, args, kwargs, out)
        if wait is not None:
            s.callback_prims.append(wait)
        if any(t.dtype == torch.float64 for t in _tensors(out)):
            s.f64_by_prim[name] = s.f64_by_prim.get(name, 0) + 1
            read = _read_inputs(func, args, kwargs)
            if read and not any(t.dtype == torch.float64 for t in read):
                s.f64_widenings += 1
        return out


def audit_ops(fn, *args, **kwargs) -> OpStats:
    """Run ``fn(*args, **kwargs)`` once and tally every aten op it issues.

    An op counts toward the float64 inventory when any output is
    float64; it counts as a widening when it also reads no float64
    tensor. ``ops`` lists the ops in order (``str(func)``).
    """
    stats = OpStats()
    with _Recorder(stats):
        fn(*args, **kwargs)
    return stats


# -- in-place carries -------------------------------------------------------------

def _storage(t: torch.Tensor) -> int:
    return t.untyped_storage().data_ptr()


def donation_in_place(step, carry, *args, **kwargs) -> tuple[int, int]:
    """(expected, aliased) for one call ``step(carry, *args, **kwargs)``:
    every leaf of ``carry`` is expected back in place.

    ``step`` returns its carry, alone or first in a tuple; a leaf counts
    as aliased when it comes back in the storage it went in with (the
    input carry is held across the call, so a new tensor cannot reuse
    its memory)."""
    before = [_storage(t) for t in carry]
    out = step(carry, *args, **kwargs)
    out_carry = out if all(isinstance(t, torch.Tensor) for t in out) \
        else out[0]
    aliased = sum(isinstance(t, torch.Tensor) and _storage(t) == p
                  for t, p in zip(out_carry, before))
    return len(before), aliased


# -- cache introspection ------------------------------------------------------------

def jit_cache_size(fn) -> int:
    """Entries of a ``functools.lru_cache``/``cache`` callable — the probe
    behind the recompile guard (one (config, shape) key must mean one
    entry: one built library, one set of step functions)."""
    return int(fn.cache_info().currsize)


# -- hot-path registry ----------------------------------------------------------------

HOT_PATH_BUILDERS: dict[str, Callable[..., "PathReport"]] = {}


def _hot_path(name: str):
    def deco(fn):
        HOT_PATH_BUILDERS[name] = fn
        return fn
    return deco


@dataclasses.dataclass
class PathReport:
    """Audit result for one named hot path (the budget-file row)."""
    name: str
    eqn_count: int
    f64_ops: int
    f64_by_prim: dict
    f64_widenings: int
    host_callbacks: int
    callback_prims: tuple
    donated_expected: int = 0
    donated_aliased: int = 0
    launches: dict = dataclasses.field(default_factory=dict)

    @classmethod
    def from_stats(cls, name: str, stats: OpStats, *,
                   donated: tuple[int, int] = (0, 0),
                   launches: dict | None = None) -> "PathReport":
        return cls(name=name, eqn_count=stats.eqn_count,
                   f64_ops=stats.f64_ops,
                   f64_by_prim=dict(sorted(stats.f64_by_prim.items())),
                   f64_widenings=stats.f64_widenings,
                   host_callbacks=stats.host_callbacks,
                   callback_prims=tuple(stats.callback_prims),
                   donated_expected=donated[0], donated_aliased=donated[1],
                   launches=dict(launches or {}))

    def render(self) -> str:
        parts = [f"{self.name}: {self.eqn_count} ops, "
                 f"{self.f64_ops} f64 ops"]
        if self.f64_by_prim:
            top = ", ".join(f"{k}×{v}" for k, v in
                            sorted(self.f64_by_prim.items(),
                                   key=lambda kv: -kv[1])[:4])
            parts.append(f"({top})")
        parts.append(f"{self.f64_widenings} widenings")
        parts.append(f"{self.host_callbacks} host waits")
        if self.donated_expected:
            parts.append(f"in place {self.donated_aliased}/"
                         f"{self.donated_expected}")
        if self.launches:
            parts.append("launches " + ", ".join(
                f"{k}×{v}" for k, v in sorted(self.launches.items())))
        return ", ".join(parts)


def _launch_counters() -> dict:
    from repro_torch.kernels.count_le.ops import count_le
    from repro_torch.kernels.flash_attention.ops import flash_attention
    from repro_torch.kernels.rmsnorm.ops import rmsnorm
    from repro_torch.kernels.sample_attr.ops import sample_attr_fold
    from repro_torch.kernels.sample_clock.ops import sample_clock
    from repro_torch.kernels.trace_sensor.ops import trace_sensor
    return {"sample_attr_fold": sample_attr_fold,
            "sample_clock": sample_clock, "count_le": count_le,
            "trace_sensor": trace_sensor,
            "flash_attention": flash_attention, "rmsnorm": rmsnorm}


def _audit_path(name: str, fn, *args, carry=None, **kwargs) -> PathReport:
    """Audit one call: ``fn(*args, **kwargs)``, or, with ``carry``, the
    step ``fn(carry, *args, **kwargs)`` and its in-place carry."""
    counters = _launch_counters()
    before = {k: f.launches for k, f in counters.items()}
    donated = (0, 0)
    if carry is None:
        stats = audit_ops(fn, *args, **kwargs)
    else:
        box = []
        stats = audit_ops(lambda: box.append(
            donation_in_place(fn, carry, *args, **kwargs)))
        donated = box[0]
    launches = {k: f.launches - before[k] for k, f in counters.items()
                if f.launches != before[k]}
    return PathReport.from_stats(name, stats, donated=donated,
                                 launches=launches)


# -- fixtures ---------------------------------------------------------------------------

_CHUNK = 256        # small audit chunk: the same ops, fast
_PERIOD, _JITTER = 10e-3, 200e-6


def _fixture_timelines(n: int, domains: bool):
    from repro_torch.core.timeline import RegionCost, synthesize
    costs = [RegionCost("mem", flops=1e10, hbm_bytes=5e10, invocations=4),
             RegionCost("alu", flops=6e11, hbm_bytes=2e9, invocations=4),
             RegionCost("opt", flops=2e10, hbm_bytes=4e10, invocations=1)]
    return [synthesize(costs, steps=8, seed=s, domains=domains)
            for s in range(n)]


def _pipeline_fixture(n: int, domains: bool, device):
    """(device timeline, RAPL spec, root key, phase, zero carry of
    ``rows`` rows, prev) as the pipelines set them up."""
    from repro_torch.core import device_pipeline as dp
    from repro_torch.core import threefry
    from repro_torch.core.sensors import RaplTraceSensor
    tls = _fixture_timelines(n, domains)
    spec = RaplTraceSensor.make_spec(domains=tls[0].domain_names)
    dtl = dp.DeviceTimeline.from_timelines(tls, device=device)
    root = threefry.PRNGKey(0)
    return dtl, spec, root, dp._phase(root, _PERIOD)



def _zero_carry(rows: int, n_chan: int, dev):
    from repro_torch.core import device_pipeline as dp
    return (*dp._zero_carry(rows, n_chan, dev),
            torch.zeros((), dtype=torch.int64, device=dev))


def _prev0(dev):
    return torch.full((), -1.0, dtype=torch.float64, device=dev)


def _region_audit(name: str, domains: bool, device) -> PathReport:
    """One steady chunk (k = 1, after chunk 0) of the region pipeline
    through ``_region_step``, the port's ``fori_loop`` body."""
    from repro_torch.convert import resolve_device
    from repro_torch.core import device_pipeline as dp
    from repro_torch.core.sensors import idle_channel
    from repro_torch.kernels.sample_attr.ops import make_carry_update
    dev = resolve_device(device)
    dtl, spec, root, u0 = _pipeline_fixture(1, domains, dev)
    update = make_carry_update(dtl.num_regions)
    carry = _zero_carry(dtl.num_regions, dp.num_channels(dtl.num_domains),
                        dev)
    rest = (dtl, spec, update, root, u0)
    tail = (_CHUNK, _PERIOD, _JITTER, 0.0, 55.0, idle_channel(spec.domains))
    carry, prev = dp._region_step(carry, _prev0(dev), *rest, 0, *tail)
    return _audit_path(name, dp._region_step, prev, *rest, 1, *tail,
                       carry=carry)


@_hot_path("device_pipeline/region_run/d1")
def _region_d1(device="cuda") -> PathReport:
    return _region_audit("device_pipeline/region_run/d1", False, device)


@_hot_path("device_pipeline/region_run/d3")
def _region_d3(device="cuda") -> PathReport:
    return _region_audit("device_pipeline/region_run/d3", True, device)


def _combo_audit(name: str, domains: bool, device) -> PathReport:
    """One steady chunk of the combination pipeline's hit path
    (``_combo_step``): W=2 workers against the minimum table, after a
    first chunk. Its carry is (counts, Σpow, Σpow², n), updated in place;
    the RAPL ``prev`` comes back as a new tensor on purpose — a miss
    replays the chunk from the ``prev`` it went in with."""
    from repro_torch.convert import resolve_device
    from repro_torch.core import device_pipeline as dp
    from repro_torch.core.streaming import CombinationInterner
    dev = resolve_device(device)
    dtl, spec, root, u0 = _pipeline_fixture(2, domains, dev)
    pack = dp._pack_spec(dtl.num_regions, dtl.num_workers)
    cap = dp._TABLE_MIN
    table = dp._build_table(CombinationInterner(), cap, pack, dev)
    carry = _zero_carry(cap, dp.num_channels(dtl.num_domains), dev)
    rest = (table, dtl, spec, root, u0)
    tail = (_CHUNK, _PERIOD, _JITTER)
    carry, prev, _ = dp._combo_step(carry, _prev0(dev), *rest, 0, *tail)
    return _audit_path(name, dp._combo_step, prev, *rest, 1, *tail,
                       carry=carry)


@_hot_path("device_pipeline/combo_step/d1")
def _combo_d1(device="cuda") -> PathReport:
    return _combo_audit("device_pipeline/combo_step/d1", False, device)


@_hot_path("device_pipeline/combo_step/d3")
def _combo_d3(device="cuda") -> PathReport:
    return _combo_audit("device_pipeline/combo_step/d3", True, device)


def _fold_audit(name: str, domains: bool, device) -> PathReport:
    """The miss path's fold (``_combo_fold``): the replayed chunk's
    channel powers folded at host-resolved interner ids (``cap`` for
    lanes out of the horizon) into the carry, in place."""
    from repro_torch.convert import resolve_device
    from repro_torch.core import device_pipeline as dp
    dev = resolve_device(device)
    n_chan = dp.num_channels(3 if domains else 1)
    cap = dp._TABLE_MIN
    carry = _zero_carry(cap, n_chan, dev)
    shape = (_CHUNK,) if n_chan == 1 else (n_chan, _CHUNK)
    idx = torch.full((_CHUNK,), cap, dtype=torch.int32, device=dev)
    pows = torch.zeros(shape, dtype=torch.float64, device=dev)
    valid = torch.zeros(_CHUNK, dtype=torch.bool, device=dev)
    return _audit_path(name, dp._combo_fold, idx, pows, valid, carry=carry)


@_hot_path("device_pipeline/combo_fold/d1")
def _fold_d1(device="cuda") -> PathReport:
    return _fold_audit("device_pipeline/combo_fold/d1", False, device)


@_hot_path("device_pipeline/combo_fold/d3")
def _fold_d3(device="cuda") -> PathReport:
    return _fold_audit("device_pipeline/combo_fold/d3", True, device)


# serve steps, one audit per cache family, through the engine's own step
# functions (reduced configs, random weights from a seed, a bf16 cache).
_CACHE_FAMILIES = {
    "dense": "qwen3-1.7b",
    "moe": "qwen3-moe-30b-a3b",
    "ssm": "xlstm-125m",
    "hybrid": "zamba2-1.2b",
}
_B, _T, _L, _WINDOW, _SINKS = 2, 16, 4, 8, 2


def _serve_audit(name: str, cfg_name: str, which: str, device
                 ) -> PathReport:
    """The masked decode step, the windowed draft (window 8, sinks 2) or
    the L=4 verify of ``cfg_name``'s reduced config at B=2 over a T=16
    bf16 cache. None of them carries a donated buffer (the engine keeps
    the window-start cache as the rollback checkpoint), so the rows pin
    in-place at 0/0, as the reference's."""
    from repro_torch.configs.registry import get_config
    from repro_torch.convert import resolve_device
    from repro_torch.models import model as M
    from repro_torch.serve.engine import _spec_step_fns, _step_fns
    dev = resolve_device(device)
    cfg = get_config(cfg_name).reduced()
    params = M.init_params(torch.Generator(dev).manual_seed(0), cfg,
                           device=dev)
    cache = M.init_cache(cfg, _B, _T, dtype=torch.bfloat16, device=dev)
    cur_len = torch.tensor([3, 5], dtype=torch.int32, device=dev)
    mask = torch.ones(_B, dtype=torch.bool, device=dev)
    width = _L if which == "verify" else 1
    tokens = torch.ones((_B, width), dtype=torch.int32, device=dev)
    if which == "decode":
        step, _ = _step_fns(cfg)
    else:
        draft, verify = _spec_step_fns(cfg, _WINDOW, _SINKS)
        step = draft if which == "draft" else verify
    return _audit_path(name, step, params, tokens, cache, cur_len, mask)


def _make_serve_path(which: str, family: str, cfg_name: str):
    name = f"serve/{which}/{family}"

    @_hot_path(name)
    def _build(device="cuda") -> PathReport:
        return _serve_audit(name, cfg_name, which, device)
    return _build


for _which in ("decode", "draft", "verify"):
    for _family, _cfg in _CACHE_FAMILIES.items():
        _make_serve_path(_which, _family, _cfg)


def _collective_audit(name: str, kind: str, device) -> PathReport:
    """The exchange's per-rank collective bodies on a one-rank process
    group of their own (gloo on the CPU, NCCL on the GPU), made for the
    audit and registered nowhere: no default group is set up or left
    behind."""
    import torch.distributed as dist

    from repro_torch.convert import resolve_device
    from repro_torch.core import exchange
    dev = resolve_device(device)
    store = dist.HashStore()
    group = (dist.ProcessGroupNCCL(store, 0, 1) if dev.type == "cuda"
             else dist.ProcessGroupGloo(store, 0, 1))
    cap, chan, width = 8, 3, 2

    def i64(*s):
        return torch.zeros(s, dtype=torch.int64, device=dev)

    def f64(*s):
        return torch.zeros(s, dtype=torch.float64, device=dev)
    try:
        if kind == "region":
            fn = exchange.region_allreduce_fn(group)
            args = (i64(1, cap), f64(1, cap, chan), f64(1, cap, chan))
        else:
            fn = exchange.combo_allgather_fn(group)
            args = (i64(1, cap, width), i64(1, cap), f64(1, cap, chan),
                    f64(1, cap, chan), i64(1, 1))
        report = _audit_path(name, fn, *args)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        return report
    finally:
        if hasattr(group, "shutdown"):
            group.shutdown()


@_hot_path("exchange/collective/region_allreduce")
def _collective_region(device="cuda") -> PathReport:
    return _collective_audit("exchange/collective/region_allreduce",
                             "region", device)


@_hot_path("exchange/collective/combo_allgather")
def _collective_combo(device="cuda") -> PathReport:
    return _collective_audit("exchange/collective/combo_allgather",
                             "combo", device)


def audit_hot_paths(names: Sequence[str] | None = None, *,
                    device="cuda") -> list[PathReport]:
    """Run + audit the registered hot paths (all by default) on
    ``device``."""
    if names is None:
        names = list(HOT_PATH_BUILDERS)
    unknown = [n for n in names if n not in HOT_PATH_BUILDERS]
    if unknown:
        raise KeyError(f"unknown hot paths: {unknown}; "
                       f"known: {sorted(HOT_PATH_BUILDERS)}")
    return [HOT_PATH_BUILDERS[n](device=device) for n in names]
