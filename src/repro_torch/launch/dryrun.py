"""Multi-pod dry run: run every (arch × shape) cell's step abstractly on
the production meshes, meter it, and emit roofline rows.

Port of ``src/repro/launch/dryrun.py``:

    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch yi-6b --shape train_4k
    PYTHONPATH=src python -m repro_torch.launch.dryrun --all --multi-pod --json out.json

Where the reference lowers and compiles each cell with XLA over 512 host
devices, the port runs the step once, eagerly, in one process: the
parameters, optimizer state, cache and batch are ``device="meta"``
tensors (shapes, no data) made DTensors by the cell's specs over a fake
process group of 256 / 512 ranks (``torch.testing``'s ``"fake"``
backend: collectives return at once and move nothing). Every DTensor
redistribution then issues its collectives as functional collectives on
this rank's local shards, and every op runs on them, so one meter
(:class:`Meter`, a ``TorchDispatchMode`` that sees the local ops
DTensor runs) reads per-device numbers:

- ``flops``: the FLOP formulas of ``torch.utils.flop_counter``
  (``FlopCounterMode``'s registry) on each local op;
- ``bytes accessed``: operand + result bytes summed per aten op (no
  fusion, so it is an upper estimate of HBM traffic; the row says so);
- collectives: output bytes and counts per kind of c10d functional
  collective, mapped to the reference's five kinds;
- memory: the local argument bytes plus the peak of the live
  intermediates the meter saw allocated.

The layer and chunk loops are Python, so one run counts every layer (the
reference needs a second, unrolled compile for that): ``unroll`` keeps
only its effect on the chunk sizes. Nothing reads a value, as XLA's
tracing reads none: ``.item()``, ``nonzero`` and ``unique`` fail on
meta. The rows are priced at the reference's default spec (``TPU_V5E``)
so that they compare with its rows; ``lower_cell(hw=H100_SXM)`` prices a
row for the card.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import math
import sys
import traceback
import weakref

import torch
import torch.distributed as dist
from torch.overrides import TorchFunctionMode
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig
from repro_torch.configs.registry import ARCH_IDS, get_config, shape_applicable
from repro_torch.launch.mesh import dp_axes_for, make_production_mesh
from repro_torch.models import model as M
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.roofline.analysis import roofline_terms
from repro_torch.sharding import params as sp
from repro_torch.sharding.rules import axis_rules, make_rules, mesh_shape
from repro_torch.train.step import init_state, make_train_step
from repro_torch.tree import tree_leaves

__all__ = ["Meter", "N_PATCH", "build_rules", "fake_world", "input_specs",
           "lower_cell", "main"]

N_PATCH = 256   # vlm stub frontend patch count


def input_specs(cfg: ModelConfig, shape: ShapeConfig) -> dict:
    """Meta-tensor stand-ins for every model input (no allocation)."""
    B, S = shape.global_batch, shape.seq_len
    i32 = torch.int32

    def t(shp, dt):
        return torch.empty(shp, dtype=dt, device="meta")
    if shape.kind in ("train", "prefill"):
        if cfg.embed_inputs:           # audio: precomputed frame embeddings
            specs = {"embeds": t((B, S, cfg.d_model), torch.bfloat16)}
            if shape.kind == "train":
                specs["labels"] = t((B, S), i32)
            return specs
        if cfg.family == "vlm":
            specs = {
                "patch_embeds": t((B, N_PATCH, cfg.d_model), torch.bfloat16),
                "tokens": t((B, S - N_PATCH), i32),
            }
            if shape.kind == "train":
                specs["labels"] = t((B, S - N_PATCH), i32)
            return specs
        specs = {"tokens": t((B, S), i32)}
        if shape.kind == "train":
            specs["labels"] = t((B, S), i32)
        return specs
    # decode: one new token against a seq_len cache
    return {"tokens": t((B, 1), i32)}


def build_rules(cfg: ModelConfig, shape: ShapeConfig, mesh):
    dp = dp_axes_for(mesh)
    rules = make_rules(mesh, dp_axes=dp)
    rules = rules.resolve_divisibility({
        "batch": shape.global_batch,
        "heads": cfg.n_heads,
        "kv_heads": cfg.n_kv_heads,
        "vocab": cfg.vocab_size,
    })
    model = mesh_shape(mesh)["model"]
    if (shape.is_decode and rules.mapping.get("kv_heads") is None
            and shape.seq_len % model == 0):
        # GQA groups can't fill the TP axis → shard the cache sequence
        # instead (flash-decoding split-K combine).
        rules.mapping["kv_seq"] = "model"
    if (shape.kind in ("train", "prefill")
            and cfg.n_heads % model != 0
            and shape.seq_len % model == 0):
        # Heads indivisible by the TP width → attention would replicate
        # and its fp32 scores blow the memory budget (internvl2: 14 heads
        # on TP-16). Shard attention activations over the *sequence*
        # instead (context-parallel scores).
        rules.mapping["seq"] = "model"
    if (shape.kind in ("train", "prefill")
            and not cfg.disable_sp
            and shape.seq_len % model == 0):
        # Megatron sequence parallelism: the residual stream between blocks
        # is sharded over the TP axis (all-gather at qkv/up-proj, reduce-
        # scatter after wo/down-proj) — 16x less activation memory.
        rules.mapping["seq_act"] = "model"
    return rules


# -- the meter -------------------------------------------------------------------

_COLLECTIVE_KINDS = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_gather_into_tensor_out": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "broadcast": "collective-permute",
}

_HLO_DTYPES = {torch.float32: "f32", torch.bfloat16: "bf16",
               torch.float16: "f16", torch.float64: "f64",
               torch.int32: "s32", torch.int64: "s64", torch.int16: "s16",
               torch.int8: "s8", torch.uint8: "u8", torch.bool: "pred"}

# ops that move no data (aliases, views, metadata)
_NO_BYTES = {"detach", "alias", "lift_fresh", "_to_copy_meta",
             "empty", "empty_strided", "empty_like", "sym_size",
             "sym_stride", "sym_numel", "sym_storage_offset", "wait_tensor",
             "_wrap_tensor_autograd"}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _tensors(tree) -> list:
    out = []

    def walk(x):
        if isinstance(x, torch.Tensor):
            out.append(x)
        elif isinstance(x, (list, tuple)):
            for y in x:
                walk(y)
        elif isinstance(x, dict):
            for y in x.values():
                walk(y)
    walk(tree)
    return out


class Meter(TorchDispatchMode):
    """Per-device meter of the local ops a DTensor program runs (see the
    module docstring). DTensor-level calls pass through to DTensor
    (``NotImplemented``), whose local ops come back here; the fake
    tensors of DTensor's shape propagation are not counted."""

    def __init__(self):
        super().__init__()
        from torch.utils.flop_counter import flop_registry
        self._flops = flop_registry
        self.flops = 0
        self.bytes = 0
        self.coll_bytes: dict[str, int] = {}
        self.coll_counts: dict[str, int] = {}
        self.coll_lines: list[str] = []
        self.live = 0
        self.peak = 0

    def _free(self, n):
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._subclasses.fake_tensor import FakeTensor
        from torch.distributed.tensor import DTensor

        kwargs = kwargs or {}
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if any(issubclass(t, FakeTensor) for t in types):
            return out
        name = func._schema.name.split("::")[-1]
        ns = func.namespace
        outs = _tensors(out)
        if ns == "_c10d_functional" and name in _COLLECTIVE_KINDS:
            kind = _COLLECTIVE_KINDS[name]
            nb = sum(_nbytes(t) for t in outs)
            self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + nb
            self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1
            for t in outs:
                dt = _HLO_DTYPES.get(t.dtype, "u8")
                n = t.numel() * (t.element_size() if dt == "u8" else 1)
                self.coll_lines.append(
                    f"%c{len(self.coll_lines)} = {dt}[{n}]{{0}} {kind}()")
            return out
        packet = func._overloadpacket
        if packet in self._flops:
            self.flops += int(self._flops[packet](*args, **kwargs,
                                                  out_val=out))
        if name in _NO_BYTES or func.is_view:
            return out
        self.bytes += sum(_nbytes(t) for t in _tensors(args) + outs)
        for t in outs:
            nb = _nbytes(t)
            self.live += nb
            self.peak = max(self.peak, self.live)
            weakref.finalize(t, self._free, nb)
        return out

    def hlo_text(self) -> str:
        """The collectives as HLO-style lines (output shape, kind), which
        ``roofline_terms`` parses."""
        return "\n".join(self.coll_lines)


class _MetaInit(TorchFunctionMode):
    """Factory calls go to ``meta`` and draw from no generator: the
    model's initializers then make shapes only."""

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        kwargs.pop("generator", None)
        if "device" in kwargs:
            kwargs["device"] = "meta"
        return func(*args, **kwargs)


def _meta_params(cfg: ModelConfig):
    with _MetaInit():
        return M.init_params(torch.Generator(), cfg, device="cpu")


def _meta_state(cfg: ModelConfig, opt_cfg: AdamWConfig):
    with _MetaInit():
        return init_state(torch.Generator(), cfg, opt_cfg, device="cpu")


def fake_world(n: int) -> None:
    """A fake process group of ``n`` ranks in this process (this process
    is rank 0); one of another size is replaced."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        if dist.get_world_size() == n and dist.get_backend() == "fake":
            return
        dist.destroy_process_group()
    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=n)


def _run_cell(cfg: ModelConfig, shape: ShapeConfig, rules, attn_impl: str,
              *, unroll: bool, fsdp: bool):
    """Build the cell's abstract arguments, distribute them, run its step
    under a :class:`Meter`; returns (meter, local argument bytes)."""
    batch = input_specs(cfg, shape)
    S = shape.seq_len
    # Chunk sizes: as large as the reference's cost compile takes them
    # under ``unroll``, its production sizes otherwise.
    q_chunk = min(S, 8192) if unroll else 1024
    ssd_chunk = min(S, 2048) if unroll else 128
    ce_chunk = S if unroll else 512
    batch = sp.distribute(batch, sp.batch_specs(batch, rules), rules)
    meter = Meter()

    if shape.kind == "train":
        opt_cfg = AdamWConfig()
        state = _meta_state(cfg, opt_cfg)
        state = sp.distribute(state, sp.param_specs(state, rules, fsdp=fsdp),
                              rules)
        step = make_train_step(cfg, opt_cfg, attn_impl=attn_impl,
                               unroll=unroll, q_chunk=q_chunk,
                               ce_chunk=ce_chunk, ssd_chunk=ssd_chunk)
        args = (state, batch)
        with meter:
            step(state, batch)
    else:
        params = _meta_params(cfg)
        params = sp.distribute(params, sp.param_specs(params, rules), rules)
        if shape.kind == "prefill":
            args = (params, batch)
            with meter, torch.no_grad():
                if cfg.is_encoder:
                    M.forward(params, cfg, batch, attn_impl=attn_impl,
                              q_chunk=q_chunk, ssd_chunk=ssd_chunk)
                else:
                    M.prefill(params, cfg, batch, shape.seq_len,
                              attn_impl=attn_impl, q_chunk=q_chunk,
                              ssd_chunk=ssd_chunk)
        else:
            cache = M.init_cache(cfg, shape.global_batch, shape.seq_len,
                                 dtype=getattr(torch, cfg.kv_cache_dtype),
                                 device="meta")
            cache = sp.distribute(cache, sp.cache_specs(cache, rules), rules)
            args = (params, batch, cache)
            with meter, torch.no_grad():
                M.decode_step(params, cfg, batch["tokens"], cache,
                              shape.seq_len - 1)
    local = sum(_nbytes(t.to_local() if hasattr(t, "to_local") else t)
                for t in tree_leaves(args) if isinstance(t, torch.Tensor))
    return meter, local


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool,
               attn_impl: str = "chunked", donate: bool = True,
               mesh=None, cfg_override=None, unroll: bool = True,
               fsdp: bool = True, hw=None):
    """Run and meter one cell. Returns (row, meter); (row with
    ``skipped``, None) for a cell the arch does not run. ``donate`` is
    the reference's buffer-donation knob: the port's step updates its
    state and cache in place, so it changes nothing. ``hw`` prices the
    row (the reference's default spec when None)."""
    del donate
    cfg = cfg_override or get_config(arch)
    shape = SHAPES[shape_name]
    ok, why = shape_applicable(cfg, shape)
    if not ok:
        return {"arch": arch, "shape": shape_name, "skipped": why}, None

    if mesh is None:
        fake_world(512 if multi_pod else 256)
        mesh = make_production_mesh(multi_pod=multi_pod, device="meta")
    dims = tuple(int(n) for n in mesh.mesh.shape)
    mesh_name = "x".join(str(s) for s in dims)
    chips = math.prod(dims)
    rules = build_rules(cfg, shape, mesh)
    training = shape.kind == "train"

    with axis_rules(rules):
        meter, local_bytes = _run_cell(cfg, shape, rules, attn_impl,
                                       unroll=unroll, fsdp=fsdp)

    cost = {"flops": float(meter.flops), "bytes accessed": float(meter.bytes)}
    n_tokens = shape.global_batch * (shape.seq_len if not shape.is_decode
                                     else 1)
    bytes_per_device = local_bytes + meter.peak
    kw = {} if hw is None else {"hw": hw}
    report = roofline_terms(
        arch=arch, shape=shape_name, mesh_name=mesh_name, chips=chips,
        cost_analysis=cost, hlo_text=meter.hlo_text(),
        n_params_active=cfg.active_param_count(), n_tokens=n_tokens,
        training=training, bytes_per_device=int(bytes_per_device), **kw)
    row = report.row()
    row["flops_per_device"] = cost["flops"]
    row["hbm_bytes_per_device"] = cost["bytes accessed"]
    row["coll_bytes_per_device"] = int(report.collective_bytes)
    row["mem_analysis"] = (
        f"bytes_per_device {bytes_per_device} = arguments {local_bytes} "
        f"(this rank's shards of params/state, batch, cache) + peak live "
        f"intermediates {meter.peak} (eager, as the meter saw them "
        f"allocated); hbm bytes are operand + result bytes per aten op, "
        f"unfused: an upper estimate")
    row["warnings"] = rules.warnings
    row["collectives"] = report.collectives
    row["collective_counts"] = report.collective_counts
    return row, meter


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCH_IDS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--attn-impl", default="chunked")
    ap.add_argument("--no-unroll", action="store_true",
                    help="production chunk sizes (the reference: keep "
                         "lax.scan over layers)")
    ap.add_argument("--no-fsdp", action="store_true")
    ap.add_argument("--json", default=None, help="write row(s) as JSON")
    args = ap.parse_args(argv)

    cells = ([(args.arch, args.shape)] if not args.all else
             [(a, s) for a in ARCH_IDS for s in SHAPES])
    rows = []
    failures = 0
    for arch, shape in cells:
        try:
            row, _ = lower_cell(arch, shape, multi_pod=args.multi_pod,
                                attn_impl=args.attn_impl,
                                unroll=not args.no_unroll,
                                fsdp=not args.no_fsdp)
            rows.append(row)
            if "skipped" in row:
                print(f"[SKIP] {arch} × {shape}: {row['skipped']}")
            else:
                print(f"[OK]   {arch} × {shape} mesh={row['mesh']} "
                      f"dominant={row['dominant']} "
                      f"frac={row['roofline_fraction']:.3f}")
                print(f"       compute {row['t_compute_s']*1e3:.2f}ms "
                      f"memory {row['t_memory_s']*1e3:.2f}ms "
                      f"collective {row['t_collective_s']*1e3:.2f}ms")
                print("       " + row["mem_analysis"])
        except Exception as e:
            failures += 1
            rows.append({"arch": arch, "shape": shape,
                         "error": f"{type(e).__name__}: {e}"})
            print(f"[FAIL] {arch} × {shape}: {type(e).__name__}: {e}")
            traceback.print_exc()
    if args.json:
        with open(args.json, "w") as f:
            json.dump(rows, f, indent=1, default=str)
    sys.exit(1 if failures else 0)


if __name__ == "__main__":
    main()
