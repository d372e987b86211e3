"""§7 use case through the PyTorch port's public API: profile → find
hotspots → search per-region knobs (DVFS × chips × impl) → report the
plan.

The port of ``examples/energy_tuning.py``. ``--hw`` picks the hardware the
activity power model prices the timeline and the plans at: ``h100`` (the
NVIDIA H100 SXM, ``repro_torch.core.hardware.H100_SXM``, the default) or
``tpu-v5e`` (the reference's spec; the output is then the reference
example's, line for line). The profile is the reference's one-shot host
sample; ``--device`` is where the profiler lives (the GPU by default).

The joules are the activity model's (``PowerModelParams``' modelled
coefficients), not a measurement on any card.

    PYTHONPATH=src python examples/torch/energy_tuning.py --arch yi-6b
"""

import argparse
import sys

from repro_torch.configs.base import SHAPES
from repro_torch.configs.registry import ARCH_IDS, get_config
from repro_torch.convert import resolve_device
from repro_torch.core import (TPU_V5E, EnergyProfiler, ImplVariant,
                              KnobSpace, PowerModel, baseline_plan,
                              optimize_regions, synthesize)
from repro_torch.core.hardware import H100_SXM
from repro_torch.roofline.cost_model import step_region_costs

HARDWARE = {"h100": H100_SXM, "tpu-v5e": TPU_V5E}
IMPL_SPACE = {
    "attn_score": [ImplVariant("default"),
                   ImplVariant("flash", flop_mult=0.55, byte_mult=0.1)],
    "ssm_scan": [ImplVariant("default"),
                 ImplVariant("fused_chunk", byte_mult=0.5)],
}
MODEL_NOTE = ("E [J] and the saving are the activity power model's "
              "(modelled coefficients, PowerModelParams), not measured")


def plan_hotspots(costs, est, *, chips, objective, model):
    """The knob search over ``est``'s six dominant regions: returns the
    max-performance baseline and the ``objective``-optimal plan."""
    top = {r.name for r in est.dominant(6)}
    top_costs = [c for c in costs if c.name in top]
    space = KnobSpace(freq_scales=(1.0, 0.94, 0.88, 0.81),
                      chip_counts=(1, 2, 4, chips))
    base = baseline_plan(top_costs, chips=chips, model=model)
    plan = optimize_regions(top_costs, space, objective=objective,
                            model=model, impl_space=IMPL_SPACE,
                            baseline_chips=chips, max_slowdown=2.0)
    return base, plan


def main(argv=None):
    """Profile, tune and print; returns ``(estimates, baseline, plan)``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="yi-6b", choices=ARCH_IDS)
    ap.add_argument("--shape", default="train_4k", choices=list(SHAPES))
    ap.add_argument("--chips", type=int, default=8)
    ap.add_argument("--objective", default="energy",
                    choices=["energy", "ed", "ed2"])
    ap.add_argument("--hw", default="h100", choices=list(HARDWARE))
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    costs = step_region_costs(cfg, SHAPES[args.shape], chips=args.chips)
    model = PowerModel(hw=HARDWARE[args.hw])

    # 1. One-pass ALEA profile of the synthesized device timeline.
    tl = synthesize(costs, steps=150, chips=args.chips, model=model, seed=0)
    prof = EnergyProfiler(period=10e-3, device=dev)
    est = prof.profile_timeline(tl, sensor="rapl")
    print(prof.report(est).table(top=8))

    # 2. Knob search over the dominant regions.
    base, plan = plan_hotspots(costs, est, chips=args.chips,
                               objective=args.objective, model=model)
    print("\nbaseline (max perf):")
    print(base.table())
    print(f"\n{args.objective}-optimal per-region plan:")
    print(plan.table())
    print(f"\nwhole-hotspot energy saving: "
          f"{(1 - plan.energy / base.energy) * 100:.0f}%  "
          f"time: {(plan.time / base.time - 1) * 100:+.0f}%")
    # stderr, so that standard output stays the reference's line for line.
    print(f"({MODEL_NOTE}; hardware {model.hw.name})", file=sys.stderr)
    return est, base, plan


if __name__ == "__main__":
    main()
