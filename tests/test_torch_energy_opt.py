"""Port parity: ``repro_torch.core.energy_opt`` against the JAX package's.

The module is a copy (only its two imports differ): the first test holds
the text to the reference's. The rest run ``evaluate``,
``baseline_plan`` and ``optimize_regions`` of both packages on the same
region costs, under the reference's ``TPU_V5E`` and under the port's
``H100_SXM`` (handed to the reference as its own ``HardwareSpec``), with
every objective, with and without ``max_slowdown`` and ``impl_space``,
and require equal plans field for field, float for float. Pure Python.
"""

import dataclasses
from pathlib import Path

import pytest

import repro.core as ref_core
import repro.core.energy_opt as ref_eo
import repro.core.power_model as ref_pm
import repro.core.timeline as ref_tl
import repro_torch.core as port_core
import repro_torch.core.energy_opt as port_eo
import repro_torch.core.power_model as port_pm
import repro_torch.core.timeline as port_tl
from repro.configs.registry import get_config as ref_config
from repro_torch.configs.registry import get_config as port_config
from repro_torch.core.hardware import H100_FP64_PER_S, H100_SXM
from repro.configs.base import SHAPES as REF_SHAPES
from repro.roofline.cost_model import step_region_costs as ref_costs
from repro_torch.configs.base import SHAPES as PORT_SHAPES
from repro_torch.roofline.cost_model import step_region_costs as port_costs

ROOT = Path(__file__).resolve().parents[1]
OBJECTIVES = ("time", "energy", "ed", "ed2")
HW = ("tpu-v5e", "h100")
# Costs of two families: yi-6b (attention: the flash variant applies) and
# zamba2-1.2b (hybrid: the fused-chunk scan variant applies).
CELLS = (("yi-6b", "train_4k", 8), ("zamba2-1.2b", "prefill_32k", 8))


def _models(hw):
    """(reference PowerModel, port PowerModel) on the same hardware."""
    if hw == "tpu-v5e":
        return ref_pm.PowerModel(), port_pm.PowerModel()
    ref_hw = ref_pm.HardwareSpec(**dataclasses.asdict(H100_SXM))
    return ref_pm.PowerModel(hw=ref_hw), port_pm.PowerModel(hw=H100_SXM)


def _costs(arch, shape, chips):
    return (ref_costs(ref_config(arch), REF_SHAPES[shape], chips=chips),
            port_costs(port_config(arch), PORT_SHAPES[shape], chips=chips))


def _impl_space(eo):
    return {"attn_score": [eo.ImplVariant("default"),
                           eo.ImplVariant("flash", flop_mult=0.55,
                                          byte_mult=0.1)],
            "ssm_scan": [eo.ImplVariant("default"),
                         eo.ImplVariant("fused_chunk", byte_mult=0.5)]}


def _plan(p):
    return (p.objective, [dataclasses.astuple(r) for r in p.plans],
            p.time, p.energy, [r.power for r in p.plans], p.table())


def test_energy_opt_is_the_references_copy():
    port = (ROOT / "src/repro_torch/core/energy_opt.py").read_text()
    ref = (ROOT / "src/repro/core/energy_opt.py").read_text()
    assert port.replace("repro_torch.", "repro.") == ref
    assert port.count("repro_torch.") == 2


def test_core_exports_the_references_energy_names():
    assert port_core.__all__ == ref_core.__all__
    assert port_eo.__all__ == ref_eo.__all__
    for name in ("ImplVariant", "KnobSpace", "ProgramPlan", "RegionPlan",
                 "baseline_plan", "optimize_regions"):
        assert getattr(port_core, name) is getattr(port_eo, name)


def test_knob_defaults_equal():
    assert (dataclasses.astuple(port_eo.KnobSpace())
            == dataclasses.astuple(ref_eo.KnobSpace()))
    assert (dataclasses.astuple(port_eo.ImplVariant("x"))
            == dataclasses.astuple(ref_eo.ImplVariant("x")))


def test_h100_spec_is_the_data_sheets():
    """The card's dense bf16 rate, HBM3 bandwidth and float64 rate that
    chip_smoke's kernel bounds (PERF.md §6) have always used."""
    assert H100_SXM.peak_flops_bf16 == 989e12
    assert H100_SXM.hbm_bandwidth == 3.35e12
    assert H100_FP64_PER_S == 34e12
    assert H100_SXM.ici_bandwidth_per_link * H100_SXM.ici_links == 450e9
    assert isinstance(H100_SXM, port_pm.HardwareSpec)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_evaluate_equal(hw, cell):
    rm, pm = _models(hw)
    rc, pc = _costs(*cell)
    space = port_eo.KnobSpace()
    for r, p in zip(rc, pc):
        for impl in ("default", "flash"):
            kw = dict(flop_mult=0.55, byte_mult=0.1) if impl == "flash" else {}
            for fs in space.freq_scales:
                for ch in space.chip_counts:
                    want = ref_eo.evaluate(
                        r, freq_scale=fs, chips=ch,
                        impl=ref_eo.ImplVariant(impl, **kw), model=rm)
                    got = port_eo.evaluate(
                        p, freq_scale=fs, chips=ch,
                        impl=port_eo.ImplVariant(impl, **kw), model=pm)
                    assert got == want, (r.name, impl, fs, ch)


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("cell", CELLS, ids=[c[0] for c in CELLS])
def test_baseline_plan_equal(hw, cell):
    rm, pm = _models(hw)
    rc, pc = _costs(*cell)
    chips = cell[2]
    assert (_plan(port_eo.baseline_plan(pc, chips=chips, model=pm))
            == _plan(ref_eo.baseline_plan(rc, chips=chips, model=rm)))
    flash = dict(flop_mult=0.55, byte_mult=0.1)
    assert (_plan(port_eo.baseline_plan(
        pc, chips=chips, model=pm, impl=port_eo.ImplVariant("f", **flash)))
        == _plan(ref_eo.baseline_plan(
            rc, chips=chips, model=rm, impl=ref_eo.ImplVariant("f", **flash))))


@pytest.mark.parametrize("hw", HW)
@pytest.mark.parametrize("objective", OBJECTIVES)
@pytest.mark.parametrize("max_slowdown", (None, 2.0))
@pytest.mark.parametrize("with_impls", (False, True))
def test_optimize_regions_equal(hw, objective, max_slowdown, with_impls):
    rm, pm = _models(hw)
    for cell in CELLS:
        rc, pc = _costs(*cell)
        chips = cell[2]
        kw = dict(objective=objective, baseline_chips=chips,
                  max_slowdown=max_slowdown)
        want = ref_eo.optimize_regions(
            rc, ref_eo.KnobSpace(chip_counts=(1, 2, 4, chips)), model=rm,
            impl_space=_impl_space(ref_eo) if with_impls else None, **kw)
        got = port_eo.optimize_regions(
            pc, port_eo.KnobSpace(chip_counts=(1, 2, 4, chips)), model=pm,
            impl_space=_impl_space(port_eo) if with_impls else None, **kw)
        assert _plan(got) == _plan(want), cell
        assert len(got.plans) == len(pc)


def test_optimize_regions_default_model_is_the_references():
    """No ``model``: both packages fall back to their TPU_V5E model."""
    rc = [ref_tl.RegionCost("a", 3e12, 4e10, invocations=3),
          ref_tl.RegionCost("b", 1e10, 9e10, ici_bytes=1e8)]
    pc = [port_tl.RegionCost("a", 3e12, 4e10, invocations=3),
          port_tl.RegionCost("b", 1e10, 9e10, ici_bytes=1e8)]
    assert (_plan(port_eo.optimize_regions(pc, port_eo.KnobSpace()))
            == _plan(ref_eo.optimize_regions(rc, ref_eo.KnobSpace())))


def test_h100_prices_the_plan_differently():
    """The spec reaches the plan: at the card's peaks a region takes less
    time than at the v5e's, and the energy-optimal plan never costs more
    energy than the max-performance baseline."""
    _, pc = _costs("yi-6b", "train_4k", 8)
    _, v5e = _models("tpu-v5e")
    _, h100 = _models("h100")
    t_v5e = port_eo.baseline_plan(pc, chips=8, model=v5e).time
    t_h100 = port_eo.baseline_plan(pc, chips=8, model=h100).time
    assert t_h100 < t_v5e
    base = port_eo.baseline_plan(pc, chips=8, model=h100)
    plan = port_eo.optimize_regions(
        pc, port_eo.KnobSpace(chip_counts=(1, 2, 4, 8)), model=h100,
        baseline_chips=8, max_slowdown=2.0)
    assert plan.energy <= base.energy
