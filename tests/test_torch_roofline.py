"""Port parity: ``repro_torch.roofline`` against the JAX package's.

``cost_model``, ``analysis`` and ``aggregate`` are copies (only their
imports differ): the first tests hold the text to the reference's. Then
``step_region_costs`` gives equal ``RegionCost``s for every applicable
(arch × shape) of ``configs.registry`` at 8 and 256 chips;
``parse_collective_bytes``, ``roofline_terms`` (under ``TPU_V5E`` and
``H100_SXM``) and ``model_flops`` are equal on the HLO fixture of
``tests/test_distribution.py``; ``aggregate`` prints equal tables. The
last test holds chip_smoke's kernel bounds, which now read ``H100_SXM``,
to the values PERF.md §6 reports. Pure Python.
"""

import dataclasses
import importlib
import importlib.util
import json
import sys
from pathlib import Path

import pytest

import repro.core.power_model as ref_pm
from repro.configs.base import SHAPES as REF_SHAPES
from repro.configs.registry import get_config as ref_config
from repro.configs.registry import shape_applicable
from repro.roofline import aggregate as ref_agg
from repro.roofline import analysis as ref_an
from repro.roofline import cost_model as ref_cm
from repro_torch.configs.base import SHAPES as PORT_SHAPES
from repro_torch.configs.registry import ARCH_IDS, all_cells
from repro_torch.configs.registry import get_config as port_config
from repro_torch.core.hardware import H100_SXM
from repro_torch.roofline import aggregate as port_agg
from repro_torch.roofline import analysis as port_an
from repro_torch.roofline import cost_model as port_cm

ROOT = Path(__file__).resolve().parents[1]
MODULES = ("cost_model", "analysis", "aggregate")
CELLS = [(a, s) for a in ARCH_IDS for s in REF_SHAPES
         if shape_applicable(ref_config(a), REF_SHAPES[s])[0]]

# The fixture of tests/test_distribution.py (re-declared: the port's tests
# import no reference test module).
_FAKE_HLO = """
HloModule test
ENTRY main {
  %p0 = f32[16,128]{1,0} parameter(0)
  %ag = f32[16,2048]{1,0} all-gather(%p0), dim=1
  %ar = bf16[1024]{0} all-reduce(%x), to_apply=%sum
  %ar2.start = bf16[1024]{0} all-reduce-start(%x)
  %rs = f32[8,64]{1,0} reduce-scatter(%y), dimensions={0}
  %a2a = (f32[4,32]{1,0}, f32[4,32]{1,0}) all-to-all(%a, %b)
  %cp = u32[256]{0} collective-permute(%c), source_target_pairs={{0,1}}
  %add = f32[16,2048]{1,0} add(%ag, %ag)
}
"""


@pytest.mark.parametrize("name", MODULES)
def test_module_is_the_references_copy(name):
    port = (ROOT / f"src/repro_torch/roofline/{name}.py").read_text()
    ref = (ROOT / f"src/repro/roofline/{name}.py").read_text()
    assert port.replace("repro_torch.", "repro.") == ref
    assert port.count("repro_torch.") == {"cost_model": 2, "analysis": 1,
                                          "aggregate": 1}[name]


@pytest.mark.parametrize("name", MODULES)
def test_public_names_equal(name):
    port = importlib.import_module(f"repro_torch.roofline.{name}")
    ref = importlib.import_module(f"repro.roofline.{name}")
    assert getattr(port, "__all__", None) == getattr(ref, "__all__", None)
    assert ({n for n in vars(port) if not n.startswith("_")}
            == {n for n in vars(ref) if not n.startswith("_")})


def test_cells_cover_the_registry():
    """40 assigned cells less 8 long_500k on full attention and hubert's
    decode_32k; the port's registry runs the same ones."""
    assert len(CELLS) == 31
    assert {a for a, _ in CELLS} == set(ARCH_IDS)
    assert [(a, s.name) for a, s, ok, _ in all_cells() if ok] == CELLS


@pytest.mark.parametrize("chips", (8, 256))
@pytest.mark.parametrize("arch,shape", CELLS,
                         ids=[f"{a}-{s}" for a, s in CELLS])
def test_step_region_costs_equal(arch, shape, chips):
    want = ref_cm.step_region_costs(ref_config(arch), REF_SHAPES[shape],
                                    chips=chips)
    got = port_cm.step_region_costs(port_config(arch), PORT_SHAPES[shape],
                                    chips=chips)
    assert [dataclasses.astuple(c) for c in got] == [
        dataclasses.astuple(c) for c in want]
    assert got and all(c.invocations >= 1 for c in got)


def test_parse_collective_bytes_equal():
    got = port_an.parse_collective_bytes(_FAKE_HLO)
    want = ref_an.parse_collective_bytes(_FAKE_HLO)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.total_bytes == want.total_bytes
    assert got.bytes_by_kind["all-gather"] == 16 * 2048 * 4
    assert got.count_by_kind["all-reduce"] == 2


@pytest.mark.parametrize("hw", ("tpu-v5e", "h100"))
@pytest.mark.parametrize("training", (True, False))
def test_roofline_terms_equal(hw, training):
    kw = dict(arch="a", shape="s", mesh_name="16x16", chips=256,
              cost_analysis={"flops": 197e12 * 1e-3,
                             "bytes accessed": 819e9 * 2e-3},
              hlo_text=_FAKE_HLO, n_params_active=int(1e9), n_tokens=1000,
              training=training, bytes_per_device=12345)
    if hw == "tpu-v5e":
        got = port_an.roofline_terms(**kw)
        want = ref_an.roofline_terms(**kw)
    else:
        got = port_an.roofline_terms(**kw, hw=H100_SXM)
        want = ref_an.roofline_terms(
            **kw, hw=ref_pm.HardwareSpec(**dataclasses.asdict(H100_SXM)))
        assert got.t_compute == pytest.approx(197e9 / 989e12)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.row() == want.row()
    assert (got.dominant, got.bound_time, got.roofline_fraction,
            got.useful_flops_ratio) == (want.dominant, want.bound_time,
                                        want.roofline_fraction,
                                        want.useful_flops_ratio)


@pytest.mark.parametrize("n,tokens", ((100, 10), (int(1.7e9), 4 * 2048)))
def test_model_flops_equal(n, tokens):
    for training in (True, False):
        assert (port_an.model_flops(n, tokens, training=training)
                == ref_an.model_flops(n, tokens, training=training))


_ROWS = [
    {"arch": "qwen3-1.7b", "shape": "train_4k", "t_compute_s": 1.5e-3,
     "t_memory_s": 2.25e-3, "t_collective_s": 0.5e-3, "dominant": "memory",
     "roofline_fraction": 0.6667, "model_flops_ratio": 0.91,
     "mem_analysis": "argument_size_in_bytes=1073741824 "
                     "temp_size_in_bytes=536870912"},
    {"arch": "yi-6b", "shape": "decode_32k", "t_compute_s": 4e-3,
     "t_memory_s": 1e-3, "t_collective_s": 9e-3,
     "dominant": "collective", "roofline_fraction": 0.444,
     "model_flops_ratio": 1.02},
    {"arch": "hubert-xlarge", "shape": "decode_32k",
     "skipped": "encoder-only arch has no decode step"},
    {"arch": "zamba2-1.2b", "shape": "long_500k",
     "error": "RESOURCE_EXHAUSTED: while allocating 123456789 bytes"},
]


def _write_rows(d):
    (d / "a__single.json").write_text(json.dumps(_ROWS[:3]))
    (d / "b__multi.json").write_text(json.dumps(_ROWS[1]))
    (d / "c__single.json").write_text(json.dumps(_ROWS[3]))
    (d / "VARIANT_x.json").write_text(json.dumps(_ROWS[0]))
    (d / "notes.txt").write_text("not a row")


def test_aggregate_table_equal(tmp_path):
    _write_rows(tmp_path)
    got = port_agg.load_rows(str(tmp_path))
    want = ref_agg.load_rows(str(tmp_path))
    assert got == want and len(got) == 5
    for kind in ("single", "multi"):
        assert port_agg.table(got, kind) == ref_agg.table(want, kind)
    assert "1.50" in port_agg.table(got, "single")     # GiB of the first
    assert port_agg.fmt_bytes(None) == ref_agg.fmt_bytes(None) == "-"


def test_aggregate_main_equal(tmp_path, monkeypatch, capsys):
    _write_rows(tmp_path)
    out = []
    for mod in (port_agg, ref_agg):
        monkeypatch.setattr(sys, "argv", ["aggregate", str(tmp_path)])
        mod.main()
        out.append(capsys.readouterr().out)
    assert out[0] == out[1]
    assert "cells: 3 compiled, 1 skipped, 1 failed" in out[0]


def _chip_smoke():
    path = ROOT / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_bounds_are_unchanged():
    """chip_smoke prices its kernels' bounds at ``H100_SXM``: the bound
    columns of PERF.md §6 (flash at B=4 H=16 KV=8 S=2048 dh=128 bf16
    causal, rmsnorm at [8192, 2048] bf16, sample_attr's region chunk)
    stay what they were with the literals it had before."""
    cs = _chip_smoke()
    ms, by = cs.flash_bound_ms(4, 16, 8, 2048, 2048, 128, True, 2)
    assert (round(ms, 5), by) == (0.06952, "operations")
    ms, by = cs.rmsnorm_bound_ms(8192, 2048, 2)
    assert (round(ms, 5), by) == (0.02003, "bytes")
    ms, by = cs.sample_attr_bound_ms(65536, 42, 4)
    assert by == "bytes"
    assert ms == pytest.approx(
        (65536 * (4 + 8 * 4 + 1) + 2 * 42 * 9 * 8) / 3.35e12 * 1e3)
    assert round(ms, 5) == 0.00073
