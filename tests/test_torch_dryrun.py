"""The port's dry run (``repro_torch.launch.dryrun``) against the
reference's.

The six cells of ``tests/test_dryrun_smoke.py`` run with reduced configs
on a (2, 2, 2) ("pod", "data", "model") mesh over a fake process group of
8 ranks, in a subprocess (a fake process group must not outlive the
test in this process): OK / SKIP as the reference's registry decides,
hubert's decode skipped with the reference's reason, and each row's keys
those of the reference's ``lower_cell`` row. One reduced dense cell
(yi-6b × train_4k) is compared with the reference's row, computed in a
subprocess with 8 host devices as the reference's own tests do: FLOPs
per device within 10%, and collective bytes above 0 in both (the model
axis is 2 wide). The subprocesses are ``scripts/dryrun_vs_reference.py``'s,
which prints the same rows side by side. The ``"fake"`` backend's
internal import path is pinned.
"""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

from repro.configs import registry as rreg
from repro_torch.configs import registry as preg
from repro_torch.configs.base import SHAPES

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "scripts"))
import dryrun_vs_reference as compare  # noqa: E402

CELLS = [("yi-6b", "train_4k"), ("qwen3-moe-30b-a3b", "decode_32k"),
         ("zamba2-1.2b", "long_500k"), ("hubert-xlarge", "prefill_32k"),
         ("xlstm-125m", "decode_32k"), ("hubert-xlarge", "decode_32k")]
DENSE = ("yi-6b", "train_4k")


@pytest.fixture(scope="module")
def rows():
    """(the port's rows of the six cells, the reference's dense row); the
    two subprocesses run side by side."""
    port = compare.start(compare.PORT, CELLS)
    ref = compare.start(compare.REF, [DENSE])
    return compare.rows(port), compare.rows(ref)[" ".join(DENSE)]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("arch,shape", CELLS)
def test_cells_run_or_skip_as_the_reference(rows, arch, shape):
    port_rows, ref_row = rows
    row = port_rows[f"{arch} {shape}"]
    rcfg = rreg.get_config(arch).reduced()
    ok, why = rreg.shape_applicable(rcfg, rreg.SHAPES[shape])
    if not ok:
        assert row == {"arch": arch, "shape": shape, "skipped": why}
        return
    assert "skipped" not in row
    assert set(row) == set(ref_row)
    assert row["chips"] == 8 and row["mesh"] == "2x2x2"
    assert row["flops_per_device"] > 0 and row["hbm_bytes_per_device"] > 0
    assert row["bytes_per_device"] > 0


@pytest.mark.timeout(600)
def test_encoder_decode_skips_with_the_reference_reason(rows):
    row = rows[0]["hubert-xlarge decode_32k"]
    assert row["skipped"] == "encoder-only arch has no decode step"
    assert preg.shape_applicable(preg.get_config("hubert-xlarge"),
                                 SHAPES["decode_32k"]) == (
        False, row["skipped"])


@pytest.mark.timeout(600)
def test_dense_cell_flops_and_collectives_against_the_reference(rows):
    port_rows, ref_row = rows
    row = port_rows[" ".join(DENSE)]
    ratio = row["flops_per_device"] / ref_row["flops_per_device"]
    assert 0.9 <= ratio <= 1.1, (row["flops_per_device"],
                                 ref_row["flops_per_device"])
    assert row["coll_bytes_per_device"] > 0
    assert ref_row["coll_bytes_per_device"] > 0
    assert row["warnings"] == ref_row["warnings"]


def test_fake_backend_import_is_pinned():
    """The dry run's fake process group comes from an internal torch
    module; this pins its path and class."""
    from torch.testing._internal.distributed.fake_pg import FakeStore
    import torch.distributed as dist
    assert issubclass(FakeStore, dist.Store)
    assert "fake" in dist.Backend.backend_list
