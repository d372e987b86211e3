"""GPipe pipeline: the port's ``pipeline_forward`` against the
sequential layers on a 4-stage ``pipe`` axis of four gloo CPU ranks (the
inputs of ``tests/test_pipeline.py``, weights drawn by numpy; bodies in
``tests/_torch_sharding_ranks.py``), at a world of one in process, and
the schedule math against the reference's."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

import _torch_sharding_ranks as ranks
from repro.sharding import pipeline as RP
from repro_torch.launch.mesh import make_mesh
from repro_torch.sharding import pipeline as PP


@pytest.mark.parametrize("stages,micro,want", [(4, 4, 3 / 7), (1, 8, 0.0),
                                               (4, 28, 3 / 31)])
def test_bubble_fraction(stages, micro, want):
    assert PP.bubble_fraction(stages, micro) == pytest.approx(want)
    assert PP.bubble_fraction(stages, micro) == RP.bubble_fraction(
        stages, micro)


@pytest.mark.timeout(120)
def test_pipeline_matches_sequential_on_four_stages(tmp_path):
    out = ranks.spawn(ranks.pipeline, tmp_path)
    assert max(out["errs"]) < 1e-5, out


def test_pipeline_at_a_world_of_one(tmp_path):
    had = dist.is_initialized()
    try:
        mesh = make_mesh((1,), ("pipe",), device="cpu")
        rng = np.random.default_rng(1)
        w = torch.from_numpy(0.3 * rng.standard_normal((4, 8, 8),
                                                       np.float32))
        x = torch.from_numpy(rng.standard_normal((6, 8), np.float32))

        def stage_fn(ws, h):
            for wi in ws:
                h = torch.tanh(h @ wi)
            return h
        ref = stage_fn(w, x)
        out = PP.pipeline_forward(stage_fn, mesh, axis="pipe", n_micro=3)(
            w, x)
        assert torch.equal(out, ref)
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()
