"""The port's examples (``examples/torch/*.py``) on the CPU at their
smallest sizes, each ``main()`` run in this process with ``--device cpu``.

``energy_tuning --hw tpu-v5e`` must print what the reference's
``examples/energy_tuning.py`` prints at the same arguments, line for
line. The reference's quickstart and serve demo are not run (minutes
under JAX); the port's are held to what they promise: finite losses, a
resumable checkpoint, every request served, an attribution table.
"""

import importlib.util
import math
import os
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[1]
PORT_EXAMPLES = ("quickstart", "train_lm", "serve_demo", "energy_tuning")


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _port(name):
    return _load(ROOT / "examples" / "torch" / f"{name}.py",
                 f"port_example_{name}")


ET_ARGS = ["--arch", "qwen3-1.7b", "--chips", "4"]


def test_energy_tuning_prints_the_references_lines(monkeypatch, capsys):
    ref = _load(ROOT / "examples" / "energy_tuning.py", "ref_energy_tuning")
    monkeypatch.setattr(sys, "argv", ["energy_tuning.py", *ET_ARGS])
    ref.main()
    want = capsys.readouterr().out
    _port("energy_tuning").main(ET_ARGS + ["--hw", "tpu-v5e",
                                           "--device", "cpu"])
    got = capsys.readouterr()
    assert got.out.splitlines() == want.splitlines()
    assert "whole-hotspot energy saving" in got.out
    assert "activity power model" in got.err


def test_energy_tuning_on_the_h100_spec(capsys):
    """The default prices the timeline at the card's peaks: a shorter
    timeline than the v5e's, and a plan that saves energy."""
    et = _port("energy_tuning")
    est, base, plan = et.main(["--device", "cpu"])
    out = capsys.readouterr()
    assert "hardware h100-sxm" in out.err
    v5e, _, _ = et.main(["--device", "cpu", "--hw", "tpu-v5e"])
    assert est.t_exec < v5e.t_exec
    assert plan.energy <= base.energy
    assert len(plan.plans) == len(base.plans) == 6
    assert {p.region for p in plan.plans} == {r.name
                                              for r in est.dominant(6)}


def test_quickstart_trains(capsys):
    loss, est = _port("quickstart").main(["--steps", "5", "--device", "cpu"])
    out = capsys.readouterr().out
    assert math.isfinite(loss)
    assert "train_step" in {r.name for r in est.regions}
    assert est.n_total > 0
    assert "hotspot:" in out


def test_train_lm_smoke_trains_and_resumes(tmp_path, capsys):
    """A straight smoke run (20 steps, checkpoints at 10 and 20); then,
    as if the process had died after step 10's checkpoint, a rerun
    resumes at step 10 and reaches step 20's loss bit for bit."""
    ex = _port("train_lm")
    args = ["--smoke", "--device", "cpu", "--ckpt-dir", str(tmp_path)]
    result, trainer = ex.main(args)
    losses = {m["step"]: m["loss"] for m in result["metrics"]}
    assert sorted(losses) == [10, 20]
    assert all(math.isfinite(v) for v in losses.values())
    assert trainer.step == 20
    (tmp_path / "LATEST").write_text("10")
    result, trainer = ex.main(args)
    out = capsys.readouterr().out
    assert "resumed from checkpoint at step 10" in out
    assert [m["step"] for m in result["metrics"]] == [20]
    assert result["metrics"][0]["loss"] == losses[20]
    assert "ALEA energy attribution" in out


def test_serve_demo_serves_every_request(capsys):
    reqs, done, est = _port("serve_demo").main(
        ["--requests", "2", "--new-tokens", "16", "--device", "cpu"])
    out = capsys.readouterr().out
    assert sorted(r.rid for r in done) == [r.rid for r in reqs]
    assert all(len(r.out_tokens) == 16 for r in done)
    assert "completed 2/2 requests" in out
    assert "ALEA per-phase attribution" in out
    assert any(r.name.startswith("serve") for r in est.regions)


@pytest.mark.parametrize("name", PORT_EXAMPLES)
def test_examples_refuse_a_missing_gpu(name, tmp_path):
    """The default device is the GPU; without one each example raises
    instead of running on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs")
    argv = {"train_lm": ["--smoke", "--ckpt-dir", str(tmp_path)],
            "quickstart": ["--steps", "1"],
            "serve_demo": ["--requests", "1"],
            "energy_tuning": ["--arch", "qwen3-1.7b"]}[name]
    with pytest.raises(RuntimeError, match="no GPU"):
        _port(name).main(argv)
    assert not os.listdir(tmp_path)
