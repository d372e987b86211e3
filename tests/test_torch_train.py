"""Port parity: the training path (``repro_torch.train.step``,
``train.trainer``, ``launch.train`` and the train-state converters)
against the JAX package's, on reduced qwen3-1.7b on the CPU, and on
reduced granite-moe-1b-a400m (the moe family: steps with their
``metrics["aux"]``, the state round trip, the launcher).

* Three steps of ``make_train_step`` from one converted state: losses
  within rel 1e-5 of the reference's and parameters within atol
  1e-2·lr (Adam's first steps amplify rounding: an update is about
  lr·g/(|g|+eps)), float32, for ``accum_steps`` 1 and 4 and with
  compression; ``bf16_gather`` in bf16 compute, losses within rel 2e-2,
  and in float32 compute, where the first gradients show which leaves
  it casts.
* The reference's own trainer checks (``tests/test_substrates.py``):
  training reduces the loss, restart from a checkpoint, metrics.
* A checkpoint the reference's ``Trainer`` wrote is read by the port,
  converted and continued: the next two losses within rel 1e-5 of the
  reference's own continuation.
* ``train_state_to_jax(train_state_from_jax(s)) == s`` bit for bit.
* C7: the region names the marker is set to during the second and later
  steps equal the reference's (its jitted step marks only while traced;
  the port's launcher runs the step inside ``regions.opaque()``).
* The launcher on the CPU, with and without profiling; without
  ``--device`` it asks for the GPU.
"""

import os
import signal

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import registry as r_registry
from repro.core import regions as r_regions
from repro.core import sampler as r_sampler
from repro.data.pipeline import SyntheticTokens as RTokens
from repro.optim import adamw as r_adamw
from repro.train import step as r_step
from repro.train import trainer as r_trainer
from repro_torch.checkpoint import ckpt as p_ckpt
from repro_torch.configs import registry as p_registry
from repro_torch.convert import train_state_from_jax, train_state_to_jax
from repro_torch.core import regions as p_regions
from repro_torch.core import sampler as p_sampler
from repro_torch.data.pipeline import SyntheticTokens
from repro_torch.launch import train as launch_train
from repro_torch.optim.adamw import AdamWConfig
from repro_torch.train import step as step_mod
from repro_torch.train.step import init_state, make_train_step, opaque_step
from repro_torch.train.trainer import Trainer, TrainerConfig
from repro_torch.tree import tree_leaves

ARCH = "qwen3-1.7b"
LOSS_RTOL = 1e-5
BF16_LOSS_RTOL = 2e-2


@pytest.fixture(autouse=True)
def _keep_sigterm():
    """Trainer installs a SIGTERM handler, as the reference's does; put
    the previous one back after each test."""
    prev = signal.getsignal(signal.SIGTERM)
    yield
    signal.signal(signal.SIGTERM, prev)


def _cfgs(arch=ARCH, **kw):
    return (r_registry.get_config(arch).reduced().replace(**kw),
            p_registry.get_config(arch).reduced().replace(**kw))


def _ref_state(rcfg, ropt, seed=0, compression=False):
    st = jax.jit(lambda k: r_step.init_state(k, rcfg, ropt,
                                             compression=compression))(
        jax.random.PRNGKey(seed))
    return jax.tree.map(np.asarray, st)


def _port_batch(b):
    return {k: torch.from_numpy(np.ascontiguousarray(v))
            for k, v in b.items()}


def _ref_batch(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _params(state, pcfg=None):
    """Parameter leaves as numpy in the reference's stacked layout (the
    port's state needs its config)."""
    if pcfg is not None:
        state = train_state_to_jax(state, pcfg)
    return [np.asarray(x) for x in jax.tree.leaves(state["params"])]


def _first_grads(ref_state, opt):
    """The clipped gradient of the reference's first step, from its first
    moment (mu = (1 - b1) g after one step)."""
    return [np.asarray(m) / (1 - opt.b1)
            for m in jax.tree.leaves(ref_state["opt"]["mu"])]


def _residuals(state, pcfg=None):
    if pcfg is not None:
        state = train_state_to_jax(state, pcfg)
    return [np.asarray(x) for x in jax.tree.leaves(state["residuals"])]


def _check_params(port, ref, noise, opt, lrs):
    """Parameters within atol 1e-2·lr, except on the ``noise`` elements,
    whose update follows rounding: where the reference's first gradient
    is below 10·eps, Adam's update lr·g/(|g|+eps) is rounding amplified
    (its sign can flip); with compression, an element whose int8 code the
    two packages round to neighbouring values in some step (its residuals
    then differ by a quantum) gets a gradient one quantum apart. Those
    are held to 2·Σlr, the most such flips can move them.
    Returns how many there are with a nonzero gradient (the embedding
    rows of tokens not in the batch have none, in both packages)."""
    n_noise = 0
    for a, b, m in zip(port, ref, noise):
        d = np.abs(a - b)
        n_noise += int(m.sum())
        assert d[~m].max(initial=0.0) <= 1e-2 * opt.lr
        assert d[m].max(initial=0.0) <= 2 * sum(lrs)
    return n_noise


@pytest.mark.parametrize("accum_steps,compression", [
    (1, False), (4, False), (1, True)],
    ids=["accum1", "accum4", "compression"])
def test_train_steps_match_reference(accum_steps, compression):
    rcfg, pcfg = _cfgs(compute_dtype="float32")
    kw = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    ropt, popt = r_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    rs = _ref_state(rcfg, ropt, compression=compression)
    ps = train_state_from_jax(rs, pcfg, device="cpu")
    rstep = jax.jit(r_step.make_train_step(
        rcfg, ropt, accum_steps=accum_steps, compression=compression))
    pstep = make_train_step(pcfg, popt, accum_steps=accum_steps,
                            compression=compression)
    data = SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=32,
                           global_batch=8)
    lrs = []
    for i in range(3):
        b = data.batch(i)
        rs, rm = rstep(rs, _ref_batch(b))
        ps, pm = pstep(ps, _port_batch(b))
        if i == 0:
            g1 = _first_grads(rs, ropt)
            noise = [(np.abs(g) < 10 * popt.eps) & (g != 0) for g in g1]
        if compression:           # a code rounded the other way: a quantum
            noise = [m | (np.abs(a - b) > 1e-6) for m, a, b in zip(
                noise, _residuals(ps, pcfg), _residuals(rs))]
            share = sum(int(m.sum()) for m in noise) / sum(
                m.size for m in noise)
            if i == 0:            # from rounding alone: a few elements
                assert share < 1e-4
            if i == 2:            # measured 0.037; a fault moves nearly all
                assert share < 5e-2
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=LOSS_RTOL)
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
        assert float(pm["lr"]) == pytest.approx(float(rm["lr"]), rel=1e-6)
        lrs.append(float(rm["lr"]))
    assert int(ps["opt"]["step"]) == 3
    n_noise = _check_params(_params(ps, pcfg), _params(rs), noise, popt,
                            lrs)
    if not compression:
        # With compression the elements moved apart by a flip change the
        # later gradients, and later steps flip more codes (~4% by the
        # third); without it only rounding-level gradients are set apart.
        assert n_noise < 1e-3 * sum(x.size for x in g1)
    if compression:
        for a, b, m in zip(_residuals(ps, pcfg), _residuals(rs), noise):
            np.testing.assert_allclose(a[~m], b[~m], atol=1e-6)


def test_bf16_gather_matches_reference():
    rcfg, pcfg = _cfgs(bf16_gather=True)
    ropt, popt = r_adamw.AdamWConfig(grad_clip=1e9), AdamWConfig(
        grad_clip=1e9)
    rs = _ref_state(rcfg, ropt, seed=2)
    ps = train_state_from_jax(rs, pcfg, device="cpu")
    rstep = jax.jit(r_step.make_train_step(rcfg, ropt))
    pstep = make_train_step(pcfg, popt)
    data = SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=32,
                           global_batch=2)
    for i in range(3):
        b = data.batch(i)
        rs, rm = rstep(rs, _ref_batch(b))
        ps, pm = pstep(ps, _port_batch(b))
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=BF16_LOSS_RTOL)


def test_bf16_gather_casts_the_references_leaves(monkeypatch):
    """The leaves ``bf16_gather`` casts are the reference's: those of
    ndim >= 2 in its layer-stacked tree, so every block's [d] norm scale
    too. In float32 compute the cast is the only bf16 rounding, so the
    first gradients tell it: a cast leaf's gradient is a bf16 value, and
    the first moments agree with the reference's to rtol 1e-4 on all but
    a few elements of each leaf (at most 2e-3 of them: an f32 gradient on
    a bf16 rounding boundary, measured at most 1.1e-3 on a matrix leaf,
    none on a norm scale). Leaving the block norm scales in float32 moves
    0.94-0.98 of their elements past rtol 1e-4 (bf16 rounding, up to
    3.8e-3), and the losses stay bitwise equal, since the scales start
    at 1.0."""
    rcfg, pcfg = _cfgs(bf16_gather=True, compute_dtype="float32")
    ropt, popt = r_adamw.AdamWConfig(grad_clip=1e9), AdamWConfig(
        grad_clip=1e9)
    rs = _ref_state(rcfg, ropt, seed=2)
    cast = [x.ndim >= 2 for x in jax.tree.leaves(rs["params"])]
    ps = train_state_from_jax(rs, pcfg, device="cpu")
    seen = []
    real_update = step_mod.adamw_update

    def update(cfg, params, grads, state, **kw):
        seen.append(grads)
        return real_update(cfg, params, grads, state, **kw)

    monkeypatch.setattr(step_mod, "adamw_update", update)
    rstep = jax.jit(r_step.make_train_step(rcfg, ropt))
    pstep = make_train_step(pcfg, popt)
    data = SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=32,
                           global_batch=2)
    for i in range(3):
        b = data.batch(i)
        rs, rm = rstep(rs, _ref_batch(b))
        ps, pm = pstep(ps, _port_batch(b))
        assert float(pm["loss"]) == pytest.approx(float(rm["loss"]),
                                                  rel=LOSS_RTOL)
        if i == 0:
            grads = train_state_to_jax(
                {"params": seen[0], "opt": {"mu": seen[0], "nu": seen[0],
                                            "step": ps["opt"]["step"]}},
                pcfg)["params"]
            for g, c in zip(jax.tree.leaves(grads), cast):
                g = torch.from_numpy(np.asarray(g))
                assert torch.equal(g.to(torch.bfloat16).float(), g) == c
            mus = (jax.tree.leaves(train_state_to_jax(ps, pcfg)["opt"]["mu"]),
                   jax.tree.leaves(rs["opt"]["mu"]))
            for a, r in zip(*(map(np.asarray, m) for m in mus)):
                off = np.abs(a - r) > 1e-4 * np.abs(r) + 1e-9
                assert off.mean() <= 2e-3


def test_bf16_gather_close_to_fp32_layout():
    """bf16 weight gathering changes numerics within bf16 rounding only
    (the reference's tests/test_loss_paths.py check, on the port)."""
    _, pcfg = _cfgs()
    opt = AdamWConfig(grad_clip=1e9)
    b = _port_batch(SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=32,
                                    global_batch=2).batch(0))
    losses = []
    for c in (pcfg, pcfg.replace(bf16_gather=True)):
        st = init_state(torch.Generator().manual_seed(2), c, opt,
                        device="cpu")
        _, m = make_train_step(c, opt)(st, b)
        losses.append(float(m["loss"]))
    assert losses[0] == pytest.approx(losses[1], rel=BF16_LOSS_RTOL)


def test_init_state_requires_grad_and_the_gpu():
    _, pcfg = _cfgs()
    st = init_state(torch.Generator().manual_seed(0), pcfg, AdamWConfig(),
                    compression=True, device="cpu")
    assert all(t.requires_grad for t in tree_leaves(st["params"]))
    assert not any(t.requires_grad for t in tree_leaves(st["opt"]))
    assert set(st) == {"params", "opt", "residuals"}
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no GPU"):
            init_state(torch.Generator().manual_seed(0), pcfg,
                       AdamWConfig())


def test_training_reduces_loss():
    """Tiny model, 30 steps: loss must drop (the reference's check)."""
    _, cfg = _cfgs()
    opt_cfg = AdamWConfig(lr=1e-3, warmup_steps=5, total_steps=30)
    state = init_state(torch.Generator().manual_seed(0), cfg, opt_cfg,
                       device="cpu")
    step = make_train_step(cfg, opt_cfg)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64,
                           global_batch=4)
    losses = []
    for i in range(30):
        state, metrics = step(state, _port_batch(data.batch(i % 2)))
        losses.append(float(metrics["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses[::6]


@pytest.mark.parametrize("arch", [ARCH, "xlstm-125m"])
def test_cpu_steps_repeat_bit_for_bit(arch):
    """Three float32 steps with compression, twice from one state on four
    CPU threads, end in the same state bit for bit: the embedding's
    gradient accumulates in a fixed order. (chip_smoke's card-vs-CPU
    train check counts the int8 codes the two devices round apart, so
    its CPU side must repeat.)"""
    _, cfg = _cfgs(arch, compute_dtype="float32")
    opt_cfg = AdamWConfig(lr=3e-4, warmup_steps=2, total_steps=10)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=64,
                           global_batch=4)
    threads = torch.get_num_threads()
    torch.set_num_threads(4)
    try:
        runs = []
        for _ in range(2):
            state = init_state(torch.Generator().manual_seed(0), cfg,
                               opt_cfg, compression=True, device="cpu")
            step = make_train_step(cfg, opt_cfg, compression=True)
            for i in range(3):
                state, _ = step(state, _port_batch(data.batch(i)))
            runs.append([t.detach().clone() for t in tree_leaves(state)])
    finally:
        torch.set_num_threads(threads)
    assert all(torch.equal(a, b) for a, b in zip(*runs))


def test_grad_accumulation_matches_full_batch():
    _, cfg = _cfgs(compute_dtype="float32")
    opt_cfg = AdamWConfig(grad_clip=1e9)
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=8)
    batch = _port_batch(data.batch(0))

    def state():
        return init_state(torch.Generator().manual_seed(1), cfg, opt_cfg,
                          device="cpu")
    s1, m1 = make_train_step(cfg, opt_cfg, accum_steps=1)(state(), batch)
    s2, m2 = make_train_step(cfg, opt_cfg, accum_steps=4)(state(), batch)
    assert float(m1["loss"]) == pytest.approx(float(m2["loss"]), rel=1e-5)
    for a, b in zip(tree_leaves(s1["params"]), tree_leaves(s2["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=2e-6)


# -- trainer -----------------------------------------------------------------

def _tiny_trainer(tmp_path, total_steps=6, **tkw):
    _, cfg = _cfgs()
    opt_cfg = AdamWConfig(total_steps=total_steps)
    state = init_state(torch.Generator().manual_seed(0), cfg, opt_cfg,
                       device="cpu")
    step = opaque_step(make_train_step(cfg, opt_cfg))
    data = SyntheticTokens(vocab_size=cfg.vocab_size, seq_len=32,
                           global_batch=2)
    tcfg = TrainerConfig(total_steps=total_steps, ckpt_dir=str(tmp_path),
                         ckpt_every=2, log_every=1, **tkw)
    return Trainer(tcfg, step, state, data, put_batch=_port_batch)


def test_trainer_checkpoint_restart(tmp_path):
    t1 = _tiny_trainer(tmp_path, total_steps=4)
    r1 = t1.run()
    assert r1["final_step"] == 4
    # "Crash" and restart: a fresh trainer resumes from step 4.
    t2 = _tiny_trainer(tmp_path, total_steps=6)
    assert t2.try_resume()
    assert t2.step == 4
    r2 = t2.run()
    assert r2["final_step"] == 6
    assert int(t2.state["opt"]["step"]) == 6
    # ... and ends where a straight 6-step run ends, bit for bit.
    t3 = _tiny_trainer(tmp_path / "straight", total_steps=6)
    r3 = t3.run()
    assert [m["loss"] for m in r3["metrics"][4:]] == \
        [m["loss"] for m in r2["metrics"]]
    for a, b in zip(tree_leaves(t2.state), tree_leaves(t3.state)):
        assert torch.equal(a, b)


def test_sigterm_inside_the_optimizer_saves_a_whole_step(tmp_path,
                                                        monkeypatch):
    """A SIGTERM that lands while ``adamw_update`` is halfway through its
    in-place loop (leaf 2's square root, in step 3) saves the state once
    the step is whole, at step 3, and a run resumed from it ends where a
    straight one does, bit for bit."""
    real_update, real_sqrt = step_mod.adamw_update, torch.sqrt
    sqrt_calls = []

    def update(cfg, params, grads, state, **kw):
        if int(state["step"]) == 2:
            sqrt_calls.append(0)     # arm: global_norm's sqrt, then a leaf's
        return real_update(cfg, params, grads, state, **kw)

    def sqrt(x):
        out = real_sqrt(x)
        if sqrt_calls:
            sqrt_calls[0] += 1
            if sqrt_calls[0] == 3:
                os.kill(os.getpid(), signal.SIGTERM)
        return out

    monkeypatch.setattr(step_mod, "adamw_update", update)
    monkeypatch.setattr(torch, "sqrt", sqrt)
    t1 = _tiny_trainer(tmp_path, total_steps=6)
    t1.cfg.ckpt_every = 100
    with pytest.raises(SystemExit) as exit_info:
        t1.run()
    assert exit_info.value.code == 143
    assert sqrt_calls[0] > 3                   # the loop ran on after it
    assert p_ckpt.latest_step(str(tmp_path)) == 3
    monkeypatch.undo()
    t2 = _tiny_trainer(tmp_path, total_steps=6)
    assert t2.try_resume() and t2.step == 3
    assert int(t2.state["opt"]["step"]) == 3
    r2 = t2.run()
    t3 = _tiny_trainer(tmp_path / "straight", total_steps=6)
    r3 = t3.run()
    assert [m["loss"] for m in r3["metrics"][3:]] == \
        [m["loss"] for m in r2["metrics"]]
    for a, b in zip(tree_leaves(t2.state), tree_leaves(t3.state)):
        assert torch.equal(a, b)


def test_trainer_records_metrics(tmp_path):
    t = _tiny_trainer(tmp_path, total_steps=3)
    r = t.run()
    assert len(r["metrics"]) == 3
    assert all(np.isfinite(m["loss"]) for m in r["metrics"])
    assert {"loss", "ce", "aux", "grad_norm", "lr", "step",
            "step_time_s"} <= set(r["metrics"][0])


def test_continues_a_checkpoint_the_reference_wrote(tmp_path):
    rcfg, pcfg = _cfgs(compute_dtype="float32")
    kw = dict(total_steps=4)
    ropt, popt = r_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    tcfg = dict(ckpt_every=2, log_every=1)
    rstep = jax.jit(r_step.make_train_step(rcfg, ropt))
    rdata = RTokens(vocab_size=rcfg.vocab_size, seq_len=32, global_batch=2)

    def ref_trainer(total):
        return r_trainer.Trainer(
            r_trainer.TrainerConfig(total_steps=total,
                                    ckpt_dir=str(tmp_path), **tcfg),
            rstep, _ref_state(rcfg, ropt), rdata, put_batch=_ref_batch)
    ref_trainer(2).run()                           # writes step 2
    cont = ref_trainer(4)
    assert cont.try_resume() and cont.step == 2
    want = [m["loss"] for m in cont.run()["metrics"]]

    example = _ref_state(rcfg, ropt)
    host, step = p_ckpt.restore(str(tmp_path), example, 2)
    t = Trainer(TrainerConfig(total_steps=4, ckpt_dir=str(tmp_path / "p"),
                              **tcfg),
                opaque_step(make_train_step(pcfg, popt)),
                train_state_from_jax(host, pcfg, device="cpu"),
                SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=32,
                                global_batch=2), put_batch=_port_batch)
    t.step = step
    got = [m["loss"] for m in t.run()["metrics"]]
    assert len(got) == len(want) == 2
    for a, b in zip(got, want):
        assert a == pytest.approx(b, rel=LOSS_RTOL)


@pytest.mark.parametrize("compression", [False, True])
def test_train_state_round_trip_is_bitwise(compression):
    rcfg, pcfg = _cfgs()
    rs = _ref_state(rcfg, r_adamw.AdamWConfig(), seed=3,
                    compression=compression)
    rs["opt"]["step"] = np.asarray(7, np.int32)
    back = train_state_to_jax(train_state_from_jax(rs, pcfg, device="cpu"),
                              pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(rs)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rs)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


# -- C7: which regions take the samples --------------------------------------

def _marker_names(regions, sampler, trainer):
    """The region names the marker is set to while ``trainer`` runs,
    from its second step on."""
    class Recording(sampler.RegionMarker):
        def set(self, region_id):
            if trainer.step >= 1:
                names.append(regions.registry.name_of(region_id))
            super().set(region_id)
    names = []
    with regions.profiling_session(Recording()):
        trainer.run()
    return names


def test_marker_sequence_equals_reference(tmp_path):
    rcfg, pcfg = _cfgs()
    ropt, popt = r_adamw.AdamWConfig(total_steps=5), AdamWConfig(
        total_steps=5)
    tkw = dict(total_steps=5, ckpt_every=2, log_every=1)
    ref = r_trainer.Trainer(
        r_trainer.TrainerConfig(ckpt_dir=str(tmp_path / "r"), **tkw),
        jax.jit(r_step.make_train_step(rcfg, ropt)), _ref_state(rcfg, ropt),
        RTokens(vocab_size=rcfg.vocab_size, seq_len=16, global_batch=2),
        put_batch=_ref_batch)
    port = Trainer(
        TrainerConfig(ckpt_dir=str(tmp_path / "p"), **tkw),
        opaque_step(make_train_step(pcfg, popt)),
        init_state(torch.Generator().manual_seed(0), pcfg, popt,
                   device="cpu"),
        SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=16,
                        global_batch=2), put_batch=_port_batch)
    want = _marker_names(r_regions, r_sampler, ref)
    got = _marker_names(p_regions, p_sampler, port)
    assert got == want
    assert set(got) == {"data_load", "train_step", "checkpoint", "<other>"}


def test_the_eager_step_would_mark_inner_regions(tmp_path):
    """Without ``opaque_step`` the port's step marks fwd_bwd, optimizer
    and the layers on every call: the check above can see a fault."""
    _, pcfg = _cfgs()
    opt = AdamWConfig(total_steps=2)
    t = Trainer(TrainerConfig(total_steps=2, ckpt_dir=str(tmp_path),
                              log_every=1),
                make_train_step(pcfg, opt),
                init_state(torch.Generator().manual_seed(0), pcfg, opt,
                           device="cpu"),
                SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=16,
                                global_batch=2), put_batch=_port_batch)
    names = set(_marker_names(p_regions, p_sampler, t))
    assert {"fwd_bwd", "optimizer", "attn", "ffn", "loss"} <= names


# -- the launcher ------------------------------------------------------------

@pytest.mark.parametrize("profile", [True, False], ids=["profile",
                                                        "no-profile"])
def test_launcher_on_the_cpu(tmp_path, capsys, profile):
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "3",
            "--ckpt-dir", str(tmp_path)]
    result, sess, trainer = launch_train.main(
        argv + ([] if profile else ["--no-profile"]))
    out = capsys.readouterr().out
    assert result["final_step"] == 3 and result["straggler_events"] == []
    assert int(trainer.state["opt"]["step"]) == 3
    assert "arch=qwen3-1.7b-smoke" in out
    if profile:
        est = sess.estimates()
        assert "train_step" in out
        names = {n for n, e in est.by_name().items() if e.n_samples}
        assert names <= {"data_load", "train_step", "checkpoint", "<other>"}
    else:
        assert sess is None


def test_launcher_asks_for_the_gpu(tmp_path):
    # --mesh is ported; a mesh larger than the world raises (no fallback)
    had = dist.is_initialized()
    try:
        with pytest.raises(ValueError, match="world of 1"):
            launch_train.main(["--arch", ARCH, "--smoke", "--device", "cpu",
                               "--mesh", "2x2", "--ckpt-dir",
                               str(tmp_path)])
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()
    if torch.cuda.is_available():
        pytest.skip("a GPU is visible: the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        launch_train.main(["--arch", ARCH, "--smoke",
                           "--ckpt-dir", str(tmp_path)])


def test_launcher_mesh_1x1_trains_as_unsharded(tmp_path, capsys):
    """``--mesh 1x1`` (a world of one): the state is DTensors, the step
    runs under the rules; its losses and final parameters equal the run
    without ``--mesh``, and its checkpoint (whole tensors) restores into
    the unsharded launcher, which then resumes at the last step."""
    argv = ["--arch", ARCH, "--smoke", "--device", "cpu", "--steps", "10",
            "--no-profile", "--log-every", "1"]
    plain, _, tp = launch_train.main(argv + ["--ckpt-dir",
                                             str(tmp_path / "a")])
    had = dist.is_initialized()
    try:
        sharded, _, ts = launch_train.main(
            argv + ["--mesh", "1x1", "--ckpt-dir", str(tmp_path / "b")])
        got = [t.full_tensor().detach()
               for t in tree_leaves(ts.state["params"])]
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()
    assert [m["loss"] for m in sharded["metrics"]] == [
        m["loss"] for m in plain["metrics"]]
    want = tree_leaves(tp.state["params"])
    assert max(float((a - b).abs().max()) for a, b in zip(got, want)) < 1e-6
    capsys.readouterr()
    again, _, tr = launch_train.main(argv + ["--ckpt-dir",
                                             str(tmp_path / "b")])
    assert "resumed at step" in capsys.readouterr().out
    for a, b in zip(tree_leaves(tr.state["params"]), got):
        assert torch.equal(a, b)


# -- the moe family (granite-moe-1b-a400m) ------------------------------------

MOE_ARCH = "granite-moe-1b-a400m"


def test_moe_train_steps_match_reference():
    """Three float32 steps from one converted state: losses and the MoE
    aux loss (``metrics["aux"]``) within rel 1e-5 of the reference's step,
    parameters as in ``test_train_steps_match_reference``."""
    rcfg, pcfg = _cfgs(MOE_ARCH, compute_dtype="float32")
    kw = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    ropt, popt = r_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    rs = _ref_state(rcfg, ropt)
    ps = train_state_from_jax(rs, pcfg, device="cpu")
    rstep = jax.jit(r_step.make_train_step(rcfg, ropt))
    pstep = make_train_step(pcfg, popt)
    data = SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=32,
                           global_batch=8)
    lrs = []
    for i in range(3):
        b = data.batch(i)
        rs, rm = rstep(rs, _ref_batch(b))
        ps, pm = pstep(ps, _port_batch(b))
        if i == 0:
            g1 = _first_grads(rs, ropt)
            noise = [(np.abs(g) < 10 * popt.eps) & (g != 0) for g in g1]
        assert float(rm["aux"]) > 0
        for k in ("loss", "ce", "aux"):
            assert float(pm[k]) == pytest.approx(float(rm[k]),
                                                 rel=LOSS_RTOL), k
        lrs.append(float(rm["lr"]))
    n_noise = _check_params(_params(ps, pcfg), _params(rs), noise, popt,
                            lrs)
    assert n_noise < 1e-3 * sum(x.size for x in g1)


@pytest.mark.parametrize("compression", [False, True])
def test_moe_train_state_round_trip_is_bitwise(compression):
    rcfg, pcfg = _cfgs(MOE_ARCH)
    rs = _ref_state(rcfg, r_adamw.AdamWConfig(), seed=3,
                    compression=compression)
    ps = train_state_from_jax(rs, pcfg, device="cpu")
    assert tuple(ps["params"]["blocks"][0]["moe"]["up"].shape) == (
        pcfg.n_experts, pcfg.d_model, pcfg.moe_d_ff)
    back = train_state_to_jax(ps, pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(rs)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rs)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


def test_moe_launcher_on_the_cpu(tmp_path, capsys):
    result, sess, trainer = launch_train.main(
        ["--arch", MOE_ARCH, "--smoke", "--device", "cpu", "--steps", "3",
         "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    out = capsys.readouterr().out
    assert result["final_step"] == 3
    assert f"arch={MOE_ARCH}-smoke" in out
    assert all(np.isfinite(m["loss"]) for m in result["metrics"])
    names = {n for n, e in sess.estimates().by_name().items()
             if e.n_samples}
    assert names <= {"data_load", "train_step", "checkpoint", "<other>"}


# -- the recurrent families (xlstm-125m, zamba2-1.2b) -------------------------

# name → (arch, n_layers or None for the reduced config's): zamba2's
# reduced config has 2 groups of 2 layers and no tail; "zamba2-tail" has 5
# layers, so a tail of 1 (its own stacked leaves, its own compression
# scale, outside remat).
RECURRENT = {"xlstm-125m": ("xlstm-125m", None),
             "zamba2-1.2b": ("zamba2-1.2b", None),
             "zamba2-tail": ("zamba2-1.2b", 5)}
# The share of elements whose first gradient is below 10·eps (Adam's
# first update of those follows rounding), and, without compression, of
# all rounding-led ones.
REC_NOISE_CAP = 5e-3
REC_ROUNDED_CAP = 5e-3
REC_GRAD_ROUND_RTOL = 1e-2


def _rec_cfgs(name, **kw):
    arch, n = RECURRENT[name]
    if n is not None:
        kw["n_layers"] = n
    return _cfgs(arch, **kw)


def _first_moments(state, pcfg=None):
    if pcfg is not None:
        state = train_state_to_jax(state, pcfg)
    return [np.asarray(m) for m in jax.tree.leaves(state["opt"]["mu"])]


@pytest.mark.parametrize("compression", [False, True],
                         ids=["plain", "compression"])
@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-tail"])
def test_recurrent_train_steps_match_reference(name, compression):
    """Three float32 steps from one converted state, as
    ``test_train_steps_match_reference``: losses within rel 1e-5,
    gradient norms within rel 1e-4, parameters within atol 1e-2·lr
    outside the rounding-led elements, those within 2·Σlr. zamba2's
    shared block is used by every group, so its gradient is their sum;
    AdamW decays the stacked ndim >= 2 leaves (the groups' and the
    tail's ``A_log``, ``D``, ``dt_bias`` and norm scales, not the shared
    block's norm scales), and compression scales each whole stacked leaf
    (the groups' over all their layers, the tail's apart). zamba2 runs
    with a tail (5 layers: two groups of 2 and a tail of 1), which holds
    the groups' leaves and the tail's.

    Rounding-led, besides the first-gradient and int8-code rules: an
    element whose first moment after some step differs between the
    packages by more than ``REC_GRAD_ROUND_RTOL`` of it (its gradients
    are cancellations of larger terms, and Adam's division by the
    gradient's own scale carries their rounding into the parameter; the
    rule chip_smoke's moe train check applies to the gradients)."""
    rcfg, pcfg = _rec_cfgs(name, compute_dtype="float32")
    kw = dict(lr=3e-4, warmup_steps=2, total_steps=10)
    ropt, popt = r_adamw.AdamWConfig(**kw), AdamWConfig(**kw)
    rs = _ref_state(rcfg, ropt, compression=compression)
    ps = train_state_from_jax(rs, pcfg, device="cpu")
    rstep = jax.jit(r_step.make_train_step(rcfg, ropt,
                                           compression=compression))
    pstep = make_train_step(pcfg, popt, compression=compression)
    data = SyntheticTokens(vocab_size=pcfg.vocab_size, seq_len=32,
                           global_batch=8)
    lrs = []
    for i in range(3):
        b = data.batch(i)
        rs, rm = rstep(rs, _ref_batch(b))
        ps, pm = pstep(ps, _port_batch(b))
        if i == 0:
            g1 = _first_grads(rs, ropt)
            noise = [(np.abs(g) < 10 * popt.eps) & (g != 0) for g in g1]
            n_first = sum(int(m.sum()) for m in noise)
        noise = [m | (np.abs(a - b) > REC_GRAD_ROUND_RTOL * np.abs(b))
                 for m, a, b in zip(noise, _first_moments(ps, pcfg),
                                    _first_moments(rs))]
        if compression:           # a code rounded the other way: a quantum
            noise = [m | (np.abs(a - b) > 1e-6) for m, a, b in zip(
                noise, _residuals(ps, pcfg), _residuals(rs))]
        for k in ("loss", "ce"):
            assert float(pm[k]) == pytest.approx(float(rm[k]),
                                                 rel=LOSS_RTOL), k
        assert float(pm["grad_norm"]) == pytest.approx(
            float(rm["grad_norm"]), rel=1e-4)
        lrs.append(float(rm["lr"]))
    n_noise = _check_params(_params(ps, pcfg), _params(rs), noise, popt,
                            lrs)
    n_el = sum(x.size for x in g1)
    # The B/C and dt projections' first gradients are tiny with random
    # weights (3-5% of in_bc's and in_dt's elements below 10·eps: 1 844
    # of 759 920 elements on zamba2 with a tail).
    assert n_first < REC_NOISE_CAP * n_el
    # Measured: 1.8e-3 to 3.0e-3 of the elements without compression;
    # with it the codes rounded apart (and what they move) reach 1.8%,
    # within the 5e-2 of test_train_steps_match_reference's third step.
    cap = 5e-2 if compression else REC_ROUNDED_CAP
    assert n_noise < cap * n_el, n_noise


@pytest.mark.parametrize("compression", [False, True],
                         ids=["plain", "compression"])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_train_state_round_trip_is_bitwise(name, compression):
    rcfg, pcfg = _rec_cfgs(name)
    rs = _ref_state(rcfg, r_adamw.AdamWConfig(), seed=3,
                    compression=compression)
    ps = train_state_from_jax(rs, pcfg, device="cpu")
    if pcfg.family == "hybrid":
        groups = ps["params"]["groups"]
        assert len(groups) == 2 and all(len(g) == 2 for g in groups)
        assert ("tail" in ps["params"]) == (name == "zamba2-tail")
    back = train_state_to_jax(ps, pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(rs)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rs)):
        assert a.dtype == b.dtype and a.shape == b.shape
        assert a.tobytes() == b.tobytes()


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-1.2b"])
def test_recurrent_launcher_on_the_cpu(tmp_path, capsys, arch):
    result, sess, trainer = launch_train.main(
        ["--arch", arch, "--smoke", "--device", "cpu", "--steps", "2",
         "--ckpt-dir", str(tmp_path), "--log-every", "1"])
    out = capsys.readouterr().out
    assert result["final_step"] == 2
    assert f"arch={arch}-smoke" in out
    assert all(np.isfinite(m["loss"]) for m in result["metrics"])
    names = {n for n, e in sess.estimates().by_name().items()
             if e.n_samples}
    assert names <= {"data_load", "train_step", "checkpoint", "<other>"}
