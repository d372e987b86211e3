"""Port parity: ``repro_torch.serve.engine`` against the JAX package's.

* Counterparts of ``tests/test_serve_admission.py``, of
  ``tests/test_serve_ragged.py`` for the four cache families (dense
  ``qwen3-1.7b``, moe ``qwen3-moe-30b-a3b``, ssm ``xlstm-125m`` and
  hybrid ``zamba2-1.2b``, reduced) and of ``tests/test_substrates.py``'s
  engine cases, on the port, with the reference's assertions and the
  reference's seed-0 weights (``params_from_jax``), on the CPU.
* Speculation with rejected drafts on the recurrent families: the
  window-start checkpoint, the verify from its copy, the rollback and
  the ``serve/replay`` run, and the tokens equal the baseline's.
* Port against reference: the same prompts and weights give equal
  ``out_tokens`` in float32 compute and a float32 cache, baseline and
  speculative (``spec_len`` 4), for the four families.
* C6: after a warm-up run in each package, the region names the marker
  is set to during a second, identical run are the same in both, and
  none is a model-inner region (``moe_router`` and ``moe_ffn``
  included; the reference's jitted steps run their regions only while
  being traced; the port runs its steps inside ``regions.opaque()``).
* The launcher serves a reduced dense, vlm (``internvl2-1b``, tokens
  only, as the reference's launcher sends), ssm and hybrid config.
* Device handling: the engine and the launcher default to the GPU and
  raise without one; params on another device are refused.
"""

import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from _torch_serve_pkgs import (CACHE_ARCHS, PORT, RECURRENT_ARCHS, REF,
                               make_engine, prompts, setup, weights)
from repro_torch.core import regions as regions_mod
from repro_torch.core.sampler import SampleBuffer
from repro_torch.launch import serve as launch_serve
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve.engine import (Engine, PhaseEnergyAccountant,
                                      PriceSignalUnavailableError, Request,
                                      ServeConfig, ServeTimeoutError)

MODEL_INNER = {"embed", "attn", "attn_decode", "attn_score", "ffn",
               "moe_router", "moe_ffn", "lm_head", "ssm_proj", "ssm_scan",
               "ssm_out", "ssm_decode", "mlstm_scan", "slstm_scan",
               "mlstm_decode", "shared_attn"}


@pytest.fixture(scope="module")
def arch_setup():
    return setup(PORT)


@pytest.fixture(scope="module", params=CACHE_ARCHS)
def cache_setup(request):
    return setup(PORT, arch=request.param)


def _engine(cfg, params, scfg, **kw):
    return Engine(cfg, params, scfg, device="cpu", **kw)


def _prompt(cfg, n=5, seed=0):
    rng = np.random.default_rng(seed)
    return rng.integers(1, cfg.vocab_size, size=n).astype(np.int32)


# -- queue-driven engine (tests/test_serve_admission.py) -----------------------

def test_submit_path_matches_direct_path(arch_setup):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=2, max_len=48)
    reqs = lambda: [Request(i, _prompt(cfg, 4 + i, seed=i), max_new_tokens=4)
                    for i in range(3)]
    direct = _engine(cfg, params, scfg)
    ref = {r.rid: list(r.out_tokens)
           for r in direct.run_until_drained(reqs())}
    queued = _engine(cfg, params, scfg)
    for r in reqs():
        queued.submit(r)
    got = {r.rid: list(r.out_tokens) for r in queued.run_until_drained([])}
    assert got == ref
    assert queued.report.completed == 3


def test_deadline_abort_returns_partial_output(arch_setup):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=1, max_len=48))
    eng.submit(Request(0, _prompt(cfg), max_new_tokens=30, deadline=3))
    (r,) = eng.run_until_drained([])
    assert r.status == "aborted_deadline" and not r.done
    assert 0 < len(r.out_tokens) <= 3
    rec = eng.report.request(0)
    assert rec.status == "aborted_deadline" and rec.error
    assert rec.tokens_out == len(r.out_tokens)


def test_energy_budget_abort_mid_decode(arch_setup):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=1, max_len=48, step_energy=1.0)
    eng = _engine(cfg, params, scfg)
    eng.submit(Request(0, _prompt(cfg, 4), max_new_tokens=30,
                       energy_budget=6.0))
    (r,) = eng.run_until_drained([])
    assert r.status == "aborted_budget" and not r.done
    assert len(r.out_tokens) == 3
    assert r.energy_j == pytest.approx(7.0)
    assert eng.report.aborted_budget == 1


def test_run_until_drained_timeout_is_typed(arch_setup):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=1, max_len=64))
    reqs = [Request(i, _prompt(cfg, 3, seed=i), max_new_tokens=40)
            for i in range(3)]
    with pytest.raises(ServeTimeoutError) as ei:
        eng.run_until_drained(reqs, max_steps=5)
    assert set(ei.value.undrained) == {0, 1, 2}


# -- per-request attribution (deterministic: stubbed sampler) -----------------

class _FakeSampler:
    def __init__(self):
        self.period = 2e-3
        self.elapsed = 0.0
        self.buffer_overruns = 0
        self.queue = []

    def drain(self):
        if self.queue:
            return self.queue.pop(0)
        return np.empty(0, np.int64), np.empty(0)


def _acct_with_fake():
    acct = PhaseEnergyAccountant(track_requests=True)
    acct.sampler = _FakeSampler()
    return acct


def test_request_energy_split_partitions_samples():
    rid = regions_mod.registry.intern("serve/decode")
    acct = _acct_with_fake()
    acct.sampler.queue.append((np.asarray([rid]), np.asarray([100.0])))
    acct.sampler.elapsed = 1.0
    acct.drain(active_requests=(1, 2))
    acct.sampler.queue.append((np.asarray([rid]), np.asarray([200.0])))
    acct.sampler.elapsed = 2.0
    acct.drain(active_requests=(2,))
    assert acct.request_energy() == pytest.approx({1: 50.0, 2: 250.0})
    per_phase = acct.request_phase_energy()
    name = regions_mod.registry.names[rid]
    assert per_phase[1][name] == pytest.approx(50.0)
    assert per_phase[2][name] == pytest.approx(250.0)
    est = acct.estimates()
    phase_total = float(est.table.e_hat[list(est.table.names).index(name)])
    assert sum(sum(d.values()) for d in per_phase.values()) == (
        pytest.approx(phase_total))


def test_take_request_charges_consumes_delta():
    rid = regions_mod.registry.intern("serve/decode")
    acct = _acct_with_fake()
    acct.sampler.queue.append((np.asarray([rid]), np.asarray([10.0])))
    acct.sampler.elapsed = 1.0
    acct.drain(active_requests=(7,))
    assert acct.take_request_charges() == pytest.approx({7: 10.0})
    assert acct.take_request_charges() == {}
    assert acct.request_energy() == pytest.approx({7: 10.0})


def test_scale_period_is_idempotent_from_base():
    acct = _acct_with_fake()
    base = acct.sampler.period
    acct.scale_period(4.0)
    acct.scale_period(4.0)
    assert acct.sampler.period == pytest.approx(base * 4.0)
    acct.reset_period()
    assert acct.sampler.period == pytest.approx(base)


# -- live J/token price signal ---------------------------------------------------

def _jpt_engine(arch_setup, acct=None, max_new=4):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=1, max_len=48),
                  accountant=acct)
    eng.run_until_drained(
        [Request(0, _prompt(cfg), max_new_tokens=max_new)])
    assert eng._tokens_emitted > 0
    return eng


def _drain_mix(acct, n_decode=30, n_other=30, elapsed=2.0):
    rid = regions_mod.registry.intern("serve/decode")
    other = regions_mod.registry.intern("serve/prefill")
    rids = np.asarray([rid] * n_decode + [other] * n_other)
    acct.sampler.queue.append((rids, np.full(len(rids), 100.0)))
    acct.sampler.elapsed = elapsed
    acct.drain()


def test_jpt_requires_accountant(arch_setup):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=1, max_len=48))
    with pytest.raises(PriceSignalUnavailableError, match="accountant"):
        eng.current_joules_per_token()


def test_jpt_requires_emitted_tokens(arch_setup):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=1, max_len=48),
                  accountant=_acct_with_fake())
    with pytest.raises(PriceSignalUnavailableError, match="no tokens"):
        eng.current_joules_per_token()


def test_jpt_requires_drained_samples(arch_setup):
    eng = _jpt_engine(arch_setup, _acct_with_fake())
    with pytest.raises(PriceSignalUnavailableError, match="no samples"):
        eng.current_joules_per_token()


def test_jpt_requires_decode_phase_samples(arch_setup):
    eng = _jpt_engine(arch_setup, _acct_with_fake())
    _drain_mix(eng.accountant, n_decode=0, n_other=30)
    with pytest.raises(PriceSignalUnavailableError, match="decode-phase"):
        eng.current_joules_per_token()


def test_jpt_wald_normality_guard_blocks_quote(arch_setup):
    eng = _jpt_engine(arch_setup, _acct_with_fake())
    _drain_mix(eng.accountant, n_decode=30, n_other=0)
    with pytest.raises(PriceSignalUnavailableError, match="normality"):
        eng.current_joules_per_token()


def test_jpt_ci_width_gate(arch_setup):
    eng = _jpt_engine(arch_setup, _acct_with_fake())
    _drain_mix(eng.accountant)
    with pytest.raises(PriceSignalUnavailableError, match="too wide"):
        eng.current_joules_per_token(max_rel_halfwidth=0.0)


def test_jpt_quote_brackets_estimate(arch_setup):
    eng = _jpt_engine(arch_setup, _acct_with_fake())
    _drain_mix(eng.accountant)
    q = eng.current_joules_per_token()
    assert q.tokens == eng._tokens_emitted > 0
    assert q.lo <= q.j_per_token <= q.hi
    assert q.energy_j > 0.0
    assert set(q.phases) <= {"serve/decode", "serve/draft", "serve/verify"}
    assert q.j_per_token == pytest.approx(q.energy_j / q.tokens)
    assert q.energy_j == pytest.approx(100.0)


def test_jpt_domain_must_be_measured(arch_setup):
    eng = _jpt_engine(arch_setup, _acct_with_fake())
    _drain_mix(eng.accountant)
    with pytest.raises(PriceSignalUnavailableError, match="not measured"):
        eng.current_joules_per_token(domain="hbm")


def test_sample_buffer_bounded_growth_counts_drops():
    buf = SampleBuffer(capacity=16, max_capacity=20)
    for i in range(30):
        buf.append(i % 3, 1.0)
    assert buf.overruns == 10
    rids, _ = buf.drain()
    assert len(rids) == 20
    assert buf.overruns == 10
    buf.append(0, 1.0)
    assert buf.overruns == 10


def test_sample_buffer_unbounded_never_drops():
    buf = SampleBuffer(capacity=4)
    for _ in range(100):
        buf.append(0, 1.0)
    assert buf.overruns == 0
    assert len(buf.drain()[0]) == 100


# -- ragged continuous batching (tests/test_serve_ragged.py, dense) ------------

def _scfg():
    return ServeConfig(max_batch=3, max_len=64, eos_token=-1)


def _prompts(cfg, lengths=(7, 3, 11), seed=42):
    return prompts(cfg.vocab_size, lengths, seed)


def _run_alone(cfg, params, prompt, rid, max_new=8):
    eng = _engine(cfg, params, _scfg())
    req = Request(rid=rid, prompt=prompt.copy(), max_new_tokens=max_new)
    done = eng.run_until_drained([req])
    assert len(done) == 1 and done[0].done
    return done[0].out_tokens


def _run_staggered(make, prompts_, max_new=8):
    """Staggered admission: each new request prefills while earlier ones
    are mid-decode at different depths. Returns (streams, engine)."""
    eng = make()
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=max_new)
            for i, p in enumerate(prompts_)]
    eng.add_request(reqs[0])
    for _ in range(2):
        eng.step()
    eng.add_request(reqs[1])
    for _ in range(2):
        eng.step()
    eng.add_request(reqs[2])
    for _ in range(40):
        eng.step()
        if all(r is None for r in eng.slot_req):
            break
    assert all(r.done for r in reqs)
    return [r.out_tokens for r in reqs], eng


def test_ragged_staggered_matches_sequential(cache_setup):
    cfg, params = cache_setup
    ps = _prompts(cfg)
    seq = [_run_alone(cfg, params, p, i) for i, p in enumerate(ps)]
    got, _ = _run_staggered(lambda: _engine(cfg, params, _scfg()), ps)
    for i in range(3):
        assert got[i] == seq[i], f"request {i} diverged"


def test_admission_mid_decode_leaves_active_request_unchanged(cache_setup):
    cfg, params = cache_setup
    ps = _prompts(cfg, lengths=(9, 6))
    base = _run_alone(cfg, params, ps[0], 0, max_new=10)
    eng = _engine(cfg, params, _scfg())
    r0 = Request(rid=0, prompt=ps[0].copy(), max_new_tokens=10)
    r1 = Request(rid=1, prompt=ps[1].copy(), max_new_tokens=4)
    eng.add_request(r0)
    for _ in range(3):
        eng.step()
    eng.add_request(r1)
    for _ in range(40):
        eng.step()
        if r0.done and r1.done:
            break
    assert r0.out_tokens == base, "mid-decode admission corrupted r0"


def test_ragged_depths_decode_to_distinct_positions(cache_setup):
    cfg, params = cache_setup
    ps = _prompts(cfg, lengths=(2, 20), seed=7)
    solo = [_run_alone(cfg, params, p, i, max_new=6)
            for i, p in enumerate(ps)]
    eng = _engine(cfg, params, _scfg())
    reqs = [Request(rid=i, prompt=p.copy(), max_new_tokens=6)
            for i, p in enumerate(ps)]
    for r in reqs:
        eng.add_request(r)
    for _ in range(30):
        eng.step()
        if all(r.done for r in reqs):
            break
    assert [r.out_tokens for r in reqs] == solo


def test_slot_reuse_does_not_inherit_previous_state(cache_setup):
    cfg, params = cache_setup
    ps = _prompts(cfg, lengths=(8, 5), seed=11)
    solo_b = _run_alone(cfg, params, ps[1], 1, max_new=6)
    eng = _engine(cfg, params, _scfg())
    ra = Request(rid=0, prompt=ps[0].copy(), max_new_tokens=4)
    eng.add_request(ra)
    for _ in range(10):
        eng.step()
        if ra.done:
            break
    assert ra.done
    for _ in range(2):
        eng.step()
    rb = Request(rid=1, prompt=ps[1].copy(), max_new_tokens=6)
    eng.add_request(rb)
    for _ in range(20):
        eng.step()
        if rb.done:
            break
    assert rb.out_tokens == solo_b, "reused slot leaked previous state"


def _scfg_spec(spec_len=4, **kw):
    return ServeConfig(max_batch=3, max_len=64, eos_token=-1,
                       spec_len=spec_len, spec_window=8, spec_sinks=2, **kw)


def test_speculative_staggered_token_exact(cache_setup):
    cfg, params = cache_setup
    ps = _prompts(cfg)
    base, _ = _run_staggered(lambda: _engine(cfg, params, _scfg()), ps)
    spec, eng = _run_staggered(lambda: _engine(cfg, params, _scfg_spec()),
                               ps)
    assert spec == base
    rep = eng.report
    assert rep.drafted > 0
    assert rep.accepted + rep.rejected == rep.drafted
    assert sum(r.spec_drafted for r in rep.requests) == rep.drafted
    assert sum(r.spec_accepted for r in rep.requests) == rep.accepted
    for rec in rep.requests:
        if rec.spec_drafted:
            assert rec.acceptance_rate == pytest.approx(
                rec.spec_accepted / rec.spec_drafted)
    cov = rep.coverage()
    assert "ACCEPTANCE" in cov["summary"]
    assert cov["counters"]["drafted"] == rep.drafted


def test_speculative_narrow_window_rolls_back_token_exact(cache_setup):
    cfg, params = cache_setup
    ps = _prompts(cfg, lengths=(13, 4, 9), seed=3)
    base, _ = _run_staggered(lambda: _engine(cfg, params, _scfg()), ps,
                             max_new=10)
    narrow = ServeConfig(max_batch=3, max_len=64, eos_token=-1,
                         spec_len=3, spec_window=2, spec_sinks=0)
    spec, eng = _run_staggered(lambda: _engine(cfg, params, narrow), ps,
                               max_new=10)
    assert spec == base
    assert eng.report.drafted > 0


@pytest.mark.parametrize("arch", RECURRENT_ARCHS)
def test_speculative_rejected_drafts_roll_back_token_exact(arch,
                                                         monkeypatch):
    """Rejected drafts on a recurrent family: every other draft pass
    proposes the runner-up token (the draft pass still advances the
    recurrent state on it), so windows are cut and the engine must
    restore its window-start checkpoint and replay the accepted tokens
    (``serve/replay``). Float32, as the token-exactness contract is
    checked on the card; the tokens equal the non-speculative run's."""
    cfg, params = setup(PORT, "float32", arch)
    ps = _prompts(cfg, lengths=(13, 4, 9), seed=3)
    scfg = dict(max_batch=3, max_len=64, eos_token=-1,
                cache_dtype="float32")
    base, _ = _run_staggered(
        lambda: _engine(cfg, params, ServeConfig(**scfg)), ps, max_new=10)
    calls = [0]

    def make():
        eng = _engine(cfg, params, ServeConfig(
            **scfg, spec_len=4, spec_window=8, spec_sinks=2))
        draft = eng._draft_step

        def wrong_half_the_time(p, t, c, l, m):
            logits, c = draft(p, t, c, l, m)
            calls[0] += 1
            if calls[0] % 2:
                second = logits.topk(2, dim=-1).indices[..., 1:]
                logits = logits.scatter(-1, second, logits.amax(-1, True)
                                        + 1.0)
            return logits, c
        eng._draft_step = wrong_half_the_time
        return eng

    phases = []
    orig = regions_mod.region

    def spy(name):
        phases.append(name)
        return orig(name)
    monkeypatch.setattr(regions_mod, "region", spy)
    spec, eng = _run_staggered(make, ps, max_new=10)
    rep = eng.report
    assert spec == base
    assert rep.rejected > 0 and rep.rollbacks > 0
    assert rep.accepted + rep.rejected == rep.drafted
    assert "serve/replay" in phases


def test_speculative_requires_greedy_sampler(arch_setup):
    cfg, params = arch_setup
    with pytest.raises(ValueError, match="greedy"):
        _engine(cfg, params, _scfg_spec(),
                sample=lambda logits: logits.argmax(-1))
    with pytest.raises(ValueError, match="spec_len"):
        _engine(cfg, params, ServeConfig(max_batch=2, spec_len=1))


def test_prompt_too_long_rejected(arch_setup):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=2, max_len=16,
                                           eos_token=-1))
    with pytest.raises(ValueError, match="request 9"):
        eng.add_request(Request(rid=9, prompt=np.ones(16, np.int32)))
    assert all(r is None for r in eng.slot_req)
    assert eng.add_request(Request(rid=1, prompt=np.ones(15, np.int32),
                                   max_new_tokens=1))


def test_exact_fit_prompt_accepted(arch_setup):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=1, max_len=16,
                                           eos_token=-1))
    req = Request(rid=0, prompt=np.ones(15, np.int32), max_new_tokens=4)
    done = eng.run_until_drained([req])
    assert len(done) == 1 and done[0].done
    assert len(done[0].out_tokens) >= 1


# -- tests/test_substrates.py's engine cases -------------------------------------

def test_engine_serves_requests(arch_setup):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=2, max_len=64,
                                           eos_token=-1))
    rng = np.random.default_rng(0)
    reqs = [Request(rid=i, prompt=rng.integers(1, cfg.vocab_size, 5)
                    .astype(np.int32), max_new_tokens=4) for i in range(3)]
    done = eng.run_until_drained(reqs)
    assert len(done) == 3
    assert all(len(r.out_tokens) == 4 for r in done)


def test_engine_rejects_empty_prompt(arch_setup):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=2, max_len=64,
                                           eos_token=-1))
    with pytest.raises(ValueError, match="empty prompt"):
        eng.add_request(Request(rid=0, prompt=np.zeros(0, np.int32)))
    ok = eng.add_request(Request(rid=1,
                                 prompt=np.array([1, 2, 3], np.int32),
                                 max_new_tokens=2))
    assert ok and eng.slot_req[0] is not None


# -- port against reference --------------------------------------------------------

def _f32_scfg(spec_len):
    return ServeConfig(max_batch=3, max_len=64, eos_token=-1,
                       cache_dtype="float32", spec_len=spec_len,
                       spec_window=8, spec_sinks=2)


def _first_divergence(got, want, ps, cfg, params):
    """The first differing token and the port's top-2 logit margin there
    (a full forward of the prompt and the agreed prefix)."""
    for i, (g, w) in enumerate(zip(got, want)):
        j = next((k for k, (a, b) in enumerate(zip(g, w)) if a != b), None)
        if j is None and len(g) == len(w):
            continue
        j = min(len(g), len(w)) if j is None else j
        seq = np.concatenate([ps[i], np.asarray(w[:j], np.int32)])
        logits, _ = M.forward(params, cfg,
                              {"tokens": torch.as_tensor(seq[None])})
        top = torch.topk(logits[0, -1].float(), 2).values
        return (f"request {i} diverges at token {j} (port {g[j:j + 1]}, "
                f"reference {w[j:j + 1]}); top-2 logit margin "
                f"{float(top[0] - top[1]):.3g}")
    return "streams equal"


@pytest.mark.parametrize("arch", CACHE_ARCHS)
@pytest.mark.parametrize("spec_len", [0, 4], ids=["baseline", "spec4"])
def test_tokens_equal_reference_float32(spec_len, arch):
    ps = prompts(256, (7, 3, 11), 42)
    streams = {}
    for pkg in (REF, PORT):
        cfg, params = setup(pkg, "float32", arch)
        streams[pkg.name], eng = _run_staggered(
            lambda: make_engine(pkg, cfg, params, _f32_scfg(spec_len)), ps)
        if spec_len:
            assert eng.report.drafted > 0
    pcfg, pp = setup(PORT, "float32", arch)
    assert streams["port"] == streams["ref"], _first_divergence(
        streams["port"], streams["ref"], ps, pcfg, pp)


# -- C6: serving phases take the samples ----------------------------------------

def _marker_names(pkg, cfg, params, scfg, ps):
    """Region names the marker is set to while ``pkg``'s engine serves
    ``ps``."""
    class Recording(pkg.sampler.RegionMarker):
        def __init__(self):
            super().__init__()
            self.seen = []

        def set(self, region_id):
            self.seen.append(region_id)
            super().set(region_id)

    marker = Recording()
    eng = make_engine(pkg, cfg, params, scfg)
    reqs = [pkg.engine.Request(rid=i, prompt=p.copy(), max_new_tokens=5)
            for i, p in enumerate(ps)]
    with pkg.regions.profiling_session(marker):
        eng.run_until_drained(reqs)
    names = pkg.regions.registry.names
    return [names[i] for i in marker.seen]


@pytest.mark.parametrize("arch", CACHE_ARCHS)
@pytest.mark.parametrize("spec_len", [0, 4], ids=["baseline", "spec4"])
def test_marker_sequence_equals_reference(spec_len, arch):
    ps = prompts(256, (4, 6, 3), 5)
    scfg = {pkg.name: pkg.engine.ServeConfig(
        max_batch=2, max_len=32, eos_token=-1, spec_len=spec_len,
        spec_window=8, spec_sinks=2) for pkg in (REF, PORT)}
    seqs = {}
    for pkg in (REF, PORT):
        cfg, params = setup(pkg, arch=arch)
        _marker_names(pkg, cfg, params, scfg[pkg.name], ps)    # warm-up
        seqs[pkg.name] = _marker_names(pkg, cfg, params, scfg[pkg.name], ps)
    assert seqs["port"] == seqs["ref"]
    assert not MODEL_INNER & set(seqs["port"])
    phases = {"serve/prefill"} | ({"serve/draft", "serve/verify"}
                                  if spec_len else {"serve/decode"})
    assert phases <= set(seqs["port"])


def test_opaque_keeps_the_marker_outside_the_model():
    class Recording(PORT.sampler.RegionMarker):
        seen: list

        def set(self, region_id):
            self.seen.append(regions_mod.registry.name_of(region_id))
            super().set(region_id)

    marker = Recording()
    marker.seen = []
    with regions_mod.profiling_session(marker):
        with regions_mod.region("outer"):
            with regions_mod.opaque():
                with regions_mod.region("attn"):
                    with regions_mod.opaque():
                        pass
                    with regions_mod.region("ffn"):
                        pass
            with regions_mod.region("inner"):
                pass
    assert marker.seen == ["outer", "inner", "outer", "<other>"]


# -- the step stays off the host's critical path ---------------------------------

class _HostWaits(TorchDispatchMode):
    """Records the operations that make the host wait for the device: a
    boolean index or ``nonzero`` (sized by the data) and scalar reads."""

    _WAITS = ("nonzero", "_local_scalar_dense", "masked_select")

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        name = func.overloadpacket.__name__
        if name in self._WAITS:
            self.seen.append(name)
        elif name.startswith("index") and len(args) > 1 and any(
                isinstance(i, torch.Tensor) and i.dtype == torch.bool
                for i in args[1] or ()):
            self.seen.append(f"{name} by a boolean mask")
        return func(*args, **(kwargs or {}))


@pytest.mark.parametrize("spec_len", [0, 4], ids=["baseline", "spec4"])
def test_engine_steps_never_wait_for_the_device(cache_setup, spec_len):
    """The masked decode, draft and verify steps queue their work without
    a host wait (the write mask's restore is a select; rope's frequencies
    are made once), so on the GPU the host runs ahead of the device until
    the engine reads the sampled tokens."""
    cfg, params = cache_setup
    eng = _engine(cfg, params, _scfg_spec(spec_len))
    eng.add_request(Request(0, _prompt(cfg, 6), max_new_tokens=8))
    toks = torch.zeros((3, 1), dtype=torch.int32)
    cur = torch.tensor([6, 0, 0], dtype=torch.int32)
    mask = torch.tensor([True, False, False])
    steps = [lambda: eng._decode_masked(params, toks, eng.cache, cur, mask)]
    if spec_len:
        steps += [lambda: eng._draft_step(params, toks, eng.cache, cur,
                                          mask),
                  lambda: eng._verify_step(params, toks.repeat(1, 4),
                                           eng.cache, cur, mask)]
    for step in steps:
        with _HostWaits() as mode:
            step()
        assert mode.seen == []
    assert L._rope_freqs(32, 1e6, torch.device("cpu")) is \
        L._rope_freqs(32, 1e6, torch.device("cpu"))


# -- device handling and the launcher -------------------------------------------

def test_engine_and_launcher_default_to_the_gpu():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is usable")
    _, _, cfg, params = weights()
    with pytest.raises(RuntimeError, match="no GPU"):
        Engine(cfg, params, _scfg())
    with pytest.raises(RuntimeError, match="no GPU"):
        launch_serve.main(["--arch", "qwen3-1.7b", "--smoke"])


def test_engine_refuses_params_on_another_device(arch_setup):
    cfg, params = arch_setup
    with pytest.raises(ValueError, match="params live on"):
        Engine(cfg, params, _scfg(), device="meta")


@pytest.mark.parametrize("arch", ["qwen3-1.7b", "internvl2-1b",
                                  "xlstm-125m", "zamba2-1.2b"])
def test_launcher_serves_every_request(capsys, arch):
    done, engine, sess = launch_serve.main(
        ["--arch", arch, "--smoke", "--device", "cpu",
         "--requests", "5", "--new-tokens", "6"])
    assert len(done) == 5 and all(r.done for r in done)
    assert all(len(r.out_tokens) == 6 for r in done)
    assert engine.report.completed == 5
    out = capsys.readouterr().out
    assert "served 5/5 requests (30 tokens)" in out
    assert "serve/prefill" in out and "serve/decode" in out
    assert not MODEL_INNER & {r.name for r in sess.estimates().regions}
