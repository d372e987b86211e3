"""Recompile guard for the port (``tests/test_recompile_guard.py``'s
counterparts): one (config, shape) key means one cache entry.

Eager PyTorch compiles nothing, but the port keeps four caches keyed by
configuration: the engine's step functions (``serve.engine._step_fns``,
``_spec_step_fns``), rotary frequencies (``models.layers._rope_freqs``)
and sinusoidal positions. A key that leaks a length, a request or a
tensor into one of them is the port's form of a recompile: an entry (and
on the GPU a host-to-device copy) per request instead of one. The device
pipeline's chunk steps have no cache; their contract is that every
steady chunk issues the same operations whatever the run or the seed
(on the GPU, the same launches), recorded by the auditor's dispatch
mode.
"""

import dataclasses

import numpy as np
import torch

from repro_torch.analysis.op_audit import audit_ops, jit_cache_size
from repro_torch.configs.registry import get_config
from repro_torch.core import device_pipeline as dp
from repro_torch.core import threefry
from repro_torch.core.sensors import InstantTraceSensor, idle_channel
from repro_torch.core.timeline import RegionCost, synthesize
from repro_torch.kernels.sample_attr.ops import make_carry_update
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.serve.engine import (Engine, Request, ServeConfig,
                                      _spec_step_fns, _step_fns)

CPU = torch.device("cpu")


def _fresh_cfg(extra=3):
    """A config no other test shares, so the session-wide lru-cached step
    functions start cold for it."""
    cfg = get_config("qwen3-1.7b").reduced()
    return dataclasses.replace(cfg, vocab_size=cfg.vocab_size + extra)


def _params(cfg):
    return M.init_params(torch.Generator().manual_seed(0), cfg, device="cpu")


def _engine(cfg, params, scfg):
    return Engine(cfg, params, scfg, device="cpu")


def _rope_entries():
    return jit_cache_size(L._rope_freqs)


def test_engine_decode_builds_its_steps_once_across_requests():
    cfg = _fresh_cfg()
    params = _params(cfg)
    before = jit_cache_size(_step_fns)
    eng = _engine(cfg, params, ServeConfig(max_batch=3, max_len=64,
                                           eos_token=-1))
    decode, reset = _step_fns(cfg)
    assert decode is eng._decode_masked     # config-keyed cache shared
    assert reset is eng._reset_slots
    assert jit_cache_size(_step_fns) == before + 1

    rng = np.random.default_rng(7)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size, n)
                    .astype(np.int32),
                    max_new_tokens=6)
            for i, n in enumerate((5, 3, 9, 4))]
    # Staggered multi-request run: prefills at several depths, ragged
    # decode, slot reuse after the first requests drain.
    eng.add_request(reqs[0])
    eng.step()
    rope = _rope_entries()
    eng.add_request(reqs[1])
    eng.add_request(reqs[2])
    for _ in range(30):
        eng.step()
        if all(r is None for r in eng.slot_req):
            break
    eng.add_request(reqs[3])                # reuses a drained slot
    for _ in range(30):
        eng.step()
        if all(r is None for r in eng.slot_req):
            break
    assert all(r.done for r in reqs)
    assert jit_cache_size(_step_fns) == before + 1, \
        "the step functions were rebuilt within one config key"
    assert _rope_entries() == rope, \
        "rotary frequencies cached per prompt length"

    # A second engine over the same config shares the same functions.
    eng2 = _engine(cfg, params, ServeConfig(max_batch=3, max_len=64,
                                            eos_token=-1))
    eng2.run_until_drained([Request(rid=99,
                                    prompt=np.array([1, 2], np.int32),
                                    max_new_tokens=4)])
    assert eng2._decode_masked is decode
    assert jit_cache_size(_step_fns) == before + 1
    assert _rope_entries() == rope


def test_snapshot_restore_and_aborts_add_no_cache_keys(tmp_path):
    # Queue-driven admission, budget aborts, snapshot publish and
    # restore-replay all reuse the one config's step functions: replay
    # teacher-forces through the same masked decode step.
    cfg = _fresh_cfg(7)
    params = _params(cfg)
    scfg = ServeConfig(max_batch=2, max_len=48, eos_token=-1,
                       step_energy=1.0)
    before = jit_cache_size(_step_fns)
    rng = np.random.default_rng(3)
    eng = _engine(cfg, params, scfg)
    eng.submit(Request(0, rng.integers(1, cfg.vocab_size, 5)
                       .astype(np.int32), max_new_tokens=8))
    eng.submit(Request(1, rng.integers(1, cfg.vocab_size, 4)
                       .astype(np.int32), max_new_tokens=12,
                       energy_budget=6.0))      # budget-aborts mid-decode
    eng.step()
    eng.step()
    rope = _rope_entries()
    eng.snapshot(str(tmp_path))
    assert jit_cache_size(_step_fns) == before + 1

    restored = Engine.restore(cfg, params, scfg, str(tmp_path),
                              device="cpu")
    restored.run_until_drained([])              # replay + finish + abort
    assert restored.report.aborted_budget == 1
    assert restored._decode_masked is eng._decode_masked
    assert jit_cache_size(_step_fns) == before + 1, \
        "snapshot/restore or abort path added a cache key"
    assert _rope_entries() == rope


def test_speculative_draft_and_verify_built_once():
    # The speculative loop adds exactly one (draft, verify) pair per
    # (config, window, sinks) key, reused across windows, slots and
    # engines; rollback replay rides the baseline masked decode step.
    cfg = _fresh_cfg(9)
    params = _params(cfg)
    scfg = ServeConfig(max_batch=2, max_len=64, eos_token=-1,
                       spec_len=4, spec_window=8, spec_sinks=2)
    base, spec = jit_cache_size(_step_fns), jit_cache_size(_spec_step_fns)
    eng = _engine(cfg, params, scfg)
    draft, verify = _spec_step_fns(cfg, scfg.spec_window, scfg.spec_sinks)
    assert eng._draft_step is draft and eng._verify_step is verify
    assert jit_cache_size(_spec_step_fns) == spec + 1

    rng = np.random.default_rng(5)
    reqs = [Request(rid=i,
                    prompt=rng.integers(1, cfg.vocab_size, n)
                    .astype(np.int32),
                    max_new_tokens=8)
            for i, n in enumerate((6, 3))]
    eng.add_request(reqs[0])
    eng.step()
    rope = _rope_entries()
    eng.add_request(reqs[1])                    # ragged speculative decode
    for _ in range(40):
        eng.step()
        if all(r is None for r in eng.slot_req):
            break
    assert all(r.done for r in reqs)
    assert eng.report.drafted > 0
    assert jit_cache_size(_spec_step_fns) == spec + 1, \
        "draft/verify rebuilt within one (config, window, sinks) key"
    assert jit_cache_size(_step_fns) == base + 1   # prefill + replay
    assert _rope_entries() == rope

    # A second speculative engine over the same config reuses them all.
    eng2 = _engine(cfg, params, scfg)
    eng2.run_until_drained([Request(rid=9,
                                    prompt=np.array([1, 2, 3], np.int32),
                                    max_new_tokens=6)])
    assert eng2._draft_step is draft and eng2._verify_step is verify
    assert jit_cache_size(_spec_step_fns) == spec + 1
    assert jit_cache_size(_step_fns) == base + 1


_GUARD_CHUNK = 333


def _timeline(seed):
    costs = [RegionCost("mem", flops=1e10, hbm_bytes=5e10, invocations=4),
             RegionCost("alu", flops=6e11, hbm_bytes=2e9, invocations=4),
             RegionCost("opt", flops=2e10, hbm_bytes=4e10, invocations=1)]
    return synthesize(costs, steps=40, seed=seed)


def _steady_ops(step, carry, prev, args, tail, chunks=(1, 2)):
    """The op lists of ``step`` on each of ``chunks`` after chunk 0."""
    out = step(carry, prev, *args, 0, *tail)
    carry, prev = out[0], out[1]
    lists = []
    for k in chunks:
        box = []
        stats = audit_ops(lambda: box.append(
            step(carry, prev, *args, k, *tail)))
        carry, prev = box[0][0], box[0][1]
        lists.append(stats.ops)
    return lists


def test_region_chunk_step_issues_the_same_ops_across_runs():
    spec = InstantTraceSensor.make_spec()
    dtls = [dp.DeviceTimeline.from_timelines([_timeline(s)], device="cpu")
            for s in (0, 1)]
    assert dtls[0].grid_k == dtls[1].grid_k, "fixture must share the key"
    lists = []
    for seed, dtl in enumerate(dtls):
        res = dp.run_region_pipeline(dtl, spec, period=5e-3, seed=seed,
                                     chunk_size=_GUARD_CHUNK)
        assert res.n > 0
        root = threefry.PRNGKey(seed)
        carry = (*dp._zero_carry(dtl.num_regions, 1, CPU),
                 torch.zeros((), dtype=torch.int64))
        args = (dtl, spec, make_carry_update(dtl.num_regions), root,
                dp._phase(root, 5e-3))
        tail = (_GUARD_CHUNK, 5e-3, 200e-6, 0.0, 55.0,
                idle_channel(spec.domains))
        lists += _steady_ops(dp._region_step, carry,
                             torch.full((), -1.0, dtype=torch.float64),
                             args, tail)
    assert len(lists[0]) > 0
    assert all(ops == lists[0] for ops in lists), \
        "a steady region chunk issued other ops in another run"


def test_combo_chunk_step_issues_the_same_ops_across_runs():
    spec = InstantTraceSensor.make_spec()
    dtl = dp.DeviceTimeline.from_timelines([_timeline(0), _timeline(1)],
                                           device="cpu")
    pack = dp._pack_spec(dtl.num_regions, dtl.num_workers)
    lists = []
    for seed in (0, 1):
        agg, n = dp.run_combo_pipeline(dtl, spec, period=5e-3, seed=seed,
                                       chunk_size=_GUARD_CHUNK)
        assert n > 0
        cap = dp._table_cap(len(agg.interner))
        table = dp._build_table(agg.interner, cap, pack, CPU)
        root = threefry.PRNGKey(seed)
        carry = (*dp._zero_carry(cap, 1, CPU),
                 torch.zeros((), dtype=torch.int64))
        args = (table, dtl, spec, root, dp._phase(root, 5e-3))
        lists += _steady_ops(dp._combo_step, carry,
                             torch.full((), -1.0, dtype=torch.float64),
                             args, (_GUARD_CHUNK, 5e-3, 200e-6))
    assert len(lists[0]) > 0
    assert all(ops == lists[0] for ops in lists), \
        "a steady combination chunk issued other ops in another run"
