"""Port parity: ``repro_torch.serve.recovery`` — the counterparts of
``tests/test_serve_recovery.py`` for the dense family (``qwen3-1.7b``)
on the port (kill mid-speculation for all four cache families: moe
``qwen3-moe-30b-a3b``, ssm ``xlstm-125m`` and hybrid ``zamba2-1.2b``
too, as the reference's ``SPEC_ARCHS`` has it), and
snapshots that cross between the packages: a snapshot
written by the reference's engine, restored by the port's and run to the
end, gives the reference's uninterrupted tokens (float32 compute and
cache), and the reverse.
"""

import numpy as np
import pytest

from _torch_serve_pkgs import (CACHE_ARCHS, PORT, REF, make_engine, prompts,
                               restore, setup)
from repro_torch.core import exchange as ex
from repro_torch.core import faults
from repro_torch.core.faults import (FaultPlan, InjectedCrash, LeafFault,
                                     MissingArtifactError, SpillError,
                                     TornWriteError)
from repro_torch.serve.engine import (Engine, PhaseEnergyAccountant, Request,
                                      ServeConfig)
from repro_torch.serve.recovery import restore_engine
from repro_torch.serve.scheduler import OverloadPolicy, ServeScheduler

pytestmark = pytest.mark.chaos

CROSS = [(REF, PORT), (PORT, REF)]
CROSS_IDS = ["ref-to-port", "port-to-ref"]


@pytest.fixture(scope="module")
def arch_setup():
    return setup(PORT)


def _engine(cfg, params, scfg, **kw):
    return Engine(cfg, params, scfg, device="cpu", **kw)


def _restore(cfg, params, scfg, path, **kw):
    return restore_engine(cfg, params, scfg, path, device="cpu", **kw)


def _prompts(cfg, n, seed=3):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, cfg.vocab_size, size=int(rng.integers(3, 8)))
            .astype(np.int32) for _ in range(n)]


def _drive(eng, done):
    for _ in range(500):
        done += eng.step()
        if (not any(r is not None for r in eng.slot_req)
                and not len(eng.scheduler.queue)):
            return
    raise AssertionError("engine did not drain")


def test_kill_restore_bit_exact_with_provenance(arch_setup, tmp_path):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=2, max_len=64, step_energy=1.0)
    prompts_ = _prompts(cfg, 5)
    policy = OverloadPolicy(queue_capacity=3, backpressure_at=1,
                            shed_at=2, widen_at=3)

    def mk_reqs():
        reqs = [Request(i, prompts_[i].copy(), max_new_tokens=5,
                        priority=i) for i in range(4)]
        reqs.append(Request(4, prompts_[4].copy(), max_new_tokens=16,
                            priority=9,
                            energy_budget=len(prompts_[4]) + 2.0))
        return reqs

    def run(eng_factory, snap_dir=None):
        eng = eng_factory()
        for r in mk_reqs():
            try:
                eng.submit(r)
            except Exception:
                pass
        done = []
        for _ in range(500):
            if snap_dir is not None and eng.step_count % 2 == 0:
                eng.snapshot(snap_dir)
            done += eng.step()
            if (not any(s is not None for s in eng.slot_req)
                    and not len(eng.scheduler.queue)):
                break
        return eng, done

    ref_eng, ref_done = run(lambda: _engine(
        cfg, params, scfg, scheduler=ServeScheduler(policy)))
    ref_streams = {r.rid: list(r.out_tokens) for r in ref_done}

    snap = str(tmp_path / "snaps")
    plan = FaultPlan(seed=7, serve_crashes=(5,))
    with pytest.raises(InjectedCrash):
        run(lambda: _engine(cfg, params, scfg,
                            scheduler=ServeScheduler(policy), faults=plan),
            snap_dir=snap)

    eng2 = _restore(cfg, params, scfg, snap)
    assert eng2.step_count <= 5
    done2 = []
    _drive(eng2, done2)
    got = {r.rid: list(r.out_tokens) for r in done2}
    assert got
    for rid, toks in got.items():
        assert toks == ref_streams[rid], f"request {rid} diverged"

    rep, ref_rep = eng2.report, ref_eng.report
    assert {r.rid for r in rep.requests} == set(range(5))
    assert rep.by_status() == ref_rep.by_status()
    assert rep.aborted_budget == 1 and rep.request(4).status == "aborted_budget"
    assert rep.shed + rep.rejected_full >= 1
    assert all(rep.request(r.rid).recovered for r in done2)
    assert rep.coverage()["counters"]["completed"] == rep.completed


def test_snapshot_fault_is_transient_and_typed(arch_setup, tmp_path):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=1, max_len=32)
    eng = _engine(cfg, params, scfg,
                  faults=FaultPlan(seed=0, snapshot_failures=(0,)))
    eng.add_request(Request(0, _prompts(cfg, 1)[0], max_new_tokens=3))
    with pytest.raises(TornWriteError):
        eng.snapshot(str(tmp_path))
    assert not (tmp_path / "LATEST").exists()
    eng.step()
    out = eng.snapshot(str(tmp_path))
    assert out.endswith("snap_000000001")
    assert _restore(cfg, params, scfg, str(tmp_path)).step_count == 1


def test_snapshot_corruption_surfaces_typed(arch_setup, tmp_path):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=1, max_len=32)
    eng = _engine(cfg, params, scfg)
    eng.add_request(Request(0, _prompts(cfg, 1)[0], max_new_tokens=3))
    eng.step()
    with faults.install(FaultPlan(seed=1, leaf_faults=(
            LeafFault(match="snap_000000001/arr_00000"),))):
        eng.snapshot(str(tmp_path))
        with pytest.raises(SpillError):
            _restore(cfg, params, scfg, str(tmp_path))


def test_restore_without_snapshot_is_missing_artifact(arch_setup, tmp_path):
    cfg, params = arch_setup
    with pytest.raises(MissingArtifactError):
        _restore(cfg, params, ServeConfig(max_batch=1, max_len=32),
                 str(tmp_path))


def test_restore_rejects_geometry_mismatch(arch_setup, tmp_path):
    cfg, params = arch_setup
    eng = _engine(cfg, params, ServeConfig(max_batch=2, max_len=32))
    eng.snapshot(str(tmp_path))
    with pytest.raises(ValueError):
        _restore(cfg, params, ServeConfig(max_batch=4, max_len=32),
                 str(tmp_path))


def test_overload_ladder_sheds_and_widens(arch_setup):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=1, max_len=48)
    acct = PhaseEnergyAccountant(period=2e-3, track_requests=True)
    sched = ServeScheduler(OverloadPolicy(
        queue_capacity=8, backpressure_at=2, shed_at=4, widen_at=6))
    eng = _engine(cfg, params, scfg, accountant=acct, scheduler=sched)
    prompts_ = _prompts(cfg, 8, seed=11)
    with acct:
        for i in range(8):
            try:
                eng.submit(Request(i, prompts_[i], max_new_tokens=3,
                                   priority=i % 3))
            except Exception:
                pass
        done = []
        done += eng.step()
        assert eng.scheduler.level == 3
        assert acct.sampling_period == pytest.approx(
            2e-3 * sched.policy.widen_factor)
        _drive(eng, done)
    assert acct.sampling_period == pytest.approx(2e-3)
    rep = eng.report
    assert rep.shed >= 1
    assert [t[2] for t in rep.transitions][-1] == "normal"
    assert rep.completed == len([r for r in done
                                 if r.status == "completed"])
    assert rep.completed + rep.shed == 8
    assert rep.rejected_full <= rep.shed


@pytest.mark.parametrize("arch", CACHE_ARCHS)
def test_kill_restore_mid_speculation_bit_exact(arch, tmp_path):
    cfg, params = setup(PORT, arch=arch)
    scfg = ServeConfig(max_batch=2, max_len=64, eos_token=-1,
                       step_energy=1.0, spec_len=4, spec_window=8,
                       spec_sinks=2)
    base_scfg = ServeConfig(max_batch=2, max_len=64, eos_token=-1,
                            step_energy=1.0)
    prompts_ = _prompts(cfg, 3, seed=9)

    def run(scfg_, faults_=None, snap_dir=None):
        eng = _engine(cfg, params, scfg_, faults=faults_)
        reqs = [Request(i, prompts_[i].copy(), max_new_tokens=9)
                for i in range(3)]
        for r in reqs:
            eng.submit(r)
        for _ in range(500):
            if snap_dir is not None and eng.step_count % 2 == 0:
                eng.snapshot(snap_dir)
            eng.step()
            if (not any(s is not None for s in eng.slot_req)
                    and not len(eng.scheduler.queue)):
                break
        return {r.rid: list(r.out_tokens) for r in reqs}, eng

    baseline, _ = run(base_scfg)
    ref, ref_eng = run(scfg)
    assert ref == baseline
    assert ref_eng.report.drafted > 0

    snap = str(tmp_path / "snaps")
    with pytest.raises(InjectedCrash):
        run(scfg, faults_=FaultPlan(seed=7, serve_crashes=(3,)),
            snap_dir=snap)
    eng2 = _restore(cfg, params, scfg, snap)
    assert eng2.step_count <= 3
    done2 = []
    _drive(eng2, done2)
    got = {rid: list(eng2._requests[rid].out_tokens) for rid in baseline}
    assert got == baseline, "restored speculative run diverged"
    rep = eng2.report
    assert rep.accepted + rep.rejected == rep.drafted


def test_deescalation_restores_speculation_length(arch_setup):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=1, max_len=48, spec_len=4,
                       spec_window=8, spec_sinks=2, degraded_spec_len=2)
    acct = PhaseEnergyAccountant(period=2e-3)
    sched = ServeScheduler(OverloadPolicy(
        queue_capacity=8, backpressure_at=2, shed_at=4, widen_at=6))
    eng = _engine(cfg, params, scfg, accountant=acct, scheduler=sched)
    prompts_ = _prompts(cfg, 8, seed=11)
    with acct:
        for i in range(8):
            try:
                eng.submit(Request(i, prompts_[i], max_new_tokens=3,
                                   priority=i % 3))
            except Exception:
                pass
        done = []
        done += eng.step()
        assert eng.scheduler.level == 3 and eng.scheduler.widened
        assert eng._spec_len_now() == 2
        assert acct.sampling_period == pytest.approx(
            2e-3 * sched.policy.widen_factor)
        _drive(eng, done)
    assert not eng.scheduler.widened
    assert eng._spec_len_now() == 4
    assert acct.sampling_period == pytest.approx(2e-3)
    reasons = [t[3] for t in eng.report.transitions]
    assert any("speculation shrunk" in r for r in reasons)
    assert any("speculation length restored" in r for r in reasons)


def test_degraded_spec_len_none_disables_speculation(arch_setup):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=1, max_len=48, spec_len=4,
                       spec_window=8, spec_sinks=2)
    sched = ServeScheduler(OverloadPolicy(
        queue_capacity=8, backpressure_at=2, shed_at=4, widen_at=6))
    eng = _engine(cfg, params, scfg, scheduler=sched)
    prompts_ = _prompts(cfg, 8, seed=11)
    for i in range(8):
        try:
            eng.submit(Request(i, prompts_[i], max_new_tokens=3,
                               priority=i % 3))
        except Exception:
            pass
    eng.step()
    assert eng.scheduler.widened
    assert eng._spec_len_now() == 0
    done = []
    _drive(eng, done)
    assert eng._spec_len_now() == 4


def test_energy_spill_fence_never_double_counts(arch_setup, tmp_path):
    cfg, params = arch_setup
    scfg = ServeConfig(max_batch=1, max_len=32)
    spill = str(tmp_path / "shards")
    snaps = str(tmp_path / "snaps")
    prompts_ = _prompts(cfg, 2, seed=5)

    acct = PhaseEnergyAccountant(period=1e-3, spill_dir=spill,
                                 spill_every=1)
    eng = _engine(cfg, params, scfg, accountant=acct,
                  faults=FaultPlan(seed=2, serve_crashes=(3,)))
    with pytest.raises(InjectedCrash):
        with acct:
            eng.submit(Request(0, prompts_[0], max_new_tokens=8))
            while True:
                eng.snapshot(snaps)
                eng.step()
    published = ex.restore_shard(spill, 0)[0].counts.sum()

    acct2 = PhaseEnergyAccountant(period=1e-3, spill_dir=spill,
                                  spill_every=1)
    assert acct2.agg.counts.sum() == published
    eng2 = _restore(cfg, params, scfg, snaps, accountant=acct2)
    assert eng2.restored_fence is not None
    assert acct2.epoch >= (eng2.restored_fence["last_spill_epoch"] or 0)
    with acct2:
        done = []
        _drive(eng2, done)
    final = ex.restore_shard(spill, 0)[0]
    assert final.counts.sum() == acct2.agg.counts.sum() >= published
    with pytest.raises(ValueError):
        ex.ShardSpiller(spill, 0).spill(acct2.agg, epoch=1)


# -- snapshots across packages -----------------------------------------------------

def _f32_scfg(pkg, spec_len):
    return pkg.engine.ServeConfig(max_batch=2, max_len=64, eos_token=-1,
                                  cache_dtype="float32", spec_len=spec_len,
                                  spec_window=8, spec_sinks=2)


def _serve(pkg, spec_len, ps, *, crash_at=None, snap_dir=None):
    """Serve ``ps`` through ``pkg``'s float32 engine, snapshotting every
    second step when ``snap_dir`` is given; returns the streams, or
    raises the injected crash at step ``crash_at``."""
    cfg, params = setup(pkg, "float32")
    plan = (None if crash_at is None
            else pkg.faults.FaultPlan(seed=7, serve_crashes=(crash_at,)))
    eng = make_engine(pkg, cfg, params, _f32_scfg(pkg, spec_len),
                      faults=plan)
    reqs = [pkg.engine.Request(i, p.copy(), max_new_tokens=9)
            for i, p in enumerate(ps)]
    for r in reqs:
        eng.submit(r)
    for _ in range(500):
        if snap_dir is not None and eng.step_count % 2 == 0:
            eng.snapshot(snap_dir)
        eng.step()
        if (not any(s is not None for s in eng.slot_req)
                and not len(eng.scheduler.queue)):
            break
    return {r.rid: list(r.out_tokens) for r in reqs}


@pytest.mark.parametrize("spec_len", [0, 4], ids=["baseline", "spec4"])
@pytest.mark.parametrize("src,dst", CROSS, ids=CROSS_IDS)
def test_snapshot_restores_across_packages(src, dst, spec_len, tmp_path):
    """``src`` is killed at step 5; ``dst`` restores ``src``'s last
    snapshot (step 4) and finishes: every request still in flight or
    queued at the snapshot ends with ``src``'s uninterrupted stream and is
    marked recovered, and the report holds every request."""
    ps = prompts(256, (6, 3, 9), 21)
    want = _serve(src, spec_len, ps)
    snap = str(tmp_path / "snaps")
    with pytest.raises(src.faults.InjectedCrash):
        _serve(src, spec_len, ps, crash_at=5, snap_dir=snap)
    cfg, params = setup(dst, "float32")
    eng = restore(dst, cfg, params, _f32_scfg(dst, spec_len), snap)
    assert eng.step_count == 4
    done = []
    _drive(eng, done)
    assert {r.rid for r in eng.report.requests} == set(want)
    assert eng._requests
    for rid, req in eng._requests.items():
        assert req.out_tokens == want[rid], rid
        assert eng.report.request(rid).recovered
