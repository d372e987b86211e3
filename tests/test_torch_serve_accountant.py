"""Port parity: ``repro_torch.serve.engine.PhaseEnergyAccountant`` —
the counterparts of the reference's accountant tests
(``tests/test_exchange.py:323``, ``tests/test_delta_spill.py:252`` and
``:281``, ``tests/test_chaos.py:461``, ``:481`` and ``:494``,
``tests/test_streaming.py:275``) on the port, and shards that cross
between the packages: one spilled by either package's accountant is read
by the other's ``gather_shards`` and ``restore_shard`` bit for bit, and
an accountant of either package resumes from the other's spills.

The cross-package cases feed both accountants the same deterministic
sample stream through a stub sampler; the others sample wall time, as
the reference's do.
"""

import time

import numpy as np
import pytest

from _torch_exchange_pkgs import stats_key
from _torch_serve_pkgs import PORT, REF
from repro_torch.core import exchange as ex
from repro_torch.core import regions as regions_mod
from repro_torch.core.faults import FaultPlan, InjectedCrash, SpillError
from repro_torch.serve.engine import PhaseEnergyAccountant

CROSS = [(REF, PORT), (PORT, REF)]
CROSS_IDS = ["ref-to-port", "port-to-ref"]


def _busy(seconds, name="serve/busy"):
    with regions_mod.region(name):
        t0 = time.monotonic()
        while time.monotonic() - t0 < seconds:
            pass


# -- counterparts of the reference's accountant tests -----------------------------

def test_accountant_periodic_spill(tmp_path):
    acct = PhaseEnergyAccountant(period=1e-3, jitter=1e-4,
                                 spill_dir=str(tmp_path), host_id=3,
                                 spill_every=5)
    with acct:
        for _ in range(12):
            _busy(2e-3)
            acct.drain()
    assert ex.list_spilled_hosts(str(tmp_path)) == [3]
    restored, epoch = ex.restore_shard(str(tmp_path), 3)
    assert epoch >= 10
    assert np.array_equal(restored.counts[:acct.agg.num_regions]
                          [:restored.num_regions],
                          acct.agg.counts[:restored.num_regions])
    if acct.agg.n_total:
        est = PhaseEnergyAccountant.gather_estimates(
            str(tmp_path), acct.sampler.elapsed)
        assert est.n_total == acct.agg.n_total


def test_accountant_exit_publishes_each_epoch_once(tmp_path):
    acct = PhaseEnergyAccountant(period=1e-3, jitter=1e-4,
                                 spill_dir=str(tmp_path), host_id=0,
                                 spill_every=1)
    published = []
    orig = acct._spiller.spill

    def counting_spill(agg, epoch, extra_meta=None):
        published.append(epoch)
        return orig(agg, epoch, extra_meta=extra_meta)
    acct._spiller.spill = counting_spill

    with acct:
        for _ in range(3):
            _busy(2e-3)
            acct.drain()
    assert len(published) == len(set(published))
    assert ex.restore_shard(str(tmp_path), 0)[1] == max(published)


def test_accountant_delta_restart_resume(tmp_path):
    acct = PhaseEnergyAccountant(period=1e-3, jitter=1e-4,
                                 spill_dir=str(tmp_path), host_id=1,
                                 spill_every=2, compact_every=3)
    with acct:
        for _ in range(7):
            _busy(2e-3)
            acct.drain()
    restored, epoch = ex.restore_shard(str(tmp_path), 1)
    assert np.array_equal(restored.counts[:acct.agg.num_regions],
                          acct.agg.counts[:restored.num_regions])
    acct2 = PhaseEnergyAccountant(period=1e-3, jitter=1e-4,
                                  spill_dir=str(tmp_path), host_id=1,
                                  spill_every=2, compact_every=3)
    assert acct2.agg.n_total == acct.agg.n_total
    assert acct2._epoch == epoch
    assert acct2._elapsed_offset == pytest.approx(acct.elapsed)


def test_accountant_retries_then_counts_drop(tmp_path):
    plan = FaultPlan(spill_failures=((0, 1), (0, 2), (0, 3)))
    acct = PhaseEnergyAccountant(period=1e-3, spill_dir=str(tmp_path),
                                 spill_every=1, spill_retries=3,
                                 faults=plan)
    with acct:
        for _ in range(4):
            _busy(2e-3, "chaos/serve")
            acct.drain()
    assert acct.spill_failures == 3
    assert acct.spill_drops == 1
    assert isinstance(acct.last_spill_error, SpillError)
    restored, epoch = ex.restore_shard(str(tmp_path), 0)
    assert epoch == acct._epoch
    assert np.array_equal(restored.counts, acct.agg.counts)
    assert np.array_equal(restored.chan_psum, acct.agg.chan_psum)


def test_accountant_exit_raises_when_it_cannot_publish(tmp_path):
    plan = FaultPlan(spill_failures=tuple((0, e) for e in range(1, 64)))
    acct = PhaseEnergyAccountant(period=1e-3, spill_dir=str(tmp_path),
                                 spill_every=0, spill_retries=2,
                                 faults=plan)
    with pytest.raises(SpillError):
        with acct:
            _busy(2e-3, "chaos/serve")
            acct.drain()
    assert acct.spill_failures >= 1


def test_accountant_never_catches_injected_crash(tmp_path):
    plan = FaultPlan(crashes=((0, 1),))
    acct = PhaseEnergyAccountant(period=1e-3, spill_dir=str(tmp_path),
                                 spill_every=1, faults=plan)
    with pytest.raises(InjectedCrash):
        with acct:
            _busy(2e-3, "chaos/serve")
            acct.drain()
    assert acct.spill_failures == 0


def test_phase_energy_accountant_streams_host_samples():
    acct = PhaseEnergyAccountant(period=1e-3, jitter=1e-4)
    with acct:
        for _ in range(120):
            _busy(2e-3)
            acct.drain()
            with regions_mod.region("serve/idle"):
                time.sleep(0.5e-3)
    assert acct.agg.n_total >= 5
    est = acct.estimates()
    assert "serve/busy" in {r.name for r in est.regions}
    assert est.by_name()["serve/busy"].p_hat > 0.1


# -- shards across packages ---------------------------------------------------------

class _StubSampler:
    """A sampler that hands out a fixed stream, one epoch per drain."""

    def __init__(self, epochs):
        self.period = 1e-3
        self.elapsed = 0.0
        self.buffer_overruns = 0
        self._epochs = list(epochs)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return None

    def drain(self):
        if self._epochs:
            rids, pows, self.elapsed = self._epochs.pop(0)
            return rids, pows
        return np.empty(0, np.int64), np.empty(0)


def _epochs(pkg, n=7, seed=0):
    """``n`` epochs of (ids, powers, elapsed) over three serving phases
    interned in ``pkg``'s registry; powers are multiples of 1/64, so sums
    are exact in any order."""
    ids = np.asarray([pkg.regions.registry.intern(p) for p in
                      ("serve/prefill", "serve/decode", "serve/verify")])
    rng = np.random.default_rng(seed)
    out = []
    for e in range(n):
        m = int(rng.integers(20, 60))
        out.append((ids[rng.integers(0, 3, m)],
                    rng.integers(50 * 64, 200 * 64, m) / 64.0,
                    0.05 * (e + 1)))
    return out


def _spill_run(pkg, path, host_id, n=7, seed=0):
    acct = pkg.engine.PhaseEnergyAccountant(
        spill_dir=str(path), host_id=host_id, spill_every=2,
        compact_every=3, track_requests=True)
    acct.sampler = _StubSampler(_epochs(pkg, n, seed))
    with acct:
        for e in range(n):
            acct.drain(active_requests=(e % 3, 5))
    return acct


@pytest.mark.parametrize("src,dst", CROSS, ids=CROSS_IDS)
def test_accountant_shards_cross_packages(src, dst, tmp_path):
    """A fleet of two hosts spilled by ``src``'s accountants gathers in
    ``dst`` to the same statistics as in ``src``; each host's shard
    restores in ``dst`` bit for bit."""
    accts = [_spill_run(src, tmp_path, h, seed=h) for h in (0, 1)]
    for h, acct in enumerate(accts):
        got, epoch = dst.ex.restore_shard(str(tmp_path), h)
        want, want_epoch = src.ex.restore_shard(str(tmp_path), h)
        assert epoch == want_epoch == acct.epoch
        assert stats_key(got) == stats_key(want)
        n = acct.agg.num_regions
        assert np.array_equal(got.counts[:n], acct.agg.counts)
        assert np.array_equal(got.chan_psum[:n], acct.agg.chan_psum)
    assert stats_key(dst.ex.gather_shards(str(tmp_path))) == \
        stats_key(src.ex.gather_shards(str(tmp_path)))


@pytest.mark.parametrize("src,dst", CROSS, ids=CROSS_IDS)
def test_accountant_resumes_from_the_other_packages_spills(src, dst,
                                                           tmp_path):
    """Restart-and-rejoin across packages: ``dst``'s accountant on
    ``src``'s spill directory resumes its statistics, epoch and elapsed
    time, and its next publish extends the chain."""
    first = _spill_run(src, tmp_path, 4)
    again = dst.engine.PhaseEnergyAccountant(
        spill_dir=str(tmp_path), host_id=4, spill_every=1)
    assert again.epoch == first.epoch
    assert again.agg.n_total == first.agg.n_total
    n = first.agg.num_regions
    assert np.array_equal(again.agg.counts[:n], first.agg.counts)
    assert np.array_equal(again.agg.chan_psum[:n], first.agg.chan_psum)
    assert again._elapsed_offset == first.elapsed
    again.sampler = _StubSampler(_epochs(dst, 1, seed=9))
    with again:
        again.drain()
    restored, epoch = src.ex.restore_shard(str(tmp_path), 4)
    assert epoch == again.epoch == first.epoch + 2    # drain, exit drain
    assert stats_key(restored) == stats_key(
        dst.ex.restore_shard(str(tmp_path), 4)[0])
    assert int(restored.counts.sum()) == again.agg.n_total
