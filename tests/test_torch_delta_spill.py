"""Port parity: incremental (delta) spills and compaction in
``repro_torch.core.exchange`` against the JAX package's — chain folds,
crash/restart stories, mixed full/delta gathers and the profiler's
delta-mode restart, with chains written by one package and read by the
other. Counterparts of ``tests/test_delta_spill.py``."""

import os
import shutil

import numpy as np
import pytest

from _torch_exchange_pkgs import IDS, PKGS, PORT, REF, stats_key, table_equal
from repro_torch.core import exchange as ex

CROSS = [(REF, PORT), (PORT, REF)]
CROSS_IDS = ["ref-to-port", "port-to-ref"]


def _dyadic(rng, n):
    """Powers exactly representable (k/64): sums bit-exact under any
    association order."""
    return rng.integers(50 * 64, 200 * 64, n) / 64.0


def _epoch_dirs(path, host_id):
    hd = os.path.join(path, f"host_{host_id:04d}")
    return sorted(n for n in os.listdir(hd) if n.startswith("epoch_")
                  and ".tmp" not in n)


def _dir_bytes(root):
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            fp = os.path.join(dirpath, name)
            with open(fp, "rb") as f:
                out[os.path.relpath(fp, root)] = f.read()
    return out


def _delta_equal(a, b):
    for f in ("idx", "counts", "psum", "psumsq", "combos_new"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    assert (a.n_rows, a.prev_rows, a.domains) == \
        (b.n_rows, b.prev_rows, b.domains)


# ---------------------------------------------------------------------------
# Delta primitives
# ---------------------------------------------------------------------------

def test_compute_apply_roundtrip_combination():
    deltas = []
    for pkg in PKGS:
        rng = np.random.default_rng(0)
        agg = pkg.CAgg()
        agg.update(rng.integers(0, 4, (500, 2)).astype(np.int64),
                   _dyadic(rng, 500))
        prev = pkg.ex._copy_shard(pkg.ex.pack_shard(agg))
        agg.update(rng.integers(0, 6, (300, 2)).astype(np.int64),
                   _dyadic(rng, 300))
        cur = pkg.ex.pack_shard(agg)
        delta = pkg.ex.compute_shard_delta(prev, cur)
        assert delta.n_rows == cur.n_rows and delta.prev_rows == prev.n_rows
        back = pkg.ex.apply_shard_delta(prev, delta)
        assert np.array_equal(back.counts, cur.counts[:cur.n_rows])
        assert np.array_equal(back.psum, cur.psum[:cur.n_rows])
        assert np.array_equal(back.psumsq, cur.psumsq[:cur.n_rows])
        assert np.array_equal(back.combos, cur.combos[:cur.n_rows])
        deltas.append(delta)
    _delta_equal(*deltas)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_apply_rejects_chain_mismatch(pkg):
    rng = np.random.default_rng(1)
    a = pkg.Agg(4).update(rng.integers(0, 4, 100).astype(np.int64),
                          _dyadic(rng, 100))
    s0 = pkg.ex._copy_shard(pkg.ex.pack_shard(a))
    a.update(rng.integers(0, 4, 100).astype(np.int64), _dyadic(rng, 100))
    delta = pkg.ex.compute_shard_delta(s0, pkg.ex.pack_shard(a))
    wrong = pkg.ex.PackedShard(counts=np.zeros(7, np.int64),
                               psum=np.zeros(7), psumsq=np.zeros(7),
                               n_rows=7)
    with pytest.raises(IOError, match="chain mismatch"):
        pkg.ex.apply_shard_delta(wrong, delta)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_compute_delta_rejects_non_append_only(pkg):
    rng = np.random.default_rng(2)
    a = pkg.CAgg().update(rng.integers(0, 3, (50, 2)).astype(np.int64),
                          _dyadic(rng, 50))
    b = pkg.CAgg().update(rng.integers(3, 6, (50, 2)).astype(np.int64),
                          _dyadic(rng, 50))
    with pytest.raises(pkg.faults.DeltaMismatchError):
        pkg.ex.compute_shard_delta(pkg.ex.pack_shard(a),
                                   pkg.ex.pack_shard(b))


# ---------------------------------------------------------------------------
# Spiller: chains, compaction, GC
# ---------------------------------------------------------------------------

def _drive(pkg, root, hosts, epochs, modes, compact_every, seed, full=None):
    """Each host accumulates and spills every epoch; returns the live
    aggregators. ``full`` also full-spills every epoch there."""
    rng = np.random.default_rng(seed)
    aggs = []
    for h in range(hosts):
        sp = pkg.ex.ShardSpiller(str(root), h, mode=modes[h],
                                 compact_every=compact_every)
        agg = pkg.CAgg()
        for e in range(1, epochs + 1):
            agg.update(rng.integers(0, 5, (40, 2)).astype(np.int64),
                       _dyadic(rng, 40))
            sp.spill(agg, e)
            if full is not None:
                pkg.ex.spill_shard(str(full), h, e, agg)
        aggs.append(agg)
    return aggs


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_delta_gather_bit_exact_vs_full_4hosts(tmp_path, writer, reader):
    """A delta-spilled 4-host run written by one package gathers in the
    other bit-exactly vs the same run's full spills, and both packages
    write the same bytes."""
    for pkg in PKGS:
        _drive(pkg, tmp_path / pkg.name / "delta", 4, 20, ["delta"] * 4, 6,
               3, full=tmp_path / pkg.name / "full")
    assert (_dir_bytes(tmp_path / REF.name)
            == _dir_bytes(tmp_path / PORT.name))
    ga = reader.ex.gather_shards(str(tmp_path / writer.name / "delta"))
    gb = reader.ex.gather_shards(str(tmp_path / writer.name / "full"))
    assert stats_key(ga) == stats_key(gb)


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_mixed_full_and_delta_hosts_gather(tmp_path, writer, reader):
    aggs = _drive(writer, tmp_path, 3, 7, ("full", "delta", "delta"), 4, 4)
    ref = reader.CAgg()
    for a in aggs:
        ref.merge(a)
    assert stats_key(reader.ex.gather_shards(str(tmp_path))) == \
        stats_key(ref)


def test_compaction_gc_keeps_directory_bounded(tmp_path):
    for pkg in PKGS:
        rng = np.random.default_rng(5)
        root = str(tmp_path / pkg.name)
        sp = pkg.ex.ShardSpiller(root, 0, mode="delta", compact_every=5)
        agg = pkg.Agg(6)
        for e in range(1, 26):
            agg.update(rng.integers(0, 6, 20).astype(np.int64),
                       _dyadic(rng, 20))
            sp.spill(agg, e)
            assert len(_epoch_dirs(root, 0)) <= 5
        restored, epoch = ex.restore_shard(root, 0)
        assert epoch == 25
        assert stats_key(restored) == stats_key(agg)
    assert _epoch_dirs(str(tmp_path / REF.name), 0) == \
        _epoch_dirs(str(tmp_path / PORT.name), 0)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_killed_host_mid_delta_leaves_only_tmp_litter(tmp_path, pkg):
    """A writer of either package killed mid-delta leaves a ``.tmp-``
    dir; the port's readers ignore it and fold the intact chain."""
    rng = np.random.default_rng(6)
    sp = pkg.ex.ShardSpiller(str(tmp_path), 0, mode="delta",
                             compact_every=10)
    agg = pkg.CAgg()
    for e in range(1, 4):
        agg.update(rng.integers(0, 4, (25, 2)).astype(np.int64),
                   _dyadic(rng, 25))
        sp.spill(agg, e)
    dead = tmp_path / "host_0000" / "epoch_000000004.tmp-deadbeef"
    dead.mkdir()
    (dead / "arr_00000.npy").write_bytes(b"\x93NUMPY partial")
    restored, epoch = ex.restore_shard(str(tmp_path), 0)
    assert epoch == 3
    assert stats_key(restored) == stats_key(agg)
    assert stats_key(ex.gather_shards(str(tmp_path))) == stats_key(agg)


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_crash_between_delta_and_compaction_no_double_count(tmp_path, writer,
                                                            reader):
    """A host of one package killed between a delta publish and its
    compaction restarts as the other package from the on-disk chain and
    re-gathers without double-counting."""
    rng = np.random.default_rng(7)
    chunks = [(rng.integers(0, 5, (30, 2)).astype(np.int64),
               _dyadic(rng, 30)) for _ in range(10)]
    sp = writer.ex.ShardSpiller(str(tmp_path), 0, mode="delta",
                                compact_every=4)
    agg = writer.CAgg()
    for e in range(1, 7):
        agg.update(*chunks[e - 1])
        sp.spill(agg, e)
    del sp
    sp2 = reader.ex.ShardSpiller(str(tmp_path), 0, mode="delta",
                                 compact_every=4)
    assert sp2.epoch == 6
    agg2 = reader.CAgg().merge(sp2.resumed)
    for e in range(7, 11):
        agg2.update(*chunks[e - 1])
        sp2.spill(agg2, e)
    ref = reader.CAgg()
    for mat, pows in chunks:
        ref.update(mat, pows)
    for pkg in PKGS:
        assert stats_key(pkg.ex.gather_shards(str(tmp_path))) == \
            stats_key(ref)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_broken_chain_raises(tmp_path, pkg):
    rng = np.random.default_rng(8)
    sp = pkg.ex.ShardSpiller(str(tmp_path), 0, mode="delta",
                             compact_every=99)
    agg = pkg.Agg(4)
    for e in range(1, 5):
        agg.update(rng.integers(0, 4, 10).astype(np.int64),
                   _dyadic(rng, 10))
        sp.spill(agg, e)
    shutil.rmtree(tmp_path / "host_0000" / "epoch_000000002")
    for reader in PKGS:
        with pytest.raises(IOError, match="chain"):
            reader.ex.restore_shard(str(tmp_path), 0)


# ---------------------------------------------------------------------------
# Profiler wiring
# ---------------------------------------------------------------------------

def _timelines(pkg):
    costs = [pkg.RegionCost("mem", flops=1e10, hbm_bytes=5e10,
                            invocations=4),
             pkg.RegionCost("alu", flops=6e11, hbm_bytes=2e9,
                            invocations=4)]
    return [pkg.synthesize(costs, steps=60, seed=s) for s in (0, 1)]


@pytest.mark.parametrize("pipeline", ["host", "device"])
def test_profiler_delta_exchange_restart_idempotent(tmp_path, pipeline):
    """A deterministic profiler re-run against the same delta spill dir
    republishes as an (empty) delta epoch — same estimates, no
    double-counting; on the host pipeline, the reference's estimates."""
    kw = dict(sensor="instant", chunk_size=256, pipeline=pipeline)
    prof = PORT.profiler(period=10e-3)
    est_ref, combos_ref = prof.profile_multiworker_streaming(
        _timelines(PORT), **kw)
    for _ in range(2):
        est, combos = prof.profile_multiworker_streaming(
            _timelines(PORT), exchange=ex.CheckpointExchange(
                str(tmp_path), host_id=0, mode="delta"), **kw)
        assert combos == combos_ref
        assert est.n_total == est_ref.n_total
        table_equal(est.table, est_ref.table)
    restored, epoch = ex.restore_shard(str(tmp_path), 0)
    assert epoch == 2
    assert ex._load_delta(os.path.join(str(tmp_path), "host_0000"),
                          2).idx.size == 0
    if pipeline == "host":
        want, want_combos = REF.profiler(period=10e-3) \
            .profile_multiworker_streaming(_timelines(REF), **kw)
        assert combos_ref == want_combos
        table_equal(est_ref.table, want.table)
