"""Port parity under fault injection: the exchange cases of
``tests/test_chaos.py`` and the corruption fuzz of
``tests/test_corruption_fuzz.py``, run on ``repro_torch.core.exchange``.
Every fault comes from a seeded ``FaultPlan``, so the port's fleet under
a plan writes the same bytes as the reference's under the same plan,
raises the same typed ``SpillError`` subclasses, and its quorum gathers
report the same provenance with bit-exact statistics."""

import contextlib
import hashlib
import os
import shutil

import numpy as np
import pytest

from _torch_exchange_pkgs import IDS, PKGS, PORT, REF, stats_key
from repro_torch.core import exchange as ex

pytestmark = pytest.mark.chaos

R = 12
DATA = os.path.join(os.path.dirname(__file__), "data", "spill_v1")
FIXTURE_EPOCHS = {0: 2, 1: 4, 2: 5}


def _updates(host, epoch):
    rng = np.random.default_rng(5000 * host + epoch)
    return rng.integers(0, R, size=137), rng.uniform(40.0, 260.0, size=137)


def _ref_agg(pkg, host, upto):
    agg = pkg.Agg(R)
    for e in range(1, upto + 1):
        agg.update(*_updates(host, e))
    return agg


def _drive_fleet(pkg, root, hosts, epochs, plan=None):
    """Each host accumulates + spills per epoch under ``plan``; a host
    that draws an InjectedCrash stops, a SpillError is ignored."""
    cm = (pkg.faults.install(plan) if plan is not None
          else contextlib.nullcontext())
    with cm:
        for h in hosts:
            agg = pkg.Agg(R)
            sp = pkg.ex.ShardSpiller(str(root), h, mode="delta",
                                     compact_every=16)
            for e in range(1, epochs + 1):
                agg.update(*_updates(h, e))
                try:
                    sp.spill(agg, e)
                except pkg.faults.InjectedCrash:
                    break
                except pkg.faults.SpillError:
                    pass


def _tree_digest(root):
    h = hashlib.sha256()
    for dirpath, dirnames, filenames in sorted(os.walk(root)):
        dirnames.sort()
        for name in sorted(filenames):
            fp = os.path.join(dirpath, name)
            h.update(os.path.relpath(fp, root).encode())
            with open(fp, "rb") as f:
                h.update(f.read())
    return h.hexdigest()


def _fleets(tmp_path, hosts, epochs, plan_of):
    """Each package drives the same fleet under its own copy of one plan,
    at the same path (a plan keys its faults by path), then the tree
    moves to ``tmp_path/<package>``."""
    for pkg in PKGS:
        _drive_fleet(pkg, tmp_path / "fleet", hosts, epochs, plan_of(pkg))
        os.rename(tmp_path / "fleet", tmp_path / pkg.name)


def _plan(pkg):
    f = pkg.faults
    return f.FaultPlan(
        seed=7, crashes=((1, 4),),
        leaf_faults=(f.LeafFault(match="host_0002/epoch_000000005/arr"),),
        stragglers=((3, 2),),
        dropouts=(f.ChannelDropout("hbm", 0.0, 1e9),))


def _reports(res):
    return [(r.host_id, r.status, r.epoch, r.requested_epoch,
             r.quarantined_epochs) for r in res.hosts]


# ---------------------------------------------------------------------------
# Typed failures at the spill read path, across packages.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("writer", PKGS, ids=IDS)
def test_disk_corruption_raises_typed_errors(tmp_path, writer):
    agg = writer.Agg(R)
    agg.update(*_updates(0, 1))
    writer.ex.spill_shard(str(tmp_path), 0, 1, agg)
    agg.update(*_updates(0, 2))
    writer.ex.spill_shard(str(tmp_path), 0, 2, agg)
    leaf = os.path.join(str(tmp_path), "host_0000", "epoch_000000002",
                        "arr_00000.npy")
    orig = open(leaf, "rb").read()
    bad = bytearray(orig)
    bad[len(bad) // 2] ^= 0x40
    for data, err in ((bytes(bad), "CorruptShardError"),
                      (orig[:4], "TornWriteError")):
        with open(leaf, "wb") as f:
            f.write(data)
        for reader in PKGS:
            with pytest.raises(getattr(reader.faults, err)):
                reader.ex.restore_shard(str(tmp_path), 0)
    f = PORT.faults
    for err in (f.CorruptShardError, f.TornWriteError, f.QuorumError):
        assert issubclass(err, f.SpillError)
    assert issubclass(ex.DeltaMismatchError, ValueError)
    assert not issubclass(f.InjectedCrash, f.SpillError)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_strict_gather_refuses_unreadable_latest(tmp_path, pkg):
    """A fleet spilled by either package: the port's strict gather
    refuses an unparseable LATEST, its quorum gather recovers it."""
    for h in (0, 1):
        agg = pkg.Agg(R)
        agg.update(*_updates(h, 1))
        pkg.ex.spill_shard(str(tmp_path), h, 1, agg)
    with open(os.path.join(str(tmp_path), "host_0001", "LATEST"), "w") as f:
        f.write("not-an-epoch")
    with pytest.raises(PORT.faults.CorruptShardError, match="LATEST"):
        ex.gather_shards(str(tmp_path))
    res = ex.gather_shards(str(tmp_path),
                           quorum=ex.QuorumPolicy(backoff=0.0))
    by = {r.host_id: r for r in res.hosts}
    assert by[1].status == "degraded" and by[1].epoch == 1
    assert stats_key(res.agg) == stats_key(ex.tree_reduce(
        [_ref_agg(PORT, 0, 1), _ref_agg(PORT, 1, 1)]))


def test_quorum_gather_acceptance_scenario(tmp_path):
    """4 hosts under 1 crash, 1 corrupt epoch, 1 straggler, 1 dropout:
    each package's fleet under the same plan writes the same bytes, and
    either package's quorum gather of either fleet reports the same
    provenance and bit-exact statistics."""
    _fleets(tmp_path, [0, 1, 2, 3], 5, _plan)
    assert _tree_digest(tmp_path / REF.name) == \
        _tree_digest(tmp_path / PORT.name)
    ref = ex.tree_reduce([_ref_agg(PORT, 0, 5), _ref_agg(PORT, 1, 3),
                          _ref_agg(PORT, 2, 4), _ref_agg(PORT, 3, 2)])
    seen = set()
    for writer in PKGS:
        for reader in PKGS:
            res = reader.ex.gather_shards(
                str(tmp_path / writer.name), quorum=reader.ex.QuorumPolicy(
                    expected_hosts=(0, 1, 2, 3), min_hosts=2, min_epoch=3,
                    backoff=0.0))
            assert stats_key(res.agg) == stats_key(ref)
            assert not res.complete
            seen.add(repr((_reports(res), res.coverage())))
    assert len(seen) == 1
    res = ex.gather_shards(str(tmp_path / REF.name), quorum=ex.QuorumPolicy(
        expected_hosts=(0, 1, 2, 3), min_hosts=2, min_epoch=3, backoff=0.0))
    assert _reports(res) == [(0, "merged", 5, 5, ()), (1, "merged", 3, 3, ()),
                             (2, "degraded", 4, 5, (5,)),
                             (3, "stale", 2, 2, ())]
    est = res.estimates(1.0, [f"r{i}" for i in range(R)])
    assert est.coverage["quarantined_epochs"] == {"2": [5]}
    with pytest.raises(PORT.faults.QuorumError):
        ex.gather_shards(str(tmp_path / PORT.name), quorum=ex.QuorumPolicy(
            expected_hosts=(0, 1, 2, 3, 7), min_hosts=5, backoff=0.0))


def test_fault_free_plan_reproduces_gather_byte_for_byte(tmp_path):
    trees = {}
    for pkg in PKGS:
        for sub, plan in (("a", None), ("b", pkg.faults.FaultPlan())):
            _drive_fleet(pkg, tmp_path / pkg.name / sub, [0, 1], 3, plan)
            trees[(pkg.name, sub)] = _tree_digest(tmp_path / pkg.name / sub)
    assert len(set(trees.values())) == 1
    ga = ex.gather_shards(str(tmp_path / REF.name / "a"))
    res = ex.gather_shards(str(tmp_path / PORT.name / "b"),
                           quorum=ex.QuorumPolicy(backoff=0.0))
    assert res.complete and res.coverage()["complete"]
    assert stats_key(res.agg) == stats_key(ga)


def test_watermarks_pin_monotone_host_epochs(tmp_path):
    _drive_fleet(REF, tmp_path, [0], 5)
    first = ex.gather_shards(str(tmp_path),
                             quorum=ex.QuorumPolicy(backoff=0.0))
    assert first.host_epochs == {0: 5}
    hd = os.path.join(str(tmp_path), "host_0000")
    for e in (4, 5):
        with open(os.path.join(hd, f"epoch_{e:09d}", "arr_00000.npy"),
                  "wb") as f:
            f.write(b"\x00")
    res = ex.gather_shards(str(tmp_path), quorum=ex.QuorumPolicy(
        watermarks=first.host_epochs, backoff=0.0))
    by = {r.host_id: r for r in res.hosts}
    assert by[0].status == "stale" and by[0].epoch == 3
    assert stats_key(res.agg) == stats_key(_ref_agg(PORT, 0, 3))
    with pytest.raises(PORT.faults.QuorumError):
        ex.gather_shards(str(tmp_path), quorum=ex.QuorumPolicy(
            watermarks=first.host_epochs, drop_stale=True, backoff=0.0))


def test_injected_spill_failures_and_crash_match_reference(tmp_path):
    """Transient spill failures and a crash drawn from one plan leave the
    same published epochs in both packages' fleets."""
    _fleets(tmp_path, [0, 1, 2], 6, lambda pkg: pkg.faults.FaultPlan(
        seed=11, crashes=((2, 3),), spill_failures=((0, 2), (1, 4))))
    assert _tree_digest(tmp_path / REF.name) == \
        _tree_digest(tmp_path / PORT.name)
    assert ex.list_spilled_hosts(str(tmp_path / PORT.name)) == [0, 1, 2]


# ---------------------------------------------------------------------------
# Corruption fuzz (counterparts of test_corruption_fuzz.py)
# ---------------------------------------------------------------------------

def _fixture_updates(host, epoch):
    rng = np.random.default_rng(1000 * host + epoch)
    return rng.integers(0, R, size=257), rng.uniform(50.0, 250.0, size=257)


def _fresh_updates(host, epoch):
    rng = np.random.default_rng(300 * host + epoch)
    return rng.integers(0, R, size=111), rng.uniform(30.0, 280.0, size=111)


def _replay(updates, host, upto):
    agg = PORT.Agg(R)
    for e in range(1, upto + 1):
        agg.update(*updates(host, e))
    return agg


def _reduce_key(updates, epochs_by_host):
    return stats_key(ex.tree_reduce(
        [_replay(updates, h, e)
         for h, e in sorted(epochs_by_host.items()) if e > 0]))


def _allowed_strict_keys(updates, epochs_by_host, vary_host):
    allowed = set()
    for e in range(1, epochs_by_host[vary_host] + 1):
        eb = dict(epochs_by_host)
        eb[vary_host] = e
        allowed.add(_reduce_key(updates, eb))
    return allowed


def _corrupt_file(path, kind, salt):
    with open(path, "rb") as f:
        data = bytearray(f.read())
    h = int.from_bytes(
        hashlib.sha256(f"{os.path.basename(path)}:{salt}".encode())
        .digest()[:8], "big")
    if kind == "bitflip":
        bit = h % (len(data) * 8)
        data[bit // 8] ^= 1 << (bit % 8)
    else:
        data = data[: h % len(data)]
    with open(path, "wb") as f:
        f.write(bytes(data))


def _check_strict(root, allowed):
    """Both packages' strict gathers: the same typed failure, or the same
    member of the valid-state set."""
    out = []
    for pkg in PKGS:
        try:
            g = pkg.ex.gather_shards(root)
        except pkg.faults.SpillError as e:
            out.append(("raised", type(e).__name__))
            continue
        assert stats_key(g) in allowed, "silently-wrong statistics"
        out.append(("valid", stats_key(g)))
    assert out[0] == out[1]
    return out[1][0]


def _check_quorum(root, updates, roster):
    """Both packages' quorum gathers: the same provenance, statistics
    bit-exact to a replay of exactly the epochs reported."""
    results = [pkg.ex.gather_shards(root, quorum=pkg.ex.QuorumPolicy(
        expected_hosts=roster, min_hosts=1, backoff=0.0)) for pkg in PKGS]
    assert _reports(results[0]) == _reports(results[1])
    res = results[1]
    shards, short = [], False
    for rep in sorted(res.hosts, key=lambda r: r.host_id):
        if rep.epoch is None:
            assert rep.status != "merged"
            short = True
            continue
        if rep.requested_epoch is not None and \
                rep.epoch < rep.requested_epoch:
            assert rep.status != "merged"
            short = True
        shards.append(_replay(updates, rep.host_id, rep.epoch))
    assert shards
    want = stats_key(ex.tree_reduce(shards))
    assert stats_key(res.agg) == want == stats_key(results[0].agg)
    if short:
        assert not res.complete
    return res


FIXTURE_TARGETS = [
    ("delta-manifest", 1, "host_0001/epoch_000000004/manifest.json"),
    ("leaf", 1, "host_0001/epoch_000000004/arr_00001.npy"),
    ("latest", 1, "host_0001/LATEST"),
]


@pytest.mark.parametrize("kind", ["bitflip", "truncate"])
@pytest.mark.parametrize("cls,host,rel", FIXTURE_TARGETS,
                         ids=[t[0] for t in FIXTURE_TARGETS])
def test_fixture_tree_corruption(tmp_path, cls, host, rel, kind):
    allowed = _allowed_strict_keys(_fixture_updates, FIXTURE_EPOCHS, host)
    for salt in range(2):
        root = tmp_path / f"{kind}-{salt}"
        shutil.copytree(os.path.join(DATA, "region"), root)
        _corrupt_file(str(root / rel), kind, salt)
        _check_strict(str(root), allowed)
        _check_quorum(str(root), _fixture_updates, tuple(FIXTURE_EPOCHS))


def _write_fresh_tree(pkg, root):
    """A v2 tree: host 0 publishes full shards, host 1 a delta chain."""
    epochs = {}
    for host, mode, last in ((0, "full", 3), (1, "delta", 4)):
        agg = pkg.Agg(R)
        sp = pkg.ex.ShardSpiller(str(root), host, mode=mode,
                                 compact_every=16)
        for e in range(1, last + 1):
            agg.update(*_fresh_updates(host, e))
            sp.spill(agg, e)
        epochs[host] = last
    return epochs


FRESH_TARGETS = [
    ("full-manifest", 0, "host_0000/epoch_000000003/manifest.json"),
    ("delta-leaf", 1, "host_0001/epoch_000000004/arr_00002.npy"),
    ("latest", 1, "host_0001/LATEST"),
]


@pytest.mark.parametrize("kind", ["bitflip", "truncate"])
@pytest.mark.parametrize("cls,host,rel", FRESH_TARGETS,
                         ids=[t[0] for t in FRESH_TARGETS])
def test_port_tree_corruption(tmp_path, cls, host, rel, kind):
    """A tree the port wrote, corrupted on disk: both packages agree."""
    for salt in range(2):
        root = tmp_path / f"{kind}-{salt}"
        epochs = _write_fresh_tree(PORT, root)
        allowed = _allowed_strict_keys(_fresh_updates, epochs, host)
        _corrupt_file(str(root / rel), kind, salt)
        _check_strict(str(root), allowed)
        _check_quorum(str(root), _fresh_updates, tuple(epochs))


def test_uncorrupted_trees_pass_both_checks(tmp_path):
    fix = {_reduce_key(_fixture_updates, FIXTURE_EPOCHS)}
    assert _check_strict(os.path.join(DATA, "region"), fix) == "valid"
    assert _check_quorum(os.path.join(DATA, "region"), _fixture_updates,
                         tuple(FIXTURE_EPOCHS)).complete
    epochs = _write_fresh_tree(PORT, tmp_path)
    allowed = {_reduce_key(_fresh_updates, epochs)}
    assert _check_strict(str(tmp_path), allowed) == "valid"
    assert _check_quorum(str(tmp_path), _fresh_updates,
                         tuple(epochs)).complete


def test_every_host_corrupt_is_a_typed_quorum_failure(tmp_path):
    _write_fresh_tree(PORT, tmp_path)
    for dirpath, _dirnames, filenames in os.walk(tmp_path):
        for name in filenames:
            if name.startswith("arr_") or name == "manifest.json":
                _corrupt_file(os.path.join(dirpath, name), "truncate", 0)
    for pkg in PKGS:
        with pytest.raises((pkg.faults.QuorumError, pkg.faults.SpillError)):
            pkg.ex.gather_shards(str(tmp_path), quorum=pkg.ex.QuorumPolicy(
                expected_hosts=(0, 1), min_hosts=1, backoff=0.0))
