"""Port parity: ``repro_torch.core.exchange`` against the JAX package's
``repro.core.exchange`` — the packed wire format, spills and gathers
across packages in both directions (schema v1 fixtures, v2 layouts,
delta chains, bounded v3 shards), the collective path over
``torch.distributed`` (one rank, and four gloo ranks on the CPU), the
profiler's ``exchange=`` and the exchange mesh. Counterparts of
``tests/test_exchange.py`` and ``tests/test_exchange_compat.py``."""

import json
import os
import pickle
import re
import shutil
import time
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.multiprocessing as mp

import _torch_exchange_ranks as ranks
from _torch_exchange_pkgs import (IDS, PKGS, PORT, REF, reference_x64,
                                  stats_key, table_equal)
from repro.core.power_model import POWER_DOMAINS
from repro_torch.core import exchange as ex
from repro_torch.launch.mesh import make_exchange_mesh

ROOT = Path(__file__).resolve().parents[1]
DATA = os.path.join(os.path.dirname(__file__), "data", "spill_v1")
CROSS = [(REF, PORT), (PORT, REF)]
CROSS_IDS = ["ref-to-port", "port-to-ref"]


@pytest.fixture
def world_of_one():
    """A test that builds the default (world of one) group tears it down."""
    had = dist.is_initialized()
    yield
    if not had and dist.is_initialized():
        dist.destroy_process_group()


def _dyadic_stream(n, R, seed, width=None):
    """(ids-or-matrix, powers) with powers exactly representable (k/64),
    so sums are bit-exact under any association order."""
    rng = np.random.default_rng(seed)
    pows = rng.integers(50 * 64, 200 * 64, n) / 64.0
    if width is None:
        return rng.integers(0, R, n).astype(np.int64), pows
    return rng.integers(0, R, (n, width)).astype(np.int64), pows


def _shard_equal(a, b):
    for f in ("counts", "psum", "psumsq", "combos"):
        x, y = getattr(a, f), getattr(b, f)
        assert (x is None) == (y is None), f
        if x is not None:
            assert x.dtype == y.dtype and x.tobytes() == y.tobytes(), f
    for f in ("n_rows", "domains", "k", "hash_range", "tail_folds",
              "evictions"):
        assert getattr(a, f) == getattr(b, f), f


def _tree_bytes(root):
    """{relative path: bytes}, the tmp nonce of any litter masked."""
    out = {}
    for dirpath, _dirs, files in os.walk(root):
        for name in files:
            fp = os.path.join(dirpath, name)
            rel = re.sub(r"\.tmp-[0-9a-f]+", ".tmp-*",
                         os.path.relpath(fp, root))
            with open(fp, "rb") as f:
                out[rel] = f.read()
    return out


# ---------------------------------------------------------------------------
# Packed wire format
# ---------------------------------------------------------------------------

def test_pack_unpack_roundtrip_region():
    ids, pows = _dyadic_stream(5000, 17, 0)
    shards = [ex_pkg.ex.pack_shard(ex_pkg.Agg(17).update(ids, pows),
                                   capacity=32) for ex_pkg in PKGS]
    _shard_equal(*shards)
    agg = PORT.Agg(17).update(ids, pows)
    back = ex.unpack_shard(shards[1])
    assert back.num_regions == 17
    assert stats_key(back) == stats_key(agg)


def test_pack_unpack_roundtrip_combination():
    mat, pows = _dyadic_stream(3000, 5, 1, width=3)
    shards = [p.ex.pack_shard(p.CAgg().update(mat, pows), capacity=256)
              for p in PKGS]
    _shard_equal(*shards)
    cagg = PORT.CAgg().update(mat, pows)
    back = ex.unpack_shard(shards[1])
    assert back.interner.combos == cagg.interner.combos
    assert stats_key(back) == stats_key(cagg)


@pytest.mark.parametrize("pkg", PKGS, ids=IDS)
def test_pack_capacity_too_small_raises(pkg):
    with pytest.raises(ValueError):
        pkg.ex.pack_shard(pkg.Agg(8), capacity=4)


# ---------------------------------------------------------------------------
# Checkpointed path: spill / restore / gather, across packages
# ---------------------------------------------------------------------------

def _host_shards(pkg, n_hosts, n=4000, R=6, width=2):
    """Disjoint per-host chunks of one logical stream + the single-host
    aggregator of the whole stream, in ``pkg``'s classes."""
    streams = [_dyadic_stream(n, R, seed=100 + h, width=width)
               for h in range(n_hosts)]
    shards = [pkg.CAgg().update(m, p) for m, p in streams]
    single = pkg.CAgg()
    for m, p in streams:
        single.update(m, p)
    return shards, single


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_gather_matches_single_host_bit_exact(tmp_path, writer, reader):
    """3 hosts spilled by one package, gathered by the other: equal to
    the single-host aggregator bit for bit, the spill the same bytes in
    both packages, and the estimates equal column for column."""
    for pkg in PKGS:
        shards, _ = _host_shards(pkg, 3)
        for h, s in enumerate(shards):
            pkg.ex.spill_shard(str(tmp_path / pkg.name), h, epoch=1, agg=s)
    assert (_tree_bytes(tmp_path / REF.name)
            == _tree_bytes(tmp_path / PORT.name))
    merged = reader.ex.gather_shards(str(tmp_path / writer.name))
    _, single = _host_shards(reader, 3)
    assert stats_key(merged) == stats_key(single)
    names = [f"r{i}" for i in range(6)]
    (est_r, combos_r), (est_p, combos_p) = (
        pkg.ex.gather_shards(str(tmp_path / writer.name)).estimates(2.0,
                                                                    names)
        for pkg in PKGS)
    assert combos_r == combos_p
    table_equal(est_p.table, est_r.table)


def test_gather_ignores_killed_host_partial_tmp(tmp_path):
    """A host that died mid-spill leaves only .tmp- litter: invisible to
    both packages' gathers."""
    shards, _ = _host_shards(PORT, 2)
    for h, s in enumerate(shards):
        ex.spill_shard(str(tmp_path), h, epoch=1, agg=s)
    dead = tmp_path / "host_0002" / "epoch_000000001.tmp-deadbeef"
    dead.mkdir(parents=True)
    (dead / "arr_00000.npy").write_bytes(b"\x93NUMPY partial garbage")
    (tmp_path / "host_0000" / "epoch_000000002.tmp-cafef00d").mkdir()
    for pkg in PKGS:
        assert pkg.ex.list_spilled_hosts(str(tmp_path)) == [0, 1]
    ref = PORT.CAgg()
    ref.merge(shards[0]).merge(shards[1])
    for pkg in PKGS:
        assert stats_key(pkg.ex.gather_shards(str(tmp_path))) == \
            stats_key(ref)


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_restore_shard_resume_and_restart_mid_run(tmp_path, writer, reader):
    """A host spills half its stream with one package, dies, restarts
    with the other package from its LATEST and replays the rest: the
    gather is bit-exact to the single-host pass."""
    d = str(tmp_path)
    shards, single = _host_shards(reader, 3)
    reader.ex.spill_shard(d, 0, epoch=1, agg=shards[0])
    reader.ex.spill_shard(d, 2, epoch=1, agg=shards[2])
    mat, pows = _dyadic_stream(4000, 6, seed=101, width=2)
    writer.ex.spill_shard(d, 1, epoch=1,
                          agg=writer.CAgg().update(mat[:2000], pows[:2000]))
    resumed, epoch = reader.ex.restore_shard(d, 1)
    assert epoch == 1
    resumed.update(mat[2000:], pows[2000:])
    reader.ex.spill_shard(d, 1, epoch=2, agg=resumed)
    for pkg in PKGS:
        assert stats_key(pkg.ex.gather_shards(d)) == stats_key(single)


def test_list_spilled_hosts_large_ids_numeric_order(tmp_path):
    ids, pows = _dyadic_stream(200, 3, 0)
    for h, pkg in zip((10000, 2, 9999), (PORT, REF, PORT)):
        pkg.ex.spill_shard(str(tmp_path), h, epoch=1,
                           agg=pkg.Agg(3).update(ids, pows))
    for pkg in PKGS:
        assert pkg.ex.list_spilled_hosts(str(tmp_path)) == [2, 9999, 10000]
        assert pkg.ex.gather_shards(str(tmp_path)).n_total == 3 * 200


def test_restore_shard_absent_host(tmp_path):
    assert ex.restore_shard(str(tmp_path), 7) is None
    with pytest.raises(FileNotFoundError):
        ex.gather_shards(str(tmp_path / "nothing"))
    with pytest.raises(PORT.faults.MissingArtifactError):
        ex.gather_shards(str(tmp_path / "nothing"))


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_spill_gather_region_shards(tmp_path, writer, reader):
    """Plain per-region shards with different region counts round-trip
    between the packages."""
    ref = reader.Agg(9)
    for h, R in enumerate((5, 9, 7)):
        ids, pows = _dyadic_stream(3000, R, seed=h)
        writer.ex.spill_shard(str(tmp_path), h, epoch=1,
                              agg=writer.Agg(R).update(ids, pows))
        ref.merge(reader.Agg(R).update(ids, pows))
    assert stats_key(reader.ex.gather_shards(str(tmp_path))) == \
        stats_key(ref)


def test_bounded_v3_shards_cross_packages(tmp_path):
    """Bounded (heavy-hitters) combination shards spill as schema v3 with
    the same bytes in both packages and gather equal in either."""
    mat, pows = _dyadic_stream(3000, 9, 5, width=2)
    for pkg in PKGS:
        for h in range(2):
            agg = pkg.CAgg(k=12).update(mat[h::2], pows[h::2])
            pkg.ex.spill_shard(str(tmp_path / pkg.name), h, 1, agg)
    assert (_tree_bytes(tmp_path / REF.name)
            == _tree_bytes(tmp_path / PORT.name))
    meta = ex.read_shard_meta(str(tmp_path / REF.name), 0)
    assert meta["schema_version"] == 3 and meta["k"] == 12
    keys = {stats_key(r.ex.gather_shards(str(tmp_path / w.name)))
            for w in PKGS for r in PKGS}
    assert len(keys) == 1


# ---------------------------------------------------------------------------
# Collective path
# ---------------------------------------------------------------------------

def test_collective_reduce_single_rank_identity(world_of_one):
    """World of one: the collective returns its input bit for bit, as the
    reference's one-device mesh does."""
    mat, pows = _dyadic_stream(2000, 4, 3, width=2)
    ids, rpows = _dyadic_stream(2000, 11, 4)
    got = {}
    for pkg in PKGS:
        cagg = pkg.CAgg().update(mat, pows)
        agg = pkg.Agg(11).update(ids, rpows)
        kw = {} if pkg is REF else {"device": "cpu"}
        with reference_x64():
            got[pkg.name] = (pkg.ex.collective_reduce([cagg], **kw),
                             pkg.ex.collective_reduce([agg], **kw))
        assert stats_key(got[pkg.name][0]) == stats_key(cagg)
        assert stats_key(got[pkg.name][1]) == stats_key(agg)
    for a, b in zip(got["ref"], got["port"]):
        assert stats_key(a) == stats_key(b)


def test_collective_reduce_several_local_shards(world_of_one):
    """One rank passing every host's shard (the reference's CI form):
    the port's rank-order merge equals the reference's tree reduction of
    the same shards (dyadic powers: any order gives the same bits)."""
    cshards, rshards = ranks.fleet_shards(PORT.Agg, PORT.CAgg)
    coll = ex.collective_reduce(cshards, device="cpu")
    coll_r = ex.collective_reduce(rshards, device="cpu")
    r_c, r_r = ranks.fleet_shards(REF.Agg, REF.CAgg)
    assert stats_key(coll) == stats_key(REF.ex.tree_reduce(r_c))
    assert stats_key(coll_r) == stats_key(REF.ex.tree_reduce(r_r))


def test_collective_reduce_refuses_mixed_shards(world_of_one):
    mat, pows = _dyadic_stream(300, 4, 9, width=2)
    ids, rpows = _dyadic_stream(300, 4, 9)
    a = PORT.CAgg().update(mat, pows)
    with pytest.raises(PORT.faults.SketchConfigError,
                       match="mixed bounded-state"):
        ex.collective_reduce([a, PORT.CAgg(k=8).update(mat, pows)],
                             device="cpu")
    with pytest.raises(ValueError, match="mixed shard kinds"):
        ex.collective_reduce([a, PORT.Agg(4).update(ids, rpows)],
                             capacity=64, device="cpu")
    d3 = PORT.Agg(4, domains=POWER_DOMAINS).update(
        ids, np.repeat(rpows[:, None], 3, axis=1))
    with pytest.raises(ValueError, match="domain axes"):
        ex.collective_reduce([PORT.Agg(4).update(ids, rpows), d3],
                             device="cpu")
    with pytest.raises(ValueError, match="worker-count"):
        ex.collective_reduce([a], width=3, device="cpu")
    # The idle host (width-0 table) pads to the fleet's width.
    got = ex.collective_reduce([PORT.CAgg(), a], device="cpu")
    assert stats_key(got) == stats_key(a)
    with pytest.raises(ValueError, match="no shards"):
        ex.collective_reduce([], device="cpu")


def _spawn(fn, root, timeout=90.0):
    """Run ``fn(rank, root)`` in four fresh CPU processes; fail (and
    stop them) if any raises or they outlive ``timeout``."""
    ctx = mp.spawn(fn, args=(str(root),), nprocs=ranks.HOSTS, join=False)
    deadline = time.monotonic() + timeout
    try:
        while not ctx.join(timeout=1.0):
            assert time.monotonic() < deadline, "ranks hung"
    finally:
        for p in ctx.processes:
            if p.is_alive():
                p.kill()
                p.join()
    return [pickle.loads((root / f"rank{r}.pkl").read_bytes())
            for r in range(ranks.HOSTS)]


@pytest.mark.timeout(120)
def test_collective_equals_checkpointed_4ranks(tmp_path):
    """Four gloo ranks: the collective equals the checkpointed gather bit
    for bit on every rank, for combination shards (host 2 idle) and
    region shards (ragged R), and both equal the reference's gather."""
    outs = _spawn(ranks.collective_vs_checkpointed, tmp_path)
    r_c, r_r = ranks.fleet_shards(REF.Agg, REF.CAgg)
    for kind, shards in (("combo", r_c), ("region", r_r)):
        d = tmp_path / f"ref_{kind}"
        for h, s in enumerate(shards):
            REF.ex.spill_shard(str(d), h, 1, s)
        want = ranks.key(REF.ex.gather_shards(str(d)))
        for out in outs:
            assert out[kind] == out[f"{kind}_ckpt"] == want, kind


@pytest.mark.timeout(120)
def test_collective_ranks_disagreeing_on_capacity_raise(tmp_path):
    outs = _spawn(ranks.disagreeing_capacity, tmp_path)
    for out in outs:
        for kind in ("region", "combo"):
            assert "disagree on the shard capacity" in out[kind], out


# ---------------------------------------------------------------------------
# Profiler wiring
# ---------------------------------------------------------------------------

def _timelines(pkg, steps=80):
    costs = [pkg.RegionCost("mem", flops=1e10, hbm_bytes=5e10,
                            invocations=4),
             pkg.RegionCost("alu", flops=6e11, hbm_bytes=2e9,
                            invocations=4)]
    return [pkg.synthesize(costs, steps=steps, seed=s) for s in (0, 1)]


def _exchange(pkg, kind, path):
    if kind == "checkpoint":
        return pkg.ex.CheckpointExchange(str(path), host_id=0)
    return pkg.ex.CollectiveExchange(
        **({} if pkg is REF else {"device": "cpu"}))


@pytest.mark.parametrize("kind", ["checkpoint", "collective"])
def test_profiler_exchange_matches_reference(tmp_path, kind, world_of_one):
    """``profile_multiworker_streaming(exchange=)`` equals the reference's
    column for column (host pipeline: the byte-equal numpy loop on both
    sides), and equals the port's own result without an exchange."""
    kw = dict(sensor="instant", chunk_size=256, pipeline="host")
    got = {}
    for pkg in PKGS:
        with reference_x64():
            got[pkg.name] = pkg.profiler(period=10e-3) \
                .profile_multiworker_streaming(
                    _timelines(pkg),
                    exchange=_exchange(pkg, kind, tmp_path / pkg.name),
                    **kw)
    (est_r, combos_r), (est_p, combos_p) = got["ref"], got["port"]
    assert combos_p == combos_r
    table_equal(est_p.table, est_r.table)
    alone, combos = PORT.profiler(period=10e-3) \
        .profile_multiworker_streaming(_timelines(PORT), **kw)
    assert combos == combos_p
    table_equal(est_p.table, alone.table)
    if kind == "checkpoint":
        assert (_tree_bytes(tmp_path / REF.name)
                == _tree_bytes(tmp_path / PORT.name))


@pytest.mark.parametrize("kind", ["checkpoint", "collective"])
def test_profiler_device_pipeline_exchange(tmp_path, kind, world_of_one):
    """The device pipeline (on the CPU) through either exchange equals the
    same run without one, bit for bit."""
    kw = dict(sensor="rapl", chunk_size=512, pipeline="device")
    prof = PORT.profiler(period=10e-3)
    alone, combos = prof.profile_multiworker_streaming(_timelines(PORT),
                                                       **kw)
    est, combos_ex = prof.profile_multiworker_streaming(
        _timelines(PORT), exchange=_exchange(PORT, kind, tmp_path), **kw)
    assert combos_ex == combos
    table_equal(est.table, alone.table)


def test_profiler_checkpoint_exchange_restart_idempotent(tmp_path):
    """A re-run against the same spill dir republishes; it must not merge
    its own previous spill on top (which would double every count) —
    and a port re-run over the reference's spill behaves the same."""
    kw = dict(sensor="instant", chunk_size=256, pipeline="host")
    est_ref, _ = REF.profiler(period=10e-3).profile_multiworker_streaming(
        _timelines(REF), **kw)
    REF.profiler(period=10e-3).profile_multiworker_streaming(
        _timelines(REF), exchange=REF.ex.CheckpointExchange(
            str(tmp_path), host_id=0), **kw)
    again, _ = PORT.profiler(period=10e-3).profile_multiworker_streaming(
        _timelines(PORT), exchange=ex.CheckpointExchange(
            str(tmp_path), host_id=0), **kw)
    assert ex.list_spilled_hosts(str(tmp_path)) == [0]
    assert again.n_total == est_ref.n_total
    table_equal(again.table, est_ref.table)
    assert ex.restore_shard(str(tmp_path), 0)[1] == 2


# ---------------------------------------------------------------------------
# Mesh and device rule
# ---------------------------------------------------------------------------

def test_make_exchange_mesh_on_the_cpu(world_of_one):
    mesh = make_exchange_mesh(device="cpu")
    assert mesh.device_type == "cpu"
    assert mesh.mesh_dim_names == ("hosts",)
    assert mesh.size() == 1
    assert dist.get_backend() == "gloo"
    with pytest.raises(ValueError, match="world"):
        make_exchange_mesh(2, device="cpu")


def test_collective_exchange_needs_the_gpu_unless_asked_for_the_cpu():
    assert ex.CollectiveExchange(device="cpu").device.type == "cpu"
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ex.CollectiveExchange()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_exchange_mesh()


# ---------------------------------------------------------------------------
# The numpy parts are the reference's text
# ---------------------------------------------------------------------------

def _sections(text):
    """The module minus its docstring, its imports, the collective
    section and ``CollectiveExchange``: the parts copied as they are."""
    lines = text.split("\n")

    def at(prefix):
        return next(i for i, ln in enumerate(lines) if ln.startswith(prefix))

    keep = (lines[at("__all__ = ["):at("# -- collective path")]
            + lines[at("# -- checkpointed path"):at("class CollectiveExchange")]
            + lines[at("class CheckpointExchange"):])
    return "\n".join(keep)


def test_exchange_numpy_parts_are_the_references():
    port = (ROOT / "src/repro_torch/core/exchange.py").read_text()
    ref = (ROOT / "src/repro/core/exchange.py").read_text()
    assert _sections(port).replace("repro_torch.", "repro.") == \
        _sections(ref)
    assert len(_sections(port).split("\n")) > 1200


# ---------------------------------------------------------------------------
# Wire-schema compatibility (counterparts of test_exchange_compat.py)
# ---------------------------------------------------------------------------

def _expected():
    with open(os.path.join(DATA, "expected.json")) as f:
        return json.load(f)


def _region_updates(host, epoch):
    rng = np.random.default_rng(1000 * host + epoch)
    return (rng.integers(0, 12, size=257),
            rng.uniform(50.0, 250.0, size=257))


def test_v1_region_dir_gathers_bit_exact():
    exp = _expected()["region"]
    g = ex.gather_shards(os.path.join(DATA, "region"))
    assert isinstance(g, PORT.Agg)
    assert g.domains == ("total",)
    assert g.counts.tolist() == exp["counts"]
    assert [float(x).hex() for x in g.psum] == exp["psum_hex"]
    assert [float(x).hex() for x in g.psumsq] == exp["psumsq_hex"]


def test_v1_combination_dir_gathers_bit_exact():
    exp = _expected()["combination"]
    g = ex.gather_shards(os.path.join(DATA, "combination"))
    assert isinstance(g, PORT.CAgg)
    assert g.agg.counts.tolist() == exp["counts"]
    assert [float(x).hex() for x in g.agg.psum] == exp["psum_hex"]
    assert [float(x).hex() for x in g.agg.psumsq] == exp["psumsq_hex"]
    assert g.interner.combo_matrix().tolist() == exp["combos"]


def test_v1_restore_shard_and_meta():
    agg, epoch = ex.restore_shard(os.path.join(DATA, "region"), 1)
    assert epoch == 4
    assert agg.domains == ("total",)
    r_agg, _ = REF.ex.restore_shard(os.path.join(DATA, "region"), 1)
    assert stats_key(agg) == stats_key(r_agg)
    meta = ex.read_shard_meta(os.path.join(DATA, "region"), 1)
    assert "domains" not in meta
    assert meta["kind"] == "region"


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_v1_hosts_mix_with_v2_delta_hosts(tmp_path, writer, reader):
    """Legacy v1 directories and a v2 delta-publishing host written by
    one package reduce under the other package's gather, bit-exactly
    equal to the same reduction tree over replayed streams."""
    root = tmp_path / "mixed"
    shutil.copytree(os.path.join(DATA, "region"), root)
    rng = np.random.default_rng(99)
    ids9 = rng.integers(0, 12, 400)
    pows9 = rng.uniform(40.0, 300.0, 400)
    new = writer.Agg(12)
    sp = writer.ex.ShardSpiller(str(root), 9, mode="delta", compact_every=16)
    new.update(ids9[:200], pows9[:200])
    sp.spill(new, 1)
    new.update(ids9[200:], pows9[200:])
    sp.spill(new, 2)
    merged = reader.ex.gather_shards(str(root))
    shards = []
    for host, epochs in [(0, 2), (1, 4), (2, 5)]:
        a = reader.Agg(12)
        for e in range(1, epochs + 1):
            a.update(*_region_updates(host, e))
        shards.append(a)
    shards.append(reader.Agg(12).update(ids9[:200], pows9[:200])
                  .update(ids9[200:], pows9[200:]))
    assert stats_key(merged) == stats_key(reader.ex.tree_reduce(shards))


def test_v2_single_domain_spill_keeps_v1_array_layout(tmp_path):
    """D=1 shards write the schema-v1 byte layout, the same bytes as the
    reference's spill."""
    rng = np.random.default_rng(3)
    ids, pows = rng.integers(0, 6, 100), rng.uniform(1, 9, 100)
    for pkg in PKGS:
        pkg.ex.spill_shard(str(tmp_path / pkg.name), 0, 1,
                           pkg.Agg(6).update(ids, pows))
    assert (_tree_bytes(tmp_path / REF.name)
            == _tree_bytes(tmp_path / PORT.name))
    d = str(tmp_path / PORT.name / "host_0000" / "epoch_000000001")
    arrays, manifest = PORT.ckpt.read_manifest_dir(d)
    named = dict(zip(manifest["schema"], arrays))
    assert named["psum"].ndim == 1
    assert manifest["schema_version"] == 2
    assert manifest["domains"] == ["total"]


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_v2_multi_domain_spill_roundtrip(tmp_path, writer, reader):
    rng = np.random.default_rng(4)
    ids, pows = rng.integers(0, 5, 300), rng.uniform(1, 9, (300, 3))
    agg = writer.Agg(5, domains=POWER_DOMAINS).update(ids, pows)
    writer.ex.spill_shard(str(tmp_path), 0, 1, agg)
    back, _ = reader.ex.restore_shard(str(tmp_path), 0)
    assert back.domains == POWER_DOMAINS
    assert stats_key(back) == stats_key(agg)
    other = writer.Agg(5).update(rng.integers(0, 5, 10),
                                 rng.uniform(1, 9, 10))
    writer.ex.spill_shard(str(tmp_path), 1, 1, other)
    with pytest.raises(ValueError, match="domain axis"):
        reader.ex.gather_shards(str(tmp_path))


@pytest.mark.parametrize("writer,reader", CROSS, ids=CROSS_IDS)
def test_v2_multi_domain_delta_chain(tmp_path, writer, reader):
    """Delta chains carry the channel axis across packages; fold == the
    live aggregator."""
    rng = np.random.default_rng(5)
    agg = writer.CAgg(domains=POWER_DOMAINS)
    sp = writer.ex.ShardSpiller(str(tmp_path), 0, mode="delta",
                                compact_every=16)
    for e in range(1, 5):
        agg.update(rng.integers(0, 4, (50, 2)).astype(np.int64),
                   rng.uniform(1, 9, (50, 3)))
        sp.spill(agg, e)
    back, epoch = reader.ex.restore_shard(str(tmp_path), 0)
    assert epoch == 4
    assert back.domains == POWER_DOMAINS
    assert stats_key(back) == stats_key(agg)


def test_spiller_uses_dirty_rows_not_snapshots(tmp_path):
    rng = np.random.default_rng(6)
    agg = PORT.Agg(1000)
    sp = ex.ShardSpiller(str(tmp_path), 0, mode="delta", compact_every=100)
    agg.update(rng.integers(0, 1000, 5000), rng.uniform(1, 9, 5000))
    sp.spill(agg, 1)
    assert sp._prev is None
    agg.update(np.array([7, 7, 42, 999]), np.array([1.0, 2.0, 3.0, 4.0]))
    sp.spill(agg, 2)
    hd = os.path.join(str(tmp_path), "host_0000")
    assert sorted(ex._load_delta(hd, 2).idx.tolist()) == [7, 42, 999]
    assert sorted(REF.ex._load_delta(hd, 2).idx.tolist()) == [7, 42, 999]
    assert sp._prev is None
    for pkg in PKGS:
        back, _ = pkg.ex.restore_shard(str(tmp_path), 0)
        assert stats_key(back) == stats_key(agg)


def test_dirty_rows_survive_failed_publish(tmp_path):
    rng = np.random.default_rng(7)
    agg = PORT.Agg(10)
    sp = ex.ShardSpiller(str(tmp_path), 0, mode="delta", compact_every=50)
    agg.update(rng.integers(0, 10, 100), rng.uniform(1, 9, 100))
    sp.spill(agg, 1)
    agg.update(np.array([3]), np.array([5.0]))
    with pytest.raises(ValueError):
        sp.spill(agg, 1)
    sp.spill(agg, 2)
    d = ex._load_delta(os.path.join(str(tmp_path), "host_0000"), 2)
    assert d.idx.tolist() == [3]
    back, _ = REF.ex.restore_shard(str(tmp_path), 0)
    assert np.array_equal(back.counts, agg.counts)


def test_two_spillers_share_one_aggregator(tmp_path):
    rng = np.random.default_rng(12)
    agg = PORT.Agg(50)
    sps = {sub: ex.ShardSpiller(str(tmp_path / sub), 0, mode="delta",
                                compact_every=50) for sub in ("a", "b")}
    agg.update(rng.integers(0, 50, 300), rng.uniform(1, 9, 300))
    for sp in sps.values():
        sp.spill(agg, 1)
    agg.update(np.array([7, 9]), np.array([1.0, 2.0]))
    for sp in sps.values():
        sp.spill(agg, 2)
    for sub in sps:
        d = ex._load_delta(os.path.join(str(tmp_path / sub), "host_0000"),
                           2)
        assert sorted(d.idx.tolist()) == [7, 9], sub
        back, _ = ex.restore_shard(str(tmp_path / sub), 0)
        assert stats_key(back) == stats_key(agg)


def test_restored_profiler_republish_is_still_empty_delta(tmp_path):
    """A port spiller restarting on a reference-written chain republishes
    an identical shard as an empty delta."""
    rng = np.random.default_rng(8)
    ids, pows = rng.integers(0, 8, 500), rng.uniform(1, 9, 500)
    a1 = REF.Agg(8).update(ids, pows)
    sp1 = REF.ex.ShardSpiller(str(tmp_path), 0, mode="delta",
                              compact_every=50)
    sp1.spill(a1, 1)
    sp1.spill(a1, 2)
    sp2 = ex.ShardSpiller(str(tmp_path), 0, mode="delta", compact_every=50)
    a2 = PORT.Agg(8).update(ids, pows)
    sp2.spill(a2, 3)
    d = ex._load_delta(os.path.join(str(tmp_path), "host_0000"), 3)
    assert d.idx.size == 0
    back, _ = REF.ex.restore_shard(str(tmp_path), 0)
    assert np.array_equal(back.counts, a2.counts)
