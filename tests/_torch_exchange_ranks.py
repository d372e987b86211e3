"""Rank bodies of the port's multi-rank exchange tests.

Each CPU rank joins a gloo group through a ``file://`` store (no port is
bound, so parallel test workers never collide), builds the shards of the
reference's four-host collective scenario (``tests/test_exchange.py``:
dyadic powers, host 2 idle, ragged region counts), keeps its own and
reduces over the mesh. Results go to ``<out>/rank<r>.pkl`` for the
parent to compare. Imports only numpy, torch and the port: every rank is
a fresh interpreter.
"""

import pickle

import numpy as np
import torch.distributed as dist

from repro_torch.core import exchange as ex
from repro_torch.core.streaming import (StreamingAggregator,
                                        StreamingCombinationAggregator)

HOSTS = 4
REGION_R = (8, 5, 8, 3)


def fleet_shards(pkg_agg, pkg_cagg):
    """The four hosts' (combination, region) shards, built with the given
    package's aggregator classes from one seeded stream."""
    rng = np.random.default_rng(0)

    def dyadic(n):
        return rng.integers(50 * 64, 200 * 64, n) / 64.0

    cshards = []
    for h in range(HOSTS):
        c = pkg_cagg()
        if h != 2:
            m = rng.integers(0, 5, (1500, 2)).astype(np.int64)
            c.update(m, dyadic(1500))
        cshards.append(c)
    rshards = []
    for R in REGION_R:
        ids = rng.integers(0, R, 2000).astype(np.int64)
        rshards.append(pkg_agg(R).update(ids, dyadic(2000)))
    return cshards, rshards


def key(agg):
    if hasattr(agg, "interner"):
        rows = [list(map(int, r)) for r in agg.interner.combos]
        inner = agg.agg
    else:
        rows, inner = None, agg
    return (rows, inner.counts.tolist(),
            [float(x).hex() for x in np.ravel(inner.chan_psum)],
            [float(x).hex() for x in np.ravel(inner.chan_psumsq)])


def _join(rank, root):
    dist.init_process_group("gloo", init_method=f"file://{root}/rendezvous",
                            rank=rank, world_size=HOSTS)
    from repro_torch.launch.mesh import make_exchange_mesh
    return make_exchange_mesh(device="cpu")


def collective_vs_checkpointed(rank, root):
    """Collective reduction of this rank's shard, and the checkpointed
    gather of every rank's spill, for both shard kinds."""
    mesh = _join(rank, root)
    try:
        cshards, rshards = fleet_shards(StreamingAggregator,
                                        StreamingCombinationAggregator)
        cap = max(len(c.interner) for c in cshards)
        out = {}
        out["combo"] = key(ex.collective_reduce(
            [cshards[rank]], mesh=mesh, capacity=cap, width=2))
        out["region"] = key(ex.collective_reduce(
            [rshards[rank]], mesh=mesh, capacity=max(REGION_R)))
        for kind, shards in (("combo", cshards), ("region", rshards)):
            ex.spill_shard(f"{root}/spill_{kind}", rank, 1, shards[rank])
        dist.barrier()
        for kind in ("combo", "region"):
            out[f"{kind}_ckpt"] = key(ex.gather_shards(
                f"{root}/spill_{kind}"))
        with open(f"{root}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def disagreeing_capacity(rank, root):
    """Every rank passes a different capacity: each must raise, none may
    wait on the payload collective."""
    mesh = _join(rank, root)
    try:
        cshards, rshards = fleet_shards(StreamingAggregator,
                                        StreamingCombinationAggregator)
        out = {}
        for kind, shard, cap in (("region", rshards[rank], 8 + rank),
                                 ("combo", cshards[rank], 64 + rank)):
            try:
                ex.collective_reduce([shard], mesh=mesh, capacity=cap,
                                     width=2)
                out[kind] = "reduced"
            except ValueError as e:
                out[kind] = str(e)
        with open(f"{root}/rank{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()
