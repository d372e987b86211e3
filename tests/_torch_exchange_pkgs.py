"""The exchange surface of both packages side by side, for the port's
exchange, spill, chaos and checkpoint tests (``tests/test_torch_*.py``).

``REF`` and ``PORT`` hold the same names — ``ex``, ``ckpt``, ``faults``,
the aggregators, ``synthesize`` — so a scenario written once runs on
either package, and its results are compared bit for bit.
"""

import contextlib
import types

import numpy as np

from repro.checkpoint import ckpt as r_ckpt
from repro.core import exchange as r_ex
from repro.core import faults as r_faults
from repro.core import profiler as r_profiler
from repro.core import streaming as r_streaming
from repro.core import timeline as r_timeline
from repro_torch.checkpoint import ckpt as p_ckpt
from repro_torch.core import exchange as p_ex
from repro_torch.core import faults as p_faults
from repro_torch.core import profiler as p_profiler
from repro_torch.core import streaming as p_streaming
from repro_torch.core import timeline as p_timeline


def _pkg(name, ckpt, ex, faults, streaming, timeline, profiler, **prof_kw):
    return types.SimpleNamespace(
        name=name, ckpt=ckpt, ex=ex, faults=faults,
        Agg=streaming.StreamingAggregator,
        CAgg=streaming.StreamingCombinationAggregator,
        RegionCost=timeline.RegionCost, synthesize=timeline.synthesize,
        profiler=lambda **kw: profiler.EnergyProfiler(**kw, **prof_kw))


REF = _pkg("ref", r_ckpt, r_ex, r_faults, r_streaming, r_timeline,
           r_profiler)
PORT = _pkg("port", p_ckpt, p_ex, p_faults, p_streaming, p_timeline,
            p_profiler, device="cpu")
PKGS = (REF, PORT)
IDS = ("ref", "port")


@contextlib.contextmanager
def reference_x64():
    """Let the reference's ``collective_reduce`` run under JAX 0.9.

    It does ``from jax.experimental import enable_x64`` inside the
    function; JAX 0.9 moved that to ``jax.enable_x64``. The alias exists
    only inside this block, so the reference's own tests see the JAX
    install exactly as they do without the port's tests.
    """
    import jax
    import jax.experimental as jexp
    had = "enable_x64" in vars(jexp)
    if not had:
        jexp.enable_x64 = jax.enable_x64
    try:
        yield
    finally:
        if not had:
            del jexp.enable_x64


def stats_key(agg):
    """Bit-exact fingerprint of a region or combination aggregator:
    combination rows in id order, counts, and every channel's sums as
    float hex, plus the domain axis."""
    if hasattr(agg, "interner"):
        rows = tuple(tuple(int(v) for v in r) for r in agg.interner.combos)
        inner = agg.agg
    else:
        rows, inner = None, agg
    return (rows, inner.domains,
            tuple(int(c) for c in inner.counts),
            tuple(float(x).hex() for x in np.ravel(inner.chan_psum)),
            tuple(float(x).hex() for x in np.ravel(inner.chan_psumsq)))


TABLE_COLS = ("region_ids", "n_samples", "p_hat", "t_hat", "t_lo", "t_hi",
              "pow_hat", "pow_lo", "pow_hi", "e_hat", "e_lo", "e_hi",
              "ci_valid")


def table_equal(a, b):
    """Two estimate tables equal column for column, bit for bit."""
    assert a.names == b.names
    for col in TABLE_COLS:
        assert np.array_equal(getattr(a, col), getattr(b, col)), col
