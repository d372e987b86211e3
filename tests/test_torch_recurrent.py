"""Port parity, unit by unit: the recurrent families' layers
(``repro_torch.models.ssm`` and ``repro_torch.models.xlstm``) against the
JAX reference's on the reference's weights (reduced zamba2-1.2b and
xlstm-125m, float32) and numpy-seeded inputs.

* ``_causal_conv`` with and without a carried tail, ``_ssd_chunked`` at
  two chunk sizes, ``ssm_forward`` with its cache, ``ssm_decode``;
  ``mlstm_forward``/``mlstm_decode`` and ``slstm_forward``/
  ``slstm_decode``, state included.
* The chunked scans equal the port's own token-by-token recurrences
  (the reference validates its chunkwise forms the same way).

Tolerance: float32 atol 2e-4 / rtol 1e-3 (``tests/test_kernels.py:115``,
the reference's model-level limit, as in ``tests/test_torch_models.py``).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as rreg
from repro.models import ssm as RS
from repro.models import xlstm as RX
from repro_torch.configs import registry as preg
from repro_torch.models import ssm as PS
from repro_torch.models import xlstm as PX

F32 = dict(atol=2e-4, rtol=1e-3)


def _cfgs(arch):
    return (rreg.get_config(arch).reduced().replace(compute_dtype="float32"),
            preg.get_config(arch).reduced().replace(compute_dtype="float32"))


def _t(tree):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), tree)


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _close(got, want):
    """Every leaf of ``got`` (port, torch) within F32 of ``want``."""
    g, w = jax.tree.leaves(jax.tree.map(_np, got)), jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == np.shape(b)
        np.testing.assert_allclose(a, np.asarray(b), **F32)


@functools.cache
def _layer(kind):
    """(reference cfg, port cfg, reference params, port params) of one
    reduced layer: "ssm" (zamba2's Mamba2), "mlstm" or "slstm"
    (xlstm's)."""
    arch = "zamba2-1.2b" if kind == "ssm" else "xlstm-125m"
    rcfg, pcfg = _cfgs(arch)
    init = {"ssm": RS.ssm_init, "mlstm": RX.mlstm_init,
            "slstm": RX.slstm_init}[kind]
    rp = init(jax.random.PRNGKey(3), rcfg)
    return rcfg, pcfg, rp, _t(rp)


def _x(B, S, d, seed):
    return np.random.default_rng(seed).standard_normal((B, S, d)).astype(
        np.float32)


# -- Mamba2 (SSD) -------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True], ids=["zeros", "state"])
def test_causal_conv_matches_reference(with_state):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 9, 12)).astype(np.float32)
    w = rng.standard_normal((4, 12)).astype(np.float32)
    st = rng.standard_normal((2, 3, 12)).astype(np.float32) if with_state \
        else None
    got = PS._causal_conv(torch.from_numpy(x), torch.from_numpy(w),
                          None if st is None else torch.from_numpy(st))
    want = RS._causal_conv(jnp.asarray(x), jnp.asarray(w),
                           None if st is None else jnp.asarray(st))
    _close(got, want)


@pytest.mark.parametrize("chunk", [8, 16])
def test_ssd_chunked_matches_reference(chunk):
    rng = np.random.default_rng(2)
    B, S, H, hd, N = 2, 32, 4, 8, 6
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    dt = rng.uniform(0.01, 0.3, (B, S, H)).astype(np.float32)
    A = -np.linspace(1.0, 4.0, H).astype(np.float32)
    got = PS._ssd_chunked(*map(torch.from_numpy, (x, Bm, Cm, dt, A)),
                          chunk=chunk)
    want = RS._ssd_chunked(*map(jnp.asarray, (x, Bm, Cm, dt, A)),
                           chunk=chunk)
    _close(got, want)
    with pytest.raises(AssertionError):
        PS._ssd_chunked(*map(torch.from_numpy, (x, Bm, Cm, dt, A)),
                        chunk=12)


def test_ssd_gradient_is_finite_where_the_reference_overflows():
    """Over a 128-position chunk with dA = -1.6 a step, exp(cs_i - cs_j)
    for j > i reaches exp(203): float32 overflows. The reference masks
    exp's result, so its gradient is inf times the mask's zero gradient,
    NaN (reduced zamba2 trains to NaN at S=512); the port masks the
    exponent: the same forward values, a finite gradient."""
    rng = np.random.default_rng(3)
    B, S, H, hd, N = 1, 128, 2, 4, 4
    x = rng.standard_normal((B, S, H, hd)).astype(np.float32)
    Bm = rng.standard_normal((B, S, N)).astype(np.float32)
    Cm = rng.standard_normal((B, S, N)).astype(np.float32)
    dt = np.full((B, S, H), 0.1, np.float32)
    A = np.full(H, -16.0, np.float32)

    def ref_loss(dt):
        return RS._ssd_chunked(*map(jnp.asarray, (x, Bm, Cm)), dt,
                               jnp.asarray(A), chunk=S)[0].sum()
    want = RS._ssd_chunked(*map(jnp.asarray, (x, Bm, Cm, dt, A)), chunk=S)
    assert np.isnan(np.asarray(jax.grad(ref_loss)(jnp.asarray(dt)))).any()
    dtt = torch.from_numpy(dt).requires_grad_()
    got = PS._ssd_chunked(*map(torch.from_numpy, (x, Bm, Cm)), dtt,
                          torch.from_numpy(A), chunk=S)
    _close(got, want)
    got[0].sum().backward()
    assert torch.isfinite(dtt.grad).all()


def test_ssm_forward_with_cache_matches_reference():
    rcfg, pcfg, rp, pp = _layer("ssm")
    x = _x(2, 32, rcfg.d_model, 4)
    got = PS.ssm_forward(pp, pcfg, torch.from_numpy(x), chunk=8,
                         return_cache=True)
    want = RS.ssm_forward(rp, rcfg, jnp.asarray(x), chunk=8,
                          return_cache=True)
    _close(got, want)
    assert got[1]["h"].dtype == torch.float32
    # The conv tails are copies, not views of the padded sequence.
    assert got[1]["conv_x"].untyped_storage().nbytes() == \
        got[1]["conv_x"].numel() * 4


def test_ssm_decode_matches_reference():
    rcfg, pcfg, rp, pp = _layer("ssm")
    rng = np.random.default_rng(5)
    cache = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        RS.ssm_cache_init(rcfg, 3))
    x = _x(3, 1, rcfg.d_model, 6)
    got = PS.ssm_decode(pp, pcfg, torch.from_numpy(x), _t(cache))
    want = RS.ssm_decode(rp, rcfg, jnp.asarray(x),
                         jax.tree.map(jnp.asarray, cache))
    _close(got, want)


def test_ssm_chunked_equals_its_recurrence():
    """Prefill's chunked scan and the token-by-token decode from a zero
    cache give the same outputs and the same final state."""
    _, pcfg, _, pp = _layer("ssm")
    x = torch.from_numpy(_x(2, 16, pcfg.d_model, 7))
    full, cache = PS.ssm_forward(pp, pcfg, x, chunk=4, return_cache=True)
    c = PS.ssm_cache_init(pcfg, 2, device="cpu")
    outs = []
    for t in range(16):
        y, c = PS.ssm_decode(pp, pcfg, x[:, t:t + 1], c)
        outs.append(y)
    _close(torch.cat(outs, 1), _np(full))
    _close(c, jax.tree.map(_np, cache))


# -- xLSTM --------------------------------------------------------------------

def test_mlstm_forward_and_decode_match_reference():
    rcfg, pcfg, rp, pp = _layer("mlstm")
    x = _x(2, 32, rcfg.d_model, 8)
    got = PX.mlstm_forward(pp, pcfg, torch.from_numpy(x), chunk=8,
                           return_cache=True)
    want = RX.mlstm_forward(rp, rcfg, jnp.asarray(x), chunk=8,
                            return_cache=True)
    _close(got, want)
    # Two decode steps from the prefill's state.
    pc, rc = got[1], want[1]
    for s in range(2):
        xt = _x(2, 1, rcfg.d_model, 9 + s)
        got = PX.mlstm_decode(pp, pcfg, torch.from_numpy(xt), pc)
        want = RX.mlstm_decode(rp, rcfg, jnp.asarray(xt), rc)
        _close(got, want)
        pc, rc = got[1], want[1]


def test_slstm_forward_and_decode_match_reference():
    rcfg, pcfg, rp, pp = _layer("slstm")
    x = _x(2, 16, rcfg.d_model, 10)
    got = PX.slstm_forward(pp, pcfg, torch.from_numpy(x), return_cache=True)
    want = RX.slstm_forward(rp, rcfg, jnp.asarray(x), return_cache=True)
    _close(got, want)
    pc, rc = got[1], want[1]
    for s in range(2):
        xt = _x(2, 1, rcfg.d_model, 11 + s)
        got = PX.slstm_decode(pp, pcfg, torch.from_numpy(xt), pc)
        want = RX.slstm_decode(rp, rcfg, jnp.asarray(xt), rc)
        _close(got, want)
        pc, rc = got[1], want[1]


@pytest.mark.parametrize("chunk", [4, 16])
def test_mlstm_chunked_equals_its_recurrence(chunk):
    """The chunkwise mLSTM (any chunk) and the stabilised single-token
    recurrence from a zero state agree, outputs and final state (the
    true state C̃·exp(m), which the two forms stabilise differently)."""
    _, pcfg, _, pp = _layer("mlstm")
    x = torch.from_numpy(_x(2, 16, pcfg.d_model, 12))
    full, st = PX.mlstm_forward(pp, pcfg, x, chunk=chunk, return_cache=True)
    c = PX.mlstm_cache_init(pcfg, 2, device="cpu")
    outs = []
    for t in range(16):
        y, c = PX.mlstm_decode(pp, pcfg, x[:, t:t + 1], c)
        outs.append(y)
    _close(torch.cat(outs, 1), _np(full))
    for k, e in (("C", (..., None, None)), ("n", (..., None))):
        _close(c[k] * torch.exp(c["m"])[e], _np(st[k] * torch.exp(
            st["m"])[e]))


def test_caches_init_to_zero_on_the_asked_device():
    rcfg, pcfg, _, _ = _layer("ssm")
    got = PS.ssm_cache_init(pcfg, 2, torch.bfloat16, device="cpu")
    want = RS.ssm_cache_init(rcfg, 2, jnp.bfloat16)
    assert {k: (tuple(v.shape), str(v.dtype).split(".")[-1])
            for k, v in got.items()} == {
        k: (v.shape, str(v.dtype)) for k, v in want.items()}
    xcfg = _cfgs("xlstm-125m")
    for pf, rf in ((PX.mlstm_cache_init, RX.mlstm_cache_init),
                   (PX.slstm_cache_init, RX.slstm_cache_init)):
        got, want = pf(xcfg[1], 2, device="cpu"), rf(xcfg[0], 2)
        assert {k: tuple(v.shape) for k, v in got.items()} == {
            k: v.shape for k, v in want.items()}
        assert all(not v.any() and v.dtype == torch.float32
                   for v in got.values())
