"""Port parity: the loss half of ``repro_torch.models.model`` against the
JAX package's (``cross_entropy``, ``fused_lm_head_ce``, ``loss_fn``) and
``remat``, on reduced dense configs in float32, from the reference's
seed-0 weights (``params_from_jax``) and numpy-seeded tokens.

Losses within abs 1e-5 of the reference's; every gradient leaf within
rtol 1e-4, atol 2e-6 of the reference's, after its gradient tree goes
through ``params_from_jax``'s unstacking; the three remat policies give
gradients within 1e-6 of each other. The atol: the embedding's gradient
passes back through every rmsnorm of tiny activations (embeddings are
drawn at scale 0.02), which amplifies it to ~1 and its rounding with
it; the packages' summation orders leave 1.47e-6 between them there
(yi-6b, values up to 1.09), and ~1e-7 on every other leaf. Plus the
kernel wrappers' refusal of a gradient (neither Pallas kernel has one in the reference).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_serve_pkgs import weights
from repro.models import model as r_model
from repro_torch.convert import params_from_jax
from repro_torch.kernels.flash_attention.ops import flash_attention
from repro_torch.kernels.rmsnorm.ops import rmsnorm
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

LOSS_ATOL = 1e-5
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
ARCHS = ("qwen3-1.7b", "yi-6b")


def _batch(cfg, B=2, S=32, seed=0, mask=False):
    rng = np.random.default_rng(seed)
    b = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
         "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    if mask:
        b["loss_mask"] = (rng.random((B, S)) < 0.7).astype(np.float32)
    return b


@functools.cache
def _ref_grad(arch, remat, kw_items, mask):
    """(loss, grads as numpy) of the reference's loss_fn."""
    rcfg, rp, _, _ = weights("float32", arch)
    rcfg = rcfg.replace(remat=remat)
    batch = {k: jnp.asarray(v) for k, v in _batch(rcfg, mask=mask).items()}
    kw = dict(kw_items)
    fn = jax.jit(jax.value_and_grad(
        lambda p: r_model.loss_fn(p, rcfg, batch, **kw)[0]))
    loss, g = fn(rp)
    return float(loss), jax.tree.map(np.asarray, g)


def _port_grad(arch, remat, kw, mask):
    _, _, pcfg, pp = weights("float32", arch)
    pcfg = pcfg.replace(remat=remat)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), pp)
    batch = {k: torch.from_numpy(v) for k, v in _batch(pcfg,
                                                          mask=mask).items()}
    loss, _ = M.loss_fn(p, pcfg, batch, **kw)
    grads = torch.autograd.grad(loss, tree_leaves(p))
    return float(loss.detach()), [g.numpy() for g in grads]


def _check_against_reference(arch, remat, kw, mask=False):
    _, _, pcfg, _ = weights("float32", arch)
    rl, rg = _ref_grad(arch, remat, tuple(sorted(kw.items())), mask)
    pl, pg = _port_grad(arch, remat, kw, mask)
    assert abs(pl - rl) <= LOSS_ATOL, (pl, rl)
    want = tree_leaves(params_from_jax(rg, pcfg, device="cpu"))
    assert len(want) == len(pg)
    for a, b in zip(pg, want):
        np.testing.assert_allclose(a, b.numpy(), **GRAD_TOL)
    return pg


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("kw", [dict(fuse_ce=False),
                                dict(fuse_ce=True, ce_chunk=16),
                                dict(fuse_ce=True, ce_chunk=13)],
                         ids=["plain", "fused16", "fused13"])
def test_loss_fn_matches_reference(arch, kw):
    _check_against_reference(arch, "full", kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_masked_loss_matches_reference(arch):
    _check_against_reference(arch, "full", dict(fuse_ce=False), mask=True)


@pytest.mark.parametrize("remat", ["none", "dots", "full"])
def test_remat_policies_match_reference(remat):
    _check_against_reference("qwen3-1.7b", remat, dict(fuse_ce=False))


def test_remat_policies_give_the_same_gradients():
    grads = {r: _port_grad("qwen3-1.7b", r, dict(fuse_ce=False), False)[1]
             for r in ("none", "dots", "full")}
    for r in ("dots", "full"):
        for a, b in zip(grads[r], grads["none"]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6)


@pytest.mark.parametrize("mask", [False, True])
def test_cross_entropy_matches_reference(mask):
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((2, 9, 50)).astype(np.float32) * 4
    labels = rng.integers(0, 50, (2, 9)).astype(np.int32)
    m = (rng.random((2, 9)) < 0.5).astype(np.float32) if mask else None
    want = r_model.cross_entropy(jnp.asarray(logits), jnp.asarray(labels),
                                 None if m is None else jnp.asarray(m))
    lt = torch.from_numpy(logits).requires_grad_()
    got = M.cross_entropy(lt, torch.from_numpy(labels),
                          None if m is None else torch.from_numpy(m))
    assert float(got.detach()) == pytest.approx(float(want), abs=LOSS_ATOL)
    (g,) = torch.autograd.grad(got, [lt])
    gw = jax.grad(lambda x: r_model.cross_entropy(
        x, jnp.asarray(labels), None if m is None else jnp.asarray(m)))(
            jnp.asarray(logits))
    np.testing.assert_allclose(g.numpy(), np.asarray(gw), **GRAD_TOL)


def test_fused_ce_default_follows_the_reference_rule():
    """fuse_ce=None fuses when there is no loss_mask and S >= 2048 (the
    chunk count changes the rounding, so each choice is seen bit for
    bit)."""
    _, _, pcfg, pp = weights("float32", "qwen3-1.7b")
    long = {k: torch.from_numpy(v) for k, v in
            _batch(pcfg, B=1, S=2048, seed=4).items()}
    masked = dict(long, loss_mask=torch.ones(1, 2048))
    short = {k: torch.from_numpy(v) for k, v in _batch(pcfg).items()}
    with torch.no_grad():
        def loss(b, **kw):
            return M.loss_fn(pp, pcfg, b, ce_chunk=700, **kw)[0]
        assert torch.equal(loss(long), loss(long, fuse_ce=True))
        assert torch.equal(loss(masked), loss(masked, fuse_ce=False))
        assert torch.equal(loss(short), loss(short, fuse_ce=False))
        assert float(loss(long, fuse_ce=True)) == pytest.approx(
            float(loss(long, fuse_ce=False)), abs=LOSS_ATOL)


def test_inference_runs_the_blocks_without_checkpoint(monkeypatch):
    """forward/prefill with weights that do not require grad never enter
    torch.utils.checkpoint; a loss with weights that do, does."""
    calls = []
    real = M.checkpoint

    def counting(*a, **kw):
        calls.append(1)
        return real(*a, **kw)
    monkeypatch.setattr(M, "checkpoint", counting)
    _, _, pcfg, pp = weights("float32", "qwen3-1.7b")
    b = {k: torch.from_numpy(v) for k, v in _batch(pcfg).items()}
    M.forward(pp, pcfg, b)
    M.prefill(pp, pcfg, b, 40)
    assert calls == []
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), pp)
    M.loss_fn(p, pcfg, b, fuse_ce=False)
    assert len(calls) == pcfg.n_layers


@pytest.mark.parametrize("remat", ["dots", "full"])
def test_recomputation_does_not_mark(remat):
    """The backward reruns a block's forward under remat; its regions must
    not store into the marker (the reference's backward never runs
    Python), whichever thread autograd runs it on."""
    from repro_torch.core import regions
    from repro_torch.core.sampler import RegionMarker

    class Recording(RegionMarker):
        def set(self, region_id):
            seen.append(regions.registry.name_of(region_id))
            super().set(region_id)
    _, _, pcfg, pp = weights("float32", "qwen3-1.7b")
    pcfg = pcfg.replace(remat=remat)
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), pp)
    b = {k: torch.from_numpy(v) for k, v in _batch(pcfg).items()}
    seen = []
    with regions.profiling_session(Recording()):
        loss, _ = M.loss_fn(p, pcfg, b, fuse_ce=False)
        forward = list(seen)
        torch.autograd.grad(loss, tree_leaves(p))
    assert forward.count("attn_score") == pcfg.n_layers
    assert seen == forward


# -- the kernel wrappers refuse a gradient ----------------------------------

def test_flash_attention_refuses_a_gradient():
    q = torch.randn(1, 2, 8, 32, requires_grad=True)
    k = torch.randn(1, 2, 8, 32)
    with pytest.raises(RuntimeError, match="no gradient"):
        flash_attention(q, k, k)
    with torch.no_grad():
        out = flash_attention(q, k, k)
    assert out.shape == q.shape and out.grad_fn is None
    assert flash_attention(q.detach(), k, k).shape == q.shape


def test_rmsnorm_kernel_refuses_a_gradient():
    x = torch.randn(4, 64)
    s = torch.ones(64, requires_grad=True)
    with pytest.raises(RuntimeError, match="no gradient"):
        rmsnorm(x, s)
    with pytest.raises(RuntimeError, match="no gradient"):
        rmsnorm(x.requires_grad_(), s.detach())
    with torch.no_grad():
        assert rmsnorm(x, s).shape == x.shape


def test_flash_attn_impl_refuses_to_train():
    _, _, pcfg, pp = weights("float32", "qwen3-1.7b")
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), pp)
    b = {k: torch.from_numpy(v) for k, v in _batch(pcfg).items()}
    with pytest.raises(RuntimeError, match="no gradient"):
        M.loss_fn(p, pcfg, b, attn_impl="flash")
