"""Port parity: ``repro_torch.models.moe`` against the JAX package's
``repro.models.moe``, on reduced ``qwen3-moe-30b-a3b`` and
``granite-moe-1b-a400m`` in float32, from the reference's weights
(``moe_init`` on PRNGKey seeds) and numpy-seeded activations.

* ``router``: the expert choice ``top_i`` equal to the reference's (a
  token whose k-th and (k+1)-th router probabilities lie within
  ``TIE_GAP`` is reported and left out of the equality; its output is
  compared loosely), combine weights and the aux loss at the float32
  limits.
* ``_dispatch_local`` at a capacity that drops tokens (capacity factor
  1.0: 24 slots an expert for loads of 18-30 tokens) and at one that
  does not (T), ``_dispatch_dense``, and ``moe_ffn``
  both ways (capacity and dropless), on the reference's router outputs.
* The gradient of ``moe_ffn`` (capacity path) against ``jax.grad`` of
  the reference's; no float scatter in forward or backward adds two
  values into one element (the combine is a gather both ways); two
  backward passes are bitwise equal.
* The expert-parallel branch (the rules map ``experts``) on a gloo
  world of one equals the local dispatch, forward and gradient.

Tolerances: float32 atol 2e-4 / rtol 1e-3 (``tests/test_kernels.py:115``,
the reference's model-level limit; ``tests/test_torch_models.py``'s
``F32``); gradients rtol 1e-4 / atol 2e-6 (``tests/test_torch_loss.py``);
a near-tie token's output within atol 0.5 (a flipped expert changes it
by up to the experts' output scale, ~0.3 here).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro.configs import registry as rreg
from repro.models import moe as RMoE
from repro_torch.configs import registry as preg
from repro_torch.models import moe as PMoE

F32 = dict(atol=2e-4, rtol=1e-3)
GRAD_TOL = dict(rtol=1e-4, atol=2e-6)
TIE_GAP = 1e-6
TIE_ATOL = 0.5
ARCHS = ["qwen3-moe-30b-a3b", "granite-moe-1b-a400m"]


def _cfgs(arch, **kw):
    return (rreg.get_config(arch).reduced().replace(compute_dtype="float32",
                                                    **kw),
            preg.get_config(arch).reduced().replace(compute_dtype="float32",
                                                    **kw))


def _params(rcfg, seed=0):
    rp = jax.jit(RMoE.moe_init, static_argnums=1)(jax.random.PRNGKey(seed),
                                                  rcfg)
    rp = jax.tree.map(np.asarray, rp)
    return rp, {k: torch.from_numpy(v.copy()) for k, v in rp.items()}


def _x(cfg, T=96, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (T, cfg.d_model)).astype(np.float32)


def _near_ties(rp, x, k):
    """Tokens whose k-th and (k+1)-th router probabilities (the
    reference's, float32) lie within TIE_GAP."""
    probs = np.asarray(jax.nn.softmax(jnp.asarray(x) @ rp["router"], -1))
    s = -np.sort(-probs, axis=-1)
    return np.abs(s[:, k - 1] - s[:, k]) < TIE_GAP


def _np(t):
    return t.detach().numpy()


def _close_but_ties(got, want, ties):
    np.testing.assert_allclose(got[~ties], want[~ties], **F32)
    if ties.any():
        assert np.abs(got[ties] - want[ties]).max() <= TIE_ATOL


@pytest.mark.parametrize("arch", ARCHS)
def test_router_matches_reference(arch):
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _params(rcfg)
    x = _x(rcfg)
    rtp, rti, raux = RMoE.router(rp, rcfg, jnp.asarray(x))
    ptp, pti, paux = PMoE.router(pp, pcfg, torch.from_numpy(x))
    ties = _near_ties(rp, x, pcfg.top_k)
    print(f"{arch}: {int(ties.sum())} near-tie tokens of {len(x)}")
    assert pti.dtype == torch.int64 and ptp.dtype == torch.float32
    np.testing.assert_array_equal(_np(pti)[~ties], np.asarray(rti)[~ties])
    _close_but_ties(_np(ptp), np.asarray(rtp), ties)
    np.testing.assert_allclose(float(paux), float(raux), **F32)


def test_router_breaks_ties_by_the_lower_index():
    """Equal router probabilities pick the lower expert first, as
    ``jax.lax.top_k`` does (the router weights are zero: every expert
    ties)."""
    rcfg, pcfg = _cfgs("qwen3-moe-30b-a3b")
    rp, pp = _params(rcfg)
    rp = dict(rp, router=np.zeros_like(rp["router"]))
    pp = dict(pp, router=torch.zeros_like(pp["router"]))
    x = _x(rcfg, T=5)
    _, rti, _ = RMoE.router(rp, rcfg, jnp.asarray(x))
    _, pti, _ = PMoE.router(pp, pcfg, torch.from_numpy(x))
    np.testing.assert_array_equal(_np(pti), np.asarray(rti))
    np.testing.assert_array_equal(_np(pti), np.tile(
        np.arange(pcfg.top_k), (5, 1)))


def _routed(arch, T=96):
    """Config pair, weights, x and the reference's router outputs (fed to
    both packages' dispatches)."""
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _params(rcfg)
    x = _x(rcfg, T)
    top_p, top_i, _ = RMoE.router(rp, rcfg, jnp.asarray(x))
    return (rcfg, pcfg, rp, pp, x, np.array(top_p),
            np.asarray(top_i).astype(np.int64))


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("drops", [True, False], ids=["drops", "dropless"])
def test_dispatch_local_matches_reference(arch, drops):
    rcfg, pcfg, rp, pp, x, top_p, top_i = _routed(arch)
    T, E, k = len(x), pcfg.n_experts, pcfg.top_k
    cap = T * k // E if drops else T
    counts = np.bincount(top_i.reshape(-1), minlength=E)
    # The dropping capacity really drops (some expert is over it) and
    # leaves filler (some expert is under it); T never drops.
    assert (counts.max() > cap and counts.min() < cap) if drops else True
    want = RMoE._dispatch_local(
        jnp.asarray(rp["up"]), jnp.asarray(rp["gate"]),
        jnp.asarray(rp["down"]), jnp.asarray(x), jnp.asarray(top_p),
        jnp.asarray(top_i.astype(np.int32)), e0=0, n_local=E, n_total=E,
        capacity=cap)
    got = PMoE._dispatch_local(pp["up"], pp["gate"], pp["down"],
                               torch.from_numpy(x),
                               torch.from_numpy(top_p),
                               torch.from_numpy(top_i), capacity=cap)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("arch", ARCHS)
def test_dispatch_dense_matches_reference(arch):
    rcfg, pcfg, rp, pp, x, top_p, top_i = _routed(arch, T=12)
    want = RMoE._dispatch_dense(
        jnp.asarray(rp["up"]), jnp.asarray(rp["gate"]),
        jnp.asarray(rp["down"]), jnp.asarray(x), jnp.asarray(top_p),
        jnp.asarray(top_i.astype(np.int32)))
    got = PMoE._dispatch_dense(pp["up"], pp["gate"], pp["down"],
                               torch.from_numpy(x), torch.from_numpy(top_p),
                               torch.from_numpy(top_i))
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    # Dropless equals the capacity path at a capacity that drops nothing.
    full = PMoE._dispatch_local(pp["up"], pp["gate"], pp["down"],
                                torch.from_numpy(x), torch.from_numpy(top_p),
                                torch.from_numpy(top_i), capacity=len(x))
    np.testing.assert_allclose(_np(got), _np(full), **F32)


@pytest.mark.parametrize("arch", ARCHS)
@pytest.mark.parametrize("dropless", [False, True],
                         ids=["capacity", "dropless"])
def test_moe_ffn_matches_reference(arch, dropless):
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _params(rcfg, seed=3)
    x = _x(rcfg, T=2 * 40, seed=4).reshape(2, 40, -1)
    want, raux = RMoE.moe_ffn(rp, rcfg, jnp.asarray(x), dropless=dropless)
    got, paux = PMoE.moe_ffn(pp, pcfg, torch.from_numpy(x),
                             dropless=dropless)
    assert got.shape == x.shape
    ties = _near_ties(rp, x.reshape(-1, x.shape[-1]), pcfg.top_k)
    _close_but_ties(_np(got).reshape(len(ties), -1),
                    np.asarray(want).reshape(len(ties), -1), ties)
    np.testing.assert_allclose(float(paux), float(raux), **F32)


class _FloatScatters(TorchDispatchMode):
    """Records, for every scatter-add of floats (``scatter_add``,
    ``index_add``, ``index_put`` with accumulate), whether two of its
    values land on one element — on CUDA those are float atomics whose
    order varies between runs."""

    def __init__(self):
        super().__init__()
        self.seen = []

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__.rstrip("_")
        out = func(*args, **kwargs)
        if name == "scatter_add" and args[0].is_floating_point():
            dim, index = args[1], args[2]
            idx = index.movedim(dim, -1).reshape(-1, index.shape[dim])
            dup = any(len(set(r.tolist())) < len(r) for r in idx)
            self.seen.append((name, dup))
        elif name == "index_add" and args[0].is_floating_point():
            index = args[2]
            self.seen.append((name, len(set(index.tolist())) < len(index)))
        elif name == "index_put" and (args[3] if len(args) > 3 else
                                      kwargs.get("accumulate", False)):
            flat = torch.stack([i.reshape(-1) for i in args[1]], 1)
            self.seen.append((name, len(set(map(tuple, flat.tolist())))
                              < len(flat)))
        return out


def _grad(pp, pcfg, x):
    p = {k: v.clone().requires_grad_() for k, v in pp.items()}
    xt = torch.from_numpy(x).requires_grad_()
    y, aux = PMoE.moe_ffn(p, pcfg, xt)
    g = torch.from_numpy(np.random.default_rng(5).standard_normal(
        y.shape).astype(np.float32))
    loss = (y * g).sum() + aux
    grads = torch.autograd.grad(loss, [xt] + [p[k] for k in sorted(p)])
    return [t.numpy() for t in grads], g.numpy()


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_ffn_gradient_matches_reference_without_float_atomics(arch):
    rcfg, pcfg = _cfgs(arch)
    rp, pp = _params(rcfg, seed=6)
    x = _x(rcfg, T=64, seed=7)
    with _FloatScatters() as mode:
        got, g = _grad(pp, pcfg, x)
    assert not any(dup for _, dup in mode.seen), mode.seen

    def f(xr, prm):
        y, aux = RMoE.moe_ffn(prm, rcfg, xr)
        return jnp.sum(y * jnp.asarray(g)) + aux
    gx, gp = jax.grad(f, argnums=(0, 1))(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in rp.items()})
    want = [np.asarray(gx)] + [np.asarray(gp[k]) for k in sorted(gp)]
    ties = _near_ties(rp, x, pcfg.top_k)
    assert not ties.any(), "no near-tie token in this draw"
    for a, b in zip(got, want):
        np.testing.assert_allclose(a, b, **GRAD_TOL)
    again, _ = _grad(pp, pcfg, x)
    assert all(np.array_equal(a, b) for a, b in zip(got, again))


def test_expert_parallel_branch_raises():
    """The expert-parallel branch (rules mapping ``experts``) on a gloo
    world of one equals the local dispatch, forward and gradient; a
    mesh that does not fit the world raises (the branch itself no longer
    does: it is ported, see ``tests/test_torch_sharding.py`` for four
    ranks)."""
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_small_mesh
    from repro_torch.sharding.rules import axis_rules, make_rules

    _, pcfg = _cfgs("qwen3-moe-30b-a3b")
    pcfg = pcfg.replace(capacity_factor=float(pcfg.n_experts / pcfg.top_k))
    _, pp = _params(_cfgs("qwen3-moe-30b-a3b")[0])
    x = np.random.default_rng(5).standard_normal(
        (2, 8, pcfg.d_model)).astype(np.float32)

    def run():
        p = {k: v.detach().clone().requires_grad_() for k, v in pp.items()}
        xt = torch.from_numpy(x).requires_grad_()
        y, aux = PMoE.moe_ffn(p, pcfg, xt)
        (y.square().sum() + aux).backward()
        return [y.detach(), xt.grad] + [p[k].grad for k in sorted(p)]
    want = run()
    had = dist.is_initialized()
    try:
        mesh = make_small_mesh(device="cpu")
        with pytest.raises(ValueError, match="world of 1"):
            make_small_mesh(1, 2, device="cpu")
        rules = make_rules(mesh)
        assert rules.mapping["experts"] == "model"
        with axis_rules(rules):
            got = run()
    finally:
        if not had and dist.is_initialized():
            dist.destroy_process_group()
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), rtol=1e-6,
                                   atol=1e-6)


def test_moe_init_draws_the_reference_shapes():
    rcfg, pcfg = _cfgs("granite-moe-1b-a400m")
    rp, _ = _params(rcfg)
    got = PMoE.moe_init(torch.Generator().manual_seed(0), pcfg)
    assert {k: (tuple(v.shape), v.dtype) for k, v in got.items()} == {
        k: (v.shape, torch.float32) for k, v in rp.items()}
    w = got["up"]
    assert float(w.abs().max()) <= 3 * pcfg.d_model ** -0.5 + 1e-6
    assert not torch.equal(w[0], w[1])
