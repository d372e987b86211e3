"""Port parity: ``repro_torch.optim`` (AdamW, schedules, clipping, int8
compression with error feedback) against the JAX package's, on the same
numpy-seeded params and grads.

* ``adamw_update`` within rtol 1e-6 of the reference on params, moments,
  grad norm and lr, over several steps, with and without clipping;
* the reference's own checks (``tests/test_substrates.py``): the
  hand-rolled numpy AdamW, clip and cosine schedule, int8 round-trip
  bounds, error feedback preserving the sum;
* ``compress_decompress``: the int8 codes equal (both round half to
  even), dequantised values and residuals within rtol 1e-6.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as r_adamw
from repro.optim import compression as r_comp
from repro_torch.optim.adamw import (AdamWConfig, adamw_init, adamw_update,
                                     clip_by_global_norm, cosine_schedule,
                                     global_norm, linear_warmup)
from repro_torch.optim.compression import (compress_decompress,
                                           compress_init, dequantize_int8,
                                           quantize_int8)
from repro_torch.tree import tree_leaves, tree_map

RTOL = 1e-6


def _tree(seed, scale=1.0):
    """A params-like tree: matrices, vectors and a list of blocks."""
    rng = np.random.default_rng(seed)

    def a(*shape):
        return (rng.standard_normal(shape) * scale).astype(np.float32)
    return {"embed": a(16, 8), "norm": {"scale": a(8)},
            "blocks": [{"w": a(8, 8), "b": a(8)} for _ in range(3)]}


def _ref_tree(t):
    """The same numbers in the reference's layout (blocks stacked)."""
    return {"embed": jnp.asarray(t["embed"]),
            "norm": {"scale": jnp.asarray(t["norm"]["scale"])},
            "blocks": {k: jnp.asarray(np.stack([b[k] for b in t["blocks"]]))
                       for k in ("w", "b")}}


def _port_tree(t):
    return tree_map(torch.from_numpy, tree_map(np.copy, t))


def _ref_leaves_in_port_order(rt):
    """The reference tree's leaves, unstacked, in the port's leaf order."""
    out = {"embed": np.asarray(rt["embed"]),
           "norm": {"scale": np.asarray(rt["norm"]["scale"])},
           "blocks": [{k: np.asarray(rt["blocks"][k][i]) for k in ("w", "b")}
                      for i in range(3)]}
    return tree_leaves(out)


@pytest.mark.parametrize("grad_clip", [1.0, 1e9], ids=["clipped", "unclipped"])
@pytest.mark.parametrize("grad_scale", [0.01, 1.0])
def test_adamw_update_matches_reference(grad_clip, grad_scale):
    cfg = AdamWConfig(lr=1e-2, grad_clip=grad_clip, warmup_steps=2,
                      total_steps=6)
    rcfg = r_adamw.AdamWConfig(**vars(cfg))
    p = _tree(0)
    pp, rp = _port_tree(p), _ref_tree(p)
    ps, rs = adamw_init(pp), r_adamw.adamw_init(rp)
    for step in range(4):
        g = _tree(10 + step, grad_scale)
        pp, ps, pm = adamw_update(cfg, pp, _port_tree(g), ps)
        rp, rs, rm = r_adamw.adamw_update(rcfg, rp, _ref_tree(g), rs)
        assert int(ps["step"]) == int(rs["step"]) == step + 1
        for k in ("grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[k]), float(rm[k]), rtol=RTOL)
        for port, ref in ((pp, rp), (ps["mu"], rs["mu"]),
                          (ps["nu"], rs["nu"])):
            for a, b in zip(tree_leaves(port), _ref_leaves_in_port_order(ref)):
                np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                           atol=1e-12)


def test_adamw_update_is_in_place():
    cfg = AdamWConfig()
    pp = _port_tree(_tree(0))
    ps = adamw_init(pp)
    first = tree_leaves(pp)[0]
    before = first.clone()
    out, st, _ = adamw_update(cfg, pp, _port_tree(_tree(1)), ps)
    assert out is pp and st is ps and tree_leaves(out)[0] is first
    assert not torch.equal(first, before)


def test_adamw_matches_reference_math():
    """One step against a hand-rolled numpy AdamW (the reference's test)."""
    cfg = AdamWConfig(lr=1e-2, b1=0.9, b2=0.99, eps=1e-8, weight_decay=0.1,
                      grad_clip=1e9, warmup_steps=0, total_steps=10,
                      min_lr_ratio=1.0)
    p0 = {"w": np.array([[1.0, -2.0], [0.5, 3.0]], np.float32),
          "b": np.array([0.1], np.float32)}
    g = {"w": np.array([[0.1, 0.2], [-0.3, 0.4]], np.float32),
         "b": np.array([0.05], np.float32)}
    p = _port_tree(p0)
    new_p, new_state, _ = adamw_update(cfg, p, _port_tree(g), adamw_init(p))
    for k, decay in (("w", 0.1), ("b", 0.0)):   # decay only on matrices
        mu = 0.1 * g[k]
        nu = 0.01 * g[k] * g[k]
        mhat = mu / (1 - 0.9)
        vhat = nu / (1 - 0.99)
        expect = p0[k] - 1e-2 * (mhat / (np.sqrt(vhat) + 1e-8)
                                 + decay * p0[k])
        np.testing.assert_allclose(new_p[k].numpy(), expect, rtol=1e-5)
    assert int(new_state["step"]) == 1


def test_clip_and_schedule():
    g = {"a": torch.full((10,), 3.0)}
    clipped, norm = clip_by_global_norm(g, 1.0)
    assert float(norm) == pytest.approx(np.sqrt(90.0))
    assert float(global_norm(clipped)) == pytest.approx(1.0, rel=1e-5)

    cfg = AdamWConfig(lr=1.0, warmup_steps=10, total_steps=110,
                      min_lr_ratio=0.1)
    sched = cosine_schedule(cfg)
    assert float(sched(torch.tensor(5))) == pytest.approx(0.5)
    assert float(sched(torch.tensor(10))) == pytest.approx(1.0)
    assert float(sched(torch.tensor(110))) == pytest.approx(0.1, abs=1e-6)


@pytest.mark.parametrize("name", ["cosine_schedule", "linear_warmup"])
def test_schedules_match_reference(name):
    cfg = AdamWConfig(lr=3e-4, warmup_steps=7, total_steps=50,
                      min_lr_ratio=0.1)
    ours = {"cosine_schedule": cosine_schedule,
            "linear_warmup": linear_warmup}[name](cfg)
    ref = getattr(r_adamw, name)(r_adamw.AdamWConfig(**vars(cfg)))
    for s in range(0, 60, 3):
        np.testing.assert_allclose(
            float(ours(torch.tensor(s, dtype=torch.int32))),
            float(ref(jnp.asarray(s, jnp.int32))), rtol=RTOL)


def test_clip_matches_reference():
    t = _tree(3, 2.0)
    got, gn = clip_by_global_norm(_port_tree(t), 1.0)
    want, wn = r_adamw.clip_by_global_norm(_ref_tree(t), 1.0)
    np.testing.assert_allclose(float(gn), float(wn), rtol=RTOL)
    for a, b in zip(tree_leaves(got), _ref_leaves_in_port_order(want)):
        np.testing.assert_allclose(a.numpy(), b, rtol=RTOL)


# -- compression -------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1, 2])
def test_quantize_int8_codes_equal_the_reference(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal(4096) * 5).astype(np.float32)
    # exact halves of the scale, where rounding half to even decides
    x[:8] = np.float32(np.abs(x).max()) / 127 * np.float32(
        [0.5, 1.5, 2.5, -0.5, -1.5, 3.5, -2.5, 4.5])
    q, scale = quantize_int8(torch.from_numpy(x))
    rq, rscale = r_comp.quantize_int8(jnp.asarray(x))
    assert float(scale) == float(rscale)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_allclose(dequantize_int8(q, scale).numpy(),
                               np.asarray(r_comp.dequantize_int8(rq, rscale)),
                               rtol=RTOL)


def test_int8_quant_roundtrip_bounds():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal(1000) * 5)
    q, scale = quantize_int8(x)
    err = (dequantize_int8(q, scale) - x.float()).abs()
    assert float(err.max()) <= float(scale) / 2 + 1e-6


def test_compress_decompress_matches_reference():
    p = _tree(0)
    pr, rr = compress_init(_port_tree(p)), r_comp.compress_init(_ref_tree(p))
    for step in range(3):
        g = _tree(20 + step, 0.01)
        pg, pr = compress_decompress(_port_tree(g), pr)
        rg, rr = r_comp.compress_decompress(_ref_tree(g), rr)
        for port, ref in ((pg, rg), (pr, rr)):
            for a, b in zip(tree_leaves(port), _ref_leaves_in_port_order(ref)):
                np.testing.assert_allclose(a.numpy(), b, rtol=RTOL,
                                           atol=1e-12)


def test_error_feedback_preserves_sum():
    """Σ compressed grads + final residual == Σ raw grads (EF property)."""
    rng = np.random.default_rng(1)
    grads_seq = [{"w": torch.from_numpy(
        rng.standard_normal((64, 64)).astype(np.float32) * 0.01)}
        for _ in range(20)]
    residual = compress_init(grads_seq[0])
    total_sent = torch.zeros(64, 64)
    for g in grads_seq:
        sent, residual = compress_decompress(g, residual)
        total_sent = total_sent + sent["w"]
    total_raw = sum(g["w"] for g in grads_seq)
    drift = (total_sent + residual["w"] - total_raw).abs()
    assert float(drift.max()) < 1e-5
