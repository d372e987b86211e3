"""Port parity: repro_torch's configs, regions, layers, attention and
model (forward, prefill, decode, loss) against the JAX reference, on the
reference's own weights (``M.init_params`` through ``params_from_jax``)
and numpy-seeded inputs: four reduced dense configs, and the moe
(``qwen3-moe-30b-a3b``, ``granite-moe-1b-a400m``), vlm
(``internvl2-1b``, with ``patch_embeds``) and audio (``hubert-xlarge``,
with ``embeds``, non-causal) families in float32, the MoE routers'
expert choices equal to the reference's; and the recurrent families:
ssm (``xlstm-125m``) and hybrid (``zamba2-1.2b``, reduced to 2 groups of
2 layers, and with 5 layers: 2 groups plus a tail of 1), their caches
and recurrent state included.

Tolerances:

* float32 compute: atol 2e-4 / rtol 1e-3 (``tests/test_kernels.py:115``,
  the reference's model-level limit), greedy tokens equal;
* bfloat16 compute: logits and bf16 cache entries within abs
  ``BF16_ATOL`` = 0.08. bf16 rounds at other places in the two
  frameworks (each intermediate is rounded where its op writes it), and
  the reference's own kernel-vs-plain spread on these models is 0.016-
  0.039 at max |logit| ~3; the port sits at the same distance (0.023-
  0.047 measured), so the limit is about twice the reference's spread.
  The recurrent families' logits and caches (float32 state that
  reaches ~100 in sLSTM's stabiliser, bf16 conv tails and KV) are held
  leaf by leaf to the reference's float32 run on the same tokens: the
  port's bf16 run within ``BF16_SPREAD`` = 2 times the RMS distance of
  the reference's own bf16 run from it (the two round at their own
  places: on reduced zamba2's prefill logits the port is 0.064 from the
  float32 run at most, the reference 0.062, and the two bf16 runs 0.084
  apart; the largest difference of a small state leaf is noisy, its RMS
  is not).
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import base as rbase
from repro.configs import registry as rreg
from repro.models import attention as RA
from repro.models import layers as RL
from repro.models import model as RM
from repro_torch.configs import base as pbase
from repro_torch.configs import registry as preg
from repro_torch.convert import cache_from_jax, params_from_jax
from repro_torch.core import regions
from repro_torch.core.sampler import RegionMarker
from repro_torch.models import attention as PA
from repro_torch.models import layers as PL
from repro_torch.models import model as PM

F32 = dict(atol=2e-4, rtol=1e-3)
BF16_ATOL = 0.08
BF16_SPREAD = 2.0
ARCHS = ["qwen3-1.7b", "yi-6b", "stablelm-3b", "starcoder2-15b"]

# The reference's entry points, jitted: one compile per config instead of
# one per eager op keeps the file fast.
_r_init = jax.jit(RM.init_params, static_argnums=1)
_r_prefill = jax.jit(RM.prefill, static_argnums=(1, 3),
                     static_argnames=("attn_impl", "cache_dtype"))
_r_decode = jax.jit(RM.decode_step, static_argnums=1)
_r_attention = jax.jit(RA.attention, static_argnums=1,
                       static_argnames=("impl", "q_chunk"))
_r_attention_decode = jax.jit(RA.attention_decode, static_argnums=1,
                              static_argnames=("window", "sinks"))


def _np(t):
    return t.detach().to(torch.float32).numpy()


def _cfgs(arch, dtype):
    return (rreg.get_config(arch).reduced().replace(compute_dtype=dtype),
            preg.get_config(arch).reduced().replace(compute_dtype=dtype))


@functools.cache
def _weights(arch, seed=0):
    """The reference's float32 init (jax) and the port's conversion of it;
    compute dtype does not change the weights."""
    rcfg, pcfg = _cfgs(arch, "float32")
    rp = _r_init(jax.random.PRNGKey(seed), rcfg)
    return rp, params_from_jax(jax.tree.map(np.asarray, rp), pcfg,
                               device="cpu")


def _stack_cache(cache):
    return {k: np.stack([_np(c[k]) for c in cache["blocks"]])
            for k in ("k", "v")}


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", rreg.ARCH_IDS)
def test_config_equals_reference(arch):
    r, p = rreg.get_config(arch), preg.get_config(arch)
    assert dataclasses.asdict(p) == dataclasses.asdict(r)
    assert dataclasses.asdict(p.reduced()) == dataclasses.asdict(r.reduced())
    assert (p.head_dim, p.q_per_kv, p.param_count(),
            p.active_param_count()) == (r.head_dim, r.q_per_kv,
                                        r.param_count(),
                                        r.active_param_count())


def test_registry_and_shapes_equal_reference():
    assert preg.ARCH_IDS == rreg.ARCH_IDS
    assert ({k: dataclasses.asdict(v) for k, v in pbase.SHAPES.items()}
            == {k: dataclasses.asdict(v) for k, v in rbase.SHAPES.items()})
    got = [(a, s.name, ok, why) for a, s, ok, why in preg.all_cells()]
    want = [(a, s.name, ok, why) for a, s, ok, why in rreg.all_cells()]
    assert got == want
    with pytest.raises(KeyError):
        preg.get_config("no-such-arch")


# ---------------------------------------------------------------------------
# Regions
# ---------------------------------------------------------------------------

def test_region_marks_and_restores_parent():
    marker = RegionMarker()
    seen = []
    with regions.profiling_session(marker):
        with regions.region("outer_test") as outer:
            seen.append(marker.value)
            with regions.region("inner_test") as inner:
                seen.append(marker.value)
            seen.append(marker.value)
        seen.append(marker.value)
    assert seen == [outer, inner, outer, 0]
    assert regions.registry.names[outer] == "outer_test"
    assert regions.registry.intern("outer_test") == outer
    with regions.region("outer_test"):          # no session: no store
        pass
    assert marker.value == 0


def test_region_names_label_the_profiler_trace():
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with regions.region("traced_region_test"):
            torch.ones(4).sum()
    assert "traced_region_test" in {e.key for e in prof.key_averages()}


# ---------------------------------------------------------------------------
# Layers (float32)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", [(2, 3, 8, 32), (2, 8, 80)])
def test_rope_matches_reference(shape):
    rng = np.random.default_rng(len(shape))
    x = rng.standard_normal(shape).astype(np.float32)
    pos = rng.integers(0, 5000, (shape[0], shape[-2])).astype(np.int32)
    got = PL.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e6)
    want = RL.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e6)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    np.testing.assert_array_equal(PL.rope_frequencies(80, 5e6),
                                  RL.rope_frequencies(80, 5e6))
    np.testing.assert_array_equal(PL.sinusoidal_positions(7, 12),
                                  RL.sinusoidal_positions(7, 12))


@pytest.mark.parametrize("kind", ["rms", "layer"])
def test_norms_match_reference(kind):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((3, 5, 48)).astype(np.float32)
    p = {"scale": rng.standard_normal(48).astype(np.float32),
         "bias": rng.standard_normal(48).astype(np.float32)}
    if kind == "rms":
        del p["bias"]
    got = PL.norm({k: torch.from_numpy(v) for k, v in p.items()},
                  torch.from_numpy(x), kind=kind, eps=1e-6)
    want = RL.norm({k: jnp.asarray(v) for k, v in p.items()},
                   jnp.asarray(x), kind=kind, eps=1e-6)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("init,args,keys", [
    ("rmsnorm_init", (48,), ("scale",)),
    ("layernorm_init", (48,), ("scale", "bias")),
    ("norm_init", (48, "rms"), ("scale",)),
    ("norm_init", (48, "layer"), ("scale", "bias"))])
def test_norm_inits_on_the_cpu_when_asked(init, args, keys):
    """The reference's norm parameters: scale ones, bias zeros, float32."""
    got = getattr(PL, init)(*args, device="cpu")
    want = (RL.rmsnorm_init(48) if "scale" in keys and len(keys) == 1
            else RL.layernorm_init(48))
    assert tuple(got) == keys
    for k in keys:
        assert got[k].device.type == "cpu" and got[k].dtype == torch.float32
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]))


@pytest.mark.parametrize("init,args", [("rmsnorm_init", (8,)),
                                       ("layernorm_init", (8,)),
                                       ("norm_init", (8, "layer"))])
def test_norm_inits_default_to_the_gpu(init, args, monkeypatch):
    """Like every entry point of the port, the norm inits run on the GPU
    unless the caller asks for the CPU, and raise when torch sees none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no GPU"):
        getattr(PL, init)(*args)


@pytest.mark.parametrize("gated,act", [(True, "silu"), (False, "gelu"),
                                       (True, "gelu")])
def test_mlp_matches_reference(gated, act):
    rp = RL.mlp_init(jax.random.PRNGKey(3), 32, 64, gated=gated)
    x = np.random.default_rng(2).standard_normal((2, 5, 32)).astype(
        np.float32)
    got = PL.mlp({k: torch.from_numpy(np.array(v)) for k, v in rp.items()},
                 torch.from_numpy(x), gated=gated, act=act)
    want = RL.mlp(rp, jnp.asarray(x), gated=gated, act=act)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


def test_inits_draw_the_reference_shapes():
    """init_params builds the same tree, shapes and dtypes as the
    reference's (unstacked), from a torch generator."""
    rp, _ = _weights("qwen3-1.7b")
    _, pcfg = _cfgs("qwen3-1.7b", "float32")
    got = PM.init_params(torch.Generator().manual_seed(0), pcfg,
                         device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, rp), pcfg, device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), got)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), want)
    w = got["blocks"][0]["attn"]["wq"]
    assert float(w.abs().max()) <= 3 * pcfg.d_model ** -0.5 + 1e-6
    assert abs(float(w.std()) * pcfg.d_model ** 0.5 - 0.987) < 0.05


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ["qwen3-1.7b", "yi-6b"])
@pytest.mark.parametrize("impl,rimpl", [("full", "full"),
                                        ("chunked", "chunked"),
                                        ("flash", "pallas")])
def test_attention_matches_reference_impl(arch, impl, rimpl):
    rcfg, pcfg = _cfgs(arch, "float32")
    rp = RA.attention_init(jax.random.PRNGKey(1), rcfg)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    x = 0.5 * np.random.default_rng(4).standard_normal(
        (2, 128, rcfg.d_model)).astype(np.float32)
    pos = np.broadcast_to(np.arange(128, dtype=np.int32)[None], (2, 128))
    got = PA.attention(pp, pcfg, torch.from_numpy(x),
                       torch.from_numpy(pos.copy()), impl=impl, q_chunk=32)
    want = _r_attention(rp, rcfg, jnp.asarray(x), jnp.asarray(pos),
                        impl=rimpl, q_chunk=32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)


@pytest.mark.parametrize("grouped,window,sinks", [
    (False, None, 0), (True, None, 0), (False, 6, 2), (True, 5, 0)])
def test_attention_decode_matches_reference(grouped, window, sinks):
    rcfg, pcfg = (c.replace(decode_grouped=grouped)
                  for c in _cfgs("qwen3-1.7b", "float32"))
    rp = RA.attention_init(jax.random.PRNGKey(2), rcfg)
    pp = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), rp)
    rng = np.random.default_rng(5)
    B, S, T = 3, 2, 24
    x = rng.standard_normal((B, S, rcfg.d_model)).astype(np.float32)
    ck = rng.standard_normal((B, rcfg.n_kv_heads, T, rcfg.head_dim)
                             ).astype(np.float32)
    cv = rng.standard_normal(ck.shape).astype(np.float32)
    cl = np.array([11, 3, 23], np.int32)      # the last one clamps
    got = PA.attention_decode(pp, pcfg, torch.from_numpy(x),
                              torch.from_numpy(ck.copy()),
                              torch.from_numpy(cv.copy()),
                              torch.from_numpy(cl), window=window,
                              sinks=sinks)
    want = _r_attention_decode(rp, rcfg, jnp.asarray(x), jnp.asarray(ck),
                               jnp.asarray(cv), jnp.asarray(cl),
                               window=window, sinks=sinks)
    for g, w in zip(got, want):
        np.testing.assert_allclose(_np(g), np.asarray(w), **F32)


def test_unknown_impl_and_family_raise():
    _, pcfg = _cfgs("qwen3-1.7b", "float32")
    q = torch.zeros(1, 4, 8, 32)
    with pytest.raises(ValueError, match="unknown attention impl"):
        PA._attend(pcfg, q, q[:, :2], q[:, :2], None, impl="pallas",
                   q_chunk=8)
    bogus = pcfg.replace(family="bogus")
    with pytest.raises(ValueError, match="unknown family"):
        PM.init_params(torch.Generator().manual_seed(0), bogus, device="cpu")


# ---------------------------------------------------------------------------
# Model: forward, prefill, decode
# ---------------------------------------------------------------------------

def _tokens(cfg, B, S, seed):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


@pytest.mark.parametrize("impl,rimpl", [("full", "full"),
                                        ("chunked", "chunked"),
                                        ("flash", "pallas")])
def test_forward_matches_reference(impl, rimpl):
    rcfg, pcfg = _cfgs("qwen3-1.7b", "float32")
    rp, pp = _weights("qwen3-1.7b")
    toks = _tokens(rcfg, 2, 64, 7)
    got, aux = PM.forward(pp, pcfg, {"tokens": torch.from_numpy(toks)},
                          attn_impl=impl, q_chunk=32)
    want, _ = RM.forward(rp, rcfg, {"tokens": jnp.asarray(toks)},
                         attn_impl=rimpl, q_chunk=32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert float(aux) == 0.0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    """Prefill through the flash path (the reference's Pallas kernel in
    interpret mode on its side), then 4 decode steps with a ragged [B]
    ``cur_len`` and a ``write_mask`` that leaves one row's cache alone;
    greedy tokens fed back from the reference."""
    rcfg, pcfg = _cfgs(arch, dtype)
    rp, pp = _weights(arch)
    f32 = dtype == "float32"
    cache_dt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                         torch.bfloat16)
    B, S, max_len = 3, 32, 40

    def close(got, want):
        got, want = _np(got), np.asarray(want, np.float32)
        if f32:
            np.testing.assert_allclose(got, want, **F32)
        else:
            assert np.abs(got - want).max() < BF16_ATOL

    toks = _tokens(rcfg, B, S, 11)
    rlog, rcache, rcl = _r_prefill(rp, rcfg, {"tokens": jnp.asarray(toks)},
                                   max_len, attn_impl="pallas",
                                   cache_dtype=cache_dt[0])
    plog, pcache, pcl = PM.prefill(pp, pcfg,
                                   {"tokens": torch.from_numpy(toks)},
                                   max_len, attn_impl="flash",
                                   cache_dtype=cache_dt[1])
    assert plog.shape == (B, 1, rcfg.vocab_size) and int(pcl) == int(rcl)
    close(plog, rlog)
    got = _stack_cache(pcache)
    for k in ("k", "v"):
        assert got[k].shape == rcache["blocks"][k].shape
        close(torch.from_numpy(got[k]), rcache["blocks"][k])
    if f32:
        np.testing.assert_array_equal(np.asarray(rlog).argmax(-1),
                                      _np(plog).argmax(-1))

    # Decode from the reference's cache on both sides, rows at ragged
    # depths; row 1 is masked out of every cache write.
    pcache = cache_from_jax(jax.tree.map(np.asarray, rcache), pcfg,
                            device="cpu")
    cl = np.array([S, S - 5, S - 9], np.int32)
    wm = np.array([True, False, True])
    tok = toks[:, -1:]
    for _ in range(4):
        rlog, rcache = _r_decode(rp, rcfg, jnp.asarray(tok), rcache,
                                      jnp.asarray(cl),
                                      write_mask=jnp.asarray(wm))
        plog, pcache = PM.decode_step(pp, pcfg, torch.from_numpy(tok),
                                      pcache, torch.from_numpy(cl),
                                      write_mask=torch.from_numpy(wm))
        close(plog, rlog)
        got = _stack_cache(pcache)
        for k in ("k", "v"):
            close(torch.from_numpy(got[k]), rcache["blocks"][k])
        if f32:
            np.testing.assert_array_equal(np.asarray(rlog).argmax(-1),
                                          _np(plog).argmax(-1))
        tok = np.asarray(rlog, np.float32).argmax(-1).astype(np.int32)
        cl = cl + 1


def test_decode_verify_and_reset_cache_slots_match_reference():
    rcfg, pcfg = _cfgs("yi-6b", "float32")
    rp, pp = _weights("yi-6b")
    B, max_len = 2, 24
    rng = np.random.default_rng(8)
    ck = rng.standard_normal((rcfg.n_layers, B, rcfg.n_kv_heads, max_len,
                              rcfg.head_dim)).astype(np.float32)
    rcache = {"blocks": {"k": jnp.asarray(ck), "v": jnp.asarray(-ck)}}
    pcache = cache_from_jax({"blocks": {"k": ck, "v": -ck}}, pcfg,
                            device="cpu")
    toks = _tokens(rcfg, B, 3, 9)
    cl = np.array([4, 10], np.int32)
    rlog, rcache = RM.decode_verify(rp, rcfg, jnp.asarray(toks), rcache,
                                    jnp.asarray(cl))
    plog, pcache = PM.decode_verify(pp, pcfg, torch.from_numpy(toks),
                                    pcache, torch.from_numpy(cl))
    np.testing.assert_allclose(_np(plog), np.asarray(rlog), **F32)
    mask = np.array([False, True])
    want = RM.reset_cache_slots(rcfg, rcache, jnp.asarray(mask))
    got = _stack_cache(PM.reset_cache_slots(pcfg, pcache,
                                            torch.from_numpy(mask)))
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k], np.asarray(want["blocks"][k]),
                                   **F32)
    assert not got["k"][:, 1].any()


def test_cast_params_keeps_the_numbers():
    """Holding matrices in the compute dtype gives the same logits as
    casting at every use."""
    _, pcfg = _cfgs("qwen3-1.7b", "bfloat16")
    _, pp = _weights("qwen3-1.7b")
    toks = torch.from_numpy(_tokens(pcfg, 2, 16, 3))
    cast = PM.cast_params(pp, pcfg)
    assert cast["blocks"][0]["mlp"]["up"].dtype == torch.bfloat16
    assert cast["final_norm"]["scale"].dtype == torch.float32
    a, _ = PM.forward(pp, pcfg, {"tokens": toks})
    b, _ = PM.forward(cast, pcfg, {"tokens": toks})
    assert torch.equal(a, b)


def test_init_cache_matches_reference_and_gpu_is_required():
    _, pcfg = _cfgs("qwen3-1.7b", "bfloat16")
    rcfg = rreg.get_config("qwen3-1.7b").reduced()
    want = RM.init_cache(rcfg, 2, 16)
    got = PM.init_cache(pcfg, 2, 16, device="cpu")
    assert len(got["blocks"]) == pcfg.n_layers
    assert got["blocks"][0]["k"].dtype == torch.bfloat16
    assert (tuple(got["blocks"][0]["k"].shape)
            == want["blocks"]["k"].shape[1:])
    if torch.cuda.is_available():
        pytest.skip("a GPU is present; the default device is usable")
    with pytest.raises(RuntimeError, match="no GPU"):
        PM.init_cache(pcfg, 2, 16)


# ---------------------------------------------------------------------------
# The moe, vlm and audio families (float32)
# ---------------------------------------------------------------------------

FAMILY_ARCHS = ["qwen3-moe-30b-a3b", "granite-moe-1b-a400m", "internvl2-1b",
                "hubert-xlarge"]
DECODER_ARCHS = FAMILY_ARCHS[:3]
N_PATCH = 8
# A token whose k-th and (k+1)-th router probabilities lie this close is a
# near tie: reported and left out of the expert-choice equality.
TIE_GAP = 1e-6
_r_forward = jax.jit(RM.forward, static_argnums=1,
                     static_argnames=("attn_impl", "q_chunk"))


def _family_batch(cfg, B, S, seed, labels=False):
    """numpy inputs of S positions: tokens (behind N_PATCH patch
    embeddings for vlm) or frame embeddings (audio); labels on the text
    positions."""
    rng = np.random.default_rng(seed)
    if cfg.embed_inputs:
        b = {"embeds": rng.standard_normal((B, S, cfg.d_model)).astype(
            np.float32)}
    elif cfg.family == "vlm":
        b = {"patch_embeds": 0.1 * rng.standard_normal(
                 (B, N_PATCH, cfg.d_model)).astype(np.float32),
             "tokens": _tokens(cfg, B, S - N_PATCH, seed + 1)}
    else:
        b = {"tokens": _tokens(cfg, B, S, seed + 1)}
    if labels:
        n = S - N_PATCH if cfg.family == "vlm" else S
        b["labels"] = _tokens(cfg, B, n, seed + 2)
    return b


def _j(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _t(b):
    return {k: torch.from_numpy(v.copy()) for k, v in b.items()}


class _Routes:
    """Records the port's router inputs and expert choices, layer by
    layer, while the block is active."""

    def __init__(self, monkeypatch):
        from repro_torch.models import moe as PMoE
        self.calls = []
        orig = PMoE.router

        def rec(p, cfg, x):
            out = orig(p, cfg, x)
            self.calls.append((_np(x), out[1].numpy()))
            return out
        monkeypatch.setattr(PMoE, "router", rec)

    def check(self, rp, rcfg, n_layers):
        """The reference's router on the port's inputs chooses the same
        experts, near ties apart; returns the near-tie count."""
        from repro.models import moe as RMoE
        assert len(self.calls) % n_layers == 0 and self.calls
        ties = 0
        for i, (x, top_i) in enumerate(self.calls):
            w = rp["blocks"]["moe"]["router"][i % n_layers]
            _, want, _ = RMoE.router({"router": w}, rcfg, jnp.asarray(x))
            probs = np.sort(np.asarray(jax.nn.softmax(
                jnp.asarray(x) @ w, -1)), -1)[:, ::-1]
            k = rcfg.top_k
            tie = np.abs(probs[:, k - 1] - probs[:, k]) < TIE_GAP
            ties += int(tie.sum())
            np.testing.assert_array_equal(top_i[~tie],
                                          np.asarray(want)[~tie])
        return ties


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
def test_family_inits_draw_the_reference_shapes(arch):
    rp, _ = _weights(arch)
    _, pcfg = _cfgs(arch, "float32")
    got = PM.init_params(torch.Generator().manual_seed(0), pcfg,
                         device="cpu")
    want = params_from_jax(jax.tree.map(np.asarray, rp), pcfg, device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), got)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), want)
    assert ("embed" in got) == (not pcfg.embed_inputs)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("impl,rimpl", [("full", "full"),
                                        ("flash", "pallas")])
def test_family_forward_matches_reference(arch, impl, rimpl, monkeypatch):
    rcfg, pcfg = _cfgs(arch, "float32")
    rp, pp = _weights(arch)
    b = _family_batch(rcfg, 2, 64, 3)
    routes = _Routes(monkeypatch)
    got, aux = PM.forward(pp, pcfg, _t(b), attn_impl=impl, q_chunk=32)
    want, raux = _r_forward(rp, rcfg, _j(b), attn_impl=rimpl, q_chunk=32)
    assert got.shape == want.shape
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    np.testing.assert_allclose(float(aux), float(raux), **F32)
    if pcfg.family == "moe":
        ties = routes.check(rp, rcfg, pcfg.n_layers)
        print(f"{arch}: {ties} near-tie router rows")
        assert float(aux) > 0
    else:
        assert not routes.calls and float(aux) == 0.0


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_family_prefill_and_decode_match_reference(arch, monkeypatch):
    """Prefill through the flash path (the reference's Pallas kernel in
    interpret mode), for vlm with the patch prefix, then 4 dropless
    decode steps with a ragged ``cur_len`` and a ``write_mask``; greedy
    tokens fed back from the reference."""
    rcfg, pcfg = _cfgs(arch, "float32")
    rp, pp = _weights(arch)
    B, S, max_len = 3, 32, 40
    b = _family_batch(rcfg, B, S, 5)
    routes = _Routes(monkeypatch)
    rlog, rcache, rcl = _r_prefill(rp, rcfg, _j(b), max_len,
                                   attn_impl="pallas",
                                   cache_dtype=jnp.float32)
    plog, pcache, pcl = PM.prefill(pp, pcfg, _t(b), max_len,
                                   attn_impl="flash",
                                   cache_dtype=torch.float32)
    assert int(pcl) == int(rcl) == S
    np.testing.assert_allclose(_np(plog), np.asarray(rlog), **F32)
    got = _stack_cache(pcache)
    for k in ("k", "v"):
        np.testing.assert_allclose(got[k], np.asarray(rcache["blocks"][k]),
                                   **F32)
    pcache = cache_from_jax(jax.tree.map(np.asarray, rcache), pcfg,
                            device="cpu")
    cl = np.array([S, S - 5, S - 9], np.int32)
    wm = np.array([True, False, True])
    tok = b["tokens"][:, -1:]
    for _ in range(4):
        rlog, rcache = _r_decode(rp, rcfg, jnp.asarray(tok), rcache,
                                 jnp.asarray(cl), write_mask=jnp.asarray(wm))
        plog, pcache = PM.decode_step(pp, pcfg, torch.from_numpy(tok),
                                      pcache, torch.from_numpy(cl),
                                      write_mask=torch.from_numpy(wm))
        np.testing.assert_allclose(_np(plog), np.asarray(rlog), **F32)
        got = _stack_cache(pcache)
        for k in ("k", "v"):
            np.testing.assert_allclose(
                got[k], np.asarray(rcache["blocks"][k]), **F32)
        np.testing.assert_array_equal(np.asarray(rlog).argmax(-1),
                                      _np(plog).argmax(-1))
        tok = np.asarray(rlog, np.float32).argmax(-1).astype(np.int32)
        cl = cl + 1
    if pcfg.family == "moe":
        routes.check(rp, rcfg, pcfg.n_layers)


@pytest.mark.parametrize("arch", DECODER_ARCHS)
def test_family_decode_matches_forward(arch):
    """Decoding a sequence token by token gives the full forward's logits
    (``tests/test_arch_smoke.py::test_decode_matches_forward``; MoE at
    capacity factor E/k, where the capacity path drops nothing)."""
    _, pcfg = _cfgs(arch, "float32")
    _, pp = _weights(arch)
    if pcfg.family == "moe":
        pcfg = pcfg.replace(capacity_factor=float(pcfg.n_experts
                                                  / pcfg.top_k))
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(pcfg, B, S, 13))
    full, _ = PM.forward(pp, pcfg, {"tokens": toks})
    cache = PM.init_cache(pcfg, B, S, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = PM.decode_step(pp, pcfg, toks[:, t:t + 1], cache,
                                       torch.tensor(t, dtype=torch.int32))
        outs.append(logits)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), **F32)


@pytest.mark.parametrize("arch", FAMILY_ARCHS)
@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "fused"])
def test_family_loss_matches_reference(arch, fuse):
    """``loss_fn`` and its gradient (vlm: text positions only; moe: ce +
    aux). Losses within abs 1e-5, gradients within rtol 1e-4 / atol 2e-6
    (``tests/test_torch_loss.py``'s limits)."""
    from repro_torch.tree import tree_leaves, tree_map
    rcfg, pcfg = _cfgs(arch, "float32")
    rp, pp = _weights(arch)
    b = _family_batch(rcfg, 2, 64, 9, labels=True)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, bb: RM.loss_fn(p, rcfg, bb, fuse_ce=fuse, ce_chunk=16),
        has_aux=True))(rp, _j(b))
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), pp)
    pl, pm = PM.loss_fn(p, pcfg, _t(b), fuse_ce=fuse, ce_chunk=16)
    grads = torch.autograd.grad(pl, tree_leaves(p))
    assert abs(float(pl.detach()) - float(rl)) <= 1e-5
    np.testing.assert_allclose(float(pm["aux"]), float(rm["aux"]), **F32)
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, rg), pcfg,
                                       device="cpu"))
    assert len(want) == len(grads)
    for a, w in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4,
                                   atol=2e-6)


def test_fused_ce_vlm_and_nondivisor_chunk():
    """``tests/test_loss_paths.py``'s case on the port: fused CE with the
    patch prefix sliced off, at a chunk dividing the text length and at
    one that does not, equals the plain CE; and both equal the
    reference's."""
    rcfg, pcfg = _cfgs("internvl2-1b", "float32")
    rp, pp = _weights("internvl2-1b")
    b = _family_batch(rcfg, 2, 64, 1, labels=True)
    l1, _ = PM.loss_fn(pp, pcfg, _t(b), fuse_ce=False)
    l2, _ = PM.loss_fn(pp, pcfg, _t(b), fuse_ce=True, ce_chunk=16)
    l3, _ = PM.loss_fn(pp, pcfg, _t(b), fuse_ce=True, ce_chunk=13)
    assert float(l1) == pytest.approx(float(l2), abs=1e-5)
    assert float(l1) == pytest.approx(float(l3), abs=1e-5)
    want, _ = RM.loss_fn(rp, rcfg, _j(b), fuse_ce=True, ce_chunk=13)
    assert float(l3) == pytest.approx(float(want), abs=1e-5)


def test_encoder_has_forward_and_loss_only():
    _, pcfg = _cfgs("hubert-xlarge", "float32")
    _, pp = _weights("hubert-xlarge")
    b = _t(_family_batch(pcfg, 1, 8, 2))
    for call in (lambda: PM.prefill(pp, pcfg, b, 16),
                 lambda: PM.init_cache(pcfg, 1, 16, device="cpu"),
                 lambda: PM.decode_step(pp, pcfg, b["embeds"], {}, 0)):
        with pytest.raises(ValueError, match="encoder-only"):
            call()


def test_cast_params_keeps_the_router_float32_and_the_numbers():
    _, pcfg = _cfgs("granite-moe-1b-a400m", "bfloat16")
    _, pp = _weights("granite-moe-1b-a400m")
    toks = torch.from_numpy(_tokens(pcfg, 2, 16, 3))
    cast = PM.cast_params(pp, pcfg)
    moe = cast["blocks"][0]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["up"].dtype == moe["down"].dtype == torch.bfloat16
    a, aux_a = PM.forward(pp, pcfg, {"tokens": toks})
    b, aux_b = PM.forward(cast, pcfg, {"tokens": toks})
    assert torch.equal(a, b) and torch.equal(aux_a, aux_b)


# ---------------------------------------------------------------------------
# The recurrent families: ssm (xlstm) and hybrid (zamba2), float32 and bf16
# ---------------------------------------------------------------------------

# name → (arch, n_layers or None for the reduced config's). zamba2's reduced
# config has 4 layers at attn_every 2, so no tail; "zamba2-tail" has 5:
# two groups of 2 and a tail of 1.
RECURRENT = {"xlstm-125m": ("xlstm-125m", None),
             "zamba2-1.2b": ("zamba2-1.2b", None),
             "zamba2-tail": ("zamba2-1.2b", 5)}


def _rec_cfgs(name, dtype="float32"):
    arch, n = RECURRENT[name]
    rcfg, pcfg = _cfgs(arch, dtype)
    if n is not None:
        rcfg, pcfg = rcfg.replace(n_layers=n), pcfg.replace(n_layers=n)
    return rcfg, pcfg


@functools.cache
def _rec_weights(name):
    rcfg, pcfg = _rec_cfgs(name)
    rp = _r_init(jax.random.PRNGKey(0), rcfg)
    return rp, params_from_jax(jax.tree.map(np.asarray, rp), pcfg,
                               device="cpu")


def _stacked(tree, pcfg):
    """The port's params or cache → numpy leaves in the reference's
    layer-stacked layout and leaf order."""
    from repro_torch.convert import _layer_axes, _stack
    from repro_torch.tree import tree_map
    out = tree_map(_np, tree)
    cache = "shared_attn" in tree and isinstance(tree["shared_attn"], list)
    for k, dims in _layer_axes(pcfg, cache=cache).items():
        out[k] = _stack(out[k], dims)
    return jax.tree.leaves(out)


def _close_trees(got, want, pcfg, close):
    g = _stacked(got, pcfg)
    w = jax.tree.leaves(want)
    assert len(g) == len(w)
    for a, b in zip(g, w):
        assert a.shape == b.shape
        close(a, np.asarray(b, np.float32))


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_inits_draw_the_reference_shapes(name):
    rp, want = _rec_weights(name)
    _, pcfg = _rec_cfgs(name)
    got = PM.init_params(torch.Generator().manual_seed(0), pcfg,
                         device="cpu")
    shapes = jax.tree.map(lambda t: (tuple(t.shape), t.dtype), got)
    assert shapes == jax.tree.map(lambda t: (tuple(t.shape), t.dtype), want)
    assert ("tail" in got) == (name == "zamba2-tail")
    if pcfg.family == "hybrid":
        assert len(got["groups"]) == pcfg.n_layers // pcfg.attn_every
        assert all(len(g) == pcfg.attn_every for g in got["groups"])
    from repro_torch.convert import _params_to_jax
    back = _params_to_jax(want, pcfg)
    assert jax.tree.structure(back) == jax.tree.structure(rp)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(rp)):
        assert a.tobytes() == np.asarray(b).tobytes()


@pytest.mark.parametrize("name", RECURRENT)
@pytest.mark.parametrize("impl,rimpl", [("full", "full"),
                                        ("flash", "pallas")])
def test_recurrent_forward_matches_reference(name, impl, rimpl):
    rcfg, pcfg = _rec_cfgs(name)
    rp, pp = _rec_weights(name)
    toks = _tokens(rcfg, 2, 64, 3)
    got, aux = PM.forward(pp, pcfg, {"tokens": torch.from_numpy(toks)},
                          attn_impl=impl, ssd_chunk=16, q_chunk=32)
    want, _ = _r_forward(rp, rcfg, {"tokens": jnp.asarray(toks)},
                         attn_impl=rimpl, q_chunk=32)
    np.testing.assert_allclose(_np(got), np.asarray(want), **F32)
    assert float(aux) == 0.0


_r_prefill_chunk = jax.jit(RM.prefill, static_argnums=(1, 3),
                           static_argnames=("attn_impl", "cache_dtype",
                                            "ssd_chunk"))


def _rms(d):
    return float(np.sqrt(np.mean(np.square(d, dtype=np.float64))))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_prefill_and_decode_match_reference(name, dtype):
    """Prefill (zamba2's shared block through the flash path, the
    reference's Pallas kernel in interpret mode), then 4 decode steps
    from the reference's cache with a ragged ``cur_len`` and a
    ``write_mask`` that leaves row 1's recurrent state and KV alone;
    logits and every cache leaf (recurrent state float32) compared. In
    bf16 each of the port's is held as close (in RMS) to the reference's
    float32 run on the same tokens (prefill and decode in float32
    throughout) as ``BF16_SPREAD`` times the reference's own bf16 run
    is."""
    rcfg, pcfg = _rec_cfgs(name, dtype)
    rcfg32 = rcfg.replace(compute_dtype="float32")
    rp, pp = _rec_weights(name)
    f32 = dtype == "float32"
    cache_dt = (jnp.float32, torch.float32) if f32 else (jnp.bfloat16,
                                                         torch.bfloat16)
    B, S, max_len = 3, 32, 40
    toks = _tokens(rcfg, B, S, 11)

    def ref_prefill(cfg, dt):
        return _r_prefill_chunk(rp, cfg, {"tokens": jnp.asarray(toks)},
                                max_len, attn_impl="pallas",
                                cache_dtype=dt, ssd_chunk=8)

    def check(plog, pcache, rlog, rcache, r32=None):
        got = [_np(plog)] + _stacked(pcache, pcfg)
        want = [np.asarray(x, np.float32)
                for x in [rlog] + jax.tree.leaves(rcache)]
        assert len(got) == len(want)
        if not f32:
            truth = [np.asarray(x, np.float32)
                     for x in [r32[0]] + jax.tree.leaves(r32[1])]
        for i, (a, b) in enumerate(zip(got, want)):
            assert a.shape == b.shape
            if f32:
                np.testing.assert_allclose(a, b, **F32)
            else:
                spread = _rms(b - truth[i])
                assert _rms(a - truth[i]) <= BF16_SPREAD * spread, i

    rlog, rcache, rcl = ref_prefill(rcfg, cache_dt[0])
    r32 = None if f32 else ref_prefill(rcfg32, jnp.float32)[:2]
    plog, pcache, pcl = PM.prefill(pp, pcfg, {"tokens": torch.from_numpy(
        toks)}, max_len, attn_impl="flash", ssd_chunk=8,
        cache_dtype=cache_dt[1])
    assert int(pcl) == int(rcl) == S
    check(plog, pcache, rlog, rcache, r32)

    pcache = cache_from_jax(jax.tree.map(np.asarray, rcache), pcfg,
                            device="cpu")
    kept = [t.clone() for t in jax.tree.leaves(
        jax.tree.map(lambda t: t[1], pcache))]
    cl = np.array([S, S - 5, S - 9], np.int32)
    wm = np.array([True, False, True])
    tok = toks[:, -1:]
    for _ in range(4):
        args = (jnp.asarray(tok),)
        kw = dict(write_mask=jnp.asarray(wm))
        if not f32:       # the reference's float32 run, same tokens
            r32 = _r_decode(rp, rcfg32, *args, r32[1], jnp.asarray(cl),
                            **kw)
        rlog, rcache = _r_decode(rp, rcfg, *args, rcache, jnp.asarray(cl),
                                 **kw)
        plog, pcache = PM.decode_step(pp, pcfg, torch.from_numpy(tok),
                                      pcache, torch.from_numpy(cl),
                                      write_mask=torch.from_numpy(wm))
        check(plog, pcache, rlog, rcache, r32)
        if f32:
            np.testing.assert_array_equal(np.asarray(rlog).argmax(-1),
                                          _np(plog).argmax(-1))
        tok = np.asarray(rlog, np.float32).argmax(-1).astype(np.int32)
        cl = cl + 1
    for a, b in zip(jax.tree.leaves(jax.tree.map(lambda t: t[1], pcache)),
                    kept):
        assert torch.equal(a, b), "a masked row's state moved"


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_decode_matches_forward(name):
    """Decoding a sequence token by token from a zero cache gives the
    full forward's logits (``tests/test_arch_smoke.py::
    test_decode_matches_forward``)."""
    _, pcfg = _rec_cfgs(name)
    _, pp = _rec_weights(name)
    B, S = 2, 16
    toks = torch.from_numpy(_tokens(pcfg, B, S, 13))
    full, _ = PM.forward(pp, pcfg, {"tokens": toks})
    cache = PM.init_cache(pcfg, B, S, dtype=torch.float32, device="cpu")
    outs = []
    for t in range(S):
        logits, cache = PM.decode_step(pp, pcfg, toks[:, t:t + 1], cache,
                                       torch.tensor(t, dtype=torch.int32))
        outs.append(logits)
    np.testing.assert_allclose(_np(torch.cat(outs, 1)), _np(full), **F32)


@pytest.mark.parametrize("name", RECURRENT)
def test_recurrent_verify_and_reset_match_reference(name):
    """``decode_verify`` (the single-token step over L positions, from
    ragged depths, one row masked) and ``reset_cache_slots`` (recurrent
    state and KV rows zeroed: batch axis 2 of the reference's groups,
    axis 0 of every port tensor) against the reference's, from a cache
    of random state."""
    rcfg, pcfg = _rec_cfgs(name)
    rp, pp = _rec_weights(name)
    B, max_len = 2, 24
    rng = np.random.default_rng(8)
    rand = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32),
        RM.init_cache(rcfg, B, max_len, dtype=jnp.float32))
    rcache = jax.tree.map(jnp.asarray, rand)
    pcache = cache_from_jax(rand, pcfg, device="cpu")
    toks = _tokens(rcfg, B, 3, 9)
    cl = np.array([4, 10], np.int32)
    wm = np.array([True, False])
    rlog, rcache = RM.decode_verify(rp, rcfg, jnp.asarray(toks), rcache,
                                    jnp.asarray(cl),
                                    write_mask=jnp.asarray(wm))
    plog, pcache = PM.decode_verify(pp, pcfg, torch.from_numpy(toks),
                                    pcache, torch.from_numpy(cl),
                                    write_mask=torch.from_numpy(wm))
    np.testing.assert_allclose(_np(plog), np.asarray(rlog), **F32)

    def close(a, b):
        np.testing.assert_allclose(a, b, **F32)
    _close_trees(pcache, rcache, pcfg, close)
    mask = np.array([False, True])
    want = RM.reset_cache_slots(rcfg, rcache, jnp.asarray(mask))
    got = PM.reset_cache_slots(pcfg, pcache, torch.from_numpy(mask))
    _close_trees(got, want, pcfg, close)
    from repro_torch.tree import tree_leaves
    assert all(not t[1].any() and t[0].any() for t in tree_leaves(got))
    with pytest.raises(ValueError, match="decode_verify"):
        PM.decode_step(pp, pcfg, torch.from_numpy(toks), got,
                       torch.from_numpy(cl))


@pytest.mark.parametrize("name", RECURRENT)
@pytest.mark.parametrize("fuse", [False, True], ids=["plain", "fused"])
def test_recurrent_loss_matches_reference(name, fuse):
    """``loss_fn`` and its gradient, through remat (each pair, or each
    group with the shared block after it, is one unit): losses within
    abs 1e-5, gradients within rtol 1e-4 / atol 2e-6
    (``tests/test_torch_loss.py``'s limits); zamba2's shared block's
    gradient is its uses' sum."""
    from repro_torch.tree import tree_leaves, tree_map
    rcfg, pcfg = _rec_cfgs(name)
    rp, pp = _rec_weights(name)
    b = _family_batch(rcfg, 2, 64, 9, labels=True)
    (rl, rm), rg = jax.jit(jax.value_and_grad(
        lambda p, bb: RM.loss_fn(p, rcfg, bb, fuse_ce=fuse, ce_chunk=16,
                                 ssd_chunk=16), has_aux=True))(rp, _j(b))
    p = tree_map(lambda t: t.detach().clone().requires_grad_(), pp)
    pl, pm = PM.loss_fn(p, pcfg, _t(b), fuse_ce=fuse, ce_chunk=16,
                        ssd_chunk=16)
    assert pcfg.remat == "full"
    grads = torch.autograd.grad(pl, tree_leaves(p))
    assert abs(float(pl.detach()) - float(rl)) <= 1e-5
    assert float(pm["aux"]) == float(rm["aux"]) == 0.0
    want = tree_leaves(params_from_jax(jax.tree.map(np.asarray, rg), pcfg,
                                       device="cpu"))
    assert len(want) == len(grads)
    for a, w in zip(grads, want):
        np.testing.assert_allclose(a.numpy(), w.numpy(), rtol=1e-4,
                                   atol=2e-6)


@pytest.mark.parametrize("name", ["xlstm-125m", "zamba2-1.2b"])
def test_recurrent_cast_params_keep_the_numbers(name):
    """The compute-dtype copy keeps sLSTM's recurrence float32 (the
    reference multiplies it with the float32 state) and gives the same
    logits as casting at every use."""
    _, pcfg = _rec_cfgs(name, "bfloat16")
    _, pp = _rec_weights(name)
    toks = torch.from_numpy(_tokens(pcfg, 2, 16, 3))
    cast = PM.cast_params(pp, pcfg)
    if pcfg.family == "ssm":
        assert cast["pairs"][0]["s"]["r"].dtype == torch.float32
        assert cast["pairs"][0]["s"]["w"].dtype == torch.bfloat16
    else:
        assert cast["groups"][0][0]["ssm"]["A_log"].dtype == torch.float32
        assert cast["groups"][0][0]["ssm"]["conv_x"].dtype == torch.bfloat16
    a, _ = PM.forward(pp, pcfg, {"tokens": toks})
    b, _ = PM.forward(cast, pcfg, {"tokens": toks})
    assert torch.equal(a, b)
