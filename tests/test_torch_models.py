"""Port parity: repro_torch's configs, regions, layers, attention and
dense-family model (forward, prefill, decode) against the JAX reference,
on the reference's own weights (``M.init_params`` through
``params_from_jax``) and numpy-seeded inputs.

Tolerances:

* float32 compute: atol 2e-4 / rtol 1e-3 (``tests/test_kernels.py:115``,
  the reference's model-level limit), greedy tokens equal;
* bfloat16 compute: logits and bf16 cache entries within abs
  ``BF16_ATOL`` = 0.08. bf16 rounds at other places in the two
  frameworks (each intermediate is rounded where its op writes it), and
  the reference's own kernel-vs-plain spread on these models is 0.016-
  0.039 at max |logit| ~3; the port sits at the same distance (0.023-
  0.047 measured), so the limit is about twice the reference's spread.
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
    moe = preg.get_config("qwen3-moe-30b-a3b").reduced()
    with pytest.raises(NotImplementedError, match="A7"):
        PM.init_params(torch.Generator().manual_seed(0), moe, device="cpu")


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
