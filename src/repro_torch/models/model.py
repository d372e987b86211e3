"""Top-level model assembly for all six families: init / forward / loss /
prefill / cache / decode.

Port of ``src/repro/models/model.py``. The reference stacks the layers on
a leading axis and scans over them; here they are Python lists with one
dict per layer, and a Python loop runs them
(:func:`repro_torch.convert.params_from_jax` unstacks the reference's
weights): ``p["blocks"]`` for the standard attention block (dense, moe,
audio, vlm), ``p["pairs"]`` for xLSTM's mLSTM + sLSTM pairs (ssm), and
for zamba2 (hybrid) ``p["groups"]``, a list of groups of ``attn_every``
Mamba2 layers each followed by the one weight-shared ``p["shared_attn"]``
block, then ``p["tail"]``, the remaining layers (only when there are
some). The caches follow the same layout; the hybrid's holds one KV
cache per group for the shared block (``cache["shared_attn"]``). Audio
(``cfg.embed_inputs``) takes precomputed frame embeddings plus
sinusoidal positions and is an encoder: forward and loss only. VLM
takes optional ``patch_embeds`` ahead of the token embeddings; its loss
covers the text positions.

Training: :func:`loss_fn` (plain or fused chunked lm_head + CE) is what
``train/step.py`` differentiates. When autograd records, each block (a
pair; a group with the shared block after it) runs under ``cfg.remat``
(``torch.utils.checkpoint``, the reference's ``jax.checkpoint``);
inference (forward, prefill, decode) runs the blocks as plain calls.

Entry points run where their tensors live: :func:`init_params` and
:func:`init_cache` take ``device=`` (the GPU unless the caller asks for
the CPU), the rest follow the parameters and inputs they are given.
"""

from __future__ import annotations

import contextlib
import functools

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import resolve_device
from repro_torch.core import regions
from repro_torch.core.regions import region
from repro_torch.models import transformer as tb
from repro_torch.models.layers import (Params, dense_init, embed_init,
                                       linear, norm, norm_init,
                                       sinusoidal_positions)
from repro_torch.models.ssm import ssm_cache_init
from repro_torch.models.xlstm import mlstm_cache_init, slstm_cache_init
from repro_torch.sharding.rules import (block_of, constrain, psum_whole,
                                       under_current_rules)
from repro_torch.tree import tree_leaves

RECURRENT = ("ssm", "hybrid")

__all__ = ["init_params", "cast_params", "forward", "loss_fn",
           "cross_entropy", "fused_lm_head_ce", "prefill", "init_cache",
           "decode_step", "decode_verify", "reset_cache_slots"]


def _compute_dtype(cfg: ModelConfig) -> torch.dtype:
    return torch.bfloat16 if cfg.compute_dtype == "bfloat16" else torch.float32


# The matmuls ``remat="dots"`` keeps (``jax.checkpoint_policies.
# checkpoint_dots`` keeps every dot_general's output).
_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.bmm.default,
         torch.ops.aten.addmm.default)


def _save_dots(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


@contextlib.contextmanager
def _recompute(ctx):
    """A block's recomputation in the backward: ``ctx`` plus
    ``regions.opaque()``. The reference's regions never mark during a
    backward (its recomputation is part of the traced graph); the port's
    recomputation reruns the block's ``region`` calls, on the CUDA
    autograd thread, where they would otherwise store into the marker."""
    with ctx, regions.opaque():
        yield


def _contexts(remat: str):
    if remat == "dots":
        fwd, rec = create_selective_checkpoint_contexts(_save_dots)
        return fwd, _recompute(rec)
    return contextlib.nullcontext(), _recompute(contextlib.nullcontext())


def _remat(fn, cfg: ModelConfig):
    """``fn`` under ``cfg.remat``: ``"none"`` a plain call, ``"full"``
    recomputes the whole call in the backward, ``"dots"`` keeps the
    matmul outputs and recomputes the rest. The model draws no random
    numbers, so no RNG state is kept for the recomputation."""
    if cfg.remat == "none":
        return fn
    if cfg.remat not in ("dots", "full"):
        raise ValueError(f"unknown remat {cfg.remat!r} (none, dots, full)")

    def wrapped(*args):
        return checkpoint(under_current_rules(fn), *args,
                          use_reentrant=False,
                          preserve_rng_state=False,
                          context_fn=lambda: _contexts(cfg.remat))
    return wrapped


def _recording(x: torch.Tensor, p: Params) -> bool:
    """Whether autograd records a block applied to ``x`` with weights
    ``p``."""
    return torch.is_grad_enabled() and (
        x.requires_grad or any(t.requires_grad for t in tree_leaves(p)))


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def init_params(generator: torch.Generator, cfg: ModelConfig,
                device="cuda") -> Params:
    """Random float32 master weights, drawn from ``generator``, which must
    live on ``device`` (the weights are drawn where they stay)."""
    tb.check_family(cfg)
    dev = resolve_device(device)
    if generator.device.type != dev.type:
        raise ValueError(f"init_params: the generator is on "
                         f"{generator.device}, the weights go to {dev}")
    p: Params = {}
    if not cfg.embed_inputs:
        p["embed"] = embed_init(generator, cfg.vocab_size, cfg.d_model)
    p["final_norm"] = norm_init(cfg.d_model, cfg.norm_kind, generator.device)
    p["lm_head"] = dense_init(generator, cfg.d_model, cfg.vocab_size)
    if cfg.family in tb.ATTN_FAMILIES:
        p["blocks"] = [tb.tblock_init(generator, cfg)
                       for _ in range(cfg.n_layers)]
    elif cfg.family == "ssm" and cfg.slstm_every:          # xLSTM
        p["pairs"] = [tb.xlstm_pair_init(generator, cfg)
                      for _ in range(cfg.n_layers // 2)]
    elif cfg.family == "hybrid":                           # zamba2
        n_groups, tail = _hybrid_split(cfg)
        p["groups"] = [tb.zamba_group_init(generator, cfg, cfg.attn_every)
                       for _ in range(n_groups)]
        if tail:
            p["tail"] = tb.zamba_group_init(generator, cfg, tail)
        p["shared_attn"] = tb.shared_attn_init(generator, cfg)
    else:
        raise ValueError(f"unknown family {cfg.family}")
    return p


def _hybrid_split(cfg: ModelConfig) -> tuple[int, int]:
    """zamba2's (groups of ``attn_every`` layers, tail layers)."""
    n_groups = cfg.n_layers // cfg.attn_every
    return n_groups, cfg.n_layers - n_groups * cfg.attn_every


# Matrices the model uses in float32 whatever the compute dtype.
_FLOAT32 = ("router", "r")


def cast_params(p: Params, cfg: ModelConfig) -> Params:
    """A copy of ``p`` with every matrix (embedding, projections, expert
    stacks, conv taps, head) held in the compute dtype; norm scales,
    biases, the SSM and gate vectors, the MoE router and the sLSTM
    recurrence ``r`` stay float32.

    The model casts each matrix to the activation dtype at every use
    (``layers.linear``, the embedding gather, the experts, the head),
    the router to float32 and multiplies ``r`` with the float32 sLSTM
    state, so the numbers are the same: this only saves the cast at
    every call. Made once at load."""
    dt = _compute_dtype(cfg)

    def conv(x, key=None):
        if isinstance(x, dict):
            return {k: conv(v, k) for k, v in x.items()}
        if isinstance(x, list):
            return [conv(v) for v in x]
        return x.to(dt) if x.ndim >= 2 and key not in _FLOAT32 else x
    return conv(p)


# ---------------------------------------------------------------------------
# Forward (prefill)
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _sinusoidal(seq: int, d: int, dtype: torch.dtype,
                device: torch.device) -> torch.Tensor:
    """:func:`sinusoidal_positions` in ``dtype`` on ``device``, made once
    per key and shared read-only."""
    return torch.from_numpy(sinusoidal_positions(seq, d)).to(device, dtype)


def _embed(p: Params, cfg: ModelConfig, batch: dict):
    """Frontend embedding → x [B,S,d] (compute dtype), positions [B,S].

    Audio (``cfg.embed_inputs``): ``batch["embeds"]`` plus sinusoidal
    positions. Otherwise the tokens' embeddings, for VLM behind
    ``batch["patch_embeds"]`` when given."""
    dt = _compute_dtype(cfg)
    if cfg.embed_inputs:
        x = batch["embeds"].to(dt)
        x = x + _sinusoidal(x.shape[1], cfg.d_model, dt, x.device)[None]
    else:
        with region("embed"):
            # F.embedding, not indexing: indexing's backward accumulates
            # in a thread-dependent order on the CPU, so its gradient
            # would not repeat bit for bit.
            # A sharded table is gathered whole over its vocab rows first
            # (an FSDP shard there would take DTensor's masked lookup,
            # whose backward fails).
            table = constrain(p["embed"].to(dt), None, "embed_shard")
            x = torch.nn.functional.embedding(batch["tokens"], table)
        if cfg.family == "vlm" and "patch_embeds" in batch:
            x = torch.cat([batch["patch_embeds"].to(dt), x], dim=1)
    B, S = x.shape[:2]
    positions = torch.arange(S, dtype=torch.int32,
                             device=x.device)[None].expand(B, S)
    x = constrain(x, "batch", "seq", "embed")
    return x, positions


def _units(p: Params, cfg: ModelConfig, positions: torch.Tensor, *,
           attn_impl: str, ssd_chunk: int, q_chunk: int):
    """The backbone's remat units in order, as (weights, body) with
    body(x) → (x, aux): a block, an xLSTM pair, or a zamba2 group with
    the shared block after it (the reference's scan bodies)."""
    if cfg.family in tb.ATTN_FAMILIES:
        def block(h, pl):
            h = constrain(h, "batch", "seq_act", "embed")   # Megatron SP
            return tb.tblock_forward(pl, cfg, h, positions,
                                     attn_impl=attn_impl, q_chunk=q_chunk)
        return [(pl, functools.partial(block, pl=pl)) for pl in p["blocks"]]
    if cfg.family == "ssm":
        def pair(h, pl):
            h = constrain(h, "batch", "seq_act", "embed")
            return tb.xlstm_pair_forward(pl, cfg, h, positions,
                                         chunk=ssd_chunk)
        return [(pl, functools.partial(pair, pl=pl)) for pl in p["pairs"]]
    shared = p["shared_attn"]

    def group(h, pg):
        h = constrain(h, "batch", "seq_act", "embed")
        h = tb.zamba_group_forward(pg, cfg, h, chunk=ssd_chunk)
        h = tb.shared_attn_forward(shared, cfg, h, positions,
                                   attn_impl=attn_impl, q_chunk=q_chunk)
        return h, torch.zeros((), dtype=torch.float32, device=h.device)
    return [((pg, shared), functools.partial(group, pg=pg))
            for pg in p["groups"]]


def _backbone(p: Params, cfg: ModelConfig, x: torch.Tensor,
              positions: torch.Tensor, *, attn_impl: str = "full",
              ssd_chunk: int = 128, q_chunk: int = 1024):
    """All blocks (no embed / final norm / head). Returns (x, aux). Each
    remat unit runs under ``cfg.remat`` when autograd records it; the
    zamba2 tail runs outside it, as in the reference."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for w, body in _units(p, cfg, positions, attn_impl=attn_impl,
                          ssd_chunk=ssd_chunk, q_chunk=q_chunk):
        if _recording(x, w):
            body = _remat(body, cfg)
        x, a = body(x)
        aux = aux + a
    if "tail" in p:
        x = tb.zamba_group_forward(p["tail"], cfg, x, chunk=ssd_chunk)
    return x, aux


def forward(p: Params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "full", ssd_chunk: int = 128,
            q_chunk: int = 1024):
    """Full-sequence forward → logits [B, S, V], aux loss.
    ``ssd_chunk`` is the recurrent families' scan chunk (the sequence
    length must be a multiple of ``min(ssd_chunk, S)``)."""
    x, positions = _embed(p, cfg, batch)
    x, aux = _backbone(p, cfg, x, positions, attn_impl=attn_impl,
                       ssd_chunk=ssd_chunk, q_chunk=q_chunk)
    x = constrain(x, "batch", None, "embed")
    x = norm(p["final_norm"], x, kind=cfg.norm_kind, eps=cfg.norm_eps)
    with region("lm_head"):
        logits = linear(p["lm_head"], x)
        logits = constrain(logits, "batch", "seq", "vocab")
    return logits, aux


def _lse_minus_label(logits: torch.Tensor, labels: torch.Tensor):
    """Per-position ``logsumexp(logits) - logits[label]`` in float32. The
    max is taken under ``detach`` (the reference's ``stop_gradient``); the
    label's logit is a gather, which equals the reference's one-hot
    ``where``-sum (that sum only adds zeros)."""
    lf = logits.to(torch.float32)
    lf = constrain(lf, "batch", "seq", "vocab")
    m = lf.max(dim=-1, keepdim=True).values.detach()
    lse = torch.log(torch.sum(torch.exp(lf - m), dim=-1)) + m[..., 0]
    return constrain(lse - _label_logit(lf, labels), "batch", "seq")


def _gather_label(lf: torch.Tensor, labels: torch.Tensor, v0: int):
    """lf[..., labels - v0] where the label falls in this block of ``lf``'s
    vocab columns [v0, v0 + V), else 0."""
    idx = labels.to(torch.int64) - v0
    inside = (idx >= 0) & (idx < lf.shape[-1])
    got = torch.gather(lf, -1, idx.clamp(0, lf.shape[-1] - 1)[..., None])
    return torch.where(inside, got[..., 0], torch.zeros((), dtype=lf.dtype,
                                                          device=lf.device))


def _label_logit(lf: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The label's logit, lf [B,S,V] float32 at labels [B,S]. On a
    vocab-sharded DTensor (the reference's vocab-parallel CE) each rank
    takes the labels in its block of columns and one all-reduce over the
    vocab's mesh dims sums them: exactly one rank adds a nonzero value,
    so the sum is the label's logit bit for bit."""
    from torch.distributed.tensor import DTensor, Replicate
    from torch.distributed.tensor.experimental import local_map

    if not isinstance(lf, DTensor):
        return torch.gather(lf, -1, labels[..., None].to(torch.int64))[..., 0]
    mesh = lf.device_mesh
    # labels and the result: lf's batch and sequence shards; whole over
    # the vocab
    lab_pl = tuple(pp if pp.is_shard() and pp.dim in (0, 1) else Replicate()
                   for pp in lf.placements)
    vocab_dims = [i for i, pp in enumerate(lf.placements)
                  if pp.is_shard() and pp.dim == 2]
    if not isinstance(labels, DTensor):
        labels = DTensor.from_local(labels, mesh,
                                    [Replicate()] * mesh.ndim,
                                    run_check=False)
    if tuple(labels.placements) != lab_pl:
        labels = labels.redistribute(mesh, lab_pl)
    r, n = block_of(lf, 2)
    v0 = r * (lf.shape[2] // n)
    groups = [mesh.get_group(i) for i in vocab_dims]

    def body(lf_l, lab_l):
        return psum_whole(_gather_label(lf_l, lab_l, v0), groups)

    return local_map(body, out_placements=(lab_pl,),
                     in_placements=(lf.placements, lab_pl),
                     device_mesh=mesh)(lf, labels)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: torch.Tensor | None = None) -> torch.Tensor:
    """Stable CE. logits [B,S,V]; labels [B,S]; mask [B,S] (optional)
    weights the positions: Σ nll·mask / max(Σ mask, 1)."""
    nll = _lse_minus_label(logits, labels)
    if mask is not None:
        return torch.sum(nll * mask) / torch.clamp(torch.sum(mask), min=1.0)
    return torch.mean(nll)


def _ce_sum(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """CE summed (not meaned) over positions."""
    return torch.sum(_lse_minus_label(logits, labels))


def _chunk_ce_sum(x: torch.Tensor, w: torch.Tensor, labels: torch.Tensor):
    logits = constrain(linear(w, x), "batch", "seq", "vocab")
    return _ce_sum(logits, labels)


def fused_lm_head_ce(p: Params, cfg: ModelConfig, x: torch.Tensor,
                     labels: torch.Tensor, *, seq_chunk: int = 512):
    """lm_head matmul + CE fused over sequence chunks.

    Never materializes the full [B,S,V] logits: each chunk's logits are
    produced, consumed, and (under ``checkpoint``) recomputed in the
    backward. The chunk is the largest divisor of S not above
    ``seq_chunk`` (one chunk of S would bring the full logits back)."""
    B, S, _ = x.shape
    if S % seq_chunk != 0:
        seq_chunk = next((c for c in range(seq_chunk, 0, -1)
                          if S % c == 0), S)
    w = p["lm_head"]
    total = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(0, S, seq_chunk):
        xi, li = x[:, i:i + seq_chunk], labels[:, i:i + seq_chunk]
        if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
            part = checkpoint(under_current_rules(_chunk_ce_sum), xi, w, li,
                              use_reentrant=False, preserve_rng_state=False)
        else:
            part = _chunk_ce_sum(xi, w, li)
        total = total + part
    return total / (B * S)


def loss_fn(p: Params, cfg: ModelConfig, batch: dict, *,
            attn_impl: str = "full", ssd_chunk: int = 128,
            unroll: bool = False, fuse_ce: bool | None = None,
            q_chunk: int = 1024, ce_chunk: int = 512):
    """Training loss → (ce + aux, {"ce", "aux"}). ``fuse_ce=None`` fuses
    the head and CE when there is no ``loss_mask`` and S >= 2048.
    ``ssd_chunk`` is the recurrent families' scan chunk; ``unroll`` is
    the reference's knob for its cost pass and is ignored. For VLM with
    ``patch_embeds`` the loss covers the text positions only: the patch
    prefix carries no labels."""
    del unroll
    tb.check_family(cfg)
    labels = batch["labels"]
    n_patch = (batch["patch_embeds"].shape[1]
               if cfg.family == "vlm" and "patch_embeds" in batch else 0)
    if fuse_ce is None:
        fuse_ce = (batch.get("loss_mask") is None
                   and labels.shape[-1] >= 2048)
    if fuse_ce:
        x, positions = _embed(p, cfg, batch)
        x, aux = _backbone(p, cfg, x, positions, attn_impl=attn_impl,
                           ssd_chunk=ssd_chunk, q_chunk=q_chunk)
        if n_patch:
            x = constrain(x, "batch", None, "embed")[:, n_patch:]
        x = constrain(x, "batch", "seq_act", "embed")
        x = norm(p["final_norm"], x, kind=cfg.norm_kind, eps=cfg.norm_eps)
        with region("loss"):
            ce = fused_lm_head_ce(p, cfg, x, labels, seq_chunk=ce_chunk)
        return ce + aux, {"ce": ce, "aux": aux}

    logits, aux = forward(p, cfg, batch, attn_impl=attn_impl,
                          ssd_chunk=ssd_chunk, q_chunk=q_chunk)
    with region("loss"):
        ce = cross_entropy(logits[:, n_patch:], labels,
                           batch.get("loss_mask"))
    return ce + aux, {"ce": ce, "aux": aux}


def prefill(p: Params, cfg: ModelConfig, batch: dict, max_len: int, *,
            attn_impl: str = "chunked", ssd_chunk: int = 128,
            cache_dtype=torch.bfloat16, q_chunk: int = 1024):
    """Inference prefill: forward over the prompt (for VLM, the patch
    embeddings and the tokens), returning (logits of the last position
    [B,1,V], populated cache, cur_len = S). The recurrent state is
    float32 and the conv tails are in the compute dtype, as the
    reference's; ``cache_dtype`` is the KV caches'."""
    _check_decoder(cfg)
    x, positions = _embed(p, cfg, batch)
    S = x.shape[1]
    if cfg.family in tb.ATTN_FAMILIES:
        caches = []
        for pl in p["blocks"]:
            x = constrain(x, "batch", "seq_act", "embed")   # Megatron SP
            x, c = tb.tblock_prefill(pl, cfg, x, positions, max_len,
                                     attn_impl=attn_impl,
                                     cache_dtype=cache_dtype,
                                     q_chunk=q_chunk)
            caches.append(c)
        cache = {"blocks": caches}
    elif cfg.family == "ssm":
        cache = {"pairs": []}
        for pl in p["pairs"]:
            x = constrain(x, "batch", "seq_act", "embed")
            x, c = tb.xlstm_pair_prefill(pl, cfg, x, positions,
                                         chunk=ssd_chunk)
            cache["pairs"].append(c)
    else:
        cache = {"groups": [], "shared_attn": []}
        for pg in p["groups"]:
            x = constrain(x, "batch", "seq_act", "embed")
            x, cg = tb.zamba_group_prefill(pg, cfg, x, chunk=ssd_chunk)
            x, ca = tb.shared_attn_prefill(p["shared_attn"], cfg, x,
                                           positions, max_len,
                                           attn_impl=attn_impl,
                                           cache_dtype=cache_dtype,
                                           q_chunk=q_chunk)
            cache["groups"].append(cg)
            cache["shared_attn"].append(ca)
        if "tail" in p:
            x, cache["tail"] = tb.zamba_group_prefill(p["tail"], cfg, x,
                                                      chunk=ssd_chunk)
    x = norm(p["final_norm"], x, kind=cfg.norm_kind, eps=cfg.norm_eps)
    with region("lm_head"):
        logits = linear(p["lm_head"], x[:, -1:, :])
        logits = constrain(logits, "batch", None, "vocab")
    return logits, cache, torch.tensor(S, dtype=torch.int32,
                                       device=x.device)


# ---------------------------------------------------------------------------
# Cache + decode
# ---------------------------------------------------------------------------

def _check_decoder(cfg: ModelConfig) -> None:
    """Raise for an encoder (audio): it has no cache and no decode."""
    tb.check_family(cfg)
    if cfg.is_encoder:
        raise ValueError(f"{cfg.name} is encoder-only: forward and loss "
                         f"only, no prefill, cache or decode")


def _kv_cache(cfg: ModelConfig, batch: int, max_len: int, dtype,
              dev) -> Params:
    shape = (batch, cfg.n_kv_heads, max_len, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def init_cache(cfg: ModelConfig, batch: int, max_len: int,
               dtype=torch.bfloat16, device="cuda") -> Params:
    """Zero cache, batch first in every tensor. Standard blocks:
    ``{"blocks": [{"k", "v"} per layer]}``, each [batch, KV, max_len,
    dh] in ``dtype``. ssm: ``{"pairs": [{"m": {"C", "n", "m"}, "s": {"c",
    "n", "h", "m"}} per pair]}``, float32. hybrid: ``{"groups": [[{"h",
    "conv_x", "conv_bc"} per layer] per group], "shared_attn": [{"k",
    "v"} per group][, "tail": [{"h", "conv_x", "conv_bc"} per layer]]}``
    (``h`` float32, the conv tails and KV in ``dtype``)."""
    _check_decoder(cfg)
    dev = resolve_device(device)
    if cfg.family in tb.ATTN_FAMILIES:
        return {"blocks": [_kv_cache(cfg, batch, max_len, dtype, dev)
                           for _ in range(cfg.n_layers)]}
    if cfg.family == "ssm":
        return {"pairs": [{"m": mlstm_cache_init(cfg, batch, dev),
                           "s": slstm_cache_init(cfg, batch, dev)}
                          for _ in range(cfg.n_layers // 2)]}
    n_groups, tail = _hybrid_split(cfg)

    def ssm_g(n):
        return [ssm_cache_init(cfg, batch, dtype, dev) for _ in range(n)]
    cache: Params = {
        "groups": [ssm_g(cfg.attn_every) for _ in range(n_groups)],
        "shared_attn": [_kv_cache(cfg, batch, max_len, dtype, dev)
                        for _ in range(n_groups)]}
    if tail:
        cache["tail"] = ssm_g(tail)
    return cache


def reset_cache_slots(cfg: ModelConfig, cache: Params,
                      slot_mask: torch.Tensor) -> Params:
    """Zero the cache state (KV rows and recurrent state) of every True
    entry of ``slot_mask`` [B], in place (slot admission for continuous
    batching: a reused slot must not seed its new request with the
    previous occupant's recurrent state); returns the cache. Batch is
    the first axis of every tensor of the port's caches."""
    _check_decoder(cfg)
    for t in tree_leaves(cache):
        m = slot_mask.to(device=t.device, dtype=torch.bool)
        t.masked_fill_(m.view(-1, *[1] * (t.ndim - 1)), 0)
    return cache


def decode_step(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                cache: Params, cur_len, *,
                write_mask: torch.Tensor | None = None,
                window: int | None = None, sinks: int = 0):
    """One decode step. tokens: [B,S] int; S=1 is the classic
    single-token step, S>1 scores several positions (the speculative
    verify sweep).

    ``cur_len`` is [] or [B] int — per-row cache depth; position j of row
    b lands at cache position ``cur_len[b] + j``. ``write_mask`` [B]
    bool, when given, confines cache mutation to True rows; logits are
    still computed for every row. ``window``/``sinks`` select the
    StreamingLLM sliding-window mask of the speculative draft.

    The recurrent families (ssm, hybrid) advance their state once per
    call: they take S=1 only (several positions go through
    :func:`decode_verify`) and raise ``ValueError`` otherwise.
    ``window``/``sinks`` reach the hybrid's shared attention block.

    The cache is updated in place and returned. Returns
    (logits [B,S,V], cache).
    """
    _check_decoder(cfg)
    if cfg.family in RECURRENT and tokens.shape[1] != 1:
        raise ValueError(f"{cfg.name}: a recurrent decode step takes one "
                         f"position, got {tokens.shape[1]}; score several "
                         f"with decode_verify")
    dt = _compute_dtype(cfg)
    with region("embed"):
        x = p["embed"].to(dt)[tokens]
    x = constrain(x, "batch", None, "embed")
    if cfg.family in tb.ATTN_FAMILIES:
        for pl, cl in zip(p["blocks"], cache["blocks"]):
            x, _ = tb.tblock_decode(pl, cfg, x, cl, cur_len, window=window,
                                    sinks=sinks, write_mask=write_mask)
    elif cfg.family == "ssm":
        for pl, cl in zip(p["pairs"], cache["pairs"]):
            x, _ = tb.xlstm_pair_decode(pl, cfg, x, cl, cur_len,
                                        write_mask=write_mask)
    else:
        for pg, cg, ca in zip(p["groups"], cache["groups"],
                              cache["shared_attn"]):
            x, _ = tb.zamba_group_decode(pg, cfg, x, cg,
                                         write_mask=write_mask)
            x, _ = tb.shared_attn_decode(p["shared_attn"], cfg, x, ca,
                                         cur_len, window=window, sinks=sinks,
                                         write_mask=write_mask)
        if "tail" in cache:
            x, _ = tb.zamba_group_decode(p["tail"], cfg, x, cache["tail"],
                                         write_mask=write_mask)
    x = norm(p["final_norm"], x, kind=cfg.norm_kind, eps=cfg.norm_eps)
    with region("lm_head"):
        logits = linear(p["lm_head"], x)
        logits = constrain(logits, "batch", None, "vocab")
    return logits, cache


def decode_verify(p: Params, cfg: ModelConfig, tokens: torch.Tensor,
                  cache: Params, cur_len, *,
                  write_mask: torch.Tensor | None = None):
    """Self-speculative verify: score L >= 1 positions in one step.

    ``tokens`` [B,L]; position j of row b is the model input at cache
    position ``cur_len[b] + j``. For the KV-cache families this is the
    multi-position :func:`decode_step`: each query row attends over the
    full cache under its own causal mask (a MoE block is dropless there,
    so each row's experts are its own). The recurrent families advance
    state once per call, so they run the single-token step over the L
    positions in turn, exactly as sequential decoding does.
    Returns ``(logits [B,L,V], cache)``.
    """
    if cfg.family not in RECURRENT:
        return decode_step(p, cfg, tokens, cache, cur_len,
                           write_mask=write_mask)
    B, L = tokens.shape
    cl = torch.as_tensor(cur_len, dtype=torch.int32, device=tokens.device)
    cl = cl.expand(B) if cl.ndim == 0 else cl
    logits = []
    for j in range(L):
        lj, cache = decode_step(p, cfg, tokens[:, j:j + 1], cache, cl + j,
                                write_mask=write_mask)
        logits.append(lj)
    return torch.cat(logits, dim=1), cache
