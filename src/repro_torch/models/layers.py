"""Foundational layers (plain PyTorch functions): norms, linears, rope,
embeddings.

Parameters are plain dicts of tensors, laid out as the reference's pytrees
(``src/repro/models/layers.py``) so that converting its weights is a tree
map. Initializers take an explicit ``torch.Generator`` and allocate on the
generator's device; the norms' initializers take none and allocate on
``device``, the GPU unless the caller asks for the CPU
(:func:`repro_torch.convert.resolve_device`). Compute dtype is the activation's; parameters may be
kept in float32 (master weights) and are cast at use sites.
"""

from __future__ import annotations

import functools
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.convert import resolve_device
from repro_torch.sharding.rules import whole_middle, whole_middle_grad

Params = dict[str, Any]

__all__ = ["Params", "apply_rope", "dense_init", "embed_init",
           "layernorm", "layernorm_init", "linear", "mlp", "mlp_init",
           "norm", "norm_init", "rmsnorm", "rmsnorm_init",
           "rope_frequencies", "sinusoidal_positions"]


# -- init ---------------------------------------------------------------------

def _trunc_normal(generator: torch.Generator, shape, std: float):
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, 0.0, 1.0, -3.0, 3.0, generator=generator)
    return t.mul_(std)


def dense_init(generator: torch.Generator, d_in: int, d_out: int, *,
               scale: float | None = None) -> torch.Tensor:
    """Truncated-normal fan-in init (LLM-standard)."""
    std = scale if scale is not None else d_in ** -0.5
    return _trunc_normal(generator, (d_in, d_out), std)


def embed_init(generator: torch.Generator, vocab: int, d: int, *,
               scale: float = 0.02) -> torch.Tensor:
    return _trunc_normal(generator, (vocab, d), scale)


# -- norms --------------------------------------------------------------------

def rmsnorm_init(d: int, device="cuda") -> Params:
    return {"scale": torch.ones(d, dtype=torch.float32,
                                device=resolve_device(device))}


def rmsnorm(p: Params, x: torch.Tensor, *, eps: float = 1e-5
            ) -> torch.Tensor:
    """RMSNorm in fp32 accumulation, output in input dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps) * p["scale"]).to(x.dtype)


def layernorm_init(d: int, device="cuda") -> Params:
    dev = resolve_device(device)
    return {"scale": torch.ones(d, dtype=torch.float32, device=dev),
            "bias": torch.zeros(d, dtype=torch.float32, device=dev)}


def layernorm(p: Params, x: torch.Tensor, *, eps: float = 1e-5
              ) -> torch.Tensor:
    xf = x.to(torch.float32)
    mu = torch.mean(xf, dim=-1, keepdim=True)
    var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
    y = (xf - mu) * torch.rsqrt(var + eps) * p["scale"] + p["bias"]
    return y.to(x.dtype)


def norm(p: Params, x: torch.Tensor, *, kind: str = "rms",
         eps: float = 1e-5) -> torch.Tensor:
    if kind == "rms":
        return rmsnorm(p, x, eps=eps)
    return layernorm(p, x, eps=eps)


def norm_init(d: int, kind: str = "rms", device="cuda") -> Params:
    return (rmsnorm_init(d, device) if kind == "rms"
            else layernorm_init(d, device))


# -- linear -------------------------------------------------------------------

def linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x @ w with weight cast to activation dtype (a no-op for weights
    already held in the compute dtype). On DTensors the matmul flattens
    the leading dims both ways, so a middle-dim shard of ``x`` (the
    sequence, under Megatron SP) is gathered first, and so is one of the
    output's gradient (:func:`repro_torch.sharding.rules.whole_middle`,
    :func:`~repro_torch.sharding.rules.whole_middle_grad`)."""
    return whole_middle_grad(whole_middle(x) @ w.to(x.dtype))


# -- MLPs ---------------------------------------------------------------------

def mlp_init(generator: torch.Generator, d: int, d_ff: int, *,
             gated: bool = True) -> Params:
    p: Params = {"up": dense_init(generator, d, d_ff),
                 "down": dense_init(generator, d_ff, d)}
    if gated:
        p["gate"] = dense_init(generator, d, d_ff)
    return p


def _act(name: str):
    # jax.nn.gelu defaults to the tanh approximation.
    if name == "silu":
        return F.silu
    return lambda t: F.gelu(t, approximate="tanh")


def mlp(p: Params, x: torch.Tensor, *, gated: bool = True,
        act: str = "silu") -> torch.Tensor:
    a = _act(act)
    up = linear(p["up"], x)
    h = a(linear(p["gate"], x)) * up if gated else a(up)
    return linear(p["down"], h)


# -- rotary embeddings ----------------------------------------------------------

def rope_frequencies(d_head: int, theta: float = 1e4) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float32)
                            / d_head))


@functools.lru_cache(maxsize=None)
def _rope_freqs(d_head: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """:func:`rope_frequencies` on ``device``, made once per key and
    shared read-only: a host-to-device copy at every call would hold each
    decode step's layers to the host."""
    return torch.from_numpy(rope_frequencies(d_head, theta)).to(device)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float = 1e4) -> torch.Tensor:
    """Rotate interleaved pairs (``0::2``, ``1::2``) in float32.
    x: [B, H, S, d_head] or [B, S, d_head]; positions: [B, S]."""
    d_head = x.shape[-1]
    freqs = _rope_freqs(d_head, theta, x.device)
    angles = positions[..., :, None].to(torch.float32) * freqs  # [B,S,d/2]
    cos, sin = torch.cos(angles), torch.sin(angles)
    if x.ndim == 4:  # insert head axis
        cos, sin = cos[:, None], sin[:, None]
    xf1 = x[..., 0::2].to(torch.float32)
    xf2 = x[..., 1::2].to(torch.float32)
    r1 = xf1 * cos - xf2 * sin
    r2 = xf1 * sin + xf2 * cos
    return torch.stack([r1, r2], dim=-1).reshape(x.shape).to(x.dtype)


def sinusoidal_positions(seq: int, d: int) -> np.ndarray:
    """Absolute sinusoidal table (encoder models without RoPE)."""
    pos = np.arange(seq, dtype=np.float32)[:, None]
    i = np.arange(d // 2, dtype=np.float32)[None, :]
    ang = pos / np.power(10000.0, 2 * i / d)
    out = np.zeros((seq, d), dtype=np.float32)
    out[:, 0::2] = np.sin(ang)
    out[:, 1::2] = np.cos(ang)
    return out
