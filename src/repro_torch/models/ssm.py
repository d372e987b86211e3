"""Mamba2 (SSD, state-space duality) blocks: chunked train/prefill scan +
O(1) recurrent decode.

Port of ``src/repro/models/ssm.py``. The chunked scan is plain PyTorch
(``einsum``, ``cumsum``, ``exp``) in float32, a Python loop over the
chunks where the reference runs a ``lax.scan``; the reference computes
it outside any Pallas kernel too. The depthwise conv is split as in the
reference: the x-channels and the B/C channels get separate
convolutions. The block's output norm is :func:`layers.rmsnorm`, as the
reference's is.

Dtypes follow the reference: projections and conv run in the compute
dtype, the scan, its state ``h`` and the skip term in float32; the conv
tails a prefill returns are in the compute dtype, and the zero cache of
:func:`ssm_cache_init` holds them in the cache dtype.
"""

from __future__ import annotations

import functools
import math

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import resolve_device
from repro_torch.core.regions import region
from repro_torch.models.layers import Params, dense_init, linear, rmsnorm
from repro_torch.sharding.rules import blockwise, constrain

__all__ = ["ssm_init", "ssm_forward", "ssm_decode", "ssm_cache_init"]

F32 = torch.float32


def _dims(cfg: ModelConfig):
    d_in = cfg.ssm_expand * cfg.d_model
    heads = d_in // cfg.ssm_head_dim
    return d_in, heads, cfg.ssm_head_dim, cfg.ssm_state


def ssm_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    """A Mamba2 layer's float32 weights, drawn from ``generator``."""
    d = cfg.d_model
    d_in, H, hd, N = _dims(cfg)
    dev = generator.device

    def normal(*shape):
        return torch.randn(shape, generator=generator, dtype=F32, device=dev)

    u = torch.rand(H, generator=generator, dtype=F32, device=dev)
    log_dt = math.log(1e-3) + u * (math.log(1e-1) - math.log(1e-3))
    return {
        "in_x": dense_init(generator, d, d_in),
        "in_z": dense_init(generator, d, d_in),
        "in_bc": dense_init(generator, d, 2 * N),
        "in_dt": dense_init(generator, d, H),
        "conv_x": 0.1 * normal(cfg.ssm_conv, d_in),
        "conv_bc": 0.1 * normal(cfg.ssm_conv, 2 * N),
        "A_log": torch.log(torch.linspace(1.0, 16.0, H, dtype=F32,
                                          device=dev)),
        "D": torch.ones(H, dtype=F32, device=dev),
        "dt_bias": torch.log(torch.expm1(torch.exp(log_dt))),
        "norm": {"scale": torch.ones(d_in, dtype=F32, device=dev)},
        "out": dense_init(generator, d_in, d),
    }


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: torch.Tensor | None = None):
    """Depthwise causal conv. x: [B,S,C], w: [K,C]. state: [B,K-1,C] tail
    of the previous tokens (decode). Returns (silu(y) [B,S,C], new tail
    [B,K-1,C]); the K taps are summed in order, in x's dtype. On
    DTensors per block of rows and channels (the sequence whole)."""
    return blockwise(_causal_conv_local, x, (0, 2),
                     [(x, (0, 2)), (w, (None, 1)), (state, (0, 2))],
                     [(0, 2), (0, 2)])


def _causal_conv_local(x, w, state):
    K = w.shape[0]
    if state is None:
        pad = torch.zeros((x.shape[0], K - 1, x.shape[2]), dtype=x.dtype,
                          device=x.device)
    else:
        pad = state.to(x.dtype)
    xp = torch.cat([pad, x], dim=1)                 # [B, S+K-1, C]
    S = x.shape[1]
    y = sum(xp[:, i:i + S, :] * w[i].to(x.dtype) for i in range(K))
    new_state = xp[:, -(K - 1):, :] if K > 1 else pad
    return F.silu(y), new_state


def _ssd_inputs(p: Params, cfg: ModelConfig, u: torch.Tensor,
                conv_x_state=None, conv_bc_state=None):
    """Project u [B,S,d] → (x [B,S,H,hd], Bmat/Cmat [B,S,N], dt [B,S,H]
    float32, z [B,S,d_in], conv tails)."""
    d_in, H, hd, N = _dims(cfg)
    z = linear(p["in_z"], u)
    x = linear(p["in_x"], u)
    bc = linear(p["in_bc"], u)
    x = constrain(x, "batch", "seq", "conv_dim")
    x, cxs = _causal_conv(x, p["conv_x"], conv_x_state)
    bc, cbs = _causal_conv(bc, p["conv_bc"], conv_bc_state)
    Bmat, Cmat = bc[..., :N], bc[..., N:]
    dt = F.softplus(linear(p["in_dt"], u).to(F32) + p["dt_bias"])
    x = x.reshape(*x.shape[:2], H, hd)
    return x, Bmat, Cmat, dt, z, cxs, cbs


def _ssd_chunk(h, xq, Bq, Cq, dAq, dtq):
    """One chunk of the SSD scan (the reference's ``lax.scan`` body), all
    float32. xq [B,Q,H,hd]; Bq/Cq [B,Q,N]; dAq/dtq [B,Q,H]; h
    [B,H,hd,N]. Returns (h', y [B,Q,H,hd])."""
    Q = xq.shape[1]
    cs = torch.cumsum(dAq, dim=1)                           # [B,Q,H]
    total = cs[:, -1]                                       # [B,H]
    # Intra-chunk (masked) attention: L[i,j] = exp(cs_i - cs_j), i >= j.
    # The mask goes on the exponent, not on exp's result (the
    # reference's order): exp(cs_i - cs_j) for j > i overflows once a
    # chunk decays by more than ~88, and inf times the mask's zero
    # gradient is NaN in the backward. The forward values are the same.
    diff = cs[:, :, None, :] - cs[:, None, :, :]            # [B,Q,Q,H]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=xq.device))
    L = torch.exp(torch.where(mask[None, :, :, None], diff,
                              torch.full((), -torch.inf, dtype=F32,
                                         device=xq.device)))
    scores = torch.einsum("bin,bjn->bij", Cq, Bq)           # [B,Q,Q]
    att = scores[..., None] * L * dtq[:, None, :, :]        # [B,Q,Q,H]
    y_intra = torch.einsum("bijh,bjhp->bihp", att, xq)
    # Inter-chunk: contribution of the carried state.
    y_inter = torch.exp(cs)[..., None] * torch.einsum(
        "bin,bhpn->bihp", Cq, h)
    # State update: h' = exp(total)·h + Σ_j exp(total - cs_j)·dt_j·B_j x_j.
    w = torch.exp(total[:, None] - cs) * dtq                # [B,Q,H]
    h_new = (torch.exp(total)[:, :, None, None] * h
             + torch.einsum("bjh,bjn,bjhp->bhpn", w, Bq, xq))
    return h_new, y_intra + y_inter


def _ssd_chunked(x, Bmat, Cmat, dt, A, *, chunk: int):
    """Chunked SSD scan.

    x: [B,S,H,hd]; Bmat/Cmat: [B,S,N]; dt: [B,S,H] (float32); A: [H]
    (float32, < 0). Returns (y [B,S,H,hd] float32, h_final [B,H,hd,N]).
    """
    Bsz, S, H, hd = x.shape
    N = Bmat.shape[-1]
    assert S % chunk == 0, (S, chunk)
    dA = dt * A                                             # [B,S,H] (<= 0)
    h = torch.zeros((Bsz, H, hd, N), dtype=F32, device=x.device)
    xf, Bf, Cf = x.to(F32), Bmat.to(F32), Cmat.to(F32)
    ys = []
    for i in range(0, S, chunk):
        sl = slice(i, i + chunk)
        h, y = _ssd_chunk(h, xf[:, sl], Bf[:, sl], Cf[:, sl], dA[:, sl],
                          dt[:, sl])
        ys.append(y)
    return torch.cat(ys, dim=1), h


def _ssm_out(p: Params, cfg: ModelConfig, y: torch.Tensor, z: torch.Tensor,
             u: torch.Tensor) -> torch.Tensor:
    """Gate and norm ahead of the output projection: y [B,S,H,hd]
    float32 → [B,S,d_in] in u's dtype."""
    d_in = _dims(cfg)[0]
    y = y.reshape(*u.shape[:2], d_in).to(u.dtype)
    y = y * F.silu(z)
    return rmsnorm(p["norm"], y, eps=cfg.norm_eps)


def ssm_forward(p: Params, cfg: ModelConfig, u: torch.Tensor, *,
                chunk: int = 128, return_cache: bool = False):
    """Full-sequence Mamba2 block (train / prefill). u: [B,S,d] → [B,S,d].

    With ``return_cache`` also returns the recurrent cache (final SSM
    state + conv tails), i.e. the prefill path."""
    with region("ssm_proj"):
        x, Bmat, Cmat, dt, z, cxs, cbs = _ssd_inputs(p, cfg, u)
    A = -torch.exp(p["A_log"])
    with region("ssm_scan"):
        # per block of rows and heads on DTensors
        y, h_final = blockwise(
            functools.partial(_ssd_chunked, chunk=min(chunk, u.shape[1])),
            x, (0, 2), [(x, (0, 2)), (Bmat, (0, None)), (Cmat, (0, None)),
                        (dt, (0, 2)), (A, (None, 0))], [(0, 2), (0, 1)])
        y = y + p["D"][None, None, :, None] * x.to(F32)
    y = _ssm_out(p, cfg, y, z, u)
    with region("ssm_out"):
        out = linear(p["out"], y)
    out = constrain(out, "batch", "seq", "embed")
    if return_cache:
        # The tails are slices of the padded input: copy them out so the
        # cache does not hold the whole sequence.
        return out, {"h": h_final, "conv_x": cxs.clone(),
                     "conv_bc": cbs.clone()}
    return out


def ssm_cache_init(cfg: ModelConfig, batch: int, dtype=F32,
                   device="cuda") -> Params:
    """Zero state: ``h`` [B,H,hd,N] float32, conv tails [B,K-1,·] in
    ``dtype``."""
    d_in, H, hd, N = _dims(cfg)
    K = cfg.ssm_conv
    dev = resolve_device(device)
    return {
        "h": torch.zeros((batch, H, hd, N), dtype=F32, device=dev),
        "conv_x": torch.zeros((batch, K - 1, d_in), dtype=dtype, device=dev),
        "conv_bc": torch.zeros((batch, K - 1, 2 * N), dtype=dtype,
                               device=dev),
    }


def _ssm_decode_core(h, xq, Bq, Cq, dtq, A, D):
    """The single-token state update and read-out (float32)."""
    decay = torch.exp(dtq * A)                              # [B,H]
    h = h * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhpn", dtq, Bq, xq)
    y = torch.einsum("bn,bhpn->bhp", Cq, h) + D[None, :, None] * xq
    return y, h


def ssm_decode(p: Params, cfg: ModelConfig, u: torch.Tensor, cache: Params):
    """Single-token recurrent update. u: [B,1,d]. Returns (y, new state):
    the new state is a dict of fresh tensors; ``cache`` is only read."""
    x, Bmat, Cmat, dt, z, cxs, cbs = _ssd_inputs(
        p, cfg, u, cache["conv_x"], cache["conv_bc"])
    A = -torch.exp(p["A_log"])
    xq = x[:, 0].to(F32)                                    # [B,H,hd]
    Bq = Bmat[:, 0].to(F32)                                 # [B,N]
    Cq = Cmat[:, 0].to(F32)
    dtq = dt[:, 0]                                          # [B,H]
    with region("ssm_decode"):
        y, h = blockwise(
            _ssm_decode_core, xq, (0, 1),
            [(cache["h"], (0, 1)), (xq, (0, 1)), (Bq, (0, None)),
             (Cq, (0, None)), (dtq, (0, 1)), (A, (None, 0)),
             (p["D"], (None, 0))], [(0, 1), (0, 1)])
    out = linear(p["out"], _ssm_out(p, cfg, y, z, u))
    return out, {"h": h, "conv_x": cxs, "conv_bc": cbs}
