"""xLSTM blocks: mLSTM (matrix memory, chunkwise-parallel) + sLSTM (scalar
memory, strictly recurrent scan — the architecture's stated property).

Port of ``src/repro/models/xlstm.py``. mLSTM follows the paper's
stabilized exponential gating: running stabilizer m, stabilized state
(C̃, ñ) with true state C = C̃·exp(m); the chunkwise form processes
Q-token chunks with an intra-chunk masked (gated) attention and an
inter-chunk recurrent carry, a Python loop over the chunks where the
reference runs a ``lax.scan``. sLSTM is a Python loop over the sequence.
The gates, the stabilizers and every recurrent state are float32, as in
the reference; projections run in the compute dtype. The mLSTM output
norm is :func:`layers.rmsnorm`, as the reference's is.
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ModelConfig
from repro_torch.convert import resolve_device
from repro_torch.core.regions import region
from repro_torch.models.layers import Params, dense_init, linear, rmsnorm
from repro_torch.sharding.rules import blockwise, constrain

__all__ = ["mlstm_init", "mlstm_forward", "mlstm_decode", "mlstm_cache_init",
           "slstm_init", "slstm_forward", "slstm_decode", "slstm_cache_init"]

NEG = -1e30
F32 = torch.float32


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------

def mlstm_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, H, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    dev = generator.device
    return {
        "wq": dense_init(generator, d, H * hd),
        "wk": dense_init(generator, d, H * hd),
        "wv": dense_init(generator, d, H * hd),
        "wif": dense_init(generator, d, 2 * H),  # input & forget pre-acts
        "wo": dense_init(generator, H * hd, d, scale=(H * hd) ** -0.5),
        "ogate": dense_init(generator, d, H * hd),
        "norm": {"scale": torch.ones(H * hd, dtype=F32, device=dev)},
        "f_bias": 3.0 * torch.ones(H, dtype=F32, device=dev),  # open gates
    }


def _mlstm_qkv(p: Params, cfg: ModelConfig, x: torch.Tensor):
    """x [B,S,d] → q/k/v [B,H,S,hd] (compute dtype), input and forget
    gate pre-activations gi/gf [B,H,S] (float32)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim

    def heads(w):
        return linear(w, x).reshape(B, S, H, hd).transpose(1, 2)
    q, k, v = heads(p["wq"]), heads(p["wk"]), heads(p["wv"])
    q = constrain(q, "batch", "heads", "seq", "head_dim")
    k = constrain(k, "batch", "heads", "seq", "head_dim")
    v = constrain(v, "batch", "heads", "seq", "head_dim")
    gif = linear(p["wif"], x).to(F32)
    gi = gif[..., :H].transpose(1, 2)                       # [B,H,S]
    gf = gif[..., H:].transpose(1, 2) + p["f_bias"][None, :, None]
    return q, k, v, gi, gf


def _mlstm_chunk_body(carry, inp, *, scale):
    """One chunk. carry: (C̃ [B,H,dk,dv], ñ [B,H,dk], m [B,H]); inp: q/k/v
    [B,H,Q,hd] and gi/lf [B,H,Q]. Returns (carry', y [B,H,Q,hd])."""
    Ct, nt, m = carry
    q, k, v, gi, lf = inp
    q, k, v = q.to(F32), k.to(F32), v.to(F32)
    Q = q.shape[2]
    Fcs = torch.cumsum(lf, dim=2)                           # [B,H,Q]
    # Intra-chunk log weights W[i,j] = Fcs_i − Fcs_j + gi_j  (i ≥ j).
    W = Fcs[..., :, None] - Fcs[..., None, :] + gi[..., None, :]
    mask = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=q.device))
    W = torch.where(mask, W, torch.full((), NEG, dtype=F32,
                                        device=q.device))
    inter = Fcs + m[..., None]                              # [B,H,Q]
    m_i = torch.maximum(W.amax(-1), inter)                  # row stabilizer
    w = torch.exp(W - m_i[..., None])                       # [B,H,Q,Q]
    s_inter = torch.exp(inter - m_i)                        # [B,H,Q]
    qk = torch.einsum("bhid,bhjd->bhij", q, k) * scale
    num = (torch.einsum("bhij,bhjd->bhid", w * qk, v)
           + s_inter[..., None] * torch.einsum("bhid,bhdv->bhiv",
                                               q * scale, Ct))
    # ñ_i = Σ_j w_ij k_j + s_inter_i · ñ   (denominator vector)
    nvec = (torch.einsum("bhij,bhjd->bhid", w, k)
            + s_inter[..., None] * nt[:, :, None, :])
    denom = torch.abs(torch.einsum("bhid,bhid->bhi", q * scale, nvec))
    denom = torch.maximum(denom, torch.exp(-m_i))
    y = num / denom[..., None]                              # [B,H,Q,hd]
    # Chunk-end state update.
    Ftot = Fcs[..., -1]                                     # [B,H]
    wj = Ftot[..., None] - Fcs + gi                         # [B,H,Q]
    m_new = torch.maximum(Ftot + m, wj.amax(-1))
    sC = torch.exp(Ftot + m - m_new)
    wj = torch.exp(wj - m_new[..., None])
    C_new = (sC[..., None, None] * Ct
             + torch.einsum("bhj,bhjd,bhjv->bhdv", wj, k, v))
    n_new = sC[..., None] * nt + torch.einsum("bhj,bhjd->bhd", wj, k)
    return (C_new, n_new, m_new), y


def _mlstm_out(p: Params, cfg: ModelConfig, x: torch.Tensor,
               y: torch.Tensor) -> torch.Tensor:
    """Norm, output gate and projection: y [B,S,H·hd] float32 → [B,S,d]."""
    og = torch.sigmoid(linear(p["ogate"], x))
    y = rmsnorm(p["norm"], y.to(x.dtype), eps=cfg.norm_eps) * og
    return linear(p["wo"], y)


def mlstm_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                  chunk: int = 128, return_cache: bool = False):
    """Full-sequence mLSTM. x: [B,S,d] → [B,S,d]; with ``return_cache``
    also the final state {"C", "n", "m"} (prefill)."""
    B, S, _ = x.shape
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v, gi, gf = _mlstm_qkv(p, cfg, x)
    Q = min(chunk, S)
    assert S % Q == 0
    with region("mlstm_scan"):
        # per block of rows and heads on DTensors
        y, Cf, nf, mf = blockwise(
            functools.partial(_mlstm_scan, Q=Q, scale=hd ** -0.5), q, (0, 1),
            [(q, (0, 1)), (k, (0, 1)), (v, (0, 1)), (gi, (0, 1)),
             (gf, (0, 1))], [(0, 1)] * 4)
        carry = (Cf, nf, mf)
    y = y.transpose(1, 2).reshape(B, S, H * hd)
    out = constrain(_mlstm_out(p, cfg, x, y), "batch", "seq", "embed")
    if return_cache:
        Cf, nf, mf = carry
        return out, {"C": Cf, "n": nf, "m": mf}
    return out


def _mlstm_scan(q, k, v, gi, gf, *, Q: int, scale: float):
    """The chunk loop over q/k/v [B,H,S,hd], gi/gf [B,H,S] → (y
    [B,H,S,hd] float32, C̃, ñ, m)."""
    B, H, S, hd = q.shape
    lf = F.logsigmoid(gf)
    carry = (torch.zeros((B, H, hd, hd), dtype=F32, device=q.device),
             torch.zeros((B, H, hd), dtype=F32, device=q.device),
             torch.zeros((B, H), dtype=F32, device=q.device))
    ys = []
    for i in range(0, S, Q):
        sl = slice(i, i + Q)
        carry, yi = _mlstm_chunk_body(
            carry, (q[:, :, sl], k[:, :, sl], v[:, :, sl], gi[..., sl],
                    lf[..., sl]), scale=scale)
        ys.append(yi)
    return (torch.cat(ys, dim=2),) + tuple(carry)


def mlstm_cache_init(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    H, hd = cfg.n_heads, cfg.head_dim
    dev = resolve_device(device)
    return {"C": torch.zeros((batch, H, hd, hd), dtype=F32, device=dev),
            "n": torch.zeros((batch, H, hd), dtype=F32, device=dev),
            "m": torch.zeros((batch, H), dtype=F32, device=dev)}


def mlstm_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache):
    """Single-token recurrent mLSTM. x: [B,1,d]. Returns (y, new state);
    ``cache`` is only read."""
    B = x.shape[0]
    H, hd = cfg.n_heads, cfg.head_dim
    q, k, v, gi, gf = _mlstm_qkv(p, cfg, x)
    with region("mlstm_decode"):
        y, C, n, m_new = blockwise(
            functools.partial(_mlstm_step, scale=hd ** -0.5), q, (0, 1),
            [(q, (0, 1)), (k, (0, 1)), (v, (0, 1)), (gi, (0, 1)),
             (gf, (0, 1)), (cache["C"], (0, 1)), (cache["n"], (0, 1)),
             (cache["m"], (0, 1))], [(0, 1)] * 4)
        y = y.reshape(B, 1, H * hd)
    return _mlstm_out(p, cfg, x, y), {"C": C, "n": n, "m": m_new}


def _mlstm_step(q, k, v, gi, gf, C, n, m, *, scale: float):
    """One recurrent step from q/k/v [B,H,1,hd], gi/gf [B,H,1] and the
    state → (y [B,H,hd], C, n, m)."""
    lf = F.logsigmoid(gf)[..., 0]                           # [B,H]
    gi = gi[..., 0]
    qs = q[:, :, 0].to(F32) * scale
    ks = k[:, :, 0].to(F32)
    vs = v[:, :, 0].to(F32)
    m_new = torch.maximum(lf + m, gi)
    f_ = torch.exp(lf + m - m_new)
    i_ = torch.exp(gi - m_new)
    C = f_[..., None, None] * C + i_[..., None, None] * (
        ks[..., :, None] * vs[..., None, :])
    n = f_[..., None] * n + i_[..., None] * ks
    num = torch.einsum("bhd,bhdv->bhv", qs, C)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qs, n)),
                        torch.exp(-m_new))
    return num / den[..., None], C, n, m_new


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------

def slstm_init(generator: torch.Generator, cfg: ModelConfig) -> Params:
    d, H = cfg.d_model, cfg.n_heads
    hd = d // H
    dev = generator.device
    return {
        "w": dense_init(generator, d, 4 * d),
        "r": 0.1 * torch.randn((H, hd, 4 * hd), generator=generator,
                               dtype=F32, device=dev),
        "b": torch.cat([torch.zeros(2 * d, dtype=F32, device=dev),
                        3.0 * torch.ones(d, dtype=F32, device=dev),
                        torch.zeros(d, dtype=F32, device=dev)]),
        "wo": dense_init(generator, d, d),
    }


def _slstm_step(p, cfg, carry, xw_t):
    """carry: (c, n, h, m) each [B,d] float32; xw_t: [B,4d], the
    x-projection at t (float32: the reference adds it to the float32
    recurrence, which promotes it)."""
    c, n, h, m = carry
    B, d = h.shape
    H = cfg.n_heads
    hh = h.reshape(B, H, d // H)
    rec = torch.einsum("bhi,hij->bhj", hh, p["r"]).reshape(B, 4 * d)
    zifo = xw_t + rec + p["b"]
    zt, it, ft, ot = torch.split(zifo, d, dim=-1)
    m_new = torch.maximum(ft + m, it)              # log-space stabilizer
    i_ = torch.exp(it - m_new)
    f_ = torch.exp(ft + m - m_new)
    c_new = f_ * c + i_ * torch.tanh(zt)
    n_new = f_ * n + i_
    h_new = torch.sigmoid(ot) * c_new / torch.clamp(n_new, min=1e-6)
    return c_new, n_new, h_new, m_new


def slstm_cache_init(cfg: ModelConfig, batch: int, device="cuda") -> Params:
    dev = resolve_device(device)
    return {k: torch.zeros((batch, cfg.d_model), dtype=F32, device=dev)
            for k in ("c", "n", "h", "m")}


def slstm_forward(p: Params, cfg: ModelConfig, x: torch.Tensor, *,
                  return_cache: bool = False):
    """Strictly-recurrent sLSTM over the sequence. x: [B,S,d]; with
    ``return_cache`` also the final state {"c", "n", "h", "m"}."""
    B, S, d = x.shape
    xw = linear(p["w"], x).to(F32)                          # [B,S,4d]
    with region("slstm_scan"):
        # per block of rows on DTensors
        y, *carry = blockwise(
            functools.partial(_slstm_scan, cfg=cfg), xw, (0, None),
            [(xw, (0, None)), (p["r"], (None, None)),
             (p["b"], (None, None))], [(0, None)] * 5)
    y = y.to(x.dtype)                                       # [B,S,d]
    out = constrain(linear(p["wo"], y), "batch", "seq", "embed")
    if return_cache:
        return out, dict(zip(("c", "n", "h", "m"), carry))
    return out


def _slstm_scan(xw, r, b, *, cfg: ModelConfig):
    """The recurrence over xw [B,S,4d] → (h [B,S,d], c, n, h, m)."""
    B, S = xw.shape[:2]
    d = xw.shape[-1] // 4
    carry = tuple(torch.zeros((B, d), dtype=F32, device=xw.device)
                  for _ in range(4))
    hs = []
    for t in range(S):
        carry = _slstm_step({"r": r, "b": b}, cfg, carry, xw[:, t])
        hs.append(carry[2])
    return (torch.stack(hs, dim=1),) + tuple(carry)


def slstm_decode(p: Params, cfg: ModelConfig, x: torch.Tensor, cache):
    """Single-token sLSTM. x: [B,1,d]. Returns (y, new state); ``cache``
    is only read."""
    xw = linear(p["w"], x)[:, 0].to(F32)

    def step(xw, r, b, *state):
        return _slstm_step({"r": r, "b": b}, cfg, state, xw)
    carry = blockwise(step, xw, (0, None),
                      [(xw, (0, None)), (p["r"], (None, None)),
                       (p["b"], (None, None))]
                      + [(cache[k], (0, None)) for k in ("c", "n", "h", "m")],
                      [(0, None)] * 4)
    y = linear(p["wo"], carry[2][:, None, :].to(x.dtype))
    return y, dict(zip(("c", "n", "h", "m"), carry))
