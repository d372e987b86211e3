"""int8 gradient compression with error feedback (distributed-optimization
trick for scale-out DP).

Port of ``src/repro/optim/compression.py``. Each gradient leaf is
quantized to int8 with a per-leaf float32 scale, the quantization
residual is kept and added back into the next step's gradient (error
feedback), which preserves convergence (1-bit Adam / EF-SGD literature).
On one card there is no all-reduce to compress: as in the reference, the
quantize → dequantize round trip is applied so the numeric effect equals
the wire-compressed run's. ``torch.round`` rounds half to even, as
``jnp.round`` does, so the int8 codes equal the reference's.

The reference quantizes each of its leaves with one scale, and its
transformer blocks' leaves are stacked over the layers; the port holds
one tensor per layer, so the per-layer slices of one stacked leaf
(:func:`repro_torch.tree.stacked_paths`) share the scale of their
largest magnitude, which is the reference's.
"""

from __future__ import annotations

import torch

from repro_torch.tree import stacked_paths, tree_leaves, tree_map

__all__ = ["compress_init", "compress_decompress", "quantize_int8",
           "dequantize_int8"]


def quantize_int8(x: torch.Tensor):
    """Symmetric per-tensor int8. Returns (q, scale)."""
    xf = x.to(torch.float32)
    scale = _scale(torch.max(torch.abs(xf)))
    return _quantize(xf, scale), scale


def _scale(amax: torch.Tensor) -> torch.Tensor:
    return torch.clamp(amax, min=1e-12) / 127.0


def _quantize(xf: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_init(params) -> dict:
    """Error-feedback residual buffers (float32, zero), shaped like
    ``params``."""
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def compress_decompress(grads, residuals):
    """The quantize → (all-reduce) → dequantize path with error feedback,
    one scale per leaf of the reference's tree. Returns (new_grads,
    new_residuals), new trees."""
    gfs = [g.to(torch.float32) + r for g, r in zip(tree_leaves(grads),
                                                     tree_leaves(residuals))]
    paths = stacked_paths(grads)
    amax: dict = {}
    for path, gf in zip(paths, gfs):
        m = torch.max(torch.abs(gf))
        amax[path] = m if path not in amax else torch.maximum(amax[path], m)
    deqs = [dequantize_int8(_quantize(gf, _scale(amax[path])),
                            _scale(amax[path]))
            for path, gf in zip(paths, gfs)]
    new_g = iter(deqs)
    new_r = iter([gf - d for gf, d in zip(gfs, deqs)])
    return (tree_map(lambda _: next(new_g), grads),
            tree_map(lambda _: next(new_r), grads))
