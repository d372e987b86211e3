"""Plain PyTorch version of fused RMSNorm.

``x · rsqrt(mean(x²) + eps) · scale`` over the last axis, accumulated in
float32, output in ``x``'s dtype: the counterpart of the JAX package's
``kernels/rmsnorm/ref.py``. The CPU path of
:mod:`repro_torch.kernels.rmsnorm.ops` runs it, and ``chip_smoke.py``
holds the CUDA kernel (``rmsnorm.cu``) against it on the GPU.
"""

from __future__ import annotations

import torch

__all__ = ["rmsnorm_ref"]


def rmsnorm_ref(x, scale, *, eps: float = 1e-5):
    """x: [..., d]; scale: [d]. fp32 accumulation, output in x.dtype."""
    xf = x.to(torch.float32)
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * scale.to(torch.float32)).to(x.dtype)
