"""The NVIDIA H100 SXM as a ``power_model.HardwareSpec``.

The port runs on one H100, so its roofline terms, its synthesized
timelines and its kernels' bounds are priced at the card's peaks, not at
the TPU v5e's (``power_model.TPU_V5E``, which stays for parity with the
reference). ``power_model.py`` is a byte-equal copy of the reference's,
so the card's spec lives here.

Values are from NVIDIA's H100 Tensor Core GPU data sheet, SXM5 column,
dense rates (without sparsity), at the card's full 700 W power limit.
The spec's field names are the reference's: ``ici_*`` is NVLink here and
``vmem_bytes`` is the shared memory a block may opt in to.

:class:`~repro_torch.core.power_model.PowerModelParams` keeps the
reference's coefficients: joules the activity model prices with this spec
are modelled, not measured on the card (calibrating them from board
power is later work).
"""

from __future__ import annotations

from repro_torch.core.power_model import HardwareSpec

__all__ = ["H100_SXM", "H100_FP64_PER_S"]

H100_SXM = HardwareSpec(
    name="h100-sxm",
    peak_flops_bf16=989e12,          # dense bf16 tensor cores
    hbm_bandwidth=3.35e12,           # HBM3
    ici_bandwidth_per_link=25e9,     # NVLink 4: 50 GB/s a link, both ways
    ici_links=18,
    vmem_bytes=227 * 1024,           # largest opt-in shared memory a block
    hbm_bytes=80 * 10**9,            # 80 GB
)

# Float64 outside the tensor cores, same sheet; HardwareSpec has no field
# for it. It bounds kernels that sum in float64 (``sample_attr``).
H100_FP64_PER_S = 34e12
