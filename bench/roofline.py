"""Published peaks of the chips the benchmark runs on, and the least time
of the work it measures against them.

NVIDIA H100 SXM5 data sheet, dense rates without sparsity, at the full
700 W power limit: 3.35 TB/s of HBM3 bandwidth, 34 TFLOP/s of float64 on
the CUDA cores (67 on the tensor cores, which a scatter of sums cannot
use), 989 TFLOP/s of bf16 on the tensor cores.
"""

from __future__ import annotations

PEAKS = {
    "NVIDIA H100 80GB HBM3": dict(hbm_bytes_per_s=3.35e12,
                                  fp64_flops=34e12, bf16_flops=989e12),
}


def peaks(kind: str) -> dict:
    """The peaks of the card named ``kind`` (``torch.cuda.get_device_name``);
    an H100 of another name takes the SXM part's."""
    return PEAKS.get(kind, PEAKS["NVIDIA H100 80GB HBM3"])


def fold_least_seconds(fold: dict, kind: str) -> tuple[float, str]:
    """The least time of folding a profile's samples into per-row
    (count, Σpow, Σpow²) of ``channels`` channels, whatever implements it:
    each in-horizon sample's id (4 B) and channel powers (8 B each) read
    once, every lane's mask byte read once, and each chunk's carry rows
    that its samples touch (an 8 B count and 2 × 8 B sums a channel) read
    and written once, against HBM bandwidth; or 1 + 3 × channels float64
    operations a sample against the float64 peak, whichever is longer.
    Returns (seconds, "bytes" | "operations")."""
    p = peaks(kind)
    C = fold["channels"]
    nbytes = (fold["samples"] * (4 + 8 * C) + fold["lanes"]
              + 2 * fold["touched"] * (1 + 2 * C) * 8)
    ops = fold["samples"] * (1 + 3 * C)
    t_bytes = nbytes / p["hbm_bytes_per_s"]
    t_ops = ops / p["fp64_flops"]
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")
