"""Architecture registry: --arch <id> → ModelConfig (+ shape applicability).

Per-assignment skips (documented in DESIGN.md §4):
  * ``long_500k`` runs only for sub-quadratic archs (ssm/hybrid);
  * encoder-only archs (hubert) have no decode step.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import SHAPES, ModelConfig, ShapeConfig

_MODULES = {
    "qwen3-moe-30b-a3b": "qwen3_moe_30b_a3b",
    "granite-moe-1b-a400m": "granite_moe_1b_a400m",
    "internvl2-1b": "internvl2_1b",
    "qwen3-1.7b": "qwen3_1_7b",
    "yi-6b": "yi_6b",
    "starcoder2-15b": "starcoder2_15b",
    "stablelm-3b": "stablelm_3b",
    "xlstm-125m": "xlstm_125m",
    "hubert-xlarge": "hubert_xlarge",
    "zamba2-1.2b": "zamba2_1_2b",
}

ARCH_IDS = tuple(_MODULES)


def get_config(arch: str) -> ModelConfig:
    if arch not in _MODULES:
        raise KeyError(f"unknown arch {arch!r}; known: {ARCH_IDS}")
    mod = importlib.import_module(f"repro_torch.configs.{_MODULES[arch]}")
    return mod.CONFIG


def shape_applicable(cfg: ModelConfig, shape: ShapeConfig) -> tuple[bool, str]:
    """(runnable, reason-if-skipped) for an (arch × shape) cell."""
    if shape.is_decode and cfg.is_encoder:
        return False, "encoder-only arch has no decode step"
    if (shape.name == "long_500k"
            and cfg.family not in ("ssm", "hybrid")):
        return False, "long_500k needs sub-quadratic attention (full-attn arch)"
    if shape.name == "long_500k" and cfg.is_encoder:
        return False, "encoder-only arch has no decode step"
    return True, ""


def all_cells():
    """Yield (arch_id, shape, runnable, reason) for the 40 assigned cells."""
    for arch in ARCH_IDS:
        cfg = get_config(arch)
        for shape in SHAPES.values():
            ok, why = shape_applicable(cfg, shape)
            yield arch, shape, ok, why
