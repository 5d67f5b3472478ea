"""Assigned architectures (exact configs) and input shapes.

A copy of the reference package's ``configs``: each module defines
CONFIG, and the registry maps ``--arch <id>`` names to them.
``applicable(cfg, shape)`` encodes the skip rules (long_500k needs a
sub-quadratic path).  The reference's ``input_specs``/``cache_specs``
dry-run helpers wait for the port of ``launch/dryrun.py``.
"""
from __future__ import annotations

from dataclasses import dataclass

from ..models.config import ArchConfig
from . import (deepseek_v3_671b, granite_moe_1b_a400m, internvl2_26b,
               llama3_2_1b, qwen2_5_3b, rwkv6_1_6b, smollm_360m,
               starcoder2_3b, whisper_tiny, zamba2_7b)

REGISTRY: dict[str, ArchConfig] = {
    m.CONFIG.name: m.CONFIG
    for m in (qwen2_5_3b, smollm_360m, llama3_2_1b, starcoder2_3b, zamba2_7b,
              deepseek_v3_671b, granite_moe_1b_a400m, rwkv6_1_6b,
              internvl2_26b, whisper_tiny)
}


def get_config(name: str) -> ArchConfig:
    if name not in REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(REGISTRY)}")
    return REGISTRY[name]


@dataclass(frozen=True)
class ShapeSpec:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


SHAPES: dict[str, ShapeSpec] = {
    "train_4k": ShapeSpec("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeSpec("long_500k", 524288, 1, "decode"),
}


def applicable(cfg: ArchConfig, shape: str) -> tuple[bool, str]:
    """(runs?, reason-if-skipped) per the assignment's skip rules."""
    s = SHAPES[shape]
    if s.name == "long_500k" and not cfg.supports_long_context:
        return False, ("pure full-attention arch: O(S^2) attention at 500k "
                       "is intractable; skip per assignment (see DESIGN.md)")
    return True, ""


ARCH_NAMES = sorted(REGISTRY)
SHAPE_NAMES = list(SHAPES)


def all_cells():
    """The 40 (arch × shape) cells with applicability flags."""
    for a in ARCH_NAMES:
        cfg = REGISTRY[a]
        for sh in SHAPE_NAMES:
            ok, why = applicable(cfg, sh)
            yield a, sh, ok, why
