"""Assigned architectures (exact configs), input shapes and their specs.

A copy of the reference package's ``configs``: each module defines
CONFIG, and the registry maps ``--arch <id>`` names to them.
``input_specs(cfg, shape)`` and ``cache_specs(cfg, shape)`` build
allocation-free stand-ins for every model input and decode cache of a
cell: tensors on ``torch.device("meta")``, where the reference has
``jax.ShapeDtypeStruct``s.  ``applicable(cfg, shape)`` encodes the skip
rules (long_500k needs a sub-quadratic path).
"""
from __future__ import annotations

from dataclasses import dataclass

import torch

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


def _text_len(cfg: ArchConfig, seq: int) -> int:
    if cfg.frontend != "none":
        return max(1, seq - cfg.frontend_seq)
    return seq


def _spec(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _shape(shape) -> ShapeSpec:
    return shape if isinstance(shape, ShapeSpec) else SHAPES[shape]


def input_specs(cfg: ArchConfig, shape, dtype=torch.bfloat16):
    """Meta tensors standing in for every model input of this cell
    (``shape`` a name of :data:`SHAPES`, or a :class:`ShapeSpec`).

    train:   {tokens, labels [, extra_embeds]}
    prefill: {tokens [, extra_embeds]}
    decode:  {tokens1, pos [, enc_out]}  (caches: :func:`cache_specs`)

    A frontend arch's ``extra_embeds`` is its ``[B, frontend_seq,
    d_model]`` prefix, and its text the rest of ``seq_len``.
    """
    s = _shape(shape)
    B = s.global_batch
    St = _text_len(cfg, s.seq_len)
    i32 = torch.int32
    if s.kind in ("train", "prefill"):
        out = {"tokens": _spec((B, St), i32)}
        if s.kind == "train":
            out["labels"] = _spec((B, St), i32)
        if cfg.frontend != "none":
            out["extra_embeds"] = _spec((B, cfg.frontend_seq, cfg.d_model),
                                        dtype)
        return out
    # decode: one new token against a cache of seq_len
    out = {"tokens1": _spec((B, 1), i32), "pos": _spec((), i32)}
    if cfg.encdec:
        out["enc_out"] = _spec((B, cfg.frontend_seq, cfg.d_model), dtype)
    return out


def cache_specs(cfg: ArchConfig, shape, dtype=torch.bfloat16):
    """The decode caches of ``init_cache`` for this cell, on ``meta``."""
    from ..models import build_model

    s = _shape(shape)
    return build_model(cfg).init_cache(s.global_batch, s.seq_len, dtype,
                                       device="meta")


ARCH_NAMES = sorted(REGISTRY)
SHAPE_NAMES = list(SHAPES)


def all_cells():
    """The 40 (arch × shape) cells with applicability flags."""
    for a in ARCH_NAMES:
        cfg = REGISTRY[a]
        for sh in SHAPE_NAMES:
            ok, why = applicable(cfg, sh)
            yield a, sh, ok, why
