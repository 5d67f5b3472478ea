"""Model zoo: a uniform functional interface over the ported families.

The port of the reference package's ``models/__init__.py``.  Every family
is built: the decoder (GQA or MLA attention, dense or MoE layers), RWKV6,
hybrid (Mamba2 + shared attention) and encoder-decoder (Whisper backbone).
A multimodal-prefix arch (a frontend, not encoder-decoder) is the decoder,
as in the reference: its frontend's embeddings come in as the forward's
``extra_embeds`` prefix.  Parameters are dicts of tensors mirroring the
reference's pytree; ``init`` and ``init_cache`` place them on CUDA unless
the caller passes another device (``"cpu"``, or ``"meta"`` for shapes).
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import encdec, hybrid, rwkv, transformer
from .config import ArchConfig, MLAConfig, MoEConfig, RWKVConfig, SSMConfig
from .transformer import ParallelCtx


@dataclass(frozen=True)
class Model:
    """Uniform handle: every family exposes the same five functions."""
    cfg: ArchConfig
    init: Callable          # (generator, dtype, device[, mesh]) -> params
    loss: Callable          # (params, batch, ctx) -> scalar
    forward: Callable       # (params, tokens, **kw) -> (logits, caches)
    init_cache: Callable    # (batch, max_len, dtype, device) -> caches
    decode_step: Callable   # (params, tokens1, caches, pos, **kw) -> (logits, caches)


def _family_module(cfg: ArchConfig):
    if cfg.encdec:
        return encdec
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return rwkv
    return transformer


def build_model(cfg: ArchConfig) -> Model:
    mod = _family_module(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.bfloat16, device=None, **kw:
            mod.init_params(cfg, gen, dtype, device, **kw),
        loss=lambda params, batch, ctx=ParallelCtx(): mod.loss_fn(
            cfg, params, batch, ctx),
        forward=lambda params, tokens, **kw: mod.forward(
            cfg, params, tokens, **kw),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device=None:
            mod.init_cache(cfg, batch, max_len, dtype, device),
        decode_step=lambda params, t1, caches, pos, **kw: mod.decode_step(
            cfg, params, t1, caches, pos, **kw),
    )


__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig",
           "Model", "ParallelCtx", "build_model"]
