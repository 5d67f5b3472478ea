"""Model zoo: a uniform functional interface over the ported families.

The port of the reference package's ``models/__init__.py``.  The decoder
(GQA or MLA attention, dense or MoE layers), RWKV6 and hybrid (Mamba2 +
shared attention) families are built; the encoder-decoder and
multimodal families raise ``NotImplementedError`` naming their ROADMAP
item.  Parameters are dicts of tensors mirroring the reference's
pytree; ``init`` and ``init_cache`` place them on CUDA unless
the caller passes ``device="cpu"``.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable

import torch

from . import hybrid, rwkv, transformer
from .config import ArchConfig, MLAConfig, MoEConfig, RWKVConfig, SSMConfig


@dataclass(frozen=True)
class Model:
    """Uniform handle: every family exposes the same five functions."""
    cfg: ArchConfig
    init: Callable          # (generator, dtype, device) -> params
    loss: Callable          # (params, batch) -> scalar
    forward: Callable       # (params, tokens, **kw) -> (logits, caches)
    init_cache: Callable    # (batch, max_len, dtype, device) -> caches
    decode_step: Callable   # (params, tokens1, caches, pos) -> (logits, caches)


def _family_module(cfg: ArchConfig):
    if cfg.encdec or cfg.frontend != "none":
        raise NotImplementedError(
            f"{cfg.name}: the encoder-decoder and multimodal-stub families "
            f"are not ported yet: ROADMAP Queue 1 #9")
    if cfg.family == "hybrid":
        return hybrid
    if cfg.family == "ssm" and cfg.rwkv is not None:
        return rwkv
    return transformer


def build_model(cfg: ArchConfig) -> Model:
    mod = _family_module(cfg)
    return Model(
        cfg=cfg,
        init=lambda gen, dtype=torch.bfloat16, device=None: mod.init_params(
            cfg, gen, dtype, device),
        loss=lambda params, batch: mod.loss_fn(cfg, params, batch),
        forward=lambda params, tokens, **kw: mod.forward(
            cfg, params, tokens, **kw),
        init_cache=lambda batch, max_len, dtype=torch.bfloat16, device=None:
            mod.init_cache(cfg, batch, max_len, dtype, device),
        decode_step=lambda params, t1, caches, pos: mod.decode_step(
            cfg, params, t1, caches, pos),
    )


__all__ = ["ArchConfig", "MoEConfig", "MLAConfig", "SSMConfig", "RWKVConfig",
           "Model", "build_model"]
