"""Optimizers: AdamW with f32 or 8-bit (block-quantized) moment states.

The port of the reference package's ``optim/__init__.py``.  The update
runs under ``torch.no_grad()`` and writes the params and the moments in
place; :func:`apply_updates` returns the same dicts, so a train step keeps
the reference's ``(params, opt_state, loss)`` signature.  The schedule and
the bias corrections are f32 arithmetic on an int32 step, as in the
reference (no Python floats, which are f64).  Huge stacked leaves are
updated one slice of dim 0 at a time, as the reference scans them.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, NamedTuple, Optional

import torch

from ..tree import leaves, rebuild

PyTree = Any
BLOCK = 256


@dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0
    state_bits: int = 32          # 32 (f32 moments) or 8 (block-int8)
    warmup: int = 100
    total_steps: int = 10_000
    min_lr_ratio: float = 0.1


def lr_at(cfg: AdamWConfig, step) -> torch.Tensor:
    """The learning rate at ``step`` (an int32 tensor, or an int), in f32."""
    step = torch.as_tensor(step, dtype=torch.int32)
    warm = torch.clamp(step / max(cfg.warmup, 1), max=1.0)
    prog = torch.clamp((step - cfg.warmup) /
                       max(cfg.total_steps - cfg.warmup, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


# ----------------------------------------------------- 8-bit moment encoding
# Shape-preserving block quantization: int8 with per-(last-axis-block) f32
# scales (q: p.shape; scales: p.shape[:-1] + (last/BLOCK,)).

def _q8_last(x: torch.Tensor) -> int:
    last = x.shape[-1] if x.ndim else 1
    return BLOCK if last % BLOCK == 0 else last


def _q8_encode(x: torch.Tensor):
    blk = _q8_last(x)
    shape = tuple(x.shape)
    nb = shape[-1] // blk
    b = x.reshape(shape[:-1] + (nb, blk))
    scale = torch.clamp(b.abs().amax(dim=-1, keepdim=True), min=1e-12) / 127.0
    q = torch.clamp(torch.round(b / scale), -127, 127).to(torch.int8)
    return q.reshape(shape), scale[..., 0].float()


def _q8_decode(q: torch.Tensor, scale: torch.Tensor):
    blk = _q8_last(q)
    shape = tuple(q.shape)
    nb = shape[-1] // blk
    b = q.reshape(shape[:-1] + (nb, blk)).float()
    return (b * scale[..., None]).reshape(shape)


_Q8_MIN_SIZE = 65536  # small leaves (norm scales, biases) stay f32
#: a leaf of at least this many elements, of rank 3 or more and with more
#: than one slice along dim 0, is updated a slice at a time (the
#: reference's ``one_scanned``)
SLICE_MIN_SIZE = 1 << 26


class MomentState(NamedTuple):
    m: Any
    v: Any
    m_scale: Optional[Any] = None
    v_scale: Optional[Any] = None


def _zip(params, *trees):
    """``(param, leaf of each tree)`` in the reference's flatten order."""
    if isinstance(params, dict):
        for k in sorted(params):
            yield from _zip(params[k], *(t[k] for t in trees))
    else:
        yield (params,) + trees


def init_state(cfg: AdamWConfig, params: PyTree):
    """Zero moments beside each leaf (int8 with f32 scales at 8 bits for
    leaves of rank 2 or more and at least ``_Q8_MIN_SIZE`` elements), and
    an int32 step, on the params' devices."""
    def one(p):
        z = dict(device=p.device)
        if cfg.state_bits == 8 and p.numel() >= _Q8_MIN_SIZE and p.ndim >= 2:
            blk = _q8_last(p)
            sshape = tuple(p.shape[:-1]) + (p.shape[-1] // blk,)
            return MomentState(torch.zeros(p.shape, dtype=torch.int8, **z),
                               torch.zeros(p.shape, dtype=torch.int8, **z),
                               torch.zeros(sshape, dtype=torch.float32, **z),
                               torch.zeros(sshape, dtype=torch.float32, **z))
        return MomentState(torch.zeros(p.shape, dtype=torch.float32, **z),
                           torch.zeros(p.shape, dtype=torch.float32, **z))
    flat = leaves(params)
    return {"mv": rebuild(params, [one(p) for p in flat]),
            "step": torch.zeros((), dtype=torch.int32, device=flat[0].device)}


def _global_norm(grads):
    return torch.sqrt(sum(torch.sum(torch.square(g.float()))
                          for g in leaves(grads)))


def _one(cfg: AdamWConfig, p, g, mv: MomentState, lr, clip, b1c, b2c):
    """One leaf's (or slice's) update, written into ``p`` and ``mv``."""
    g = g.float() * clip
    quantized = mv.m_scale is not None
    if quantized:
        m = _q8_decode(mv.m, mv.m_scale)
        v = _q8_decode(mv.v, mv.v_scale)
    else:
        m, v = mv.m, mv.v
    m.mul_(cfg.b1).add_((1 - cfg.b1) * g)
    v.mul_(cfg.b2).add_((1 - cfg.b2) * g * g)
    upd = (m / b1c) / (torch.sqrt(v / b2c) + cfg.eps)
    decay = cfg.weight_decay if p.ndim >= 2 else 0.0
    pf = p.float()
    p.copy_(pf - lr * (upd + decay * pf))
    if quantized:
        for q, s, x in ((mv.m, mv.m_scale, m), (mv.v, mv.v_scale, v)):
            qx, sx = _q8_encode(x)
            q.copy_(qx)
            s.copy_(sx)


@torch.no_grad()
def apply_updates(cfg: AdamWConfig, params, grads, state, *, gnorm=None):
    """One AdamW step, in place; returns ``(params, state)``, the same
    dicts.  ``gnorm``, the global gradient norm the clip reads, is the
    norm of ``grads`` unless the caller holds only part of the gradient
    (a rank's slice of a sharded leaf) and passes the whole's."""
    step = state["step"] + 1
    lr = lr_at(cfg, step)
    if gnorm is None:
        gnorm = _global_norm(grads)
    clip = torch.clamp(cfg.grad_clip / (gnorm + 1e-9), max=1.0)
    b1c = 1 - cfg.b1 ** step.float()
    b2c = 1 - cfg.b2 ** step.float()
    for p, g, mv in _zip(params, grads, state["mv"]):
        if p.ndim >= 3 and p.numel() >= SLICE_MIN_SIZE and p.shape[0] > 1:
            # only one slice's f32 moments and temporaries are ever live
            for i in range(p.shape[0]):
                _one(cfg, p[i], g[i], MomentState(
                    *(None if t is None else t[i] for t in mv)),
                    lr, clip, b1c, b2c)
        else:
            _one(cfg, p, g, mv, lr, clip, b1c, b2c)
    state["step"].copy_(step)
    return params, state
