"""Public wrappers of the hand-written kernels in the models' layout.

The port of the reference package's ``kernels/ops.py``.  There is no
``interpret`` flag: the device of the tensors picks the route (the CUDA
kernel for CUDA tensors, its plain torch version for CPU tensors).  The
layout adapter lives here so model code stays in ``[B, S, H, D]``.
"""
from __future__ import annotations

from .flash_attention import flash_attention_hm
from .ssd import ssd as _ssd
from .wkv6 import wkv6 as _wkv6


def flash_attention(q, k, v, *, causal: bool = True):
    """q [B,Sq,H,D], k/v [B,Skv,Hkv,D] -> [B,Sq,H,D] (GQA-aware)."""
    qh, kh, vh = (x.transpose(1, 2).contiguous() for x in (q, k, v))
    out = flash_attention_hm(qh, kh, vh, causal=causal)
    return out.transpose(1, 2)


def wkv6(r, k, v, w, u, init_state=None, *, chunk: int = 64):
    """RWKV6 recurrence: r,k,v,w [B,S,H,D], u [H,D] -> (out, state)."""
    return _wkv6(r, k, v, w, u, init_state, chunk=chunk)


def ssd(x, dt, A, Bm, Cm, init_state=None, *, chunk: int = 128):
    """Mamba2 SSD: x [B,S,H,P], dt [B,S,H], A [H], Bm/Cm [B,S,N]."""
    return _ssd(x, dt, A, Bm, Cm, init_state, chunk=chunk)
