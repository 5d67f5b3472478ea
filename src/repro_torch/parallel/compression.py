"""Gradient compression for the data-parallel all-reduce.

The port of the reference package's ``parallel/compression.py``.  int8
reduce-scatter + all-gather with f32 accumulation: each gradient is
block-quantized to int8 (per-256-element scales), exchanged over the data
axis with ``all_to_all`` (the reduce-scatter half), summed locally in f32,
re-quantized, and all-gathered.  Wire bytes drop ~3.6x vs f32 all-reduce
(int8 payload + f32 scales).  The int8 payloads and scales are the
reference's byte for byte: the same order of operations (``blocks /
scale * 127``) and rounding (``torch.round`` and ``jnp.round`` both round
half to even).
"""
from __future__ import annotations

from typing import Any

import torch
import torch.nn.functional as F

from ..tree import leaves, rebuild
from .collectives import all_gather, all_to_all

PyTree = Any
BLOCK = 256


def _quant(x: torch.Tensor):
    flat = x.reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = F.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(1, keepdim=True), 1e-12)
    q = torch.clamp(torch.round(blocks / scale * 127), -127, 127).to(
        torch.int8)
    return q, (scale / 127).float()


def _dequant(q, scale, shape, size):
    flat = (q.float() * scale).reshape(-1)
    return flat[:size].reshape(shape)


def compressed_psum_grads(grads: PyTree, mesh, axis: str = "data"):
    """Mean-reduce gradients over ``axis`` with int8 wire format.

    Call on every rank of the axis with its *unreduced* gradients; each
    leaf comes back as the mean, in its own dtype, on every rank.
    """
    group = mesh.group(axis)
    n = group.size

    def one(g):
        shape, size = g.shape, g.numel()
        q, s = _quant(g.float())
        nb = q.shape[0]
        padb = (-nb) % n
        if padb:
            q = F.pad(q, (0, 0, 0, padb))
            s = F.pad(s, (0, 0, 0, padb))
        # reduce-scatter half: everyone sends its i-th block-slab to rank i
        qs = q.reshape(n, -1, BLOCK)
        ss = s.reshape(n, -1, 1)
        qr = all_to_all(qs, group)                       # [n, nb/n, B]
        sr = all_to_all(ss, group)
        local = (qr.float() * sr).sum(0) / n             # f32 accumulation
        q2, s2 = _quant(local)
        # all-gather half
        qg = all_gather(q2, group)                       # [n, nb/n, B]
        sg = all_gather(s2, group)
        full_q = qg.reshape(-1, BLOCK)[:nb + padb][:nb]
        full_s = sg.reshape(-1, 1)[:nb + padb][:nb]
        return _dequant(full_q, full_s, shape, size).to(g.dtype)

    return rebuild(grads, [one(g) for g in leaves(grads)])


def wire_bytes(grads: PyTree, n: int) -> tuple[int, int]:
    """``(int8 payload + f32 scale bytes, f32 bytes)`` one rank sends in
    :func:`compressed_psum_grads` over ``n`` ranks (both halves) and in a
    ring all-reduce of the f32 gradients."""
    sent = f32 = 0
    for g in leaves(grads):
        nb = -(-g.numel() // BLOCK)
        nb += (-nb) % n
        per = nb * (BLOCK + 4)                  # int8 blocks + f32 scales
        sent += 2 * per * (n - 1) // n          # all_to_all + all_gather
        f32 += 2 * g.numel() * 4 * (n - 1) // n
    return sent, f32


def make_compressed_allreduce(mesh, dp_spec, axis: str = "data"):
    """pjit-level wrapper: grads come in dp-replicated? No — this expects
    per-dp-shard *partial* grads produced inside a shard_map loss; for the
    pjit flow use quantize-dequantize before the implicit all-reduce
    (``simulate=True``), which models the precision (not the bandwidth)."""

    def apply(grads):
        raise NotImplementedError(
            "use compressed_psum_grads inside a shard_map training region")

    return apply


def quantize_dequantize_grads(grads: PyTree) -> PyTree:
    """Precision-only model of int8 gradient exchange."""
    return rebuild(grads, [
        _dequant(*_quant(g.float()), g.shape, g.numel()).to(g.dtype)
        for g in leaves(grads)])
