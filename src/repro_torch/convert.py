"""Carry the reference package's state across to the port.

Two kinds of state must match.  For the task runtime it is the packed
graph (the ``DeviceGraph``/``DeviceSchedule`` columns and the fused
executor's tile-origin rows) and the stencil grid: :func:`from_reference`;
and the distributed engines' rank partition:
:func:`rank_slices_from_reference`.
For the models it is the architecture config, the parameter pytree and
the optimizer state: :func:`config_from_reference`,
:func:`params_from_reference` and :func:`opt_state_from_reference`.  Both
take the reference's objects duck-typed — anything with the same
attributes and NumPy arrays, so this module imports nothing of the
reference — check every column's or leaf's type and shape, and return the
port's objects.  Feeding both packages the same inputs makes any
difference in a result a fault of the port.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional

import numpy as np
import torch

from .compat import default_device
from .core.edt.device import DeviceGraph, DeviceSchedule
from .core.edt.distributed import RankSlice
from .models import build_model
from .models.config import (ArchConfig, MLAConfig, MoEConfig, RWKVConfig,
                            SSMConfig)
from .optim import MomentState, _q8_last

_GRAPH_COLUMNS = ("indptr", "succ", "dec_src", "dec_ptr", "pred_n")
_SCHEDULE_COLUMNS = ("order", "task_ptr", "lvl_tgt", "edge_ptr")


class Converted(NamedTuple):
    dg: DeviceGraph
    ds: Optional[DeviceSchedule]
    origins: Optional[np.ndarray]
    state: Optional[torch.Tensor]


def _int32(obj, name: str, length: int) -> np.ndarray:
    a = np.asarray(getattr(obj, name))
    if a.dtype != np.int32 or a.shape != (length,):
        raise ValueError(f"{name}: want int32 of shape ({length},), got "
                         f"{a.dtype} of shape {a.shape}")
    return a.copy()


def _origins(origins, n: int) -> np.ndarray:
    fo = np.asarray(origins)
    if fo.dtype != np.int32 or fo.ndim != 2 or fo.shape[0] != n + 1:
        raise ValueError(f"origins: want int32 of shape ({n + 1}, ndim), got "
                         f"{fo.dtype} of shape {fo.shape}")
    return fo.copy()


def from_reference(dg, ds=None, origins=None, state=None,
                   device=None) -> Converted:
    """The port's packed graph, schedule, origins and grid.

    ``dg``/``ds`` are the reference's ``DeviceGraph``/``DeviceSchedule``
    (or any objects with the same attributes), ``origins`` its
    ``pack_origins`` rows and ``state`` a NumPy grid.  Columns stay host
    NumPy arrays, as the port's own packing leaves them (the executors
    upload them on their first run); the grid becomes a tensor on
    ``device`` (default CUDA).
    """
    n, e = int(dg.n), int(dg.n_edges)
    lengths = {"indptr": n + 1, "succ": e, "dec_src": e, "dec_ptr": n + 1,
               "pred_n": n}
    graph = DeviceGraph(n=n, n_edges=e, **{
        k: _int32(dg, k, lengths[k]) for k in _GRAPH_COLUMNS})
    sched = None
    if ds is not None:
        depth, w_pad, e_pad = int(ds.depth), int(ds.w_pad), int(ds.e_pad)
        lengths = {"order": n + w_pad, "task_ptr": depth + 2,
                   "lvl_tgt": e + e_pad, "edge_ptr": depth + 1}
        level_of = np.asarray(ds.level_of, dtype=np.int64).copy()
        levels = [np.asarray(lv, dtype=np.int64).copy() for lv in ds.levels]
        ds_origin = getattr(ds, "origin", None)
        sched = DeviceSchedule(
            depth=depth, w_pad=w_pad, e_pad=e_pad, levels=levels,
            level_of=level_of,
            origin=None if ds_origin is None else _origins(ds_origin, n),
            **{k: _int32(ds, k, lengths[k]) for k in _SCHEDULE_COLUMNS})
    fo = None if origins is None else _origins(origins, n)
    grid = None
    if state is not None:
        grid = torch.from_numpy(np.array(state)).to(default_device(device))
    return Converted(graph, sched, fo, grid)


def _int64(obj, name: str, length: int) -> np.ndarray:
    a = np.asarray(getattr(obj, name))
    if a.dtype != np.int64 or a.shape != (length,):
        raise ValueError(f"{name}: want int64 of shape ({length},), got "
                         f"{a.dtype} of shape {a.shape}")
    return a.copy()


def rank_slices_from_reference(slices) -> list[RankSlice]:
    """The port's :class:`RankSlice` list from the reference's partition.

    ``slices`` are the reference's ``RankSlice`` objects (or any objects
    with the same attributes), in rank order.  Every column must be int64
    of its length — ``bounds`` ``ranks + 1``, ``indeg`` the rank's task
    count, the CSR row pointers one more, the target columns their row
    pointer's last entry — else ``ValueError`` names it.  Feeding both
    packages' engines the same partition isolates the engines.
    """
    out = []
    for k, sl in enumerate(slices):
        rank, ranks = int(sl.rank), int(sl.ranks)
        lo, hi = int(sl.lo), int(sl.hi)
        if rank != k or not 0 <= lo <= hi:
            raise ValueError(f"slice {k}: rank {rank}, range [{lo}, {hi})")
        nl = hi - lo
        cols = {"bounds": _int64(sl, "bounds", ranks + 1),
                "indeg": _int64(sl, "indeg", nl),
                "l_indptr": _int64(sl, "l_indptr", nl + 1),
                "r_indptr": _int64(sl, "r_indptr", nl + 1)}
        for tgt, ptr in (("l_tgt", "l_indptr"), ("r_tgt", "r_indptr")):
            cols[tgt] = _int64(sl, tgt, int(cols[ptr][-1]))
        out.append(RankSlice(rank=rank, ranks=ranks, lo=lo, hi=hi,
                             expected_in=int(sl.expected_in), **cols))
    return out


# ------------------------------------------------------------------ models
_SUBCONFIGS = {"moe": MoEConfig, "mla": MLAConfig, "ssm": SSMConfig,
               "rwkv": RWKVConfig}
_NP_TO_TORCH = {"float32": torch.float32, "float64": torch.float64,
                "float16": torch.float16, "bfloat16": torch.bfloat16,
                "int8": torch.int8, "int32": torch.int32}


def config_from_reference(cfg) -> ArchConfig:
    """The port's :class:`ArchConfig` with every field of the reference's
    ``cfg`` (read by attribute); ``attn_impl="pallas"`` becomes ``"cuda"``."""
    kw = {}
    for f in dataclasses.fields(ArchConfig):
        val = getattr(cfg, f.name)
        sub = _SUBCONFIGS.get(f.name)
        if sub is not None and val is not None:
            val = sub(**{g.name: getattr(val, g.name)
                         for g in dataclasses.fields(sub)})
        kw[f.name] = val
    if kw["attn_impl"] == "pallas":
        kw["attn_impl"] = "cuda"
    return ArchConfig(**kw)


def _leaf(a, want: torch.Tensor, path: str, device) -> torch.Tensor:
    a = np.asarray(a)
    dtype = _NP_TO_TORCH.get(a.dtype.name)
    if dtype != want.dtype or a.shape != tuple(want.shape):
        raise ValueError(f"{path}: want {want.dtype} of shape "
                         f"{tuple(want.shape)}, got {a.dtype} of shape "
                         f"{a.shape}")
    a = np.array(a, order="C")        # a writable copy
    if dtype == torch.bfloat16:      # NumPy's bfloat16 is an extension type
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16).to(
            device)
    return torch.from_numpy(a).to(device)


def _carry(tree, want, path: str, device):
    if isinstance(want, dict):
        if not isinstance(tree, dict) or set(tree) != set(want):
            got = sorted(tree) if isinstance(tree, dict) else type(tree)
            raise ValueError(f"{path or 'params'}: want keys {sorted(want)}, "
                             f"got {got}")
        return {k: _carry(tree[k], want[k], f"{path}/{k}", device)
                for k in want}
    return _leaf(tree, want, path, device)


def params_from_reference(tree, cfg, device=None):
    """``(params, cfg)`` of the port from the reference's parameters.

    ``tree`` is the reference's parameter pytree (nested dicts) with NumPy
    leaves, ``cfg`` its ``ArchConfig``.  Every leaf must have the shape and
    dtype that the port's ``init`` gives that config (its main dtype read
    from the embedding; an MoE router is f32 whatever that dtype, as the
    reference draws it), else ``ValueError`` names it.  The reference's
    ``[in, out]`` weight layout (``x @ W``) is kept, so the transfer is one
    to one.  Tensors go to ``device`` (default CUDA).
    """
    device = default_device(device)
    port_cfg = config_from_reference(cfg)
    dtype = _NP_TO_TORCH.get(np.asarray(tree["embed"]).dtype.name)
    if dtype is None:
        raise ValueError(f"embed: not a float array "
                         f"({np.asarray(tree['embed']).dtype})")
    want = build_model(port_cfg).init(torch.Generator(), dtype,
                                      device="meta")
    return _carry(tree, want, "", device), port_cfg


def opt_state_from_reference(state, params):
    """The port's AdamW state from the reference's ``init_state`` /
    ``apply_updates`` state.

    ``state`` is ``{"mv": ..., "step": ...}`` with NumPy leaves: a tree
    shaped like ``params`` whose leaves have the attributes ``m, v,
    m_scale, v_scale`` (the reference's ``MomentState``).  Moments are f32
    of the param's shape, or int8 with f32 block scales of shape
    ``p.shape[:-1] + (blocks,)`` when ``m_scale`` is set; ``step`` is an
    int32 scalar.  Any other dtype or shape raises ``ValueError`` naming
    the leaf.  Each leaf goes to its param's device."""
    def one(mv, p, path):
        meta = dict(device="meta")
        if getattr(mv, "m_scale", None) is None:
            want = MomentState(torch.empty(p.shape, dtype=torch.float32, **meta),
                               torch.empty(p.shape, dtype=torch.float32, **meta))
        else:
            sshape = tuple(p.shape[:-1]) + (p.shape[-1] // _q8_last(p),)
            want = MomentState(
                *(torch.empty(p.shape, dtype=torch.int8, **meta),) * 2,
                *(torch.empty(sshape, dtype=torch.float32, **meta),) * 2)
        return MomentState(*(
            None if w is None else _leaf(getattr(mv, f), w, f"{path}.{f}",
                                         p.device)
            for f, w in zip(MomentState._fields, want)))

    def walk(mv, p, path):
        if isinstance(p, dict):
            if not isinstance(mv, dict) or set(mv) != set(p):
                got = sorted(mv) if isinstance(mv, dict) else type(mv)
                raise ValueError(f"{path or 'mv'}: want keys {sorted(p)}, "
                                 f"got {got}")
            return {k: walk(mv[k], p[k], f"{path}/{k}") for k in p}
        return one(mv, p, path)

    first = next(iter(params.values()))
    while isinstance(first, dict):
        first = next(iter(first.values()))
    step = _leaf(state["step"], torch.empty((), dtype=torch.int32,
                                            device="meta"), "step",
                 first.device)
    return {"mv": walk(state["mv"], params, ""), "step": step}
