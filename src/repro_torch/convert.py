"""Carry the reference package's packed state across to the port.

There are no model weights in this system; the state that must match is
the packed graph (the ``DeviceGraph``/``DeviceSchedule`` columns and the
fused executor's tile-origin rows) and the stencil grid.
:func:`from_reference` takes the reference's objects duck-typed — anything
with the same NumPy attributes, so this module imports nothing of the
reference — checks every column's type and shape, and returns the port's
objects, ready for ``packed=`` of the port's executors.  Feeding both
packages the same packed inputs makes any difference in a result a fault
of the port.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from .compat import default_device
from .core.edt.device import DeviceGraph, DeviceSchedule

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
