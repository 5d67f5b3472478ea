"""Fused device execution: task bodies inside the counted-sync sweep.

:class:`~repro_torch.core.edt.device.DeviceExecutor` runs the §2 counted
synchronization model on the card but computes nothing.  This module runs
the stencil family's tiles inside the same sweeps: each level decrements
the counters **and** executes every tile the level enables, so a ≥1M-task
jacobi2d solve never hands a tile to the host.  It is priced against the
hand-written torch stencil of the same problem
(:func:`repro_torch.kernels.stencils.handwritten_solve`).

State layout
------------
The grid lives in one flat device vector ``u`` of ``2*S + 2`` elements
(``S = N^d`` sites):

* ``u[p*S + flat(site)]`` holds ``v_t[site]`` for time parity ``p = t & 1``
  (taps reach at most one step back, so two buffers suffice; the initial
  grid ``v_{-1}`` seeds parity 1),
* ``u[2*S]`` is a zero slot that every masked/out-of-range tap gathers
  from (the Dirichlet-0 halo),
* masked lanes *scatter* to the junk slot ``2*S + 1`` (torch has no
  dropping scatter), so padding never corrupts the halo zero.  ``u`` is
  updated in place: it belongs to one run.

Per level the sweep takes the level's task ids, looks up each task's
**tile origin** row (:func:`pack_origins`), and runs the tile body: local
offsets within a tile are a *static* structure (``tt`` sequential over
the tile's time extent — plus sequential spatial dims for Gauss-Seidel —
and the parallel spatial dims vectorized), so each sub-step is a handful
of gathers, a weighted sum taken tap by tap in the reference's order, and
one scatter.  Site validity (``0 <= t < T`` and ``site ∈ [0, N)^d``) is
exactly domain membership for the skewed stencil programs, so partial
tiles mask themselves.

Why same-level tiles never race: the EDT flow dependences of these
stencils cover every write-write and write-read hazard on the parity
buffers, so wavefront leveling already linearizes conflicting accesses,
and the per-level scatter indices are distinct (apart from the junk slot).
:func:`host_execute` (the same level-major execution in NumPy) equals the
time-major :func:`~repro_torch.kernels.stencils.reference_solve` bitwise.

Both sweep modes run fused: **replay** is the ``O(V+E)`` leveled loop
with the validation counters; **discover** self-levels from the counters
alone through the CUDA wavefront kernel (dense frontier, every task's
tile body masked by the frontier — ``O(depth·V·g)``).
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from typing import Optional, Union

import numpy as np
import torch

from ...compat import default_device
from ...kernels.stencils import SPECS, StencilSpec, default_state
from .config import resolve_execution
from .device import (DeviceCounters, discover_result, discover_sweep,
                     counter_init, pack_graph, pack_schedule, replay_result,
                     replay_sweep, upload)
from .taskgraph import IndexedGraph, TiledTaskGraph
from .wavefront import IndexedSchedule

#: Sentinel origin row (index ``n``): a time coordinate this negative can
#: never satisfy ``t >= 0``, so padded lanes mask themselves.
SENTINEL_ORIGIN = -(1 << 20)


# ------------------------------------------------------------------ packing
def pack_origins(ig: IndexedGraph, tile) -> "np.ndarray":
    """Per-task tile-origin columns: ``i32[n + 1, ndim]``.

    Row ``t`` is task ``t``'s iteration-space origin (tile coordinates ×
    tile sizes, in the skewed program coordinates); the extra row at index
    ``n`` is the :data:`SENTINEL_ORIGIN` mask row the padded
    ``dynamic_slice`` lanes gather.
    """
    if len(ig.stmt_blocks) != 1:
        raise ValueError(
            "fused execution supports single-statement graphs; got "
            f"{len(ig.stmt_blocks)} statements")
    _, coords = ig.stmt_blocks[0]
    nd = coords.shape[1]
    sizes = np.asarray(tuple(tile), dtype=np.int64)
    if sizes.shape != (nd,):
        raise ValueError(
            f"tile sizes {tuple(tile)} do not match the graph's {nd} "
            "iteration dims")
    org = coords.astype(np.int64) * sizes
    if org.size and (int(org.max()) >= -SENTINEL_ORIGIN or int(org.min()) < 0):
        raise ValueError(
            "tile origins exceed the fused executor's index range")
    out = np.empty((ig.n + 1, nd), dtype=np.int32)
    out[:-1] = org
    out[-1] = SENTINEL_ORIGIN
    return out


def _local_steps(spec: StencilSpec, tile) -> list:
    """The tile body's static sub-step structure.

    Returns ``[(tt, loc), ...]``: for each sequential iteration (local
    time ``tt``, then any sequential spatial dims in lex order) the
    ``(sv, space)`` int32 matrix of vectorized local spatial offsets.
    Sub-steps execute in list order — the skewed lexicographic order the
    schedule requires.
    """
    gs = tile[1:]
    seq = [k for k in range(spec.space) if spec.seq_space[k]]
    par = [k for k in range(spec.space) if not spec.seq_space[k]]
    sv = 1
    for k in par:
        sv *= gs[k]
    base = np.zeros((sv, spec.space), np.int32)
    if par:
        grids = np.meshgrid(
            *[np.arange(gs[k], dtype=np.int32) for k in par], indexing="ij")
        for g, k in zip(grids, par):
            base[:, k] = g.ravel()
    steps = []
    for tt in range(tile[0]):
        for sq in itertools.product(*[range(gs[k]) for k in seq]):
            loc = base.copy()
            for k, v in zip(seq, sq):
                loc[:, k] = v
            steps.append((tt, loc))
    return steps


def _strides(space: int, extent: int) -> tuple:
    return tuple(extent ** (space - 1 - k) for k in range(space))


# --------------------------------------------------------------- host oracle
def host_execute(spec: StencilSpec, tile, steps: int, extent: int,
                 origins: "np.ndarray", levels, state: "np.ndarray"):
    """Level-major NumPy twin of the fused sweep (the host-dispatch path).

    Executes the same tiles in the same level order with the same masking
    — element for element the identical arithmetic — so it is bitwise
    equal to :func:`~repro_torch.kernels.stencils.reference_solve` *and* serves
    as the host-dispatch baseline ``bench_fused.py`` prices.  Returns the
    final field ``v_{steps-1}``.
    """
    space = spec.space
    size = extent ** space
    st = np.asarray(_strides(space, extent), dtype=np.int64)
    u = np.zeros((2, size), dtype=state.dtype)
    u[1] = state.ravel()
    loc_steps = _local_steps(spec, tile)
    ty = state.dtype.type
    for ids in levels:
        org = origins[np.asarray(ids)].astype(np.int64)
        t0, osp = org[:, 0], org[:, 1:]
        for tt, loc in loc_steps:
            t = t0 + tt
            site = osp[:, None, :] + loc[None].astype(np.int64) \
                - t[:, None, None]
            ok0 = ((t >= 0) & (t < steps))[:, None] \
                & np.all((site >= 0) & (site < extent), axis=2)
            flat = site @ st
            pw = (t & 1)[:, None]
            acc = np.zeros(flat.shape, dtype=u.dtype)
            for dt, off, w in spec.taps:
                ok = ok0
                foff = 0
                for k, o in enumerate(off):
                    if o:
                        ns = site[..., k] + o
                        ok = ok & (ns >= 0) & (ns < extent)
                        foff += o * int(st[k])
                buf = np.broadcast_to(pw if dt == 0 else 1 - pw, ok.shape)
                vals = np.zeros(flat.shape, dtype=u.dtype)
                vals[ok] = u[buf[ok], (flat + foff)[ok]]
                acc = acc + ty(w) * vals
            pwb = np.broadcast_to(pw, ok0.shape)
            u[pwb[ok0], flat[ok0]] = acc[ok0]
    return u[(steps - 1) & 1].reshape(spec.shape(extent)).copy()


@dataclass
class FusedRun:
    """One fused sweep: frontiers + counters + the computed grid.

    ``levels``/``level_of``/``counters`` mirror
    :class:`~repro_torch.core.edt.device.DeviceRun` (byte-identical
    frontiers, same validation guarantees per mode); ``state`` is the full
    parity pair ``(2, N^d grid)`` and ``final`` the answer field
    ``v_{T-1}``, both tensors on the executor's device.
    """

    mode: str                  # "discover" | "replay"
    levels: list
    level_of: "np.ndarray"
    counters: DeviceCounters
    state: torch.Tensor        # (2,) + grid shape — both parity buffers
    final: torch.Tensor        # grid shape — v_{steps-1}

    @property
    def exec_order(self) -> "np.ndarray":
        if not self.levels:
            return np.zeros(0, dtype=np.int64)
        return np.concatenate(self.levels)


_FLOATS = {torch.float32: np.dtype(np.float32),
           torch.float64: np.dtype(np.float64)}


def _torch_dtype(dtype) -> torch.dtype:
    """float32/float64 in NumPy or torch spelling, as a torch dtype."""
    if not isinstance(dtype, torch.dtype):
        try:
            dtype = getattr(torch, np.dtype(dtype).name)
        except (AttributeError, TypeError):
            dtype = None
    if dtype not in _FLOATS:
        raise TypeError(f"fused execution runs float32 or float64 grids, "
                        f"not {dtype!r}")
    return dtype


class FusedExecutor:
    """End-to-end device-resident stencil execution of an EDT graph.

    Construct like :class:`~repro_torch.core.edt.device.DeviceExecutor` —
    from a :class:`TiledTaskGraph` (``params`` required; ``config=``/
    ``session=`` drive its generation, sharded scans included, and a
    session serves the graph from its cache) or an
    :class:`IndexedGraph` (then ``tile=`` names the tile sizes).
    ``config.faults`` (a :class:`~.faults.FaultPlan`) arms dropped
    decrements.  ``body``
    picks the :class:`~repro_torch.kernels.stencils.StencilSpec` (a name
    from ``SPECS`` or a spec object); with a ``TiledTaskGraph`` it defaults
    to the program's registered name.  ``schedule=`` selects the O(V+E)
    replay sweep (validated on the device unless ``validate=False`` drops
    the three violation counters); without it the discover sweep
    self-levels through the wavefront kernel.  ``packed=(DeviceGraph,
    DeviceSchedule | None, origins)`` skips all host-side packing.

    ``state`` (a NumPy array or a tensor) seeds the grid (default
    :func:`~repro_torch.kernels.stencils.default_state`); ``dtype``
    (float32 or float64, NumPy or torch spelling) defaults to the state's.
    ``device`` defaults to CUDA and raises where there is none.  ``run()``
    returns a :class:`FusedRun`; repeat runs (optionally with a fresh
    ``state=``) reuse the uploaded columns.
    """

    def __init__(self, graph: Union[TiledTaskGraph, IndexedGraph],
                 params: Optional[dict] = None, *,
                 body=None,
                 schedule: Optional[IndexedSchedule] = None,
                 state=None,
                 dtype=None,
                 tile: Optional[tuple] = None,
                 validate: bool = True,
                 config=None, session=None, packed=None, device=None):
        cfg, sess = resolve_execution(config, session, stacklevel=3)
        self.device = default_device(device)
        if isinstance(graph, TiledTaskGraph):
            if params is None:
                raise TypeError("params required with a TiledTaskGraph")
            ig = (sess.index_graph(graph, params) if sess is not None
                  else graph._index_graph_cfg(params, cfg))
            if tile is None:
                tile = graph_tile(graph)
            if body is None:
                body = getattr(graph.program, "name", "") or None
        else:
            ig = graph
            if tile is None:
                raise TypeError("tile= (tile sizes) required with an "
                                "IndexedGraph")
        if body is None:
            raise TypeError("body= required (a repro_torch.kernels.stencils."
                            "SPECS name or StencilSpec); TiledTaskGraph "
                            "infers it from the program name")
        if isinstance(body, StencilSpec):
            spec = body
        elif body in SPECS:
            spec = SPECS[body]
        else:
            raise TypeError(f"unknown stencil body {body!r}; known: "
                            f"{sorted(SPECS)}")
        if params is None:
            raise TypeError("params required (the spec's symbolic sizes)")
        tile = tuple(int(g) for g in tile)
        if len(tile) != spec.space + 1:
            raise ValueError(
                f"body {spec.name!r} needs {spec.space + 1} tile dims "
                f"(time + space); got {tile}")
        if ig.stmt_blocks and ig.stmt_blocks[0][1].shape[1] != len(tile):
            raise ValueError(
                f"graph has {ig.stmt_blocks[0][1].shape[1]} iteration dims, "
                f"tile names {len(tile)}")
        self.ig = ig
        self.spec = spec
        self.tile = tile
        self.steps = int(params[spec.time_param])
        self.extent = int(params[spec.size_param])
        self.size = self.extent ** spec.space
        if 2 * self.size + 2 >= np.iinfo(np.int32).max:
            raise ValueError(f"grid too large for int32 site indexing: "
                             f"{self.size} sites")
        self.faults = cfg.faults
        self.validate = bool(validate)
        if packed is not None and schedule is not None:
            raise TypeError("pass schedule= or packed=, not both")
        if packed is not None:
            self.dg, self.ds, self.fo = packed
            if self.fo is None and self.ds is not None:
                self.fo = self.ds.origin
            if self.fo is None:
                self.fo = pack_origins(ig, tile)
        else:
            self.dg = pack_graph(ig)
            self.fo = pack_origins(ig, tile)
            self.ds = (pack_schedule(ig, schedule, origins=self.fo)
                       if schedule is not None else None)
        if dtype is None:
            dtype = state.dtype if state is not None else np.float32
        self.dtype = _torch_dtype(dtype)
        self._state = self._grid(
            default_state(spec, self.extent, _FLOATS[self.dtype])
            if state is None else state)
        self._loc_steps = _local_steps(spec, tile)
        self._cols = None   # device columns, uploaded on the first run()

    # ------------------------------------------------------------- plumbing
    def _grid(self, a) -> torch.Tensor:
        if not isinstance(a, torch.Tensor):
            a = torch.from_numpy(np.ascontiguousarray(a))
        a0 = a.to(device=self.device, dtype=self.dtype)
        if tuple(a0.shape) != self.spec.shape(self.extent):
            raise ValueError(f"state shape {tuple(a0.shape)} != grid "
                             f"{self.spec.shape(self.extent)}")
        return a0

    def _flat_state(self, a0: torch.Tensor) -> torch.Tensor:
        size = self.size
        u0 = torch.zeros(2 * size + 2, dtype=self.dtype, device=self.device)
        u0[size:2 * size] = a0.reshape(-1)   # v_{-1} lives in parity buffer 1
        return u0

    def _columns(self) -> dict:
        if self._cols is None:
            dg, ds, dev = self.dg, self.ds, self.device
            cols = {"org": upload(self.fo, dev)}
            if ds is not None:
                cols.update(order=upload(ds.order, dev),
                            lvl_tgt=upload(ds.lvl_tgt, dev),
                            pred=upload(dg.pred_n, dev))
            else:
                cols.update(dec_src=upload(dg.dec_src, dev),
                            dec_ptr=upload(dg.dec_ptr, dev))
            cols["loc"] = [(tt, upload(loc.astype(np.int64), dev))
                           for tt, loc in self._loc_steps]
            self._cols = cols
        return self._cols

    def _compute(self, u: torch.Tensor, org: torch.Tensor,
                 active: Optional[torch.Tensor] = None) -> None:
        """The tile body over one level's lanes, in place on ``u``.

        ``org`` is the ``(w, ndim)`` int64 origin rows (sentinel rows mask
        themselves through ``t < 0``); ``active`` optionally masks lanes
        (the discover frontier).  Each sub-step is 3^d masked gathers, a
        weighted sum taken one tap at a time in the state's dtype (the
        reference's order), and one scatter whose masked lanes land in the
        junk slot ``2S + 1``.
        """
        spec, steps, extent, size = (self.spec, self.steps, self.extent,
                                     self.size)
        st = _strides(spec.space, extent)
        t0 = org[:, 0]
        osp = org[:, 1:]
        for tt, loc in self._columns()["loc"]:
            t = t0 + tt
            tmask = (t >= 0) & (t < steps)
            if active is not None:
                tmask = tmask & active
            pw = (t & 1) * size
            site = osp[:, None, :] + loc[None] - t[:, None, None]
            ok0 = tmask[:, None] & ((site >= 0) & (site < extent)).all(dim=2)
            flat = site[..., 0] * st[0]
            for k in range(1, spec.space):
                flat = flat + site[..., k] * st[k]
            acc = torch.zeros(flat.shape, dtype=u.dtype, device=u.device)
            for dt, off, w in spec.taps:
                ok = ok0
                foff = 0
                for k, o in enumerate(off):
                    if o:
                        ns = site[..., k] + o
                        ok = ok & (ns >= 0) & (ns < extent)
                        foff += o * st[k]
                base = pw if dt == 0 else size - pw
                idx = torch.where(ok, base[:, None] + flat + foff, 2 * size)
                acc = acc + w * u[idx]
            widx = torch.where(ok0, pw[:, None] + flat, 2 * size + 1)
            u[widx.reshape(-1)] = acc.reshape(-1)

    def _finish(self, mode, levels, level_of, counters, u) -> FusedRun:
        size = self.size
        grid = self.spec.shape(self.extent)
        state = u[:2 * size].reshape((2,) + grid)
        final = state[(self.steps - 1) & 1] if self.steps else self._state
        return FusedRun(mode, levels, level_of, counters, state, final)

    # --------------------------------------------------------------- sweeps
    def run(self, state=None) -> FusedRun:
        a0 = self._state if state is None else self._grid(state)
        if self.dg.n == 0:
            counters = DeviceCounters(0, 0, 0, 0, np.zeros(0, np.int64))
            return self._finish(
                "replay" if self.ds is not None else "discover",
                [], np.zeros(0, np.int64), counters, self._flat_state(a0))
        if self.ds is not None:
            return self._run_replay(a0)
        return self._run_discover(a0)

    def _run_replay(self, a0: torch.Tensor) -> FusedRun:
        dg, ds = self.dg, self.ds
        cols = self._columns()
        u = self._flat_state(a0)
        org = cols["org"]

        def tiles(ids):
            self._compute(u, org.index_select(0, ids).long())

        tally = replay_sweep(dg, ds, cols["order"], cols["lvl_tgt"],
                             cols["pred"], validate=self.validate,
                             on_level=tiles)
        counters = replay_result(dg, ds, tally)
        return self._finish("replay", ds.levels, ds.level_of, counters, u)

    def _run_discover(self, a0: torch.Tensor) -> FusedRun:
        dg = self.dg
        cols = self._columns()
        u = self._flat_state(a0)
        org = cols["org"][:dg.n].long()
        pred = upload(counter_init(dg.pred_n, self.faults), self.device)

        def tiles(frontier):
            self._compute(u, org, active=frontier)

        out = discover_sweep(pred, cols["dec_src"], cols["dec_ptr"],
                             on_level=tiles)
        levels, level_of, counters = discover_result(
            dg.n, *out, context="fused-discover", label="fused ")
        return self._finish("discover", levels, level_of, counters, u)


def graph_tile(graph: TiledTaskGraph) -> tuple:
    """The tile sizes of a single-statement graph (fused executor unit)."""
    if len(graph.tilings) != 1:
        raise ValueError("fused execution supports single-statement "
                         "programs; got "
                         f"{sorted(graph.tilings)}")
    (tiling,) = graph.tilings.values()
    return tuple(int(s) for s in tiling.sizes)
