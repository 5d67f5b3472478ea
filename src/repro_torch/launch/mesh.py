"""Device meshes over ``torch.distributed`` ranks, and a launcher.

The port of the reference package's ``launch/mesh.py``.  A :class:`Mesh`
lays the world's ranks out row-major over named axes, as
``jax.make_mesh`` lays out devices: one process a rank, and one process
group per axis and per tuple of axes in mesh order (``("data",
"model")`` spans both, data-major).  Single pod: 16 x 16 = 256 ranks,
axes (data, model).  Multi-pod: 2 x 16 x 16 = 512 ranks, axes (pod,
data, model).  Nothing touches a device or a process group when this
module is imported.

:func:`run_ranks` starts ``world`` processes on this host, sets up their
process group over the transport the caller names (``nccl`` when every
rank has its own card, ``gloo`` otherwise, which stages CUDA tensors
through the host; see :mod:`repro_torch.parallel.collectives`) and
returns each rank's result.
"""
from __future__ import annotations

import datetime
import itertools
import logging
import multiprocessing
import os
import queue
import socket
import time
import traceback
from typing import Any, Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from ..compat import default_device
from ..parallel.collectives import AxisGroup

log = logging.getLogger(__name__)

TRANSPORTS = ("nccl", "gloo")


def _world() -> tuple[int, int]:
    """``(world size, rank)`` of the process group, ``(1, 0)`` without
    one."""
    if dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


class Mesh:
    """The world's ranks over named axes, as this rank sees them.

    ``shape`` is a dict (as ``jax.sharding.Mesh.shape`` is), ``coords``
    this rank's index on each axis, ``group(axis)`` the
    :class:`AxisGroup` of an axis or of an axis tuple in mesh order.
    ``device`` is this rank's device: CUDA unless the caller passes
    ``device="cpu"``.  Every rank must build the same meshes in the same
    order (each builds its process groups collectively)."""

    def __init__(self, shape, axis_names, *, device=None):
        self.device = default_device(device)
        dims = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        if len(dims) != len(self.axis_names) or min(dims, default=0) < 1:
            raise ValueError(f"mesh shape {dims} for axes {self.axis_names}")
        self.shape = dict(zip(self.axis_names, dims))
        self.size = int(np.prod(dims))
        world, rank = _world()
        if self.size != world:
            raise ValueError(f"a {dims} mesh needs {self.size} ranks; the "
                             f"world has {world}")
        self.rank = rank
        self.transport = dist.get_backend() if dist.is_initialized() else None
        staged = self.transport == "gloo" and self.device.type == "cuda"
        self.coords = dict(zip(self.axis_names,
                               (int(c) for c in np.unravel_index(rank, dims))))
        grid = np.arange(self.size).reshape(dims)
        n = len(dims)
        self._groups: dict[tuple, AxisGroup] = {}
        for k in range(1, n + 1):
            for sub in itertools.combinations(range(n), k):
                rest = [i for i in range(n) if i not in sub]
                width = int(np.prod([dims[i] for i in sub]))
                key = tuple(self.axis_names[i] for i in sub)
                for row in grid.transpose(rest + list(sub)).reshape(-1, width):
                    ranks = tuple(int(r) for r in row)
                    pg = dist.new_group(list(ranks)) if width > 1 else None
                    if rank in ranks:
                        self._groups[key] = AxisGroup(
                            key if k > 1 else key[0], width,
                            ranks.index(rank), ranks, pg, staged)

    def group(self, axis) -> AxisGroup:
        """The :class:`AxisGroup` of ``axis`` (a name, or a tuple of names
        in mesh order)."""
        key = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        if key not in self._groups:
            raise KeyError(f"no axis {axis!r} in a mesh of "
                           f"{self.axis_names} (a tuple names its axes in "
                           f"mesh order)")
        return self._groups[key]


def make_production_mesh(*, multi_pod: bool = False, device=None) -> Mesh:
    """16 x 16 (data, model), or 2 x 16 x 16 (pod, data, model) with
    ``multi_pod``, over a world of exactly that many ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    dev = default_device(device)
    world, _ = _world()
    if world != int(np.prod(shape)):
        raise ValueError(f"the production mesh {shape} needs "
                         f"{int(np.prod(shape))} ranks; the world has "
                         f"{world}")
    return Mesh(shape, axes, device=dev)


def make_debug_mesh(n_data: int = 1, n_model: int = 1, *,
                    device=None) -> Mesh:
    """A small (data, model) mesh over the world's ranks (tests, smoke
    runs)."""
    return Mesh((n_data, n_model), ("data", "model"), device=device)


# ---------------------------------------------------------------- launcher
def default_transport(world: int, device) -> str:
    """``nccl`` when the ranks run on CUDA and each has its own card,
    else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda" and torch.cuda.device_count() >= world:
        return "nccl"
    return "gloo"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _rank_main(fn, args, rank: int, world: int, port: int, device_type: str,
               backend: str, timeout_s: float, out) -> None:
    """One rank: its device, the process group, ``fn(device, *args)``; the
    result or the traceback goes to ``out``."""
    try:
        # every rank is on this host: the loopback carries the traffic
        os.environ.setdefault("GLOO_SOCKET_IFNAME", "lo")
        os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
        if device_type == "cuda":
            idx = rank % torch.cuda.device_count()
            torch.cuda.set_device(idx)
            device = torch.device("cuda", idx)
        else:
            device = torch.device(device_type)
        dist.init_process_group(
            backend, init_method=f"tcp://127.0.0.1:{port}", world_size=world,
            rank=rank, timeout=datetime.timedelta(seconds=timeout_s),
            # NCCL binds the group to the rank's card (its barrier too)
            device_id=device if backend == "nccl" else None)
        try:
            result = fn(device, *args)
        finally:
            dist.destroy_process_group()
        out.put((rank, True, result))
    except Exception:       # the rank's boundary: report, then fail
        out.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn: Callable, world: int, *args: Any, device=None,
              backend: Optional[str] = None, timeout: float = 900.0) -> list:
    """Run ``fn(device, *args)`` on ``world`` ranks of one host and return
    their results, rank by rank.

    Each rank is a process (``spawn`` on CUDA, so ``fn`` and ``args`` must
    pickle by reference; ``fork`` on the CPU) with the process group set
    up over ``backend`` (:func:`default_transport` when not named): NCCL
    gives rank ``r`` card ``r``; under gloo the ranks share the cards
    round-robin.  ``device`` is CUDA unless the caller passes
    ``device="cpu"``.  Results must pickle (NumPy arrays, not tensors).
    A rank's exception, a rank that dies, or ``timeout`` seconds fail the
    call with that rank's traceback, and the other ranks are stopped."""
    dev = default_device(device)
    backend = backend or default_transport(world, dev)
    if backend not in TRANSPORTS:
        raise ValueError(f"transport {backend!r}: one of {TRANSPORTS}")
    if backend == "nccl" and (dev.type != "cuda"
                              or torch.cuda.device_count() < world):
        raise ValueError(f"nccl needs a card for each of {world} ranks; "
                         f"this host has {torch.cuda.device_count()}")
    log.info("run_ranks: %d ranks on %s over %s (%d cards)", world, dev.type,
             backend, torch.cuda.device_count() if dev.type == "cuda" else 0)
    ctx = multiprocessing.get_context("spawn" if dev.type == "cuda"
                                      else "fork")
    out = ctx.Queue()
    port = _free_port()
    procs = [ctx.Process(target=_rank_main, name=f"rank{r}", daemon=True,
                         args=(fn, args, r, world, port, dev.type, backend,
                               timeout, out))
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict[int, Any] = {}
    failures: list[tuple[int, str]] = []
    deadline = time.monotonic() + timeout
    try:
        while len(results) < world and not failures:
            try:
                rank, ok, payload = out.get(timeout=0.5)
            except queue.Empty:
                dead = [r for r, p in enumerate(procs)
                        if r not in results and p.exitcode not in (None, 0)]
                if dead:
                    # a rank that raised reports before it exits
                    try:
                        rank, ok, payload = out.get(timeout=5.0)
                    except queue.Empty:
                        failures.append((dead[0], f"exited with code "
                                         f"{procs[dead[0]].exitcode}"))
                        continue
                elif time.monotonic() > deadline:
                    failures.append((-1, f"timed out after {timeout} s with "
                                     f"ranks {sorted(results)} done"))
                    continue
                else:
                    continue
            if ok:
                results[rank] = payload
            else:
                failures.append((rank, payload))
        if failures:
            # the ranks a failure strands in a collective fail in turn:
            # report theirs too, the first failure first
            end = time.monotonic() + 5.0
            while len(results) + len(failures) < world:
                try:
                    rank, ok, payload = out.get(
                        timeout=max(0.0, end - time.monotonic()))
                except queue.Empty:
                    break
                if not ok:
                    failures.append((rank, payload))
    finally:
        if failures:
            for p in procs:
                if p.is_alive():
                    p.terminate()
        for p in procs:
            p.join(timeout=30)
            if p.is_alive():
                p.kill()
                p.join()
        out.close()
        out.join_thread()
    if failures:
        raise RuntimeError("\n".join(
            f"{f'rank {r}' if r >= 0 else 'run_ranks'} of {world} failed:\n"
            f"{msg}" for r, msg in failures))
    return [results[r] for r in range(world)]
