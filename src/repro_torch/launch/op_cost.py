"""Op-level cost of one eager step: the port's counterpart of the
reference package's ``launch/hlo_cost.py``.

The reference parses the compiled HLO of a jitted step and weights each
op by the trip counts of the ``while`` loops around it, because XLA's own
cost analysis counts a loop body once.  The port has no HLO: a step runs
eagerly, op by op, so :func:`op_cost` counts the ops the step dispatches,
in a ``TorchDispatchMode`` around ``fn(*args)``.  There is no trip-count
correction to make: eager execution dispatches every iteration of every
Python loop (layers, chunks, microbatches), and the backward's ops as
autograd runs them.

Counted over one call of ``fn`` on this rank (the port's per-device
program, as the reference's module is the SPMD per-device program):

* ``flops``: the matmul family and convolutions, by
  ``torch.utils.flop_counter``'s formulas (2 x output elements x
  contraction size for a product), which is what ``analyze_hlo`` counts
  for a ``dot``;
* ``bytes_accessed``: the operand and result bytes of every op that is
  not a view, the eager counterpart of the reference's rule of counting
  each non-fused op's operands and results;
* ``launches``: one for each op that is neither a view nor an allocation
  without a fill (``empty``): the kernels the card is asked to run;
* ``kernels``: the calls of each hand-written kernel.  A kernel wrapper
  records itself (:func:`record_kernel`) as one launch with its own FLOP
  and byte formula, on CUDA tensors and on ``meta`` ones alike;
* ``collective_bytes`` (the reference's five kinds), ``collective_counts``
  and ``collective_total``: the operand bytes of the collectives run over
  a dry group (:mod:`repro_torch.parallel.collectives`,
  :func:`record_collective`);
* ``argument_bytes``, ``peak_bytes``, ``temp_bytes`` and
  ``output_bytes``: the storages the arguments hold, the largest sum of
  live storage bytes during the call (the arguments' included), the peak
  less the arguments, and the result's storages that no argument holds.
  A storage is live while a tensor that views it is (autograd's saved
  tensors included); storages are keyed by ``untyped_storage()._cdata``,
  since the Python storage wrapper dies before the storage does;
* ``ops``: the launches by op name.

On ``meta`` tensors the walk computes shapes only and touches no device:
``launch.dryrun`` sizes every cell that way.  A dispatch mode slows the
host, so a step is never timed under it.
"""
from __future__ import annotations

import collections
import weakref
from typing import Callable, Optional

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")

#: allocations without a fill: no launch and no bytes moved
_ALLOCATIONS = frozenset(("empty", "empty_like", "empty_strided",
                          "new_empty", "new_empty_strided"))

#: the tally of the :func:`op_cost` call in progress, if any
_active: Optional["_Tally"] = None


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Tally(TorchDispatchMode):
    """The counts of one :func:`op_cost` call, and the mode that takes
    them."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.bytes = 0
        self.launches = 0
        self.ops: collections.Counter = collections.Counter()
        self.kernels: collections.Counter = collections.Counter()
        self.coll_bytes = dict.fromkeys(COLLECTIVES, 0)
        self.coll_counts = dict.fromkeys(COLLECTIVES, 0)
        self.live = self.peak = 0
        self._refs: dict[int, dict] = {}    # storage -> weakrefs of views
        self._size: dict[int, int] = {}     # storage -> bytes

    def hold(self, t: torch.Tensor) -> bool:
        """Count ``t``'s storage live while ``t`` lives; True when the
        storage is new to the tally."""
        storage = t.untyped_storage()
        key = storage._cdata
        refs = self._refs.get(key)
        new = refs is None
        if new:
            refs = self._refs[key] = {}
            self._size[key] = storage.nbytes()
            self.live += self._size[key]
            self.peak = max(self.peak, self.live)
        # keyed by the weakref's id: a live weakref compares its tensors
        ref = weakref.ref(t, lambda r, key=key: self._drop(key, r))
        refs[id(ref)] = ref
        return new

    def _drop(self, key: int, ref) -> None:
        refs = self._refs.get(key)
        if refs is None:
            return
        refs.pop(id(ref), None)
        if not refs:
            del self._refs[key]
            self.live -= self._size.pop(key)

    def release(self) -> None:
        """Forget every storage: no callback fires after the call."""
        self._refs.clear()
        self._size.clear()

    def launch(self, name: str, flops: int, nbytes: int) -> None:
        self.launches += 1
        self.ops[name] += 1
        self.flops += flops
        self.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        fresh = [self.hold(t) for t in outs]
        name = func.overloadpacket.__name__
        view = func.is_view or (not func._schema.is_mutable and outs
                                and not any(fresh))
        if name in _ALLOCATIONS or view:
            return out
        flops = 0
        if func.overloadpacket in flop_registry:
            flops = flop_registry[func.overloadpacket](*args, **kwargs,
                                                       out_val=out)
        self.launch(name, int(flops), sum(
            _nbytes(t) for t in _tensors((args, kwargs)) + outs))
        return out


def record_kernel(name: str, flops: int, nbytes: int) -> None:
    """A hand-written kernel's call, counted into the :func:`op_cost` call
    in progress (none: nothing to do) as one launch of ``flops`` and
    ``nbytes``.  The wrappers call it on CUDA and on ``meta`` tensors."""
    tally = _active
    if tally is not None:
        tally.launch(name, flops, nbytes)
        tally.kernels[name] += 1


def record_collective(kind: str, nbytes: int) -> None:
    """A collective of ``kind`` (one of :data:`COLLECTIVES`) over
    ``nbytes`` of operand, counted into the :func:`op_cost` call in
    progress."""
    tally = _active
    if tally is not None:
        tally.coll_bytes[kind] += nbytes
        tally.coll_counts[kind] += 1


def op_cost(fn: Callable, *args, **kwargs) -> dict:
    """Run ``fn(*args, **kwargs)`` once and return what it cost (see the
    module doc); the result of ``fn`` is dropped."""
    global _active
    if _active is not None:
        raise RuntimeError("op_cost calls do not nest")
    tally = _Tally()
    for t in _tensors((args, kwargs)):
        tally.hold(t)
    argument_bytes = tally.live
    held = set(tally._refs)
    _active = tally
    try:
        with tally:
            out = fn(*args, **kwargs)
        seen: dict[int, int] = {}
        for t in _tensors(out):
            s = t.untyped_storage()
            if s._cdata not in held:
                seen[s._cdata] = s.nbytes()
        del out
    finally:
        _active = None
        tally.release()
    return {
        "flops": tally.flops,
        "bytes_accessed": tally.bytes,
        "collective_bytes": dict(tally.coll_bytes),
        "collective_counts": dict(tally.coll_counts),
        "collective_total": sum(tally.coll_bytes.values()),
        "launches": tally.launches,
        "kernels": dict(tally.kernels),
        "argument_bytes": argument_bytes,
        "peak_bytes": tally.peak,
        "temp_bytes": tally.peak - argument_bytes,
        "output_bytes": sum(seen.values()),
        "ops": dict(tally.ops),
    }
