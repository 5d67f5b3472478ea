"""Stencil tile bodies: the compute the EDT graphs of ``core.programs``
synchronize.

The polyhedral programs are written in *time-skewed* coordinates (x = i +
t) so orthogonal tiling is legal; the numerics live in unskewed "site"
space ``s = x - t``.  A :class:`StencilSpec` names that semantics once:

* task point ``(t, x...)`` computes the value ``v_t[s]`` of its site,
* a tap ``(dt, offsets, weight)`` reads ``v_{t-dt}[s + offsets]``,
* reads outside ``[0, N)^d`` contribute zero (a Dirichlet-0 halo),
* ``v_{-1}`` is the initial grid; the solve's answer is ``v_{T-1}``.

Because every tap has ``dt`` in {0, 1}, two buffers suffice: ``v_t`` lives
in parity buffer ``t & 1`` (so the initial grid seeds buffer 1).  Taps
with ``dt == 0`` read sites the *same* time step already wrote —
Gauss-Seidel — which is why :class:`StencilSpec.seq_space` marks spatial
dims that must run sequentially inside a tile; pure Jacobi bodies
vectorize over all spatial dims.

Three implementations of the same spec:

* :func:`reference_solve` — plain NumPy, time-major (the ground truth),
* :func:`handwritten_solve` — the no-task-graph torch baseline the fused
  executor is priced against: a loop over time with pad+slice taps
  (Jacobi) or the carry recurrence (Seidel),
* the fused device body itself (``core.edt.fused``), which executes the
  identical taps level by level inside the counted-sync sweep.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from ..compat import default_device

@dataclass(frozen=True)
class StencilSpec:
    """One stencil body in unskewed site space.

    ``taps`` is a tuple of ``(dt, offsets, weight)`` with ``dt`` in
    {0, 1}; ``seq_space[k]`` marks spatial dim ``k`` as sequential inside
    a tile (required exactly when some tap has ``dt == 0``, whose offsets
    must then be lexicographically negative).  ``time_param`` /
    ``size_param`` name the polyhedral program's symbolic sizes.
    """

    name: str
    space: int
    taps: tuple
    seq_space: tuple
    time_param: str = "T"
    size_param: str = "N"

    @property
    def sequential(self) -> bool:
        return any(self.seq_space)

    def shape(self, extent: int) -> tuple:
        return (extent,) * self.space


def _box_taps(space: int) -> tuple:
    offs = list(itertools.product((-1, 0, 1), repeat=space))
    w = 1.0 / len(offs)
    return tuple((1, off, w) for off in offs)


#: Specs for the stencil programs of ``repro_torch.core.programs`` (keyed by
#: the PROGRAMS name).  The site offsets are the skewed dependence
#: offsets shifted by the time skew: x_t - x_s in [0, 2] becomes
#: s-offsets {-1, 0, 1} at dt = 1.
SPECS = {
    "stencil1d": StencilSpec("stencil1d", 1, _box_taps(1), (False,)),
    "jacobi2d": StencilSpec("jacobi2d", 2, _box_taps(2), (False, False)),
    "heat3d": StencilSpec("heat3d", 3, _box_taps(3), (False,) * 3),
    # Gauss-Seidel: half the value from this step's left neighbor (the
    # skewed "sweep" dependence), half from last step's right neighbor
    # (the skewed "carry") — the x dim is sequential.
    "seidel1d": StencilSpec("seidel1d", 1,
                            ((0, (-1,), 0.5), (1, (1,), 0.5)), (True,)),
}


def default_state(spec: StencilSpec, extent: int, dtype=np.float32):
    """A deterministic, non-smooth initial grid (linear fields would let
    indexing bugs cancel under averaging stencils)."""
    size = extent ** spec.space
    v = (np.arange(size, dtype=np.int64) * 2654435761) % 1021
    return (v.astype(np.float64) / 1021.0).astype(dtype).reshape(
        spec.shape(extent))


def _shift(a: "np.ndarray", off) -> "np.ndarray":
    """``out[s] = a[s + off]`` with zeros shifted in at the boundary."""
    out = np.zeros_like(a)
    dst, src = [], []
    for k, o in enumerate(off):
        n = a.shape[k]
        lo, hi = max(0, -o), n - max(0, o)
        dst.append(slice(lo, hi))
        src.append(slice(lo + o, hi + o))
    out[tuple(dst)] = a[tuple(src)]
    return out


def reference_solve(spec: StencilSpec, state: "np.ndarray",
                    steps: int) -> "np.ndarray":
    """Ground truth: time-major NumPy execution of the spec.

    Jacobi-style specs (all taps at ``dt == 1``) run as vectorized
    shifts; Gauss-Seidel specs run the honest ordered scalar loop (site
    lex order — the order the skewed schedule implies)."""
    prev = np.array(state)
    ty = prev.dtype.type
    for _ in range(steps):
        if not spec.sequential:
            acc = None
            for _, off, w in spec.taps:
                term = ty(w) * _shift(prev, off)
                acc = term if acc is None else acc + term
            prev = acc
            continue
        cur = np.zeros_like(prev)
        for idx in np.ndindex(prev.shape):
            acc = ty(0)
            for dt, off, w in spec.taps:
                j = tuple(i + o for i, o in zip(idx, off))
                if all(0 <= jj < n for jj, n in zip(j, prev.shape)):
                    acc = acc + ty(w) * (cur[j] if dt == 0 else prev[j])
            cur[idx] = acc
        prev = cur
    return prev


def handwritten_solve(spec: StencilSpec, state, steps: int,
                      device=None) -> torch.Tensor:
    """The hand-written torch baseline: the same solve with no task graph.

    Dense Jacobi bodies are a loop over time whose body is a pad + 3^d
    static slices; the Seidel recurrence carries ``v = w0 * v_prev + b``
    along the sequential dim inside the time loop.  ``state`` is a NumPy
    array or a tensor; the result is a tensor on ``device`` (default: the
    state's own device for a tensor, else CUDA).
    """
    if device is None and isinstance(state, torch.Tensor):
        device = state.device
    if not isinstance(state, torch.Tensor):
        state = torch.from_numpy(np.ascontiguousarray(state))
    u = state.to(default_device(device))
    n = u.shape[0]

    if not spec.sequential:
        for _ in range(steps):
            p = F.pad(u, (1, 1) * spec.space)
            acc = None
            for _, off, w in spec.taps:
                term = w * p[tuple(slice(1 + o, 1 + o + n) for o in off)]
                acc = term if acc is None else acc + term
            u = acc
        return u

    if spec.space != 1:
        raise NotImplementedError(
            "handwritten sequential baseline is 1-D only")
    seq = [(off, w) for dt, off, w in spec.taps if dt == 0]
    if seq != [((-1,), seq[0][1])]:
        raise NotImplementedError(
            "sequential baseline expects a single dt=0 tap at offset -1")
    w0 = seq[0][1]
    for _ in range(steps):
        p = F.pad(u, (1, 1))
        pre = None
        for dt, off, w in spec.taps:
            if dt == 0:
                continue
            term = w * p[1 + off[0]:1 + off[0] + n]
            pre = term if pre is None else pre + term
        out = torch.empty_like(u)
        c = torch.zeros((), dtype=u.dtype, device=u.device)
        for i in range(n):
            c = w0 * c + pre[i]
            out[i] = c
        u = out
    return u
