"""Predecessor-count functions (paper §4.3).

With autodecs, the first predecessor to reach a successor task must initialize
its counted dependence with the *exact* number of predecessors.  The paper
generates, per dependence polyhedron, a function

    pred_count(T_target, params) -> int

in one of two forms, chosen by a shape heuristic:

  * an **enumerator** — a closed-form product evaluated in O(n) (cheap, but
    only valid for rectangular get-loops),
  * a **counting loop** — scan the get-loop and count (shape-insensitive, cost
    proportional to the count).

We realize both: the target tile coordinates are moved into the *parameter*
space of the polyhedron, so the per-level Fourier-Motzkin systems are computed
once at "compile time", and each call is a cheap bound evaluation.  With the
default ``compiled`` scanning backend every call runs pure integer
arithmetic (the bounds were normalized to ceil/floor-division form when the
nest was built); ``backend="fraction"`` retains the reference rational path
for the equivalence regression tests.  ``backend="numpy"`` adds
:meth:`CountingFunction.count_block`: counts for a whole block of target
tiles at once — the enumerator form becomes a few matrix products over the
coordinate block, with a scalar-compiled fallback for counting loops.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Callable, Sequence

import numpy as np

from .polyhedron import Polyhedron
from .scanning import LoopNest

F0 = Fraction(0)


def dims_to_params(poly: Polyhedron, dim_idx: Sequence[int]) -> Polyhedron:
    """Reclassify the given dims as parameters (appended after existing params).

    The polyhedron's point set is unchanged; only the scanning/counting role
    of the coordinates changes.  Used to turn Δ_T(T_s, T_t) into a family of
    source sets parameterized by the target tile.
    """
    dim_idx = sorted(set(dim_idx))
    keep = [i for i in range(poly.ndim) if i not in dim_idx]

    def conv(row):
        body = [row[i] for i in keep]
        params = list(row[poly.ndim:poly.ndim + poly.nparam])
        moved = [row[i] for i in dim_idx]
        return tuple(body + params + moved + [row[-1]])

    return Polyhedron(tuple(poly.dim_names[i] for i in keep),
                      poly.param_names + tuple(poly.dim_names[i] for i in dim_idx),
                      tuple(conv(r) for r in poly.ineqs),
                      tuple(conv(r) for r in poly.eqs)).canonical()


@dataclass
class CountingFunction:
    """Callable predecessor/successor counter with a recorded strategy."""
    nest: LoopNest
    strategy: str  # 'enumerator' | 'loop'
    # param order of nest: original params then fixed-dim coordinates.

    def __call__(self, coords: Sequence[int], params: Sequence[int] = ()) -> int:
        pv = list(params) + list(coords)
        if self.strategy == "enumerator":
            return self._enumerate(pv)
        return self.nest.count(pv)

    def _enumerate(self, pv) -> int:
        """O(n) closed form — valid only for rectangular nests."""
        if not self.nest.feasible(pv):
            return 0
        total = 1
        for level in self.nest.levels:
            lb, ub = self.nest._bounds(level, [0] * level.k, pv)
            if lb is None or ub is None:
                raise ValueError("unbounded dim in enumerator")
            if ub < lb:
                return 0
            total *= ub - lb + 1
        return total

    def points(self, coords: Sequence[int], params: Sequence[int] = ()):
        """Iterate the counted set (the paper's get/put/autodec loop body)."""
        return self.nest.iterate(list(params) + list(coords))

    def count_block(self, coords: "np.ndarray",
                    params: Sequence[int] = ()) -> "np.ndarray":
        """Counts for a ``(N, nfixed)`` block of fixed coordinates at once.

        Enumerator strategy: the closed form vectorizes into per-level bound
        evaluations over the block (one matvec per bound row) — O(rows)
        array ops total, no per-coordinate Python.  Loop strategy: falls
        back to the compiled scalar counter per row.  Values are identical
        to calling ``self(coords_i, params)`` per row.
        """
        base = [int(p) for p in params]
        nest = self.nest
        nfixed = nest.nparam - len(base)
        coords = np.asarray(coords, dtype=np.int64)
        if coords.ndim != 2:
            # -1 is ambiguous for size-0 inputs; the fixed-dim count is known
            coords = coords.reshape(-1, nfixed) if nfixed else coords.reshape(len(coords), 0)
        n = coords.shape[0]
        assert coords.shape[1] == nfixed
        if self.strategy != "enumerator":
            out = np.empty(n, dtype=np.int64)
            count = nest.count
            for i, row in enumerate(coords.tolist()):
                out[i] = count(base + row)
            return out

        def rest(par, const):
            """const + par·(params, coords) over the block -> (N,) array."""
            v = const
            for c, p in zip(par[:len(base)], base):
                if c:
                    v += c * p
            cc = np.asarray(par[len(base):], dtype=np.int64)
            if cc.size and cc.any():
                return coords @ cc + v
            return np.full(n, v, dtype=np.int64)

        total = np.ones(n, dtype=np.int64)
        feasible = np.ones(n, dtype=bool)
        if nest._infeasible:
            return np.zeros(n, dtype=np.int64)
        for par, const in nest._int_guards:
            feasible &= rest(par, const) >= 0
        for los, ups in nest._int_levels:
            lb = None
            ub = None
            # rectangular nests have no outer-dim terms (prefix is all-zero
            # in the scalar enumerator, so any stray ones contribute nothing)
            for r in los:
                v = -(rest(r.par, r.const) // r.a)
                lb = v if lb is None else np.maximum(lb, v)
            for r in ups:
                v = rest(r.par, r.const) // r.a
                ub = v if ub is None else np.minimum(ub, v)
            if lb is None or ub is None:
                raise ValueError("unbounded dim in enumerator")
            total *= np.maximum(ub - lb + 1, 0)
        total[~feasible] = 0
        return total


def make_counting_function(delta_t: Polyhedron, count_dims: Sequence[int],
                           fixed_dims: Sequence[int],
                           strategy: str = "auto",
                           backend: str = "compiled") -> CountingFunction:
    """Build ``count(fixed_coords, params) -> |{count_dims points}|``.

    ``count_dims``/``fixed_dims`` partition the dims of ``delta_t``.
    For a predecessor counter on Δ_T(T_s, T_t): count_dims = source dims,
    fixed_dims = target dims.  Strategy 'auto' applies the paper's heuristic:
    rectangular nest -> enumerator, else counting loop.  ``backend`` selects
    the scanning evaluation path (see :mod:`.scanning`).
    """
    assert sorted(list(count_dims) + list(fixed_dims)) == list(range(delta_t.ndim))
    fam = dims_to_params(delta_t, fixed_dims)
    nest = LoopNest(fam, backend=backend)
    if strategy == "auto":
        strategy = "enumerator" if nest.is_rectangular() else "loop"
    return CountingFunction(nest=nest, strategy=strategy)
