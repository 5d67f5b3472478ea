"""Lexicographic scanning of integer points — the paper's generated loops.

The paper's codegen (§4) turns dependence polyhedra into loop nests that scan
predecessors/successors of a task (get/put/autodec loops).  Here a
:class:`LoopNest` plays that role: it precomputes, per loop level, the
Fourier-Motzkin projection of the polyhedron onto the outer dims, so that at
"run time" (task execution) each level's bounds are cheap affine min/max
evaluations — exactly like generated C loop bounds.

Three evaluation backends share the same per-level systems:

* ``compiled`` (default) — the projected bounds are normalized once, at
  construction, into integer ``ceild``/``floord`` form (``-(rest // a)`` /
  ``rest // a`` with ``a > 0``, and a unit-coefficient fast path that drops
  the division entirely).  ``iterate``/``count`` then run *generated Python
  source* — an actual loop nest compiled per polyhedron, with parameter-only
  bounds hoisted out of the loops — so scanning behaves like the paper's
  generated C loops: pure integer arithmetic, no per-point allocation.
* ``numpy`` — batch enumeration: :meth:`LoopNest.iterate_array` /
  :meth:`LoopNest.count_vectorized` run *generated NumPy source* that emits
  whole wavefronts of points at once (``arange`` per level, ceil/floor
  division applied as array ops, ragged levels expanded with the
  repeat/cumsum trick) and returns a raveled ``(N, ndim)`` int64 array in
  the same lexicographic order the scalar loops produce.  The per-point
  scalar APIs (``iterate``/``count``) delegate to the compiled integer
  path.  Both reuse the same ``_IntRow`` normalization.
* ``fraction`` — the original per-call ``fractions.Fraction`` evaluation,
  retained as the reference oracle for the equivalence regression tests.

Compiled scan/count functions (scalar and NumPy) are cached in a module
table keyed by the **canonical polyhedron**, so identical dependence
polyhedra across graphs share one codegen (see :func:`scan_cache_info`).

Scanning is exact over the integers: level-k bounds come from the rational
projection, and integer-empty inner ranges simply produce empty loops.
Array enumeration uses int64; coefficients/params that overflow int64 are
out of scope (the scalar paths stay exact at arbitrary precision).
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterator, Optional, Sequence

import numpy as np

from .polyhedron import Polyhedron
from .projection import project_out

F0 = Fraction(0)

BACKENDS = ("compiled", "numpy", "fraction")

# --------------------------------------------------------------------------
# Compiled-scan cache: canonical polyhedron -> compiled artifacts.  Two
# LoopNests over equal canonical polyhedra (e.g. the same dependence in two
# graphs) share one generated scan/count function per flavor.
_SCAN_CACHE: dict[tuple, dict] = {}
_SCAN_CACHE_STATS = {"hits": 0, "misses": 0}


def scan_cache_info() -> dict:
    """Hit/miss counters and size of the compiled-scan cache."""
    return {**_SCAN_CACHE_STATS, "size": len(_SCAN_CACHE)}


def clear_scan_cache() -> None:
    _SCAN_CACHE.clear()
    _SCAN_CACHE_STATS["hits"] = 0
    _SCAN_CACHE_STATS["misses"] = 0


def _cache_slot(key: tuple, flavor: str, build):
    """Fetch or build the compiled artifacts for one codegen flavor."""
    entry = _SCAN_CACHE.setdefault(key, {})
    got = entry.get(flavor)
    if got is not None:
        _SCAN_CACHE_STATS["hits"] += 1
        return got
    _SCAN_CACHE_STATS["misses"] += 1
    entry[flavor] = got = build()
    return got


def _row_ints(row) -> tuple[int, ...]:
    """Scale a rational constraint row to integers (positive factor: exact)."""
    den = 1
    for c in row:
        den = den * c.denominator // math.gcd(den, c.denominator)
    return tuple(int(c * den) for c in row)


# ------------------------------------------------------------------ sharding
SHARD_LO, SHARD_HI = "__slo", "__shi"


def shard_polyhedron(poly: Polyhedron) -> Polyhedron:
    """Expose the outermost dim's scan range as two extra parameters.

    Returns the same point set constrained by ``__slo <= d0 <= __shi`` with
    ``__slo``/``__shi`` appended to the parameter list.  A :class:`LoopNest`
    over the result scans exactly the rows of the full lexicographic scan
    whose outermost coordinate falls in ``[lo, hi]`` — in the same order —
    so concatenating block scans over a partition of the outer range is
    byte-identical to one full scan.

    Every shard of one polyhedron shares this single extended polyhedron
    (the block bounds travel as parameter *values*), so the canonical-key
    scan cache compiles each unit once per process no matter how many
    shards it is split into.
    """
    assert poly.ndim > 0, "cannot shard a 0-dim polyhedron"
    assert SHARD_LO not in poly.param_names, "polyhedron is already sharded"
    nd, np_ = poly.ndim, poly.nparam
    F1 = Fraction(1)

    def ext(row):
        return row[:nd + np_] + (F0, F0) + row[-1:]

    lo_row = [F0] * (nd + np_ + 3)
    lo_row[0], lo_row[nd + np_] = F1, -F1          # d0 - __slo >= 0
    hi_row = [F0] * (nd + np_ + 3)
    hi_row[0], hi_row[nd + np_ + 1] = -F1, F1      # __shi - d0 >= 0
    return Polyhedron(
        poly.dim_names, poly.param_names + (SHARD_LO, SHARD_HI),
        tuple(ext(r) for r in poly.ineqs) + (tuple(lo_row), tuple(hi_row)),
        tuple(ext(r) for r in poly.eqs)).canonical()


@dataclass
class _Level:
    """Bounds for one loop dim: rows over [outer dims..., this dim, params, 1].

    The level-k system has k+1 dims (outer dims + this one); parameters start
    at column k+1.
    """
    lowers: list[tuple]   # a_k > 0 rows: d_k >= ceil(-(rest)/a_k)
    uppers: list[tuple]   # a_k < 0 rows: d_k <= floor(rest/(-a_k))
    k: int

    @property
    def param_off(self) -> int:
        return self.k + 1


@dataclass
class _IntRow:
    """One bound row in integer ceil/floor-division form.

    ``rest = const + pre·prefix + par·params``; the bound contribution is
    ``-(rest // a)`` for lowers, ``rest // a`` for uppers, with ``a > 0``.
    ``pre`` is sparse ((outer-dim index, coeff) pairs) so rectangular rows
    cost nothing per outer iteration.
    """
    a: int                          # positive divisor (1 = fast path)
    pre: tuple[tuple[int, int], ...]  # nonzero outer-dim coefficients
    par: tuple[int, ...]            # dense parameter coefficients
    const: int


class LoopNest:
    """Scan the integer points of ``poly`` in lexicographic dim order."""

    def __init__(self, poly: Polyhedron, simplify: str = "auto",
                 backend: str = "compiled"):
        assert backend in BACKENDS, backend
        self.backend = backend
        self.poly = poly.canonical()
        self.ndim = poly.ndim
        self.nparam = poly.nparam
        self.levels: list[_Level] = []
        self._infeasible = False
        # guards: rows with no dim support (pure parameter constraints);
        # they surface in the outermost projected system and must be checked
        # at evaluation time or infeasible parameter values scan garbage.
        self._guards: list[tuple] = []
        cur = self.poly
        systems = [None] * self.ndim
        for k in range(self.ndim - 1, -1, -1):
            systems[k] = cur
            if k > 0:
                cur = project_out(cur, [k], simplify=simplify)
        if self.ndim == 0:
            self._guards = list(self.poly.all_rows_as_ineqs())
            self._compile_static()
            return
        for k in range(self.ndim):
            sys_k = systems[k]
            rows = sys_k.all_rows_as_ineqs()
            lowers, uppers = [], []
            for r in rows:
                c = r[k]
                if c > 0:
                    lowers.append(r)
                elif c < 0:
                    uppers.append(r)
                elif k == 0:
                    # pure-parameter guard (dim coeff 0 in the 1-dim system)
                    if all(x == 0 for x in r[:-1]):
                        if r[-1] < 0:
                            self._infeasible = True
                    else:
                        self._guards.append(r)
            self.levels.append(_Level(lowers, uppers, k))
        self._compile_static()

    # ----------------------------------------------------- compile (integer)
    def _compile_static(self) -> None:
        """Normalize guards and per-level bounds to integer form, once."""
        off = 1 if self.ndim else 0
        self._int_guards: list[tuple[tuple[int, ...], int]] = []
        for r in self._guards:
            ir = _row_ints(r)
            self._int_guards.append(
                (ir[off:off + self.nparam], ir[-1]))
        self._int_levels: list[tuple[list[_IntRow], list[_IntRow]]] = []
        for level in self.levels:
            k, poff = level.k, level.param_off
            los, ups = [], []
            for r in level.lowers:
                ir = _row_ints(r)
                los.append(_IntRow(
                    a=ir[k],
                    pre=tuple((j, ir[j]) for j in range(k) if ir[j]),
                    par=ir[poff:poff + self.nparam],
                    const=ir[-1]))
            for r in level.uppers:
                ir = _row_ints(r)
                ups.append(_IntRow(
                    a=-ir[k],
                    pre=tuple((j, ir[j]) for j in range(k) if ir[j]),
                    par=ir[poff:poff + self.nparam],
                    const=ir[-1]))
            self._int_levels.append((los, ups))
        self._scan_fn = None   # generated lazily (codegen is not free)
        self._count_fn = None
        self._gen_source: Optional[str] = None
        self._scan_np_fn = None
        self._count_np_fn = None
        self._np_source: Optional[str] = None
        self._block_nest: Optional["LoopNest"] = None
        # canonical-polyhedron cache key: rows are tuples of Fractions.
        self._cache_key = (self.poly.dim_names, self.poly.param_names,
                           self.poly.ineqs, self.poly.eqs)

    def feasible(self, params) -> bool:
        """Evaluate the pure-parameter guards (integer arithmetic)."""
        if self._infeasible:
            return False
        pv = self._param_vec(params)
        for par, const in self._int_guards:
            v = const
            for c, p in zip(par, pv):
                if c:
                    v += c * p
            if v < 0:
                return False
        return True

    # ------------------------------------------------------------------ eval
    def _bounds(self, level: _Level, prefix: Sequence[int],
                params: Sequence[int]) -> tuple[Optional[int], Optional[int]]:
        """Integer [lb, ub] for dim k given outer values; None = unbounded."""
        if self.backend == "compiled":
            return self._bounds_int(level.k, prefix, params)
        return self._bounds_fraction(level, prefix, params)

    def _bounds_int(self, k: int, prefix: Sequence[int],
                    params: Sequence[int]) -> tuple[Optional[int], Optional[int]]:
        """Compiled path: pure-integer ceil/floor division bound evaluation."""
        los, ups = self._int_levels[k]
        lb: Optional[int] = None
        ub: Optional[int] = None
        for r in los:
            rest = r.const
            for j, c in r.pre:
                rest += c * prefix[j]
            for c, p in zip(r.par, params):
                if c:
                    rest += c * p
            v = -rest if r.a == 1 else -(rest // r.a)
            if lb is None or v > lb:
                lb = v
        for r in ups:
            rest = r.const
            for j, c in r.pre:
                rest += c * prefix[j]
            for c, p in zip(r.par, params):
                if c:
                    rest += c * p
            v = rest if r.a == 1 else rest // r.a
            if ub is None or v < ub:
                ub = v
        return lb, ub

    def _bounds_fraction(self, level: _Level, prefix: Sequence[int],
                         params: Sequence[int]) -> tuple[Optional[int], Optional[int]]:
        """Reference path: the original per-call Fraction evaluation."""
        k = level.k
        off = level.param_off
        lb: Optional[int] = None
        ub: Optional[int] = None
        for r in level.lowers:
            a = r[k]
            rest = r[-1]
            for j in range(k):
                rest += r[j] * prefix[j]
            for j in range(self.nparam):
                rest += r[off + j] * params[j]
            v = math.ceil(Fraction(-rest, 1) / a)
            lb = v if lb is None else max(lb, v)
        for r in level.uppers:
            a = -r[k]
            rest = r[-1]
            for j in range(k):
                rest += r[j] * prefix[j]
            for j in range(self.nparam):
                rest += r[off + j] * params[j]
            v = math.floor(Fraction(rest, 1) / a)
            ub = v if ub is None else min(ub, v)
        return lb, ub

    # --------------------------------------------------------------- codegen
    def _rest_src(self, r: _IntRow) -> str:
        terms = []
        for j, c in enumerate(r.par):
            if c:
                terms.append(f"{c:+d}*p{j}")
        for j, c in r.pre:
            terms.append(f"{c:+d}*d{j}")
        if r.const or not terms:
            terms.append(f"{r.const:+d}")
        return " ".join(terms)

    def _bound_src(self, r: _IntRow, lower: bool) -> str:
        rest = self._rest_src(r)
        if lower:
            return f"-({rest})" if r.a == 1 else f"-(({rest}) // {r.a})"
        return f"({rest})" if r.a == 1 else f"({rest}) // {r.a}"

    def _emit(self) -> str:
        """Generate Python source for the scan and count loop nests.

        Mirrors the paper's generated C loops: ``ceild``/``floord`` become
        integer floor division, parameter-only bounds are hoisted to the
        function prologue, and the innermost count level is closed-form.
        """
        n = self.ndim
        head: list[str] = []
        for j in range(self.nparam):
            head.append(f"    p{j} = pv[{j}]")
        guards = []
        if self._infeasible:
            guards.append("    if True:")
        elif self._int_guards:
            conds = []
            for par, const in self._int_guards:
                r = _IntRow(1, (), par, const)
                conds.append(f"({self._rest_src(r)}) < 0")
            guards.append(f"    if {' or '.join(conds)}:")
        # per-level bound expressions, hoisting parameter-only rows
        hoist: list[str] = []
        lb_expr: list[Optional[str]] = []
        ub_expr: list[Optional[str]] = []
        for k in range(n):
            los, ups = self._int_levels[k]
            stat_l = [self._bound_src(r, True) for r in los if not r.pre]
            dyn_l = [self._bound_src(r, True) for r in los if r.pre]
            stat_u = [self._bound_src(r, False) for r in ups if not r.pre]
            dyn_u = [self._bound_src(r, False) for r in ups if r.pre]
            if stat_l:
                src = stat_l[0] if len(stat_l) == 1 else "max(%s)" % ", ".join(stat_l)
                hoist.append(f"    slb{k} = {src}")
                dyn_l = [f"slb{k}"] + dyn_l
            if stat_u:
                src = stat_u[0] if len(stat_u) == 1 else "min(%s)" % ", ".join(stat_u)
                hoist.append(f"    sub{k} = {src}")
                dyn_u = [f"sub{k}"] + dyn_u
            lb_expr.append(None if not dyn_l else
                           (dyn_l[0] if len(dyn_l) == 1 else "max(%s)" % ", ".join(dyn_l)))
            ub_expr.append(None if not dyn_u else
                           (dyn_u[0] if len(dyn_u) == 1 else "min(%s)" % ", ".join(dyn_u)))

        def body(kind: str) -> list[str]:
            out: list[str] = [f"def __{kind}(pv):"]
            out += head
            if guards:
                out.append(guards[0])
                out.append("        return" if kind == "scan" else "        return 0")
            if kind == "count":
                out.append("    total = 0")
            out += hoist
            ind = "    "
            last = n - 1
            for k in range(n):
                if lb_expr[k] is None or ub_expr[k] is None:
                    nm = self.poly.dim_names[k]
                    out.append(f"{ind}raise ValueError("
                               f"\"dim {k} ({nm}) is unbounded\")")
                    if kind == "scan":
                        # unreachable, but forces generator semantics so an
                        # empty outer range yields [] and a non-empty one
                        # raises on first next() — like the fraction path
                        out.append(f"{ind}yield ()")
                    else:
                        out.append("    return total")
                    return out
                if kind == "count" and k == last:
                    out.append(f"{ind}__lo = {lb_expr[k]}")
                    out.append(f"{ind}__hi = {ub_expr[k]}")
                    out.append(f"{ind}if __hi >= __lo:")
                    out.append(f"{ind}    total += __hi - __lo + 1")
                else:
                    out.append(f"{ind}for d{k} in range({lb_expr[k]}, "
                               f"{ub_expr[k]} + 1):")
                    ind += "    "
            if kind == "scan":
                tup = ", ".join(f"d{k}" for k in range(n)) + ("," if n == 1 else "")
                out.append(f"{ind}yield ({tup})")
            else:
                out.append("    return total")
            return out

        return "\n".join(body("scan") + [""] + body("count")) + "\n"

    def _compile_fns(self) -> None:
        def build():
            src = self._emit()
            ns: dict = {}
            exec(compile(src, f"<loopnest {self.poly.dim_names}>", "exec"), ns)
            return (src, ns["__scan"], ns["__count"])

        self._gen_source, self._scan_fn, self._count_fn = _cache_slot(
            self._cache_key, "scalar", build)

    def generated_source(self) -> str:
        """The generated Python loop nest (compiled backend; docs/debug)."""
        if self._scan_fn is None and self.ndim:
            self._compile_fns()
        return self._gen_source or ""

    # ------------------------------------------------------- codegen (numpy)
    def _emit_numpy(self) -> str:
        """Generate NumPy source for batch scan and count.

        The same ``_IntRow`` bounds drive array arithmetic: each level either
        has parameter-only (static) bounds — expanded with ``repeat``/``tile``
        like a meshgrid axis — or outer-dim-dependent (ragged) bounds, where
        per-prefix extents are clipped and expanded with the repeat/cumsum
        trick.  The scan returns a raveled ``(N, ndim)`` int64 array in exact
        lexicographic order; the count closes the innermost level in form.
        """
        n = self.ndim
        head = [f"    p{j} = pv[{j}]" for j in range(self.nparam)]
        guard_cond = None
        if self._infeasible:
            guard_cond = "True"
        elif self._int_guards:
            conds = []
            for par, const in self._int_guards:
                r = _IntRow(1, (), par, const)
                conds.append(f"({self._rest_src(r)}) < 0")
            guard_cond = " or ".join(conds)

        # per-level bound sources; static (parameter-only) rows hoisted
        hoist: list[str] = []
        lb_src: list[Optional[str]] = []
        ub_src: list[Optional[str]] = []
        lb_static: list[bool] = []
        dynamic: list[bool] = []

        def fold(fn: str, parts: list[str]) -> str:
            out = parts[0]
            for p in parts[1:]:
                out = f"_np.{fn}({out}, {p})"
            return out

        for k in range(n):
            los, ups = self._int_levels[k]
            stat_l = [self._bound_src(r, True) for r in los if not r.pre]
            dyn_l = [self._bound_src(r, True) for r in los if r.pre]
            stat_u = [self._bound_src(r, False) for r in ups if not r.pre]
            dyn_u = [self._bound_src(r, False) for r in ups if r.pre]
            if stat_l:
                src = stat_l[0] if len(stat_l) == 1 else "max(%s)" % ", ".join(stat_l)
                hoist.append(f"    slb{k} = {src}")
            if stat_u:
                src = stat_u[0] if len(stat_u) == 1 else "min(%s)" % ", ".join(stat_u)
                hoist.append(f"    sub{k} = {src}")
            if not (stat_l or dyn_l) or not (stat_u or dyn_u):
                lb_src.append(None)
                ub_src.append(None)
                lb_static.append(True)
                dynamic.append(False)
                continue
            l_parts = ([f"slb{k}"] if stat_l else []) + dyn_l
            u_parts = ([f"sub{k}"] if stat_u else []) + dyn_u
            lb_src.append(fold("maximum", l_parts))
            ub_src.append(fold("minimum", u_parts))
            lb_static.append(not dyn_l)
            dynamic.append(bool(dyn_l or dyn_u))

        def body(kind: str) -> list[str]:
            out = [f"def __{kind}_np(pv):"]
            out += head
            empty = f"_np.empty((0, {n}), dtype=_np.int64)"
            ret_nothing = f"return {empty}" if kind == "scan" else "return 0"
            if guard_cond:
                out.append(f"    if {guard_cond}:")
                out.append(f"        {ret_nothing}")
            out += hoist
            # which outer-dim columns each level must carry forward: the scan
            # needs every dim; the count only dims referenced by deeper bounds
            if kind == "scan":
                carry_after = [set(range(k + 1)) for k in range(n)]
            else:
                carry_after = []
                for k in range(n):
                    need: set[int] = set()
                    for k2 in range(k + 1, n):
                        los2, ups2 = self._int_levels[k2]
                        for r in los2 + ups2:
                            need |= {j for j, _ in r.pre}
                    carry_after.append({j for j in need if j <= k})
            out.append("    m = 1")
            last = n - 1
            for k in range(n):
                if lb_src[k] is None or ub_src[k] is None:
                    nm = self.poly.dim_names[k]
                    out.append(f"    raise ValueError("
                               f"\"dim {k} ({nm}) is unbounded\")")
                    return out
                carry = sorted(carry_after[k])
                if not dynamic[k]:
                    out.append(f"    lb{k} = {lb_src[k]}")
                    out.append(f"    ub{k} = {ub_src[k]}")
                    if kind == "count" and k == last:
                        out.append(f"    return m * (ub{k} - lb{k} + 1) "
                                   f"if ub{k} >= lb{k} else 0")
                        return out
                    out.append(f"    n{k} = ub{k} - lb{k} + 1")
                    out.append(f"    if n{k} <= 0:")
                    out.append(f"        {ret_nothing}")
                    for j in carry:
                        if j < k:
                            out.append(f"    d{j} = _np.repeat(d{j}, n{k})")
                    if k in carry:
                        out.append(f"    d{k} = _np.tile(_np.arange(lb{k}, "
                                   f"ub{k} + 1, dtype=_np.int64), m)")
                    out.append(f"    m = m * n{k}")
                else:
                    out.append(f"    lb{k} = {lb_src[k]}")
                    out.append(f"    ub{k} = {ub_src[k]}")
                    out.append(f"    cnt{k} = _np.maximum(ub{k} - lb{k} + 1, 0)")
                    if kind == "count" and k == last:
                        out.append(f"    return int(cnt{k}.sum())")
                        return out
                    out.append(f"    csum{k} = _np.cumsum(cnt{k})")
                    out.append(f"    t{k} = int(csum{k}[-1]) if m else 0")
                    out.append(f"    if t{k} == 0:")
                    out.append(f"        {ret_nothing}")
                    if carry:
                        out.append(f"    idx{k} = _np.repeat(_np.arange(m), cnt{k})")
                        for j in carry:
                            if j < k:
                                out.append(f"    d{j} = d{j}[idx{k}]")
                        if k in carry:
                            out.append(f"    off{k} = _np.arange(t{k}, "
                                       f"dtype=_np.int64) - "
                                       f"_np.repeat(csum{k} - cnt{k}, cnt{k})")
                            base = f"lb{k}" if lb_static[k] else f"lb{k}[idx{k}]"
                            out.append(f"    d{k} = {base} + off{k}")
                    out.append(f"    m = t{k}")
            if kind == "scan":
                cols = ", ".join(f"d{k}" for k in range(n))
                out.append(f"    return _np.stack(({cols},), axis=1)")
            else:
                out.append("    return m")
            return out

        return "\n".join(body("scan") + [""] + body("count")) + "\n"

    def _compile_np_fns(self) -> None:
        def build():
            src = self._emit_numpy()
            ns: dict = {"_np": np}
            exec(compile(src, f"<loopnest-np {self.poly.dim_names}>", "exec"), ns)
            return (src, ns["__scan_np"], ns["__count_np"])

        self._np_source, self._scan_np_fn, self._count_np_fn = _cache_slot(
            self._cache_key, "numpy", build)

    def generated_numpy_source(self) -> str:
        """The generated NumPy batch enumerator (docs/debug)."""
        if self._scan_np_fn is None and self.ndim:
            self._compile_np_fns()
        return self._np_source or ""

    # --------------------------------------------------------------- iterate
    def iterate(self, params: dict[str, int] | Sequence[int] = ()) -> Iterator[tuple[int, ...]]:
        """Yield every integer point (requires bounded dims).

        The ``numpy`` backend shares the compiled scalar path here; its batch
        API is :meth:`iterate_array`.
        """
        pv = self._param_vec(params)
        if self.ndim == 0:
            return iter((((),) if self.feasible(pv) else ()))
        if self.backend != "fraction":
            if self._scan_fn is None:
                self._compile_fns()
            return self._scan_fn(pv)
        return self._iterate_fraction(pv)

    def iterate_array(self, params: dict[str, int] | Sequence[int] = ()) -> "np.ndarray":
        """All integer points as a raveled ``(N, ndim)`` int64 array.

        Lexicographic row order, identical to :meth:`iterate`.  Whole levels
        are emitted as index arithmetic (generated NumPy source) — no
        per-point Python dispatch.  Available on every backend.
        """
        pv = self._param_vec(params)
        if self.ndim == 0:
            n = 1 if self.feasible(pv) else 0
            return np.zeros((n, 0), dtype=np.int64)
        if self._scan_np_fn is None:
            self._compile_np_fns()
        return self._scan_np_fn(pv)

    def count_vectorized(self, params: dict[str, int] | Sequence[int] = ()) -> int:
        """Point count via the generated NumPy enumerator (array bounds)."""
        pv = self._param_vec(params)
        if self.ndim == 0:
            return 1 if self.feasible(pv) else 0
        if self._count_np_fn is None:
            self._compile_np_fns()
        return int(self._count_np_fn(pv))

    def _iterate_fraction(self, pv) -> Iterator[tuple[int, ...]]:
        if not self.feasible(pv):
            return
        yield from self._rec(0, [], pv)

    def _rec(self, k: int, prefix: list[int], pv) -> Iterator[tuple[int, ...]]:
        if k == self.ndim:
            yield tuple(prefix)
            return
        lb, ub = self._bounds_fraction(self.levels[k], prefix, pv)
        if lb is None or ub is None:
            raise ValueError(f"dim {k} ({self.poly.dim_names[k]}) is unbounded")
        for v in range(lb, ub + 1):
            prefix.append(v)
            yield from self._rec(k + 1, prefix, pv)
            prefix.pop()

    def count(self, params: dict[str, int] | Sequence[int] = ()) -> int:
        """Number of integer points (innermost level counted closed-form)."""
        pv = self._param_vec(params)
        if self.ndim == 0:
            return 1 if self.feasible(pv) else 0
        if self.backend != "fraction":
            if self._count_fn is None:
                self._compile_fns()
            return self._count_fn(pv)
        if not self.feasible(pv):
            return 0
        return self._count_rec(0, [], pv)

    def _count_rec(self, k: int, prefix: list[int], pv) -> int:
        lb, ub = self._bounds_fraction(self.levels[k], prefix, pv)
        if lb is None or ub is None:
            raise ValueError(f"dim {k} is unbounded; cannot count")
        if ub < lb:
            return 0
        if k == self.ndim - 1:
            return ub - lb + 1
        total = 0
        for v in range(lb, ub + 1):
            prefix.append(v)
            total += self._count_rec(k + 1, prefix, pv)
            prefix.pop()
        return total

    def outer_bounds(self, params=()) -> Optional[tuple[int, int]]:
        """Static integer bounds ``[lb, ub]`` of the outermost dim.

        Level-0 bounds never reference outer dims, so they evaluate from the
        parameters alone — this is what the shard planner partitions.  Returns
        ``None`` when the nest is 0-dim, infeasible at these params, or the
        outer dim is unbounded (callers fall back to a single local scan).
        """
        pv = self._param_vec(params)
        if self.ndim == 0 or not self.feasible(pv):
            return None
        los, ups = self._int_levels[0]
        lb: Optional[int] = None
        ub: Optional[int] = None
        for r in los:
            rest = r.const + sum(c * p for c, p in zip(r.par, pv) if c)
            v = -rest if r.a == 1 else -(rest // r.a)
            if lb is None or v > lb:
                lb = v
        for r in ups:
            rest = r.const + sum(c * p for c, p in zip(r.par, pv) if c)
            v = rest if r.a == 1 else rest // r.a
            if ub is None or v < ub:
                ub = v
        if lb is None or ub is None:
            return None
        return lb, ub

    def outer_only_params(self) -> frozenset[int]:
        """Parameter indices that bound ONLY the outermost loop dim.

        A parameter is *outer-only* when its coefficient is zero in every
        level-k bound row for k >= 1: fixing the outer coordinate, the inner
        scan is independent of it.  Pure-parameter guards do not disqualify
        (they gate feasibility of the whole scan, never row content), so for
        two feasible parameter vectors differing only in outer-only params,
        the rows whose outer coordinate lies in both scans' ranges are
        byte-identical — the reuse invariant behind the graph cache's
        incremental re-materialization (the reference package's graph cache).
        """
        inner = set()
        for k in range(1, self.ndim):
            los, ups = self._int_levels[k]
            for r in los + ups:
                for j, c in enumerate(r.par):
                    if c:
                        inner.add(j)
        return frozenset(j for j in range(self.nparam) if j not in inner)

    def block_nest(self) -> "LoopNest":
        """The ``__slo``/``__shi``-extended twin of this nest (lazy, cached).

        Scans exactly the rows of the full scan whose outermost coordinate
        falls in ``[lo, hi]`` when called with ``params + (lo, hi)`` — the
        same restricted polyhedron the shard planner partitions
        (:func:`shard_polyhedron`), shared here so driver-side consumers
        (the graph cache's incremental path) reuse one canonical compile.
        """
        assert self.ndim > 0, "cannot block-restrict a 0-dim nest"
        if self._block_nest is None:
            self._block_nest = LoopNest(shard_polyhedron(self.poly),
                                        backend=self.backend)
        return self._block_nest

    def first(self, params=()) -> Optional[tuple[int, ...]]:
        return next(self.iterate(params), None)

    def is_empty_at(self, params=()) -> bool:
        return self.first(params) is None

    # ------------------------------------------------------------- structure
    def is_rectangular(self) -> bool:
        """True if every level's bounds are independent of outer dims.

        This is the shape heuristic of §4.3: rectangular nests admit an O(n)
        closed-form enumerator; ragged ones are counted by scanning.
        """
        for level in self.levels:
            for r in level.lowers + level.uppers:
                if any(r[j] != 0 for j in range(level.k)):
                    return False
        return True

    def _param_vec(self, params) -> list[int]:
        if isinstance(params, dict):
            return [params[n] for n in self.poly.param_names]
        pv = list(params)
        assert len(pv) == self.nparam, (
            f"expected {self.nparam} params {self.poly.param_names}, got {pv}")
        return pv

    # ---------------------------------------------------------------- codegen
    def pretty_loops(self) -> str:
        """Human-readable pseudo-C of the generated loop nest (docs/debug)."""
        lines = []
        names = self.poly.dim_names
        pnames = self.poly.param_names

        def expr(r, k, flip):
            terms = []
            for j in range(k):
                c = -r[j] if not flip else r[j]
                if c:
                    terms.append(f"{'+' if c > 0 else ''}{c}*{names[j]}")
            for j in range(self.nparam):
                c = r[k + 1 + j]
                c = -c if not flip else c
                if c:
                    terms.append(f"{'+' if c > 0 else ''}{c}*{pnames[j]}")
            c = -r[-1] if not flip else r[-1]
            if c or not terms:
                terms.append(f"{'+' if c > 0 else ''}{c}")
            return " ".join(terms)

        for level in self.levels:
            k = level.k
            lbs = [f"ceild({expr(r, k, False)}, {r[k]})" for r in level.lowers]
            ubs = [f"floord({expr(r, k, True)}, {-r[k]})" for r in level.uppers]
            lb = lbs[0] if len(lbs) == 1 else "max(" + ", ".join(lbs) + ")"
            ub = ubs[0] if len(ubs) == 1 else "min(" + ", ".join(ubs) + ")"
            lines.append("  " * k + f"for ({names[k]} = {lb}; {names[k]} <= {ub}; {names[k]}++)")
        lines.append("  " * self.ndim + "body(" + ", ".join(names) + ");")
        return "\n".join(lines)
