"""Parametric rational polyhedra in constraint form.

A :class:`Polyhedron` is ``{ x in Q^ndim : A.x + D.p + c >= 0,  E.x + F.p + g = 0 }``
where ``p`` is a vector of symbolic parameters (e.g. problem sizes ``N``).
Rows are stored over the combined column space ``[dims..., params..., 1]`` with
exact ``Fraction`` coefficients.

This is the substrate for the paper's §3: dependence polyhedra, tiling by
compression, direct sums, inflation, and the Fourier-Motzkin *projection*
baseline it is benchmarked against.
"""
from __future__ import annotations

import itertools
from dataclasses import dataclass
from fractions import Fraction
from typing import Iterable, Optional, Sequence

from .linalg import (Mat, Row, frac, is_zero_row, mat_inv, mat_vec,
                     row_normalize, vec, vec_mat)
from .lp import lp_feasible, lp_max, lp_min

F0 = Fraction(0)
F1 = Fraction(1)


def _dedupe(rows: Iterable[Row]) -> tuple[Row, ...]:
    seen, out = set(), []
    for r in rows:
        if r not in seen:
            seen.add(r)
            out.append(r)
    return tuple(out)


@dataclass(frozen=True)
class Polyhedron:
    dim_names: tuple[str, ...]
    param_names: tuple[str, ...]
    ineqs: tuple[Row, ...] = ()   # a.x + d.p + c >= 0
    eqs: tuple[Row, ...] = ()     # e.x + f.p + g  = 0

    # ---------------------------------------------------------------- basics
    @property
    def ndim(self) -> int:
        return len(self.dim_names)

    @property
    def nparam(self) -> int:
        return len(self.param_names)

    @property
    def ncol(self) -> int:
        return self.ndim + self.nparam + 1

    def __post_init__(self):
        for r in itertools.chain(self.ineqs, self.eqs):
            assert len(r) == self.ncol, (len(r), self.ncol)

    # -------------------------------------------------------------- builders
    @staticmethod
    def universe(dim_names: Sequence[str], param_names: Sequence[str] = ()) -> "Polyhedron":
        return Polyhedron(tuple(dim_names), tuple(param_names))

    @staticmethod
    def from_ineqs(dim_names, param_names, rows, eqs=()) -> "Polyhedron":
        rows = tuple(vec(r) for r in rows)
        eqs = tuple(vec(r) for r in eqs)
        return Polyhedron(tuple(dim_names), tuple(param_names), rows, eqs).canonical()

    @staticmethod
    def box(dim_names, lo: Sequence, hi: Sequence, param_names=()) -> "Polyhedron":
        """Axis-aligned box lo_i <= x_i <= hi_i (bounds are rationals)."""
        n, npar = len(dim_names), len(param_names)
        rows = []
        for i, (lb, ub) in enumerate(zip(lo, hi)):
            lo_row = [F0] * (n + npar + 1)
            lo_row[i] = F1
            lo_row[-1] = -frac(lb)
            hi_row = [F0] * (n + npar + 1)
            hi_row[i] = -F1
            hi_row[-1] = frac(ub)
            rows += [tuple(lo_row), tuple(hi_row)]
        return Polyhedron(tuple(dim_names), tuple(param_names), tuple(rows))

    # ---------------------------------------------------------- canonical form
    def canonical(self) -> "Polyhedron":
        """Normalize rows to coprime ints, drop tautologies, dedupe."""
        ineqs, eqs = [], []
        for r in self.eqs:
            r = row_normalize(r)
            if is_zero_row(r):
                continue
            if all(c == 0 for c in r[:-1]):
                # 0 = g with g != 0: infeasible; encode as 0 >= 1
                bad = list((F0,) * (self.ncol - 1)) + [Fraction(-1)]
                return Polyhedron(self.dim_names, self.param_names,
                                  (tuple(bad),), ())
            # canonical sign: first nonzero coefficient positive
            lead = next(c for c in r if c != 0)
            if lead < 0:
                r = tuple(-c for c in r)
            eqs.append(r)
        for r in self.ineqs:
            r = row_normalize(r)
            if all(c == 0 for c in r[:-1]):
                if r[-1] < 0:
                    bad = list((F0,) * (self.ncol - 1)) + [Fraction(-1)]
                    return Polyhedron(self.dim_names, self.param_names,
                                      (tuple(bad),), ())
                continue  # 0 >= -c, trivially true
            ineqs.append(r)
        return Polyhedron(self.dim_names, self.param_names,
                          _dedupe(ineqs), _dedupe(eqs))

    def all_rows_as_ineqs(self) -> tuple[Row, ...]:
        """Equalities expanded into constraint pairs (for LP / FM)."""
        rows = list(self.ineqs)
        for e in self.eqs:
            rows.append(e)
            rows.append(tuple(-c for c in e))
        return tuple(rows)

    # ------------------------------------------------------------- set algebra
    def intersect(self, other: "Polyhedron") -> "Polyhedron":
        assert self.dim_names == other.dim_names
        assert self.param_names == other.param_names
        return Polyhedron(self.dim_names, self.param_names,
                          _dedupe(self.ineqs + other.ineqs),
                          _dedupe(self.eqs + other.eqs)).canonical()

    def add_ineq(self, row: Sequence) -> "Polyhedron":
        return Polyhedron(self.dim_names, self.param_names,
                          self.ineqs + (vec(row),), self.eqs).canonical()

    def add_eq(self, row: Sequence) -> "Polyhedron":
        return Polyhedron(self.dim_names, self.param_names,
                          self.ineqs, self.eqs + (vec(row),)).canonical()

    # --------------------------------------------------------------- queries
    def is_empty(self) -> bool:
        """Empty for *all* parameter values (params treated as free rationals)."""
        nv = self.ndim + self.nparam
        return not lp_feasible(self.all_rows_as_ineqs(), nv)

    def is_empty_at(self, params: dict[str, int]) -> bool:
        return self.fix_params(params).is_empty()

    def sample(self) -> Optional[tuple[Fraction, ...]]:
        nv = self.ndim + self.nparam
        res = lp_min(self.all_rows_as_ineqs(), nv, [F0] * nv)
        return None if res.status == "infeasible" else res.x

    def contains_point(self, x: Sequence, params: Sequence = ()) -> bool:
        col = vec(list(x) + list(params) + [1])
        return (all(sum(a * b for a, b in zip(r, col)) >= 0 for r in self.ineqs)
                and all(sum(a * b for a, b in zip(r, col)) == 0 for r in self.eqs))

    def contains(self, other: "Polyhedron") -> bool:
        """self >= other as sets (for every parameter value)? Exact via LP."""
        assert self.ncol == other.ncol
        if other.is_empty():
            return True
        nv = self.ndim + self.nparam
        rows = other.all_rows_as_ineqs()
        for c in self.all_rows_as_ineqs():
            # min over `other` of c.x must be >= 0
            res = lp_min(rows, nv, c[:nv])
            if res.status == "unbounded":
                return False
            if res.status == "optimal" and res.value + c[nv] < 0:
                return False
        return True

    def equals(self, other: "Polyhedron") -> bool:
        return self.contains(other) and other.contains(self)

    def dim_bounds(self, i: int) -> tuple[Optional[Fraction], Optional[Fraction]]:
        """(min, max) of dimension i over the polyhedron (params free). None=unbounded."""
        nv = self.ndim + self.nparam
        obj = [F0] * nv
        obj[i] = F1
        rows = self.all_rows_as_ineqs()
        lo = lp_min(rows, nv, obj)
        hi = lp_max(rows, nv, obj)
        if lo.status == "infeasible":
            return (None, None)
        return (lo.value if lo.status == "optimal" else None,
                hi.value if hi.status == "optimal" else None)

    # ---------------------------------------------------------- substitutions
    def fix_params(self, params: dict[str, int]) -> "Polyhedron":
        """Substitute concrete values for a subset of parameters."""
        keep = [i for i, n in enumerate(self.param_names) if n not in params]
        newp = tuple(self.param_names[i] for i in keep)

        def conv(row: Row) -> Row:
            out = list(row[:self.ndim])
            const = row[-1]
            for i, name in enumerate(self.param_names):
                c = row[self.ndim + i]
                if name in params:
                    const += c * frac(params[name])
                else:
                    out.append(c)
            out.append(const)
            return tuple(out)

        return Polyhedron(self.dim_names, newp,
                          tuple(conv(r) for r in self.ineqs),
                          tuple(conv(r) for r in self.eqs)).canonical()

    def fix_dims(self, values: dict[int, Fraction]) -> "Polyhedron":
        """Substitute concrete values for a subset of dimensions (by index)."""
        keep = [i for i in range(self.ndim) if i not in values]
        newd = tuple(self.dim_names[i] for i in keep)

        def conv(row: Row) -> Row:
            out = []
            const = row[-1]
            for i in range(self.ndim):
                if i in values:
                    const += row[i] * frac(values[i])
                else:
                    out.append(row[i])
            out.extend(row[self.ndim:self.ndim + self.nparam])
            out.append(const)
            return tuple(out)

        return Polyhedron(newd, self.param_names,
                          tuple(conv(r) for r in self.ineqs),
                          tuple(conv(r) for r in self.eqs)).canonical()

    def preimage_affine(self, M: Mat, t: Row, new_dim_names: Sequence[str]) -> "Polyhedron":
        """{ y : M.y + t in self }  (x = M y + t substituted into constraints).

        M is ndim x len(new_dim_names); t length ndim. Parameters are untouched.
        """

        def conv(row: Row) -> Row:
            a = row[:self.ndim]
            rest = row[self.ndim:]
            ay = vec_mat(a, M)  # coefficients over y
            const_shift = sum((ai * ti for ai, ti in zip(a, t)), F0)
            out = list(ay) + list(rest[:-1]) + [rest[-1] + const_shift]
            return tuple(out)

        return Polyhedron(tuple(new_dim_names), self.param_names,
                          tuple(conv(r) for r in self.ineqs),
                          tuple(conv(r) for r in self.eqs)).canonical()

    def image_invertible(self, M: Mat, t: Row, new_dim_names: Sequence[str]) -> "Polyhedron":
        """{ M.x + t : x in self } for invertible M — exact, no projection.

        This is the paper's compression step: ``image(D, G^{-1})`` with
        M = G^{-1}.  Computed by substituting x = M^{-1}(y - t).
        """
        Minv = mat_inv(M)
        t_new = tuple(-c for c in mat_vec(Minv, t))
        return self.preimage_affine(Minv, t_new, new_dim_names)

    def rename(self, dim_names=None, param_names=None) -> "Polyhedron":
        return Polyhedron(tuple(dim_names) if dim_names else self.dim_names,
                          tuple(param_names) if param_names else self.param_names,
                          self.ineqs, self.eqs)

    def add_dims(self, names: Sequence[str], front: bool = False) -> "Polyhedron":
        """Embed into a larger space (new dims unconstrained)."""
        k = len(names)

        def conv(row: Row) -> Row:
            if front:
                return (F0,) * k + row
            return row[:self.ndim] + (F0,) * k + row[self.ndim:]

        dn = (tuple(names) + self.dim_names) if front else (self.dim_names + tuple(names))
        return Polyhedron(dn, self.param_names,
                          tuple(conv(r) for r in self.ineqs),
                          tuple(conv(r) for r in self.eqs))

    # ----------------------------------------------- §3.1 inflation (paper)
    def inflate_box(self, lo: Sequence, hi: Sequence) -> "Polyhedron":
        """Over-approximate ``self ⊕ Box(lo, hi)`` by shifting constraints.

        Paper §3.1: for each constraint a.x + b >= 0 the required offset is
        c_max(a) = max_{u in Box} (-a.u) = sum_i max(-a_i*lo_i, -a_i*hi_i).
        Same combinatorial structure (no new vertices/constraints).
        Equalities whose dim-part is nonzero become inequality pairs, inflated
        independently (an equality thickens into a slab under Minkowski sum).
        """
        lo = vec(lo)
        hi = vec(hi)
        assert len(lo) == self.ndim and len(hi) == self.ndim

        def shifted(row: Row) -> Row:
            c = sum((max(-row[i] * lo[i], -row[i] * hi[i]) for i in range(self.ndim)), F0)
            return row[:-1] + (row[-1] + c,)

        new_ineqs = [shifted(r) for r in self.ineqs]
        new_eqs = []
        for e in self.eqs:
            if all(e[i] == 0 for i in range(self.ndim)):
                new_eqs.append(e)  # pure-parameter equality: unaffected
            else:
                new_ineqs.append(shifted(e))
                new_ineqs.append(shifted(tuple(-c for c in e)))
        return Polyhedron(self.dim_names, self.param_names,
                          _dedupe(new_ineqs), tuple(new_eqs)).canonical()

    # ------------------------------------------------------------ repr/debug
    def pretty(self) -> str:
        names = list(self.dim_names) + list(self.param_names)

        def fmt(row: Row, op: str) -> str:
            terms = []
            for c, n in zip(row[:-1], names):
                if c == 0:
                    continue
                if c == 1:
                    terms.append(f"+{n}")
                elif c == -1:
                    terms.append(f"-{n}")
                else:
                    terms.append(f"{'+' if c > 0 else ''}{c}*{n}")
            if row[-1] != 0 or not terms:
                terms.append(f"{'+' if row[-1] > 0 else ''}{row[-1]}")
            return " ".join(terms) + f" {op} 0"

        lines = [fmt(r, ">=") for r in self.ineqs] + [fmt(r, "=") for r in self.eqs]
        return "{ [%s] : %s }" % (", ".join(self.dim_names), " and ".join(lines) or "true")

    def __repr__(self) -> str:  # pragma: no cover
        return f"Polyhedron({self.pretty()}, params={self.param_names})"
