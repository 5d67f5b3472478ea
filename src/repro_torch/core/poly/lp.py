"""Exact rational linear programming (two-phase primal simplex, Bland's rule).

Used by the polyhedron layer for:
  * feasibility / emptiness certificates,
  * redundancy removal (is constraint c implied by the rest?),
  * inclusion tests (P1 subseteq P2),
  * numeric bounds when scanning loop nests.

All arithmetic is in ``fractions.Fraction`` so there is no numerical error and
Bland's rule guarantees termination.  Problems in this codebase are small
(tens of variables, low hundreds of constraints) which exact simplex handles
comfortably.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Optional, Sequence

F0 = Fraction(0)
F1 = Fraction(1)


@dataclass
class LPResult:
    status: str  # 'optimal' | 'unbounded' | 'infeasible'
    value: Optional[Fraction] = None
    x: Optional[tuple[Fraction, ...]] = None


class _Simplex:
    """maximize c.z  s.t.  A z = b (b >= 0), z >= 0, with a known basis.

    Bland's rule (lowest-index entering / leaving) => guaranteed termination.
    ``blocked`` columns may never enter the basis (used to freeze artificials
    in phase 2).
    """

    def __init__(self, rows: list[list[Fraction]], basis: list[int]):
        self.rows = rows          # each row: coeffs + [rhs]
        self.basis = basis
        self.m = len(rows)
        self.ncol = len(rows[0]) - 1 if rows else 0
        self.obj: list[Fraction] = []
        self.blocked: set[int] = set()

    def set_objective(self, c: list[Fraction]) -> None:
        """Install objective (maximize) and price it out w.r.t. current basis."""
        self.obj = list(c) + [F0]
        for i, bi in enumerate(self.basis):
            if self.obj[bi] != 0:
                f = self.obj[bi]
                self.obj = [x - f * y for x, y in zip(self.obj, self.rows[i])]

    def pivot(self, r: int, col: int) -> None:
        pv = self.rows[r][col]
        self.rows[r] = [x / pv for x in self.rows[r]]
        prow = self.rows[r]
        for i in range(self.m):
            if i != r and self.rows[i][col] != 0:
                f = self.rows[i][col]
                self.rows[i] = [x - f * y for x, y in zip(self.rows[i], prow)]
        if self.obj and self.obj[col] != 0:
            f = self.obj[col]
            self.obj = [x - f * y for x, y in zip(self.obj, prow)]
        self.basis[r] = col

    def run(self) -> str:
        while True:
            col = next((j for j in range(self.ncol)
                        if j not in self.blocked and self.obj[j] > 0), None)
            if col is None:
                return "optimal"
            best_r, best_ratio = None, None
            for i in range(self.m):
                a = self.rows[i][col]
                if a > 0:
                    ratio = self.rows[i][-1] / a
                    if (best_ratio is None or ratio < best_ratio or
                            (ratio == best_ratio and self.basis[i] < self.basis[best_r])):
                        best_r, best_ratio = i, ratio
            if best_r is None:
                return "unbounded"
            self.pivot(best_r, col)

    def value(self) -> Fraction:
        return -self.obj[-1]

    def solution(self, n: int) -> list[Fraction]:
        x = [F0] * n
        for i, b in enumerate(self.basis):
            if b < n:
                x[b] = self.rows[i][-1]
        return x


def lp_solve(ineqs: Sequence[Sequence[Fraction]], nvar: int,
             objective: Sequence[Fraction], maximize: bool = True) -> LPResult:
    """Optimize ``objective . x`` over {x free : row[:nvar].x + row[nvar] >= 0}.

    ``ineqs`` rows have length nvar+1 (coefficients then constant term).
    """
    sign = F1 if maximize else -F1
    m = len(ineqs)
    # Free x via split x_j = z_{2j} - z_{2j+1};  a.x + c >= 0  =>  -a.x <= c
    # => standard row:  sum_j (-a_j)(z+ - z-) + slack = c.
    nz = 2 * nvar
    ncol = nz + m + m  # real pairs | slacks | artificials (allocated lazily)
    rows: list[list[Fraction]] = []
    basis: list[int] = []
    art_cols: list[int] = []
    nart = 0
    for i, row in enumerate(ineqs):
        a, const = row[:nvar], Fraction(row[nvar])
        r = []
        for j in range(nvar):
            r.append(-Fraction(a[j]))
            r.append(Fraction(a[j]))
        slack = [F0] * m
        slack[i] = F1
        r = r + slack
        if const < 0:
            r = [-x for x in r]
            const = -const
            rows.append(r)  # artificial appended after we know nart
            basis.append(-1)  # placeholder -> artificial
            art_cols.append(i)
            nart += 1
        else:
            rows.append(r)
            basis.append(nz + i)  # slack is basic
        rows[-1].append(const)

    # install artificial columns
    ncol = nz + m + nart
    k = 0
    for i in range(m):
        body, rhs = rows[i][:-1], rows[i][-1]
        art = [F0] * nart
        if basis[i] == -1:
            art[k] = F1
            basis[i] = nz + m + k
            k += 1
        rows[i] = body + art + [rhs]

    sx = _Simplex(rows, basis)

    if nart:
        phase1 = [F0] * (nz + m) + [-F1] * nart
        sx.set_objective(phase1)
        st = sx.run()
        assert st == "optimal"
        if sx.value() != 0:
            return LPResult("infeasible")
        # Pivot any artificial still in the basis out (degenerate rows).
        for i in range(sx.m):
            if sx.basis[i] >= nz + m:
                col = next((j for j in range(nz + m) if sx.rows[i][j] != 0), None)
                if col is not None:
                    sx.pivot(i, col)
        sx.blocked = set(range(nz + m, ncol))

    obj = [F0] * ncol
    for j in range(nvar):
        obj[2 * j] = sign * Fraction(objective[j])
        obj[2 * j + 1] = -sign * Fraction(objective[j])
    sx.set_objective(obj)
    st = sx.run()
    if st == "unbounded":
        return LPResult("unbounded")
    z = sx.solution(nz)
    x = tuple(z[2 * j] - z[2 * j + 1] for j in range(nvar))
    val = sum((Fraction(objective[j]) * x[j] for j in range(nvar)), F0)
    return LPResult("optimal", val, x)


def lp_feasible(ineqs: Sequence[Sequence[Fraction]], nvar: int) -> bool:
    """Is {x : a.x + c >= 0 for all rows} non-empty (over the rationals)?"""
    return lp_solve(ineqs, nvar, [F0] * nvar).status != "infeasible"


def lp_min(ineqs, nvar, objective) -> LPResult:
    return lp_solve(ineqs, nvar, objective, maximize=False)


def lp_max(ineqs, nvar, objective) -> LPResult:
    return lp_solve(ineqs, nvar, objective, maximize=True)
