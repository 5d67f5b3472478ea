"""Fourier-Motzkin projection — the *baseline* tile-dependence method.

The prior-art technique ([2, 9, 14] in the paper) computes inter-tile
dependences by building the high-dimensional polyhedron over
``(T_s, X_s, T_t, X_t)`` and projecting out the intra-tile dims ``X``.
FM elimination scales poorly with dimension count (worst case doubly
exponential in eliminated dims) — which is precisely the tractability problem
the paper's compression method (``compression.py``) removes.

We implement FM exactly (rational arithmetic), with:
  * Gaussian elimination through equalities first (free eliminations),
  * canonical row normalization + syntactic dominance filtering,
  * optional exact LP-based redundancy pruning (``simplify='lp'``) to keep
    intermediate systems from exploding in the correctness tests.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Iterable, Sequence

from .linalg import is_zero_row, row_normalize
from .lp import lp_min
from .polyhedron import Polyhedron

F0 = Fraction(0)


def _dominance_filter(rows: Iterable[tuple]) -> list[tuple]:
    """Keep only the tightest constant per distinct coefficient vector."""
    best: dict[tuple, Fraction] = {}
    for r in rows:
        key, const = r[:-1], r[-1]
        if key not in best or const < best[key]:
            best[key] = const
    return [k + (c,) for k, c in best.items()]


def _lp_prune(rows: list[tuple], nv: int) -> list[tuple]:
    """Remove constraints implied by the others (exact, O(rows) LPs)."""
    rows = list(rows)
    i = 0
    while i < len(rows):
        others = rows[:i] + rows[i + 1:]
        if not others:
            break
        r = rows[i]
        res = lp_min(others, nv, r[:nv])
        if res.status == "optimal" and res.value + r[nv] >= 0:
            rows.pop(i)  # implied
        elif res.status == "infeasible":
            return [rows[i]] if False else rows  # empty set: keep as-is
        else:
            i += 1
    return rows


def eliminate_dim(ineqs: list[tuple], col: int) -> list[tuple]:
    """One FM elimination step on inequality rows (col = column index)."""
    pos, neg, zero = [], [], []
    for r in ineqs:
        c = r[col]
        if c > 0:
            pos.append(r)
        elif c < 0:
            neg.append(r)
        else:
            zero.append(r)
    out = list(zero)
    for p in pos:
        for n in neg:
            # p[col] > 0, n[col] < 0: combine to cancel col
            a, b = p[col], -n[col]
            row = tuple(b * pc + a * nc for pc, nc in zip(p, n))
            row = row_normalize(row)
            if is_zero_row(row):
                continue
            if all(c == 0 for c in row[:-1]):
                if row[-1] < 0:
                    return [row]  # infeasible marker: 0 >= positive
                continue
            out.append(row)
    return _dominance_filter(out)


def project_out(poly: Polyhedron, dims: Sequence[int],
                simplify: str = "auto", lp_threshold: int = 64) -> Polyhedron:
    """Project away the given dim indices (existential quantification).

    simplify: 'none' | 'auto' (LP-prune when the system grows past
    ``lp_threshold`` rows) | 'lp' (always LP-prune after each elimination).
    """
    dims = sorted(set(dims))
    keep = [i for i in range(poly.ndim) if i not in dims]

    eqs = [tuple(r) for r in poly.eqs]
    ineqs = [tuple(r) for r in poly.ineqs]

    # Gaussian elimination: use equalities to remove dims for free.
    remaining = list(dims)
    for d in list(remaining):
        pivot = next((e for e in eqs if e[d] != 0), None)
        if pivot is None:
            continue
        eqs.remove(pivot)

        def subst(row):
            if row[d] == 0:
                return row
            f = row[d] / pivot[d]
            return tuple(rc - f * pc for rc, pc in zip(row, pivot))

        eqs = [row_normalize(subst(e)) for e in eqs]
        eqs = [e for e in eqs if not is_zero_row(e)]
        ineqs = [row_normalize(subst(r)) for r in ineqs]
        ineqs = [r for r in ineqs if not is_zero_row(r)]
        remaining.remove(d)

    # FM on what's left. Equalities with support on eliminated dims must be
    # expanded (none remain after Gaussian elim unless duplicated; be safe).
    for d in remaining:
        extra = [e for e in eqs if e[d] != 0]
        if extra:
            for e in extra:
                eqs.remove(e)
                ineqs.append(e)
                ineqs.append(tuple(-c for c in e))
        ineqs = eliminate_dim(ineqs, d)
        if simplify == "lp" or (simplify == "auto" and len(ineqs) > lp_threshold):
            nv = poly.ndim + poly.nparam
            # prune only the inequality part against the full system
            ineqs = _lp_prune(ineqs, nv)

    # Drop the eliminated columns.
    def strip(row):
        body = [row[i] for i in keep]
        body += list(row[poly.ndim:])
        return tuple(body)

    new = Polyhedron(tuple(poly.dim_names[i] for i in keep), poly.param_names,
                     tuple(strip(r) for r in ineqs),
                     tuple(strip(e) for e in eqs))
    return new.canonical()


def project_onto(poly: Polyhedron, keep: Sequence[int], **kw) -> Polyhedron:
    drop = [i for i in range(poly.ndim) if i not in set(keep)]
    return project_out(poly, drop, **kw)


def minkowski_sum_box_exact(poly: Polyhedron, lo: Sequence, hi: Sequence,
                            **kw) -> Polyhedron:
    """Exact ``poly ⊕ Box(lo, hi)`` via lifting + projection.

    Builds {(y, u) : y - u in P, lo <= u <= hi} and projects out u.  Used as
    the *oracle* for validating §3.1 inflation; the production path never
    calls this (that is the point of the paper).
    """
    n = poly.ndim
    u_names = tuple(f"_u{i}" for i in range(n))
    lifted_dims = poly.dim_names + u_names

    def lift(row):
        a = row[:n]
        rest = row[n:]
        return tuple(a) + tuple(-c for c in a) + tuple(rest)

    box = Polyhedron.box(u_names, lo, hi, poly.param_names)

    lifted = Polyhedron(lifted_dims, poly.param_names,
                        tuple(lift(r) for r in poly.ineqs),
                        tuple(lift(e) for e in poly.eqs))
    box_l = box.add_dims(poly.dim_names, front=True)
    both = lifted.intersect(box_l)
    return project_out(both, list(range(n, 2 * n)), **kw)
