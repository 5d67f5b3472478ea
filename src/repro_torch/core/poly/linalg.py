"""Exact rational linear algebra over ``fractions.Fraction``.

Everything in ``repro_torch.core.poly`` is exact: no floating point ever enters the
polyhedral computations (paper §3 relies on exact integer/rational sets).

Matrices are tuples-of-tuples of Fractions (immutable, hashable); small helper
functions implement the handful of operations the polyhedral layer needs:
matmul, inverse (Gauss-Jordan), identity, diagonal, row reduction.
"""
from __future__ import annotations

from fractions import Fraction
from typing import Iterable, Sequence

Frac = Fraction
Row = tuple[Fraction, ...]
Mat = tuple[Row, ...]


def frac(x) -> Fraction:
    """Coerce ints / strings / Fractions to Fraction (floats are rejected)."""
    if isinstance(x, float):
        raise TypeError("floats are not allowed in exact polyhedral math: %r" % (x,))
    return Fraction(x)


def vec(xs: Iterable) -> Row:
    return tuple(frac(x) for x in xs)


def mat(rows: Iterable[Iterable]) -> Mat:
    return tuple(vec(r) for r in rows)


def zeros(n: int) -> Row:
    return (Fraction(0),) * n


def eye(n: int) -> Mat:
    return tuple(
        tuple(Fraction(1) if i == j else Fraction(0) for j in range(n))
        for i in range(n)
    )


def diag(ds: Sequence) -> Mat:
    ds = vec(ds)
    n = len(ds)
    return tuple(
        tuple(ds[i] if i == j else Fraction(0) for j in range(n)) for i in range(n)
    )


def mat_shape(m: Mat) -> tuple[int, int]:
    return (len(m), len(m[0]) if m else 0)


def mat_mul(a: Mat, b: Mat) -> Mat:
    n, k = mat_shape(a)
    k2, p = mat_shape(b)
    assert k == k2, f"shape mismatch {mat_shape(a)} @ {mat_shape(b)}"
    bt = tuple(zip(*b))
    return tuple(
        tuple(sum(x * y for x, y in zip(row, col)) for col in bt) for row in a
    )


def mat_vec(a: Mat, x: Row) -> Row:
    return tuple(sum(c * v for c, v in zip(row, x)) for row in a)


def vec_mat(x: Row, a: Mat) -> Row:
    """Row-vector times matrix: (x^T A)."""
    n, p = mat_shape(a)
    assert len(x) == n
    return tuple(sum(x[i] * a[i][j] for i in range(n)) for j in range(p))


def dot(x: Row, y: Row) -> Fraction:
    return sum((a * b for a, b in zip(x, y)), Fraction(0))


def mat_inv(m: Mat) -> Mat:
    """Exact inverse via Gauss-Jordan with partial (nonzero) pivoting."""
    n, k = mat_shape(m)
    assert n == k, "inverse needs a square matrix"
    aug = [list(row) + list(eye_row) for row, eye_row in zip(m, eye(n))]
    for col in range(n):
        piv = next((r for r in range(col, n) if aug[r][col] != 0), None)
        if piv is None:
            raise ZeroDivisionError("matrix is singular")
        aug[col], aug[piv] = aug[piv], aug[col]
        pv = aug[col][col]
        aug[col] = [x / pv for x in aug[col]]
        for r in range(n):
            if r != col and aug[r][col] != 0:
                f = aug[r][col]
                aug[r] = [x - f * y for x, y in zip(aug[r], aug[col])]
    return tuple(tuple(row[n:]) for row in aug)


def row_normalize(row: Row) -> Row:
    """Scale a constraint row to coprime integers (canonical form).

    Keeps the sign of the row; rows that are all-zero are returned unchanged.
    """
    from math import gcd

    den = 1
    for c in row:
        den = den * c.denominator // gcd(den, c.denominator)
    ints = [int(c * den) for c in row]
    g = 0
    for v in ints:
        g = gcd(g, abs(v))
    if g > 1:
        ints = [v // g for v in ints]
    return tuple(Fraction(v) for v in ints)


def is_zero_row(row: Row) -> bool:
    return all(c == 0 for c in row)


def rref(rows: list[list[Fraction]]) -> list[list[Fraction]]:
    """Reduced row echelon form (in place on a copy); drops zero rows."""
    rows = [list(r) for r in rows]
    m = len(rows)
    n = len(rows[0]) if m else 0
    lead = 0
    out = []
    for col in range(n):
        piv = next((r for r in range(lead, m) if rows[r][col] != 0), None)
        if piv is None:
            continue
        rows[lead], rows[piv] = rows[piv], rows[lead]
        pv = rows[lead][col]
        rows[lead] = [x / pv for x in rows[lead]]
        for r in range(m):
            if r != lead and rows[r][col] != 0:
                f = rows[r][col]
                rows[r] = [x - f * y for x, y in zip(rows[r], rows[lead])]
        lead += 1
        if lead == m:
            break
    for r in rows:
        if any(c != 0 for c in r):
            out.append(r)
    return out
