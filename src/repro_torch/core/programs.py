"""A suite of polyhedral programs (paper §5 benchmark families).

Each builder returns a :class:`PolyhedralProgram` with symbolic size
parameters.  These cover the families the paper evaluates: stencils
(jacobi/seidel/heat), dense linear algebra (matmul, trisolv, LU-like
triangular loops), the diamond DAG of Fig 1/2 (single dominator — worst case
for prescribed synchronization), pipelines, and synthetic high-dimensional
codes that stress Fourier-Motzkin.
"""
from __future__ import annotations

from typing import Sequence

from .edt.taskgraph import PolyhedralProgram
from .poly import Polyhedron


def _product_domain(src: Polyhedron, tgt: Polyhedron,
                    src_suffix: str = "_s", tgt_suffix: str = "_t") -> Polyhedron:
    """Cartesian product src × tgt with renamed dims (shared params)."""
    assert src.param_names == tgt.param_names
    sd = tuple(n + src_suffix for n in src.dim_names)
    td = tuple(n + tgt_suffix for n in tgt.dim_names)
    a = src.rename(dim_names=sd).add_dims(td)
    b = tgt.rename(dim_names=td).add_dims(sd, front=True)
    return a.intersect(b.rename(dim_names=sd + td))


def dep(src: Polyhedron, tgt: Polyhedron, eqs: Sequence[Sequence[int]] = (),
        ineqs: Sequence[Sequence[int]] = ()) -> Polyhedron:
    """Dependence polyhedron over (src dims, tgt dims) with extra rows.

    Row layout: [src dims..., tgt dims..., params..., const].
    """
    d = _product_domain(src, tgt)
    for e in eqs:
        d = d.add_eq(e)
    for r in ineqs:
        d = d.add_ineq(r)
    return d


# ---------------------------------------------------------------- stencils
#
# Stencils are written in *schedule-transformed* (time-skewed) coordinates,
# exactly as the paper assumes (§3: "tiling is performed along scheduling
# hyperplanes" — orthogonal tiling is applied after the affine schedule).
# A raw symmetric stencil tiled orthogonally would yield a cyclic tile graph
# (illegal tiling); skewing x = i + t makes every dependence component
# non-negative so any orthogonal tiling is legal.

def stencil1d() -> PolyhedralProgram:
    """Jacobi-1D, skewed: (t,x) <- (t-1, x-2..x).  Params (T, N).

    Domain {(t,x) : 0<=t<T, t<=x<t+N} (x = i + t)."""
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("t", "x"), ("T", "N"),
        [(1, 0, 0, 0, 0), (-1, 0, 1, 0, -1),    # 0 <= t <= T-1
         (-1, 1, 0, 0, 0), (1, -1, 0, 1, -1)])  # t <= x <= t+N-1
    P.add_statement("S", D)
    delta = dep(D, D,
                eqs=[(1, 0, -1, 0, 0, 0, 1)],                    # t_t = t_s + 1
                ineqs=[(0, -1, 0, 1, 0, 0, 0),                   # x_t >= x_s
                       (0, 1, 0, -1, 0, 0, 2)])                  # x_t <= x_s + 2
    P.add_dependence("S", "S", delta, "jacobi1d")
    return P


def seidel1d() -> PolyhedralProgram:
    """Gauss-Seidel-1D, skewed (x = i + t): (t,x)->(t,x+1), (t,x)->(t+1,x)."""
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("t", "x"), ("T", "N"),
        [(1, 0, 0, 0, 0), (-1, 0, 1, 0, -1),
         (-1, 1, 0, 0, 0), (1, -1, 0, 1, -1)])
    P.add_statement("S", D)
    P.add_dependence("S", "S", dep(D, D, eqs=[(1, 0, -1, 0, 0, 0, 0),
                                              (0, 1, 0, -1, 0, 0, 1)]),
                     "sweep")
    P.add_dependence("S", "S", dep(D, D, eqs=[(1, 0, -1, 0, 0, 0, 1),
                                              (0, 1, 0, -1, 0, 0, 0)]),
                     "carry")
    return P


def jacobi2d() -> PolyhedralProgram:
    """Jacobi-2D (9-point), skewed both space dims: offsets in {0,1,2}^2."""
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("t", "x", "y"), ("T", "N"),
        [(1, 0, 0, 0, 0, 0), (-1, 0, 0, 1, 0, -1),
         (-1, 1, 0, 0, 0, 0), (1, -1, 0, 0, 1, -1),
         (-1, 0, 1, 0, 0, 0), (1, 0, -1, 0, 1, -1)])
    P.add_statement("S", D)
    delta = dep(D, D,
                eqs=[(1, 0, 0, -1, 0, 0, 0, 0, 1)],
                ineqs=[(0, -1, 0, 0, 1, 0, 0, 0, 0),
                       (0, 1, 0, 0, -1, 0, 0, 0, 2),
                       (0, 0, -1, 0, 0, 1, 0, 0, 0),
                       (0, 0, 1, 0, 0, -1, 0, 0, 2)])
    P.add_dependence("S", "S", delta, "jacobi2d")
    return P


def heat3d() -> PolyhedralProgram:
    """Heat-3D (box stencil), skewed, 4 iteration dims — FM stress test."""
    P = PolyhedralProgram()
    rows = []
    nd, np_ = 4, 2  # (t,x,y,z), (T,N)
    # 0 <= t <= T-1
    lo = [0] * (nd + np_ + 1)
    lo[0] = 1
    hi = [0] * (nd + np_ + 1)
    hi[0], hi[nd], hi[-1] = -1, 1, -1
    rows += [lo, hi]
    for d in range(1, nd):
        lo = [0] * (nd + np_ + 1)
        lo[0], lo[d] = -1, 1            # x_d >= t
        hi = [0] * (nd + np_ + 1)
        hi[0], hi[d], hi[nd + 1], hi[-1] = 1, -1, 1, -1  # x_d <= t + N - 1
        rows += [lo, hi]
    D = Polyhedron.from_ineqs(("t", "x", "y", "z"), ("T", "N"), rows)
    P.add_statement("S", D)
    n2 = 2 * nd
    eq = [0] * (n2 + np_ + 1)
    eq[0], eq[nd], eq[-1] = 1, -1, 1          # t_t = t_s + 1
    ineqs = []
    for d in range(1, nd):
        r1 = [0] * (n2 + np_ + 1)
        r1[d], r1[nd + d] = -1, 1              # x_t >= x_s
        r2 = [0] * (n2 + np_ + 1)
        r2[d], r2[nd + d], r2[-1] = 1, -1, 2   # x_t <= x_s + 2
        ineqs += [r1, r2]
    P.add_dependence("S", "S", dep(D, D, eqs=[eq], ineqs=ineqs), "heat3d")
    return P


# ------------------------------------------------------------ linear algebra
def matmul() -> PolyhedralProgram:
    """Tiled C += A.B with the reduction loop kept sequential per (i,j).

    A task per (i,j,k) tile; dependence (i,j,k) -> (i,j,k+1) — the paper
    notes tasks are formed over all three loops for load balancing."""
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("i", "j", "k"), ("N",),
        [(1, 0, 0, 0, 0), (-1, 0, 0, 1, -1),
         (0, 1, 0, 0, 0), (0, -1, 0, 1, -1),
         (0, 0, 1, 0, 0), (0, 0, -1, 1, -1)])
    P.add_statement("S", D)
    P.add_dependence("S", "S", dep(D, D, eqs=[
        (1, 0, 0, -1, 0, 0, 0, 0),
        (0, 1, 0, 0, -1, 0, 0, 0),
        (0, 0, 1, 0, 0, -1, 0, 1)]), "kred")
    return P


def trisolv() -> PolyhedralProgram:
    """Forward substitution: x_i -= L_ij x_j then divide.

    Domain {(i,j) : 0 <= j <= i < N}; deps:
      accumulate: (i,j) -> (i,j+1)   (j+1 <= i)
      broadcast:  (j,j) -> (i,j)     (i > j)  — x_j feeds every later row.
    Non-rectangular (triangular) — exercises the counting-loop strategy.
    """
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("i", "j"), ("N",),
        [(0, 1, 0, 0), (1, -1, 0, 0), (-1, 0, 1, -1)])  # 0<=j<=i<=N-1
    P.add_statement("S", D)
    P.add_dependence("S", "S", dep(D, D, eqs=[
        (1, 0, -1, 0, 0, 0),         # i_t = i_s
        (0, 1, 0, -1, 0, 1)]),       # j_t = j_s + 1
        "accum")
    P.add_dependence("S", "S", dep(
        D, D,
        eqs=[(1, -1, 0, 0, 0, 0),    # i_s = j_s   (the diagonal task)
             (0, 1, 0, -1, 0, 0)],   # j_t = j_s
        ineqs=[(-1, 0, 1, 0, 0, -1)]),  # i_t >= i_s + 1
        "bcast")
    return P


def cholesky_like() -> PolyhedralProgram:
    """Right-looking tiled Cholesky task DAG (à la TaskTorrent's benchmark).

    One statement S(k,i,j) over the prism {0 <= k <= j <= i <= N-1}; the
    role of a task is positional: (k,k,k) is POTRF(k), (k,i,k) with i>k is
    TRSM(k,i), and (k,i,j) with j>k is the SYRK/GEMM update of block (i,j)
    at step k.  Dependences:

      potrf_trsm: (k,k,k)   -> (k,i,k)    i>k   — the factored diagonal
                                                  feeds every panel solve
      upd_a:      (k,i,k)   -> (k,i,j)    j>k   — A(i,k) feeds row i updates
      upd_b:      (k,j,k)   -> (k,i,j)    i>j   — A(j,k) feeds column j
                                                  (strict: the diagonal SYRK
                                                  needs only upd_a)
      step:       (k,i,j)   -> (k+1,i,j)  j>k   — the updated block is the
                                                  step-(k+1) task on (i,j),
                                                  be it POTRF, TRSM, or GEMM

    Critical path Θ(N), wavefront width Θ(N²): the dense-LA shape whose
    frontier grows faster than the stencils' but slower than its task count
    — the interesting middle case for the sync-overhead atlas.
    """
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("k", "i", "j"), ("N",),
        [(1, 0, 0, 0, 0),        # k >= 0
         (-1, 0, 1, 0, 0),       # j >= k
         (0, 1, -1, 0, 0),       # i >= j
         (0, -1, 0, 1, -1)])     # i <= N-1
    P.add_statement("S", D)
    P.add_dependence("S", "S", dep(
        D, D,
        eqs=[(1, -1, 0, 0, 0, 0, 0, 0),      # i_s = k_s  (diagonal task)
             (1, 0, -1, 0, 0, 0, 0, 0),      # j_s = k_s
             (1, 0, 0, -1, 0, 0, 0, 0),      # k_t = k_s
             (1, 0, 0, 0, 0, -1, 0, 0)],     # j_t = k_s  (a panel solve)
        ineqs=[(-1, 0, 0, 0, 1, 0, 0, -1)]),  # i_t >= k_s + 1
        "potrf_trsm")
    P.add_dependence("S", "S", dep(
        D, D,
        eqs=[(1, 0, -1, 0, 0, 0, 0, 0),      # j_s = k_s  (a panel solve)
             (1, 0, 0, -1, 0, 0, 0, 0),      # k_t = k_s
             (0, 1, 0, 0, -1, 0, 0, 0)],     # i_t = i_s  (same row)
        ineqs=[(-1, 0, 0, 0, 0, 1, 0, -1)]),  # j_t >= k_s + 1
        "upd_a")
    P.add_dependence("S", "S", dep(
        D, D,
        eqs=[(1, 0, -1, 0, 0, 0, 0, 0),      # j_s = k_s  (a panel solve,
             (1, 0, 0, -1, 0, 0, 0, 0),      # k_t = k_s   strictly: i_s > k_s
             (0, 1, 0, 0, 0, -1, 0, 0)],     # j_t = i_s   so POTRF is excluded)
        ineqs=[(0, 0, 0, 0, 1, -1, 0, -1),    # i_t >= j_t + 1 (off-diagonal)
               (-1, 1, 0, 0, 0, 0, 0, -1)]),  # i_s >= k_s + 1
        "upd_b")
    P.add_dependence("S", "S", dep(
        D, D,
        eqs=[(1, 0, 0, -1, 0, 0, 0, 1),      # k_t = k_s + 1
             (0, 1, 0, 0, -1, 0, 0, 0),      # i_t = i_s
             (0, 0, 1, 0, 0, -1, 0, 0)]),    # j_t = j_s (j_s > k_s implied
        "step")                              #   by the target domain)
    return P


def lu_like() -> PolyhedralProgram:
    """Right-looking update pattern: (k,i,j) <- (k-1,i,j), plus panel deps.

    Domain {(k,i,j): 0<=k<N, k<i<N... relaxed to k<=i,j<=N-1} — triangular in
    two dims; a heavier non-rectangular case."""
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("k", "i", "j"), ("N",),
        [(1, 0, 0, 0, 0), (-1, 1, 0, 0, 0), (-1, 0, 1, 0, 0),
         (0, -1, 0, 1, -1), (0, 0, -1, 1, -1)])
    P.add_statement("S", D)
    P.add_dependence("S", "S", dep(D, D, eqs=[
        (1, 0, 0, -1, 0, 0, 0, 1),      # k_t = k_s + 1
        (0, 1, 0, 0, -1, 0, 0, 0),      # i_t = i_s
        (0, 0, 1, 0, 0, -1, 0, 0)]),    # j_t = j_s
        "update")
    P.add_dependence("S", "S", dep(
        D, D,
        eqs=[(1, -1, 0, 0, 0, 0, 0, 0),   # i_s = k_s (panel row)
             (1, 0, 0, -1, 0, 0, 0, 0),   # k_t = k_s
             (0, 0, 1, 0, 0, -1, 0, 0)],  # j_t = j_s (same column)
        ineqs=[(0, -1, 0, 0, 1, 0, 0, -1)]),  # i_t > i_s
        "panel")
    return P


# ----------------------------------------------------------------- graphs
def diamond() -> PolyhedralProgram:
    """Grid DAG with right/down deps — single dominator at (0,0).

    The paper's worst case for prescribed Method 1 (Fig 1): the entire graph
    is dominated by one task, so the master must set up all O(n) tasks and
    O(n) edges before anything runs."""
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("i", "j"), ("K",),
        [(1, 0, 0, 0), (-1, 0, 1, -1), (0, 1, 0, 0), (0, -1, 1, -1)])
    P.add_statement("S", D)
    P.add_dependence("S", "S", dep(D, D, eqs=[
        (1, 0, -1, 0, 0, 1), (0, 1, 0, -1, 0, 0)]), "down")
    P.add_dependence("S", "S", dep(D, D, eqs=[
        (1, 0, -1, 0, 0, 0), (0, 1, 0, -1, 0, 1)]), "right")
    return P


def pipeline() -> PolyhedralProgram:
    """(microbatch m, stage s) with deps (m,s)->(m,s+1) and (m,s)->(m+1,s).

    Exactly the pipeline-parallel training schedule; params (M, S)."""
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("m", "s"), ("M", "S"),
        [(1, 0, 0, 0, 0), (-1, 0, 1, 0, -1),
         (0, 1, 0, 0, 0), (0, -1, 0, 1, -1)])
    P.add_statement("S", D)
    P.add_dependence("S", "S", dep(D, D, eqs=[
        (1, 0, -1, 0, 0, 0, 0), (0, 1, 0, -1, 0, 0, 1)]), "stage")
    P.add_dependence("S", "S", dep(D, D, eqs=[
        (1, 0, -1, 0, 0, 0, 1), (0, 1, 0, -1, 0, 0, 0)]), "next_mb")
    return P


def fanout_band(f: int) -> PolyhedralProgram:
    """Layered band DAG with constant per-task fan-out ~2f+1; params (L, W).

    Tasks (l, i) on an L×W grid; (l, i) feeds (l+1, j) for |j - i| <= f.
    Depth and wavefront width are *independent* parameters (depth L, width
    exactly W at every level) and the dependence fan-out is set by the
    compile-time band radius ``f`` — the atlas's knob for sweeping
    dependence fan-out and frontier width orthogonally (a banded stand-in
    for fan-out trees: affine, so the fan-out must be a constant, not a
    program parameter).

    Written skewed (x = i + f·l), like the stencils: the raw band has
    dependence components i_t - i_s < 0, so an orthogonal tiling with more
    than one layer per tile would produce a cyclic tile graph; skewing
    makes every component non-negative (0 <= x_t - x_s <= 2f) and any
    tiling legal.
    """
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("l", "x"), ("L", "W"),
        [(1, 0, 0, 0, 0), (-1, 0, 1, 0, -1),     # 0 <= l <= L-1
         (-f, 1, 0, 0, 0), (f, -1, 0, 1, -1)])   # f*l <= x <= f*l + W-1
    P.add_statement("S", D)
    P.add_dependence("S", "S", dep(
        D, D,
        eqs=[(1, 0, -1, 0, 0, 0, 1)],            # l_t = l_s + 1
        ineqs=[(0, -1, 0, 1, 0, 0, 0),           # x_t >= x_s
               (0, 1, 0, -1, 0, 0, 2 * f)]),     # x_t <= x_s + 2f
        f"band{f}")
    return P


def embarrassing() -> PolyhedralProgram:
    """No dependences at all (the 'embarrassingly parallel' control case)."""
    P = PolyhedralProgram()
    D = Polyhedron.from_ineqs(
        ("i",), ("N",), [(1, 0, 0), (-1, 1, -1)])
    P.add_statement("S", D)
    return P


def synthetic_highdim(nd: int = 5) -> PolyhedralProgram:
    """nd-dimensional box with a unit shift in every dim — FM stress test.

    The projection baseline must eliminate 2*nd dims from a 4*nd-dim system;
    compression never leaves dimension nd."""
    P = PolyhedralProgram()
    rows = []
    for d in range(nd):
        lo = [0] * (nd + 2)
        lo[d] = 1
        hi = [0] * (nd + 2)
        hi[d], hi[nd], hi[-1] = -1, 1, -1
        rows += [lo, hi]
    D = Polyhedron.from_ineqs(tuple(f"x{i}" for i in range(nd)), ("N",), rows)
    P.add_statement("S", D)
    n2 = 2 * nd
    eqs = []
    for d in range(nd):
        e = [0] * (n2 + 2)
        e[d], e[nd + d], e[-1] = 1, -1, 1   # x_t = x_s + 1 in every dim
        eqs.append(e)
    P.add_dependence("S", "S", dep(D, D, eqs=eqs), "shift")
    return P


def _named(name: str, build):
    """Stamp the registry key onto the built program (kept in one place so
    ``PolyhedralProgram.name`` can never drift from the PROGRAMS key —
    the fused executor resolves stencil bodies through it)."""
    def builder() -> PolyhedralProgram:
        p = build()
        p.name = name
        return p
    builder.__name__ = getattr(build, "__name__", name)
    return builder


PROGRAMS = {name: _named(name, fn) for name, fn in {
    "stencil1d": stencil1d,
    "seidel1d": seidel1d,
    "jacobi2d": jacobi2d,
    "heat3d": heat3d,
    "matmul": matmul,
    "trisolv": trisolv,
    "lu_like": lu_like,
    "cholesky_like": cholesky_like,
    "diamond": diamond,
    "fanout2": lambda: fanout_band(2),
    "fanout8": lambda: fanout_band(8),
    "pipeline": pipeline,
    "embarrassing": embarrassing,
    "synthetic5d": lambda: synthetic_highdim(5),
    "synthetic6d": lambda: synthetic_highdim(6),
}.items()}
