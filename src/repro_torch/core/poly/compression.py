"""The paper's §3: scalable inter-tile dependence computation by compression.

Given a pre-tiling dependence polyhedron ``Δ(I_s, I_t)`` and diagonal tiling
matrices ``G_s, G_t``:

    T = G^{-1} I - G^{-1} X,     0 <= X <= diag(G) - 1            (eqs 1-3)
    U = { -G^{-1} X }            (a hyper-rectangle, eq 4)
    Δ_T = image(Δ, G_{s,t}^{-1}) ⊕ U_{s,t}                        (eq 8)

The image under the invertible compression is a plain constraint rewrite
(no projection!), and the direct sum with the box ``U`` is either computed
exactly (validation oracle) or via the §3.1 *inflation* over-approximation,
which shifts each constraint outward by ``c_max(a)`` and adds no vertices.

``tile_dependence_projection`` implements the prior-art baseline the paper
benchmarks against: lift to ``(T_s, X_s, T_t, X_t)`` and Fourier-Motzkin the
``X`` dims away.
"""
from __future__ import annotations

from dataclasses import dataclass
from fractions import Fraction
from typing import Sequence

from .linalg import Mat, Row, diag, frac, vec
from .polyhedron import Polyhedron
from .projection import minkowski_sum_box_exact, project_out

F0 = Fraction(0)
F1 = Fraction(1)


@dataclass(frozen=True)
class Tiling:
    """Orthogonal tiling: diagonal G with positive integer tile sizes."""
    sizes: tuple[int, ...]

    def __post_init__(self):
        assert all(isinstance(s, int) and s >= 1 for s in self.sizes), self.sizes

    @property
    def ndim(self) -> int:
        return len(self.sizes)

    def G(self) -> Mat:
        return diag([frac(s) for s in self.sizes])

    def u_box(self) -> tuple[Row, Row]:
        """The hyper-rectangle U = [-(g-1)/g, 0]^n of eq (4)."""
        lo = vec([Fraction(-(g - 1), g) for g in self.sizes])
        hi = vec([F0] * self.ndim)
        return lo, hi


def compress(domain: Polyhedron, tiling: Tiling,
             tile_dim_names: Sequence[str] | None = None) -> Polyhedron:
    """``image(D, G^{-1})`` — substitute I = G·T. Exact; no projection."""
    assert tiling.ndim == domain.ndim
    names = tuple(tile_dim_names or (f"{n}_T" for n in domain.dim_names))
    G = tiling.G()
    t0 = vec([0] * domain.ndim)
    return domain.preimage_affine(G, t0, names)


def tile_domain(domain: Polyhedron, tiling: Tiling, method: str = "inflate",
                tile_dim_names: Sequence[str] | None = None) -> Polyhedron:
    """Set of tile indices T whose tile contains a point of ``domain`` (eq 6).

    method: 'inflate' (production, §3.1 over-approximation — exact for the
    tilings used in practice because tile-domain constraints are integer
    translates) or 'exact' (direct-sum oracle via lifted projection).
    """
    P = compress(domain, tiling, tile_dim_names)
    lo, hi = tiling.u_box()
    if method == "inflate":
        return P.inflate_box(lo, hi)
    if method == "exact":
        return minkowski_sum_box_exact(P, lo, hi)
    raise ValueError(method)


def _combined(delta: Polyhedron, src_ndim: int, gs: Tiling, gt: Tiling) -> Tiling:
    assert delta.ndim == src_ndim + gt.ndim, (
        f"dependence has {delta.ndim} dims != {src_ndim}+{gt.ndim}")
    assert gs.ndim == src_ndim
    return Tiling(gs.sizes + gt.sizes)


def tile_dependence(delta: Polyhedron, src_ndim: int, gs: Tiling, gt: Tiling,
                    method: str = "inflate",
                    tile_dim_names: Sequence[str] | None = None) -> Polyhedron:
    """Paper eq (8): ``Δ_T = image(Δ, G_{s,t}^{-1}) ⊕ U_{s,t}``.

    ``delta`` lives in the Cartesian product of source and target iteration
    spaces (first ``src_ndim`` dims are the source's).
    """
    gst = _combined(delta, src_ndim, gs, gt)
    return tile_domain(delta, gst, method=method, tile_dim_names=tile_dim_names)


def tile_dependence_projection(delta: Polyhedron, src_ndim: int,
                               gs: Tiling, gt: Tiling,
                               simplify: str = "auto",
                               tile_dim_names: Sequence[str] | None = None
                               ) -> Polyhedron:
    """Prior-art baseline [2, 9, 14]: lift to (T, X) and project out X.

    Builds the 2(n_s+n_t)-dimensional system
        Δ(G_s T_s + X_s, G_t T_t + X_t),  0 <= X <= diag(G) - 1
    and eliminates all X dims with Fourier-Motzkin.  Worst-case cost is
    doubly exponential in the eliminated dims — the tractability problem
    §3 removes.
    """
    gst = _combined(delta, src_ndim, gs, gt)
    n = delta.ndim
    tnames = tuple(tile_dim_names or (f"{d}_T" for d in delta.dim_names))
    xnames = tuple(f"{d}_X" for d in delta.dim_names)

    # Map (T..., X...) -> I = G T + X : matrix [G | I_n], zero offset.
    G = gst.G()
    M = tuple(tuple(G[i][j] for j in range(n)) +
              tuple(F1 if i == j else F0 for j in range(n))
              for i in range(n))
    t0 = vec([0] * n)
    lifted = delta.preimage_affine(M, t0, tnames + xnames)

    xbox = Polyhedron.box(xnames,
                          [0] * n, [g - 1 for g in gst.sizes],
                          delta.param_names).add_dims(tnames, front=True)
    sys = lifted.intersect(xbox)
    return project_out(sys, list(range(n, 2 * n)), simplify=simplify)
