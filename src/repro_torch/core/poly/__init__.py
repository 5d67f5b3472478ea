"""Exact polyhedral engine (paper §3): polyhedra, projection, compression."""
from .compression import (Tiling, compress, tile_dependence,
                          tile_dependence_projection, tile_domain)
from .counting import CountingFunction, dims_to_params, make_counting_function
from .linalg import diag, eye, frac, mat, mat_inv, mat_mul, vec
from .lp import LPResult, lp_feasible, lp_max, lp_min, lp_solve
from .polyhedron import Polyhedron
from .projection import minkowski_sum_box_exact, project_onto, project_out
from .scanning import (LoopNest, clear_scan_cache, scan_cache_info,
                       shard_polyhedron)

__all__ = [
    "Polyhedron", "Tiling", "LoopNest", "CountingFunction",
    "scan_cache_info", "clear_scan_cache", "shard_polyhedron",
    "compress", "tile_domain", "tile_dependence", "tile_dependence_projection",
    "project_out", "project_onto", "minkowski_sum_box_exact",
    "dims_to_params", "make_counting_function",
    "lp_solve", "lp_feasible", "lp_min", "lp_max", "LPResult",
    "frac", "vec", "mat", "eye", "diag", "mat_mul", "mat_inv",
]
