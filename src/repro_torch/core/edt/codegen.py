"""Emit the paper's generated-code forms (Figures 3, 4, 5) for inspection.

The *executable* counterparts live in ``taskgraph.py`` (iterators) and
``syncmodels.py`` (runtime behavior); this module renders the same polyhedra
as human-readable pseudo-C so examples and docs can show exactly what the
compiler "generates" for each synchronization model.  :func:`emit_fused`
renders the counted model's *fused* device form — counter sweep plus tile
body in one program — whose executable counterpart is
:class:`~.fused.FusedExecutor`.
"""
from __future__ import annotations

from ..poly import LoopNest
from ..poly.counting import dims_to_params
from .taskgraph import TiledTaskGraph


def _dep_loop(graph: TiledTaskGraph, td, fix: str) -> str:
    """Render the get ('src' fixed=target) or put ('tgt' fixed=source) loop."""
    ns = graph.tilings[td.dep.src].ndim
    if fix == "target":   # get loop: scan sources given my coords
        fixed = list(range(ns, td.delta_t.ndim))
    else:                 # put/autodec loop: scan targets given my coords
        fixed = list(range(ns))
    fam = dims_to_params(td.delta_t, fixed)
    return LoopNest(fam).pretty_loops()


def emit_prescribed(graph: TiledTaskGraph) -> str:
    """Fig 3: task-creation loops + declarative dependence loops."""
    out = ["// ---- prescribed model (Fig 3): master sets everything up ----"]
    for name, nest in graph.tile_nests.items():
        out.append(f"// create tasks of statement '{name}'")
        out.append(nest.pretty_loops().replace("body(", f"task_init({name!r}, "))
    for td in graph.tiled_deps:
        out.append(f"// declare dependences {td.dep.name}")
        out.append(LoopNest(td.delta_t).pretty_loops()
                   .replace("body(", "declare_dependence("))
    return "\n".join(out)


def emit_tags(graph: TiledTaskGraph, method: int = 2) -> str:
    """Fig 4: per-task gets on predecessors, puts for (self|successors)."""
    out = [f"// ---- tags model, Method {method} (Fig 4) ----"]
    for name in graph.program.statements:
        out.append(f"task {name}(iT...):")
        for td in graph._in[name]:
            out.append(f"  // gets on {td.dep.name}")
            for line in _dep_loop(graph, td, "target").splitlines()[:-1]:
                out.append("  " + line)
            out.append("    get(tag(src))" if method == 2
                       else "    get(tag(src, iT))")
        out.append("  compute(iT)")
        if method == 2:
            out.append("  put(tag(iT))")
        else:
            for td in graph._out[name]:
                out.append(f"  // puts on {td.dep.name}")
                for line in _dep_loop(graph, td, "source").splitlines()[:-1]:
                    out.append("  " + line)
                out.append("    put(tag(iT, tgt))")
    return "\n".join(out)


def emit_autodec(graph: TiledTaskGraph) -> str:
    """Fig 5: pred-count function + autodec loop; master preschedules roots."""
    out = ["// ---- autodec model (Fig 5) ----"]
    strategies = graph.pred_count_strategies()
    for name in graph.program.statements:
        out.append(f"int pred_count_{name}(iT...):  // §4.3")
        for td in graph._in[name]:
            strat = strategies[td.dep.name]
            out.append(f"  // {td.dep.name}: strategy = {strat}")
            if strat == "enumerator":
                out.append("  n += closed_form(iT)   // O(dims) evaluation")
            else:
                for line in _dep_loop(graph, td, "target").splitlines()[:-1]:
                    out.append("  " + line)
                out.append("    n++;")
        out.append("  return n;")
    for name in graph.program.statements:
        out.append(f"task {name}(iT...):")
        out.append("  compute(iT)")
        for td in graph._out[name]:
            out.append(f"  // autodec successors via {td.dep.name}")
            for line in _dep_loop(graph, td, "source").splitlines()[:-1]:
                out.append("  " + line)
            out.append(f"    autodec(tgt, pred_count_{td.dep.tgt})")
    out.append("// master: preschedule(t) for all t — O(1) sequential start-up")
    return "\n".join(out)


def emit_fused(graph: TiledTaskGraph, body: str = None) -> str:
    """The fused counted-sync device sweep: decrement + tile body, one loop.

    Pseudo-code for what :class:`~.fused.FusedExecutor`
    compiles — the level loop of the replay sweep with the stencil body
    (``repro_torch.kernels.stencils.SPECS``) inlined between the validation
    gathers and the counter decrement.  ``body`` defaults to the program's
    registered name.
    """
    from ...kernels.stencils import SPECS
    name = body or getattr(graph.program, "name", "")
    if name not in SPECS:
        raise ValueError(f"no stencil body registered for {name!r}; "
                        f"known: {sorted(SPECS)}")
    spec = SPECS[name]
    (tiling,) = graph.tilings.values()
    tile = tiling.sizes
    seq = [f"l{k}" for k in range(spec.space) if spec.seq_space[k]]
    par = [f"l{k}" for k in range(spec.space) if not spec.seq_space[k]]
    out = [f"// ---- fused counted model: device sweep + {name} body ----",
           f"// state: u[2*S+1]  (S = N^{spec.space} sites; parity buffers "
           "p = t & 1,",
           "//         slot 2S = zero halo; masked writes drop) — "
           "docs/device_exec.md",
           "for level in range(depth):                   // one fori_loop, "
           "never host",
           "  ids  = order[task_ptr[level] : +w_pad]     // fixed-width "
           "slice, sentinel-padded",
           "  chk  = indeg[ids] != 0 if lane < width     // validation (a): "
           "not ready",
           "  chk += indeg[next_ids] == 0                // validation (b): "
           "early ready",
           "  org  = origin[ids]                         // tile origins "
           "(t0, x0...)"]
    steps = " * ".join(str(g) for g in tile)
    out.append(f"  // tile body: {steps} points/tile, taps={len(spec.taps)}"
               f" (dt,off,w), seq dims: t{',' if seq else ''}{','.join(seq)}")
    out.append(f"  for tt in range({tile[0]}):"
               "                        // local time: sequential")
    ind = "    "
    for d in seq:
        out.append(f"{ind}for {d} in range(g):                     "
                   "// Gauss-Seidel dim: sequential")
        ind += "  "
    if par:
        out.append(f"{ind}vmap over ({', '.join(par)}):               "
                   "// parallel spatial lanes")
        ind += "  "
    out.append(f"{ind}t, s = org.t + tt, org.x + l - t        "
               "// unskew: site = x - t")
    out.append(f"{ind}mask = 0 <= t < T and s in [0, N)^d     "
               "// = domain membership")
    for dt, off, w in spec.taps:
        buf = "p" if dt == 0 else "1-p"
        out.append(f"{ind}acc += {w:g} * u[{buf}, s + {off}]"
                   f"{'':<{max(1, 14 - 3 * len(off))}}// dt={dt}, halo reads 0")
    out.append(f"{ind}u[p, s] = acc if mask                   "
               "// distinct slots per level (proof: fused.py)")
    out += ["  // counted-sync decrement: this level's out-edges, one "
            "contiguous slice",
            "  tgts = lvl_tgt[edge_ptr[level] : +e_pad]",
            "  indeg[tgts] -= 1                           // scatter-add, "
            "slot n swallows pads",
            "chk += sum(indeg != 0)                       // validation (c): "
            "undrained",
            "// chk == 0 proves the schedule IS the counted-model execution"]
    return "\n".join(out)
