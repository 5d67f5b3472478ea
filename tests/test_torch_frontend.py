"""The port's front end against the reference: index graphs and levels.

The polyhedral front end, the index graph and the wavefront leveling of
``repro_torch`` are the port's own copies of the reference's NumPy
layers.  Built from the same program at the same sizes, every product
must be byte-identical: task blocks, edge columns, counters, levels.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import programs as ref_programs  # noqa: E402
from repro.core.edt import TiledTaskGraph as RefGraph  # noqa: E402
from repro.core.edt import synthesize_indexed as ref_synthesize  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402

from repro_torch.core import programs  # noqa: E402
from repro_torch.core.edt import (TiledTaskGraph,  # noqa: E402
                                  schedule_from_graph, synthesize_indexed)
from repro_torch.core.poly import Tiling  # noqa: E402

#: the four stencil bodies at the fused suite's sizes
#: (tests/test_fused_exec.py CASES), then two non-stencil programs
CASES = [
    ("stencil1d", (2, 2), {"T": 6, "N": 15}),
    ("jacobi2d", (2, 2, 2), {"T": 5, "N": 11}),
    ("heat3d", (2, 2, 2, 2), {"T": 3, "N": 7}),
    ("seidel1d", (2, 3), {"T": 6, "N": 14}),
    ("trisolv", (2, 2), {"N": 21}),
    ("cholesky_like", (2, 2, 2), {"N": 9}),
]


def _graphs(name, tiles, backend="numpy"):
    ref = RefGraph(ref_programs.PROGRAMS[name](), {"S": RefTiling(tiles)},
                   backend=backend)
    port = TiledTaskGraph(programs.PROGRAMS[name](), {"S": Tiling(tiles)},
                          backend=backend)
    return ref, port


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


@pytest.mark.parametrize("name,tiles,params", CASES)
def test_index_graph_and_levels_byte_identical(name, tiles, params):
    ref, port = _graphs(name, tiles)
    rig, rsched = ref_synthesize(ref, params)
    pig, psched = synthesize_indexed(port, params)
    assert pig.n == rig.n and pig.n_edges == rig.n_edges > 0
    for field in ("edge_src", "edge_tgt", "pred_n"):
        assert _same(getattr(pig, field), getattr(rig, field)), field
    assert [s for s, _ in pig.stmt_blocks] == [s for s, _ in rig.stmt_blocks]
    for (_, a), (_, b) in zip(pig.stmt_blocks, rig.stmt_blocks):
        assert _same(a, b)
    assert pig.dep_spans == rig.dep_spans
    assert psched.depth == rsched.depth
    for a, b in zip(psched.levels, rsched.levels):
        assert _same(a, b)
    assert _same(psched.level_of, rsched.level_of)
    assert psched.stats() == rsched.stats()
    assert _same(schedule_from_graph(pig).level_of, rsched.level_of)


@pytest.mark.parametrize("backend", ["compiled", "fraction"])
def test_scalar_backends_materialize_like_reference(backend):
    """The copied scalar scan paths: adjacency, counters and roots."""
    ref, port = _graphs("trisolv", (2, 2), backend=backend)
    params = {"N": 13}
    rg, pg = ref.materialize(params), port.materialize(params)
    assert pg.tasks == rg.tasks
    assert pg.succ == rg.succ and pg.pred_n == rg.pred_n
    assert list(port.roots(params)) == list(ref.roots(params))
    assert pg.wavefronts() == rg.wavefronts()
    t = pg.tasks[len(pg.tasks) // 2]
    assert list(port.successors(t, params)) == list(ref.successors(t, params))
    assert port.pred_count(t, params) == ref.pred_count(t, params)


def test_sharded_generation_is_not_ported():
    _, port = _graphs("trisolv", (2, 2))
    for call in (port.index_graph, port.materialize, port.roots):
        with pytest.raises(NotImplementedError, match="sharded"):
            call({"N": 9}, shards=2)
    with pytest.raises(NotImplementedError, match="sharded"):
        synthesize_indexed(port, {"N": 9}, shards=4)
    assert port.index_graph({"N": 9}, shards=1).n == \
        port.index_graph({"N": 9}).n
