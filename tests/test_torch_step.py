"""The wavefront step of the port against the reference's three versions.

``wavefront_step_torch`` (the plain torch version of the CUDA kernel, and
what the ``wavefront_step`` wrapper runs on CPU tensors) must equal the
reference's NumPy oracle ``decrement_reference`` and its Pallas kernel
``make_pallas_step`` (interpret mode on this CPU-only host) byte for byte,
on every frontier of a real sweep and on an edgeless graph.  The CUDA
kernel itself is held against the same plain version on the card by
``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax.numpy as jnp  # noqa: E402

from repro.core.edt import TiledTaskGraph as RefGraph  # noqa: E402
from repro.core.edt import synthesize_indexed as ref_synthesize  # noqa: E402
from repro.core.edt.device import decrement_reference as ref_decrement  # noqa: E402
from repro.core.edt.device import make_pallas_step  # noqa: E402
from repro.core.edt.device import pack_graph as ref_pack_graph  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402

from repro_torch.core.edt import IndexedGraph, pack_graph  # noqa: E402
from repro_torch.core.edt.device import (_check_step_args,  # noqa: E402
                                         decrement_reference, wavefront_step,
                                         wavefront_step_torch)


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _all_steps(indeg, frontier, dec_src, dec_ptr, pallas):
    """Every version of one step, as NumPy ``(indeg, newly)`` pairs."""
    args = (_t(indeg), _t(frontier), _t(dec_src), _t(dec_ptr))
    out = {
        "reference": ref_decrement(indeg, frontier, dec_src, dec_ptr),
        "port-numpy": decrement_reference(indeg, frontier, dec_src, dec_ptr),
        "plain": wavefront_step_torch(*args),
        "wrapper": wavefront_step(*args),
        "pallas": pallas(*(jnp.asarray(a) for a in
                           (indeg, frontier, dec_src, dec_ptr))),
    }
    return {k: (np.asarray(a), np.asarray(b)) for k, (a, b) in out.items()}


def test_plain_step_matches_reference_and_pallas_on_every_frontier():
    """The seidel1d sweep of the reference's own step test
    (tests/test_device_exec.py::test_pallas_step_matches_reference_and_xla)."""
    g = RefGraph(REF_PROGRAMS["seidel1d"](), {"S": RefTiling((2, 2))},
                 backend="numpy")
    ig, sched = ref_synthesize(g, {"T": 8, "N": 18})
    dg = ref_pack_graph(ig)
    pallas = make_pallas_step(dg.n, dg.n_edges, interpret=True)
    indeg = dg.pred_n.copy()
    frontier = indeg == 0
    for _ in range(sched.depth):
        got = _all_steps(indeg, frontier, dg.dec_src, dg.dec_ptr, pallas)
        want_indeg, want_newly = got.pop("reference")
        for name, (g_indeg, g_newly) in got.items():
            assert g_indeg.dtype == np.int32, name
            assert g_newly.dtype == np.bool_, name
            assert g_indeg.tobytes() == want_indeg.tobytes(), name
            assert g_newly.tobytes() == want_newly.tobytes(), name
        indeg, frontier = want_indeg, want_newly
    assert not frontier.any() and (indeg == 0).all()


def test_edgeless_step_returns_indeg_unchanged():
    n = 7
    dg = pack_graph(IndexedGraph(
        stmt_blocks=[("S", np.arange(n, dtype=np.int64)[:, None])], n=n,
        edge_src=np.zeros(0, np.int64), edge_tgt=np.zeros(0, np.int64),
        pred_n=np.zeros(n, np.int64)))
    pallas = make_pallas_step(n, 0, interpret=True)
    indeg = np.asarray([0, 1, 0, 2, 0, 0, 3], np.int32)
    for frontier in (indeg == 0, np.zeros(n, bool), np.ones(n, bool)):
        for name, (g_indeg, g_newly) in _all_steps(
                indeg, frontier, dg.dec_src, dg.dec_ptr, pallas).items():
            assert g_indeg.tobytes() == indeg.tobytes(), name
            assert not g_newly.any(), name


def test_step_argument_checks():
    """What the CUDA path checks before it hands pointers to the kernel."""
    n, e = 5, 4
    indeg = torch.zeros(n, dtype=torch.int32)
    frontier = torch.zeros(n, dtype=torch.bool)
    src = torch.zeros(e, dtype=torch.int32)
    ptr = torch.zeros(n + 1, dtype=torch.int32)
    assert _check_step_args(indeg, frontier, src, ptr) == n
    bad = {
        "indeg": (indeg.long(), frontier, src, ptr),
        "frontier": (indeg, frontier.to(torch.uint8), src, ptr),
        "dec_src": (indeg, frontier, src.long(), ptr),
        "dec_ptr": (indeg, frontier, src, ptr[:-1]),
    }
    for name, args in bad.items():
        with pytest.raises(ValueError, match=name):
            _check_step_args(*args)
    strided = torch.zeros(2 * e, dtype=torch.int32)[::2]
    with pytest.raises(ValueError, match="contiguous"):
        _check_step_args(indeg, frontier, strided, ptr)
    with pytest.raises(ValueError, match="cuda or cpu"):
        wavefront_step(*(t.to("meta") for t in (indeg, frontier, src, ptr)))
