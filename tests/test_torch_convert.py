"""``repro_torch.convert.from_reference``: the reference's packed state,
carried across field for field, drives the port to the reference's result.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import edt as ref  # noqa: E402
from repro.core.edt import device as ref_device  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402
from repro.kernels.stencils import default_state  # noqa: E402
from repro.kernels.stencils import SPECS as REF_SPECS  # noqa: E402

from repro_torch import convert  # noqa: E402
from repro_torch.core import edt  # noqa: E402

NAME, TILES, PARAMS = "jacobi2d", (2, 2, 2), {"T": 5, "N": 11}


@pytest.fixture(scope="module")
def reference_packed():
    g = ref.TiledTaskGraph(REF_PROGRAMS[NAME](), {"S": RefTiling(TILES)},
                           backend="numpy")
    ig, sched = ref.synthesize_indexed(g, PARAMS)
    fo = ref.pack_origins(ig, TILES)
    return (ig, sched, ref_device.pack_graph(ig),
            ref_device.pack_schedule(ig, sched, origins=fo), fo,
            default_state(REF_SPECS[NAME], PARAMS["N"], np.float32))


def _same(a, b) -> bool:
    a, b = np.asarray(a), np.asarray(b)
    return a.dtype == b.dtype and a.shape == b.shape \
        and a.tobytes() == b.tobytes()


def test_round_trips_every_packed_field(reference_packed):
    _, _, rdg, rds, fo, state = reference_packed
    dg, ds, origins, grid = convert.from_reference(rdg, rds, fo, state,
                                                   device="cpu")
    assert isinstance(dg, edt.DeviceGraph) and isinstance(ds,
                                                          edt.DeviceSchedule)
    for f in dataclasses.fields(dg):
        a, b = getattr(dg, f.name), getattr(rdg, f.name)
        assert _same(a, b) if isinstance(b, np.ndarray) else a == b, f.name
    for f in dataclasses.fields(ds):
        a, b = getattr(ds, f.name), getattr(rds, f.name)
        if f.name == "levels":
            assert len(a) == len(b) and all(map(_same, a, b))
        elif isinstance(b, np.ndarray):
            assert _same(a, b), f.name
        else:
            assert a == b, f.name
    assert _same(origins, fo)
    assert grid.device.type == "cpu" and grid.dtype == torch.float32
    assert _same(grid.numpy(), state)
    # copies, not views of the reference's arrays
    assert not np.shares_memory(dg.dec_src, rdg.dec_src)


def test_converted_state_drives_port_to_reference_result(reference_packed):
    ig, sched, rdg, rds, fo, state = reference_packed
    dg, ds, origins, grid = convert.from_reference(rdg, rds, fo, state,
                                                   device="cpu")
    want = ref.FusedExecutor(ig, PARAMS, body=NAME, tile=TILES,
                             packed=(rdg, rds, fo), state=state).run()
    got = edt.FusedExecutor(ig, PARAMS, body=NAME, tile=TILES,
                            packed=(dg, ds, origins), state=grid,
                            device="cpu").run()
    np.testing.assert_allclose(got.final.numpy(), want.final,
                               rtol=1e-5, atol=1e-6)
    run = edt.DeviceExecutor(ig, packed=(dg, None), device="cpu").run()
    assert _same(run.level_of, sched.level_of)


def test_rejects_malformed_columns(reference_packed):
    _, _, rdg, rds, fo, _ = reference_packed
    wide = dataclasses.replace(rdg, dec_src=rdg.dec_src.astype(np.int64))
    with pytest.raises(ValueError, match="dec_src"):
        convert.from_reference(wide)
    short = dataclasses.replace(rds, task_ptr=rds.task_ptr[:-1])
    with pytest.raises(ValueError, match="task_ptr"):
        convert.from_reference(rdg, short)
    with pytest.raises(ValueError, match="origins"):
        convert.from_reference(rdg, origins=fo[:-1])
    dg, ds, origins, grid = convert.from_reference(rdg)
    assert ds is None and origins is None and grid is None
