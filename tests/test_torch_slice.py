"""The port's main path end to end against the reference's, on the CPU.

Program -> index graph -> wavefront schedule -> counted-sync sweeps ->
fused stencil tiles, through the entry points a user calls, in both
packages from the same program and the same seeded grid: every integer
result byte for byte, every grid within the reference's tolerance.  The
same path runs at 1,056,784 tasks on the card in ``chip_smoke.py``.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro.core import edt as ref  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402
from repro_torch.kernels.stencils import (SPECS, handwritten_solve,  # noqa: E402
                                          reference_solve)

#: the slice's program and tiles at a CPU size (chip_smoke.py: T=32 N=512)
NAME, TILES = "jacobi2d", (2, 2, 2)


@pytest.mark.parametrize("params", [{"T": 8, "N": 24}, {"T": 7, "N": 17}])
def test_main_path_matches_reference(params):
    rg = ref.TiledTaskGraph(REF_PROGRAMS[NAME](), {"S": RefTiling(TILES)},
                            backend="numpy")
    pg = edt.TiledTaskGraph(PROGRAMS[NAME](), {"S": Tiling(TILES)},
                            backend="numpy")
    rig, rsched = ref.synthesize_indexed(rg, params)
    pig, psched = edt.synthesize_indexed(pg, params)
    assert pig.edge_src.tobytes() == rig.edge_src.tobytes()
    assert psched.level_of.tobytes() == rsched.level_of.tobytes()

    for sched_p, sched_r in ((None, None), (psched, rsched)):
        got = edt.DeviceExecutor(pig, schedule=sched_p, device="cpu").run()
        want = ref.DeviceExecutor(rig, schedule=sched_r).run()
        assert got.level_of.tobytes() == want.level_of.tobytes()
        assert got.counters.summary() == want.counters.summary()

    rng = np.random.default_rng(12)
    state = rng.random((params["N"],) * 2).astype(np.float32)
    hand = handwritten_solve(SPECS[NAME], state, params["T"], device="cpu")
    sol = reference_solve(SPECS[NAME], state, params["T"])
    np.testing.assert_allclose(hand.numpy(), sol, rtol=1e-5, atol=1e-6)
    for sched_p, sched_r in ((psched, rsched), (None, None)):
        got = edt.FusedExecutor(pg, params, schedule=sched_p, state=state,
                                device="cpu").run()
        want = ref.FusedExecutor(rg, params, schedule=sched_r,
                                 state=state).run()
        assert got.level_of.tobytes() == want.level_of.tobytes()
        np.testing.assert_allclose(got.final.numpy(), want.final,
                                   rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(got.final.numpy(), sol,
                                   rtol=1e-5, atol=1e-6)
