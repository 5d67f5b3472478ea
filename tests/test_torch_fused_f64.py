"""The port's ``FusedExecutor`` in float64 against the reference's.

Both sweep modes, all four stencil bodies, against the reference
``FusedExecutor`` (under ``enable_x64``) and ``host_execute`` at the
reference's float64 tolerance.  Torch has native float64, so the port
needs no switch.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro import compat as ref_compat  # noqa: E402
from repro.core import edt as ref  # noqa: E402
from repro.core.poly import Tiling as RefTiling  # noqa: E402
from repro.core.programs import PROGRAMS as REF_PROGRAMS  # noqa: E402

from repro_torch.core import edt  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402
from repro_torch.kernels.stencils import (SPECS, default_state,  # noqa: E402
                                          handwritten_solve, reference_solve)

#: tests/test_fused_exec.py CASES and tolerances
CASES = [
    ("stencil1d", (2, 2), {"T": 6, "N": 15}),
    ("jacobi2d", (2, 2, 2), {"T": 5, "N": 11}),
    ("heat3d", (2, 2, 2, 2), {"T": 3, "N": 7}),
    ("seidel1d", (2, 3), {"T": 6, "N": 14}),
]
F64_TOL = dict(rtol=1e-12, atol=1e-13)


@pytest.mark.parametrize("name,tiles,params", CASES)
@pytest.mark.parametrize("mode", ["replay", "discover"])
def test_fused_matches_reference_f64(name, tiles, params, mode):
    rg = ref.TiledTaskGraph(REF_PROGRAMS[name](), {"S": RefTiling(tiles)},
                            backend="numpy")
    pg = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                            backend="numpy")
    rig, rsched = ref.synthesize_indexed(rg, params)
    pig, psched = edt.synthesize_indexed(pg, params)
    state = default_state(SPECS[name], params["N"], np.float64)
    with ref_compat.enable_x64():
        want = ref.FusedExecutor(
            rig, params, body=name, tile=tiles, state=state,
            schedule=rsched if mode == "replay" else None).run()
    got = edt.FusedExecutor(pig, params, body=name, tile=tiles, state=state,
                            schedule=psched if mode == "replay" else None,
                            device="cpu").run()
    assert got.final.dtype == torch.float64
    np.testing.assert_allclose(got.final.numpy(), want.final, **F64_TOL)
    host = edt.host_execute(SPECS[name], tiles, params["T"], params["N"],
                            edt.pack_origins(pig, tiles), psched.levels,
                            state)
    np.testing.assert_allclose(got.final.numpy(), host, **F64_TOL)
    np.testing.assert_allclose(
        handwritten_solve(SPECS[name], state, params["T"],
                          device="cpu").numpy(),
        reference_solve(SPECS[name], state, params["T"]), **F64_TOL)


def test_default_state_follows_dtype():
    """A float64 run seeds the float64 grid, not a widened float32 one."""
    name, tiles, params = CASES[0]
    g = edt.TiledTaskGraph(PROGRAMS[name](), {"S": Tiling(tiles)},
                           backend="numpy")
    run = edt.FusedExecutor(g, params, dtype=torch.float64,
                            device="cpu").run()
    want = reference_solve(SPECS[name], default_state(
        SPECS[name], params["N"], np.float64), params["T"])
    np.testing.assert_allclose(run.final.numpy(), want, **F64_TOL)
