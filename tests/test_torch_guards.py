"""What keeps the port a port: no JAX, no reference imports, no silent CPU.

* No file of ``src/repro_torch`` nor ``chip_smoke.py`` imports ``jax`` or
  the reference package ``repro`` (an AST scan), and importing the port
  loads neither (a fresh interpreter).
* The entry points run on CUDA unless the caller passes ``device="cpu"``:
  on a host without CUDA they raise instead of running on the CPU.
* The CUDA build refuses loudly without ``nvcc``.
"""
from __future__ import annotations

import ast
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

from repro_torch import compat, convert  # noqa: E402
from repro_torch.core import edt  # noqa: E402
from repro_torch.core.poly import Tiling  # noqa: E402
from repro_torch.core.programs import PROGRAMS  # noqa: E402
from repro_torch.kernels import build  # noqa: E402
from repro_torch.kernels.stencils import SPECS, handwritten_solve  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
PORT_FILES = sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
    ROOT / "chip_smoke.py"]
FORBIDDEN = ("jax", "jaxlib", "repro")


def _imported_roots(path: Path) -> set:
    roots = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            roots.update(a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            roots.add(node.module.split(".")[0])
    return roots


def test_port_files_import_no_jax_and_no_reference():
    assert len(PORT_FILES) > 20
    bad = {str(p.relative_to(ROOT)): sorted(_imported_roots(p)
                                            & set(FORBIDDEN))
           for p in PORT_FILES}
    assert {k: v for k, v in bad.items() if v} == {}


def test_importing_the_port_loads_no_jax_and_no_reference():
    code = (
        "import sys\n"
        "import repro_torch, repro_torch.convert, repro_torch.compat\n"
        "import repro_torch.core.edt, repro_torch.core.programs\n"
        "import repro_torch.kernels.build, repro_torch.kernels.stencils\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        f"{FORBIDDEN!r})\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run([sys.executable, "-c", code], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stdout + out.stderr


def _jacobi():
    g = edt.TiledTaskGraph(PROGRAMS["jacobi2d"](), {"S": Tiling((2, 2, 2))},
                           backend="numpy")
    return g, {"T": 3, "N": 6}


def test_default_device_raises_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g, params = _jacobi()
    ig = g.index_graph(params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compat.default_device()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        compat.default_device("cuda")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edt.DeviceExecutor(ig)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        edt.FusedExecutor(g, params)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        handwritten_solve(SPECS["jacobi2d"], np.zeros((6, 6), np.float32), 1)
    dg = edt.pack_graph(ig)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.from_reference(dg, state=np.zeros((6, 6), np.float32))
    # the CPU, asked for by name, runs
    assert compat.default_device("cpu") == torch.device("cpu")
    assert edt.DeviceExecutor(ig, device="cpu").run().counters.depth > 0


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    out = build.library_path("wavefront_step")
    assert out.parent == compat.build_dir()
    assert out.name.startswith("libwavefront_step-") and out.suffix == ".so"
    assert not out.exists()
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.compile_library("wavefront_step")
    assert compat.build_dir() == ROOT / "build" / "repro_torch"
