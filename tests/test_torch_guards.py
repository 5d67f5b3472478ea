"""What keeps the port a port: no JAX, no reference imports, no silent CPU.

* No file of ``src/repro_torch`` nor ``chip_smoke.py`` imports ``jax`` or
  the reference package ``repro`` (an AST scan), and importing the port
  loads neither (a fresh interpreter).
* The entry points run on CUDA unless the caller passes ``device="cpu"``:
  on a host without CUDA they raise instead of running on the CPU
  (serving and training alike: ``init_all``, ``SyntheticLM``, the
  ``TrainDriver`` through its ``init_fn``, ``launch.train.main``; the
  meshes and ``run_ranks`` of the parallel slice, whose production mesh
  refuses a world of another size).
* The kernel wrappers run their plain versions only for CPU tensors: any
  other tensor launches the kernel or raises, never falls back.
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
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd as sd  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.kernels.stencils import SPECS, handwritten_solve  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch import mesh as mesh_mod  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import init_all, make_train_step  # noqa: E402
from repro_torch.optim import AdamWConfig, init_state  # noqa: E402
from repro_torch.runtime import DriverConfig, TrainDriver  # noqa: E402
from repro_torch.models import build_model, hybrid, rwkv, transformer  # noqa: E402

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
        "import repro_torch.kernels.ops, repro_torch.kernels.ref\n"
        "import repro_torch.kernels.ssd, repro_torch.models.hybrid\n"
        "import repro_torch.models, repro_torch.configs\n"
        "import repro_torch.launch.serve, repro_torch.launch.steps\n"
        "import repro_torch.launch.edt_serve, repro_torch.launch.train\n"
        "import repro_torch.optim, repro_torch.data, repro_torch.checkpoint\n"
        "import repro_torch.runtime, repro_torch.tree\n"
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
        edt.run_distributed(ig, engine="device")
    with edt.Session(edt.ExecutionConfig(backend="numpy")) as session:
        for replay in (True, False):
            with pytest.raises(RuntimeError, match="CUDA is not available"):
                session.executor(g, params, replay=replay)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            session.fused_executor(g, params)
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            session.distributed(g, params, engine="device")
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        handwritten_solve(SPECS["jacobi2d"], np.zeros((6, 6), np.float32), 1)
    dg = edt.pack_graph(ig)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.from_reference(dg, state=np.zeros((6, 6), np.float32))
    # the CPU, asked for by name, runs
    assert compat.default_device("cpu") == torch.device("cpu")
    assert edt.DeviceExecutor(ig, device="cpu").run().counters.depth > 0
    assert edt.run_distributed(ig, engine="device", device="cpu").depth > 0


@pytest.mark.parametrize("name,family", [
    ("llama3.2-1b", transformer), ("rwkv6-1.6b", rwkv),
    ("zamba2-7b", hybrid), ("internvl2-26b", transformer)])
def test_model_entry_points_raise_without_cuda(monkeypatch, tmp_path, name,
                                              family):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(name).smoke_config()
    m = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        family.init_params(cfg, gen, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.init(gen, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        m.init_cache(2, 16, torch.float32)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve(cfg, batch=2, prompt_len=8, gen=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        convert.params_from_reference({}, cfg)
    # the training entry points
    opt = AdamWConfig()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        init_all(m, opt, gen, torch.float32)
    dcfg = DataConfig(vocab=cfg.vocab, seq_len=8, global_batch=2)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        SyntheticLM(dcfg)

    def init_fn():
        params = m.init(gen, torch.float32)
        return params, init_state(opt, params)

    drv = TrainDriver(DriverConfig(total_steps=1, ckpt_dir=str(tmp_path),
                                   max_restarts=0), dcfg,
                      make_train_step(m, opt), init_fn)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        drv.run()
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train.main(["--arch", name, "--width", "tiny", "--steps", "1",
                    "--ckpt-dir", str(tmp_path)])
    # the CPU, asked for by name, runs
    res = serve(cfg, batch=2, prompt_len=8, gen=2, device="cpu")
    assert tuple(res.tokens.shape) == (2, 2)
    params, state = init_all(m, opt, gen, torch.float32, device="cpu")
    batch = SyntheticLM(dcfg, device="cpu").batch_at(0)
    _, _, loss = make_train_step(m, opt)(params, state, batch)
    assert bool(torch.isfinite(loss)) and int(state["step"]) == 1


def _refuse(*args, **kwargs):
    raise AssertionError("a plain version was reached")


def _never(device):
    raise AssertionError("a rank ran without CUDA")


def test_meshes_and_run_ranks_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for make in (mesh_mod.make_debug_mesh, mesh_mod.make_production_mesh,
                 lambda **kw: mesh_mod.Mesh((1,), ("stage",), **kw),
                 lambda **kw: mesh_mod.run_ranks(_never, 2, **kw)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make(device="cuda")
    one = mesh_mod.make_debug_mesh(device="cpu")
    assert (one.shape, one.size, one.coords) == (
        {"data": 1, "model": 1}, 1, {"data": 0, "model": 0})
    with pytest.raises(ValueError, match="needs 4 ranks; the world has 1"):
        mesh_mod.make_debug_mesh(2, 2, device="cpu")


@pytest.mark.parametrize("multi_pod,n", [(False, 256), (True, 512)])
def test_production_mesh_refuses_a_world_of_four(monkeypatch, multi_pod, n):
    monkeypatch.setattr(mesh_mod, "_world", lambda: (4, 0))
    with pytest.raises(ValueError, match=f"needs {n} ranks; the world has "
                                         f"4"):
        mesh_mod.make_production_mesh(multi_pod=multi_pod, device="cpu")


def test_kernel_wrappers_take_the_plain_version_only_for_cpu_tensors(
        monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(fa, "flash_attention_hm_torch", _refuse)
    monkeypatch.setattr(wk, "wkv6_torch", _refuse)
    monkeypatch.setattr(sd, "ssd_torch", _refuse)
    q = torch.zeros((1, 2, 128, 64), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        fa.flash_attention_hm(q, q, q)
    x = torch.zeros((1, 64, 2, 16), device="meta")
    with pytest.raises(ValueError, match="cuda or cpu"):
        wk.wkv6(x, x, x, x, torch.zeros((2, 16), device="meta"))
    xs, dt, A, bm = (torch.zeros(s, device="meta") for s in (
        (1, 64, 2, 16), (1, 64, 2), (2,), (1, 64, 8)))
    with pytest.raises(ValueError, match="cuda or cpu"):
        sd.ssd(xs, dt, A, bm, bm)
    # CPU tensors take the plain versions (here refused, so they raise)
    with pytest.raises(AssertionError, match="plain version"):
        fa.flash_attention_hm(*(torch.zeros((1, 2, 128, 64)),) * 3)
    with pytest.raises(AssertionError, match="plain version"):
        wk.wkv6(*(torch.zeros((1, 64, 2, 16)),) * 4, torch.zeros((2, 16)))
    with pytest.raises(AssertionError, match="plain version"):
        sd.ssd(torch.zeros((1, 64, 2, 16)), torch.zeros((1, 64, 2)),
               torch.zeros((2,)), *(torch.zeros((1, 64, 8)),) * 2)
    assert fa.flash_attention_hm.launches == 0 and wk.wkv6.launches == 0
    assert sd.ssd.launches == 0


def test_build_refuses_without_nvcc(monkeypatch, tmp_path):
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        build.nvcc()
    for name in ("wavefront_step", "flash_attention", "wkv6", "ssd"):
        out = build.library_path(name)
        assert out.parent == compat.build_dir()
        assert out.name.startswith(f"lib{name}-") and out.suffix == ".so"
        assert not out.exists()
        with pytest.raises(RuntimeError, match="nvcc not found"):
            build.compile_library(name)
    assert compat.build_dir() == ROOT / "build" / "repro_torch"
