"""``repro_torch.kernels.build``: a kernel's library follows its sources.

Each ``csrc/<name>.cu`` is built alone into a library whose file name
carries a hash of what it is built from: the source and every shared
header ``csrc/*.cuh`` it may include, and the macros it is built with.
An edit to a header must move the library path, or a stale library would
be loaded.  Nothing here calls ``nvcc``.
"""
from __future__ import annotations

import shutil
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro_torch.kernels import build  # noqa: E402

KERNELS = ("wavefront_step", "flash_attention", "wkv6", "ssd")
ROOT = Path(__file__).resolve().parents[1]


@pytest.fixture
def csrc(monkeypatch, tmp_path):
    """A copy of ``csrc`` that ``build`` reads instead of the real one."""
    for src in build.CSRC.iterdir():
        shutil.copy(src, tmp_path / src.name)
    monkeypatch.setattr(build, "CSRC", tmp_path)
    return tmp_path


def test_a_header_edit_moves_every_library_path(csrc):
    before = {n: build.library_path(n) for n in KERNELS}
    assert len(set(before.values())) == len(KERNELS)
    header = csrc / "mma_tf32x3.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in KERNELS}
    assert all(after[n] != before[n] for n in KERNELS)
    assert all(not p.exists() for p in after.values())


def test_a_source_edit_moves_only_its_own_library_path(csrc):
    before = {n: build.library_path(n) for n in KERNELS}
    src = csrc / "ssd.cu"
    src.write_text(src.read_text() + "\n// edited\n")
    after = {n: build.library_path(n) for n in KERNELS}
    assert after["ssd"] != before["ssd"]
    assert all(after[n] == before[n] for n in KERNELS if n != "ssd")


def test_a_new_header_counts_too(csrc):
    before = build.library_path("flash_attention")
    (csrc / "extra.cuh").write_text("#pragma once\n")
    assert build.library_path("flash_attention") != before


def test_the_kernels_include_the_shared_header_from_csrc():
    i = build.NVCC_FLAGS.index("-I")
    assert build.NVCC_FLAGS[i + 1] == str(build.CSRC)
    for name in ("ssd", "flash_attention"):
        text = (build.CSRC / f"{name}.cu").read_text()
        assert '#include "mma_tf32x3.cuh"' in text


def test_macros_move_the_library_path_and_reach_nvcc(monkeypatch):
    plain = build.library_path("ssd")
    ablated = build.library_path("ssd", ("REPRO_ABLATE_PRODUCTS",))
    assert ablated != plain and ablated.parent == plain.parent
    seen = []

    def run(cmd, **kwargs):
        seen.append(cmd)
        return subprocess.CompletedProcess(cmd, 1, "", "stub")

    monkeypatch.setattr(build, "nvcc", lambda: "nvcc")
    monkeypatch.setattr(build.subprocess, "run", run)
    with pytest.raises(RuntimeError, match="nvcc failed"):
        build.compile_library("ssd", ("REPRO_ABLATE_PRODUCTS",))
    assert "-DREPRO_ABLATE_PRODUCTS" in seen[0]
    assert not ablated.exists()


def test_every_ablation_macro_is_read_by_the_kernels():
    """``chip_smoke.py --ablation`` builds with these macros: a macro that
    no source reads would time the kernels as built under another name."""
    sys.path.insert(0, str(ROOT))
    try:
        import chip_smoke
    finally:
        sys.path.remove(str(ROOT))
    text = "".join(p.read_text() for p in build.CSRC.glob("*.cu*"))
    macros = {m for ds in chip_smoke.ABLATIONS.values() for m in ds}
    assert macros
    for macro in macros:
        assert f"#ifdef {macro}\n" in text, macro
