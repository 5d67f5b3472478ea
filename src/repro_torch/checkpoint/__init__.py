"""Checkpointing with atomic manifests and async save.

The port of the reference package's ``checkpoint/__init__.py``, with the
same layout::

    <dir>/step_<N>/
        manifest.json          (written LAST -> step-atomic commit)
        arr_<i>.npy            one file per leaf

Leaves are numbered in the reference's flatten order (dict keys sorted,
a ``MomentState``'s fields in order with ``None`` dropped), so the same
state gives the same ``arr_<i>.npy`` files in both packages; the
manifest's ``treedef`` string and ``time`` are the port's own.  A
bfloat16 leaf is saved as its raw 2-byte words under the header
``'<V2'`` and the manifest dtype ``"bfloat16"``, the bytes the
reference's ``np.save`` writes; restoring one raises ``TypeError``, as the
reference's ``restore`` does (ROADMAP Queue 3).

Fault-tolerance contract:
  * a checkpoint is valid iff its manifest exists (crash mid-save leaves no
    manifest -> restart ignores the partial step);
  * ``latest_step`` scans for the newest valid manifest;
  * saves run asynchronously on the autodec runtime: the save task for step
    t depends on (a) step t's arrays being snapshotted and (b) the save of
    step t-1 having completed (a counted dependence chain), so saves never
    reorder and never block the training loop;
  * ``restore`` loads each leaf onto the target leaf's device (the
    reference's resharding has no counterpart on one card).
"""
from __future__ import annotations

import json
import shutil
import threading
import time
from pathlib import Path
from typing import Any, Optional

import numpy as np
import torch

from ..tree import leaves, rebuild

PyTree = Any
_BF16_WORDS = np.dtype("V2")      # a bfloat16 leaf's raw words on the host


def _treedef(tree: PyTree) -> str:
    if isinstance(tree, dict):
        return "{" + ", ".join(f"{k!r}: {_treedef(tree[k])}"
                               for k in sorted(tree)) + "}"
    if isinstance(tree, (tuple, list)):
        inner = ", ".join(_treedef(t) for t in tree)
        return f"{type(tree).__name__}({inner})"
    return "None" if tree is None else "*"


def _host(leaf) -> np.ndarray:
    """A host copy of ``leaf`` (never a view of a live tensor)."""
    if isinstance(leaf, np.ndarray):
        return leaf
    t = leaf.detach().to("cpu", copy=True)
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(_BF16_WORDS)
    return t.numpy()


def _dtype_name(arr: np.ndarray) -> str:
    return "bfloat16" if arr.dtype == _BF16_WORDS else str(arr.dtype)


def _save_npy(path: Path, arr: np.ndarray) -> None:
    if arr.dtype != _BF16_WORDS:
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = "<V2"            # what np.save writes for bfloat16
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        np.ascontiguousarray(arr).tofile(f)


def save_sync(ckpt_dir: str | Path, step: int, tree: PyTree) -> Path:
    d = Path(ckpt_dir) / f"step_{step:08d}"
    tmp = d.with_suffix(".tmp")
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    flat = leaves(tree)
    metas = []
    for i, leaf in enumerate(flat):
        arr = _host(leaf)
        _save_npy(tmp / f"arr_{i}.npy", arr)
        metas.append({"i": i, "shape": list(arr.shape),
                      "dtype": _dtype_name(arr)})
    manifest = {"step": step, "n_arrays": len(flat), "arrays": metas,
                "treedef": _treedef(tree), "time": time.time()}
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    if d.exists():
        shutil.rmtree(d)
    tmp.rename(d)   # manifest inside; rename is the atomic commit
    return d


def latest_step(ckpt_dir: str | Path) -> Optional[int]:
    d = Path(ckpt_dir)
    if not d.exists():
        return None
    steps = []
    for sub in d.glob("step_*"):
        if (sub / "manifest.json").exists():
            try:
                steps.append(int(sub.name.split("_")[1]))
            except ValueError:
                continue
    return max(steps) if steps else None


def restore(ckpt_dir: str | Path, step: int, target: PyTree) -> PyTree:
    """Load into the structure of ``target``, each leaf onto the device of
    the target's leaf, in the dtype the file holds."""
    d = Path(ckpt_dir) / f"step_{step:08d}"
    manifest = json.loads((d / "manifest.json").read_text())
    flat = leaves(target)
    assert manifest["n_arrays"] == len(flat), (
        f"checkpoint has {manifest['n_arrays']} leaves, target {len(flat)}")
    out = []
    for i, leaf in enumerate(flat):
        arr = np.load(d / f"arr_{i}.npy")
        want_shape = tuple(leaf.shape)
        assert tuple(arr.shape) == want_shape, (i, arr.shape, want_shape)
        if arr.dtype.kind == "V":
            raise TypeError(
                f"arr_{i}.npy holds a {manifest['arrays'][i]['dtype']} leaf "
                f"(dtype {arr.dtype} on load), which restore cannot rebuild; "
                f"the reference's restore raises the same TypeError "
                f"(ROADMAP Queue 3)")
        out.append(torch.from_numpy(arr).to(leaf.device))
    return rebuild(target, out)


class AsyncCheckpointer:
    """Autodec-scheduled async saves with a strict completion chain."""

    def __init__(self, ckpt_dir: str | Path, keep: int = 3):
        from ..core.edt.threaded import ThreadedAutodec
        self.dir = Path(ckpt_dir)
        self.keep = keep
        self._pending: dict[int, PyTree] = {}
        self._lock = threading.Lock()
        self.saved_steps: list[int] = []
        self._seq: list[int] = []      # submission order
        self._done: set[int] = set()
        self.rt = ThreadedAutodec(
            pred_count=lambda step: 2,   # snapshot ready + previous save done
            successors=self._succ,
            body=self._save,
            workers=1,
        )

    def _succ(self, step: int):
        # called after _save(step) returned; signal the next submitted save
        with self._lock:
            self._done.add(step)
            idx = self._seq.index(step)
            return [self._seq[idx + 1]] if idx + 1 < len(self._seq) else []

    def _save(self, step: int) -> None:
        with self._lock:
            tree = self._pending.pop(step)
        save_sync(self.dir, step, tree)
        self.saved_steps.append(step)
        self._gc()

    def _gc(self):
        steps = sorted(self.saved_steps)
        for s in steps[:-self.keep]:
            p = self.dir / f"step_{s:08d}"
            if p.exists():
                shutil.rmtree(p)
            self.saved_steps.remove(s)

    def submit(self, step: int, tree: PyTree) -> None:
        """Snapshot (a host copy of every leaf, so an in-place update after
        this call cannot reach it) and schedule the save."""
        snap = rebuild(tree, [_host(x) for x in leaves(tree)])
        with self._lock:
            self._pending[step] = snap
            prev = self._seq[-1] if self._seq else None
            self._seq.append(step)
            prev_done = prev is None or prev in self._done
        self.rt.autodec(step)          # dependence 1: snapshot ready
        if prev_done:
            # predecessor save already finished (or none): signal now; the
            # completion-side signal may double-fire, which autodec absorbs
            # (exactly-once scheduling is guaranteed by the scheduled-set).
            self.rt.autodec(step)
        return None

    def wait(self, timeout: float = 120) -> bool:
        return self.rt.wait(timeout)

    def close(self):
        self.wait()
        self.rt.shutdown()
