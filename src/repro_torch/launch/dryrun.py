"""Dry run: size every (arch x shape x mesh) cell of the port on ``meta``.

The port of the reference package's ``launch/dryrun.py``.  The reference
lowers and compiles each cell's jitted step under a mesh of 512 host
placeholder devices and reads XLA's memory and cost analyses.  The port
has no compiler: it builds each cell's step with its parameters,
optimizer state, inputs and caches on ``torch.device("meta")`` (shapes,
no storage) and walks it once under :func:`.op_cost.op_cost`, which
counts the FLOPs, bytes, launches, collectives and live-storage peak of
every op the step dispatches on rank 0.  Nothing touches a card: this is
the one entry point of the port that does not run on CUDA by default,
because it computes shapes and counts, never a time.

The meshes ``pod16x16`` (data, model) and ``pod2x16x16`` (pod, data,
model) are :class:`DryMesh` stand-ins: their shape, axis names, size,
rank 0's coordinates and dry axis groups
(:data:`repro_torch.parallel.collectives.DRY`).  There is no process
group, so no 256 or 512 ranks are started: a collective over a dry group
records its operand bytes and returns a ``meta`` tensor of its result.

Serving cells walk ``attn_impl="cuda"``, the route the card runs (each
hand-written kernel one op, recorded by its wrapper with its formula);
train cells walk ``"xla"``, as training does.  A train cell walks rank
0's step under the mesh: its block of the global batch, the forward and
backward (the expert-parallel region's all-to-alls and gathers both
ways) and the data-parallel gradient exchange, recorded under
``all-reduce``.

Each record, ``artifacts/dryrun_torch/<arch>__<shape>__<mesh>.json``,
keeps the reference's keys where they have a counterpart (``status``,
``n_devices``, ``n_params``, ``n_active_params``, ``build_s``,
``memory``, ``cost``, ``collectives``) and adds ``walk_s`` and
``op_cost`` (the counter's whole dict).  ``memory.by_specs`` holds the
per-rank bytes of the params, optimizer state, batch and caches that
``parallel.sharding``'s rules assign: the number comparable to the
reference's sharded ``argument_size_in_bytes``.  ``memory.argument_bytes``
is what the port holds on a rank: the global batch, of which a step
computes on its block, and the params: a serving cell's as
``parallel.sharding.held_params`` cuts them (the decoder family's
attention, MLP, shared expert and vocabulary over 'model', its routed
expert stacks over their expert axes, whether the einsum or the
expert-parallel form runs them), a train cell's whole but for the expert
slices of its expert-parallel region; a decode cell's caches are the
rank's block (``sharding.cache_block``: its rows and the kv heads its
attention reads, where ``cache_specs_tree`` cuts the head dim when
'model' does not divide the kv heads).  What remains between the two is
the train step's tensor parallelism and ZeRO, MLA attention and the
other families' tensor parallelism, which the port does not run
(ROADMAP.md, Queue 1).  A serving cell records the row-parallel sums and
the MoE layers' combines under ``all-reduce``, and the logits' gathers
and the MoE layers' token gathers under ``all-gather``.

Usage:
  python -m repro_torch.launch.dryrun --arch llama3.2-1b --shape prefill_32k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--single-pod]
"""
from __future__ import annotations

import argparse
import json
import time
import traceback
from pathlib import Path

import numpy as np
import torch

from ..configs import (REGISTRY, SHAPES, applicable, cache_specs, get_config,
                       input_specs)
from ..models import ParallelCtx, build_model
from ..models.transformer import ep_axis_for
from ..optim import AdamWConfig, init_state
from ..parallel.collectives import DRY, AxisGroup
from ..parallel.sharding import (P, _axis_size, batch_specs, cache_block,
                                 cache_specs_tree, dp_axes, held_params,
                                 held_shape, opt_state_specs, param_specs)
from .op_cost import op_cost
from .steps import make_decode_step, make_prefill_step, make_train_step

ART = Path(__file__).resolve().parents[3] / "artifacts" / "dryrun_torch"

#: f32 moments fit when params x 10 B a rank stays under this: 0.75 of an
#: H100's 80 GB (the reference's rule, with the card's budget for the
#: TPU's 16 GB)
MOMENT_BUDGET = 0.75 * 80e9


class DryMesh:
    """A stand-in for :class:`repro_torch.launch.mesh.Mesh` as rank 0 sees
    it, with no process group: ``shape``, ``axis_names``, ``size``,
    ``coords`` (all 0) and :meth:`group`, whose groups are dry."""

    def __init__(self, shape, axis_names):
        dims = tuple(int(n) for n in shape)
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, dims))
        self.size = int(np.prod(dims))
        self.coords = dict.fromkeys(self.axis_names, 0)
        self._grid = np.arange(self.size).reshape(dims)

    def group(self, axis) -> AxisGroup:
        """Rank 0's :class:`AxisGroup` of ``axis`` (a name, or a tuple of
        names in mesh order): a dry process group when it spans more than
        one rank, none otherwise."""
        key = tuple(axis) if isinstance(axis, (tuple, list)) else (axis,)
        order = [self.axis_names.index(a) for a in key
                 if a in self.axis_names]
        if len(order) != len(key) or order != sorted(set(order)):
            raise KeyError(f"no axis {axis!r} in a mesh of "
                           f"{self.axis_names} (a tuple names its axes in "
                           f"mesh order)")
        ranks = self._grid[tuple(slice(None) if a in key else 0
                                 for a in self.axis_names)].reshape(-1)
        width = len(ranks)
        return AxisGroup(key if len(key) > 1 else key[0], width, 0,
                         tuple(int(r) for r in ranks),
                         DRY if width > 1 else None, False)


def make_dry_mesh(multi_pod: bool = False) -> DryMesh:
    """The production meshes' stand-ins: 16 x 16 (data, model), or 2 x 16
    x 16 (pod, data, model) with ``multi_pod``."""
    if multi_pod:
        return DryMesh((2, 16, 16), ("pod", "data", "model"))
    return DryMesh((16, 16), ("data", "model"))


def spec_bytes(tree, specs, mesh) -> int:
    """The bytes of ``tree``'s tensors a rank holds under ``specs`` (a
    tree of :class:`P` shaped like it): each sharded dim cut by its axes'
    size (the rules only shard dims those sizes divide)."""
    if isinstance(specs, P):
        if not isinstance(tree, torch.Tensor):
            return 0                    # a host integer (a cache's len)
        return tree.element_size() * int(np.prod(held_shape(
            tree.shape, specs, mesh)))
    if isinstance(tree, dict):
        return sum(spec_bytes(tree[k], specs[k], mesh) for k in tree)
    if isinstance(tree, (tuple, list)):
        return sum(spec_bytes(t, s, mesh) for t, s in zip(tree, specs))
    return 0


def _cut_experts(params, ep_size: int):
    """``params`` with each MoE stack's routed expert leaves ``[L, E,
    ...]`` replaced by this rank's ``[L, E / ep_size, ...]``, as a train
    step's expert-parallel region holds them."""
    moe = params["moe_layers"]["moe"]
    cut = {name: torch.empty((w.shape[0], w.shape[1] // ep_size)
                             + tuple(w.shape[2:]), dtype=w.dtype,
                             device=w.device)
           if name in ("wg", "wu", "wd") else w
           for name, w in moe.items()}
    return {**params, "moe_layers": {**params["moe_layers"], "moe": cut}}


def build_cell(arch: str, shape: str, mesh, *, opt_bits: int = 0,
               extra_cfg: dict | None = None, microbatches: int = 1):
    """``(cfg, step, args, by_specs)`` for the cell: the step on the
    card's route and its arguments on ``meta``, ready to walk, and the
    per-rank bytes the sharding rules assign (params, opt_state, batch,
    caches and their total).

    opt_bits=0 means auto: 8-bit moment states when f32 states would not
    fit :data:`MOMENT_BUDGET` (params x 10 B / ranks), else f32.
    """
    cfg = get_config(arch)
    if extra_cfg:
        cfg = cfg.replace(**extra_cfg)
    if opt_bits == 0:
        opt_bits = 8 if cfg.n_params() * 10 / mesh.size > MOMENT_BUDGET \
            else 32
    sspec = SHAPES[shape]
    train = sspec.kind == "train"
    cfg = cfg.replace(attn_impl="xla" if train else "cuda")
    model = build_model(cfg)
    dps = dp_axes(mesh)
    dp = dps if len(dps) > 1 else dps[0]
    ctx = ParallelCtx(ep_axis="model", ep_size=mesh.shape["model"],
                      mesh=mesh, dp_spec=dp)

    params = model.init(torch.Generator(), torch.bfloat16, device="meta")
    batch = input_specs(cfg, sspec)
    trees = {"params": (params, param_specs(params, mesh)),
             "batch": (batch, batch_specs(batch, mesh))}
    if train:
        opt_cfg = AdamWConfig(state_bits=opt_bits)
        opt_state = init_state(opt_cfg, params)
        trees["opt_state"] = (opt_state, opt_state_specs(
            opt_state, trees["params"][1], mesh, zero=True))
    elif sspec.kind == "decode":
        caches = cache_specs(cfg, sspec)
        trees["caches"] = (caches, cache_specs_tree(caches, mesh))
    by_specs = {k: spec_bytes(t, s, mesh) for k, (t, s) in trees.items()}
    by_specs["total"] = sum(by_specs.values())

    if not train:
        # the expert stacks too, whichever form runs them
        params = held_params(cfg, params, mesh)
    elif cfg.moe is not None:
        ep_axis = ep_axis_for(cfg, sspec.global_batch, sspec.seq_len, mesh)
        if ep_axis is not None:
            params = _cut_experts(params, _axis_size(mesh, ep_axis))
    if train:
        # the optimizer state of the params as the rank holds them
        opt_state = init_state(opt_cfg, params)
        step = make_train_step(model, opt_cfg, ctx,
                               microbatches=microbatches)
        args = (params, opt_state, batch)
    elif sspec.kind == "prefill":
        step = make_prefill_step(model, ctx)
        args = (params, batch)
    else:
        step = make_decode_step(model, ctx)
        args = (params, cache_block(model, sspec.global_batch,
                                    sspec.seq_len, torch.bfloat16, "meta",
                                    mesh), batch)
    return cfg, step, args, by_specs


def run_cell(arch: str, shape: str, multi_pod: bool, *,
             opt_bits: int = 0, save: bool = True,
             extra_cfg: dict | None = None, tag: str = "",
             microbatches: int = 1) -> dict:
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    cfg0 = get_config(arch)
    ok, why = applicable(cfg0, shape)
    rec = {"arch": arch, "shape": shape, "mesh": mesh_name,
           "opt_bits": opt_bits, "tag": tag}
    if not ok:
        rec.update({"status": "skipped", "reason": why})
        _save(rec, save)
        return rec
    cfg = cfg0.replace(**extra_cfg) if extra_cfg else cfg0
    t0 = time.perf_counter()
    try:
        mesh = make_dry_mesh(multi_pod)
        rec.update({"n_devices": mesh.size, "n_params": cfg.n_params(),
                    "n_active_params": cfg.n_active_params()})
        _, step, args, by_specs = build_cell(
            arch, shape, mesh, opt_bits=opt_bits, extra_cfg=extra_cfg,
            microbatches=microbatches)
        t1 = time.perf_counter()
        oc = op_cost(step, *args)
        t2 = time.perf_counter()
        rec.update({
            "status": "ok",
            "build_s": round(t1 - t0, 3),
            "walk_s": round(t2 - t1, 3),
            "memory": {k: oc[k] for k in ("argument_bytes", "output_bytes",
                                          "temp_bytes", "peak_bytes")}
            | {"by_specs": by_specs},
            "cost": {"flops": oc["flops"],
                     "bytes_accessed": oc["bytes_accessed"]},
            "collectives": {"bytes": oc["collective_bytes"],
                            "counts": oc["collective_counts"],
                            "total_bytes": oc["collective_total"]},
            "op_cost": oc,
        })
    except Exception as e:      # a cell's boundary: record it, go on
        rec.update({"status": "error", "error": repr(e),
                    "traceback": traceback.format_exc()[-4000:]})
    _save(rec, save)
    return rec


def _save(rec: dict, save: bool):
    if not save:
        return
    ART.mkdir(parents=True, exist_ok=True)
    tag = f"__{rec['tag']}" if rec.get("tag") else ""
    f = ART / f"{rec['arch']}__{rec['shape']}__{rec['mesh']}{tag}.json"
    f.write_text(json.dumps(rec, indent=2))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--single-pod", action="store_true")
    ap.add_argument("--opt-bits", type=int, default=0)
    ap.add_argument("--tag", default="")
    args = ap.parse_args(argv)

    meshes = []
    if args.single_pod or not args.multi_pod:
        meshes.append(False)
    if args.multi_pod:
        meshes.append(True)

    if args.all:
        cells = [(a, s) for a in sorted(REGISTRY) for s in SHAPES]
    elif args.arch and args.shape:
        cells = [(args.arch, args.shape)]
    else:
        ap.error("--arch/--shape or --all")

    counts = dict.fromkeys(("ok", "skipped", "not_ported", "error"), 0)
    for mp in meshes:
        for a, s in cells:
            rec = run_cell(a, s, mp, opt_bits=args.opt_bits, tag=args.tag)
            st = rec["status"]
            counts[st] += 1
            mem = rec.get("memory", {})
            peak = mem.get("peak_bytes")
            spec = mem.get("by_specs", {}).get("total")
            mem_s = (f"{peak / 2**30:.2f}GiB/rank" if peak else "-")
            spec_s = f"{spec / 2**30:.2f}GiB/rank" if spec else "-"
            flops = rec.get("cost", {}).get("flops")
            fl_s = f"{flops:.3e}" if flops else "-"
            print(f"[{rec['mesh']}] {a:24s} {s:12s} {st:10s} "
                  f"peak={mem_s:16s} by_specs={spec_s:16s} flops={fl_s} "
                  f"walk={rec.get('walk_s', '-')}s "
                  f"{rec.get('reason', '') or rec.get('error', '')}",
                  flush=True)
            if st == "ok":
                print("  memory:", json.dumps(mem))
                print("  cost:", json.dumps(rec["cost"]),
                      "launches:", rec["op_cost"]["launches"],
                      "kernels:", json.dumps(rec["op_cost"]["kernels"]))
                print("  collectives:",
                      json.dumps(rec["collectives"]["bytes"]))
    print("\ndry-run summary: " + " ".join(f"{k}={v}"
                                            for k, v in counts.items()))
    return 1 if counts["error"] else 0


if __name__ == "__main__":
    raise SystemExit(main())
