"""Sharding rules: pytree-path pattern -> partition spec, per architecture.

The port of the reference package's ``parallel/sharding.py``: the same
rules, the same functions, the same specs.  A spec is a :class:`P`, a
tuple with one entry a tensor dim: ``None`` (replicated over it), an axis
name, or a tuple of axis names (sharded over their product, the first
one major); ``P()`` replicates the whole tensor.

Axis conventions (see launch/mesh.py):
  'data' (+ 'pod' when multi-pod)  — batch / ZeRO axis
  'model'                          — TP / EP / head axis

Rules are (regex over the flattened path, spec builder).  Param tensors are
stacked per layer ([L, ...] leading dim), so most specs start with None.
The same rules shard the AdamW moment tree (MomentState mirrors the param
shapes; 8-bit states are flat [nblocks, 256] and get ZeRO 'data' sharding).

Every function takes any ``mesh`` with a ``shape`` dict and
``axis_names`` (the port's :class:`~repro_torch.launch.mesh.Mesh`, or a
stand-in).  :func:`to_placements` gives ``torch.distributed.tensor``
placements per mesh dim, and :func:`local_shard` / :func:`gather_shards`
cut this rank's block out of a replicated tensor and put it back, each
differentiable with ``shard_map``'s transpose rule.

How a rank holds each leaf (the reference leaves that to GSPMD, which
reads it from the jitted step's argument shardings; the port reads it
from the tensors): :func:`tp_spec` is the rule of tensor-parallel
serving, :func:`held_params` cuts a whole tree by it, :func:`held_specs`
reads each leaf's spec back from its shape (an expert stack's slice
too), and :func:`cache_block` allocates a rank's decode caches.
"""
from __future__ import annotations

import re
from typing import Any

import numpy as np
import torch

PyTree = Any


class P(tuple):
    """A partition spec: one entry a tensor dim (see the module doc)."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self) -> str:
        return f"P{tuple.__repr__(self)}"

    def __getnewargs__(self):
        return tuple(self)


def dp_axes(mesh):
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _path_str(path) -> str:
    return "/".join(str(p) for p in path)


# (pattern, spec-for-trailing-dims); leading L dim (if rank is +1) gets None.
# Specs are written for the *unstacked* tensor rank.
_RULES: list[tuple[str, tuple]] = [
    # embeddings: vocab-parallel over model axis
    (r"embed$", ("model", None)),
    (r"unembed$", (None, "model")),
    (r"enc_pos$", (None, None)),
    # attention (GQA + cross-attention)
    (r"attn/w[qkv]$|xattn/w[qkv]$", (None, "model")),
    (r"attn/wo$|xattn/wo$", ("model", None)),
    (r"attn/b[qkv]$", ("model",)),
    # MLA
    (r"attn/wdq$|attn/wdkv$|attn/wkr$", (None, None)),
    (r"attn/wuq$|attn/wuk$|attn/wuv$", (None, "model")),
    (r"attn/(q|kv)_norm$", (None,)),
    # dense MLPs
    (r"mlp/w[gu1]$|shared/w[gu1]$", (None, "model")),
    (r"mlp/w[d2]$|shared/w[d2]$", ("model", None)),
    # MoE experts: expert-parallel; big expert counts shard E over
    # (data x model) so 256-expert models distribute across the full pod
    (r"moe/w[gu]$", (("data", "model"), None, None)),
    (r"moe/wd$", (("data", "model"), None, None)),
    (r"moe/router$", (None, None)),
    # Mamba2
    (r"mamba/win$", (None, "model")),
    (r"mamba/wout$", ("model", None)),
    (r"mamba/conv$", (None, "model")),
    (r"mamba/(A_log|D|dt_bias)$", (None,)),
    (r"mamba/norm$", (None,)),
    # RWKV6
    (r"mix/w[rkvg]$|mix/wo$|mix/cr$", (None, "model")),
    (r"mix/ck$", (None, "model")),
    (r"mix/cv$", ("model", None)),
    (r"mix/w_lora_a$", (None, None)),
    (r"mix/w_lora_b$", (None, None)),
    (r"mix/u$", (None, None)),
    (r"mix/(mix_rkvwg|mix_cm|w0|ln_x)$", None),  # replicate small vectors
    # norms and everything small: replicate
    (r"ln", None),
]


def _axis_size(mesh, axis) -> int:
    if axis is None:
        return 1
    if isinstance(axis, tuple):
        return int(np.prod([mesh.shape[a] for a in axis if a in mesh.shape]))
    return mesh.shape.get(axis, 1)


def _fit_axis(axis, dim: int, mesh):
    """Largest suffix/whole of the requested axis (or None) that divides."""
    if axis is None:
        return None
    candidates = [axis]
    if isinstance(axis, tuple):
        # prefer the full product, then each single member (model first)
        candidates += [a for a in reversed(axis)]
    for cand in candidates:
        csize = _axis_size(mesh, cand)
        ok = dim % csize == 0
        if isinstance(cand, tuple):
            ok = ok and all(a in mesh.axis_names for a in cand)
        else:
            ok = ok and (cand in mesh.axis_names)
        if ok and csize > 1:
            return cand
    return None


def spec_for_param(path: str, shape: tuple[int, ...], mesh) -> P:
    for pat, trailing in _RULES:
        if re.search(pat, path):
            if trailing is None:
                return P()
            rank = len(shape)
            spec = list(trailing)
            # leading stack dims (L, or none) -> None
            while len(spec) < rank:
                spec.insert(0, None)
            spec = spec[-rank:] if len(spec) > rank else spec
            out = [_fit_axis(ax, dim, mesh) for ax, dim in zip(spec, shape)]
            return P(*out)
    return P()  # default: replicate


def zero_spec(spec: P, shape: tuple[int, ...], mesh,
              enable: bool = True) -> P:
    """ZeRO: additionally shard a replicated axis over the *unused* dp axes.

    Applied to optimizer moments (and optionally params for ZeRO-3).
    Picks the first unsharded dim divisible by the free dp extent.
    """
    if not enable:
        return spec
    spec_t = tuple(spec) + (None,) * (len(shape) - len(tuple(spec)))
    used: set = set()
    for ax in spec_t:
        if isinstance(ax, tuple):
            used.update(ax)
        elif ax is not None:
            used.add(ax)
    dps = tuple(a for a in dp_axes(mesh) if a not in used)
    if not dps:
        return P(*spec_t)
    dp_n = int(np.prod([mesh.shape[a] for a in dps]))
    out = list(spec_t)
    for i, (ax, dim) in enumerate(zip(spec_t, shape)):
        if ax is None and dim % dp_n == 0:
            out[i] = dps if len(dps) > 1 else dps[0]
            return P(*out)
    return P(*spec_t)


def _map(fn, tree, path=()):
    """``fn(path, leaf)`` over a tree of dicts, tuples and lists (a
    ``MomentState`` keeps its type); ``None`` stays ``None``."""
    if isinstance(tree, dict):
        return {k: _map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (tuple, list)) and not isinstance(tree, P):
        items = [_map(fn, v, path + (i,)) for i, v in enumerate(tree)]
        if hasattr(tree, "_fields"):
            return type(tree)(*items)
        return type(tree)(items)
    return None if tree is None else fn(path, tree)


def param_specs(params: PyTree, mesh) -> PyTree:
    return _map(lambda path, x: spec_for_param(_path_str(path),
                                               tuple(x.shape), mesh), params)


def opt_state_specs(opt_state: PyTree, param_spec_tree: PyTree, mesh,
                    zero: bool = True) -> PyTree:
    """Moments follow the param spec (+ZeRO); 8-bit blocks shard over data."""
    from ..optim import MomentState

    def mv_spec(pspec: P, mv: MomentState):
        if mv.m_scale is not None:
            # shape-preserving 8-bit moments: int8 inherits the param spec;
            # the per-block scale drops the last-axis sharding if the block
            # count no longer divides the axis extent
            qspec = zero_spec(pspec, tuple(mv.m.shape), mesh, enable=zero)
            qt = tuple(qspec) + (None,) * (len(mv.m.shape) - len(tuple(qspec)))
            last = qt[-1]
            s_shape = tuple(mv.m_scale.shape)
            s_last = _fit_axis(last, s_shape[-1], mesh) if last else None
            sspec = P(*(qt[:-1] + (s_last,)))
            return MomentState(qspec, qspec, sspec, sspec)
        mspec = zero_spec(pspec, tuple(mv.m.shape), mesh, enable=zero)
        return MomentState(mspec, mspec)

    def walk(ps, mv):
        if isinstance(ps, dict):
            return {k: walk(ps[k], mv[k]) for k in ps}
        return mv_spec(ps, mv)

    return {"mv": walk(param_spec_tree, opt_state["mv"]), "step": P()}


def batch_specs(batch_shapes: dict, mesh) -> dict:
    """Inputs: shard batch over dp axes when divisible, else sequence."""
    dps = dp_axes(mesh)
    dp_n = int(np.prod([mesh.shape[a] for a in dps]))
    dp = dps if len(dps) > 1 else dps[0]
    out = {}
    for k, sds in batch_shapes.items():
        shape = tuple(sds.shape)
        if len(shape) == 0:
            out[k] = P()
        elif shape[0] % dp_n == 0:
            out[k] = P(dp, *([None] * (len(shape) - 1)))
        elif len(shape) >= 2 and shape[1] % dp_n == 0:
            out[k] = P(None, dp, *([None] * (len(shape) - 2)))
        else:
            out[k] = P(*([None] * len(shape)))
    return out


def cache_specs_tree(caches: PyTree, mesh) -> PyTree:
    """Decode caches: [L, B, S, H, D]-ish — shard B over dp, heads/features
    over model when divisible (best-effort, per-leaf).  A host integer
    (the port's cache ``len``) is a scalar: ``P()``."""
    dps = dp_axes(mesh)
    dp_n = int(np.prod([mesh.shape[a] for a in dps]))
    model_n = mesh.shape["model"]
    dp = dps if len(dps) > 1 else dps[0]

    def one(_, x):
        shape = tuple(getattr(x, "shape", ()))
        spec = [None] * len(shape)
        # batch dim is axis 1 for stacked caches [L, B, ...], else 0
        bdim = 1 if len(shape) >= 2 else 0
        if len(shape) > bdim and shape[bdim] % dp_n == 0:
            spec[bdim] = dp
        # model axis: try trailing dims (heads or features), prefer axis -2
        for cand in (len(shape) - 2, len(shape) - 1):
            if cand <= bdim or cand < 0:
                continue
            if spec[cand] is None and shape[cand] % model_n == 0:
                spec[cand] = "model"
                break
        return P(*spec)

    return _map(one, caches)


# ------------------------------------------------- placements and blocks
def _axes(entry) -> tuple:
    if entry is None:
        return ()
    return tuple(entry) if isinstance(entry, tuple) else (entry,)


def to_placements(tree_specs: PyTree, mesh) -> PyTree:
    """Each spec as ``torch.distributed.tensor`` placements, one a mesh
    dim: ``Shard(d)`` where tensor dim ``d`` is sharded over it, else
    ``Replicate()``.  A tuple entry such as ``("data", "model")`` shards
    its dim over both, data-major, as JAX does (``Shard`` placements of
    one dim in mesh-dim order)."""
    from torch.distributed.tensor import Replicate, Shard

    def one(_, spec):
        dims = {}
        for d, entry in enumerate(spec):
            for ax in _axes(entry):
                if ax in dims:
                    raise ValueError(f"{spec}: axis {ax!r} used twice")
                dims[ax] = d
        return tuple(Shard(dims[a]) if a in dims else Replicate()
                     for a in mesh.axis_names)

    return _map(one, tree_specs) if not isinstance(tree_specs, P) else one(
        (), tree_specs)


def _cut(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    for d, entry in enumerate(spec):
        axes = _axes(entry)
        if not axes:
            continue
        n = _axis_size(mesh, entry)
        if t.shape[d] % n:
            raise ValueError(f"dim {d} of {tuple(t.shape)} does not split "
                             f"over {entry} ({n} ranks)")
        idx = 0
        for a in axes:
            idx = idx * mesh.shape[a] + mesh.coords[a]
        size = t.shape[d] // n
        t = t.narrow(d, idx * size, size)
    return t


def _gather(block: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    from .collectives import all_gather

    for d, entry in enumerate(spec):
        if not _axes(entry):
            continue
        parts = all_gather(block, mesh.group(entry))     # [n, ...]
        block = torch.cat(list(parts.unbind(0)), dim=d)
    return block


class _LocalShard(torch.autograd.Function):
    """A replicated value cut into this rank's block.  Every rank on the
    axes goes on computing with the whole value outside the region, so
    each needs the whole cotangent: the blocks' cotangents all-gathered."""

    @staticmethod
    def forward(ctx, t, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _cut(t, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.spec, ctx.mesh), None, None


class _GatherShards(torch.autograd.Function):
    """The blocks gathered into a replicated value.  Every rank on the axes
    computes the same loss from it, so a rank's cotangent is already the
    whole of it: each block takes its own part, summed over nothing (as
    :class:`~repro_torch.parallel.collectives._Psum` reasons)."""

    @staticmethod
    def forward(ctx, block, spec, mesh):
        ctx.spec, ctx.mesh = spec, mesh
        return _gather(block, spec, mesh)

    @staticmethod
    def backward(ctx, g):
        return _cut(g, ctx.spec, ctx.mesh), None, None


def local_shard(t: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """This rank's block of ``t`` (replicated, full shape) under ``spec``:
    dim ``d`` is cut into ``prod(axis sizes)`` equal blocks and this rank
    takes the one at its (major-to-minor) index on the entry's axes.  A
    view, no copy.  Differentiable with ``shard_map``'s transpose (the
    blocks' cotangents all-gathered, see :class:`_LocalShard`)."""
    return _LocalShard.apply(t, spec, mesh)


def gather_shards(block: torch.Tensor, spec: P, mesh) -> torch.Tensor:
    """The inverse of :func:`local_shard`: every rank's block under
    ``spec``, all-gathered back to the full tensor on every rank (what
    GSPMD does with a ``shard_map``'s replicated ``out_specs``).
    Differentiable: the backward takes this rank's block of the cotangent
    (see :class:`_GatherShards`)."""
    return _GatherShards.apply(block, spec, mesh)


# ------------------------------------------------ how a rank holds a leaf
#: the decoder family's leaves that tensor-parallel serving holds by their
#: spec over 'model': GQA attention, the dense MLPs, the (un)embedding
_TP_LEAF = re.compile(r"^(embed|unembed)$|(^|/)attn/(w[qkvo]|b[qkv])$"
                      r"|(^|/)mlp/w[gud12]$")
#: an MoE layer's routed expert stacks (the expert-parallel region's)
_EXPERTS = re.compile(r"moe/w[gud]$")


def held_shape(shape, spec: P, mesh) -> tuple:
    """The shape of a rank's block of a ``shape`` tensor under ``spec``:
    each sharded dim cut by its axes' size (the rules shard only dims
    those sizes divide)."""
    entries = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(int(d) // _axis_size(mesh, e) for d, e in zip(shape, entries))


def tensor_parallel(cfg) -> bool:
    """Whether ``cfg``'s family serves tensor-parallel: the decoder
    family (dense, MoE and multimodal-prefix).  RWKV6, the hybrid and the
    encoder-decoder hold every leaf whole."""
    return not cfg.encdec and cfg.family in ("dense", "moe", "vlm")


def heads_split(cfg, m: int) -> bool:
    """Whether GQA attention splits over ``m`` 'model' ranks: ``m``
    divides the ``H`` query heads, and each rank's ``H/m`` heads either
    cover whole groups of ``G = H/Hkv`` (their kv heads are the rank's
    own) or lie within one group (ranks share its kv head).  Where not
    (starcoder2's 24 or smollm's 15 heads at 16), the attention leaves
    are held whole: their specs would cut within a head."""
    H, Hkv = cfg.n_heads, cfg.n_kv_heads
    if m <= 1 or H % m or H % Hkv:
        return False
    q, G = H // m, H // Hkv
    return q % G == 0 or G % q == 0


def kv_heads_held(cfg, mesh) -> range:
    """The kv heads this rank's attention reads and its caches hold: those
    of its ``H/m`` query heads where attention splits
    (:func:`heads_split`), else all ``Hkv``.  Where ``m`` does not divide
    ``Hkv`` this is one head that several ranks share, where the
    reference's ``cache_specs_tree`` cuts the head dim instead."""
    m = mesh.shape.get("model", 1) if mesh is not None else 1
    if not (tensor_parallel(cfg) and cfg.mla is None and heads_split(cfg, m)):
        return range(cfg.n_kv_heads)
    q, G = cfg.n_heads // m, cfg.n_heads // cfg.n_kv_heads
    first = mesh.coords["model"] * q
    return range(first // G, (first + q - 1) // G + 1)


def tp_spec(cfg, path: str, shape, mesh) -> P:
    """The spec tensor-parallel serving holds leaf ``path`` (of global
    ``shape``) by on ``mesh``: ``spec_for_param``'s, over 'model' only,
    for the decoder family's GQA attention where its heads split
    (:func:`heads_split`), its dense MLPs and its (un)embedding; ``P()``
    (whole) for every other leaf: norms, routers, an MoE layer's experts
    (the expert-parallel region's own rule, :func:`held_specs`) and
    shared expert, MLA attention, and every leaf of the other families.
    The embedding ``[V, d]`` is cut over the vocab where ``m`` divides it
    (not internvl2-26b's 92,553); the untied unembedding ``[d, V]``, which
    the rule ``embed$`` matches first, over ``d``."""
    if not (tensor_parallel(cfg) and _TP_LEAF.search(path)):
        return P()
    if "attn/" in path and (cfg.mla is not None or not heads_split(
            cfg, mesh.shape.get("model", 1))):
        return P()
    spec = spec_for_param(path, tuple(shape), mesh)
    return spec if any(e is not None for e in spec) else P()


def _paths(tree, prefix: str = "") -> list:
    """Each leaf's path (``a/b/c``), in the order of :func:`leaves`."""
    if isinstance(tree, dict):
        return [p for k in sorted(tree)
                for p in _paths(tree[k], f"{prefix}/{k}" if prefix else k)]
    return [prefix]


def held_params(cfg, params, mesh, prefix: str = ""):
    """A whole param tree cut to this rank's held tree: each leaf by its
    :func:`tp_spec` (a contiguous copy of its block), every other leaf as
    it is (the same tensor).  ``prefix`` is the tree's path in the whole
    tree (``"layers"`` for one layer's dict)."""
    def one(path, t):
        spec = tp_spec(cfg, _path_str((prefix,) + path if prefix else path),
                       t.shape, mesh)
        return _cut(t, spec, mesh).clone() if spec != P() else t

    return _map(one, params)


def param_shapes(model) -> list:
    """The global shape of each of ``model``'s param leaves, in the order
    of :func:`~repro_torch.tree.leaves` (from its ``init`` on ``meta``)."""
    from ..tree import leaves

    return [tuple(t.shape) for t in leaves(model.init(
        torch.Generator(), torch.float32, device="meta"))]


def held_specs(model, params, mesh, shapes: list) -> list:
    """The spec of each leaf of ``params`` (in the order of
    :func:`~repro_torch.tree.leaves`) as this rank holds it, read from its
    shape against the global one (``shapes``, :func:`param_shapes`'): ``P()`` for a whole leaf; an expert stack held as its
    ``[L, E/ep, ...]`` slice, its storage spec (``param_specs``'); any
    other leaf held as a slice, its :func:`tp_spec`.  A leaf that is
    neither whole nor the slice its rule gives is refused, the error
    naming it."""
    from ..tree import leaves

    out = []
    for path, t, shape in zip(_paths(params), leaves(params), shapes):
        if tuple(t.shape) == shape:
            out.append(P())
            continue
        spec = (spec_for_param(path, shape, mesh) if _EXPERTS.search(path)
                else tp_spec(model.cfg, path, shape, mesh))
        if held_shape(shape, spec, mesh) != tuple(t.shape):
            raise ValueError(f"{path}: held as {tuple(t.shape)}, neither "
                             f"whole {shape} nor its slice under {spec} "
                             f"{held_shape(shape, spec, mesh)}")
        out.append(spec)
    return out


def held_batch(n: int, mesh) -> int:
    """Rows of a batch of ``n`` a serving rank holds: its block over the
    dp axes where they divide ``n`` (``batch_specs``' dim 0), else all."""
    dp_n = _axis_size(mesh, dp_axes(mesh))
    return n // dp_n if n % dp_n == 0 else n


def cache_block(model, batch: int, max_len: int, dtype, device, mesh):
    """This rank's block of the decode caches of a ``batch`` of global
    rows, allocated directly (the whole would not fit at full depth): its
    :func:`held_batch` rows and, in the decoder family, the kv heads of
    :func:`kv_heads_held`."""
    from ..models import build_model

    heads = kv_heads_held(model.cfg, mesh)
    if len(heads) != model.cfg.n_kv_heads:
        model = build_model(model.cfg.replace(n_kv_heads=len(heads)))
    return model.init_cache(held_batch(batch, mesh), max_len, dtype, device)
