"""The port's parallelism (``parallel/*``, ``launch/mesh.py``, the
expert-parallel MoE) against the reference, on the CPU.

* The sharding rules in process: ``spec_for_param``/``param_specs``,
  ``zero_spec``, ``opt_state_specs`` (32- and 8-bit moments),
  ``batch_specs`` and ``cache_specs_tree`` of every leaf of all ten archs
  at full width (the port's trees on ``meta``, the reference's through
  ``jax.eval_shape``) on meshes (2,4), (4,2), (1,1), 16x16 and 2x16x16
  (the reference on ``AbstractMesh``es, the port on a stand-in with
  ``shape`` and ``axis_names``), compared as tuples.
* One reference subprocess with four host devices writes an ``.npz``:
  ``compressed_psum_grads`` over a (4,) data mesh with ``_quant``'s
  payloads and scales of each rank's gradients, ``pipelined_forward``
  and ``jax.grad`` of ``make_pipeline_loss`` (the reference example's
  stage at D 16), and deepseek-v3-671b smoke's ``_moe_dispatch`` under a
  (1,4) mesh (4 experts top-2, ``ep_a2a``, B=2 S=2048: 4,096 tokens, the
  ``ep_threshold``) at capacity factor 4.0 (drop-free) and 1.0
  (dropping), with its routing.
* One run of the port over 4 forked gloo ranks against it: the int8
  payloads and scales on the wire byte-identical and the result within
  1e-6; the pipeline's forward within 2e-5 (the example's tolerance) and
  each stage's gradients within 1e-5 of the largest; the EP routing and
  its dropped slots (at the send buffer and at each rank's experts)
  byte-identical to a NumPy model of the reference's two capacity stages
  on the reference's routing, the outputs within ``test_torch_moe.py``'s
  tolerance; deepseek smoke's ``make_prefill_step(model, ctx)`` on that
  mesh against the step without one; ``local_shard``/``gather_shards``
  and the meshes' groups.
* ``build_schedule``'s levels equal to the reference's, ``run_ranks``
  failing with the failed rank's traceback, and ``tree.rebuild``
  freeing its values with its result (no reference cycle).

All inputs are drawn with NumPy from a seed.
"""
from __future__ import annotations

import dataclasses
import json
import os
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro import optim as roptim  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.parallel import sharding as rsh  # noqa: E402
from repro.parallel.pipeline import build_schedule as ref_schedule  # noqa: E402
from repro_torch import configs, convert, optim  # noqa: E402
from repro_torch.launch.mesh import Mesh, make_debug_mesh, run_ranks  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402
from repro_torch.parallel import compression, pipeline, sharding  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((2, 4), ("data", "model")), ((4, 2), ("data", "model")),
          ((1, 1), ("data", "model")), ((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model"))]
RANKS = 4
MOE_TOL = dict(rtol=2e-4, atol=2e-4)         # tests/test_torch_moe.py
PIPE_TOL = dict(rtol=2e-5, atol=2e-5)        # examples/pipeline_train.py
DEEPSEEK = "deepseek-v3-671b"
EP_B, EP_S = 2, 2048
EP_CFS = (4.0, 1.0)
PIPE = dict(n_micro=8, n_stages=4, tile_m=2, b_tile=2, d=16)


# ------------------------------------------------------------ the rules
def _stand_in(shape, names):
    return types.SimpleNamespace(shape=dict(zip(names, shape)),
                                 axis_names=names)


def _ref_specs(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(
        x, jax.sharding.PartitionSpec))


def _specs(tree) -> list:
    """The port's specs in the reference's flatten order (a ``P`` is a
    leaf, though a tuple)."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _specs(tree[k])]
    return [tree]


def _cache_specs(tree, path="") -> dict:
    """Cache specs by path, without ``len``: the reference stacks a
    length a layer, the port keeps one host integer a group."""
    if isinstance(tree, dict):
        return {k: v for key in tree if key != "len"
                for k, v in _cache_specs(tree[key], f"{path}/{key}").items()}
    return {path: tuple(tree)}


def _same(got: list, want: list, what: str):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert tuple(g) == tuple(w), (what, i, g, w)


def _moment_specs(state_specs):
    """Each leaf's MomentState of specs as a tuple of tuples (``None``
    for a missing scale)."""
    out = []

    def walk(t):
        if isinstance(t, dict):
            for k in sorted(t):
                walk(t[k])
        else:
            out.append(tuple(None if s is None else tuple(s) for s in t))

    walk(state_specs["mv"])
    return out


@pytest.mark.parametrize("name", sorted(rconfigs.REGISTRY))
def test_sharding_rules_match_reference(name):
    """Every rule function, every leaf, five meshes."""
    rcfg = rconfigs.REGISTRY[name]
    cfg = configs.get_config(name)
    rparams = jax.eval_shape(lambda: ref_build(rcfg).init(
        jax.random.PRNGKey(0), jnp.bfloat16))
    params = build_model(cfg).init(torch.Generator(), torch.bfloat16,
                                   device="meta")
    rstates = {bits: jax.eval_shape(lambda bits=bits: roptim.init_state(
        roptim.AdamWConfig(state_bits=bits), rparams)) for bits in (32, 8)}
    states = {bits: optim.init_state(optim.AdamWConfig(state_bits=bits),
                                     params) for bits in (32, 8)}
    cells = {sh: (rconfigs.input_specs(rcfg, sh), configs.input_specs(cfg, sh),
                  rconfigs.cache_specs(rcfg, sh), configs.cache_specs(cfg, sh))
             for sh in configs.SHAPES}
    for dims, names in MESHES:
        rmesh, mesh = AbstractMesh(dims, names), _stand_in(dims, names)
        tag = f"{name} {dims}"
        rps, ps = rsh.param_specs(rparams, rmesh), sharding.param_specs(
            params, mesh)
        _same(_specs(ps), _ref_specs(rps), f"{tag} param_specs")
        shapes = [tuple(t.shape) for t in leaves(params)]
        _same([sharding.zero_spec(s, sh, mesh)
               for s, sh in zip(_specs(ps), shapes)],
              [rsh.zero_spec(s, sh, rmesh)
               for s, sh in zip(_ref_specs(rps), shapes)], f"{tag} zero")
        for bits in (32, 8):
            want = rsh.opt_state_specs(rstates[bits], rps, rmesh)
            got = sharding.opt_state_specs(states[bits], ps, mesh)
            assert _moment_specs(got) == _moment_specs(want), (tag, bits)
            assert tuple(got["step"]) == tuple(want["step"])
        for sh, (rin, pin, rcache, pcache) in cells.items():
            rb = rsh.batch_specs(rin, rmesh)
            b = sharding.batch_specs(pin, mesh)
            assert {k: tuple(v) for k, v in b.items()} == {
                k: tuple(v) for k, v in rb.items()}, (tag, sh)
            assert _cache_specs(sharding.cache_specs_tree(pcache, mesh)) == (
                _cache_specs(rsh.cache_specs_tree(rcache, rmesh))), (tag, sh)


def test_spec_for_param_examples_and_placements():
    """The reference test's examples on the port's ``P``, and
    ``to_placements`` of a tuple entry: both mesh dims shard one tensor
    dim, data-major."""
    from torch.distributed.tensor import Replicate, Shard

    P = sharding.P
    mesh = _stand_in((2, 4), ("data", "model"))
    assert sharding.spec_for_param("layers/attn/wq", (16, 64, 128),
                                   mesh) == P(None, None, "model")
    assert sharding.spec_for_param("moe_layers/moe/wg", (8, 8, 64, 32),
                                   mesh) == P(None, ("data", "model"),
                                              None, None)
    assert sharding.spec_for_param("layers/ln1", (16, 64), mesh) == P()
    assert sharding.zero_spec(P(None, "model"), (8, 64), mesh) == P(
        "data", "model")
    assert sharding.to_placements(P(("data", "model"), None), mesh) == (
        Shard(0), Shard(0))
    assert sharding.to_placements({"a": P(None, "model"), "b": P()},
                                  mesh) == {"a": (Replicate(), Shard(1)),
                                            "b": (Replicate(), Replicate())}
    assert repr(P(None, "model")) == "P(None, 'model')"


@pytest.mark.parametrize("m,s,tile", [(8, 4, 2), (12, 5, 3), (6, 1, 1)])
def test_build_schedule_levels_match_reference(m, s, tile):
    got, want = pipeline.build_schedule(m, s, tile), ref_schedule(m, s, tile)
    assert (got.n_stages, got.n_tiles, got.tile_m, got.depth) == (
        want.n_stages, want.n_tiles, want.tile_m, want.depth)
    assert got.levels == want.levels


def test_compression_arithmetic_matches_reference_in_process():
    """``_quant`` byte for byte and ``quantize_dequantize_grads`` on one
    device, with ties at half a step in the data."""
    from repro.parallel import compression as rcomp

    rng = np.random.default_rng(11)
    g = (rng.standard_normal((3, 301)) * 3).astype(np.float32)
    g[0, :8] = np.float32(127.5) * np.arange(8) / 127.5   # exact halves
    q, s = compression._quant(torch.from_numpy(g))
    rq, rs = rcomp._quant(jnp.asarray(g))
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy().view(np.int32),
                                  np.asarray(rs).view(np.int32))
    got = compression.quantize_dequantize_grads({"g": torch.from_numpy(g)})
    want = rcomp.quantize_dequantize_grads({"g": jnp.asarray(g)})
    np.testing.assert_array_equal(got["g"].numpy(), np.asarray(want["g"]))
    with pytest.raises(NotImplementedError, match="shard_map"):
        compression.make_compressed_allreduce(None, None)({})


def test_rebuild_keeps_no_reference_to_its_values():
    """``tree.rebuild`` (which ``compressed_psum_grads`` returns through)
    leaves no reference cycle holding its values: a gradient tree is
    freed when its last name goes, not when the cyclic collector runs."""
    import gc
    import weakref

    from repro_torch.tree import rebuild

    enabled = gc.isenabled()
    gc.disable()
    try:
        t = torch.zeros(4)
        alive = weakref.ref(t)
        out = rebuild({"a": None, "b": 0, "c": (0, [0])},
                      [t, torch.ones(1), torch.ones(2)])
        assert out["b"] is t and out["a"] is None
        del t, out
        assert alive() is None
    finally:
        if enabled:
            gc.enable()


# ------------------------------------------------ the multi-rank runs
def _inputs() -> dict:
    """Every input of the multi-rank runs, from one NumPy seed."""
    rng = np.random.default_rng(29)
    out = {
        # two gradient leaves a rank: 2,100 values (9 blocks, padded to 12)
        # and 130 (1 block, padded to 4)
        "g_w": (rng.standard_normal((RANKS, 3, 700)) * 2).astype(np.float32),
        "g_b": rng.standard_normal((RANKS, 130)).astype(np.float32),
    }
    S, D = PIPE["n_stages"], PIPE["d"]
    n_tiles = PIPE["n_micro"] // PIPE["tile_m"]
    bt = PIPE["b_tile"] * PIPE["tile_m"]
    out.update({
        "p_w1": (0.3 * rng.standard_normal((S, D, D))).astype(np.float32),
        "p_b1": (0.1 * rng.standard_normal((S, D))).astype(np.float32),
        "p_w2": (0.3 * rng.standard_normal((S, D, D))).astype(np.float32),
        "mbs": rng.standard_normal((n_tiles, bt, D)).astype(np.float32),
        "targets": rng.standard_normal((n_tiles, bt, D)).astype(np.float32),
    })
    cfg = rconfigs.REGISTRY[DEEPSEEK].smoke_config()
    d, mo = cfg.d_model, cfg.moe
    E, ff = mo.n_experts, mo.d_ff_expert
    out.update({
        "moe_router": (rng.standard_normal((d, E)) / np.sqrt(d)
                       ).astype(np.float32),
        "moe_wg": (rng.standard_normal((E, d, ff)) / np.sqrt(d)
                   ).astype(np.float32),
        "moe_wu": (rng.standard_normal((E, d, ff)) / np.sqrt(d)
                   ).astype(np.float32),
        "moe_wd": (rng.standard_normal((E, ff, d)) / np.sqrt(ff)
                   ).astype(np.float32),
        "moe_shared_wg": (rng.standard_normal((d, ff * mo.n_shared))
                          / np.sqrt(d)).astype(np.float32),
        "moe_shared_wu": (rng.standard_normal((d, ff * mo.n_shared))
                          / np.sqrt(d)).astype(np.float32),
        "moe_shared_wd": (rng.standard_normal((ff * mo.n_shared, d))
                          / np.sqrt(ff)).astype(np.float32),
        "h": rng.standard_normal((EP_B, EP_S, d)).astype(np.float32),
        "tokens": rng.integers(0, cfg.vocab, (EP_B, EP_S)).astype(np.int32),
    })
    out["moe_router"][:, 0] += 0.2        # expert 0 busier: drops at cf 1
    return out


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro import configs
from repro.compat import shard_map
from repro.models import transformer
from repro.parallel.compression import _quant, compressed_psum_grads
from repro.parallel.pipeline import (build_schedule, make_pipeline_loss,
                                     pipelined_forward)

inp = dict(np.load(sys.argv[1]))
opt = json.loads(sys.argv[3])
out = {}
# -------- compression over a (4,) data mesh
mesh = jax.make_mesh((4,), ("data",))
g = {"w": jnp.asarray(inp["g_w"]), "b": jnp.asarray(inp["g_b"])}

def region(gs):
    return compressed_psum_grads({k: v[0] for k, v in gs.items()}, mesh,
                                 axis="data")

res = jax.jit(shard_map(region, mesh=mesh, in_specs=P("data"),
                        out_specs=P()))(g)
for k in g:
    out[f"c_{k}"] = np.asarray(res[k])
    for r in range(4):
        q, s = _quant(g[k][r])
        out[f"q_{k}_{r}"], out[f"s_{k}_{r}"] = np.asarray(q), np.asarray(s)
# -------- the pipeline: the example's stage
S, n_micro, tile_m = opt["n_stages"], opt["n_micro"], opt["tile_m"]
mesh = jax.make_mesh((S,), ("stage",))
sched = build_schedule(n_micro, S, tile_m=tile_m)

def stage_fn(p, x):
    h = jnp.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]

params = {k: jnp.asarray(inp["p_" + k]) for k in ("w1", "b1", "w2")}
mbs, tgt = jnp.asarray(inp["mbs"]), jnp.asarray(inp["targets"])
out["pipe_out"] = np.asarray(pipelined_forward(stage_fn, params, mbs, sched,
                                               mesh))
loss, grads = jax.jit(jax.value_and_grad(make_pipeline_loss(
    stage_fn, sched, mesh)))(params, mbs, tgt)
out["pipe_loss"] = np.asarray(loss)
for k, v in grads.items():
    out["pipe_g_" + k] = np.asarray(v)
# -------- expert parallelism: deepseek smoke's MoE layer, (1,4) mesh
mesh = jax.make_mesh((1, 4), ("data", "model"))
base = configs.REGISTRY[opt["deepseek"]].smoke_config()
pmoe = {k: jnp.asarray(inp["moe_" + k]) for k in ("router", "wg", "wu", "wd")}
pmoe["shared"] = {k: jnp.asarray(inp["moe_shared_" + k])
                  for k in ("wg", "wu", "wd")}
h = jnp.asarray(inp["h"])
ctx = transformer.ParallelCtx(mesh=mesh, dp_spec="data")
for cf in opt["cfs"]:
    cfg = base.replace(moe=dataclasses.replace(base.moe, capacity_factor=cf))
    out[f"ep_{cf}"] = np.asarray(jax.jit(
        lambda p, h: transformer._moe_dispatch(cfg, p, h, ctx))(pmoe, h))
xt = h.reshape(-1, h.shape[-1])
probs = jax.nn.softmax(xt.astype(jnp.float32) @ pmoe["router"], axis=-1)
out["ep_idx"] = np.asarray(jax.lax.top_k(probs, base.moe.top_k)[1])
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel") / "inputs.npz"
    data = _inputs()
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module")
def ref_run(inputs):
    """The reference's runs on four host devices, started in a subprocess
    that works while the port's ranks run (its output to a file)."""
    in_path, _ = inputs
    out_path = in_path.with_name("reference.npz")
    opt = json.dumps({**PIPE, "deepseek": DEEPSEEK, "cfs": EP_CFS})
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"),
           "JAX_PLATFORMS": "cpu"}
    with open(in_path.with_name("reference.log"), "w+") as log:
        proc = subprocess.Popen([sys.executable, "-c", REFERENCE,
                                 str(in_path), str(out_path), opt],
                                stdout=log, stderr=subprocess.STDOUT,
                                env=env, cwd=ROOT)
        try:
            yield proc, out_path, log
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()


@pytest.fixture(scope="module")
def ref(ref_run, port):
    proc, out_path, log = ref_run
    rc = proc.wait(timeout=300)
    log.seek(0)
    assert rc == 0, log.read()[-3000:]
    return dict(np.load(out_path))


def _deepseek_params(cfg):
    return build_model(cfg).init(torch.Generator().manual_seed(5),
                                 torch.float32, "cpu")


def _stage_fn(p, x):
    h = torch.tanh(x @ p["w1"] + p["b1"])
    return x + h @ p["w2"]


def _rank(device, data):
    """One rank of the port's run: compression, the pipeline, EP."""
    import torch.distributed as dist

    torch.set_num_threads(1)
    r = dist.get_rank()
    res = {}
    # -------- compression over a (4,) data mesh, the wire recorded
    mesh = Mesh((RANKS,), ("data",), device=device)
    wire = []
    a2a = compression.all_to_all

    def recording(x, group):
        wire.append(x.clone())
        return a2a(x, group)

    compression.all_to_all = recording
    try:
        got = compression.compressed_psum_grads(
            {"w": torch.from_numpy(data["g_w"][r]),
             "b": torch.from_numpy(data["g_b"][r])}, mesh)
    finally:
        compression.all_to_all = a2a
    res["c"] = {k: v.numpy() for k, v in got.items()}
    # the leaves in flatten order (b, w), each its payload then its scales
    res["wire"] = [w.numpy() for w in wire]
    # -------- the pipeline
    smesh = Mesh((RANKS,), ("stage",), device=device)
    sched = pipeline.build_schedule(PIPE["n_micro"], PIPE["n_stages"],
                                    PIPE["tile_m"])
    s = smesh.group("stage").index
    p = {k: torch.from_numpy(data["p_" + k][s]).requires_grad_()
         for k in ("w1", "b1", "w2")}
    mbs, tgt = (torch.from_numpy(data[k]) for k in ("mbs", "targets"))
    with torch.no_grad():
        res["pipe_out"] = pipeline.pipelined_forward(
            _stage_fn, p, mbs, sched, smesh).numpy()
    loss = pipeline.make_pipeline_loss(_stage_fn, sched, smesh)(p, mbs, tgt)
    grads = torch.autograd.grad(loss, list(p.values()))
    res["pipe_loss"] = float(loss)
    res["pipe_g"] = {k: g.numpy() for k, g in zip(p, grads)}
    # -------- EP on a (1,4) mesh, and the mesh's blocks
    dmesh = make_debug_mesh(1, RANKS, device=device)
    res["coords"] = dmesh.coords
    res["groups"] = {ax: dmesh.group(ax).ranks
                     for ax in ("data", "model", ("data", "model"))}
    base = convert.config_from_reference(
        rconfigs.REGISTRY[DEEPSEEK].smoke_config())
    pmoe = {k: torch.from_numpy(data["moe_" + k])
            for k in ("router", "wg", "wu", "wd")}
    pmoe["shared"] = {k: torch.from_numpy(data["moe_shared_" + k])
                      for k in ("wg", "wu", "wd")}
    h = torch.from_numpy(data["h"])
    spec = sharding.P("data", "model", None)
    blk = sharding.local_shard(h, spec, dmesh)
    res["block"] = blk.numpy()
    res["regathered"] = bool(torch.equal(
        sharding.gather_shards(blk, spec, dmesh), h))
    ctx = transformer.ParallelCtx(mesh=dmesh, dp_spec="data")
    orig = transformer.moe_ep_apply
    for cf in EP_CFS:
        cfg = base.replace(moe=dataclasses.replace(base.moe,
                                                   capacity_factor=cf))
        rec = {}
        transformer.moe_ep_apply = (
            lambda *a, rec=rec, **kw: orig(*a, stats=rec, **kw))
        try:
            with torch.no_grad():
                out = transformer._moe_dispatch(cfg, pmoe, h, ctx)
        finally:
            transformer.moe_ep_apply = orig
        res[f"ep_{cf}"] = {"out": out.numpy(), "idx": rec["idx"].numpy(),
                           "kept": rec["kept"].numpy(),
                           "dropped": rec["dropped"]}
    # the whole model: make_prefill_step threads the ctx to its MoE layer
    shards = []
    transformer.moe_ep_apply = (
        lambda *a, **kw: shards.append(kw.get("ep_size")) or orig(*a, **kw))
    try:
        with torch.no_grad():
            res["prefill"] = make_prefill_step(build_model(base), ctx)(
                _deepseek_params(base), {"tokens": torch.from_numpy(
                    data["tokens"]).long()}).numpy()
    finally:
        transformer.moe_ep_apply = orig
    res["prefill_shards"] = shards
    return res


@pytest.fixture(scope="module")
def port(inputs):
    _, data = inputs
    return run_ranks(_rank, RANKS, data, device="cpu", backend="gloo",
                     timeout=240)


def test_compressed_psum_matches_reference(inputs, ref, port):
    """The int8 payloads and scales each rank puts on the wire equal the
    reference's ``_quant`` of its gradients byte for byte (padded to a
    multiple of the axis), and every rank's mean is the reference's
    within 1e-6 and the reference test's bound of the exact mean."""
    _, data = inputs
    for r, res in enumerate(port):
        wire = iter(res["wire"])
        for k in ("b", "w"):
            q, s = next(wire), next(wire)
            rq, rs = ref[f"q_{k}_{r}"], ref[f"s_{k}_{r}"]
            nb = rq.shape[0]
            pad = (-nb) % RANKS
            assert q.shape == (RANKS, (nb + pad) // RANKS, compression.BLOCK)
            np.testing.assert_array_equal(q.reshape(-1, compression.BLOCK)
                                          [:nb], rq)
            assert not q.reshape(-1, compression.BLOCK)[nb:].any()
            np.testing.assert_array_equal(
                s.reshape(-1, 1)[:nb].view(np.int32), rs.view(np.int32))
        for k in ("b", "w"):
            got, want = res["c"][k], ref[f"c_{k}"]
            np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
            g = data[f"g_{k}"]
            bound = 2 * np.abs(g).max() / 127 + 1e-6
            assert np.abs(got - g.mean(0)).max() <= bound


def test_pipeline_forward_and_grads_match_reference(ref, port):
    """Every rank's pipelined output against the reference's shard_map
    run; the loss, and each stage's gradients (rank s holds stage s's)
    within 1e-5 of the largest of ``jax.grad``'s."""
    for res in port:
        np.testing.assert_allclose(res["pipe_out"], ref["pipe_out"],
                                   **PIPE_TOL)
        np.testing.assert_allclose(res["pipe_loss"], ref["pipe_loss"],
                                   rtol=1e-5)
    for k in ("w1", "b1", "w2"):
        got = np.stack([res["pipe_g"][k] for res in port])
        want = ref["pipe_g_" + k]
        np.testing.assert_allclose(got, want, rtol=1e-5,
                                   atol=1e-5 * np.abs(want).max())


def _ep_model(idx: np.ndarray, cf: float, E: int, ep: int):
    """The reference's two capacity stages on its routing, per rank: the
    kept mask of each rank's token-major slots at its send buffer, and
    the slots dropped at each rank's experts."""
    T, k = idx.shape
    e_loc = E // ep
    blocks = np.arange(T).reshape(EP_B, ep, EP_S // ep).transpose(1, 0, 2)
    blocks = blocks.reshape(ep, -1)               # rank r's tokens, in order
    TK = blocks.shape[1] * k
    C = max(1, int(TK / ep * cf))
    kept, sent = [], [[] for _ in range(ep)]
    for r in range(ep):
        e = idx[blocks[r]].reshape(-1)
        order = np.argsort(e // e_loc, kind="stable")
        pos = np.zeros(TK, np.int64)
        for dst in range(ep):
            mine = order[(e // e_loc)[order] == dst]
            pos[mine] = np.arange(mine.size)
            sent[dst].append(np.concatenate([
                e[mine[:C]] % e_loc, np.full(C - min(C, mine.size), -1)]))
        kept.append(pos < C)
    N = ep * C
    Ce = max(1, int(N / e_loc * cf))
    dropped2 = []
    for dst in range(ep):
        recv = np.concatenate(sent[dst])
        real = recv[recv >= 0]
        dropped2.append(int(sum(max(0, int((real == e).sum()) - Ce)
                                for e in range(e_loc))))
    return blocks, kept, dropped2


@pytest.mark.parametrize("cf", EP_CFS)
def test_ep_dispatch_matches_reference(ref, port, cf):
    """``_moe_dispatch`` on a (1,4) mesh (``ep_axis`` ("data","model"),
    ``ep_size`` 4): each rank's routing equals the reference's for its
    token block, its kept slots and its dropped slots equal the model of
    the reference's capacity stages, and every rank's gathered output is
    the reference's within the MoE tolerance.  At 4.0 nothing drops; at
    1.0 the send buffers drop."""
    cfg = rconfigs.REGISTRY[DEEPSEEK].smoke_config()
    E = cfg.moe.n_experts
    blocks, kept, dropped2 = _ep_model(ref["ep_idx"], cf, E, RANKS)
    total = 0
    for r, res in enumerate(port):
        ep = res[f"ep_{cf}"]
        np.testing.assert_array_equal(ep["idx"], ref["ep_idx"][blocks[r]])
        np.testing.assert_array_equal(ep["kept"], kept[r])
        assert ep["dropped"] == (int((~kept[r]).sum()), dropped2[r])
        total += sum(ep["dropped"])
        np.testing.assert_allclose(ep["out"], ref[f"ep_{cf}"], **MOE_TOL)
    assert (total > 0) == (cf < 4.0), total


def test_prefill_step_with_a_mesh_takes_expert_parallelism(inputs, port):
    """deepseek smoke's ``make_prefill_step(model, ctx)`` on the (1,4)
    mesh: its one MoE layer runs over 4 expert shards on every rank, and
    the last-position logits equal the step without a mesh (the grouped
    einsum at 4,096 tokens; nothing drops at capacity 4.0) within the
    MoE tolerance."""
    _, data = inputs
    base = convert.config_from_reference(
        rconfigs.REGISTRY[DEEPSEEK].smoke_config())
    with torch.no_grad():
        want = make_prefill_step(build_model(base))(
            _deepseek_params(base),
            {"tokens": torch.from_numpy(data["tokens"]).long()}).numpy()
    for res in port:
        assert res["prefill_shards"] == [RANKS]
        np.testing.assert_allclose(res["prefill"], want, **MOE_TOL)


def test_mesh_blocks_and_groups(inputs, port):
    """A (1,4) mesh: rank r at model r; 'data' is each rank alone,
    'model' and ("data","model") all four in order; ``local_shard`` of
    P("data","model",None) is rank r's quarter of the sequence, and
    ``gather_shards`` puts the whole back."""
    _, data = inputs
    q = EP_S // RANKS
    for r, res in enumerate(port):
        assert res["coords"] == {"data": 0, "model": r}
        assert res["groups"] == {"data": (r,), "model": (0, 1, 2, 3),
                                 ("data", "model"): (0, 1, 2, 3)}
        np.testing.assert_array_equal(res["block"],
                                      data["h"][:, r * q:(r + 1) * q])
        assert res["regathered"]


def _failing_rank(device, bad):
    import torch.distributed as dist

    if dist.get_rank() == bad:
        raise ValueError(f"rank {bad} refuses")
    dist.barrier()
    return dist.get_rank()


def test_run_ranks_fails_with_the_rank_traceback():
    assert run_ranks(_failing_rank, 2, -1, device="cpu") == [0, 1]
    with pytest.raises(RuntimeError, match=r"rank 1 of 2 failed(.|\n)*"
                                           r"ValueError: rank 1 refuses"):
        run_ranks(_failing_rank, 2, 1, device="cpu", timeout=60)
