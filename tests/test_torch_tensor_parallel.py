"""The port's tensor-parallel serving steps against the reference's
sharded steps, on the CPU.

One reference subprocess with four host devices (``Auto`` mesh axes: the
reference's ``make_debug_mesh`` builds ``Explicit`` ones, on which its
``with_sharding_constraint`` raises) jits ``make_prefill_step`` and
``make_decode_step`` with the shardings of its dry run (``param_specs``,
``batch_specs``, ``cache_specs_tree``), and a prefill of the prompt into
the caches (its forward with ``caches``) before 3 decode steps.  One
``run_ranks`` of 4 forked gloo ranks runs the port's steps at the same
time, each rank holding its cut (``sharding.held_params``) of
``convert.params_from_reference``, its batch block and its cache block
(``sharding.cache_block``).  Every input is drawn from one NumPy seed;
smoke configs, f32, B=4, S=32.  The cases:

* llama3.2-1b on (1,4): the tied embedding vocab-parallel; its 2 kv heads
  against 'model' 4, so each rank's k/v columns are all-gathered and it
  keeps the one kv head its query head reads;
* llama3.2-1b on (2,2): the heads divide, the batch splits over 'data'
  and the caches are held as blocks;
* internvl2-26b with a vocab of 251 on (2,2): a vocab 'model' does not
  divide (the embedding whole, as at full width), the untied unembedding
  held over ``d`` (partial logits summed), the patch prefix;
* granite-moe-1b-a400m on (2,2), prefill: tensor-parallel attention
  beside the MoE layer (its einsum form on the rank's rows).

The last logits at prefill and at each decode step are held within 2e-5
of the largest absolute logit, each rank's held shapes against the
shapes the reference's specs give its shard, and a train step handed a
sliced leaf raises and names the leaf.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import convert, optim  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.launch.mesh import Mesh, run_ranks  # noqa: E402
from repro_torch.models import ParallelCtx, build_model  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
B, S, STEPS = 4, 32, 3
TOL = 2e-5                      # of the largest absolute logit
LLAMA, VLM, GRANITE = "llama3.2-1b", "internvl2-26b", "granite-moe-1b-a400m"
CASES = {
    "llama_1x4": dict(arch=LLAMA, mesh=(1, 4), decode=True),
    "llama_2x2": dict(arch=LLAMA, mesh=(2, 2), decode=True),
    "internvl_2x2": dict(arch=VLM, mesh=(2, 2), decode=True, vocab=251),
    "granite_2x2": dict(arch=GRANITE, mesh=(2, 2), decode=False),
}


def _rcfg(case: dict):
    cfg = rconfigs.REGISTRY[case["arch"]].smoke_config()
    return cfg.replace(vocab=case["vocab"]) if "vocab" in case else cfg


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        return {k: v for key in sorted(tree)
                for k, v in _flat(tree[key], f"{prefix}{key}/").items()}
    return {prefix[:-1]: tree}


def _nest(flat: dict) -> dict:
    out: dict = {}
    for path, v in flat.items():
        *head, last = path.split("/")
        d = out
        for k in head:
            d = d.setdefault(k, {})
        d[last] = v
    return out


def _inputs() -> dict:
    """Each case's params (f32, the reference's layout), prompt (text
    behind the patch prefix: 32 positions in all) and decode tokens, from
    one seed."""
    rng = np.random.default_rng(32)
    out = {}
    for name, case in CASES.items():
        cfg = _rcfg(case)
        shapes = jax.eval_shape(lambda: ref_build(cfg).init(
            jax.random.PRNGKey(0), jax.numpy.float32))
        for path, sds in _flat(shapes).items():
            shape = tuple(sds.shape)
            x = (rng.standard_normal(shape) / np.sqrt(shape[-2])
                 if len(shape) >= 2 else 1 + 0.1 * rng.standard_normal(shape))
            out[f"{name}:p:{path}"] = x.astype(np.float32)
        P = cfg.frontend_seq
        out[f"{name}:tokens"] = rng.integers(0, cfg.vocab, (B, S - P)
                                             ).astype(np.int32)
        if P:
            out[f"{name}:extra_embeds"] = (0.5 * rng.standard_normal(
                (B, P, cfg.d_model))).astype(np.float32)
        out[f"{name}:tokens1"] = rng.integers(0, cfg.vocab, (STEPS, B, 1)
                                              ).astype(np.int32)
    return out


def _params(data: dict, name: str) -> dict:
    pre = f"{name}:p:"
    return _nest({k[len(pre):]: v for k, v in data.items()
                  if k.startswith(pre)})


def _batch(data: dict, name: str) -> dict:
    return {k: data[f"{name}:{k}"] for k in ("tokens", "extra_embeds")
            if f"{name}:{k}" in data}


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType, NamedSharding, PartitionSpec
from repro import configs
from repro.launch import steps as rsteps
from repro.models import build_model, transformer
from repro.parallel.sharding import (batch_specs, cache_specs_tree,
                                     param_specs, to_named)

inp = dict(np.load(sys.argv[1]))
opt = json.loads(sys.argv[3])
out = {}


def leaf_paths(tree, prefix=""):
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaf_paths(tree[k], f"{prefix}{k}/")
    else:
        yield prefix[:-1], tree


def nest(name):
    tree = {}
    pre = name + ":p:"
    for key, v in inp.items():
        if not key.startswith(pre):
            continue
        *head, last = key[len(pre):].split("/")
        d = tree
        for k in head:
            d = d.setdefault(k, {})
        d[last] = jnp.asarray(v)
    return tree


def shard_shapes(tree, specs, mesh, tag):
    for (path, x), (_, spec) in zip(
            leaf_paths(tree), leaf_paths(jax.tree.map(
                lambda s: {"": s}, specs,
                is_leaf=lambda s: isinstance(s, PartitionSpec)))):
        out[f"{tag}:{path}"] = np.asarray(
            NamedSharding(mesh, spec).shard_shape(x.shape), np.int64)


for name, case in opt["cases"].items():
    cfg = configs.REGISTRY[case["arch"]].smoke_config()
    if "vocab" in case:
        cfg = cfg.replace(vocab=case["vocab"])
    mesh = jax.make_mesh(tuple(case["mesh"]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    model = build_model(cfg)
    ctx = transformer.ParallelCtx(ep_axis="model",
                                  ep_size=mesh.shape["model"], mesh=mesh,
                                  dp_spec="data")
    params = nest(name)
    pspecs = param_specs(params, mesh)
    shard_shapes(params, pspecs, mesh, f"{name}:shard")
    batch = {k: jnp.asarray(inp[f"{name}:{k}"])
             for k in ("tokens", "extra_embeds") if f"{name}:{k}" in inp}
    bspecs = batch_specs(batch, mesh)
    pn, bn = to_named(pspecs, mesh), to_named(bspecs, mesh)
    replicated = NamedSharding(mesh, PartitionSpec())
    prefill = jax.jit(rsteps.make_prefill_step(model, ctx),
                      in_shardings=(pn, bn), out_shardings=replicated)
    params, batch = jax.device_put((params, batch), (pn, bn))
    out[f"{name}:prefill"] = np.asarray(prefill(params, batch))
    if not case["decode"]:
        continue
    total = opt["S"] + opt["steps"] + 1
    caches = model.init_cache(opt["B"], total, jnp.float32)
    cspecs = cache_specs_tree(caches, mesh)
    shard_shapes(caches, cspecs, mesh, f"{name}:cache")
    cn = to_named(cspecs, mesh)

    def cached(p, c, b):
        logits, c = model.forward(p, b["tokens"],
                                  extra_embeds=b.get("extra_embeds"),
                                  caches=c, pos_offset=0, ctx=ctx)
        return logits[:, -1], c

    logits, caches = jax.jit(cached, in_shardings=(pn, cn, bn),
                             out_shardings=(replicated, cn))(
        params, jax.device_put(caches, cn), batch)
    out[f"{name}:cached"] = np.asarray(logits)
    one = {"tokens1": jnp.zeros((opt["B"], 1), jnp.int32),
           "pos": jnp.zeros((), jnp.int32)}
    dn = to_named(batch_specs(one, mesh), mesh)
    decode = jax.jit(rsteps.make_decode_step(model, ctx),
                     in_shardings=(pn, cn, dn),
                     out_shardings=(replicated, cn))
    for i in range(opt["steps"]):
        step = jax.device_put(
            {"tokens1": jnp.asarray(inp[f"{name}:tokens1"][i]),
             "pos": jnp.asarray(opt["S"] + i, jnp.int32)}, dn)
        logits, caches = decode(params, caches, step)
        out[f"{name}:decode:{i}"] = np.asarray(logits)
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("tensor_parallel") / "inputs.npz"
    data = _inputs()
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module")
def ref_run(inputs):
    """The reference's sharded steps on four host devices, in a
    subprocess that works while the port's ranks run."""
    in_path, _ = inputs
    out_path = in_path.with_name("reference.npz")
    opt = json.dumps({"cases": CASES, "B": B, "S": S, "steps": STEPS})
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


def _rank(device, data):
    """One rank: each case's held shapes, its prefill step, and (decode
    cases) its cache block, the prefill into it and 3 decode steps."""
    torch.set_num_threads(1)
    meshes = {shape: Mesh(shape, ("data", "model"), device=device)
              for shape in sorted({tuple(c["mesh"]) for c in CASES.values()})}
    res = {}
    for name, case in CASES.items():
        mesh = meshes[tuple(case["mesh"])]
        whole, cfg = convert.params_from_reference(
            _params(data, name), _rcfg(case), device="cpu")
        params = sharding.held_params(cfg, whole, mesh)
        del whole
        model = build_model(cfg)
        ctx = ParallelCtx(ep_axis="model", ep_size=mesh.shape["model"],
                          mesh=mesh, dp_spec="data")
        batch = {k: torch.from_numpy(v) for k, v in _batch(data,
                                                           name).items()}
        batch["tokens"] = batch["tokens"].long()
        r = {"held": {p: tuple(t.shape) for p, t in zip(
                 sharding._paths(params), leaves(params))},
             "specs": [tuple(s) for s in sharding.held_specs(
                 model, params, mesh, sharding.param_shapes(model))]}
        with torch.no_grad():
            r["prefill"] = steps.make_prefill_step(model, ctx)(
                params, batch).numpy()
            if case["decode"]:
                caches = sharding.cache_block(model, B, S + STEPS + 1,
                                              torch.float32, "cpu", mesh)
                r["cache"] = tuple(caches["dense"]["k"].shape)
                logits, caches = steps.make_cache_prefill_step(model, ctx)(
                    params, caches, batch)
                r["cached"] = logits.numpy()
                decode = steps.make_decode_step(model, ctx)
                r["decode"] = []
                for i in range(STEPS):
                    tok = torch.from_numpy(data[f"{name}:tokens1"][i]).long()
                    logits, caches = decode(params, caches,
                                            {"tokens1": tok, "pos": S + i})
                    r["decode"].append(logits.numpy())
        res[name] = r
    return res


@pytest.fixture(scope="module")
def port(inputs):
    _, data = inputs
    return run_ranks(_rank, RANKS, data, device="cpu", backend="gloo",
                     timeout=240)


def _close(got, want, what: str):
    assert got.shape == want.shape, (what, got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=TOL * np.abs(want).max(), err_msg=what)


@pytest.mark.parametrize("name", list(CASES))
def test_serving_steps_match_the_references_sharded_steps(ref, port, name):
    """Every rank returns the global last-position logits: the prefill
    step's, the prefill into its cache block's and each decode step's,
    within ``TOL`` of the reference's sharded steps."""
    case = CASES[name]
    for r, res in enumerate(port):
        got = res[name]
        _close(got["prefill"], ref[f"{name}:prefill"],
               f"{name} rank {r} prefill")
        if not case["decode"]:
            continue
        _close(got["cached"], ref[f"{name}:cached"],
               f"{name} rank {r} prefill into the caches")
        for i in range(STEPS):
            _close(got["decode"][i], ref[f"{name}:decode:{i}"],
                   f"{name} rank {r} decode step {i}")


@pytest.mark.parametrize("name", list(CASES))
def test_held_shapes_are_the_references_shards(inputs, ref, port, name):
    """A leaf the rank holds as a block has the shape of the reference's
    shard under ``param_specs`` (its spec over 'model'), and ``held_specs``
    reads that spec back; every other leaf is whole.  In llama3.2-1b every
    attention, MLP and vocabulary leaf is a block; in internvl2-26b the
    embedding, whose 251 rows 'model' does not divide, is whole and the
    unembedding a block of ``d``.  The cache block holds the reference's
    rows of the batch and the kv heads the rank's attention reads (one,
    where the reference cuts the head dim)."""
    _, data = inputs
    case = CASES[name]
    cfg = convert.config_from_reference(_rcfg(case))
    whole = {p: tuple(v.shape) for p, v in _flat(_params(data, name)).items()}
    for r, res in enumerate(port):
        held, specs = res[name]["held"], res[name]["specs"]
        assert list(held) == sorted(whole)
        cut = set()
        for (path, shape), spec in zip(held.items(), specs):
            if spec:
                cut.add(path)
                assert shape == tuple(ref[f"{name}:shard:{path}"]), path
                assert "model" in spec and "data" not in spec, (path, spec)
            else:
                assert shape == whole[path], path
        tp = {p for p in whole if sharding._TP_LEAF.search(p)}
        if case["arch"] == LLAMA:
            assert cut == tp
        elif case["arch"] == VLM:
            assert cut == tp - {"embed"} and "unembed" in cut
        else:
            assert cut == tp and not any("moe/" in p for p in cut)
        if case["decode"]:
            rows = tuple(ref[f"{name}:cache:dense/k"])
            m = case["mesh"][1]
            heads = cfg.n_kv_heads // m if cfg.n_kv_heads % m == 0 else 1
            assert res[name]["cache"] == (cfg.n_layers, rows[1], S + STEPS + 1,
                                          heads, cfg.hd()), r


def test_a_train_step_refuses_a_sliced_leaf():
    """A train step handed the held tree of tensor-parallel serving (on a
    2x2 stand-in mesh, on ``meta``) raises and names the first sliced leaf;
    the whole tree steps."""
    cfg = convert.config_from_reference(
        rconfigs.REGISTRY[LLAMA].smoke_config())
    mesh = dryrun.DryMesh((2, 2), ("data", "model"))
    model = build_model(cfg)
    opt = optim.AdamWConfig()
    meta = torch.device("meta")
    whole = model.init(torch.Generator(), torch.float32, meta)
    held = sharding.held_params(cfg, whole, mesh)
    batch = {k: torch.empty((4, 32), dtype=torch.int64, device=meta)
             for k in ("tokens", "labels")}
    step = steps.make_train_step(model, opt, ParallelCtx(mesh=mesh,
                                                         dp_spec="data"))
    with pytest.raises(ValueError, match=r"^embed: held as its "
                                         r"tensor-parallel block \(128, 64\)"):
        step(held, optim.init_state(opt, held), batch)
    held["embed"] = whole["embed"]
    with pytest.raises(ValueError, match=r"^layers/attn/wk: held as its "
                                         r"tensor-parallel block"):
        step(held, optim.init_state(opt, held), batch)
    step(whole, optim.init_state(opt, whole), batch)


@pytest.mark.parametrize("name", ["llama_1x4", "internvl_2x2"])
def test_init_with_a_mesh_draws_the_held_tree(name):
    """``model.init(..., mesh=)`` cuts each leaf as it is drawn: for every
    rank of the mesh, bit for bit the held tree of the whole draw from
    the same seed."""
    case = CASES[name]
    cfg = convert.config_from_reference(_rcfg(case))
    model = build_model(cfg)
    whole = model.init(torch.Generator().manual_seed(7), torch.float32,
                       "cpu")
    mesh = dryrun.DryMesh(case["mesh"], ("data", "model"))
    for rank in range(RANKS):
        mesh.coords = dict(zip(mesh.axis_names, np.unravel_index(
            rank, case["mesh"])))
        want = sharding.held_params(cfg, whole, mesh)
        got = model.init(torch.Generator().manual_seed(7), torch.float32,
                         "cpu", mesh=mesh)
        assert sharding._paths(got) == sharding._paths(want)
        for g, w in zip(leaves(got), leaves(want)):
            assert torch.equal(g, w)
        assert any(g.shape != w.shape
                   for g, w in zip(leaves(got), leaves(whole)))
