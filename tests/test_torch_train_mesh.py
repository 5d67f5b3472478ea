"""The port's train step under a mesh of more than one rank against the
reference's sharded step, on the CPU.

One reference subprocess with four host devices (``Auto`` mesh axes: the
reference's ``make_debug_mesh`` builds ``Explicit`` ones, on which its
``with_sharding_constraint`` raises) jits ``make_train_step`` with the
shardings of ``dryrun.build_cell`` (``param_specs``,
``opt_state_specs(zero=True)``, ``batch_specs``), and
``jax.value_and_grad(model.loss)`` once; its ``apply_updates`` is wrapped
to hand out the gradient each step updates with.  One ``run_ranks`` of
4 forked gloo ranks runs the port's step at the same time, each rank
holding the params whole but for the expert stacks of the
expert-parallel region, which it holds as its slice.  Every input is drawn from one NumPy seed.  The cases:

* llama3.2-1b smoke on a (4,1) mesh, B=8 S=32, with ``-1`` labels spread
  unevenly over the ranks' rows (one rank's rows all ``-1``); the same at
  ``microbatches=2``;
* deepseek-v3-671b smoke on a (2,2) mesh at ``ep_threshold=64`` (B=2
  S=64: the expert-parallel region over ``("data", "model")``, one
  expert a rank), at capacity factor 4.0 (drop-free) and 1.0 (dropping);
* granite-moe-1b-a400m smoke on a (2,2) mesh, B=4 S=32, at capacity
  1.25 (its full config's own; the smoke config's 4.0 drops nothing):
  the einsum form on the experts held whole, on a data block of 64
  tokens that is not a whole number of the global batch's one group of
  128, so each rank gathers both blocks, runs the reference's group and
  keeps its rows; its params after the steps held against the same
  steps on one rank of the port.

Each holds the loss within rtol 1e-5 at each of 2 steps and every
gradient leaf within 1e-5 of its largest absolute value at the first
(the params after an AdamW step would hide a gradient counted twice: the
first update is close to ``lr * sign(g)``), the second step's and the
params after the steps as the test says why.  For deepseek the routing
of each rank's tokens and the slots dropped at its send buffer and at
its expert are byte-identical to a NumPy model of the reference's
capacity stages on the reference's routing.  A global expert stack
under a training mesh is refused.
"""
from __future__ import annotations

import dataclasses
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
from repro_torch.models import ParallelCtx, build_model, transformer  # noqa: E402
from repro_torch.parallel.sharding import P, local_shard  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
RANKS = 4
STEPS = 2
OPT = dict(lr=1e-2, warmup=1, total_steps=10)
LOSS_RTOL = 1e-5
GRAD_TOL = 1e-5                 # of the leaf's largest absolute value
GRAD_TOL_LATER = 1e-4           # the second step's (see the test)
BF16_STEP = 2.0 ** -7           # one bf16 rounding step, relative
UPDATE_RTOL = 1e-4              # of the norm of a leaf's update
LLAMA, DEEPSEEK = "llama3.2-1b", "deepseek-v3-671b"
GRANITE = "granite-moe-1b-a400m"
EXPERT_SPEC = P(None, ("data", "model"), None, None)
CASES = {
    "llama": dict(arch=LLAMA, mesh=(4, 1), B=8, S=32, mb=1, vg=True),
    "llama_mb2": dict(arch=LLAMA, mesh=(4, 1), B=8, S=32, mb=2),
    "deepseek_cf4": dict(arch=DEEPSEEK, mesh=(2, 2), B=2, S=64, cf=4.0,
                         ep_threshold=64),
    "deepseek_cf1": dict(arch=DEEPSEEK, mesh=(2, 2), B=2, S=64, cf=1.0,
                         ep_threshold=64),
    # one_rank: the params after the steps held against the port's own
    # steps on one rank (no mesh), see the test
    "granite_cf": dict(arch=GRANITE, mesh=(2, 2), B=4, S=32, cf=1.25,
                       one_rank=True),
}
ONE_RANK = [name for name, case in CASES.items() if case.get("one_rank")]


def _sliced(case: dict) -> bool:
    """Whether the case's MoE layers take the expert-parallel region,
    whose expert stacks a rank holds as its slice."""
    return "ep_threshold" in case


def _rcfg(case: dict):
    cfg = rconfigs.REGISTRY[case["arch"]].smoke_config()
    if "cf" in case:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["cf"],
            ep_threshold=case.get("ep_threshold", cfg.moe.ep_threshold)))
    return cfg


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
    """Params of each arch (f32, the reference's layout) and each case's
    batches, from one seed.  ``-1`` labels: llama's rank 0 has 40 of its
    64, rank 1 one, rank 2 none, rank 3 all; in the second microbatch
    split the pattern lands on other ranks."""
    rng = np.random.default_rng(31)
    out = {}

    def draw_params(arch):
        cfg = rconfigs.REGISTRY[arch].smoke_config()
        shapes = jax.eval_shape(lambda: ref_build(cfg).init(
            jax.random.PRNGKey(0), jax.numpy.float32))
        for path, sds in _flat(shapes).items():
            shape = tuple(sds.shape)
            x = (rng.standard_normal(shape) / np.sqrt(shape[-2])
                 if len(shape) >= 2 else 1 + 0.1 * rng.standard_normal(shape))
            out[f"{arch}:{path}"] = x.astype(np.float32)

    for arch in (LLAMA, DEEPSEEK):
        draw_params(arch)
    for name, case in CASES.items():
        vocab = rconfigs.REGISTRY[case["arch"]].smoke_config().vocab
        B, S = case["B"], case["S"]
        for step in range(STEPS):
            toks = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
            labels = toks[:, 1:].copy()
            if B == 8:
                labels[0, :] = -1
                labels[1, 24:] = -1
                labels[3, 5] = -1
                labels[6:, :] = -1
            else:
                labels[0, 3:40] = -1
            out[f"{name}:{step}:tokens"] = toks[:, :-1].copy()
            out[f"{name}:{step}:labels"] = labels
    # last, so that the other cases' draws stay as they were
    draw_params(GRANITE)
    return out


def _params(data: dict, arch: str) -> dict:
    return _nest({k.split(":", 1)[1]: v for k, v in data.items()
                  if k.startswith(arch + ":")})


def _batch(data: dict, name: str, step: int) -> dict:
    return {k: data[f"{name}:{step}:{k}"] for k in ("tokens", "labels")}


REFERENCE = """
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import dataclasses, json
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import AxisType
from repro import configs
from repro.launch import steps as rsteps
from repro.models import build_model, transformer
from repro.models.layers import mla_apply, rmsnorm
from repro.optim import AdamWConfig, init_state
from repro.parallel.sharding import (batch_specs, opt_state_specs,
                                     param_specs, to_named)

inp = dict(np.load(sys.argv[1]))
opt = json.loads(sys.argv[3])
out = {}


def nest(arch):
    tree = {}
    for key, v in inp.items():
        if not key.startswith(arch + ":"):
            continue
        *head, last = key.split(":", 1)[1].split("/")
        d = tree
        for k in head:
            d = d.setdefault(k, {})
        d[last] = jnp.asarray(v)
    return tree


def flat(tree, prefix):
    if isinstance(tree, dict):
        for k in sorted(tree):
            flat(tree[k], f"{prefix}/{k}")
    else:
        out[prefix] = np.asarray(tree).astype(np.float32)


orig = rsteps.apply_updates


def capturing(cfg, params, grads, state):
    p, s = orig(cfg, params, grads, state)
    return p, {**s, "grads": grads}


rsteps.apply_updates = capturing
for name, case in opt["cases"].items():
    cfg = configs.REGISTRY[case["arch"]].smoke_config()
    if "cf" in case:
        cfg = cfg.replace(moe=dataclasses.replace(
            cfg.moe, capacity_factor=case["cf"],
            ep_threshold=case.get("ep_threshold", cfg.moe.ep_threshold)))
    mesh = jax.make_mesh(tuple(case["mesh"]), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    model = build_model(cfg)
    params = nest(case["arch"])
    ocfg = AdamWConfig(**opt["opt"])
    state = init_state(ocfg, params)
    ctx = transformer.ParallelCtx(ep_axis="model",
                                  ep_size=mesh.shape["model"], mesh=mesh,
                                  dp_spec="data")
    pspecs = param_specs(params, mesh)
    ospecs = opt_state_specs(state, pspecs, mesh, zero=True)
    batch = {k: jnp.asarray(inp[f"{name}:0:{k}"])
             for k in ("tokens", "labels")}
    bspecs = batch_specs(batch, mesh)
    shard = (to_named(pspecs, mesh), to_named(ospecs, mesh),
             to_named(bspecs, mesh))
    if case.get("vg"):
        loss, grads = jax.jit(
            jax.value_and_grad(lambda p, b: model.loss(p, b, ctx)),
            in_shardings=(shard[0], shard[2]))(
                *jax.device_put((params, batch), (shard[0], shard[2])))
        out[f"{name}:vg:loss"] = np.asarray(loss)
        flat(grads, f"{name}:vg:grad")
    step = jax.jit(rsteps.make_train_step(model, ocfg, ctx,
                                          microbatches=case.get("mb", 1)),
                   in_shardings=shard)
    for i in range(opt["steps"]):
        batch = {k: jnp.asarray(inp[f"{name}:{i}:{k}"])
                 for k in ("tokens", "labels")}
        params, state, batch = jax.device_put((params, state, batch), shard)
        params, state, loss = step(params, state, batch)
        grads = state.pop("grads")
        out[f"{name}:{i}:loss"] = np.asarray(loss)
        flat(grads, f"{name}:{i}:grad")
    flat(params, f"{name}:params")
    if "ep_threshold" in case:
        # the routing at the MoE layer's input (the first step's params,
        # no mesh): embed, the dense layer, the MoE layer's attention
        p0 = nest(case["arch"])

        def moe_input(p, tokens):
            S = tokens.shape[1]
            pos = jnp.arange(S)
            nctx = transformer.ParallelCtx()
            x = p["embed"][tokens]
            x, _ = transformer._block(
                cfg, jax.tree.map(lambda a: a[0], p["layers"]), x, pos,
                None, False, nctx)
            lp = jax.tree.map(lambda a: a[0], p["moe_layers"])
            a, _ = mla_apply(lp["attn"], rmsnorm(lp["ln1"], x, cfg.rms_eps),
                             cfg, positions=pos, cache=None, ctx=nctx)
            h = rmsnorm(lp["ln2"], x + a, cfg.rms_eps)
            xt = h.reshape(-1, h.shape[-1]).astype(jnp.float32)
            probs = jax.nn.softmax(xt @ lp["moe"]["router"], axis=-1)
            return jax.lax.top_k(probs, cfg.moe.top_k)[1]

        out[f"{name}:idx"] = np.asarray(jax.jit(moe_input)(
            p0, jnp.asarray(inp[f"{name}:0:tokens"])))
np.savez(sys.argv[2], **out)
"""


@pytest.fixture(scope="module")
def inputs(tmp_path_factory):
    path = tmp_path_factory.mktemp("train_mesh") / "inputs.npz"
    data = _inputs()
    np.savez(path, **data)
    return path, data


@pytest.fixture(scope="module")
def ref_run(inputs):
    """The reference's steps on four host devices, in a subprocess that
    works while the port's ranks run (its output to a file)."""
    in_path, _ = inputs
    out_path = in_path.with_name("reference.npz")
    opt = json.dumps({"cases": CASES, "steps": STEPS, "opt": OPT})
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


def _held(params: dict, mesh) -> dict:
    """``params`` as a rank holds them under a training mesh: the expert
    stacks cut to the rank's slice (copies), every other leaf whole."""
    moe = params.get("moe_layers", {}).get("moe")
    if moe is not None:
        for k in ("wg", "wu", "wd"):
            moe[k] = local_shard(moe[k], EXPERT_SPEC, mesh).clone()
    return params


def _rank(device, data):
    """One rank: each case's steps, the gradient each updates with, the
    params after them, and (deepseek) the first forward's routing; a
    ``one_rank`` case's steps also with no mesh."""
    torch.set_num_threads(1)
    meshes = {shape: Mesh(shape, ("data", "model"), device=device)
              for shape in sorted({tuple(c["mesh"]) for c in CASES.values()})}
    res = {}
    captured = []
    orig_update = steps.apply_updates

    def capturing(cfg, params, grads, state, **kw):
        captured.append([g.float().numpy() for g in leaves(grads)])
        return orig_update(cfg, params, grads, state, **kw)

    orig_ep = transformer.moe_ep_apply
    routing = []

    def recording(*a, **kw):
        rec = {}
        out = orig_ep(*a, stats=rec, **kw)
        routing.append({"idx": rec["idx"].numpy(),
                        "kept": rec["kept"].numpy(),
                        "dropped": rec["dropped"]})
        return out

    def run(name, case, mesh):
        params, pcfg = convert.params_from_reference(
            _params(data, case["arch"]), _rcfg(case), device="cpu")
        if mesh is None:
            ctx = ParallelCtx()
        else:
            if _sliced(case):
                params = _held(params, mesh)
            ctx = ParallelCtx(ep_axis="model", ep_size=mesh.shape["model"],
                              mesh=mesh, dp_spec="data")
        model = build_model(pcfg)
        ocfg = optim.AdamWConfig(**OPT)
        state = optim.init_state(ocfg, params)
        batches = [{k: torch.from_numpy(v).long()
                    for k, v in _batch(data, name, i).items()}
                   for i in range(STEPS)]
        r = {}
        if case.get("vg"):
            loss, grads = steps.value_and_grad(model, params, batches[0],
                                               ctx)
            r["vg"] = (float(loss), [g.numpy() for g in leaves(grads)])
        step = steps.make_train_step(model, ocfg, ctx,
                                     microbatches=case.get("mb", 1))
        captured.clear()
        routing.clear()
        r["losses"] = []
        for b in batches:
            params, state, loss = step(params, state, b)
            r["losses"].append(float(loss))
        r["grads"] = list(captured)
        r["params"] = [p.numpy() for p in leaves(params)]
        r["routing"] = routing[0] if routing else None
        return r

    steps.apply_updates = capturing
    transformer.moe_ep_apply = recording
    try:
        for name, case in CASES.items():
            res[name] = run(name, case, meshes[tuple(case["mesh"])])
            if case.get("one_rank"):
                res[name]["one_rank"] = run(name, case, None)
    finally:
        steps.apply_updates = orig_update
        transformer.moe_ep_apply = orig_ep
    return res


@pytest.fixture(scope="module")
def port(inputs):
    _, data = inputs
    return run_ranks(_rank, RANKS, data, device="cpu", backend="gloo",
                     timeout=240)


def _want_leaves(ref: dict, key: str, rank: int, case: dict) -> list:
    """The reference's leaves under ``key`` in flatten order, an expert
    stack cut to ``rank``'s slice."""
    prefix = f"{key}/"
    names = sorted(k for k in ref if k.startswith(prefix))
    out = []
    for k in names:
        w = ref[k]
        if _sliced(case) and k.endswith(("/moe/wg", "/moe/wu", "/moe/wd")):
            n = w.shape[1] // RANKS
            w = w[:, rank * n:(rank + 1) * n]
        out.append(w)
    return out


def _close_grads(got: list, want: list, what: str, tol: float):
    assert len(got) == len(want), what
    for i, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape, (what, i, g.shape, w.shape)
        np.testing.assert_allclose(g, w, rtol=0,
                                   atol=tol * np.abs(w).max(),
                                   err_msg=f"{what} leaf {i}")


@pytest.mark.parametrize("name", ONE_RANK)
def test_einsum_train_step_under_a_mesh_matches_one_rank(inputs, port, name):
    """The params after the einsum form's steps under a mesh, on every
    rank, within ``UPDATE_RTOL`` of the update's norm from the same steps
    on one rank of the port.  Not the reference's params: the port's one
    rank is already 2.3e-4 of the update away from those in ``moe/wg``,
    as AdamW's ``m / sqrt(v)`` turns the packages' rounding in near-zero
    gradients into up to ``lr``; the loss and the gradients are held
    against the reference's sharded step in
    ``test_train_step_under_a_mesh_matches_reference``."""
    _, data = inputs
    start = [np.asarray(v) for v in leaves(convert.params_from_reference(
        _params(data, CASES[name]["arch"]), _rcfg(CASES[name]),
        device="cpu")[0])]
    for r, res in enumerate(port):
        got, want = res[name], res[name]["one_rank"]
        for j, (g, w, p0) in enumerate(zip(got["params"], want["params"],
                                           start, strict=True)):
            gap = np.linalg.norm(g - w) / np.linalg.norm(w - p0)
            assert gap <= UPDATE_RTOL, (name, r, j, gap)


@pytest.mark.parametrize("name", list(CASES))
def test_train_step_under_a_mesh_matches_reference(inputs, ref, port, name):
    """The loss at each step within ``LOSS_RTOL``; every gradient leaf of
    the first step (both packages start from the same params) within
    ``GRAD_TOL`` of its largest value, and of the second within
    ``GRAD_TOL_LATER``; the params after the steps with each leaf's gap
    within ``UPDATE_RTOL`` of its update's norm.  The second step starts
    from params that already differ by the first update's rounding, which
    AdamW's ``m / sqrt(v)`` turns into up to ``lr`` in an element whose
    gradient is near zero: hence the looser second step, and the params
    held in the norm (as ``chip_smoke.py``'s ``TRAIN_STATE_RTOL`` holds
    them; a ``one_rank`` case's against the port's one rank, in
    ``test_einsum_train_step_under_a_mesh_matches_one_rank``).  At ``microbatches=2`` the gradient that updates is the
    reference's bf16 accumulation, which rounds each element at the scale
    of its microbatch terms: where the packages' f32 terms straddle a
    rounding boundary an element moves by a bf16 step of those terms, so
    its leaves are held within ``BF16_STEP`` of their largest value (the
    loss, and the labels spread unevenly over the microbatches, hold the
    split)."""
    case = CASES[name]
    _, data = inputs
    bf16 = case.get("mb", 1) > 1
    for r, res in enumerate(port):
        got = res[name]
        for i in range(STEPS):
            np.testing.assert_allclose(got["losses"][i],
                                       ref[f"{name}:{i}:loss"],
                                       rtol=LOSS_RTOL)
            _close_grads(got["grads"][i],
                         _want_leaves(ref, f"{name}:{i}:grad", r, case),
                         f"{name} rank {r} step {i}",
                         BF16_STEP if bf16 else
                         GRAD_TOL if i == 0 else GRAD_TOL_LATER)
        if not case.get("one_rank"):    # held against one rank instead
            want = _want_leaves(ref, f"{name}:params", r, case)
            start = _want_leaves({f"p0/{k}": v for k, v in _flat(_params(
                data, case["arch"])).items()}, "p0", r, case)
            assert len(got["params"]) == len(want) == len(start)
            for j, (g, w, p0) in enumerate(zip(got["params"], want,
                                               start)):
                gap = np.linalg.norm(g - w) / np.linalg.norm(w - p0)
                assert gap <= UPDATE_RTOL, (name, r, j, gap)
        if case.get("vg"):
            loss, grads = got["vg"]
            np.testing.assert_allclose(loss, ref[f"{name}:vg:loss"],
                                       rtol=LOSS_RTOL)
            _close_grads(grads, _want_leaves(ref, f"{name}:vg:grad", r, case),
                         f"{name} rank {r} value_and_grad", GRAD_TOL)


def _ep_model(idx: np.ndarray, cf: float, E: int, blocks: np.ndarray):
    """The reference's two capacity stages on its routing ``idx`` [T, k],
    rank ``r`` routing the tokens ``blocks[r]`` in order over an
    expert-parallel axis of ``len(blocks)`` ranks: each rank's kept mask
    of its token-major slots at its send buffer, and its slots dropped
    there and at its experts."""
    ep = len(blocks)
    k = idx.shape[1]
    e_loc = E // ep
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
    Ce = max(1, int(ep * C / e_loc * cf))
    dropped = []
    for r in range(ep):
        recv = np.concatenate(sent[r])
        real = recv[recv >= 0]
        dropped.append((int((~kept[r]).sum()),
                        int(sum(max(0, int((real == e).sum()) - Ce)
                                for e in range(e_loc)))))
    return kept, dropped


@pytest.mark.parametrize("name", ["deepseek_cf4", "deepseek_cf1"])
def test_expert_parallel_routing_and_drops_match_reference(ref, port, name):
    """Rank (d, m) routes batch row block d's sequence block m (the train
    step's data block, cut over 'model' in the region): its routing equals
    the reference's for those tokens, and its kept and dropped slots equal
    the model of the reference's capacity stages.  At 4.0 nothing drops,
    at 1.0 some slots do."""
    case = CASES[name]
    cfg = _rcfg(case)
    B, S = case["B"], case["S"]
    n_data, n_model = case["mesh"]
    tok = np.arange(B * S).reshape(B, S)
    blocks = np.stack([
        tok[d * B // n_data:(d + 1) * B // n_data,
            m * S // n_model:(m + 1) * S // n_model].reshape(-1)
        for d in range(n_data) for m in range(n_model)])
    idx = ref[f"{name}:idx"]
    kept, dropped = _ep_model(idx, case["cf"], cfg.moe.n_experts, blocks)
    for r, res in enumerate(port):
        got = res[name]["routing"]
        np.testing.assert_array_equal(got["idx"], idx[blocks[r]])
        np.testing.assert_array_equal(got["kept"], kept[r])
        assert tuple(got["dropped"]) == dropped[r], (r, got["dropped"])
    total = sum(sum(d) for d in dropped)
    assert (total > 0) == (case["cf"] < 4.0), dropped


def test_a_global_expert_stack_is_refused_under_a_training_mesh():
    """deepseek smoke on a 2x2 dry mesh whose MoE layer takes the
    expert-parallel region: its params with the global ``[L, E, ...]``
    expert stacks are refused, the error naming the leaf; cut to rank 0's
    slice, the step walks."""
    case = CASES["deepseek_cf4"]
    pcfg = convert.config_from_reference(_rcfg(case))
    model = build_model(pcfg)
    mesh = dryrun.DryMesh(case["mesh"], ("data", "model"))
    ocfg = optim.AdamWConfig(**OPT)
    meta = torch.device("meta")
    params = model.init(torch.Generator(), torch.float32, meta)
    batch = {k: torch.empty((case["B"], case["S"]), dtype=torch.int64,
                            device=meta) for k in ("tokens", "labels")}
    step = steps.make_train_step(model, ocfg, ParallelCtx(mesh=mesh,
                                                          dp_spec="data"))
    with pytest.raises(ValueError, match=r"moe/wg: a global stack of 4 "
                                         r"experts under a training mesh"):
        step(params, optim.init_state(ocfg, params), batch)
    params = _held(params, mesh)
    assert params["moe_layers"]["moe"]["wg"].shape[1] == 1
    step(params, optim.init_state(ocfg, params), batch)
