"""The port's dry run (``launch/dryrun.py``) against the reference's, on
the CPU.

* ``run_cell(..., save=False)`` on each family's smoke config at a 2x2
  stand-in mesh, at shapes cut to a smoke size: serving cells walk the
  card's route (each hand-written kernel one op), the expert-parallel
  cell's collectives are recorded, train cells walk rank 0's step (the
  plain route, its block of the batch) and record the gradient
  exchange's all-reduce.
* ``memory.by_specs`` for llama3.2-1b and deepseek-v3-671b at both
  production meshes, byte for byte against the per-rank bytes of the
  reference's own ``param_specs``/``opt_state_specs``/``batch_specs`` on
  ``jax.eval_shape`` shapes (the reference on ``AbstractMesh``es).
* ``applicable``'s skips with the reference's reasons, llama3.2-1b's
  full-width train cell on the 512-rank stand-in, ``main()``'s exit code
  and summary, a dry group refusing a CPU tensor, and a train step on a
  two-rank data-parallel stand-in exchanging the whole gradient.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AbstractMesh, PartitionSpec  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro import optim as roptim  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.parallel import sharding as rsh  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.configs import ShapeSpec  # noqa: E402
from repro_torch.launch import dryrun, steps  # noqa: E402
from repro_torch.models import ParallelCtx, build_model  # noqa: E402
from repro_torch.parallel import collectives  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

#: the four shapes cut to a smoke size (prefill: 4,096 tokens, the
#: deepseek smoke config's expert-parallel threshold)
SMOKE_SHAPES = {
    "train_4k": ShapeSpec("train_4k", 128, 4, "train"),
    "prefill_32k": ShapeSpec("prefill_32k", 1024, 4, "prefill"),
    "decode_32k": ShapeSpec("decode_32k", 256, 4, "decode"),
    "long_500k": ShapeSpec("long_500k", 512, 1, "decode"),
}
FAMILIES = ("llama3.2-1b", "granite-moe-1b-a400m", "deepseek-v3-671b",
            "rwkv6-1.6b", "zamba2-7b", "whisper-tiny", "internvl2-26b")


@pytest.fixture
def smoke(monkeypatch):
    """Smoke configs (head dim 64, and whisper's 128 frames, so attention
    takes the flash route), smoke shapes and a 2x2 (data, model) stand-in
    mesh."""
    def smoke_config(name):
        cfg = configs.REGISTRY[name].smoke_config().replace(head_dim=64)
        return cfg.replace(frontend_seq=128) if cfg.encdec else cfg

    monkeypatch.setattr(dryrun, "get_config", smoke_config)
    monkeypatch.setattr(dryrun, "SHAPES", SMOKE_SHAPES)
    monkeypatch.setattr(dryrun, "make_dry_mesh", lambda multi_pod=False:
                        dryrun.DryMesh((2, 2), ("data", "model")))


def _values(cfg) -> int:
    """The values in ``cfg``'s parameter tree (its gradient's)."""
    params = build_model(cfg).init(torch.Generator(), torch.float32,
                                   device="meta")
    return sum(t.numel() for t in leaves(params))


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_walks_each_family_at_a_stand_in_mesh(smoke, arch):
    cfg = dryrun.get_config(arch)
    for shape, sspec in SMOKE_SHAPES.items():
        rec = dryrun.run_cell(arch, shape, False, save=False)
        ok, why = configs.applicable(cfg, shape)
        if not ok:
            assert (rec["status"], rec["reason"]) == ("skipped", why)
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        oc = rec["op_cost"]
        assert rec["cost"] == {"flops": oc["flops"],
                               "bytes_accessed": oc["bytes_accessed"]}
        assert oc["flops"] > 0 and oc["launches"] > 0
        mem = rec["memory"]
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        if sspec.kind == "train":
            assert 0 < mem["by_specs"]["total"] < mem["argument_bytes"]
        else:
            # a serving cell holds its params by their specs (the decoder
            # family's), which may leave nothing between the two
            assert 0 < mem["by_specs"]["total"] <= mem["argument_bytes"]
        if sspec.kind == "prefill":
            kernel = {"rwkv6-1.6b": "wkv6", "zamba2-7b": "ssd"}.get(
                arch, "flash_attention_hm")
            # deepseek's MLA takes the plain attention (head dims 24/16);
            # whisper's encoder and cross-attention take none
            if arch != "deepseek-v3-671b":
                assert oc["kernels"].get(kernel, 0) > 0, oc["kernels"]
        else:
            # decode and train: the plain steps
            assert oc["kernels"] == {}
        coll = rec["collectives"]["bytes"]
        if sspec.kind == "train":
            # every gradient leaf summed over 'data' in f32, the loss's
            # two scalars: no expert-parallel region at these 512 tokens
            assert mem["by_specs"]["opt_state"] > 0
            assert rec["collectives"]["counts"].get("all-to-all", 0) == 0
            assert coll["all-reduce"] == 4 * _values(cfg) + 8, coll
        elif arch == "deepseek-v3-671b" and sspec.kind == "prefill":
            # the expert-parallel region: three all-to-alls over the 4
            # ranks, the block all-gathered over data then model
            assert rec["collectives"]["counts"]["all-to-all"] == 3 * (
                cfg.n_layers - cfg.n_dense_layers)
            assert coll["all-gather"] > 0
        else:
            # a serving step: the logits of the rank's rows gathered over
            # 'data' (its bf16 [B/2, V] at the last position), and in the
            # decoder family the row-parallel sums over 'model' (each
            # layer's attention and dense MLP, the vocab-parallel
            # embedding's lookup and an untied unembedding's partial
            # logits: deepseek's MLA layers hold their attention whole,
            # and its MoE layer no dense MLP)
            counts = rec["collectives"]["counts"]
            assert counts["all-to-all"] == 0
            B = sspec.global_batch
            assert coll["all-gather"] >= B // 2 * cfg.vocab * 2
            tp = arch in ("llama3.2-1b", "granite-moe-1b-a400m",
                          "internvl2-26b", "deepseek-v3-671b")
            moe = (cfg.n_layers - cfg.n_dense_layers) if cfg.moe else 0
            want = (cfg.n_layers * (1 if cfg.mla else 2) - moe + 1
                    + (not cfg.tie_embeddings) if tp else 0)
            assert counts["all-reduce"] == want, (counts, want)


def _ref_bytes(shapes, specs, mesh) -> int:
    """Per-rank bytes of the reference's shapes under its specs."""
    total = 0

    def one(spec, sds):
        nonlocal total
        n = np.dtype(sds.dtype).itemsize
        entries = tuple(spec) + (None,) * (len(sds.shape) - len(spec))
        for dim, entry in zip(sds.shape, entries):
            axes = () if entry is None else (
                entry if isinstance(entry, tuple) else (entry,))
            n *= dim // int(np.prod([mesh.shape[a] for a in axes]))
        total += n

    jax.tree.map(one, specs, shapes,
                 is_leaf=lambda x: isinstance(x, PartitionSpec))
    return total


@pytest.mark.parametrize("arch", ["llama3.2-1b", "deepseek-v3-671b"])
def test_by_specs_equal_the_references_spec_bytes(arch):
    rcfg = rconfigs.REGISTRY[arch]
    rparams = jax.eval_shape(lambda: ref_build(rcfg).init(
        jax.random.PRNGKey(0), jnp.bfloat16))
    for multi_pod in (False, True):
        mesh = dryrun.make_dry_mesh(multi_pod)
        rmesh = AbstractMesh(tuple(mesh.shape.values()), mesh.axis_names)
        got = dryrun.build_cell(arch, "train_4k", mesh)[3]
        bits = 8 if rcfg.n_params() * 10 / mesh.size > \
            dryrun.MOMENT_BUDGET else 32
        ropt = roptim.AdamWConfig(state_bits=bits)
        rstate = jax.eval_shape(lambda: roptim.init_state(ropt, rparams))
        rps = rsh.param_specs(rparams, rmesh)
        rin = rconfigs.input_specs(rcfg, "train_4k")
        want = {
            "params": _ref_bytes(rparams, rps, rmesh),
            "opt_state": _ref_bytes(
                rstate, rsh.opt_state_specs(rstate, rps, rmesh, zero=True),
                rmesh),
            "batch": _ref_bytes(rin, rsh.batch_specs(rin, rmesh), rmesh),
        }
        want["total"] = sum(want.values())
        assert got == want, (arch, multi_pod)


def test_applicable_skips_with_the_references_reasons():
    for arch in sorted(rconfigs.REGISTRY):
        ok, why = rconfigs.applicable(rconfigs.REGISTRY[arch], "long_500k")
        if ok:
            continue
        rec = dryrun.run_cell(arch, "long_500k", False, save=False)
        assert (rec["status"], rec["reason"]) == ("skipped", why)
    assert {a for a in rconfigs.REGISTRY
            if rconfigs.applicable(rconfigs.REGISTRY[a], "long_500k")[0]} == {
        a for a in configs.REGISTRY
        if configs.applicable(configs.REGISTRY[a], "long_500k")[0]}


def test_train_cell_is_not_ported_with_the_reason(monkeypatch):
    """Once refused as not ported, llama3.2-1b's train cell on the
    512-rank stand-in now walks rank 0's step: its block of 8 of the 256
    rows, and every gradient leaf exchanged over ("pod", "data") in f32
    (the loss's two scalars beside them).  The sequence is cut to 1,024
    (the direct attention, not the chunked loop's many ops), which moves
    no exchanged byte."""
    monkeypatch.setitem(dryrun.SHAPES, "train_4k",
                        ShapeSpec("train_4k", 1024, 256, "train"))
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", True, save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["n_devices"] == 512 and rec["op_cost"]["flops"] > 0
    assert set(rec["memory"]["by_specs"]) == {"params", "opt_state",
                                              "batch", "total"}
    cfg = configs.get_config("llama3.2-1b")
    assert rec["collectives"]["bytes"]["all-reduce"] == 4 * _values(cfg) + 8
    assert rec["collectives"]["counts"]["all-reduce"] == len(leaves(
        build_model(cfg).init(torch.Generator(), torch.float32,
                              device="meta"))) + 2


def test_main_exit_code_and_records(smoke, monkeypatch, tmp_path, capsys):
    monkeypatch.setattr(dryrun, "ART", tmp_path)
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape",
                        "decode_32k"]) == 0
    assert [p.name for p in tmp_path.iterdir()] == [
        "llama3.2-1b__decode_32k__pod16x16.json"]
    out = capsys.readouterr().out
    assert "ok=1 skipped=0 not_ported=0 error=0" in out

    def broken(*args, **kwargs):
        raise RuntimeError("a broken cell")

    monkeypatch.setattr(dryrun, "build_cell", broken)
    assert dryrun.main(["--arch", "llama3.2-1b", "--shape", "decode_32k",
                        "--multi-pod", "--tag", "t"]) == 1
    assert "error=1" in capsys.readouterr().out
    assert (tmp_path / "llama3.2-1b__decode_32k__pod2x16x16__t.json").exists()


def test_dry_group_refuses_a_cpu_tensor():
    mesh = dryrun.DryMesh((2, 2), ("data", "model"))
    group = mesh.group(("data", "model"))
    assert (group.size, group.index, group.ranks) == (4, 0, (0, 1, 2, 3))
    assert mesh.group("model").ranks == (0, 1)
    assert mesh.group("data").ranks == (0, 2)
    x = torch.zeros((4, 3))
    for fn in (collectives.all_to_all, collectives.all_gather,
               collectives.psum, collectives.pmax):
        with pytest.raises(ValueError, match="takes meta tensors"):
            fn(x, group)
    with pytest.raises(ValueError, match="takes meta tensors"):
        collectives.ppermute(x, group, [(0, 1)])
    assert collectives.all_gather(x.to("meta"), group).shape == (4, 4, 3)
    with pytest.raises(KeyError, match="mesh order"):
        mesh.group(("model", "data"))


def test_train_step_refuses_a_two_rank_mesh():
    """Once refused, a train step on a two-rank data-parallel stand-in
    (``DryMesh((2, 1))``) now walks on ``meta``: rank 0 takes its 2 of the
    4 rows, and the exchange all-reduces the whole unsharded gradient, in
    f32, beside the loss's two scalars (its label count and its value)."""
    from repro_torch.launch.op_cost import op_cost

    cfg = configs.get_config("llama3.2-1b").smoke_config()
    mesh = dryrun.DryMesh((2, 1), ("data", "model"))
    model, opt = build_model(cfg), optim.AdamWConfig()
    meta = torch.device("meta")
    params = model.init(torch.Generator(), torch.float32, meta)
    batch = {k: torch.empty((4, 32), dtype=torch.int64, device=meta)
             for k in ("tokens", "labels")}
    seen = []
    loss = model.loss
    model = dataclasses.replace(model, loss=lambda p, b, ctx: (
        seen.append(b["tokens"].shape), loss(p, b, ctx))[1])
    step = steps.make_train_step(model, opt, ParallelCtx(mesh=mesh),
                                 microbatches=1)
    oc = op_cost(step, params, optim.init_state(opt, params), batch)
    assert seen == [(2, 32)]
    assert oc["collective_bytes"]["all-reduce"] == 4 * _values(cfg) + 8
    assert oc["collective_counts"]["all-reduce"] == len(leaves(params)) + 2
    assert oc["collective_total"] == oc["collective_bytes"]["all-reduce"]


def test_meta_init_draws_nothing():
    """Sizing deepseek-v3-671b's parameters on ``meta`` leaves the
    generator where it was."""
    gen = torch.Generator().manual_seed(5)
    before = gen.get_state()
    cfg = configs.get_config("deepseek-v3-671b")
    params = build_model(cfg).init(gen, torch.bfloat16, device="meta")
    assert torch.equal(gen.get_state(), before)
    assert params["moe_layers"]["moe"]["wg"].shape[:2] == (
        cfg.n_layers - cfg.n_dense_layers, cfg.moe.n_experts)


def _bytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in leaves(tree)
               if isinstance(t, torch.Tensor))


@pytest.mark.parametrize("shape", ["prefill_32k", "decode_32k"])
def test_serving_cell_holds_its_params_by_their_specs(shape):
    """llama3.2-1b's serving cells at full size on the 256-rank stand-in:
    rank 0 holds its params as tensor-parallel serving cuts them, within
    1% of ``by_specs``' params (byte for byte here: every leaf's spec cuts
    over 'model' only), and the walk records one all-reduce of the rank's
    ``[B/16, S, d]`` bf16 activations for each row-parallel sum (each
    layer's attention and MLP, the vocab-parallel embedding's lookup).
    ``argument_bytes`` is those params, the global batch and the rank's
    cache block (its 8 of 128 rows and the one kv head its two query heads
    read, twice ``by_specs``' caches, which cut the head dim instead)."""
    mesh = dryrun.make_dry_mesh(False)
    cfg, _, args, by_specs = dryrun.build_cell("llama3.2-1b", shape, mesh)
    held = _bytes(args[0])
    assert abs(held - by_specs["params"]) <= 0.01 * by_specs["params"]
    assert held == by_specs["params"]
    rec = dryrun.run_cell("llama3.2-1b", shape, False, save=False)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["memory"]["argument_bytes"] == sum(_bytes(a) for a in args)
    sspec = dryrun.SHAPES[shape]
    S = 1 if sspec.kind == "decode" else sspec.seq_len
    rows = sspec.global_batch // mesh.shape["data"]
    coll = rec["collectives"]
    assert coll["counts"]["all-reduce"] == 2 * cfg.n_layers + 1
    assert coll["bytes"]["all-reduce"] == (2 * cfg.n_layers + 1) * (
        rows * S * cfg.d_model * 2)
    if sspec.kind == "decode":
        cache = args[1]["dense"]["k"]
        assert tuple(cache.shape) == (cfg.n_layers, rows, sspec.seq_len, 1,
                                      cfg.hd())
        assert _bytes(args[1]) == 2 * by_specs["caches"]
