"""The port's dry run (``launch/dryrun.py``) against the reference's, on
the CPU.

* ``run_cell(..., save=False)`` on each family's smoke config at a 2x2
  stand-in mesh, at shapes cut to a smoke size: serving cells walk the
  card's route (each hand-written kernel one op), the expert-parallel
  cell's collectives are recorded, train cells are ``not_ported``.
* ``memory.by_specs`` for llama3.2-1b and deepseek-v3-671b at both
  production meshes, byte for byte against the per-rank bytes of the
  reference's own ``param_specs``/``opt_state_specs``/``batch_specs`` on
  ``jax.eval_shape`` shapes (the reference on ``AbstractMesh``es).
* ``applicable``'s skips with the reference's reasons, the
  ``not_ported`` train cell, ``main()``'s exit code and summary, a dry
  group refusing a CPU tensor, and ``make_train_step`` refusing a
  two-rank mesh.
"""
from __future__ import annotations

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


@pytest.mark.parametrize("arch", FAMILIES)
def test_run_cell_walks_each_family_at_a_stand_in_mesh(smoke, arch):
    cfg = dryrun.get_config(arch)
    for shape, sspec in SMOKE_SHAPES.items():
        rec = dryrun.run_cell(arch, shape, False, save=False)
        ok, why = configs.applicable(cfg, shape)
        if not ok:
            assert (rec["status"], rec["reason"]) == ("skipped", why)
            continue
        if sspec.kind == "train":
            assert rec["status"] == "not_ported", rec
            assert rec["memory"]["by_specs"]["opt_state"] > 0
            continue
        assert rec["status"] == "ok", rec.get("traceback")
        oc = rec["op_cost"]
        assert rec["cost"] == {"flops": oc["flops"],
                               "bytes_accessed": oc["bytes_accessed"]}
        assert oc["flops"] > 0 and oc["launches"] > 0
        mem = rec["memory"]
        assert mem["peak_bytes"] >= mem["argument_bytes"] > 0
        assert 0 < mem["by_specs"]["total"] < mem["argument_bytes"]
        if sspec.kind == "prefill":
            kernel = {"rwkv6-1.6b": "wkv6", "zamba2-7b": "ssd"}.get(
                arch, "flash_attention_hm")
            # deepseek's MLA takes the plain attention (head dims 24/16);
            # whisper's encoder and cross-attention take none
            if arch != "deepseek-v3-671b":
                assert oc["kernels"].get(kernel, 0) > 0, oc["kernels"]
        else:
            assert oc["kernels"] == {}      # decode: the plain step
        coll = rec["collectives"]["bytes"]
        if arch == "deepseek-v3-671b" and sspec.kind == "prefill":
            # the expert-parallel region: three all-to-alls over the 4
            # ranks, the block all-gathered over data then model
            assert rec["collectives"]["counts"]["all-to-all"] == 3 * (
                cfg.n_layers - cfg.n_dense_layers)
            assert coll["all-gather"] > 0
        else:
            assert rec["collectives"]["total_bytes"] == 0


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
        rec = dryrun.run_cell(arch, "train_4k", multi_pod, save=False)
        assert rec["status"] == "not_ported"
        got = rec["memory"]["by_specs"]
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


def test_train_cell_is_not_ported_with_the_reason():
    rec = dryrun.run_cell("llama3.2-1b", "train_4k", True, save=False)
    assert rec["status"] == "not_ported"
    assert "512 ranks" in rec["reason"] and "ROADMAP" in rec["reason"]
    assert rec["n_devices"] == 512 and "op_cost" not in rec
    assert set(rec["memory"]["by_specs"]) == {"params", "opt_state",
                                              "batch", "total"}


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
    cfg = configs.get_config("llama3.2-1b").smoke_config()
    mesh = dryrun.DryMesh((2, 1), ("data", "model"))
    model, opt = build_model(cfg), optim.AdamWConfig()
    with pytest.raises(NotImplementedError, match="2 ranks is not ported"):
        steps.make_train_step(model, opt, ParallelCtx(mesh=mesh),
                              microbatches=1)
    one = dryrun.DryMesh((1, 1), ("data", "model"))
    assert callable(steps.make_train_step(model, opt, ParallelCtx(mesh=one)))


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
