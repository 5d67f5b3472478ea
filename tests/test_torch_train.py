"""The port's training path against the reference, on the CPU.

The reference draws f32 smoke parameters, ``convert`` carries them (and
the AdamW state) across, and both packages run the same numpy-seeded
batches:

* ``xent`` with ``-1`` labels, and each family's ``loss_fn`` (llama3.2-1b
  also with a modality prefix, whose labels are padded with ``-1``) with
  remat on: the loss within ``LOGIT_TOL`` and every gradient leaf within
  rtol 1e-3 / atol 1e-5 of ``jax.grad``; the unembedding's
  ``autograd.Function`` equal to plain autograd in f32, and its bf16
  cotangent cast against the reference's ``_unembed_bwd``;
* 3 steps of ``make_train_step`` within rtol 1e-4 of the reference's
  jitted step, and ``microbatches=4`` within 5e-3 of the full batch (as
  ``tests/test_substrate.py`` asks of the reference);
* ``SyntheticLM`` batches byte-identical (host split, ``frontend_seq``),
  ``PrefetchPipeline`` order;
* checkpoints: the port's ``arr_<i>.npy`` files byte-identical to the
  reference's for the same state (f32, int8, int32, bf16), a
  reference-written checkpoint restored exactly, the async chain and its
  GC, a snapshot untouched by an in-place update after ``submit``, a
  bf16 restore refused with ``TypeError`` by both;
* the reference's toy trainer, with and without an injected fault,
  through both drivers; ``run_with_backup``; ``launch.train.main`` on the
  CPU.
"""
from __future__ import annotations

import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import checkpoint as rckpt  # noqa: E402
from repro import configs as rconfigs  # noqa: E402
from repro import data as rdata  # noqa: E402
from repro import optim as roptim  # noqa: E402
from repro.launch.steps import make_train_step as ref_train_step  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import transformer as rtransformer  # noqa: E402
from repro.runtime import DriverConfig as RDriverConfig  # noqa: E402
from repro.runtime import TrainDriver as RTrainDriver  # noqa: E402
from repro_torch import checkpoint, convert, data, optim, runtime, tree  # noqa: E402
from repro_torch.launch import train  # noqa: E402
from repro_torch.launch.steps import init_all, make_train_step  # noqa: E402
from repro_torch.models import build_model, transformer  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)
FAMILIES = ("llama3.2-1b", "rwkv6-1.6b", "zamba2-7b")
SEQ = 16


@pytest.fixture(scope="module")
def reference():
    """The reference's f32 smoke parameters per arch (remat on), drawn
    once, with their NumPy copies."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = rconfigs.REGISTRY[name].smoke_config().replace(remat=True)
            params = ref_build(cfg).init(jax.random.PRNGKey(0), jnp.float32)
            cache[name] = (cfg, params, jax.tree.map(np.asarray, params))
        return cache[name]
    return get


def _batch(vocab: int, b: int = 4, s: int = SEQ, seed: int = 0) -> dict:
    toks = np.random.default_rng(seed).integers(
        0, vocab, (b, s + 1)).astype(np.int32)
    return {"tokens": toks[:, :-1].copy(), "labels": toks[:, 1:].copy()}


def _torch(batch: dict) -> dict:
    return {k: torch.from_numpy(np.asarray(v).copy()) for k, v in batch.items()}


def _port(reference, name):
    cfg, _, nparams = reference(name)
    return convert.params_from_reference(nparams, cfg, device="cpu")


def test_xent_matches_reference_with_padding_labels():
    rng = np.random.default_rng(1)
    logits = rng.standard_normal((2, 6, 33)).astype(np.float32) * 3
    labels = rng.integers(0, 33, (2, 6)).astype(np.int32)
    labels[0, :2] = -1
    labels[1, 5] = -1
    want, gwant = jax.value_and_grad(rtransformer.xent)(
        jnp.asarray(logits), jnp.asarray(labels))
    x = torch.from_numpy(logits).requires_grad_(True)
    got = transformer.xent(x, torch.from_numpy(labels))
    (g,) = torch.autograd.grad(got, [x])
    np.testing.assert_allclose(got.item(), float(want), **LOGIT_TOL)
    np.testing.assert_allclose(g.numpy(), np.asarray(gwant), **GRAD_TOL)
    assert not g[0, :2].any() and not g[1, 5].any()
    # every label masked: the mean's denominator is floored at 1
    none = np.full_like(labels, -1)
    assert float(transformer.xent(torch.from_numpy(logits),
                                  torch.from_numpy(none))) == 0.0
    assert float(rtransformer.xent(jnp.asarray(logits),
                                   jnp.asarray(none))) == 0.0


@pytest.mark.parametrize("name,prefix", [
    ("llama3.2-1b", False), ("llama3.2-1b", True), ("rwkv6-1.6b", False),
    ("zamba2-7b", False)])
def test_loss_and_grads_match_reference(reference, name, prefix):
    cfg, rparams, _ = reference(name)
    params, pcfg = _port(reference, name)
    assert pcfg.remat
    batch = _batch(cfg.vocab)
    if prefix:
        emb = np.random.default_rng(2).standard_normal(
            (4, 3, cfg.d_model)).astype(np.float32) * 0.02
        batch["extra_embeds"] = emb
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_build(cfg).loss(p, jax.tree.map(jnp.asarray, batch))))(
            rparams)
    flat = list(tree.leaves(params))
    for p in flat:
        p.requires_grad_(True)
    loss = build_model(pcfg).loss(params, _torch(batch))
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(rloss), **LOGIT_TOL)
    rflat = jax.tree.leaves(rgrads)
    assert len(rflat) == len(grads)
    for g, w in zip(grads, rflat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


def test_unembed_function_matches_autograd_and_the_bf16_cast():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 5, 16)).astype(np.float32)
    w = rng.standard_normal((16, 40)).astype(np.float32) * 0.3
    g = rng.standard_normal((2, 5, 40)).astype(np.float32)
    for transpose in (False, True):
        wt = w.T.copy() if transpose else w
        a = [torch.from_numpy(t.copy()).requires_grad_(True) for t in (x, wt)]
        b = [torch.from_numpy(t.copy()).requires_grad_(True) for t in (x, wt)]
        out = transformer.unembed_mm(a[0], a[1], transpose)
        plain = b[0] @ (b[1].T if transpose else b[1])
        assert torch.equal(out, plain)
        ga = torch.autograd.grad(out, a, torch.from_numpy(g))
        gb = torch.autograd.grad(plain, b, torch.from_numpy(g))
        for u, v in zip(ga, gb):
            torch.testing.assert_close(u, v, rtol=1e-6, atol=1e-6)
        # bf16 weights: the f32 cotangent is cast to bf16 before both
        # products, as the reference's custom VJP does
        wb = jnp.asarray(wt).astype(jnp.bfloat16)
        xb = jnp.asarray(x).astype(jnp.bfloat16)
        rdx, rdw = rtransformer._unembed_bwd(None, transpose, (xb, wb),
                                             jnp.asarray(g))
        tx = torch.from_numpy(x).to(torch.bfloat16).requires_grad_(True)
        tw = torch.from_numpy(wt).to(torch.bfloat16).requires_grad_(True)
        dx, dw = torch.autograd.grad(
            transformer.unembed_mm(tx, tw, transpose), [tx, tw],
            torch.from_numpy(g).to(torch.bfloat16))
        assert dx.dtype == dw.dtype == torch.bfloat16
        for u, v in ((dx, rdx), (dw, rdw)):
            np.testing.assert_allclose(u.float().numpy(),
                                       np.asarray(v.astype(jnp.float32)),
                                       rtol=2e-2, atol=2e-2)


def _ref_state(reference, name, opt_kw):
    cfg, rparams, _ = reference(name)
    rcfg = roptim.AdamWConfig(**opt_kw)
    return cfg, rcfg, rparams, roptim.init_state(rcfg, rparams)


@pytest.mark.parametrize("name", FAMILIES)
def test_train_step_matches_reference_jitted_step(reference, name):
    opt_kw = dict(lr=1e-2, warmup=1, total_steps=10)
    cfg, rcfg, rparams, rstate = _ref_state(reference, name, opt_kw)
    params, pcfg = _port(reference, name)
    state = convert.opt_state_from_reference(
        jax.tree.map(np.asarray, rstate), params)
    rstep = jax.jit(ref_train_step(ref_build(cfg), rcfg))
    step = make_train_step(build_model(pcfg), optim.AdamWConfig(**opt_kw))
    for i in range(3):
        batch = _batch(cfg.vocab, seed=10 + i)
        rparams, rstate, rloss = rstep(rparams, rstate,
                                       jax.tree.map(jnp.asarray, batch))
        params, state, loss = step(params, state, _torch(batch))
        np.testing.assert_allclose(float(loss), float(rloss), rtol=1e-4)
    assert int(state["step"]) == 3


@pytest.mark.parametrize("name", FAMILIES)
def test_microbatched_train_step_matches_full_batch(reference, name):
    pcfg = _port(reference, name)[1]
    model = build_model(pcfg)
    opt_cfg = optim.AdamWConfig(lr=1e-3, warmup=1)
    batch = _torch(_batch(pcfg.vocab, b=8, seed=5))
    runs = []
    for mb in (1, 4):
        p = _port(reference, name)[0]
        st = optim.init_state(opt_cfg, p)
        runs.append(make_train_step(model, opt_cfg, microbatches=mb)(
            p, st, batch))
    (p1, _, l1), (p4, _, l4) = runs
    assert abs(float(l1) - float(l4)) < 5e-3
    for a, b in zip(tree.leaves(p1), tree.leaves(p4)):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=5e-3)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_step_leaves_the_params_out_of_autograd(reference,
                                                      microbatches):
    """A train step updates the caller's params in place but never marks
    them as requiring grad, so a forward of them afterwards (as serving
    runs it, outside ``no_grad``) builds no graph."""
    params, pcfg = _port(reference, "llama3.2-1b")
    model = build_model(pcfg)
    opt_cfg = optim.AdamWConfig(lr=1e-2, warmup=1)
    before = params["embed"].clone()
    step = make_train_step(model, opt_cfg, microbatches=microbatches)
    out, _, _ = step(params, optim.init_state(opt_cfg, params),
                     _torch(_batch(pcfg.vocab)))
    assert out["embed"] is params["embed"]
    assert not torch.equal(params["embed"], before)
    assert not any(p.requires_grad for p in tree.leaves(params))
    logits, _ = model.forward(params, _torch(_batch(pcfg.vocab))["tokens"])
    assert logits.grad_fn is None and not logits.requires_grad


def test_init_all_on_the_cpu():
    cfg = train.tiny_config(rconfigs.REGISTRY["llama3.2-1b"])
    pcfg = convert.config_from_reference(cfg)
    params, state = init_all(build_model(pcfg), optim.AdamWConfig(),
                             torch.Generator().manual_seed(0), torch.float32,
                             device="cpu")
    assert params["embed"].shape == (2048, 128)
    assert state["mv"]["embed"].m.shape == (2048, 128)
    assert int(state["step"]) == 0


def test_batches_byte_identical_to_reference():
    for cfg_kw in (dict(vocab=101, seq_len=32, global_batch=8),
                   dict(vocab=50, seq_len=8, global_batch=4, seed=3,
                        frontend_seq=5, d_model=16)):
        for host in (0, 1):
            ref = rdata.SyntheticLM(rdata.DataConfig(**cfg_kw), host_id=host,
                                    n_hosts=2)
            src = data.SyntheticLM(data.DataConfig(**cfg_kw), host_id=host,
                                   n_hosts=2, device="cpu")
            for step in (0, 7):
                want, got = ref.batch_at(step), src.batch_at(step)
                assert sorted(got) == sorted(want)
                for k in want:
                    w = np.asarray(want[k])
                    g = got[k]
                    if g.dtype == torch.bfloat16:
                        g = g.view(torch.int16).numpy()
                        w = w.view(np.int16)
                    else:
                        g = g.numpy()
                    assert g.dtype == w.dtype and g.shape == w.shape
                    assert g.tobytes() == w.tobytes(), (cfg_kw, host, step, k)
    a = data.SyntheticLM(data.DataConfig(vocab=101, seq_len=32,
                                         global_batch=8), 0, 2, device="cpu")
    b = data.SyntheticLM(data.DataConfig(vocab=101, seq_len=32,
                                         global_batch=8), 1, 2, device="cpu")
    assert a.batch_at(7)["tokens"].shape == (4, 32)
    assert not torch.equal(a.batch_at(7)["tokens"], b.batch_at(7)["tokens"])


def test_prefetch_pipeline_order_and_refill():
    cfg = data.DataConfig(vocab=50, seq_len=8, global_batch=2)
    pipe = data.PrefetchPipeline(data.SyntheticLM(cfg, device="cpu"),
                                 depth=2, start_step=3)
    steps = []
    for _ in range(6):
        s, batch = pipe.get()
        steps.append(s)
        assert batch["tokens"].shape == (2, 8)
        assert torch.equal(batch["tokens"],
                           data.SyntheticLM(cfg, device="cpu").batch_at(s)[
                               "tokens"])
    pipe.close()
    assert steps == list(range(3, 9))


def _state_pair(bits: int):
    """The same params and AdamW state (after one reference step) in both
    packages."""
    tree = {"embed": np.random.default_rng(6).standard_normal(
                (256, 512)).astype(np.float32),
            "layers": {"ln": np.ones((2, 8), np.float32)}}
    rcfg = roptim.AdamWConfig(state_bits=bits)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = roptim.init_state(rcfg, rparams)
    grads = jax.tree.map(lambda a: jnp.asarray(a) * 0.01, tree)
    rparams, rstate = roptim.apply_updates(rcfg, rparams, grads, rstate)
    params = {"embed": torch.from_numpy(np.asarray(rparams["embed"]).copy()),
              "layers": {"ln": torch.from_numpy(
                  np.asarray(rparams["layers"]["ln"]).copy())}}
    state = convert.opt_state_from_reference(
        jax.tree.map(np.asarray, rstate), params)
    return {"params": rparams, "opt": rstate}, {"params": params,
                                                "opt": state}


def _files(d):
    return {p.name: p.read_bytes() for p in sorted(d.glob("arr_*.npy"))}


@pytest.mark.parametrize("bits", [32, 8])
def test_checkpoint_files_byte_identical_and_restored(tmp_path, bits):
    rtree, ptree = _state_pair(bits)
    rd = rckpt.save_sync(tmp_path / "ref", 5, rtree)
    pd = checkpoint.save_sync(tmp_path / "port", 5, ptree)
    # params 2, moments 4 (and 2 scales of the quantized embed), step 1
    assert _files(rd) == _files(pd) and len(_files(pd)) == (
        7 if bits == 32 else 9)
    assert checkpoint.latest_step(tmp_path / "port") == 5
    # the port restores a checkpoint the reference wrote, exactly
    target = jax.tree.map(torch.zeros_like, ptree)
    out = checkpoint.restore(tmp_path / "ref", 5, target)
    for a, b in zip(tree.leaves(out), tree.leaves(ptree)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert isinstance(out["opt"]["mv"]["embed"], optim.MomentState)
    # a partial (manifest-less) later step is ignored
    bad = tmp_path / "port" / "step_00000007"
    bad.mkdir()
    (bad / "arr_0.npy").write_bytes(b"garbage")
    assert checkpoint.latest_step(tmp_path / "port") == 5


def test_bf16_leaf_saved_as_the_reference_and_refused_on_restore(tmp_path):
    x = np.linspace(-2, 2, 12, dtype=np.float32).reshape(3, 4)
    rd = rckpt.save_sync(tmp_path / "ref", 1,
                         {"a": jnp.asarray(x).astype(jnp.bfloat16)})
    pd = checkpoint.save_sync(tmp_path / "port", 1,
                              {"a": torch.from_numpy(x).to(torch.bfloat16)})
    assert _files(rd) == _files(pd)
    import json
    assert json.loads((pd / "manifest.json").read_text())["arrays"][0][
        "dtype"] == "bfloat16"
    with pytest.raises(TypeError):
        rckpt.restore(tmp_path / "ref", 1, {"a": jnp.zeros((3, 4),
                                                           jnp.bfloat16)})
    with pytest.raises(TypeError, match="arr_0.npy holds a bfloat16 leaf"):
        checkpoint.restore(tmp_path / "port", 1,
                           {"a": torch.zeros((3, 4), dtype=torch.bfloat16)})


def test_async_checkpointer_chain_gc_and_snapshot(tmp_path):
    ck = checkpoint.AsyncCheckpointer(tmp_path, keep=2)
    live = torch.zeros(4)
    for s in (0, 1, 2, 3):
        live.fill_(s)
        ck.submit(s, {"x": live})
        live.add_(100)           # an in-place update after the snapshot
    assert ck.wait(60)
    ck.close()
    assert checkpoint.latest_step(tmp_path) == 3
    out = checkpoint.restore(tmp_path, 3, {"x": torch.zeros(4)})
    assert torch.equal(out["x"], torch.full((4,), 3.0))
    kept = sorted(p.name for p in tmp_path.glob("step_*"))
    assert kept == ["step_00000002", "step_00000003"]


def _toy(pkg, tmp_path, fault_hook=None, steps=12):
    """The reference's ``_toy_trainer`` (tests/test_substrate.py), in
    ``pkg``'s terms."""
    if pkg == "ref":
        opt_cfg = roptim.AdamWConfig(lr=1e-2, warmup=2, total_steps=steps)

        def init_fn():
            params = {"w": jnp.ones((4, 4))}
            return params, roptim.init_state(opt_cfg, params)

        @jax.jit
        def step(params, opt_state, batch):
            def loss_fn(p):
                x = batch["tokens"].astype(jnp.float32)
                return jnp.mean((x[:, :4] @ p["w"]) ** 2)
            loss, g = jax.value_and_grad(loss_fn)(params)
            params, opt_state = roptim.apply_updates(opt_cfg, params, g,
                                                     opt_state)
            return params, opt_state, loss

        return RTrainDriver(
            RDriverConfig(total_steps=steps, ckpt_every=4,
                          ckpt_dir=str(tmp_path), max_restarts=3),
            rdata.DataConfig(vocab=17, seq_len=8, global_batch=2), step,
            init_fn, fault_hook=fault_hook)
    opt_cfg = optim.AdamWConfig(lr=1e-2, warmup=2, total_steps=steps)

    def init_fn():
        params = {"w": torch.ones((4, 4))}
        return params, optim.init_state(opt_cfg, params)

    def step(params, opt_state, batch):
        w = params["w"].requires_grad_(True)
        x = batch["tokens"].float()
        loss = torch.mean((x[:, :4] @ w) ** 2)
        (g,) = torch.autograd.grad(loss, [w])
        params, opt_state = optim.apply_updates(opt_cfg, params, {"w": g},
                                                opt_state)
        return params, opt_state, loss.detach()

    return runtime.TrainDriver(
        runtime.DriverConfig(total_steps=steps, ckpt_every=4,
                             ckpt_dir=str(tmp_path), max_restarts=3),
        data.DataConfig(vocab=17, seq_len=8, global_batch=2), step, init_fn,
        fault_hook=fault_hook)


@pytest.mark.parametrize("fault", [False, True])
def test_toy_trainer_through_both_drivers(tmp_path, fault):
    hists = {}
    for pkg in ("ref", "port"):
        fired = {"done": False}

        def hook(step):
            if fault and step == 9 and not fired["done"]:
                fired["done"] = True
                raise RuntimeError("injected node failure")

        drv = _toy(pkg, tmp_path / pkg, fault_hook=hook)
        hists[pkg] = drv.run()
        assert drv.restarts == int(fault)
        latest = (rckpt if pkg == "ref" else checkpoint).latest_step(
            tmp_path / pkg)
        assert latest == 11
    ref, port = hists["ref"], hists["port"]
    assert [h.step for h in port] == [h.step for h in ref]
    np.testing.assert_allclose([h.loss for h in port], [h.loss for h in ref],
                               rtol=1e-5)
    steps = [h.step for h in port]
    if fault:
        # restart restores the step-7 checkpoint: step 8 replays, same loss
        assert steps.count(8) == 2 and steps.count(9) == 1
        l8 = [h.loss for h in port if h.step == 8]
        assert abs(l8[0] - l8[1]) < 1e-6
    else:
        assert steps == list(range(12))


def test_straggler_backup_first_completion_wins():
    def slow():
        time.sleep(2.0)
        return "slow"

    def fast():
        return "fast"

    assert runtime.run_with_backup(slow, deadline_s=0.1, backup=fast) == (
        "fast", "backup")
    assert runtime.run_with_backup(fast, deadline_s=5.0) == ("fast",
                                                             "primary")


def test_train_cli_on_the_cpu(tmp_path, capsys):
    assert train.main(["--device", "cpu", "--width", "tiny", "--arch",
                       "llama3.2-1b", "--steps", "6", "--batch", "4",
                       "--seq", "32", "--lr", "3e-2", "--ckpt-every", "3",
                       "--ckpt-dir", str(tmp_path)]) == 0
    out = capsys.readouterr().out
    assert "arch=llama3.2-1b steps=6 loss" in out and "restarts=0" in out
    assert checkpoint.latest_step(tmp_path) == 5
