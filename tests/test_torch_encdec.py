"""The port's encoder-decoder family (whisper-tiny's backbone) against the
reference, on the CPU.

At ``whisper-tiny``'s smoke config the reference draws f32 parameters,
``convert.params_from_reference`` carries them across, and both packages
run the same numpy-seeded tokens and frames, the reference's functions
under ``jax.jit``:

* ``encode`` (and its positions tiled past their rows), ``decode`` and
  ``forward`` logits on ``"xla"`` within 2e-4;
* ``"cuda"`` against the reference's ``"pallas"`` at a text length of
  128 and 256 frames: only the decoder's causal self-attention reaches
  ``kops.flash_attention`` in either package (the encoder's is
  bidirectional, the cross-attention passes no ``impl``); on CPU tensors
  the port runs the kernel's plain version;
* the caches after a cached prefill, teacher-forced ``decode_step(...,
  enc_out=)`` against the full ``decode`` (2e-3, as
  ``tests/test_arch_smoke.py``), ``make_prefill_step`` and
  ``make_decode_step`` with ``enc_out``, the serve loop against the
  reference's encode/decode/decode_step loop;
* ``loss_fn`` (text labels, not padded; bf16 frames promoted to f32) and
  every gradient leaf against ``jax.grad`` with remat on, and three
  ``make_train_step`` steps on the plain route (the kernel route refusing
  grad mode);
* ``init_cache``'s shapes and dtypes, ``params_from_reference`` on the
  encdec tree in bf16, the ``AssertionError`` without frames and the
  ``TypeError`` without ``enc_out``, and the entry points on CUDA.
"""
from __future__ import annotations

import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.kernels import ops as rkops  # noqa: E402
from repro.launch.steps import make_decode_step as ref_decode_step  # noqa: E402
from repro.launch.steps import make_prefill_step as ref_prefill_step  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import encdec as rencdec  # noqa: E402
from repro_torch import convert, optim, tree  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import (make_decode_step,  # noqa: E402
                                      make_prefill_step, make_train_step)
from repro_torch.models import build_model, encdec  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_arch_smoke.py
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)       # tests/test_torch_train.py
WHISPER = "whisper-tiny"
B, S = 2, 16
P, CACHE = 8, 14            # a prompt, and the slots of every cache


@pytest.fixture(scope="module")
def ref():
    """``(reference cfg, port cfg, reference params, port params)`` of the
    smoke config, per ``attn_impl`` and ``remat``: the reference's f32
    params carried across by ``convert``."""
    base = rconfigs.REGISTRY[WHISPER].smoke_config()
    rparams = jax.jit(lambda k: ref_build(base).init(k, jnp.float32))(
        jax.random.PRNGKey(0))
    nparams = jax.tree.map(np.asarray, rparams)
    cache = {}

    def get(impl="xla", remat=False):
        if (impl, remat) not in cache:
            rcfg = base.replace(remat=remat, attn_impl=impl)
            params, pcfg = convert.params_from_reference(nparams, rcfg,
                                                         device="cpu")
            cache[impl, remat] = (rcfg, pcfg, rparams, params)
        return cache[impl, remat]
    return get


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


def _frames(cfg, b, s=None, seed=1):
    s = cfg.frontend_seq if s is None else s
    return (np.random.default_rng(seed).standard_normal(
        (b, s, cfg.d_model)) * 0.02).astype(np.float32)


def _t(a):
    a = torch.from_numpy(np.array(a))
    return a.long() if a.dtype == torch.int32 else a


@functools.cache
def _ref_encode(rcfg):
    return jax.jit(lambda p, f: rencdec.encode(rcfg, p, f))


@functools.cache
def _ref_decode(rcfg):
    """The reference's jitted ``decode`` into caches."""
    return jax.jit(lambda p, t, e, c: rencdec.decode(rcfg, p, t, e,
                                                     caches=c))


@functools.cache
def _ref_step(rcfg):
    """The reference's jitted ``decode_step`` given ``enc_out``."""
    m = ref_build(rcfg)
    return jax.jit(lambda p, t, c, i, e: m.decode_step(p, t, c, i,
                                                       enc_out=e))


@functools.cache
def _ref_forward(rcfg):
    return jax.jit(lambda p, t, f: ref_build(rcfg).forward(
        p, t, extra_embeds=f)[0])


def test_encode_matches_reference(ref):
    rcfg, pcfg, rparams, params = ref()
    f = _frames(rcfg, B)
    want = _ref_encode(rcfg)(rparams, jnp.asarray(f))
    got = encdec.encode(pcfg, params, _t(f))
    assert tuple(got.shape) == (B, rcfg.frontend_seq, rcfg.d_model)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_encode_tiles_positions_past_their_rows(ref):
    """With 16 rows of positions, 40 frames take them three times over,
    as ``jnp.tile`` does in the reference."""
    rcfg, pcfg, rparams, params = ref()
    rp = {**rparams, "enc_pos": rparams["enc_pos"][:16]}
    p = {**params, "enc_pos": params["enc_pos"][:16]}
    f = _frames(rcfg, 1, 40, seed=5)
    want = _ref_encode(rcfg)(rp, jnp.asarray(f))
    got = encdec.encode(pcfg, p, _t(f))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_decode_and_forward_match_reference(ref):
    rcfg, pcfg, rparams, params = ref()
    toks, f = _tokens(rcfg.vocab, B, S), _frames(rcfg, B)
    enc = _ref_encode(rcfg)(rparams, jnp.asarray(f))
    want, none = jax.jit(lambda p, t, e: rencdec.decode(rcfg, p, t, e))(
        rparams, jnp.asarray(toks), enc)
    assert none is None
    got, pnone = encdec.decode(pcfg, params, _t(toks), _t(enc))
    assert pnone is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    # forward: the text's logits only, no frame prefix
    want = _ref_forward(rcfg)(rparams, jnp.asarray(toks), jnp.asarray(f))
    got, _ = build_model(pcfg).forward(params, _t(toks), extra_embeds=_t(f))
    assert got.shape == want.shape == (B, S, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_kernel_route_only_for_the_decoder_self_attention(ref, monkeypatch):
    """Text of 128 tokens and 256 frames, so that each attention's shape
    tells it apart: the decoder's self-attention [128 x 128] causal, the
    encoder's [256 x 256] bidirectional, the cross-attention [128 x 256].
    Only the first reaches the flash wrapper, in both packages (the
    reference's under a trace, so once for its scanned layers), and the
    port's ``"cuda"`` logits equal the reference's ``"pallas"``."""
    rcfg, pcfg, rparams, params = ref("pallas")
    assert pcfg.attn_impl == "cuda"
    seen = {"ref": [], "port": []}

    def counted(side, real):
        def fn(q, k, v, **kw):
            seen[side].append((q.shape[1], k.shape[1], kw.get("causal")))
            return real(q, k, v, **kw)
        return fn

    monkeypatch.setattr(rkops, "flash_attention",
                        counted("ref", rkops.flash_attention))
    monkeypatch.setattr(kops, "flash_attention",
                        counted("port", kops.flash_attention))
    toks, f = _tokens(rcfg.vocab, 1, 128, seed=2), _frames(rcfg, 1, 256)
    want = jax.jit(lambda p, t, f: ref_build(rcfg).forward(
        p, t, extra_embeds=f)[0])(rparams, jnp.asarray(toks), jnp.asarray(f))
    got, _ = build_model(pcfg).forward(params, _t(toks), extra_embeds=_t(f))
    assert seen["port"] == [(128, 128, True)] * pcfg.n_layers
    assert seen["ref"] and set(seen["ref"]) == {(128, 128, True)}
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_cached_prefill_matches_reference(ref):
    """A prompt of 8 decoded into caches of 14 slots through ``forward``:
    logits, every layer's cached K/V and the length as the reference's."""
    rcfg, pcfg, rparams, params = ref()
    toks, f = _tokens(rcfg.vocab, B, P, seed=3), _frames(rcfg, B)
    renc = _ref_encode(rcfg)(rparams, jnp.asarray(f))
    want, rc = _ref_decode(rcfg)(rparams, jnp.asarray(toks), renc,
                                 ref_build(rcfg).init_cache(B, CACHE,
                                                            jnp.float32))
    pm = build_model(pcfg)
    got, pc = pm.forward(params, _t(toks), extra_embeds=_t(f),
                         caches=pm.init_cache(B, CACHE, torch.float32, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    assert pc["len"] == P and set(np.asarray(rc["len"]).tolist()) == {P}
    for k in ("k", "v"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]),
                                   **LOGIT_TOL)


def test_init_cache_matches_reference(ref):
    rcfg, pcfg, _, _ = ref()
    want = ref_build(rcfg).init_cache(3, 20, jnp.bfloat16)
    got = build_model(pcfg).init_cache(3, 20, torch.bfloat16, "cpu")
    assert set(got) == set(want) == {"k", "v", "len"}
    for k in ("k", "v"):
        assert tuple(got[k].shape) == want[k].shape == (
            pcfg.n_layers, 3, 20, pcfg.n_kv_heads, pcfg.hd())
        assert got[k].dtype == torch.bfloat16 and not got[k].any()
    # the reference's stacked int32 lengths are one host integer here
    assert want["len"].shape == (pcfg.n_layers,) and got["len"] == 0


def test_teacher_forced_decode_step_matches_full_decode(ref):
    """``decode`` of 8 tokens into the caches, then 5 ``decode_step``s
    given ``enc_out``, against one full ``decode`` (and each step's
    logits against the reference's step)."""
    rcfg, pcfg, rparams, params = ref()
    n = CACHE - 1
    toks, f = _tokens(rcfg.vocab, B, n, seed=4), _frames(rcfg, B)
    pm, m = build_model(pcfg), ref_build(rcfg)
    enc = encdec.encode(pcfg, params, _t(f))
    full, _ = encdec.decode(pcfg, params, _t(toks), enc)
    caches = pm.init_cache(B, CACHE, torch.float32, "cpu")
    _, caches = encdec.decode(pcfg, params, _t(toks[:, :P]), enc,
                              caches=caches)
    renc = _ref_encode(rcfg)(rparams, jnp.asarray(f))
    _, rc = _ref_decode(rcfg)(rparams, jnp.asarray(toks[:, :P]), renc,
                              m.init_cache(B, CACHE, jnp.float32))
    outs = []
    for i in range(P, n):
        l1, caches = pm.decode_step(params, _t(toks[:, i:i + 1]), caches, i,
                                    enc_out=enc)
        r1, rc = _ref_step(rcfg)(rparams, jnp.asarray(toks[:, i:i + 1]), rc,
                                 i, renc)
        np.testing.assert_allclose(l1.numpy(), np.asarray(r1), **LOGIT_TOL)
        outs.append(l1)
    assert caches["len"] == n
    torch.testing.assert_close(torch.stack(outs, 1), full[:, P:n],
                               **DECODE_TOL)


def test_prefill_and_decode_steps_match_reference(ref):
    """``make_prefill_step`` with ``extra_embeds`` and
    ``make_decode_step`` with ``batch["enc_out"]``, against the
    reference's step functions."""
    rcfg, pcfg, rparams, params = ref()
    toks, f = _tokens(rcfg.vocab, B, S, seed=6), _frames(rcfg, B)
    want = jax.jit(ref_prefill_step(ref_build(rcfg)))(
        rparams, {"tokens": jnp.asarray(toks), "extra_embeds": jnp.asarray(f)})
    got = make_prefill_step(build_model(pcfg))(
        params, {"tokens": _t(toks), "extra_embeds": _t(f)})
    assert tuple(got.shape) == (B, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)

    m, pm = ref_build(rcfg), build_model(pcfg)
    renc = _ref_encode(rcfg)(rparams, jnp.asarray(f))
    enc = encdec.encode(pcfg, params, _t(f))
    _, rc = _ref_decode(rcfg)(rparams, jnp.asarray(toks[:, :P]), renc,
                              m.init_cache(B, CACHE, jnp.float32))
    _, pc = encdec.decode(pcfg, params, _t(toks[:, :P]), enc,
                          caches=pm.init_cache(B, CACHE, torch.float32, "cpu"))
    t1 = toks[:, P:P + 1]
    want, _ = jax.jit(ref_decode_step(m))(
        rparams, rc, {"tokens1": jnp.asarray(t1), "pos": P,
                      "enc_out": renc})
    got, pc = make_decode_step(pm)(
        params, pc, {"tokens1": _t(t1), "pos": P, "enc_out": enc})
    assert pc["len"] == P + 1
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_serve_loop_matches_reference_loop(ref):
    """The port's serve loop on the frames against the reference's
    encode, prompt decode into caches of Lp+G+1 slots and greedy
    ``decode_step(..., enc_out=)`` loop (tests/test_arch_smoke.py)."""
    rcfg, pcfg, rparams, params = ref("pallas")
    G = CACHE - P - 1
    prompts, f = _tokens(rcfg.vocab, B, P, seed=7), _frames(rcfg, B)
    res = serve(pcfg, gen=G, device="cpu", params=params,
                prompts=_t(prompts), frames=_t(f))
    m = ref_build(rcfg)
    renc = _ref_encode(rcfg)(rparams, jnp.asarray(f))
    logits, caches = _ref_decode(rcfg)(rparams, jnp.asarray(prompts), renc,
                                       m.init_cache(B, CACHE, jnp.float32))
    logits = logits[:, -1]
    want_logits, want_toks = [logits], [jnp.argmax(logits, -1)]
    for i in range(G - 1):
        logits, caches = _ref_step(rcfg)(
            rparams, want_toks[-1][:, None].astype(jnp.int32), caches,
            P + i, renc)
        want_logits.append(logits)
        want_toks.append(jnp.argmax(logits, -1))
    np.testing.assert_array_equal(
        res.tokens.numpy(), np.stack([np.asarray(t) for t in want_toks], 1))
    for got, want in zip(res.logits, want_logits, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)


def _train_batch(cfg, seed):
    toks = _tokens(cfg.vocab, 4, S + 1, seed=seed)
    f = _frames(cfg, 4, seed=seed + 1)
    bf = np.asarray(jnp.asarray(f).astype(jnp.bfloat16))
    ref_batch = {"tokens": jnp.asarray(toks[:, :-1]),
                 "labels": jnp.asarray(toks[:, 1:]),
                 "extra_embeds": jnp.asarray(bf)}
    port_batch = {"tokens": _t(toks[:, :-1]), "labels": _t(toks[:, 1:]),
                  "extra_embeds": torch.from_numpy(f).to(torch.bfloat16)}
    return ref_batch, port_batch


def test_loss_and_grads_match_reference(ref):
    """Remat on, bf16 frames (as the data stream emits them) promoted to
    f32 by the f32 positions; the labels cover the text only."""
    rcfg, pcfg, rparams, params = ref(remat=True)
    assert pcfg.remat
    rb, pb = _train_batch(rcfg, seed=8)
    assert torch.equal(pb["extra_embeds"].float(),
                       torch.from_numpy(np.asarray(rb["extra_embeds"],
                                                   np.float32)))
    rloss, rgrads = jax.jit(jax.value_and_grad(
        lambda p: ref_build(rcfg).loss(p, rb)))(rparams)
    flat = [p.detach().clone().requires_grad_() for p in tree.leaves(params)]
    loss = build_model(pcfg).loss(tree.rebuild(params, flat), pb)
    assert loss.dtype == torch.float32
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(rloss), **LOGIT_TOL)
    rflat = jax.tree.leaves(rgrads)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(rgrads)[0]]
    assert len(rflat) == len(grads) and any("xattn" in k for k in paths)
    for path, g, w in zip(paths, grads, rflat, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL,
                                   err_msg=path)


def test_train_step_runs_the_plain_route(ref):
    """``make_train_step`` on ``"xla"``: three steps at text length 128,
    the first step's loss the model's loss, the loss going down; on
    ``"cuda"`` the decoder's kernel route refuses grad mode."""
    rcfg, pcfg, _, params = ref(remat=True)
    params = tree.rebuild(params, [p.clone() for p in tree.leaves(params)])
    opt = optim.AdamWConfig(lr=1e-2, warmup=1, total_steps=10)
    state = optim.init_state(opt, params)
    toks = _t(_tokens(rcfg.vocab, B, 129, seed=10))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:],
             "extra_embeds": _t(_frames(rcfg, B)).to(torch.bfloat16)}
    with pytest.raises(RuntimeError, match="no backward"):
        make_train_step(build_model(pcfg.replace(attn_impl="cuda")), opt)(
            params, state, batch)
    model = build_model(pcfg)
    with torch.no_grad():
        first = model.loss(params, batch)
    step = make_train_step(model, opt)
    losses = [float(step(params, state, batch)[2]) for _ in range(3)]
    assert int(state["step"]) == 3
    np.testing.assert_allclose(losses[0], float(first), rtol=1e-6)
    assert losses[2] < losses[0]


def test_params_from_reference_carries_the_encdec_tree():
    """The reference's bf16 tree (its layout from ``init`` under
    ``jax.eval_shape``) carries across bit for bit; a leaf of the wrong
    shape is named."""
    rcfg = rconfigs.REGISTRY[WHISPER].smoke_config()
    shapes = jax.eval_shape(
        lambda: ref_build(rcfg).init(jax.random.PRNGKey(0), jnp.bfloat16))
    rng = np.random.default_rng(9)
    rtree = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    params, _ = convert.params_from_reference(rtree, rcfg, device="cpu")
    assert set(params) == {"embed", "enc_pos", "ln_enc", "ln_f",
                           "enc_layers", "dec_layers", "unembed"}
    assert set(params["dec_layers"]) == {"ln1", "ln_x", "ln2", "attn",
                                         "xattn", "mlp"}
    assert tuple(params["enc_pos"].shape) == (8192, rcfg.d_model)
    for (path, want), got in zip(
            jax.tree_util.tree_flatten_with_path(rtree)[0],
            tree.leaves(params), strict=True):
        assert got.dtype == torch.bfloat16, path
        np.testing.assert_array_equal(got.view(torch.int16).numpy(),
                                      want.view(np.int16))
    bad = jax.tree.map(lambda a: a, rtree)
    bad["dec_layers"]["xattn"]["wk"] = rtree["dec_layers"]["xattn"]["wk"][
        ..., :8]
    with pytest.raises(ValueError, match="dec_layers/xattn/wk"):
        convert.params_from_reference(bad, rcfg, device="cpu")


def test_missing_frames_and_missing_enc_out_raise_as_the_reference(ref):
    rcfg, pcfg, rparams, params = ref()
    toks = _tokens(rcfg.vocab, 1, 4)
    with pytest.raises(AssertionError, match="enc-dec needs frame embeddings"):
        ref_build(rcfg).forward(rparams, jnp.asarray(toks))
    with pytest.raises(AssertionError, match="enc-dec needs frame embeddings"):
        build_model(pcfg).forward(params, _t(toks))
    rc = ref_build(rcfg).init_cache(1, 8, jnp.float32)
    with pytest.raises(TypeError, match="enc_out"):
        ref_build(rcfg).decode_step(rparams, jnp.asarray(toks[:, :1]), rc, 0)
    pc = build_model(pcfg).init_cache(1, 8, torch.float32, "cpu")
    with pytest.raises(TypeError, match="enc_out"):
        build_model(pcfg).decode_step(params, _t(toks[:, :1]), pc, 0)


def test_entry_points_raise_without_cuda(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = convert.config_from_reference(
        rconfigs.REGISTRY[WHISPER].smoke_config())
    m = build_model(cfg)
    gen = torch.Generator().manual_seed(0)
    for call in (lambda: encdec.init_params(cfg, gen, torch.float32),
                 lambda: m.init(gen, torch.float32),
                 lambda: m.init_cache(2, 16, torch.float32),
                 lambda: serve(cfg, batch=2, prompt_len=8, gen=2)):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            call()
    res = serve(cfg, batch=2, prompt_len=8, gen=3, device="cpu")
    assert tuple(res.tokens.shape) == (2, 3)
    assert bool(((res.tokens >= 0) & (res.tokens < cfg.vocab)).all())
