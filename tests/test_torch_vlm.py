"""The port's multimodal-prefix family against the reference, on the CPU.

internvl2-26b's smoke config (2 layers, d 64, head dim 16, an 8-embedding
patch prefix): the reference draws f32 parameters, and
``convert.params_from_reference`` carries them across bit for bit.  The
prefix is ``extra_embeds`` drawn with NumPy from a seed, as
``configs.input_specs`` shapes it and ``tests/test_arch_smoke.py`` feeds
it.  Both packages run the same inputs; the reference's functions run
under ``jax.jit``, one compile a function and shape:

* the forward over prefix and text, on the plain route and on the
  kernel route (the flash branch taken once a layer in both packages);
* ``make_prefill_step``;
* the prefix and a prompt prefilled into the caches, then teacher-forced
  decode at ``pos = P + Lp + i`` against the reference's ``decode_step``
  and the full forward; a position short by the prefix is caught;
* the loss with the labels padded by -1 over the prefix (its value);
* ``input_specs``/``cache_specs`` for every arch and shape, on ``meta``;
* ``serve(..., extra_embeds=)`` against a loop over the reference's
  functions;
* ``attention_core`` on the kernel route at G = 6, D = 128 against the
  reference's Pallas kernel in interpret mode.
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
from repro.launch.steps import make_prefill_step as ref_prefill_step  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402
from repro_torch.tree import leaves  # noqa: E402

#: tests/test_kernels.py's f32 TOL
TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_arch_smoke.py
VLM = "internvl2-26b"
B, S = 2, 12                                 # batch, text tokens


@pytest.fixture(scope="module")
def model():
    """``(reference cfg, reference params, port params, port cfg)`` for
    ``impl``: the reference's f32 smoke parameters, drawn once, and the
    port's copy of them."""
    rcfg = rconfigs.REGISTRY[VLM].smoke_config().replace(remat=False)
    jparams = ref_build(rcfg).init(jax.random.PRNGKey(0), jnp.float32)
    nparams = jax.tree.map(np.asarray, jparams)

    def get(impl="xla"):
        r = rcfg.replace(attn_impl=impl)
        params, pcfg = convert.params_from_reference(nparams, r, device="cpu")
        return r, jparams, params, pcfg
    return get


def _tokens(vocab, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (b, s)
                                                ).astype(np.int32)


def _prefix(cfg, b, seed=1):
    return 0.02 * np.random.default_rng(seed).standard_normal(
        (b, cfg.frontend_seq, cfg.d_model)).astype(np.float32)


def _t(x):
    return torch.from_numpy(x).long() if x.dtype == np.int32 \
        else torch.from_numpy(x)


@functools.cache
def _ref_forward(rcfg):
    return jax.jit(lambda p, t, e: ref_build(rcfg).forward(
        p, t, extra_embeds=e)[0])


@functools.cache
def _ref_prefill(rcfg):
    """The reference's prefix prefill into caches, jitted."""
    return jax.jit(lambda p, t, e, c: ref_build(rcfg).forward(
        p, t, extra_embeds=e, caches=c, pos_offset=0))


@functools.cache
def _ref_decode(rcfg):
    return jax.jit(lambda p, t, c, pos: ref_build(rcfg).decode_step(
        p, t, c, pos))


def test_params_from_reference_bit_for_bit(model):
    rcfg, jparams, params, pcfg = model()
    want = jax.tree.leaves(jax.tree.map(np.asarray, jparams))
    got = leaves(params)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and np.array_equal(
            g.numpy().view(np.int32), w.view(np.int32))
    assert pcfg.frontend == "patch_stub" and pcfg.frontend_seq == 8


def test_build_model_takes_the_decoder_family():
    """internvl2-26b builds as the reference builds it: the decoder, its
    frontend a prefix.  At full width its parameters on ``meta`` count
    ``n_params()`` and the norms; cut to 4 of 48 layers, as the card's
    phase runs it."""
    cfg = configs.get_config(VLM)
    for n_layers, want in ((48, 19_861_260_288), (4, 2_697_627_648)):
        c = cfg.replace(n_layers=n_layers)
        params = build_model(c).init(torch.Generator(), torch.float32,
                                     device="meta")
        assert all(t.is_meta for t in leaves(params))
        norms = (2 * n_layers + 1) * c.d_model
        assert sum(t.numel() for t in leaves(params)) == want
        assert c.n_params() + norms == want


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_forward_with_prefix_matches_reference(model, impl, monkeypatch):
    """Logits over prefix and text.  On the kernel route, text of 120
    tokens behind the 8 patches makes 128 positions, so each layer's
    attention takes the flash branch: once a layer in both packages."""
    rcfg, jparams, params, pcfg = model(impl)
    s = 120 if impl == "pallas" else S
    toks, pre = _tokens(rcfg.vocab, B, s), _prefix(rcfg, B)
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got, _ = build_model(pcfg).forward(params, _t(toks),
                                       extra_embeds=_t(pre))
    want = _ref_forward(rcfg)(jparams, jnp.asarray(toks), jnp.asarray(pre))
    P = rcfg.frontend_seq
    assert tuple(got.shape) == want.shape == (B, P + s, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert len(calls) == (rcfg.n_layers if impl == "pallas" else 0)


def test_prefill_step_matches_reference(model):
    rcfg, jparams, params, pcfg = model()
    toks, pre = _tokens(rcfg.vocab, B, S, seed=2), _prefix(rcfg, B, seed=2)
    want = jax.jit(ref_prefill_step(ref_build(rcfg)))(
        jparams, {"tokens": jnp.asarray(toks),
                  "extra_embeds": jnp.asarray(pre)})
    got = make_prefill_step(build_model(pcfg))(
        params, {"tokens": _t(toks), "extra_embeds": _t(pre)})
    assert tuple(got.shape) == (B, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_prefix_prefill_then_teacher_forced_decode(model):
    """The prefix and ``Lp`` prompt tokens prefilled into caches of ``P +
    S + 1`` slots, then the rest of the text one token a step at ``pos =
    P + Lp + i``: each step against the reference's ``decode_step`` at the
    same position (TOL) and against the full forward (DECODE_TOL); cache
    lengths identical.  A step at ``Lp + i``, short by the prefix, leaves
    the full forward."""
    rcfg, jparams, params, pcfg = model()
    P, Lp = rcfg.frontend_seq, 5
    toks, pre = _tokens(rcfg.vocab, B, S, seed=3), _prefix(rcfg, B, seed=3)
    m = build_model(pcfg)
    full, _ = m.forward(params, _t(toks), extra_embeds=_t(pre))
    caches = m.init_cache(B, P + S + 1, torch.float32, "cpu")
    logits, caches = m.forward(params, _t(toks[:, :Lp]),
                               extra_embeds=_t(pre), caches=caches)
    rm = ref_build(rcfg)
    rlogits, rcaches = _ref_prefill(rcfg)(
        jparams, jnp.asarray(toks[:, :Lp]), jnp.asarray(pre),
        rm.init_cache(B, P + S + 1, jnp.float32))
    np.testing.assert_allclose(logits.numpy(), np.asarray(rlogits), **TOL)
    assert caches["dense"]["len"] == P + Lp
    assert set(np.asarray(rcaches["dense"]["len"]).tolist()) == {P + Lp}
    wrong = {k: v.clone() if isinstance(v, torch.Tensor) else v
             for k, v in caches["dense"].items()}
    step_pos = [P + Lp + i for i in range(S - Lp)]
    outs = []
    for i, pos in enumerate(step_pos):
        t1 = toks[:, Lp + i:Lp + i + 1]
        got, caches = m.decode_step(params, _t(t1), caches, pos)
        want, rcaches = _ref_decode(rcfg)(jparams, jnp.asarray(t1), rcaches,
                                          pos)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        outs.append(got)
    assert caches["dense"]["len"] == P + S
    assert set(np.asarray(rcaches["dense"]["len"]).tolist()) == {P + S}
    np.testing.assert_allclose(torch.stack(outs, 1).numpy(),
                               full[:, P + Lp:].numpy(), **DECODE_TOL)
    # the trap: a position that forgets the prefix hides slots from the
    # query and ropes it wrong
    short, _ = m.decode_step(params, _t(toks[:, Lp:Lp + 1]),
                             {"dense": wrong}, Lp)
    assert float((short - full[:, P + Lp]).abs().max()) > DECODE_TOL["atol"]


def test_loss_value_with_prefix_labels(model):
    """The loss pads the labels with -1 over the prefix (its value; the
    slice serves, no gradient is taken)."""
    rcfg, jparams, params, pcfg = model()
    toks, pre = _tokens(rcfg.vocab, B, S, seed=4), _prefix(rcfg, B, seed=4)
    labels = np.roll(toks, -1, axis=1)
    labels[:, -1] = -1
    want = jax.jit(ref_build(rcfg).loss)(jparams, {
        "tokens": jnp.asarray(toks), "labels": jnp.asarray(labels),
        "extra_embeds": jnp.asarray(pre)})
    with torch.no_grad():
        got = build_model(pcfg).loss(params, {
            "tokens": _t(toks), "labels": _t(labels),
            "extra_embeds": _t(pre)})
    np.testing.assert_allclose(float(got), float(want), **TOL)


def _same_specs(got, want, path=""):
    """Every leaf of ``got`` on ``meta`` with ``want``'s shape and dtype;
    a host ``len`` stands for the reference's int32 lengths."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and set(got) == set(want), path
        for k in want:
            _same_specs(got[k], want[k], f"{path}/{k}")
        return
    if isinstance(got, int):
        assert path.endswith("len") and got == 0 and want.dtype == jnp.int32
        return
    assert got.is_meta, path
    assert tuple(got.shape) == tuple(want.shape), path
    assert str(got.dtype).split(".")[1] == jnp.dtype(want.dtype).name, path


@pytest.mark.parametrize("name", sorted(rconfigs.REGISTRY))
def test_input_and_cache_specs_match_reference(name):
    """``input_specs`` and ``cache_specs`` of every shape against the
    reference's ``ShapeDtypeStruct``s, with nothing allocated."""
    cfg = configs.get_config(name)
    for shape in configs.SHAPES:
        want = rconfigs.input_specs(rconfigs.REGISTRY[name], shape)
        got = configs.input_specs(cfg, shape)
        _same_specs(got, want)
        _same_specs(configs.cache_specs(cfg, shape),
                    rconfigs.cache_specs(rconfigs.REGISTRY[name], shape))
    if cfg.frontend != "none":
        # the prefix and the text fill the shape's sequence
        spec = configs.input_specs(cfg, "prefill_32k")
        assert tuple(spec["extra_embeds"].shape) == (32, cfg.frontend_seq,
                                                     cfg.d_model)
        assert spec["tokens"].shape[1] + cfg.frontend_seq == 32768


def test_serve_with_prefix_matches_reference_loop(model):
    """``serve(..., extra_embeds=)`` against the reference's functions in
    serve.py's loop, with the prefix in front of the prompt: tokens
    identical, each step's logits within TOL.  Without ``extra_embeds``
    the prefix is drawn from the seed."""
    rcfg, jparams, params, pcfg = model()
    P, Lp, G = rcfg.frontend_seq, 6, 5
    prompts, pre = _tokens(rcfg.vocab, B, Lp, seed=5), _prefix(rcfg, B, 5)
    res = serve(pcfg, gen=G, device="cpu", params=params,
                prompts=_t(prompts), extra_embeds=_t(pre))
    rm = ref_build(rcfg)
    logits, caches = _ref_prefill(rcfg)(
        jparams, jnp.asarray(prompts), jnp.asarray(pre),
        rm.init_cache(B, P + Lp + G + 1, jnp.float32))
    logits = logits[:, -1]
    want_logits, want_toks = [logits], [jnp.argmax(logits, -1)]
    for i in range(G - 1):
        logits, caches = _ref_decode(rcfg)(
            jparams, want_toks[-1][:, None].astype(jnp.int32), caches,
            P + Lp + i)
        want_logits.append(logits)
        want_toks.append(jnp.argmax(logits, -1))
    assert np.array_equal(res.tokens.numpy(),
                          np.stack([np.asarray(t) for t in want_toks], 1))
    for g, w in zip(res.logits, want_logits, strict=True):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **TOL)
    drawn = [serve(pcfg, gen=2, device="cpu", params=params,
                   prompts=_t(prompts), seed=9) for _ in range(2)]
    assert torch.equal(drawn[0].tokens, drawn[1].tokens)
    assert not torch.equal(drawn[0].logits[0], res.logits[0])
    # an encoder-decoder arch takes its frames as frames, not as a prefix
    whisper = configs.get_config("whisper-tiny").smoke_config()
    with pytest.raises(ValueError, match="takes frames"):
        serve(whisper, batch=1, prompt_len=4, gen=2, device="cpu",
              extra_embeds=torch.zeros((1, whisper.frontend_seq,
                                        whisper.d_model)))


def test_attention_core_kernel_route_g6_d128(monkeypatch):
    """``attention_core`` on the kernel route (``"cuda"``; on CPU tensors
    the flash wrapper's plain version) at internvl2-26b's head ratio, G =
    6, and head dim 128, against the reference's Pallas kernel in
    interpret mode (``"pallas"``)."""
    rng = np.random.default_rng(6)
    Sa, H, Hkv, D = 256, 12, 2, 128
    q, k, v = (rng.standard_normal((1, Sa, h, D)).astype(np.float32)
               for h in (H, Hkv, Hkv))
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    got = layers.attention_core(*(torch.from_numpy(x) for x in (q, k, v)),
                                causal=True, impl="cuda")
    want = rlayers.attention_core(*(jnp.asarray(x) for x in (q, k, v)),
                                  causal=True, impl="pallas")
    assert calls == [1]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
