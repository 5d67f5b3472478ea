"""The port's MoE and MLA half of the decoder family against the reference,
on the CPU.

Smoke configs of granite-moe-1b-a400m (GQA attention, every layer MoE,
the einsum dispatch) and deepseek-v3-671b (MLA, a dense prefix layer, MoE
layers with a shared expert, the expert-parallel form from 8,192 tokens
on).  The port draws f32 parameters from a seeded generator; both
packages run them on the same numpy-seeded inputs:

* ``mla_apply`` without a cache, and with one in both decode forms
  (absorbed and materialised), outputs and cache within 2e-4;
* ``moe_einsum_apply`` and ``moe_ep_apply`` (T=8192) at the smoke
  capacity factor (drop-free) and at 1.25 with a router biased towards
  one expert, so that tokens are dropped (at ``moe_ep_apply``'s second
  stage): routing indices byte-identical, outputs within 2e-4;
* forward logits with ``"xla"`` on both sides, and granite's with
  ``"pallas"`` against the port's ``"cuda"`` at head dim 64 (so the
  flash route is taken, once a layer); deepseek's
  ``"pallas"`` route raising the reference's ``TypeError`` (MLA hands the
  kernel q/k and v of other head dims) where the port's ``"cuda"`` route
  equals the reference's ``"xla"``;
* ``attention_core``'s shape dispatch, decided before any launch, and
  ``_moe_dispatch``'s choice of form;
* teacher-forced decode against the full forward (2e-3), and the serve
  loop against the reference's loop;
* the loss and every gradient leaf against ``jax.grad`` with remat on,
  the router's and the routed experts' included;
* ``params_from_reference`` with bf16 params and the f32 router.
"""
from __future__ import annotations

import dataclasses
import functools

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import layers as rlayers  # noqa: E402
from repro_torch import convert, tree  # noqa: E402
from repro_torch.kernels import ops as kops  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model, layers, transformer  # noqa: E402

TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_arch_smoke.py
GRAD_TOL = dict(rtol=1e-3, atol=1e-5)       # tests/test_torch_train.py
GRANITE, DEEPSEEK = "granite-moe-1b-a400m", "deepseek-v3-671b"
IMPL = {"xla": "xla", "pallas": "cuda"}


def _np(t):
    return {k: _np(v) if isinstance(v, dict) else v.detach().numpy()
            for k, v in t.items()}


def _jnp(t):
    return jax.tree.map(jnp.asarray, _np(t))


@pytest.fixture(scope="module")
def model():
    """``(reference cfg, port cfg, port params, reference params)`` of a
    smoke config: f32 params drawn by the port, the same values on both
    sides."""
    cache = {}

    def get(name, impl="xla", **kw):
        key = (name, impl, tuple(sorted(kw.items())))
        if key not in cache:
            rcfg = rconfigs.REGISTRY[name].smoke_config().replace(
                remat=False, attn_impl=impl, **kw)
            pcfg = convert.config_from_reference(rcfg)
            params = build_model(pcfg).init(torch.Generator().manual_seed(0),
                                            torch.float32, "cpu")
            cache[key] = (rcfg, pcfg, params, _jnp(params))
        return cache[key]
    return get


def _tokens(vocab, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, vocab, (B, S)
                                                ).astype(np.int32)


@functools.cache
def _ref_forward(rcfg):
    """The reference's jitted forward, one a config (so that tests at one
    config and shape share one compile)."""
    return jax.jit(lambda p, t: ref_build(rcfg).forward(p, t)[0])


# ---------------------------------------------------------------- layers
@pytest.mark.parametrize("absorbed", [True, False])
def test_mla_matches_reference(absorbed):
    """No cache, then a 10-token prefill into a cache and three decode
    steps in the given form; the cache's rows as the reference's."""
    rcfg = rconfigs.REGISTRY[DEEPSEEK].smoke_config()
    cfg = convert.config_from_reference(rcfg)
    p = layers.mla_params(torch.Generator().manual_seed(1), cfg,
                          torch.float32, "cpu")
    jp = _jnp(p)
    B, S, Smax = 2, 16, 24
    x = np.random.default_rng(1).standard_normal(
        (B, S, cfg.d_model)).astype(np.float32)
    ref = jax.jit(lambda p, x, pos, c: rlayers.mla_apply(
        p, x, rcfg, positions=pos, cache=c, absorbed_decode=absorbed))

    want, _ = ref(jp, jnp.asarray(x), jnp.arange(S), None)
    got, none = layers.mla_apply(p, torch.from_numpy(x),
                                 cfg, positions=torch.arange(S))
    assert none is None
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)

    m = cfg.mla
    rc = {"c_kv": jnp.zeros((B, Smax, m.kv_lora_rank)),
          "k_rope": jnp.zeros((B, Smax, m.qk_rope_head_dim)),
          "len": jnp.zeros((), jnp.int32)}
    pc = {"c_kv": torch.zeros((B, Smax, m.kv_lora_rank)),
          "k_rope": torch.zeros((B, Smax, m.qk_rope_head_dim)), "len": 0}
    for lo, hi in ((0, 10), (10, 11), (11, 12), (12, 13)):
        want, rc = ref(jp, jnp.asarray(x[:, lo:hi]), jnp.arange(lo, hi), rc)
        got, pc = layers.mla_apply(p, torch.from_numpy(x[:, lo:hi]), cfg,
                                   positions=torch.arange(lo, hi), cache=pc,
                                   absorbed_decode=absorbed)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
        assert pc["len"] == int(rc["len"]) == hi
    for k in ("c_kv", "k_rope"):
        np.testing.assert_allclose(pc[k].numpy(), np.asarray(rc[k]), **TOL)


def _biased_moe(name, cf, T, d, seed):
    """A smoke MoE layer and tokens; for ``cf`` a router pulled towards
    expert 0 and tokens with a mean along it, so that expert 0 takes
    most tokens and the capacity drops some."""
    rcfg = rconfigs.REGISTRY[name].smoke_config()
    if cf is not None:
        rcfg = rcfg.replace(moe=dataclasses.replace(rcfg.moe,
                                                    capacity_factor=cf))
    cfg = convert.config_from_reference(rcfg)
    p = layers.moe_params(torch.Generator().manual_seed(seed), cfg,
                          torch.float32, "cpu")
    x = np.random.default_rng(seed).standard_normal((T, d)).astype(np.float32)
    if cf is not None:
        p["router"][:, 0] += 0.3
        x += 0.3
    return rcfg, cfg, p, x


def _routing(jp, xt, k):
    """The reference's routing lines (``moe_einsum_apply``/``moe_ep_apply``)."""
    probs = jax.nn.softmax(xt.astype(jnp.float32) @ jp["router"], axis=-1)
    return np.asarray(jax.lax.top_k(probs, k)[1])


@pytest.mark.parametrize("form,cf", [("einsum", None), ("einsum", 1.25),
                                     ("ep", None), ("ep", 1.25)])
def test_moe_layer_matches_reference(form, cf):
    """``moe_einsum_apply`` on granite's smoke layer (B=2, S=512: two
    groups of 512) and ``moe_ep_apply`` on deepseek's (with its shared
    expert; B=2, S=4096, d 64), drop-free at the smoke capacity factor
    (4.0) and dropping at 1.25."""
    name, (B, S) = ((GRANITE, (2, 512)) if form == "einsum"
                    else (DEEPSEEK, (2, 4096)))
    rcfg, cfg, p, x = _biased_moe(name, cf, B * S, 64, seed=3)
    mo = cfg.moe
    jp = _jnp(p)
    if form == "einsum":
        groups, Tg = 2, 512
        cap = max(1, int(Tg * mo.top_k / mo.n_experts * mo.capacity_factor))
        ref_fn, port_fn = rlayers.moe_einsum_apply, layers.moe_einsum_apply
    else:
        groups, Tg = 1, B * S
        C = max(1, int(B * S * mo.top_k * mo.capacity_factor))
        cap = max(1, int(C / mo.n_experts * mo.capacity_factor))
        ref_fn, port_fn = rlayers.moe_ep_apply, layers.moe_ep_apply
        assert C >= B * S * mo.top_k       # the first stage never drops
    xg = x.reshape(groups, Tg, -1)
    idx = layers.route(p["router"], torch.from_numpy(xg), mo.top_k)[1]
    want_idx = _routing(jp, jnp.asarray(xg), mo.top_k)
    np.testing.assert_array_equal(idx.numpy(), want_idx)
    load = max(int((want_idx[g] == e).sum()) for g in range(groups)
               for e in range(mo.n_experts))
    assert (load > cap) == (cf is not None), (load, cap)

    want = jax.jit(lambda p, x: ref_fn(p, x, rcfg))(
        jp, jnp.asarray(x.reshape(B, S, -1)))
    got = port_fn(p, torch.from_numpy(x.reshape(B, S, -1)), cfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_top_k_breaks_ties_as_lax_top_k():
    x = np.array([[0.1, 0.4, 0.4, 0.05, 0.4], [0.2, 0.2, 0.2, 0.2, 0.2]],
                 np.float32)
    vals, idx = layers.top_k(torch.from_numpy(x), 3)
    wvals, widx = jax.lax.top_k(jnp.asarray(x), 3)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(widx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(wvals))


def test_moe_dispatch_takes_the_reference_form(monkeypatch):
    """Without a mesh: ``ep_a2a`` takes the expert-parallel form from
    8,192 tokens on, the grouped einsum below; ``einsum`` always."""
    seen = []
    monkeypatch.setattr(transformer, "moe_ep_apply",
                        lambda p, h, cfg: seen.append("ep"))
    monkeypatch.setattr(transformer, "moe_einsum_apply",
                        lambda p, h, cfg: seen.append("einsum"))
    for name in (DEEPSEEK, GRANITE):
        cfg = convert.config_from_reference(
            rconfigs.REGISTRY[name].smoke_config())
        for S in (8191, 8192):
            transformer._moe_dispatch(cfg, {}, torch.zeros((1, S, 1)))
    assert seen == ["einsum", "ep", "einsum", "einsum"]


def test_attention_core_kernel_route_only_where_the_kernel_covers_it(
        monkeypatch):
    """``impl="cuda"`` hands the flash kernel's wrapper causal
    self-attention with S a multiple of 128 and one head dim for q, k and
    v (a head dim the kernel lacks is the wrapper's to refuse on a card);
    MLA's q/k and v head dims and every other shape take the plain
    algorithms (decided before the kernel is called), and a kernel that
    fails on a shape it was handed raises."""
    calls = []
    real = kops.flash_attention

    def counted(q, k, v, causal=True):
        calls.append(tuple(q.shape))
        return real(q, k, v, causal=causal)

    monkeypatch.setattr(kops, "flash_attention", counted)
    rng = np.random.default_rng(5)
    for dqk, dv, S, kernel in ((64, 64, 128, True), (128, 128, 128, True),
                               (16, 16, 128, True), (24, 16, 128, False),
                               (192, 128, 128, False), (64, 64, 100, False)):
        q, k = (torch.from_numpy(rng.standard_normal((1, S, 4, dqk)).astype(
            np.float32)) for _ in range(2))
        v = torch.from_numpy(rng.standard_normal((1, S, 4, dv)).astype(
            np.float32))
        calls.clear()
        got = layers.attention_core(q, k, v, impl="cuda")
        assert bool(calls) == kernel, (dqk, dv, S)
        assert tuple(got.shape) == (1, S, 4, dv)
        torch.testing.assert_close(
            got, layers.attention_core(q, k, v, impl="xla"), **TOL)

    def broken(q, k, v, causal=True):
        raise RuntimeError("kernel failed")

    monkeypatch.setattr(kops, "flash_attention", broken)
    q = torch.zeros((1, 128, 2, 64))
    with pytest.raises(RuntimeError, match="kernel failed"):
        layers.attention_core(q, q, q, impl="cuda")


# ---------------------------------------------------------------- models
@pytest.mark.parametrize("name,impl,S,kw", [
    (GRANITE, "xla", 32, {}), (DEEPSEEK, "xla", 128, {}),
    (GRANITE, "pallas", 128, {"head_dim": 64}),
], ids=["granite-xla", "deepseek-xla", "granite-cuda-hd64"])
def test_forward_matches_reference(model, monkeypatch, name, impl, S, kw):
    rcfg, pcfg, params, jparams = model(name, impl, **kw)
    assert pcfg.attn_impl == IMPL[impl]
    calls = []
    real = kops.flash_attention
    monkeypatch.setattr(kops, "flash_attention",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    toks = _tokens(rcfg.vocab, 2 if impl == "xla" else 1, S)
    want = _ref_forward(rcfg)(jparams, jnp.asarray(toks))
    got, _ = build_model(pcfg).forward(params, torch.from_numpy(toks).long())
    assert len(calls) == (pcfg.n_layers if kw else 0)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_deepseek_pallas_route_fault_and_the_port_cuda_route(model,
                                                             monkeypatch):
    """The reference's MLA hands its Pallas kernel q/k of head dim nope +
    rope and v of ``v_head_dim``; the kernel shapes its output like q and
    the reshape to ``H * v_head_dim`` raises.  The port's ``"cuda"``
    route sends those shapes to the plain algorithm and equals the
    reference's ``"xla"`` route."""
    rcfg, _, params, jparams = model(DEEPSEEK)
    toks = jnp.asarray(_tokens(rcfg.vocab, 2, 128, seed=4))
    with pytest.raises(TypeError, match="cannot reshape"):
        _ref_forward(rcfg.replace(attn_impl="pallas"))(jparams, toks)
    want = _ref_forward(rcfg)(jparams, toks)
    monkeypatch.setattr(kops, "flash_attention", None)   # never called
    pcfg = convert.config_from_reference(rcfg.replace(attn_impl="pallas"))
    assert pcfg.attn_impl == "cuda"
    got, _ = build_model(pcfg).forward(
        params, torch.from_numpy(np.array(toks)).long())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("name", [GRANITE, DEEPSEEK])
def test_teacher_forced_decode_matches_full_forward(model, name):
    """Drop-free at the smoke capacity factor, so incremental decode equals
    the full forward; caches in both groups (deepseek's MLA latents).  At
    these lengths the ``"cuda"`` route is the plain one too."""
    _, pcfg, params, _ = model(name)
    m = build_model(pcfg)
    B, S, k = 2, 12, 6
    toks = torch.from_numpy(_tokens(pcfg.vocab, B, S, seed=2)).long()
    full, _ = m.forward(params, toks)
    caches = m.init_cache(B, 32, torch.float32, "cpu")
    assert set(caches) == {g for g, *_ in transformer.stacks(pcfg)}
    _, caches = m.forward(params, toks[:, :k], caches=caches, pos_offset=0)
    outs = []
    for i in range(k, S):
        logits1, caches = m.decode_step(params, toks[:, i:i + 1], caches, i)
        outs.append(logits1)
    assert all(c["len"] == S for c in caches.values())
    torch.testing.assert_close(torch.stack(outs, 1), full[:, k:S],
                               **DECODE_TOL)


def test_serve_loop_matches_reference_loop(model):
    """The port's serve loop against the reference's ``serve.py`` loop
    (prefill into caches of Lp+G+1 slots, greedy decode) on deepseek: MLA
    caches in both groups, the dense prefix and the MoE layers."""
    rcfg, pcfg, params, jparams = model(DEEPSEEK, "pallas")
    B, Lp, G = 2, 16, 4
    prompts = _tokens(rcfg.vocab, B, Lp, seed=3)
    res = serve(pcfg, gen=G, device="cpu", params=params,
                prompts=torch.from_numpy(prompts).long())
    m = ref_build(rcfg.replace(attn_impl="xla"))
    prefill = jax.jit(lambda p, t, c: m.forward(p, t, caches=c, pos_offset=0))
    step = jax.jit(m.decode_step)
    logits, caches = prefill(jparams, jnp.asarray(prompts),
                             m.init_cache(B, Lp + G + 1, jnp.float32))
    logits = logits[:, -1]
    want_logits, want_toks = [logits], [jnp.argmax(logits, -1)]
    for i in range(G - 1):
        logits, caches = step(jparams, want_toks[-1][:, None].astype(
            jnp.int32), caches, Lp + i)
        want_logits.append(logits)
        want_toks.append(jnp.argmax(logits, -1))
    np.testing.assert_array_equal(
        res.tokens.numpy(), np.stack([np.asarray(t) for t in want_toks], 1))
    for got, want in zip(res.logits, want_logits, strict=True):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_loss_and_grads_match_reference(model):
    """deepseek's loss with remat on (the dense prefix, MLA, the routed
    and shared experts, the router) and every gradient leaf."""
    rcfg, pcfg, params, jparams = model(DEEPSEEK)
    rcfg, pcfg = rcfg.replace(remat=True), pcfg.replace(remat=True)
    toks = _tokens(rcfg.vocab, 4, 17, seed=6)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    rloss, rgrads = jax.jit(jax.value_and_grad(lambda p: ref_build(rcfg).loss(
        p, jax.tree.map(jnp.asarray, batch))))(jparams)
    flat = [p.detach().clone().requires_grad_() for p in tree.leaves(params)]
    loss = build_model(pcfg).loss(
        tree.rebuild(params, flat),
        {k: torch.from_numpy(v).long() for k, v in batch.items()})
    grads = torch.autograd.grad(loss, flat)
    np.testing.assert_allclose(loss.item(), float(rloss), **TOL)
    rflat = jax.tree.leaves(rgrads)
    assert len(rflat) == len(grads)
    paths = [jax.tree_util.keystr(k) for k, _ in
             jax.tree_util.tree_flatten_with_path(rgrads)[0]]
    assert any("router" in k for k in paths) and any("wg" in k for k in paths)
    for g, w in zip(grads, rflat):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **GRAD_TOL)


@pytest.mark.parametrize("name", [GRANITE, DEEPSEEK])
def test_params_from_reference_bf16_with_f32_router(name):
    """The reference's bf16 parameter tree (its layout from ``init`` under
    ``jax.eval_shape``): ``moe_layers``, the MLA leaves, the shared expert
    and the f32 router carry across bit for bit; a bf16 router is
    refused."""
    rcfg = rconfigs.REGISTRY[name].smoke_config()
    shapes = jax.eval_shape(
        lambda: ref_build(rcfg).init(jax.random.PRNGKey(0), jnp.bfloat16))
    rng = np.random.default_rng(7)
    ref = jax.tree.map(
        lambda s: rng.standard_normal(s.shape).astype(s.dtype), shapes)
    params, pcfg = convert.params_from_reference(ref, rcfg, device="cpu")
    moe = params["moe_layers"]["moe"]
    assert moe["router"].dtype == torch.float32
    assert moe["wg"].dtype == params["embed"].dtype == torch.bfloat16
    assert ("shared" in moe) == bool(rcfg.moe.n_shared)
    assert ("layers" in params) == bool(rcfg.n_dense_layers)
    assert ("wuk" in params["moe_layers"]["attn"]) == bool(rcfg.mla)
    np.testing.assert_array_equal(moe["router"].numpy(),
                                  ref["moe_layers"]["moe"]["router"])
    np.testing.assert_array_equal(
        moe["wg"].view(torch.int16).numpy(),
        ref["moe_layers"]["moe"]["wg"].view(np.int16))
    bad = jax.tree.map(lambda a: a, ref)
    bad["moe_layers"]["moe"]["router"] = ref["moe_layers"]["moe"][
        "router"].astype(ref["embed"].dtype)
    with pytest.raises(ValueError, match="moe_layers/moe/router"):
        convert.params_from_reference(bad, rcfg, device="cpu")
