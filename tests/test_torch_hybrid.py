"""The port's hybrid family (Mamba2 + shared attention) against the reference.

zamba2-7b's smoke config (4 layers: Mamba2, shared attention, Mamba2,
shared attention; d_model 64, SSD heads of 16, state 16, chunk 8, window
16): the reference draws the parameters, ``convert`` carries them
across, and both packages run the same numpy-seeded inputs.

* ``mamba2_apply`` equals the reference's without a cache, with a cache,
  in the S == 1 decode step and at an S that is not a multiple of the
  chunk (the dt = 0 padding), on the plain route and on the kernel route;
* the hybrid forward's logits, prefill-with-cache plus decode, and the
  serve loop equal the reference's (2e-4);
* the ring-buffer cache: decode 24 steps past the window of 16, a
  multi-token write that the reference's ``dynamic_update_slice`` clamps,
  and the dense family's ring cache, each against the reference's logits;
* teacher-forced decode equals the full forward (2e-3), and the two
  routes agree on the CPU.
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
from repro.models import build_model as ref_build  # noqa: E402
from repro.models import ssm as rssm  # noqa: E402
from repro_torch import configs, convert  # noqa: E402
from repro_torch.kernels.ssd import ssd  # noqa: E402
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.models import build_model, hybrid, ssm  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
STATE_TOL = dict(rtol=1e-3, atol=1e-3)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_arch_smoke.py
ZAMBA = "zamba2-7b"


@pytest.fixture(scope="module")
def reference():
    """The reference's f32 smoke config and parameters (jax and numpy),
    with A_log and dt_bias drawn away from their zero init so the decay
    rates differ per head, and the port's copy of them."""
    cfg = rconfigs.REGISTRY[ZAMBA].smoke_config().replace(remat=False)
    params = ref_build(cfg).init(jax.random.PRNGKey(0), jnp.float32)
    nparams = jax.tree.map(np.asarray, params)
    rng = np.random.default_rng(0)
    mamba = nparams["ssm_layers"]["mamba"]
    for name, scale in (("A_log", 0.5), ("dt_bias", 0.5)):
        mamba[name] = (scale * rng.standard_normal(mamba[name].shape)
                       ).astype(np.float32)
    params = jax.tree.map(jnp.asarray, nparams)
    return cfg, params, nparams


@functools.cache
def _ref_decode(cfg):
    """The reference's decode step for ``cfg``, jitted once (eager JAX
    dispatches every op of a step from Python); ``pos`` is traced."""
    return jax.jit(ref_build(cfg).decode_step)


_ref_mamba2 = jax.jit(rssm.mamba2_apply, static_argnames="cfg")


@functools.cache
def _ref_forward(cfg):
    """The reference's forward for ``cfg``, jitted, with or without
    caches; ``pos_offset`` is traced."""
    m = ref_build(cfg)
    return jax.jit(lambda p, t, c=None, off=0: m.forward(
        p, t, caches=c, pos_offset=off))


def _port(reference, impl):
    cfg, jparams, nparams = reference
    rcfg = cfg.replace(attn_impl=impl)
    params, pcfg = convert.params_from_reference(nparams, rcfg, device="cpu")
    return rcfg, jparams, params, pcfg


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def _np(x):
    return (x.float().numpy() if isinstance(x, torch.Tensor)
            else np.asarray(x, np.float32))


@pytest.mark.parametrize("use_kernel", [False, True], ids=["plain", "kernel"])
@pytest.mark.parametrize("case", ["nocache", "cache", "decode", "ragged"])
def test_mamba2_apply_matches_reference(reference, case, use_kernel):
    cfg, _, nparams = reference
    pcfg = convert.config_from_reference(cfg)
    rp = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      nparams["ssm_layers"]["mamba"])
    tp = {k: torch.from_numpy(np.array(v[0]))
          for k, v in nparams["ssm_layers"]["mamba"].items()}
    S = {"nocache": 16, "cache": 16, "decode": 1, "ragged": 13}[case]
    rng = np.random.default_rng(S)
    x = rng.standard_normal((2, S, cfg.d_model)).astype(np.float32)
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    cache = None
    if case != "nocache":
        cache = {"conv": rng.standard_normal(
                     (2, s.d_conv - 1, di + 2 * s.d_state)).astype(np.float32),
                 "ssm": rng.standard_normal(
                     (2, nh, s.head_dim, s.d_state)).astype(np.float32)}
    want, want_c = _ref_mamba2(
        rp, jnp.asarray(x), cfg,
        cache=None if cache is None else jax.tree.map(jnp.asarray, cache))
    got, got_c = ssm.mamba2_apply(
        tp, torch.from_numpy(x),
        pcfg.replace(attn_impl="cuda" if use_kernel else "xla"),
        cache=None if cache is None else {k: torch.from_numpy(v)
                                          for k, v in cache.items()})
    np.testing.assert_allclose(_np(got), _np(want), **LOGIT_TOL)
    if cache is not None:
        np.testing.assert_array_equal(_np(got_c["conv"]),
                                      _np(want_c["conv"]))
        np.testing.assert_allclose(_np(got_c["ssm"]), _np(want_c["ssm"]),
                                   **STATE_TOL)
    assert ssd.launches == 0          # CPU tensors launch nothing


@pytest.mark.parametrize("impl", ["pallas", "xla"])
def test_forward_matches_reference(reference, impl):
    rcfg, jparams, params, pcfg = _port(reference, impl)
    assert pcfg.attn_impl == {"pallas": "cuda", "xla": "xla"}[impl]
    toks = _tokens(rcfg, 2, 40)         # 5 chunks of 8, past the window
    want, _ = _ref_forward(rcfg)(jparams, jnp.asarray(toks))
    got, _ = build_model(pcfg).forward(params, torch.from_numpy(toks).long())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_prefill_and_decode_match_reference(reference):
    """Prefill 9 tokens (the dt = 0 padding) into a flat cache of 16 slots,
    then 6 decode steps: logits, every Mamba2 state and conv cache, and
    the attention caches equal the reference's."""
    rcfg, jparams, params, pcfg = _port(reference, "pallas")
    B, P, G = 2, 9, 6
    toks = _tokens(rcfg, B, P + G, seed=4)
    rm, m = ref_build(rcfg), build_model(pcfg)
    rc = rm.init_cache(B, P + G + 1, jnp.float32)
    tc = m.init_cache(B, P + G + 1, torch.float32, "cpu")
    assert "pos" not in tc["attn"] and tc["attn"]["len"] == 0
    want, rc = _ref_forward(rcfg)(jparams, jnp.asarray(toks[:, :P]), rc, 0)
    got, tc = m.forward(params, torch.from_numpy(toks[:, :P]).long(),
                        caches=tc, pos_offset=0)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)
    for i in range(P, P + G):
        w1, rc = _ref_decode(rcfg)(jparams, jnp.asarray(toks[:, i:i + 1]),
                                   rc, i)
        g1, tc = m.decode_step(params, torch.from_numpy(toks[:, i:i + 1])
                               .long(), tc, i)
        np.testing.assert_allclose(g1.numpy(), np.asarray(w1), **LOGIT_TOL)
    assert tc["attn"]["len"] == P + G == int(rc["attn"]["len"][0])
    np.testing.assert_allclose(_np(tc["ssm"]["ssm"]), _np(rc["ssm"]["ssm"]),
                               **STATE_TOL)
    np.testing.assert_allclose(_np(tc["ssm"]["conv"]),
                               _np(rc["ssm"]["conv"]), **LOGIT_TOL)
    np.testing.assert_allclose(_np(tc["attn"]["k"]), _np(rc["attn"]["k"]),
                               **LOGIT_TOL)


def test_ring_cache_decode_matches_reference(reference):
    """24 decode steps against a cache of 48 slots: the window of 16 is
    shorter, so the shared attention's caches are 16-slot rings and decode
    wraps at step 16.  The reference's own test
    (tests/test_arch_smoke.py:99-109) checks only finiteness; here every
    step's logits equal the reference's."""
    rcfg, jparams, params, pcfg = _port(reference, "pallas")
    B = 1
    rm, m = ref_build(rcfg), build_model(pcfg)
    rc = rm.init_cache(B, 48, jnp.float32)
    tc = m.init_cache(B, 48, torch.float32, "cpu")
    W = pcfg.sliding_window
    assert tuple(tc["attn"]["k"].shape[1:3]) == (B, W)
    assert bool((tc["attn"]["pos"] == -1).all())
    toks = _tokens(rcfg, B, 24, seed=5)
    for i in range(24):
        w1, rc = _ref_decode(rcfg)(jparams, jnp.asarray(toks[:, i:i + 1]),
                                   rc, i)
        g1, tc = m.decode_step(params, torch.from_numpy(toks[:, i:i + 1])
                               .long(), tc, i)
        assert bool(torch.isfinite(g1).all())
        np.testing.assert_allclose(g1.numpy(), np.asarray(w1), **LOGIT_TOL)
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(rc["attn"]["pos"]))
    np.testing.assert_allclose(_np(tc["ssm"]["ssm"]), _np(rc["ssm"]["ssm"]),
                               **STATE_TOL)


def test_ring_cache_multi_token_writes_clamp_as_the_reference(reference):
    """A 12-token prefill, then an 8-token chunk at len 12: the reference's
    ``dynamic_update_slice`` clamps the start from 12 to 16 - 8 = 8; the
    port writes there too.  Logits, slot positions and K equal the
    reference's; more tokens than slots raise (the reference cannot
    trace them)."""
    rcfg, jparams, params, pcfg = _port(reference, "pallas")
    B = 2
    rm, m = ref_build(rcfg), build_model(pcfg)
    rc = rm.init_cache(B, 40, jnp.float32)
    tc = m.init_cache(B, 40, torch.float32, "cpu")
    toks = _tokens(rcfg, B, 20, seed=6)
    for lo, hi in ((0, 12), (12, 20)):
        want, rc = _ref_forward(rcfg)(jparams, jnp.asarray(toks[:, lo:hi]),
                                      rc, lo)
        got, tc = m.forward(params, torch.from_numpy(toks[:, lo:hi]).long(),
                            caches=tc, pos_offset=lo)
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)
    pos = tc["attn"]["pos"][0].tolist()
    assert pos == list(range(8)) + list(range(12, 20))
    np.testing.assert_array_equal(tc["attn"]["pos"].numpy(),
                                  np.asarray(rc["attn"]["pos"]))
    np.testing.assert_allclose(_np(tc["attn"]["k"]), _np(rc["attn"]["k"]),
                               **LOGIT_TOL)
    with pytest.raises(ValueError, match="ring cache of 16 slots"):
        m.forward(params, torch.zeros((B, 17), dtype=torch.long), caches=tc,
                  pos_offset=20)


def test_dense_ring_cache_matches_reference():
    """The dense family's ring cache (``transformer.init_cache``): llama's
    smoke config with a window of 16, decoded 24 steps, against the
    reference's logits."""
    cfg = rconfigs.REGISTRY["llama3.2-1b"].smoke_config().replace(
        remat=False, sliding_window=16)
    jparams = ref_build(cfg).init(jax.random.PRNGKey(1), jnp.float32)
    params, pcfg = convert.params_from_reference(
        jax.tree.map(np.asarray, jparams), cfg, device="cpu")
    rm, m = ref_build(cfg), build_model(pcfg)
    rc = rm.init_cache(1, 30, jnp.float32)
    tc = m.init_cache(1, 30, torch.float32, "cpu")
    assert tuple(tc["dense"]["pos"].shape) == (cfg.n_layers, 16)
    toks = _tokens(cfg, 1, 24, seed=7)
    for i in range(24):
        w1, rc = _ref_decode(cfg)(jparams, jnp.asarray(toks[:, i:i + 1]), rc,
                                  i)
        g1, tc = m.decode_step(params, torch.from_numpy(toks[:, i:i + 1])
                               .long(), tc, i)
        np.testing.assert_allclose(g1.numpy(), np.asarray(w1), **LOGIT_TOL)


@pytest.mark.parametrize("impl", ["cuda", "xla"])
def test_teacher_forced_decode_matches_full_forward(impl):
    cfg = configs.get_config(ZAMBA).smoke_config().replace(attn_impl=impl)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(2), torch.float32, "cpu")
    B, S, k = 2, 30, 11
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2)).long()
    full, _ = m.forward(params, toks)
    caches = m.init_cache(B, S + 2, torch.float32, "cpu")
    _, caches = m.forward(params, toks[:, :k], caches=caches, pos_offset=0)
    outs = []
    for i in range(k, S):
        logits1, caches = m.decode_step(params, toks[:, i:i + 1], caches, i)
        outs.append(logits1)
    torch.testing.assert_close(torch.stack(outs, 1), full[:, k:S],
                               **DECODE_TOL)


def test_serve_loop_matches_reference_loop(reference):
    """The port's serve loop against the reference's serve.py loop on one
    prompt (prefill into a cache of Lp+G+1 slots, greedy decode)."""
    rcfg, jparams, params, pcfg = _port(reference, "pallas")
    B, Lp, G = 2, 9, 6                  # a flat cache of 16 slots
    prompts = _tokens(rcfg, B, Lp, seed=3)
    res = serve(pcfg, gen=G, device="cpu", params=params,
                prompts=torch.from_numpy(prompts).long())
    m = ref_build(rcfg)
    caches = m.init_cache(B, Lp + G + 1, jnp.float32)
    logits, caches = _ref_forward(rcfg)(jparams, jnp.asarray(prompts),
                                        caches, 0)
    logits = logits[:, -1]
    want_logits, want_toks = [logits], [jnp.argmax(logits, -1)]
    for i in range(G - 1):
        logits, caches = _ref_decode(rcfg)(
            jparams, want_toks[-1][:, None].astype(jnp.int32), caches, Lp + i)
        want_logits.append(logits)
        want_toks.append(jnp.argmax(logits, -1))
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.stack([np.asarray(t) for t in want_toks],
                                           1))
    for got, want in zip(res.logits, want_logits):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)


def test_both_routes_agree_on_the_cpu(reference):
    """On CPU tensors the kernel route runs the kernel's plain version on
    the scan's f32 inputs: the same numbers as the plain route."""
    _, _, params, pcfg = _port(reference, "pallas")
    toks = torch.from_numpy(_tokens(pcfg, 2, 24, seed=8)).long()
    got, _ = build_model(pcfg).forward(params, toks)
    want, _ = build_model(pcfg.replace(attn_impl="xla")).forward(params, toks)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_params_from_reference_carries_the_hybrid_tree(reference):
    cfg, _, nparams = reference
    params, pcfg = convert.params_from_reference(nparams, cfg, device="cpu")
    assert set(params) == {"embed", "ln_f", "ssm_layers", "shared_attn",
                           "unembed"}
    n_ssm = hybrid._n_ssm(pcfg)
    assert (n_ssm, hybrid._n_attn(pcfg)) == (2, 2)
    win = params["ssm_layers"]["mamba"]["win"]
    assert win.shape[0] == n_ssm
    np.testing.assert_array_equal(win.numpy(),
                                  nparams["ssm_layers"]["mamba"]["win"])
    bad = jax.tree.map(lambda a: a, nparams)
    bad["ssm_layers"]["mamba"]["win"] = nparams["ssm_layers"]["mamba"][
        "win"][:, :, :8]
    with pytest.raises(ValueError, match="ssm_layers/mamba/win"):
        convert.params_from_reference(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, nparams)
    del bad["shared_attn"]["mlp"]
    with pytest.raises(ValueError, match="shared_attn"):
        convert.params_from_reference(bad, cfg, device="cpu")
    # the full-width config's counts: 68 Mamba2 layers, 13 applications
    full = configs.get_config(ZAMBA)
    assert (hybrid._n_ssm(full), hybrid._n_attn(full)) == (68, 13)
    assert full.n_params() == rconfigs.REGISTRY[ZAMBA].n_params()
