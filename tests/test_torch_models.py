"""The port's model substrate against the reference, on the CPU.

Smoke configs of the dense (llama3.2-1b, qwen2.5-3b, starcoder2-3b) and
RWKV6 families: the reference draws the parameters, ``convert`` carries
them across, and both packages run the same numpy-seeded tokens.

* forward logits equal the reference's, with ``attn_impl="pallas"`` on its
  side and ``"cuda"`` on the port's (so the flash and WKV6 branches are
  taken: S=128 for llama, S=64 for rwkv; on CPU tensors the port runs the
  kernels' plain versions), and with ``"xla"`` on both, within 2e-4;
* ``make_prefill_step`` returns the reference's last-position logits;
* teacher-forced incremental decode equals the full forward (2e-3, as
  ``tests/test_arch_smoke.py``);
* the serve loop's per-step logits and tokens equal the reference's loop;
* configs, ``convert`` and ``build_model`` carry the reference's data
  (the MoE and MLA families are held in ``tests/test_torch_moe.py``, the
  encoder-decoder family in ``tests/test_torch_encdec.py``, the
  multimodal-prefix family in ``tests/test_torch_vlm.py``), and the serve
  CLI refuses an arch with a frontend as the reference's does.
"""
from __future__ import annotations

import dataclasses

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
from repro_torch.launch.serve import serve  # noqa: E402
from repro_torch.launch.steps import make_prefill_step  # noqa: E402
from repro_torch.models import build_model, layers  # noqa: E402

LOGIT_TOL = dict(rtol=2e-4, atol=2e-4)
DECODE_TOL = dict(rtol=2e-3, atol=2e-3)     # tests/test_arch_smoke.py
SEQ = {"llama3.2-1b": 128, "rwkv6-1.6b": 64, "qwen2.5-3b": 32,
       "starcoder2-3b": 32}


@pytest.fixture(scope="module")
def reference_params():
    """The reference's f32 smoke parameters per arch, drawn once."""
    cache = {}

    def get(name):
        if name not in cache:
            cfg = rconfigs.REGISTRY[name].smoke_config().replace(remat=False)
            params = ref_build(cfg).init(jax.random.PRNGKey(0), jnp.float32)
            cache[name] = (cfg, params,
                           jax.tree.map(np.asarray, params))
        return cache[name]
    return get


def _tokens(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (B, S)
                                                ).astype(np.int32)


def _port(reference_params, name, impl):
    cfg, jparams, nparams = reference_params(name)
    rcfg = cfg.replace(attn_impl=impl)
    params, pcfg = convert.params_from_reference(nparams, rcfg, device="cpu")
    return rcfg, jparams, params, pcfg


@pytest.mark.parametrize("name,impl", [
    ("llama3.2-1b", "pallas"), ("llama3.2-1b", "xla"),
    ("rwkv6-1.6b", "pallas"), ("rwkv6-1.6b", "xla"),
    ("qwen2.5-3b", "xla"), ("starcoder2-3b", "xla"),
])
def test_forward_matches_reference(reference_params, name, impl):
    rcfg, jparams, params, pcfg = _port(reference_params, name, impl)
    assert pcfg.attn_impl == {"pallas": "cuda", "xla": "xla"}[impl]
    toks = _tokens(rcfg, 2, SEQ[name])
    want, _ = ref_build(rcfg).forward(jparams, jnp.asarray(toks))
    got, _ = build_model(pcfg).forward(params, torch.from_numpy(toks).long())
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("name", ["llama3.2-1b", "rwkv6-1.6b"])
def test_prefill_step_matches_reference(reference_params, name):
    rcfg, jparams, params, pcfg = _port(reference_params, name, "pallas")
    toks = _tokens(rcfg, 2, SEQ[name], seed=1)
    want = ref_prefill_step(ref_build(rcfg))(
        jparams, {"tokens": jnp.asarray(toks)})
    got = make_prefill_step(build_model(pcfg))(
        params, {"tokens": torch.from_numpy(toks).long()})
    assert tuple(got.shape) == (2, rcfg.vocab)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


@pytest.mark.parametrize("name,impl", [
    ("llama3.2-1b", "cuda"), ("rwkv6-1.6b", "cuda"), ("rwkv6-1.6b", "xla"),
])
def test_teacher_forced_decode_matches_full_forward(name, impl):
    cfg = configs.get_config(name).smoke_config().replace(attn_impl=impl)
    m = build_model(cfg)
    params = m.init(torch.Generator().manual_seed(2), torch.float32, "cpu")
    B, S, k = 2, 12, 6
    toks = torch.from_numpy(_tokens(cfg, B, S, seed=2)).long()
    full, _ = m.forward(params, toks)
    caches = m.init_cache(B, 32, torch.float32, "cpu")
    _, caches = m.forward(params, toks[:, :k], caches=caches, pos_offset=0)
    outs = []
    for i in range(k, S):
        logits1, caches = m.decode_step(params, toks[:, i:i + 1], caches, i)
        outs.append(logits1)
    torch.testing.assert_close(torch.stack(outs, 1), full[:, k:S],
                               **DECODE_TOL)


@pytest.mark.parametrize("name", ["llama3.2-1b", "rwkv6-1.6b"])
def test_serve_loop_matches_reference_loop(reference_params, name):
    """The port's serve loop against the reference's serve.py loop
    (prefill into a cache of Lp+G+1 slots, greedy decode) on one prompt."""
    rcfg, jparams, params, pcfg = _port(reference_params, name, "pallas")
    B, Lp, G = 2, 64, 6
    prompts = _tokens(rcfg, B, Lp, seed=3)
    res = serve(pcfg, gen=G, device="cpu", params=params,
                prompts=torch.from_numpy(prompts).long())
    m = ref_build(rcfg)
    caches = m.init_cache(B, Lp + G + 1, jnp.float32)
    logits, caches = m.forward(jparams, jnp.asarray(prompts), caches=caches,
                               pos_offset=0)
    logits = logits[:, -1]
    want_logits, want_toks = [logits], [jnp.argmax(logits, -1)]
    for i in range(G - 1):
        logits, caches = m.decode_step(jparams, want_toks[-1][:, None]
                                       .astype(jnp.int32), caches, Lp + i)
        want_logits.append(logits)
        want_toks.append(jnp.argmax(logits, -1))
    np.testing.assert_array_equal(res.tokens.numpy(),
                                  np.stack([np.asarray(t) for t in want_toks],
                                           1))
    assert len(res.logits) == G
    for got, want in zip(res.logits, want_logits):
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   **LOGIT_TOL)


@pytest.mark.parametrize("Sq,Skv,causal,window", [
    (200, 200, True, 0), (96, 160, False, 0), (200, 200, True, 48),
], ids=["causal-padded", "noncausal", "window"])
def test_chunked_attention_matches_reference(Sq, Skv, causal, window):
    """``_attn_chunked`` without the static causal split == the
    reference's, with q and kv padding (small blocks force both)."""
    rng = np.random.default_rng(Sq + Skv + window)
    q = rng.standard_normal((2, Sq, 4, 16)).astype(np.float32)
    k, v = (rng.standard_normal((2, Skv, 2, 16)).astype(np.float32)
            for _ in range(2))
    qp, kp = np.arange(Sq) + (Skv - Sq), np.arange(Skv)
    kw = dict(causal=causal, window=window, chunk=64, q_block=32)
    want = rlayers._attn_chunked(*(jnp.asarray(x) for x in (q, k, v)),
                                 q_pos=jnp.asarray(qp), kv_pos=jnp.asarray(kp),
                                 **kw)
    got = layers._attn_chunked(*(torch.from_numpy(x) for x in (q, k, v)),
                               q_pos=torch.from_numpy(qp),
                               kv_pos=torch.from_numpy(kp), **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **LOGIT_TOL)


def test_configs_are_the_references():
    assert sorted(configs.REGISTRY) == sorted(rconfigs.REGISTRY)
    for name, rcfg in rconfigs.REGISTRY.items():
        cfg = configs.get_config(name)
        assert convert.config_from_reference(rcfg) == cfg, name
        assert cfg.n_params() == rcfg.n_params(), name
        assert cfg.n_active_params() == rcfg.n_active_params(), name
        assert cfg.hd() == rcfg.hd(), name
        assert (convert.config_from_reference(rcfg.smoke_config())
                == cfg.smoke_config()), name
    assert {k: dataclasses.astuple(v) for k, v in configs.SHAPES.items()} \
        == {k: dataclasses.astuple(v) for k, v in rconfigs.SHAPES.items()}
    assert list(configs.all_cells()) == list(rconfigs.all_cells())
    with pytest.raises(KeyError):
        configs.get_config("no-such-arch")
    pcfg = convert.config_from_reference(
        rconfigs.REGISTRY["rwkv6-1.6b"].replace(attn_impl="pallas"))
    assert pcfg.attn_impl == "cuda"


def test_params_from_reference_checks_every_leaf(reference_params):
    cfg, _, nparams = reference_params("llama3.2-1b")
    bad = jax.tree.map(lambda a: a, nparams)
    bad["layers"]["attn"]["wq"] = nparams["layers"]["attn"]["wq"][:, :, :8]
    with pytest.raises(ValueError, match="layers/attn/wq"):
        convert.params_from_reference(bad, cfg, device="cpu")
    bad = jax.tree.map(lambda a: a, nparams)
    bad["ln_f"] = nparams["ln_f"].astype(np.float64)
    with pytest.raises(ValueError, match="ln_f"):
        convert.params_from_reference(bad, cfg, device="cpu")
    bad = {k: v for k, v in nparams.items() if k != "ln_f"}
    with pytest.raises(ValueError, match="keys"):
        convert.params_from_reference(bad, cfg, device="cpu")
    # bf16 leaves (NumPy's extension type) carry across bit for bit
    bf = jax.tree.map(lambda a: np.asarray(jnp.asarray(a).astype(jnp.bfloat16)),
                      nparams)
    params, _ = convert.params_from_reference(bf, cfg, device="cpu")
    assert params["embed"].dtype == torch.bfloat16
    assert np.array_equal(params["embed"].view(torch.int16).numpy(),
                          bf["embed"].view(np.int16))


@pytest.mark.parametrize("name", ["whisper-tiny", "internvl2-26b"])
def test_serve_cli_refuses_frontend_archs_as_the_reference(name):
    """Both CLIs drive text-only archs: an arch with a frontend is refused
    with the reference's message, before any model is built."""
    from repro.launch import serve as ref_serve
    from repro_torch.launch import serve as port_serve

    argv = ["--arch", name, "--width", "tiny"]
    with pytest.raises(SystemExit) as want:
        ref_serve.main(argv)
    with pytest.raises(SystemExit) as got:
        port_serve.main(argv)
    assert str(got.value) == str(want.value)
    assert "drives text-only archs" in str(got.value)


def test_loss_is_not_ported_yet():
    """Once a stub, the loss is ported: it runs on the plain route, and
    the kernel routes refuse grad mode (the hand-written kernels have no
    backward, as the reference's Pallas kernels define no VJP) on every
    device, before the dispatch, instead of returning outputs detached
    from autograd; under ``no_grad`` they run.  ``attn_impl`` is still
    checked."""
    for name, S in (("llama3.2-1b", 128), ("rwkv6-1.6b", 64),
                    ("zamba2-7b", 64)):
        cfg = configs.get_config(name).smoke_config()
        params = build_model(cfg).init(torch.Generator().manual_seed(0),
                                       torch.float32, device="cpu")
        tokens = torch.randint(0, cfg.vocab, (2, S),
                               generator=torch.Generator().manual_seed(1))
        batch = {"tokens": tokens, "labels": tokens.roll(-1, dims=1)}
        for p in jax.tree.leaves(params):
            p.requires_grad_(True)
        loss = build_model(cfg).loss(params, batch)
        assert loss.requires_grad and bool(torch.isfinite(loss))
        kernel = build_model(cfg.replace(attn_impl="cuda"))
        with pytest.raises(RuntimeError, match="no backward"):
            kernel.loss(params, batch)
        with torch.no_grad():
            got = kernel.loss(params, batch)
        torch.testing.assert_close(got, loss.detach(), **LOGIT_TOL)
    with pytest.raises(ValueError, match="attn_impl"):
        layers.attention_core(torch.zeros(1, 4, 2, 8), torch.zeros(1, 4, 2, 8),
                              torch.zeros(1, 4, 2, 8), impl="pallas")
    q = torch.zeros(1, 128, 2, 64, requires_grad=True)
    with pytest.raises(RuntimeError, match="flash_attention_hm: .*no backward"):
        layers.attention_core(q, q, q, impl="cuda")
