"""The port's AdamW (``repro_torch.optim``) against the reference's, on the CPU.

* ``lr_at`` over every step of a schedule, within rtol 1e-6;
* ``apply_updates`` fed the *same* gradients for 3 steps, at 32 and 8
  state bits, on a tree with a stacked ``[L, d]`` norm leaf (decayed, kept
  f32), a 1-D leaf (not decayed) and a ``[4, 256, 512]`` leaf (int8 at 8
  bits): params and f32 moments within rtol 1e-6 / atol 1e-7, int8
  moments never more than 1 apart, scales within rtol 1e-6, the step
  equal;
* the slice-by-slice update of huge stacked leaves equal to the
  whole-leaf update (the threshold lowered, since a 2^26-element leaf is
  too large for a CPU test);
* ``convert.opt_state_from_reference`` carries the reference's state and
  refuses a wrong dtype.
"""
from __future__ import annotations

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import optim as roptim  # noqa: E402
from repro_torch import convert, optim  # noqa: E402

STATE_TOL = dict(rtol=1e-6, atol=1e-7)


def _tree(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    return {"layers": {"ln": (1 + 0.1 * rng.standard_normal((3, 64))
                              ).astype(np.float32),
                       "w": rng.standard_normal((4, 256, 512)
                                                ).astype(np.float32)},
            "bias": rng.standard_normal((64,)).astype(np.float32)}


def _port(tree):
    return {k: _port(v) if isinstance(v, dict) else torch.from_numpy(v.copy())
            for k, v in tree.items()}


def test_lr_at_matches_reference():
    cfg = optim.AdamWConfig(lr=1e-3, warmup=7, total_steps=40)
    rcfg = roptim.AdamWConfig(lr=1e-3, warmup=7, total_steps=40)
    steps = np.arange(0, 41, dtype=np.int32)
    got = optim.lr_at(cfg, torch.from_numpy(steps))
    want = np.asarray(roptim.lr_at(rcfg, jnp.asarray(steps)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    # one step at a time, as apply_updates asks
    for s in (0, 7, 23, 40):
        np.testing.assert_allclose(
            float(optim.lr_at(cfg, torch.tensor(s, dtype=torch.int32))),
            float(roptim.lr_at(rcfg, jnp.int32(s))), rtol=1e-6)


@pytest.mark.parametrize("bits,gscale", [(32, 0.1), (32, 1e-3), (8, 1e-3),
                                         (8, 0.1)])
def test_apply_updates_matches_reference_on_the_same_grads(bits, gscale):
    """At ``gscale`` 0.1 the global norm (about 72) clips the gradients;
    at 1e-3 (about 0.7) the clip factor is exactly 1.  The norm is a sum
    that each package rounds in its own order, so a clipped gradient may
    differ in its last bit; at 8 bits that can move an int8 moment by one
    (its rounding at a half), and the param then by up to ``lr``: there
    the quantized leaf's params are held to ``lr`` and at most 1e-4 of
    its elements, every other number to the stated tolerances."""
    kw = dict(lr=5e-2, warmup=2, total_steps=10, state_bits=bits)
    cfg, rcfg = optim.AdamWConfig(**kw), roptim.AdamWConfig(**kw)
    tree = _tree(0)
    rparams = jax.tree.map(jnp.asarray, tree)
    rstate = roptim.init_state(rcfg, rparams)
    params = _port(tree)
    state = convert.opt_state_from_reference(
        jax.tree.map(np.asarray, rstate), params)
    own = optim.init_state(cfg, params)
    for a, b in zip(jax.tree.leaves(state), jax.tree.leaves(own)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    w_mv = state["mv"]["layers"]["w"]
    assert (w_mv.m.dtype == torch.int8) == (bits == 8)
    assert state["mv"]["layers"]["ln"].m_scale is None
    for step in range(3):
        grads = {k: v * gscale for k, v in _tree(10 + step).items()
                 if not isinstance(v, dict)}
        grads["layers"] = {k: v * gscale for k, v in
                           _tree(10 + step)["layers"].items()}
        rparams, rstate = roptim.apply_updates(
            rcfg, rparams, jax.tree.map(jnp.asarray, grads), rstate)
        out_p, out_s = optim.apply_updates(cfg, params, _port(grads), state)
        assert out_p is params and out_s is state        # updated in place
    assert int(state["step"]) == int(rstate["step"]) == 3
    assert state["step"].dtype == torch.int32
    flips = bits == 8 and gscale == 0.1
    for got, want in zip(jax.tree.leaves(params), jax.tree.leaves(rparams)):
        got, want = got.numpy(), np.asarray(want)
        if flips and got.size == 4 * 256 * 512:
            off = ~np.isclose(got, want, **STATE_TOL)
            assert off.mean() <= 1e-4 and np.abs(got - want).max() <= kw["lr"]
        else:
            np.testing.assert_allclose(got, want, **STATE_TOL)
    rmv = jax.tree.map(np.asarray, rstate["mv"])
    for path in (("layers", "ln"), ("layers", "w"), ("bias",)):
        got, want = state["mv"], rmv
        for k in path:
            got, want = got[k], want[k]
        for f in optim.MomentState._fields:
            g, w = getattr(got, f), getattr(want, f)
            assert (g is None) == (w is None), (path, f)
            if g is None:
                continue
            g = g.numpy()
            assert g.dtype == w.dtype, (path, f)
            if g.dtype == np.int8:
                assert np.abs(g.astype(np.int32) - w.astype(np.int32)
                              ).max() <= 1, (path, f)
            elif f.endswith("scale"):
                np.testing.assert_allclose(g, w, rtol=1e-6)
            else:
                np.testing.assert_allclose(g, w, **STATE_TOL)
    # the stacked [L, d] norm leaf is decayed (rank 2), the 1-D bias not
    p0 = _port(_tree(0))
    g0 = {"layers": {"ln": torch.zeros(3, 64), "w": torch.zeros(4, 256, 512)},
          "bias": torch.zeros(64)}
    st = optim.init_state(cfg, p0)
    ln0, b0 = p0["layers"]["ln"].clone(), p0["bias"].clone()
    optim.apply_updates(cfg, p0, g0, st)
    assert not torch.equal(p0["layers"]["ln"], ln0)
    assert torch.equal(p0["bias"], b0)


@pytest.mark.parametrize("bits", [32, 8])
def test_sliced_update_equals_whole_leaf(monkeypatch, bits):
    cfg = optim.AdamWConfig(lr=1e-2, warmup=1, total_steps=5, state_bits=bits)
    rng = np.random.default_rng(3)
    p = rng.standard_normal((4, 64, 256)).astype(np.float32)
    grads = [rng.standard_normal(p.shape).astype(np.float32)
             for _ in range(3)]
    runs = {}
    for name, threshold in (("whole", optim.SLICE_MIN_SIZE), ("sliced", 1)):
        monkeypatch.setattr(optim, "SLICE_MIN_SIZE", threshold)
        params = {"w": torch.from_numpy(p.copy())}
        state = optim.init_state(cfg, params)
        for g in grads:
            optim.apply_updates(cfg, params, {"w": torch.from_numpy(g)},
                                state)
        runs[name] = (params, state)
    (pw, sw), (ps, ss) = runs["whole"], runs["sliced"]
    assert torch.equal(pw["w"], ps["w"])
    for a, b in zip(sw["mv"]["w"], ss["mv"]["w"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert torch.equal(a, b)
    assert (sw["mv"]["w"].m.dtype == torch.int8) == (bits == 8)


@pytest.mark.parametrize("bits", [32, 8])
def test_adamw_reduces_loss(bits):
    cfg = optim.AdamWConfig(lr=5e-2, warmup=1, total_steps=50,
                            state_bits=bits)
    w = {"w": torch.full((256, 256), 2.0)}
    st = optim.init_state(cfg, w)
    l0 = float(torch.mean(w["w"] ** 2))
    for _ in range(20):
        x = w["w"].detach().requires_grad_(True)
        (g,) = torch.autograd.grad(torch.mean(x ** 2), [x])
        optim.apply_updates(cfg, w, {"w": g}, st)
    assert float(torch.mean(w["w"] ** 2)) < l0 * 0.5
    if bits == 8:
        mv = st["mv"]["w"]
        assert mv.m.dtype == torch.int8 and mv.m_scale is not None
        assert tuple(mv.m.shape) == (256, 256)


def test_opt_state_from_reference_refuses_wrong_leaves():
    params = _port(_tree(0))
    rstate = jax.tree.map(np.asarray, roptim.init_state(
        roptim.AdamWConfig(state_bits=8), jax.tree.map(jnp.asarray,
                                                       _tree(0))))
    bad = dict(rstate, step=np.zeros((), np.int64))
    with pytest.raises(ValueError, match="step"):
        convert.opt_state_from_reference(bad, params)
    mv = dict(rstate["mv"])
    mv["bias"] = rstate["mv"]["bias"]._replace(
        m=np.zeros((65,), np.float32))
    with pytest.raises(ValueError, match="bias.m"):
        convert.opt_state_from_reference(dict(rstate, mv=mv), params)
    with pytest.raises(ValueError, match="keys"):
        convert.opt_state_from_reference(
            dict(rstate, mv={"bias": rstate["mv"]["bias"]}), params)
