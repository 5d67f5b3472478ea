"""The port's op counter (``launch/op_cost.py``) against the reference's
HLO cost analyzer (``launch/hlo_cost.py``), on the CPU.

* The four calibration functions of ``tests/test_hlo_cost.py`` (its
  scans written as Python loops): the port's ``flops`` equal
  ``analyze_hlo``'s on the jitted JAX versions, exactly.
* Bytes and launches checked by hand for a matmul, a view and an
  in-place add; a known peak of live storage; ``meta`` counts equal to
  CPU counts for a smoke llama prefill.
* Each family's smoke ``make_prefill_step`` (llama3.2-1b,
  granite-moe-1b-a400m, rwkv6-1.6b, zamba2-7b, whisper-tiny) and the
  train step of llama3.2-1b and granite-moe-1b-a400m: the port's FLOPs
  equal the reference's ``analyze_hlo`` on its compiled step plus the
  differences itemised below, each a product one side writes as a
  contraction and the other does not, exact in integers.
* Each hand-written kernel's wrapper on ``meta``: its outputs' shapes
  and the cost it records against a hand computation.

All inputs are shapes (``meta`` tensors, ``ShapeDtypeStruct``s) or drawn
with NumPy from a seed.
"""
from __future__ import annotations

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as rconfigs  # noqa: E402
from repro import optim as roptim  # noqa: E402
from repro.launch import steps as rsteps  # noqa: E402
from repro.launch.hlo_cost import analyze_hlo  # noqa: E402
from repro.models import ParallelCtx as RCtx  # noqa: E402
from repro.models import build_model as ref_build  # noqa: E402
from repro_torch import configs, optim  # noqa: E402
from repro_torch.kernels import flash_attention as fa  # noqa: E402
from repro_torch.kernels import ssd as sd  # noqa: E402
from repro_torch.kernels import wkv6 as wk  # noqa: E402
from repro_torch.launch import steps  # noqa: E402
from repro_torch.launch.op_cost import op_cost  # noqa: E402
from repro_torch.models import build_model  # noqa: E402

B, S = 2, 32          # the smoke steps' batch


def _hlo_flops(f, *sds) -> int:
    return int(analyze_hlo(jax.jit(f).lower(*sds).compile().as_text())[
        "flops"])


def _meta(*shape):
    return torch.empty(shape, device="meta")


def _f32(*shape):
    return jax.ShapeDtypeStruct(shape, jnp.float32)


# ------------------------------------------- the calibration functions
def test_plain_matmul_flops_exact():
    N = 512
    got = op_cost(lambda a, b: a @ b, _meta(N, N), _meta(N, N))["flops"]
    assert got == _hlo_flops(lambda a, b: a @ b, _f32(N, N), _f32(N, N))
    assert got == 2 * N ** 3


def test_loop_counts_every_iteration():
    """The reference's ``lax.scan`` of 8 matmuls, which ``analyze_hlo``
    multiplies by its trip count; eager dispatches all 8."""
    N, L = 256, 8

    def f(x):
        for _ in range(L):
            x = x @ x
        return x

    want = _hlo_flops(lambda x: jax.lax.scan(
        lambda c, _: (c @ c, None), x, None, length=L)[0], _f32(N, N))
    assert op_cost(f, _meta(N, N))["flops"] == want == L * 2 * N ** 3


def test_nested_loops_multiply():
    N, L1, L2 = 128, 3, 5

    def f(x):
        for _ in range(L1):
            for _ in range(L2):
                x = x @ x
        return x

    def g(x):
        def outer(c, _):
            return jax.lax.scan(lambda d, _: (d @ d, None), c, None,
                                length=L2)[0], None
        return jax.lax.scan(outer, x, None, length=L1)[0]

    want = _hlo_flops(g, _f32(N, N))
    assert op_cost(f, _meta(N, N))["flops"] == want == L1 * L2 * 2 * N ** 3


def test_einsum_contraction_flops():
    Bb, M, K, N = 4, 64, 96, 32
    want = _hlo_flops(lambda a, b: jnp.einsum("bmk,kn->bmn", a, b),
                      _f32(Bb, M, K), _f32(K, N))
    got = op_cost(lambda a, b: torch.einsum("bmk,kn->bmn", a, b),
                  _meta(Bb, M, K), _meta(K, N))["flops"]
    assert got == want == 2 * Bb * M * K * N


# --------------------------------------------- bytes, launches, peak
def test_bytes_and_launches_by_hand():
    M, K, N = 64, 96, 32
    mm = op_cost(lambda a, b: a @ b, _meta(M, K), _meta(K, N))
    assert (mm["launches"], mm["bytes_accessed"]) == (
        1, 4 * (M * K + K * N + M * N))
    assert mm["ops"] == {"mm": 1}
    view = op_cost(lambda a: a.t()[3:].unsqueeze(0), _meta(M, K))
    assert (view["launches"], view["bytes_accessed"]) == (0, 0)
    add = op_cost(lambda a, b: a.add_(b), _meta(M, K), _meta(M, K))
    assert (add["launches"], add["bytes_accessed"]) == (1, 3 * 4 * M * K)
    # an allocation without a fill launches nothing
    empty = op_cost(lambda a: torch.empty_like(a), _meta(M, K))
    assert (empty["launches"], empty["bytes_accessed"]) == (0, 0)


def test_peak_of_live_storage():
    """x (an argument) and y, z, w of 1 MiB each: y dies before w is
    made, so at most three are live, plus the 4-byte sum."""
    n = 1 << 18                 # 1 MiB of f32

    def f(x):
        y = x * 2
        z = y + 1
        del y
        w = z * 3
        return w.sum()

    got = op_cost(f, torch.zeros(n))
    assert got["argument_bytes"] == 4 * n
    assert got["peak_bytes"] == 3 * 4 * n + 4
    assert got["temp_bytes"] == 2 * 4 * n + 4
    assert got["output_bytes"] == 4
    assert got["launches"] == 4


def test_saved_tensors_stay_live_until_the_backward():
    """A tensor autograd saves is live after its Python name is gone."""
    n = 1 << 16
    x = torch.randn(n, requires_grad=True)

    def f(x):
        t = torch.sin(x)        # saved by mul's backward
        s = (t * t).sum()
        del t
        s.backward()
        return s

    got = op_cost(f, x)
    # x, sin(x), t*t live before the backward's own temporaries
    assert got["peak_bytes"] >= 3 * 4 * n


def test_meta_counts_equal_cpu_counts():
    cfg = configs.get_config("llama3.2-1b").smoke_config()
    model = build_model(cfg)
    got = {}
    for dev in ("cpu", "meta"):
        params = model.init(torch.Generator().manual_seed(0), torch.float32,
                            device=dev)
        tokens = torch.zeros((B, S), dtype=torch.int32, device=dev)
        got[dev] = op_cost(steps.make_prefill_step(model), params,
                           {"tokens": tokens})
    assert got["cpu"] == got["meta"]
    assert got["meta"]["launches"] > 100 and got["meta"]["flops"] > 0


# ----------------------------------- model steps against the reference
def _ref_flops(arch: str, kind: str) -> int:
    rcfg = rconfigs.REGISTRY[arch].smoke_config()
    model = ref_build(rcfg)
    params = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.float32))
    batch = {"tokens": jax.ShapeDtypeStruct((B, S), jnp.int32)}
    if rcfg.frontend != "none":
        batch["extra_embeds"] = _f32(B, rcfg.frontend_seq, rcfg.d_model)
    if kind == "prefill":
        step, args = rsteps.make_prefill_step(model, RCtx()), (params, batch)
    else:
        batch["labels"] = batch["tokens"]
        opt = roptim.AdamWConfig()
        state = jax.eval_shape(lambda: roptim.init_state(opt, params))
        step = rsteps.make_train_step(model, opt, RCtx())
        args = (params, state, batch)
    return int(analyze_hlo(jax.jit(step).lower(*args).compile().as_text())[
        "flops"])


def _port_flops(arch: str, kind: str) -> int:
    cfg = configs.get_config(arch).smoke_config()
    model = build_model(cfg)
    params = model.init(torch.Generator(), torch.float32, device="meta")
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device="meta")}
    if cfg.frontend != "none":
        batch["extra_embeds"] = _meta(B, cfg.frontend_seq, cfg.d_model)
    if kind == "prefill":
        return op_cost(steps.make_prefill_step(model), params, batch)["flops"]
    batch["labels"] = batch["tokens"]
    opt = optim.AdamWConfig()
    return op_cost(steps.make_train_step(model, opt), params,
                   optim.init_state(opt, params), batch)["flops"]


def _xent_one_hot(cfg) -> int:
    """The reference's ``xent`` takes the gold logit as a one-hot
    contraction over the vocabulary; the port gathers it: 2·B·S·V."""
    return 2 * B * S * cfg.vocab


def _gate_through_combine(cfg) -> int:
    """In the backward of each MoE layer's combine weights (``gtke, gtk,
    gtkc -> gtec``), the reference contracts the gate's cotangent over
    the C capacity slots; the port multiplies and sums: L_moe·2·G·Tg·k·C
    (one group here)."""
    from repro_torch.models.layers import moe_groups

    G, Tg, C = moe_groups(cfg, B * S)
    n_moe = cfg.n_layers - cfg.n_dense_layers
    return n_moe * 2 * G * Tg * cfg.moe.top_k * C


def _conv_taps(cfg) -> int:
    """Each Mamba2 layer's causal depthwise conv: the reference contracts
    its K-tap windows (``bskc,kc->bsc``), the port adds a tap at a time:
    n_ssm·2·B·S·(d_inner + 2·d_state)·d_conv."""
    from repro_torch.models.hybrid import _n_ssm

    s = cfg.ssm
    return _n_ssm(cfg) * 2 * B * S * (s.expand * cfg.d_model
                                      + 2 * s.d_state) * s.d_conv


#: (arch, step) -> the port's FLOPs less the reference's, itemised
DIFFERENCES = {
    ("llama3.2-1b", "prefill"): lambda cfg: 0,
    ("granite-moe-1b-a400m", "prefill"): lambda cfg: 0,
    ("rwkv6-1.6b", "prefill"): lambda cfg: 0,
    ("zamba2-7b", "prefill"): lambda cfg: -_conv_taps(cfg),
    ("whisper-tiny", "prefill"): lambda cfg: 0,
    ("llama3.2-1b", "train"): lambda cfg: -_xent_one_hot(cfg),
    ("granite-moe-1b-a400m", "train"):
        lambda cfg: -_xent_one_hot(cfg) - _gate_through_combine(cfg),
}


@pytest.mark.parametrize("arch,kind", sorted(DIFFERENCES))
def test_step_flops_match_reference_up_to_itemised_differences(arch, kind):
    cfg = configs.get_config(arch).smoke_config()
    diff = DIFFERENCES[(arch, kind)](cfg)
    assert _port_flops(arch, kind) == _ref_flops(arch, kind) + diff
    if (arch, kind) == ("zamba2-7b", "prefill"):
        assert diff == -163_840         # 2,560 flop a token at this width


# ----------------------------------------- the kernel wrappers on meta
def _recorded(fn, *args) -> tuple:
    got = op_cost(fn, *args)
    return got["flops"], got["bytes_accessed"], got["launches"], \
        got["kernels"]


def test_flash_wrapper_on_meta():
    Bb, H, Hkv, Sq, D = 2, 4, 2, 256, 64
    q, k = _meta(Bb, H, Sq, D), _meta(Bb, Hkv, Sq, D)
    out = fa.flash_attention_hm(q, k, k)
    assert out.is_meta and out.shape == q.shape and out.dtype == q.dtype
    flops = 4 * Bb * H * D * (Sq * (Sq + 1) // 2)
    nbytes = 4 * (2 * Bb * H * Sq * D + 2 * Bb * Hkv * Sq * D)
    assert _recorded(lambda q, k: fa.flash_attention_hm(q, k, k), q, k) == (
        flops, nbytes, 1, {"flash_attention_hm": 1})
    assert fa.cost(q.shape, k.shape, causal=False)["flops"] == \
        4 * Bb * H * D * Sq * Sq
    # a short query block against a longer cache sees Sq (Sq + 1) / 2
    assert fa.cost((1, 1, 128, D), (1, 1, 256, D))["exps"] == 128 * 129 // 2
    # the card's conditions hold on meta: head dim 96 is refused
    with pytest.raises(ValueError, match="head dims"):
        fa.flash_attention_hm(*(_meta(1, 2, 128, 96),) * 3)
    assert fa.flash_attention_hm.launches == 0


def test_wkv6_wrapper_on_meta():
    Bb, T, H, D = 2, 64, 3, 32
    x, u = _meta(Bb, T, H, D), _meta(H, D)
    s0 = _meta(Bb, H, D, D)
    out, state = wk.wkv6(x, x, x, x, u, s0)
    assert out.shape == x.shape and state.shape == (Bb, H, D, D)
    assert state.dtype == torch.float32 and out.is_meta
    n = Bb * T * H * D
    nbytes = 4 * (5 * n + H * D + 2 * Bb * H * D * D)
    assert _recorded(lambda *a: wk.wkv6(*a), x, x, x, x, u, s0) == (
        5 * n * (D + 1), nbytes, 1, {"wkv6": 1})
    # bf16 streams with an f32 decay and no initial state
    xb = torch.empty((Bb, T, H, D), dtype=torch.bfloat16, device="meta")
    assert wk.cost(xb.shape, 2, 4)["bytes"] == 2 * 4 * n + 4 * n + 4 * (
        H * D + Bb * H * D * D)


def test_ssd_wrapper_on_meta():
    Bb, T, H, P, N = 2, 128, 4, 16, 8
    x, dt, A, bm = _meta(Bb, T, H, P), _meta(Bb, T, H), _meta(H), \
        _meta(Bb, T, N)
    y, state = sd.ssd(x, dt, A, bm, bm)
    assert y.shape == x.shape and state.shape == (Bb, H, P, N)
    per = min(4 * P * N + P * N / L + (L + 1) * (P + 1 + N / H)
              for L in range(1, T + 1))
    flops = round(Bb * T * H * per)
    nbytes = 4 * (2 * Bb * T * H * P + Bb * T * H + H + 2 * Bb * T * N
                  + Bb * H * P * N)
    assert _recorded(lambda *a: sd.ssd(*a), x, dt, A, bm, bm) == (
        flops, nbytes, 1, {"ssd": 1})
    assert sd.least_flops(Bb, T, H, P, N) == flops
