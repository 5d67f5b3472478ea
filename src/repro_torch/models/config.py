"""Architecture configuration — one dataclass covering the 10 assigned archs.

A copy of the reference package's ``models/config.py``.  The one change:
``attn_impl`` takes ``"xla"`` (the reference's plain algorithms, written
as torch ops) or ``"cuda"`` (the hand-written kernels of ``csrc/``);
:func:`repro_torch.convert.config_from_reference` maps the reference's
``"pallas"`` to ``"cuda"``.

Families: dense decoder (GQA), MoE (top-k routed + shared), MLA (DeepSeek
low-rank attention), hybrid SSM (Mamba2 + shared attention), pure SSM
(RWKV6), encoder-decoder (Whisper backbone), VLM backbone (LM + patch-embed
prefix stub).
"""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Optional


@dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff_expert: int
    n_shared: int = 0            # shared (always-on) experts, DeepSeek-style
    capacity_factor: float = 1.25
    router_dtype: str = "float32"
    impl: str = "einsum"         # 'einsum' (small E) | 'ep_a2a' (shard_map EP)
    group_size: int = 512        # einsum dispatch group (tokens)
    ep_threshold: int = 4096     # below this many tokens, use einsum anyway


@dataclass(frozen=True)
class MLAConfig:
    """DeepSeek-V3 multi-head latent attention."""
    q_lora_rank: int = 1536
    kv_lora_rank: int = 512
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128


@dataclass(frozen=True)
class SSMConfig:
    d_state: int = 64
    d_conv: int = 4
    head_dim: int = 64
    expand: int = 2
    chunk: int = 256             # SSD chunk length


@dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64
    decay_lora: int = 64
    mix_lora: int = 32


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | vlm | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int

    head_dim: Optional[int] = None     # default d_model // n_heads
    qkv_bias: bool = False             # Qwen2-style
    mlp: str = "swiglu"                # swiglu | gelu
    rope_theta: float = 10_000.0
    rms_eps: float = 1e-5
    tie_embeddings: bool = False

    moe: Optional[MoEConfig] = None
    n_dense_layers: int = 0            # MoE models: leading dense layers
    mla: Optional[MLAConfig] = None
    ssm: Optional[SSMConfig] = None
    rwkv: Optional[RWKVConfig] = None

    # hybrid (Zamba2): one shared attention block applied every k SSM layers
    shared_attn_every: int = 0

    # encoder-decoder (Whisper backbone)
    encdec: bool = False
    n_encoder_layers: int = 0

    # VLM / audio frontends are stubs: inputs arrive as precomputed embeddings
    frontend: str = "none"             # none | patch_stub | frame_stub
    frontend_seq: int = 0              # prefix length supplied by the stub

    # long-context attention policy: 0 = full causal; >0 = sliding window
    sliding_window: int = 0

    # training-time policy knobs (overridable per run)
    remat: bool = True
    scan_layers: bool = True
    attn_impl: str = "xla"             # xla | cuda
    seq_shard_residual: bool = True    # Megatron-SP residual (memory vs comm)

    def hd(self) -> int:
        return self.head_dim or (self.d_model // self.n_heads)

    @property
    def is_attention_free(self) -> bool:
        return self.family == "ssm" and self.rwkv is not None

    @property
    def supports_long_context(self) -> bool:
        """Sub-quadratic path available (SSM / hybrid-with-window)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Analytic parameter count (for roofline MODEL_FLOPS)."""
        d, v = self.d_model, self.vocab
        emb = v * d * (1 if self.tie_embeddings else 2)
        total = emb
        hd = self.hd()
        for i in range(self.n_layers):
            if self.family == "ssm" and self.rwkv is not None:
                di = d * 2
                tm = d * di * 2 + di * d + (self.rwkv.decay_lora * d * 2) * 2
                cm = d * self.d_ff + self.d_ff * d
                total += tm + cm
                continue
            is_ssm_layer = (self.ssm is not None and
                            not (self.shared_attn_every and
                                 (i + 1) % self.shared_attn_every == 0))
            if is_ssm_layer and self.family == "hybrid":
                di = self.ssm.expand * d
                nheads = di // self.ssm.head_dim
                total += d * (2 * di + 2 * self.ssm.d_state + nheads) + di * d
            else:
                if self.mla is not None:
                    m = self.mla
                    total += (d * m.q_lora_rank
                              + m.q_lora_rank * self.n_heads
                              * (m.qk_nope_head_dim + m.qk_rope_head_dim)
                              + d * (m.kv_lora_rank + m.qk_rope_head_dim)
                              + m.kv_lora_rank * self.n_heads
                              * (m.qk_nope_head_dim + m.v_head_dim)
                              + self.n_heads * m.v_head_dim * d)
                else:
                    total += (d * (self.n_heads * hd)
                              + 2 * d * (self.n_kv_heads * hd)
                              + (self.n_heads * hd) * d)
            if self.moe is not None and i >= self.n_dense_layers and not is_ssm_layer:
                ff = self.moe.d_ff_expert
                per = (3 if self.mlp == "swiglu" else 2) * d * ff
                total += per * (self.moe.n_experts + self.moe.n_shared)
                total += d * self.moe.n_experts  # router
            elif not is_ssm_layer or self.family != "hybrid":
                total += (3 if self.mlp == "swiglu" else 2) * d * self.d_ff
        if self.encdec:
            # encoder layers: self-attn + mlp; decoder adds cross-attn
            enc = self.n_encoder_layers * (
                4 * d * d + (3 if self.mlp == "swiglu" else 2) * d * self.d_ff)
            cross = self.n_layers * 4 * d * d
            total += enc + cross
        return total

    def n_active_params(self) -> int:
        """Active (per-token) parameters — differs for MoE."""
        if self.moe is None:
            return self.n_params()
        full = self.n_params()
        ff = self.moe.d_ff_expert
        per = (3 if self.mlp == "swiglu" else 2) * self.d_model * ff
        n_moe_layers = self.n_layers - self.n_dense_layers
        unused = per * (self.moe.n_experts - self.moe.top_k) * n_moe_layers
        return full - unused

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def smoke_config(self) -> "ArchConfig":
        """A tiny same-family config for CPU smoke tests."""
        kw = dict(
            n_layers=min(self.n_layers, 2),
            d_model=64,
            n_heads=4,
            n_kv_heads=min(self.n_kv_heads, 2) if self.n_kv_heads < self.n_heads else 4,
            d_ff=128,
            vocab=256,
            head_dim=16,
            frontend_seq=8 if self.frontend != "none" else 0,
        )
        if self.moe is not None:
            # drop-free capacity so prefill/decode consistency is exact
            kw["moe"] = dataclasses.replace(
                self.moe, n_experts=4, top_k=2, d_ff_expert=64,
                n_shared=min(self.moe.n_shared, 1), capacity_factor=4.0)
            kw["n_dense_layers"] = min(self.n_dense_layers, 1)
        if self.mla is not None:
            kw["mla"] = MLAConfig(q_lora_rank=32, kv_lora_rank=16,
                                  qk_nope_head_dim=16, qk_rope_head_dim=8,
                                  v_head_dim=16)
        if self.ssm is not None:
            kw["ssm"] = dataclasses.replace(self.ssm, d_state=16, head_dim=16,
                                            chunk=8)
            kw["n_layers"] = min(self.n_layers, 4)
        if self.rwkv is not None:
            kw["rwkv"] = RWKVConfig(head_dim=16, decay_lora=8, mix_lora=8)
        if self.shared_attn_every:
            kw["shared_attn_every"] = 2
            kw["n_layers"] = 4
        if self.encdec:
            kw["n_encoder_layers"] = 2
        if self.sliding_window:
            kw["sliding_window"] = 16
        return self.replace(**kw)
