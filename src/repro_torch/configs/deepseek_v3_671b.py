"""deepseek-v3-671b [moe]: MLA + 1 shared + 256 routed top-8 experts.

61 layers (first 3 dense, d_ff=18432), d_model=7168; routed expert FF=2048.
MoE uses expert-parallel all-to-all (shard_map EP). [arXiv:2412.19437; hf]
"""
from ..models.config import ArchConfig, MLAConfig, MoEConfig

CONFIG = ArchConfig(
    name="deepseek-v3-671b", family="moe",
    n_layers=61, d_model=7168, n_heads=128, n_kv_heads=128,
    d_ff=18432, vocab=129280,
    mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                  qk_nope_head_dim=128, qk_rope_head_dim=64, v_head_dim=128),
    moe=MoEConfig(n_experts=256, top_k=8, d_ff_expert=2048, n_shared=1,
                  capacity_factor=1.25, impl="ep_a2a"),
    n_dense_layers=3,
    rope_theta=10_000.0,
)
