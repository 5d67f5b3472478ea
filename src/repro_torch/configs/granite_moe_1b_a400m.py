"""granite-moe-1b-a400m [moe]: 32 experts top-8, every layer MoE.
[hf:ibm-granite/granite-3.0-1b-a400m-base; hf]"""
from ..models.config import ArchConfig, MoEConfig

CONFIG = ArchConfig(
    name="granite-moe-1b-a400m", family="moe",
    n_layers=24, d_model=1024, n_heads=16, n_kv_heads=8,
    d_ff=512, vocab=49155,
    moe=MoEConfig(n_experts=32, top_k=8, d_ff_expert=512, n_shared=0,
                  capacity_factor=1.25, impl="einsum"),
    tie_embeddings=True,
)
