"""qwen2.5-3b [dense]: GQA with QKV bias.  [hf:Qwen/Qwen2.5-*; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-3b", family="dense",
    n_layers=36, d_model=2048, n_heads=16, n_kv_heads=2,
    d_ff=11008, vocab=151936,
    qkv_bias=True, mlp="swiglu", rope_theta=1_000_000.0,
    tie_embeddings=True,
)
