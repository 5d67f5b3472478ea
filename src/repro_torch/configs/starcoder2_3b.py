"""starcoder2-3b [dense]: GQA, RoPE, GELU MLP with bias. [arXiv:2402.19173; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="starcoder2-3b", family="dense",
    n_layers=30, d_model=3072, n_heads=24, n_kv_heads=2,
    d_ff=12288, vocab=49152,
    qkv_bias=True, mlp="gelu", rope_theta=999_999.0,
)
