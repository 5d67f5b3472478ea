"""internvl2-26b [vlm]: InternLM2-20B-class backbone; InternViT frontend is a
STUB (input_specs provides 256 precomputed patch embeddings).
[arXiv:2404.16821; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="internvl2-26b", family="vlm",
    n_layers=48, d_model=6144, n_heads=48, n_kv_heads=8,
    d_ff=16384, vocab=92553,
    mlp="swiglu", rope_theta=1_000_000.0,
    frontend="patch_stub", frontend_seq=256,
)
