"""smollm-360m [dense]: llama-arch small.  [hf:HuggingFaceTB/SmolLM-*; hf]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="smollm-360m", family="dense",
    n_layers=32, d_model=960, n_heads=15, n_kv_heads=5,
    d_ff=2560, vocab=49152,
    mlp="swiglu", rope_theta=10_000.0, tie_embeddings=True,
)
