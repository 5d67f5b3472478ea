"""zamba2-7b [hybrid]: Mamba2 backbone + shared attention blocks.

81 layers, d_model=3584, ssm_state=64; the single shared attention+MLP block
is applied every 6 layers (weights shared across applications).
At long context the shared attention uses a 4096 sliding window (deviation
recorded in DESIGN.md; SSM layers carry the long-range state).
[arXiv:2411.15242; unverified]
"""
from ..models.config import ArchConfig, SSMConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv_heads=32,
    d_ff=14336, vocab=32000,
    head_dim=112,
    ssm=SSMConfig(d_state=64, d_conv=4, head_dim=64, expand=2, chunk=256),
    shared_attn_every=6,
    sliding_window=4096,
)
