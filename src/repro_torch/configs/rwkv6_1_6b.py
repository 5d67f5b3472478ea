"""rwkv6-1.6b [ssm] "Finch": attention-free, data-dependent decay.
[arXiv:2404.05892; unverified]"""
from ..models.config import ArchConfig, RWKVConfig

CONFIG = ArchConfig(
    name="rwkv6-1.6b", family="ssm",
    n_layers=24, d_model=2048, n_heads=32, n_kv_heads=32,
    d_ff=7168, vocab=65536,
    rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
)
