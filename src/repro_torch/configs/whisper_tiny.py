"""whisper-tiny [audio]: enc-dec backbone; conv frontend is a STUB
(input_specs provides 1500 precomputed frame embeddings).
[arXiv:2212.04356; unverified]"""
from ..models.config import ArchConfig

CONFIG = ArchConfig(
    name="whisper-tiny", family="audio",
    n_layers=4, d_model=384, n_heads=6, n_kv_heads=6,
    d_ff=1536, vocab=51865,
    mlp="gelu",
    encdec=True, n_encoder_layers=4,
    frontend="frame_stub", frontend_seq=1536,  # 1500 mel frames padded to the 512-tile boundary
)
