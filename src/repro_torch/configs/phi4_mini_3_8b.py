"""phi4-mini-3.8b [dense] — RoPE SwiGLU GQA [arXiv:2412.08905; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi4-mini-3.8b", family="dense",
    n_layers=32, d_model=3072, n_heads=24, n_kv=8, d_ff=8192,
    vocab=200064, head_dim=128, rope_theta=10000.0,
    tie_embeddings=True,
)

SMOKE = ArchConfig(
    name="phi4-mini-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, attn_block=64,
)
