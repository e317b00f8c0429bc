"""qwen2.5-32b [dense] — GQA with QKV bias [hf:Qwen/Qwen2.5-*; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="qwen2.5-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=40, n_kv=8, d_ff=27648,
    vocab=152064, head_dim=128, rope_theta=1000000.0, qkv_bias=True,
)

SMOKE = ArchConfig(
    name="qwen2.5-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, qkv_bias=True, attn_block=64,
)
