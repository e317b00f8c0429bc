"""internlm2-20b [dense] — GQA [arXiv:2403.17297; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="internlm2-20b", family="dense",
    n_layers=48, d_model=6144, n_heads=48, n_kv=8, d_ff=16384,
    vocab=92544, head_dim=128, rope_theta=1000000.0,
)

SMOKE = ArchConfig(
    name="internlm2-smoke", family="dense",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, attn_block=64,
)
