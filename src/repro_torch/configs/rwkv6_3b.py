"""rwkv6-3b (Finch) [ssm] — attention-free, data-dependent decay
[arXiv:2404.05892; hf].  n_heads = d_model / 64 (head size 64)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="rwkv6-3b", family="ssm",
    n_layers=32, d_model=2560, n_heads=40, n_kv=40, d_ff=8960,
    vocab=65536, head_dim=64, ssm_chunk=64,
)

SMOKE = ArchConfig(
    name="rwkv6-smoke", family="ssm",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=512, head_dim=16, ssm_chunk=16,
)
