"""zamba2-7b [hybrid] — Mamba2 blocks + shared attention block every 6th
position, per-application LoRA adapters [arXiv:2411.15242; unverified].
81 blocks = 13 super-blocks of (5 mamba + 1 shared-attn) + 3 tail mamba.
Long-context (500k) runs the shared attention with a 4096 ring-buffer
window (the cache's size; the forward attends over the whole prefix)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="zamba2-7b", family="hybrid",
    n_layers=81, d_model=3584, n_heads=32, n_kv=32, d_ff=14336,
    vocab=32000, head_dim=112,
    ssm_state=64, ssm_head_dim=64, ssm_expand=2, ssm_groups=1,
    shared_every=6, shared_lora_rank=8, shared_window=4096,
)

SMOKE = ArchConfig(
    name="zamba2-smoke", family="hybrid",
    n_layers=13, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=512, head_dim=16,
    ssm_state=16, ssm_head_dim=16, ssm_expand=2, ssm_groups=1,
    shared_every=6, shared_lora_rank=4, shared_window=64, ssm_chunk=16,
)
