"""arctic-480b [moe] — 128 experts top-2 + parallel dense residual FFN
[hf:Snowflake/snowflake-arctic-base; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="arctic-480b", family="moe",
    n_layers=35, d_model=7168, n_heads=56, n_kv=8, d_ff=4864,
    vocab=32000, head_dim=128,
    ffn_kind="moe", n_experts=128, moe_top_k=2, moe_dense_residual=True,
    moe_groups=16,  # grouped dispatch over the data axis (§Perf: confirmed win)
)

SMOKE = ArchConfig(
    name="arctic-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, ffn_kind="moe", n_experts=8, moe_top_k=2,
    moe_dense_residual=True, attn_block=64,
)
