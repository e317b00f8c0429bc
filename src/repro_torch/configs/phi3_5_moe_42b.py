"""phi3.5-moe-42b-a6.6b [moe] — 16 experts top-2
[hf:microsoft/Phi-3.5-MoE-instruct; hf]."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="phi3.5-moe-42b-a6.6b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv=8, d_ff=6400,
    vocab=32064, head_dim=128,
    ffn_kind="moe", n_experts=16, moe_top_k=2,
    moe_groups=16,  # grouped dispatch over the data axis (§Perf: confirmed win)
    # expert-parallel ragged a2a dispatch when the recipe has a model axis;
    # grouped dispatch above stays the fallback for ineligible meshes
    moe_dispatch="ep",
)

SMOKE = ArchConfig(
    name="phi3.5-moe-smoke", family="moe",
    n_layers=2, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, ffn_kind="moe", n_experts=4, moe_top_k=2,
    attn_block=64,
)
