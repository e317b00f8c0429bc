"""minicpm3-4b [dense/MLA] — Multi-head Latent Attention
[hf:openbmb/MiniCPM3-4B; hf].  MLA ranks follow the HF config family
(q_lora_rank=768, kv_lora_rank=256, nope/rope head dims 64/32)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="minicpm3-4b", family="mla",
    n_layers=62, d_model=2560, n_heads=40, n_kv=40, d_ff=6400,
    vocab=73448, head_dim=64,
    mla_q_rank=768, mla_kv_rank=256, mla_d_nope=64, mla_d_rope=32, mla_d_v=64,
    tie_embeddings=True,
    notes="vocab padded to 73728 for sharding (Megatron-style)",
)

SMOKE = ArchConfig(
    name="minicpm3-smoke", family="mla",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=512, head_dim=16,
    mla_q_rank=32, mla_kv_rank=16, mla_d_nope=16, mla_d_rope=8, mla_d_v=16,
    attn_block=64,
)
