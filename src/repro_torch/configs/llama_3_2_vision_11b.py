"""llama-3.2-vision-11b [vlm]: a cross-attention image layer every 5th layer
[hf:meta-llama/Llama-3.2-11B-Vision].  The vision frontend is a stub: the
model takes pre-computed patch embeddings ``image_embeds`` (B, 1024, 4096);
only the transformer backbone is modeled."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b", family="vlm",
    n_layers=40, d_model=4096, n_heads=32, n_kv=8, d_ff=14336,
    vocab=128256, head_dim=128, rope_theta=500000.0,
    enc_dim=4096, enc_len=1024, cross_every=5,
    input_kind="tokens+image",
)

SMOKE = ArchConfig(
    name="llama-vision-smoke", family="vlm",
    n_layers=5, d_model=64, n_heads=4, n_kv=2, d_ff=128,
    vocab=512, head_dim=16, enc_dim=64, enc_len=16, cross_every=5,
    input_kind="tokens+image", attn_block=64,
)
