"""musicgen-large [audio]: a decoder-only model over EnCodec tokens
[arXiv:2306.05284].  The EnCodec frontend is a stub: the model takes
pre-computed frame embeddings ``embeds`` (B, S, d_model), adds sinusoidal
positions, and its FFN is the GELU MLP (MusicGen's convention)."""
from .base import ArchConfig

CONFIG = ArchConfig(
    name="musicgen-large", family="audio",
    n_layers=48, d_model=2048, n_heads=32, n_kv=32, d_ff=8192,
    vocab=2048, head_dim=64, ffn_kind="gelu", input_kind="embeds",
)

SMOKE = ArchConfig(
    name="musicgen-smoke", family="audio",
    n_layers=2, d_model=64, n_heads=4, n_kv=4, d_ff=128,
    vocab=128, head_dim=16, ffn_kind="gelu", input_kind="embeds",
    attn_block=64,
)
