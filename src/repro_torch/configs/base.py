"""Architecture configuration schema and the shape cells assigned to every
architecture.

The reference's field set (``src/repro/configs/base.py``) with torch dtypes:
``param_dtype=torch.float32``, ``act_dtype=torch.bfloat16``.  Each ported
architecture has one ``configs/<id>.py`` exporting ``CONFIG`` (the published
configuration) and ``SMOKE`` (a reduced same-family config for CPU tests).
:data:`SHAPES` holds the four input-shape cells the dry run
(:mod:`repro_torch.launch.dryrun`) traces for every architecture.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "round_up"]


def round_up(x: int, mult: int) -> int:
    return ((x + mult - 1) // mult) * mult


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """A batch shape: ``global_batch`` sequences of ``seq_len`` tokens, for
    a ``train``, ``prefill`` or ``decode`` program (a decode cell's
    ``seq_len`` is its cache length)."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # 'train' | 'prefill' | 'decode'


# The four assigned input-shape cells for the LM families.
SHAPES: dict[str, ShapeCell] = {
    "train_4k": ShapeCell("train_4k", 4096, 256, "train"),
    "prefill_32k": ShapeCell("prefill_32k", 32768, 32, "prefill"),
    "decode_32k": ShapeCell("decode_32k", 32768, 128, "decode"),
    "long_500k": ShapeCell("long_500k", 524288, 1, "decode"),
}


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str  # dense | mla | moe | vlm | ssm | hybrid | audio
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int
    vocab: int
    head_dim: int = 128
    rope_theta: float = 10000.0
    qkv_bias: bool = False
    tie_embeddings: bool = False

    # ffn / moe
    ffn_kind: str = "swiglu"  # swiglu | gelu | moe
    n_experts: int = 0
    moe_top_k: int = 2
    moe_capacity_factor: float = 1.25
    moe_dense_residual: bool = False
    # grouped dispatch (GShard-style): 0/1 = one global group; set to the
    # data-parallel degree so routing/capacity stay shard-local and the
    # dispatch scatter never crosses the data axis (§Perf lever)
    moe_groups: int = 0
    # "auto" = dense/grouped capacity dispatch; "ep" = expert-parallel ragged
    # all-to-all dispatch over the model axis (the reference's models/ffn.py docstring) —
    # falls back to auto (with a warning) when the recipe cannot host it
    moe_dispatch: str = "auto"

    # MLA (minicpm3)
    mla_q_rank: int = 768
    mla_kv_rank: int = 256
    mla_d_nope: int = 64
    mla_d_rope: int = 32
    mla_d_v: int = 64

    # SSM (rwkv6 / mamba2)
    ssm_state: int = 64
    ssm_head_dim: int = 64
    ssm_expand: int = 2
    ssm_groups: int = 1
    ssm_chunk: int = 64

    # VLM (llama-3.2-vision)
    enc_dim: int = 4096
    enc_len: int = 1024
    cross_every: int = 5  # every 5th layer is cross-attention

    # hybrid (zamba2)
    shared_every: int = 6  # every 6th block is the shared attention block
    shared_lora_rank: int = 8
    shared_window: int = 4096  # long-context window for the shared attn (500k cell)

    # execution
    attn_impl: str | None = None  # None -> from the tensors' device (cuda / ref)
    attn_mixed: bool | None = None  # not read by the port (its attention is float32)
    attn_block: int = 512
    param_dtype: Any = torch.float32
    act_dtype: Any = torch.bfloat16
    remat: str = "block"  # none | block
    input_kind: str = "tokens"  # tokens | embeds | tokens+image
    notes: str = ""

    # ------------------------------------------------------------------
    @property
    def vocab_padded(self) -> int:
        """Vocab rounded up for clean sharding (Megatron-style padding)."""
        return round_up(self.vocab, 256)

    @property
    def sub_quadratic(self) -> bool:
        """Can this arch run the long_500k cell? (SSM / hybrid only)"""
        return self.family in ("ssm", "hybrid")

    def supported_shapes(self) -> list[str]:
        out = ["train_4k", "prefill_32k", "decode_32k"]
        if self.sub_quadratic:
            out.append("long_500k")
        return out

    def param_count(self, *, active_only: bool = False) -> int:
        """The parameter count (``active_only``: a token's, the MoE's
        unchosen experts left out), for MODEL_FLOPS = 6 N D."""
        from repro_torch.models import lm

        return lm.count_params(self, active_only=active_only)
