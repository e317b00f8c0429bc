"""Feed-forward family of the dense LM: SwiGLU and the GELU MLP.

The products are plain ``torch.matmul`` in the activation dtype: in the
reference they sit outside any Pallas kernel (XLA's dots).  MoE
(``moe_ffn`` and the expert-parallel dispatch) waits for ROADMAP queue 1
item 9.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from .module import pspec

__all__ = ["swiglu_specs", "swiglu", "gelu_mlp_specs", "gelu_mlp"]


def swiglu_specs(d_model: int, d_ff: int, dtype=torch.float32) -> dict:
    return {
        "w_gate": pspec(("m", d_model), ("f", d_ff), dtype=dtype, fan_in=("m",)),
        "w_up": pspec(("m", d_model), ("f", d_ff), dtype=dtype, fan_in=("m",)),
        "w_down": pspec(("f", d_ff), ("m", d_model), dtype=dtype, fan_in=("f",)),
    }


def swiglu(p, x):
    g = torch.matmul(x, p["w_gate"].to(x.dtype))
    u = torch.matmul(x, p["w_up"].to(x.dtype))
    return torch.matmul(F.silu(g) * u, p["w_down"].to(x.dtype))


def gelu_mlp_specs(d_model: int, d_ff: int, dtype=torch.float32) -> dict:
    return {
        "w_in": pspec(("m", d_model), ("f", d_ff), dtype=dtype, fan_in=("m",)),
        "w_out": pspec(("f", d_ff), ("m", d_model), dtype=dtype, fan_in=("f",)),
        "b_in": pspec(("f", d_ff), dtype=dtype, init="zeros"),
        "b_out": pspec(("m", d_model), dtype=dtype, init="zeros"),
    }


def gelu_mlp(p, x):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(torch.matmul(x, p["w_in"].to(x.dtype)) + p["b_in"].to(x.dtype), approximate="tanh")
    return torch.matmul(h, p["w_out"].to(x.dtype)) + p["b_out"].to(x.dtype)
