"""Configurations of the port: the case study's GEMM sizes and the model
architectures.  ``repro_torch.configs.get("phi4-mini-3.8b")``
resolves an architecture (its published config, or ``smoke=True`` for the
reduced CPU one)."""
from importlib import import_module

from .base import SHAPES, ArchConfig, ShapeCell

_MODULES = {
    "phi4-mini-3.8b": "phi4_mini_3_8b",
    "qwen2.5-32b": "qwen2_5_32b",
    "phi3.5-moe-42b-a6.6b": "phi3_5_moe_42b",
    "arctic-480b": "arctic_480b",
    "minicpm3-4b": "minicpm3_4b",
    "internlm2-20b": "internlm2_20b",
    "zamba2-7b": "zamba2_7b",
    "rwkv6-3b": "rwkv6_3b",
    "llama-3.2-vision-11b": "llama_3_2_vision_11b",
    "musicgen-large": "musicgen_large",
}

ARCH_IDS = list(_MODULES)


def get(name: str, *, smoke: bool = False) -> ArchConfig:
    if name not in _MODULES:
        raise KeyError(f"unknown arch {name!r}; known: {ARCH_IDS}")
    mod = import_module(f"repro_torch.configs.{_MODULES[name]}")
    return mod.SMOKE if smoke else mod.CONFIG


__all__ = ["ArchConfig", "ShapeCell", "SHAPES", "ARCH_IDS", "get"]
