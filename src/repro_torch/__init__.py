"""repro_torch — the PyTorch / CUDA port of the layout-agnostic distributed
array algebra (``repro``), for NVIDIA Hopper GPUs.

The package imports ``torch`` and numpy only, never ``jax`` or ``repro``;
module names follow the reference package so each counterpart is easy to
find.  See ``src/repro_torch/README.md``.
"""
