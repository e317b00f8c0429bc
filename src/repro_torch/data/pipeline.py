"""Deterministic, resumable data pipeline: the port of
``src/repro/data/pipeline.py``, in numpy, so its batches are the
reference's, bit for bit, for every step.

Two sources:
  * ``synthetic``: structured pseudo-text (Zipfian tokens with short-range
    copies, so the loss actually decreases) generated per (seed, step):
    restart-anywhere determinism, the property that makes checkpoint and
    restart exact;
  * ``memmap``: a flat binary token file (``np.memmap``), strided by step.

A batch is a dict of numpy arrays; the trainer moves it to its device.
:func:`batch_specs` gives the shapes and dtypes without making a batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

__all__ = ["DataConfig", "ShapeCell", "make_batch", "batch_specs"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"  # synthetic | memmap
    seed: int = 0
    path: str | None = None  # for memmap
    zipf_a: float = 1.2


@dataclasses.dataclass(frozen=True)
class ShapeCell:
    """A batch shape: the reference's ``configs.base.ShapeCell``."""

    name: str
    seq_len: int
    global_batch: int
    kind: str  # train | prefill | decode


def _synthetic_tokens(rng: np.random.Generator, B: int, S: int, vocab: int, a: float):
    """Zipfian marginals + Markov-ish repetition: 30% of positions copy the
    token 2 back, a learnable structure for loss-curve tests."""
    base = rng.zipf(a, size=(B, S + 1)) % vocab
    copy_mask = rng.random((B, S + 1)) < 0.3
    out = base.copy()
    out[:, 2:] = np.where(copy_mask[:, 2:], out[:, :-2], out[:, 2:])
    return out.astype(np.int32)


def make_batch(cfg, shape, step: int, dcfg: DataConfig = DataConfig()) -> dict:
    """Batch dict for (arch cfg, :class:`ShapeCell`, step): ``tokens`` and
    ``labels`` (the tokens shifted by one), int32 (B, S).  A pure function
    of its inputs."""
    if cfg.input_kind != "tokens":
        raise NotImplementedError(f"input_kind {cfg.input_kind!r} is not ported yet: "
                                  "ROADMAP.md queue 1, item 6")
    B, S = shape.global_batch, shape.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step]))
    if dcfg.source == "memmap":
        data = np.memmap(dcfg.path, dtype=np.int32, mode="r")
        need = B * (S + 1)
        start = (step * need) % max(len(data) - need, 1)
        toks = np.asarray(data[start:start + need]).reshape(B, S + 1) % cfg.vocab
    else:
        toks = _synthetic_tokens(rng, B, S, cfg.vocab, dcfg.zipf_a)
    return {"tokens": toks[:, :-1], "labels": toks[:, 1:]}


def batch_specs(cfg, shape) -> dict:
    """``{name: (shape, numpy dtype)}`` of every model input of a cell."""
    if cfg.input_kind != "tokens":
        raise NotImplementedError(f"input_kind {cfg.input_kind!r} is not ported yet: "
                                  "ROADMAP.md queue 1, item 6")
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    out = {"tokens": ((B, S), np.dtype(np.int32))}
    if shape.kind == "train":
        out["labels"] = ((B, S), np.dtype(np.int32))
    return out
