"""Deterministic, resumable data pipeline: the port of
``src/repro/data/pipeline.py``, in numpy, so its batches are the
reference's, bit for bit, for every step.

Two sources:
  * ``synthetic``: structured pseudo-text (Zipfian tokens with short-range
    copies, so the loss actually decreases) generated per (seed, step):
    restart-anywhere determinism, the property that makes checkpoint and
    restart exact;
  * ``memmap``: a flat binary token file (``np.memmap``), strided by step.

A batch is a dict of numpy arrays; under a sharding recipe each rank cuts
its blocks of it on the host (``repro_torch.models.sharding.local_batch``)
and :func:`to_device` moves what it holds to its device.
:func:`batch_specs` gives the shapes and dtypes without making a batch.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.configs.base import ShapeCell

__all__ = ["DataConfig", "ShapeCell", "make_batch", "batch_specs", "to_device"]


@dataclasses.dataclass(frozen=True)
class DataConfig:
    source: str = "synthetic"  # synthetic | memmap
    seed: int = 0
    path: str | None = None  # for memmap
    zipf_a: float = 1.2


def _synthetic_tokens(rng: np.random.Generator, B: int, S: int, vocab: int, a: float):
    """Zipfian marginals + Markov-ish repetition: 30% of positions copy the
    token 2 back, a learnable structure for loss-curve tests."""
    base = rng.zipf(a, size=(B, S + 1)) % vocab
    copy_mask = rng.random((B, S + 1)) < 0.3
    out = base.copy()
    out[:, 2:] = np.where(copy_mask[:, 2:], out[:, :-2], out[:, 2:])
    return out.astype(np.int32)


def make_batch(cfg, shape, step: int, dcfg: DataConfig = DataConfig()) -> dict:
    """Batch dict for (arch cfg, :class:`ShapeCell`, step), a pure function
    of its inputs.  ``tokens`` input: int32 (B, S) ``tokens`` and
    ``labels`` (the tokens shifted by one); ``tokens+image`` adds the
    stub vision frontend's float32 ``image_embeds`` (B, enc_len, enc_dim);
    ``embeds`` input: the stub codec's float32 ``embeds`` (B, S, d_model)
    and int32 ``labels``.  Every draw comes from one generator in the
    reference's order, so the batch is the reference's, bit for bit."""
    B, S = shape.global_batch, shape.seq_len
    rng = np.random.default_rng(np.random.SeedSequence([dcfg.seed, step]))
    if cfg.input_kind == "embeds":
        emb = rng.standard_normal((B, S, cfg.d_model), dtype=np.float32)
        return {"embeds": emb, "labels": rng.integers(0, cfg.vocab, (B, S), dtype=np.int32)}
    if dcfg.source == "memmap":
        data = np.memmap(dcfg.path, dtype=np.int32, mode="r")
        need = B * (S + 1)
        start = (step * need) % max(len(data) - need, 1)
        toks = np.asarray(data[start:start + need]).reshape(B, S + 1) % cfg.vocab
    else:
        toks = _synthetic_tokens(rng, B, S, cfg.vocab, dcfg.zipf_a)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.input_kind == "tokens+image":
        batch["image_embeds"] = rng.standard_normal((B, cfg.enc_len, cfg.enc_dim),
                                                    dtype=np.float32)
    return batch


def batch_specs(cfg, shape) -> dict:
    """``{name: (shape, numpy dtype)}`` of every model input of a cell."""
    B = shape.global_batch
    S = shape.seq_len if shape.kind != "decode" else 1
    if cfg.input_kind == "embeds":
        out = {"embeds": ((B, S, cfg.d_model), np.dtype(np.float32))}
    else:
        out = {"tokens": ((B, S), np.dtype(np.int32))}
    if shape.kind == "train":
        out["labels"] = ((B, S), np.dtype(np.int32))
    if cfg.input_kind == "tokens+image":
        out["image_embeds"] = ((B, cfg.enc_len, cfg.enc_dim), np.dtype(np.float32))
    return out


def to_device(batch: dict, device) -> dict:
    """A numpy batch on ``device``: token ids and labels as int64 tensors,
    the ``embeds`` and ``image_embeds`` inputs as float32.  A rank's blocks
    (``sharding.RankBatch``) stay one, their global shapes kept."""
    import torch

    from repro_torch.models.sharding import RankBatch

    def one(v):
        return torch.from_numpy(v).to(device=device, dtype=torch.long if v.dtype.kind in "iu"
                                      else torch.float32)

    if isinstance(batch, RankBatch):
        return batch.map(one)
    return {k: one(v) for k, v in batch.items()}
