"""Dry run: one rank's program of every (arch x shape) cell at the
production mesh, traced on fake tensors, with its memory and cost; and the
comm plans' overlap gates.  The port of ``src/repro/launch/dryrun.py``.

For each cell (:func:`iter_cells`) :func:`lower_cell` traces rank
``--rank`` of a 16 x 16 ``(data, model)`` mesh (``--multi-pod``: 2 x 16 x
16 ``(pod, data, model)``) on a world of 256 (512) ranks of
``torch.distributed``'s ``fake`` backend, in this one process, under
``FakeTensorMode``: every tensor has its real shape and none is allocated.

  * train_4k     -> ``make_train_step`` (forward, backward, AdamW)
  * prefill_32k  -> ``lm.forward`` under the recipe
  * decode/long  -> ``make_serve_step`` on ``lm.init_cache`` (one token
                    against the whole cache)

The parameters are this rank's shards (``lm.abstract_model``), the batch is
this rank's blocks of the global batch (``sharding.local_batch_shapes``, the
reference's ``batch_shardings``; a train cell's rows laid out for its
microbatches, a decode cell's rows), made at their local shapes with the
global shapes attached (``sharding.RankBatch``), so ``batch_bytes`` is a
rank's.
``--device cuda`` (the default) traces the card's program, with the port's
kernels standing in for their launches (``repro_torch.kernels.fake``);
``--device cpu`` traces the plain versions.  The op walk
(:mod:`repro_torch.launch.op_walk`) gives the rank's peak memory above its
inputs, its operations, bytes and collectives with their overlap verdicts,
and :mod:`repro_torch.launch.roofline` the three roofline terms, for an
NVIDIA H100 80GB HBM3 at 700 W from its data sheet: a prediction, not a
measurement.

Usage:
  python -m repro_torch.launch.dryrun --arch qwen2.5-32b --shape train_4k
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--out build/dryrun]
  python -m repro_torch.launch.dryrun --summa-gemm   # SUMMA ring: 0 serialized gate
  python -m repro_torch.launch.dryrun --uneven       # ragged SUMMA ring
  python -m repro_torch.launch.dryrun --sp-ring      # ring attention
  python -m repro_torch.launch.dryrun --serve        # serving TP decode
  python -m repro_torch.launch.dryrun --moe          # expert-parallel MoE dispatch
  python -m repro_torch.launch.dryrun --train        # ZeRO-2 train step
  python -m repro_torch.launch.dryrun --plan-report build/dryrun/plan.json

The program gates run each comm plan's program on a fake world with real
small CPU tensors (the fake backend moves no data, so their values mean
nothing: the programs' numerics are held on gloo by the tests), walk its op
stream and hold the plan's *declared* overlap intent
(:func:`repro_torch.core.plan.intent_of`) against the walk's verdict; each
has a negative control that must come out serialized.  ``--plan-report``
runs all of them and writes the per-plan agreement table.

Eager execution orders what XLA's scheduler may move: a blocking ring waits
each rotation before the step that reads it, so where the ring carries
values that compute produced (the sp ring's K/V) its transfers sit on the
chain.  The reference's dataflow walker calls its blocking sp ring
overlapped; here the blocking ring is the sp ring gate's negative control,
and the gate's second program is the card's (the carry kernel on fake
tensors).  The SUMMA ring's panels are never computed, so both of its forms
stay overlapped, as the reference's do.
"""
from __future__ import annotations

import argparse
import dataclasses
from contextlib import nullcontext
import json
import math
import os
import time
import traceback
from types import SimpleNamespace

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.configs import SHAPES, ShapeCell
from repro_torch.core.dist import init_fake_world, is_fake_world, make_mesh
from repro_torch.core.plan import intent_of
from repro_torch.data.pipeline import batch_specs
from repro_torch.kernels.fake import card_trace
from repro_torch.models import lm
from repro_torch.models.module import tree_leaves
from repro_torch.models.sharding import RankBatch, local_batch_shapes, make_recipe, use_recipe
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import make_serve_step, make_train_step

from . import op_walk
from . import roofline as rl

__all__ = ["lower_cell", "iter_cells", "make_production_mesh", "summa_dryrun",
           "ragged_summa_dryrun", "sp_ring_dryrun", "serve_dryrun", "moe_dryrun",
           "train_dryrun", "plan_report", "main"]

_NP_TORCH = {np.dtype(np.int32): torch.int32, np.dtype(np.float32): torch.float32}


def fake_world(size: int, rank: int = 0) -> None:
    """A fake world of ``size`` ranks playing ``rank`` (the one running is
    kept when it fits, replaced when it is fake and does not; a real world
    is refused)."""
    if dist.is_initialized():
        if not is_fake_world():
            raise RuntimeError("the dry run needs a fake world; a real one is running")
        if dist.get_world_size() == size and dist.get_rank() == rank:
            return
        dist.destroy_process_group()
    init_fake_world(size, rank, "cpu")


def make_production_mesh(*, multi_pod: bool = False, device="cpu"):
    """16 x 16 ranks a pod ``(data, model)``; two pods add a leading
    ``pod`` axis.  Needs a world of 256 (512) ranks."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return make_mesh(shape, axes, device=device)


def _apply_overrides(cfg, sets: list[str]):
    if not sets:
        return cfg
    kw = {}
    for s in sets:
        k, v = s.split("=", 1)
        if k.endswith("dtype"):
            kw[k] = getattr(torch, v)  # 'bfloat16', 'float32'
            continue
        current = getattr(cfg, k)
        if isinstance(current, bool) or v.lower() in ("true", "false"):
            kw[k] = v.lower() in ("1", "true")
        elif current is None:
            kw[k] = v
        else:
            kw[k] = type(current)(v)
    return dataclasses.replace(cfg, **kw)


def _nbytes(tree) -> int:
    leaves = tree_leaves(tree) if isinstance(tree, dict) else _flat(tree)
    return sum(t.numel() * t.element_size() for t in leaves)


def _flat(x) -> list:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _flat(v)]
    if isinstance(x, (tuple, list)):
        return [t for v in x for t in _flat(v)]
    return []


def _rank_batch(cfg, shape, recipe, dev, microbatches: int) -> RankBatch:
    """This rank's blocks of a cell's global batch, empty tensors of their
    local shapes: a train cell's laid out for ``microbatches``, a decode
    cell's rows."""
    specs = batch_specs(cfg, shape)
    shapes = {n: s for n, (s, _) in specs.items()}
    k = microbatches if shape.kind == "train" else 1
    local = local_batch_shapes(recipe, shapes, microbatches=k, decode=shape.kind == "decode")
    return RankBatch({n: torch.empty(local[n], dtype=_NP_TORCH[d], device=dev)
                      for n, (_, d) in specs.items()}, shapes, k)


def lower_cell(arch: str, shape_name: str, *, multi_pod: bool = False, attn_mode: str = "auto",
               microbatches: int = 1, sets: list[str] | None = None, rank: int = 0,
               device: str = "cuda", verbose: bool = True) -> dict:
    """Trace rank ``rank``'s program of one cell on fake tensors; returns
    its record (memory, cost, roofline, overlap, trace seconds)."""
    cfg = _apply_overrides(configs.get(arch), sets or [])
    shape = SHAPES[shape_name]
    fake_world(512 if multi_pod else 256, rank)
    mode, dev = card_trace(device)
    mesh = make_production_mesh(multi_pod=multi_pod, device=dev)
    chips = math.prod(mesh.shape.values())
    recipe = make_recipe(cfg, mesh, attn_mode=attn_mode)
    t0 = time.time()
    with mode:
        params = lm.abstract_model(cfg, recipe=recipe, device=dev)
        batch = _rank_batch(cfg, shape, recipe, dev, microbatches)
        mem = {"param_bytes": _nbytes(params), "batch_bytes": _nbytes(batch),
               "optimizer_bytes": 0, "state_bytes": 0}
        if shape.kind == "train":
            ocfg = OptConfig()
            opt = init_opt_state(params, ocfg)
            mem["optimizer_bytes"] = _nbytes(opt)
            step = make_train_step(cfg, recipe, ocfg, microbatches=microbatches)
            with op_walk.OpWalk() as walk:
                out = step(params, opt, batch)
        elif shape.kind == "prefill":
            with op_walk.OpWalk() as walk:
                with use_recipe(recipe), torch.no_grad():
                    out = lm.forward(params, batch, cfg)
        else:  # decode: one token against the whole cache
            B = shape.global_batch
            with use_recipe(recipe):
                caches = lm.init_cache(cfg, B, shape.seq_len, device=dev)
            state = lm.DecodeState(caches=caches,
                                   positions=torch.zeros((B,), dtype=torch.int32, device=dev))
            mem["state_bytes"] = _nbytes(state)
            step = make_serve_step(cfg, recipe)
            with op_walk.OpWalk() as walk:
                out = step(params, state, batch)
        del out
    trace_s = time.time() - t0
    st = walk.stats()
    mem["peak_live_bytes"] = st.peak_live_bytes
    mem["total_bytes"] = sum(mem.values())
    mem["fits"] = mem["total_bytes"] <= rl.HW["hbm_bytes"]
    rep = rl.roofline_report(arch=arch, shape=shape_name,
                             mesh_name="2x16x16" if multi_pod else "16x16", chips=chips,
                             stats=st, model_flops=_model_flops(cfg, shape))
    record = {
        "arch": arch,
        "shape": shape_name,
        "mesh": rep.mesh,
        "chips": chips,
        "rank": rank,
        "device": device,
        "traced_on": str(dev),
        "attn_mode": recipe.attn_mode,
        "sp_ring": recipe.sp_ring,
        "trace_seconds": round(trace_s, 1),
        "ops": st.n_ops,
        "memory": mem,
        "largest_storage_bytes": st.largest_storage_bytes,
        "cost": {"flops": st.flops, "bytes accessed": st.bytes},
        "kernel_launches": st.kernel_launches,
        "roofline": rep.to_json(),
        "prediction_for": rl.CARD,
    }
    if verbose:
        print(json.dumps({k: v for k, v in record.items() if k != "roofline"}))
        print("  roofline:", json.dumps({
            k: record["roofline"][k]
            for k in ("t_compute", "t_memory", "t_collective", "dominant", "useful_ratio",
                      "roofline_fraction")}))
        print("  overlap:", json.dumps({
            k: record["roofline"][k]
            for k in ("collectives_overlapped", "collectives_serialized",
                      "collective_overlap_fraction", "coll_exposed_bytes",
                      "t_collective_exposed")}))
    return record


def _model_flops(cfg, shape) -> float:
    """MODEL_FLOPS = 6 N D (dense) / 6 N_active D (MoE) for training, 2 N D
    for a prefill; a decode step's D is the batch (one token a row)."""
    n = lm.count_params(cfg, active_only=True)
    if shape.kind == "train":
        return 6.0 * n * shape.global_batch * shape.seq_len
    if shape.kind == "prefill":
        return 2.0 * n * shape.global_batch * shape.seq_len
    return 2.0 * n * shape.global_batch


def iter_cells():
    for arch in configs.ARCH_IDS:
        cfg = configs.get(arch)
        for shape_name in SHAPES:
            if shape_name == "long_500k" and not cfg.sub_quadratic:
                yield arch, shape_name, "skip"
            else:
                yield arch, shape_name, "run"


# ================================================================ gates ====

def _walk(fn, *args, valid_fractions=None):
    with op_walk.OpWalk() as walk:
        fn(*args)
    return walk.stats(valid_fractions=valid_fractions)


def _tiles(meta) -> tuple[torch.Tensor, torch.Tensor]:
    return (torch.zeros(meta["A_tile"].shape, dtype=torch.float32),
            torch.zeros(meta["B_tile"].shape, dtype=torch.float32))


def summa_dryrun(*, ni: int = 256, nj: int = 256, nk: int = 256,
                 grid: tuple[int, int] = (2, 4), majors: str = "I/I/K",
                 verbose: bool = True) -> dict:
    """The SUMMA ring program (both forms) walked on a fake world: every
    collective classified (the ring's collective-permutes and the
    reduce-scatter epilogue) and the permute bytes against the analytic
    comm-volume model."""
    from repro_torch.examples import distributed_gemm as dg

    fake_world(math.prod(grid))
    mesh = make_mesh(grid, ("rows", "cols"), device="cpu")
    out: dict = {"ni": ni, "nj": nj, "nk": nk, "grid": list(grid), "majors": majors}
    for variant, db in (("double_buffered", True), ("blocking", False)):
        fn, meta = dg.summa_ring_program(ni=ni, nj=nj, nk=nk, grid=grid, majors=majors,
                                         mesh=mesh, double_buffer=db, device="cpu")
        st = _walk(fn, *_tiles(meta))
        out[variant] = {
            "collective_permutes": len(st.of_kind("collective-permute")),
            "overlapped": st.collectives_overlapped("collective-permute"),
            "serialized": st.collectives_serialized("collective-permute"),
            "permute_overlap_fraction": st.overlap_fraction("collective-permute"),
            "op_permute_bytes": st.coll_by_op.get("collective-permute", 0.0),
            "model_ring_bytes": meta["comm_model"]["ring_bytes"],
            "model_total_bytes": meta["comm_model"]["total_bytes"],
            "collectives_serialized_any_kind": st.collectives_serialized(),
            "collectives_overlapped_any_kind": st.collectives_overlapped(),
            "exposed_bytes": st.exposed_collective_bytes(),
            "overlap_by_kind": st.overlap_by_kind(),
            "plan": op_walk.plan_agreement(st, meta["plan_intent"]),
        }
    if verbose:
        print(json.dumps(out, indent=1))
    return out


def ragged_summa_dryrun(*, ni: int = 35, nj: int = 35, nk: int = 35,
                        grid: tuple[int, int] = (2, 4), majors: str = "I/I/K",
                        verbose: bool = True) -> dict:
    """The ragged SUMMA ring (dims that divide no grid side): 0 serialized,
    the walk's wire bytes equal to the padded ring model and its valid
    bytes to the ragged (payload) model."""
    from repro_torch.examples import distributed_gemm as dg

    fake_world(math.prod(grid))
    mesh = make_mesh(grid, ("rows", "cols"), device="cpu")
    out: dict = {"ni": ni, "nj": nj, "nk": nk, "grid": list(grid), "majors": majors,
                 "ragged": True}
    for variant, db in (("double_buffered", True), ("blocking", False)):
        fn, meta = dg.ragged_summa_program(ni=ni, nj=nj, nk=nk, grid=grid, majors=majors,
                                           mesh=mesh, double_buffer=db, device="cpu")
        model = meta["comm_model"]
        st = _walk(fn, *_tiles(meta), valid_fractions=model["valid_fractions"])
        wire = st.coll_by_op.get("collective-permute", 0.0)
        valid = st.coll_by_op_valid.get("collective-permute", 0.0)
        out[variant] = {
            "collectives": len(st.collectives),
            "collective_permutes": len(st.of_kind("collective-permute")),
            "overlapped": st.collectives_overlapped(),
            "serialized": st.collectives_serialized(),
            "exposed_bytes": st.exposed_collective_bytes(),
            "op_wire_permute_bytes": wire,
            "op_valid_permute_bytes": valid,
            "model_ring_padded_bytes": model["ring_padded_bytes"],
            "model_ring_valid_bytes": model["ring_bytes"],
            "wire_matches_padded_model": wire == model["ring_padded_bytes"],
            "valid_matches_ragged_model": abs(valid - model["ring_bytes"]) < 1e-6,
            "overlap_by_kind": st.overlap_by_kind(),
            "plan": op_walk.plan_agreement(st, meta["plan_intent"]),
        }
    if verbose:
        print(json.dumps(out, indent=1))
    return out


def sp_ring_dryrun(*, batch: int = 2, seq: int = 256, d_model: int = 64, n_heads: int = 4,
                   n_kv: int = 2, head_dim: int = 16, grid: tuple[int, int] = (2, 4),
                   device: str = "cpu", verbose: bool = True) -> dict:
    """The sequence-parallel ring attention of one rank (QKV projections of
    its chunk, the KV ring, the output projection) under an ``sp_ring``
    recipe, both forms.  The double-buffered ring must serialize nothing;
    its blocking form, waiting each rotation of the projected K/V before the
    step that reads it, is the negative control.  ``seq`` that does not
    divide the model axis runs the ragged ring (padded capacity chunks,
    masked keys): the permute bytes are then discounted by the valid
    fraction ``seq / (R * cap)``.  ``device="cuda"`` traces the card's
    program on fake tensors (the carry kernel standing in for its launches;
    the kernel's head dims: 64, 112, 128)."""
    from repro_torch.models import attention as attn
    from repro_torch.models.sharding import ragged_seq_extents

    fake_world(math.prod(grid))
    D_ax, R = grid
    cfg = SimpleNamespace(n_heads=n_heads, n_kv=n_kv, head_dim=head_dim, d_model=d_model,
                          d_ff=4 * d_model, vocab_padded=256, n_experts=0, family="dense")
    cap, _ = ragged_seq_extents(seq, R)
    valid_fractions = {"collective-permute": seq / (R * cap)} if seq % R else None
    out: dict = {"batch": batch, "seq": seq, "d_model": d_model, "n_heads": n_heads,
                 "n_kv": n_kv, "head_dim": head_dim, "grid": list(grid),
                 "ragged_seq": bool(seq % R), "device": device, "valid_fraction":
                 None if valid_fractions is None else valid_fractions["collective-permute"]}
    mode, dev = card_trace(device) if device == "cuda" else (nullcontext(), torch.device("cpu"))
    mesh = make_mesh(grid, ("data", "model"), device=dev)
    recipe = make_recipe(cfg, mesh, attn_mode="sp_ring")
    r = mesh.coords()["model"]
    for variant, db in (("double_buffered", True), ("blocking", False)):
        with mode:
            dt = torch.bfloat16 if device == "cuda" else torch.float32
            p = {"wq": torch.zeros((d_model, n_heads, head_dim), dtype=dt, device=dev),
                 "wk": torch.zeros((d_model, n_kv, head_dim), dtype=dt, device=dev),
                 "wv": torch.zeros((d_model, n_kv, head_dim), dtype=dt, device=dev),
                 "wo": torch.zeros((n_heads, head_dim, d_model), dtype=dt, device=dev)}
            x = torch.zeros((batch // D_ax, cap, d_model), dtype=dt, device=dev)
            positions = r * cap + torch.arange(cap, device=dev)

            def fwd(_db=db):
                with use_recipe(recipe), torch.no_grad():
                    return attn.gqa_attention(p, x, n_heads=n_heads, n_kv=n_kv,
                                              head_dim=head_dim, positions=positions,
                                              seq_len=seq, sp_ring_double_buffer=_db)

            st = _walk(fwd, valid_fractions=valid_fractions)
        out[variant] = {
            "collectives": len(st.collectives),
            "overlapped": st.collectives_overlapped(),
            "serialized": st.collectives_serialized(),
            "exposed_bytes": st.exposed_collective_bytes(),
            "op_wire_permute_bytes": st.coll_by_op.get("collective-permute", 0.0),
            "op_valid_permute_bytes": st.coll_by_op_valid.get("collective-permute", 0.0),
            "overlap_by_kind": st.overlap_by_kind(),
            "kernel_launches": st.kernel_launches,
            "expected_ring_transfers": 2 * (R - 1),
            "plan": op_walk.plan_agreement(st, intent_of("ring"),
                                           kind="collective-permute"),
            "boundary_serialized": (st.collectives_serialized()
                                    - st.collectives_serialized("collective-permute")),
        }
    if verbose:
        print(json.dumps(out, indent=1))
    return out


def serve_dryrun(*, arch: str = "phi4-mini-3.8b", slots: int = 8, max_len: int = 64,
                 grid: tuple[int, int] = (4, 2), microbatches: int = 2,
                 verbose: bool = True) -> dict:
    """One continuous-batching decode step of the explicit tensor-parallel
    decode (:func:`repro_torch.serve.tp_decode.make_tp_decode_step`) on a
    ``(data, model)`` fake world: with ``microbatches >= 2`` the staggered
    schedule serializes nothing and agrees with the declared ``stagger``
    intent; ``microbatches=1`` is the negative control."""
    from repro_torch.models.weights import shard_params
    from repro_torch.serve.tp_decode import (DECODE_TP_PLAN_INTENT, make_tp_decode_step,
                                             tp_decode_specs)

    fake_world(math.prod(grid))
    cfg = configs.get(arch, smoke=True)
    mesh = make_mesh(grid, ("data", "model"), device="cpu")
    params = shard_params(lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu"),
                          tp_decode_specs(cfg)[0], mesh)
    tokens_in = cfg.input_kind != "embeds"
    batch = {"tokens": torch.zeros((slots, 1), dtype=torch.long)} if tokens_in \
        else {"embeds": torch.zeros((slots, 1, cfg.d_model))}
    active = torch.ones((slots,), dtype=torch.bool)
    out: dict = {"arch": arch, "slots": slots, "max_len": max_len, "grid": list(grid),
                 "microbatches": microbatches}
    for variant, mb in (("staggered", microbatches), ("single", 1)):
        state = lm.DecodeState(caches=lm.init_cache(cfg, slots, max_len, device="cpu"),
                               positions=torch.zeros((slots,), dtype=torch.int32))
        step = make_tp_decode_step(cfg, mesh, slots=slots, microbatches=mb)
        with torch.no_grad():
            st = _walk(step, params, state, batch, active)
        out[variant] = {
            "collectives": len(st.collectives),
            "overlapped": st.collectives_overlapped(),
            "serialized": st.collectives_serialized(),
            "exposed_bytes": st.exposed_collective_bytes(),
            "overlap_by_kind": st.overlap_by_kind(),
            "plan": op_walk.plan_agreement(st, DECODE_TP_PLAN_INTENT),
        }
    if verbose:
        print(json.dumps(out, indent=1))
    return out


def moe_dryrun(*, batch: int = 4, seq: int = 8, d_model: int = 64, d_ff: int = 128,
               n_experts: int = 8, top_k: int = 2, grid: tuple[int, int] = (2, 4),
               routing: str = "balanced", n_groups: int = 2, verbose: bool = True) -> dict:
    """The expert-parallel MoE dispatch
    (:func:`repro_torch.models.ffn.moe_expert_parallel`) of rank 0 on a
    ``(data, model)`` fake world: with ``n_groups >= 2`` the ``dispatch``
    plan serializes no all-to-all; one group is the negative control.  The
    port's all-to-alls move the counts table's rows and no padding, so the
    walk's all-to-all bytes are the rows that land on this rank, dispatch
    and combine legs (``op_wire_a2a_bytes == rank_a2a_bytes``); the
    reference's wire is the padded capacity blocks
    (:func:`repro_torch.models.ffn.moe_comm_model`'s ``wire_bytes``), and
    its valid bytes, the mean over the ranks, are this rank's under
    balanced routing.  ``routing="skewed"`` sends every token to rank 0's
    experts."""
    from repro_torch.models import ffn
    from repro_torch.models.sharding import ragged_expert_extents

    E, k = n_experts, top_k
    D, R = grid
    fake_world(D * R)
    cfg = SimpleNamespace(n_heads=4, n_kv=2, head_dim=d_model // 4, d_model=d_model,
                          d_ff=d_ff, vocab_padded=256, n_experts=E, family="moe")
    mesh = make_mesh(grid, ("data", "model"), device="cpu")
    me = mesh.coords()["model"]
    Tl = (batch // D) * (seq // R)
    if routing == "balanced":
        counts = ffn.moe_ep_counts(E, Tl, k, 1.25)
    elif routing == "skewed":
        cap_e, _ = ragged_expert_extents(E, R)
        stride = max(1, cap_e // max(n_groups, 1))
        hot = tuple(range(0, cap_e, stride))[:n_groups]
        counts = tuple(Tl if e in hot else 0 for e in range(E))
    else:
        raise ValueError(f"unknown routing {routing!r} (balanced | skewed)")
    g = torch.Generator().manual_seed(0)
    params = {"router": torch.randn((d_model, E), generator=g),
              "w_gate": torch.randn((E, d_model, d_ff), generator=g),
              "w_up": torch.randn((E, d_model, d_ff), generator=g),
              "w_down": torch.randn((E, d_ff, d_model), generator=g)}
    x = torch.randn((batch // D, seq // R, d_model), generator=g)
    out: dict = {"batch": batch, "seq": seq, "d_model": d_model, "d_ff": d_ff,
                 "n_experts": E, "top_k": k, "grid": list(grid), "routing": routing,
                 "counts": list(counts), "n_groups": n_groups}
    for variant, ng in (("overlapped", n_groups), ("single", 1)):
        recipe = make_recipe(cfg, mesh)
        sched = ffn.moe_ep_schedule(E, R, counts, ng)
        model = ffn.moe_comm_model(sched, d_model=d_model, itemsize=4)
        # rows landing here: every source's split for this rank, then this
        # rank's own rows back from every owner
        rank_bytes = sum((R * grp.se[me] + grp.Sg) * d_model * 4 for grp in sched.groups)
        with use_recipe(recipe), torch.no_grad():
            st = _walk(lambda: ffn.moe_expert_parallel(params, x, n_experts=E, top_k=k,
                                                       counts=counts, n_groups=ng))
        wire = st.coll_by_op.get("all-to-all", 0.0)
        out[variant] = {
            "steps": len(sched.groups),
            "collectives": len(st.collectives),
            "all_to_alls": len(st.of_kind("all-to-all")),
            "overlapped": st.collectives_overlapped(),
            "serialized": st.collectives_serialized(),
            "serialized_a2a": st.collectives_serialized("all-to-all"),
            "exposed_bytes": st.exposed_collective_bytes(),
            "op_wire_a2a_bytes": wire,
            "rank_a2a_bytes": rank_bytes,
            "model_wire_bytes": model["wire_bytes"],
            "model_valid_bytes": model["valid_bytes"],
            "wire_matches_model": wire == rank_bytes,
            "overlap_by_kind": st.overlap_by_kind(),
            "plan": op_walk.plan_agreement(st, ffn.MOE_DISPATCH_PLAN_INTENT,
                                           kind="all-to-all"),
        }
    if verbose:
        print(json.dumps(out, indent=1))
    return out


def train_dryrun(*, arch: str = "phi4-mini-3.8b", ranks: int = 8, seq: int = 64,
                 batch: int = 16, bucket_kb: int = 64, compress: str = "none",
                 microbatches: int = 1, verbose: bool = True) -> dict:
    """The explicit ZeRO-2 train step
    (:func:`repro_torch.train.trainer.make_zero_train_step`) on a ``data``
    fake world: with several gradient buckets no reduce-scatter or
    all-gather is serialized, the kind-scoped ``bucket`` plan agrees, and
    the walk's wire and valid bytes equal
    :func:`repro_torch.train.buckets.zero_comm_model`'s; one bucket holding
    the whole model is the negative control."""
    from repro_torch.train.buckets import zero_comm_model
    from repro_torch.train.optimizer import init_zero_opt_state
    from repro_torch.train.trainer import (ZERO_TRAIN_PLAN_INTENT, make_zero_train_step,
                                           zero_local_batch, zero_train_buckets)

    fake_world(ranks)
    cfg = configs.get(arch, smoke=True)
    mesh = make_mesh((ranks,), ("data",), device="cpu")
    ocfg = OptConfig(compress=compress)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    shape = ShapeCell("train_gate", seq, batch, "train")
    data = zero_local_batch(mesh, {name: torch.zeros(s, dtype=_NP_TORCH[d])
                                   for name, (s, d) in batch_specs(cfg, shape).items()})

    def walk(bucket_bytes, db):
        bkts = zero_train_buckets(cfg, bucket_bytes=bucket_bytes, ranks=ranks)
        opt = init_zero_opt_state(params, bkts, ocfg)
        step = make_zero_train_step(cfg, mesh, ocfg, microbatches=microbatches,
                                    bucket_bytes=bucket_bytes, double_buffer=db)
        model = zero_comm_model(bkts)
        st = _walk(step, params, opt, data, valid_fractions=model["valid_fractions"])
        rs_wire = st.coll_by_op.get("reduce-scatter", 0.0)
        ag_wire = st.coll_by_op.get("all-gather", 0.0)
        rs_valid = st.coll_by_op_valid.get("reduce-scatter", 0.0)
        ag_valid = st.coll_by_op_valid.get("all-gather", 0.0)
        return {
            "n_buckets": len(bkts),
            "collectives": len(st.collectives),
            "overlapped": st.collectives_overlapped(),
            "serialized": st.collectives_serialized(),
            "serialized_rs": st.collectives_serialized("reduce-scatter"),
            "serialized_ag": st.collectives_serialized("all-gather"),
            "exposed_bytes": st.exposed_collective_bytes(),
            "op_wire_rs_bytes": rs_wire,
            "op_wire_ag_bytes": ag_wire,
            "op_valid_rs_bytes": rs_valid,
            "op_valid_ag_bytes": ag_valid,
            "model": {k: model[k] for k in
                      ("n_buckets", "param_elems", "padded_elems", "rs_wire_bytes",
                       "rs_valid_bytes", "ag_wire_bytes", "ag_valid_bytes", "wire_bytes",
                       "valid_bytes")},
            "wire_matches_model": (rs_wire == model["rs_wire_bytes"]
                                   and ag_wire == model["ag_wire_bytes"]),
            "valid_matches_model": (abs(rs_valid - model["rs_valid_bytes"]) < 1e-6
                                    and abs(ag_valid - model["ag_valid_bytes"]) < 1e-6),
            "overlap_by_kind": st.overlap_by_kind(),
            "plan_rs": op_walk.plan_agreement(st, ZERO_TRAIN_PLAN_INTENT,
                                              kind="reduce-scatter"),
            "plan_ag": op_walk.plan_agreement(st, ZERO_TRAIN_PLAN_INTENT, kind="all-gather"),
        }

    out: dict = {"arch": arch, "ranks": ranks, "seq": seq, "batch": batch,
                 "bucket_kb": bucket_kb, "compress": compress, "microbatches": microbatches}
    out["bucketed"] = walk(bucket_kb << 10, True)
    out["blocking"] = walk(bucket_kb << 10, False)
    out["single_bucket"] = walk(1 << 40, True)  # the whole model in one bucket
    if verbose:
        print(json.dumps(out, indent=1))
    return out


def plan_report(path: str, verbose: bool = True) -> int:
    """Run every comm-plan gate and write the per-plan agreement table to
    ``path``; returns 1 if any plan's declared intent disagrees with the
    walk's verdict or a negative control serialized nothing, else 0."""
    rows = []
    for prog, rep in (("summa_ring", summa_dryrun(verbose=False)),
                      ("ragged_summa_ring", ragged_summa_dryrun(verbose=False))):
        for variant in ("double_buffered", "blocking"):
            cell = rep[variant]
            rows.append({"program": prog, "variant": variant, **cell["plan"],
                         "exposed_bytes": cell["exposed_bytes"],
                         "overlap_by_kind": cell["overlap_by_kind"]})
    for prog, kw in (("sp_ring_attention", {}),
                     ("sp_ring_attention_card", {"device": "cuda", "head_dim": 64}),
                     ("sp_ring_attention_ragged", {"seq": 250}),
                     ("sp_ring_attention_ragged_card",
                      {"seq": 250, "device": "cuda", "head_dim": 64})):
        rep = sp_ring_dryrun(verbose=False, **kw)
        cell = rep["double_buffered"]
        rows.append({"program": prog, "variant": "double_buffered", **cell["plan"],
                     "exposed_bytes": cell["exposed_bytes"],
                     "overlap_by_kind": cell["overlap_by_kind"],
                     # the blocking ring waits each rotation before the step that
                     # reads it: its K/V rotations must land on the chain
                     "negative_control_serialized": rep["blocking"]["plan"]["serialized"]})
    for routing in ("balanced", "skewed"):
        moe = moe_dryrun(routing=routing, verbose=False)
        rows.append({"program": f"moe_ep_dispatch_{routing}", "variant": "double_buffered",
                     **moe["overlapped"]["plan"],
                     "exposed_bytes": moe["overlapped"]["exposed_bytes"],
                     "overlap_by_kind": moe["overlapped"]["overlap_by_kind"],
                     "negative_control_serialized": moe["single"]["serialized_a2a"]})
    serve = serve_dryrun(verbose=False)
    rows.append({"program": "serve_tp_decode", "variant": "staggered",
                 **serve["staggered"]["plan"],
                 "exposed_bytes": serve["staggered"]["exposed_bytes"],
                 "overlap_by_kind": serve["staggered"]["overlap_by_kind"],
                 "negative_control_serialized": serve["single"]["serialized"]})
    for compress in ("none", "int8"):
        train = train_dryrun(compress=compress, verbose=False)
        for leg, key in (("reduce_scatter", "plan_rs"), ("all_gather", "plan_ag")):
            rows.append({"program": f"zero_train_{compress}_{leg}", "variant": "bucketed",
                         **train["bucketed"][key],
                         "exposed_bytes": train["bucketed"]["exposed_bytes"],
                         "overlap_by_kind": train["bucketed"]["overlap_by_kind"],
                         "negative_control_serialized":
                             train["single_bucket"]["serialized_rs"]})
    disagreements = [r for r in rows if not r["agree"]]
    blind = [r for r in rows if r.get("negative_control_serialized", 1) <= 0]
    report = {"plans": rows, "n_plans": len(rows), "n_disagreements": len(disagreements),
              "n_blind_negative_controls": len(blind),
              "agree_all": not disagreements and not blind}
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    with open(path, "w") as f:
        json.dump(report, f, indent=1)
    if verbose:
        for r in rows:
            mark = "ok " if r["agree"] and r.get("negative_control_serialized", 1) > 0 \
                else "FAIL"
            neg = (f" negative control serialized={r['negative_control_serialized']}"
                   if "negative_control_serialized" in r else "")
            print(f"[{mark}] {r['program']}/{r['variant']}: declared={r['declared']} "
                  f"proven={r['proven']} (serialized={r['serialized']} "
                  f"overlapped={r['overlapped']}){neg}")
        print(f"plan report -> {path} ({len(rows)} plans, {len(disagreements)} disagreements, "
              f"{len(blind)} blind negative controls)")
    return 1 if disagreements or blind else 0


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None, choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--attn-mode", default="auto", choices=["auto", "tp", "sp", "sp_ring"])
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--set", action="append", default=[], help="cfg override k=v")
    ap.add_argument("--rank", type=int, default=0, help="the rank whose program is traced")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: the card's program (kernels); cpu: the plain versions")
    ap.add_argument("--out", default="build/dryrun")
    ap.add_argument("--tag", default="baseline")
    ap.add_argument("--summa-gemm", action="store_true",
                    help="walk the SUMMA ring program and gate on 0 serialized collectives")
    ap.add_argument("--summa-dims", default="256,256,256", help="ni,nj,nk for --summa-gemm")
    ap.add_argument("--summa-grid", default="2x4", help="rows x cols for --summa-gemm")
    ap.add_argument("--sp-ring", action="store_true",
                    help="walk the sp ring attention; gate on 0 serialized collectives "
                         "and a serialized blocking ring")
    ap.add_argument("--sp-ring-seq", type=int, default=256, help="seq len for --sp-ring")
    ap.add_argument("--sp-ring-grid", default="2x4", help="data x model for --sp-ring")
    ap.add_argument("--uneven", action="store_true",
                    help="walk the ragged SUMMA ring; gate on 0 serialized collectives and "
                         "its wire/valid permute bytes == the padded/ragged ring models")
    ap.add_argument("--uneven-dims", default="35,35,35", help="ni,nj,nk for --uneven")
    ap.add_argument("--uneven-grid", default="2x4", help="rows x cols for --uneven")
    ap.add_argument("--serve", action="store_true",
                    help="walk one TP decode step; gate on 0 serialized collectives, "
                         "plan agreement and a serialized microbatches=1 control")
    ap.add_argument("--serve-grid", default="4x2", help="data x model for --serve")
    ap.add_argument("--serve-slots", type=int, default=8, help="batch slots for --serve")
    ap.add_argument("--serve-microbatches", type=int, default=2,
                    help="stagger depth for --serve (1 = negative control)")
    ap.add_argument("--moe", action="store_true",
                    help="walk the expert-parallel MoE dispatch; gate on 0 serialized, "
                         "plan agreement, a2a bytes == the counts model, and a serialized "
                         "one-group control")
    ap.add_argument("--moe-grid", default="2x4", help="data x model for --moe")
    ap.add_argument("--moe-groups", type=int, default=2, help="expert groups for --moe")
    ap.add_argument("--moe-routing", default="both", choices=["balanced", "skewed", "both"])
    ap.add_argument("--train", action="store_true",
                    help="walk one ZeRO-2 train step; gate on 0 serialized reduce-scatter/"
                         "all-gather, bytes == zero_comm_model, and a serialized "
                         "single-bucket control")
    ap.add_argument("--train-grid", type=int, default=8, help="data ranks for --train")
    ap.add_argument("--train-bucket-kb", type=int, default=64)
    ap.add_argument("--train-compress", default="none", choices=["none", "int8"])
    ap.add_argument("--plan-report", default=None, metavar="PATH",
                    help="run every gate and write the per-plan agreement table as JSON")
    args = ap.parse_args()

    def grid_of(s):
        return tuple(int(x) for x in s.split("x"))

    if args.plan_report:
        raise SystemExit(plan_report(args.plan_report))
    if args.summa_gemm:
        ni, nj, nk = (int(x) for x in args.summa_dims.split(","))
        rep = summa_dryrun(ni=ni, nj=nj, nk=nk, grid=grid_of(args.summa_grid))
        bad = sum(rep[v]["collectives_serialized_any_kind"] + (not rep[v]["plan"]["agree"])
                  for v in ("double_buffered", "blocking"))
        raise SystemExit(1 if bad else 0)
    if args.uneven:
        ni, nj, nk = (int(x) for x in args.uneven_dims.split(","))
        rep = ragged_summa_dryrun(ni=ni, nj=nj, nk=nk, grid=grid_of(args.uneven_grid))
        bad = sum(rep[v]["serialized"] + (not rep[v]["wire_matches_padded_model"])
                  + (not rep[v]["valid_matches_ragged_model"]) + (not rep[v]["plan"]["agree"])
                  for v in ("double_buffered", "blocking"))
        raise SystemExit(1 if bad else 0)
    if args.sp_ring:
        rep = sp_ring_dryrun(seq=args.sp_ring_seq, grid=grid_of(args.sp_ring_grid),
                             device=args.device if args.device == "cpu" else "cuda",
                             **({"head_dim": 64} if args.device == "cuda" else {}))
        db = rep["double_buffered"]
        bad = db["serialized"] + (not db["plan"]["agree"])
        bad += 0 if rep["blocking"]["plan"]["serialized"] > 0 else 1
        raise SystemExit(1 if bad else 0)
    if args.serve:
        rep = serve_dryrun(grid=grid_of(args.serve_grid), slots=args.serve_slots,
                           microbatches=args.serve_microbatches)
        stag = rep["staggered"]
        bad = stag["serialized"] + (not stag["plan"]["agree"])
        bad += 0 if rep["single"]["serialized"] > 0 else 1
        raise SystemExit(1 if bad else 0)
    if args.train:
        rep = train_dryrun(ranks=args.train_grid, bucket_kb=args.train_bucket_kb,
                           compress=args.train_compress)
        bad = sum((not rep[v]["wire_matches_model"]) + (not rep[v]["valid_matches_model"])
                  for v in ("bucketed", "blocking"))
        bk = rep["bucketed"]
        bad += bk["serialized_rs"] + bk["serialized_ag"]
        bad += (not bk["plan_rs"]["agree"]) + (not bk["plan_ag"]["agree"])
        bad += 0 if rep["single_bucket"]["serialized_rs"] > 0 else 1
        raise SystemExit(1 if bad else 0)
    if args.moe:
        routings = ("balanced", "skewed") if args.moe_routing == "both" else (args.moe_routing,)
        bad = 0
        for routing in routings:
            rep = moe_dryrun(grid=grid_of(args.moe_grid), routing=routing,
                             n_groups=args.moe_groups)
            ov, single = rep["overlapped"], rep["single"]
            bad += ov["serialized_a2a"] + (not ov["plan"]["agree"])
            bad += (not ov["wire_matches_model"]) + (single["serialized_a2a"] <= 0)
        raise SystemExit(1 if bad else 0)

    if args.out.split(os.sep)[0] == "benchmarks":
        raise SystemExit("the dry run writes its records under build/, never benchmarks/")
    os.makedirs(args.out, exist_ok=True)
    mesh_tag = "multipod" if args.multi_pod else "singlepod"
    if args.all:
        cells = list(iter_cells())
    else:
        if not (args.arch and args.shape):
            raise SystemExit("--arch and --shape, or --all")
        cells = [(args.arch, args.shape, "run")]
    results, failures = [], []
    for arch, shape_name, status in cells:
        key = f"{arch}__{shape_name}__{mesh_tag}__{args.tag}"
        path = os.path.join(args.out, key + ".json")
        if status == "skip":
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "status": "skipped",
                   "reason": "full attention is O(S^2): long_500k runs for sub-quadratic "
                             "archs only"}
            with open(path, "w") as f:
                json.dump(rec, f, indent=1)
            print(f"[skip] {key}")
            continue
        print(f"[trace] {key}", flush=True)
        try:
            rec = lower_cell(arch, shape_name, multi_pod=args.multi_pod,
                             attn_mode=args.attn_mode, microbatches=args.microbatches,
                             sets=args.set, rank=args.rank, device=args.device)
            rec["status"], rec["tag"] = "ok", args.tag
            results.append(rec)
        except Exception as e:  # noqa: BLE001 - record the cell and go on
            failures.append((key, repr(e)))
            rec = {"arch": arch, "shape": shape_name, "mesh": mesh_tag, "status": "failed",
                   "error": traceback.format_exc()}
            print(f"[FAILED] {key}: {e!r}")
        with open(path, "w") as f:
            json.dump(rec, f, indent=1)
    print(f"\ndone: {len(results)} ok, {len(failures)} failed")
    if results:
        print("prediction for " + rl.CARD)
        print(f"{'arch':<22} {'shape':<12} {'peak GB':>9} {'fits':>5} {'dominant':>10} "
              f"{'roofline':>9} {'trace s':>8}")
        for r in results:
            print(f"{r['arch']:<22} {r['shape']:<12} "
                  f"{r['memory']['total_bytes'] / 1e9:>9.2f} {str(r['memory']['fits']):>5} "
                  f"{r['roofline']['dominant']:>10} {r['roofline']['roofline_fraction']:>9.4f} "
                  f"{r['trace_seconds']:>8.1f}")
    for k, e in failures:
        print("  FAIL", k, e[:200])
    if failures:
        raise SystemExit(1)


if __name__ == "__main__":
    main()
