"""End-to-end example: pretrain a ~100M-parameter dense LM for a few hundred
steps on synthetic data, with checkpoints; the port of
``examples/train_lm.py``.

One process trains with ``make_train_step``.  Under ``torchrun`` the world
is the mesh: with ``--zero`` a pure ``data`` mesh running the explicit
ZeRO-2 step (bucketed gradient reduce-scatters, AdamW on each rank's 1/R
shard, parameter all-gathers), else a ``(data, model)`` mesh under the
``sp_ring`` recipe.  The reference's ``--devices`` (fake JAX devices) has no
counterpart: start one process per rank.  gloo with ``--device cpu``,
NCCL on the GPU (one GPU per rank).

Run:
  python -m repro_torch.examples.train_lm --steps 200                  # on the GPU
  python -m repro_torch.examples.train_lm --steps 2 --device cpu --global-batch 2 --seq-len 16
  torchrun --standalone --nproc-per-node 2 -m repro_torch.examples.train_lm \\
      --device cpu --zero --steps 2 --global-batch 4 --seq-len 16 --bucket-kb 4096
"""
import argparse
import os
import sys
import tempfile
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--seq-len", type=int, default=256)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_lm"))
    ap.add_argument("--zero", action="store_true",
                    help="explicit ZeRO-2 train step on a pure data mesh (under torchrun)")
    ap.add_argument("--bucket-kb", type=int, default=4096,
                    help="gradient bucket threshold (KiB) for --zero")
    args = ap.parse_args(argv)

    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.configs.base import ArchConfig
    from repro_torch.core.dist import init_world, make_mesh, resolve_device
    from repro_torch.data.pipeline import DataConfig, ShapeCell, make_batch, to_device
    from repro_torch.models import lm
    from repro_torch.models.sharding import local_batch, make_recipe
    from repro_torch.train.optimizer import OptConfig, init_opt_state, init_zero_opt_state
    from repro_torch.train.trainer import (make_train_step, make_zero_train_step,
                                           zero_local_batch, zero_train_buckets)

    # ~100M params: 12 layers, d=768, untied 32k vocab
    cfg = ArchConfig(name="demo-100m", family="dense", n_layers=12, d_model=768, n_heads=12,
                     n_kv=4, d_ff=2048, vocab=32000, head_dim=64, attn_block=256)
    device = resolve_device(args.device)
    distributed = "RANK" in os.environ and "WORLD_SIZE" in os.environ
    mesh, rank, world = None, 0, 1
    if distributed:
        import torch.distributed as dist

        device = init_world(device)
        world, rank = dist.get_world_size(), dist.get_rank()
    elif args.zero:
        ap.error("--zero needs a data-parallel world: start it under torchrun")
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"model: {cfg.name}, {lm.count_params(cfg) / 1e6:.1f}M params")
    cell = ShapeCell("train", seq_len=args.seq_len, global_batch=args.global_batch,
                     kind="train")
    dcfg = DataConfig(seed=0)
    ocfg = OptConfig(lr=3e-4, warmup_steps=20, total_steps=args.steps)
    params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    ckpt_dir = args.ckpt_dir
    recipe = None
    if args.zero:
        mesh = make_mesh((world,), ("data",), device=device)
        buckets = zero_train_buckets(cfg, bucket_bytes=args.bucket_kb << 10, ranks=world)
        log(f"mesh {dict(mesh.shape)}, explicit ZeRO-2 step (bucket threshold "
            f"{args.bucket_kb} KiB): {len(buckets)} gradient buckets, largest "
            f"{max(b.nbytes for b in buckets) / 2**20:.1f} MiB")
        opt = init_zero_opt_state(params, buckets, ocfg)
        step_fn = make_zero_train_step(cfg, mesh, ocfg, microbatches=2,
                                       bucket_bytes=args.bucket_kb << 10)
        ckpt_dir = os.path.join(ckpt_dir, f"rank{rank}")  # each rank's optimizer shard
    else:
        if distributed:
            model = 2 if world % 2 == 0 else 1
            mesh = make_mesh((world // model, model), ("data", "model"), device=device)
            recipe = make_recipe(cfg, mesh, attn_mode="sp_ring")
            log(f"mesh {dict(mesh.shape)}, attn_mode=sp_ring")
        opt = init_opt_state(params, ocfg)
        step_fn = make_train_step(cfg, recipe, ocfg, microbatches=2)
    writes = args.zero or rank == 0
    mgr = CheckpointManager(ckpt_dir, keep=2) if writes else None

    t0 = time.time()
    for step in range(args.steps):
        batch = make_batch(cfg, cell, step, dcfg)  # each rank's block cut on the host
        if args.zero:
            batch = zero_local_batch(mesh, batch)
        elif recipe is not None:
            batch = local_batch(recipe, batch, microbatches=2)
        params, opt, m = step_fn(params, opt, to_device(batch, device))
        if step % 10 == 0 or step == args.steps - 1:
            tok_s = (step + 1) * cell.global_batch * cell.seq_len / (time.time() - t0)
            log(f"step {step:4d}  loss {float(m['loss']):.4f}  "
                f"gnorm {float(m['grad_norm']):.2f}  {tok_s:,.0f} tok/s", flush=True)
        if writes and (step + 1) % 50 == 0:
            mgr.save_async(step + 1, {"params": params, "opt": opt})
    if mgr is not None:
        mgr.wait()
    if distributed:
        torch.distributed.destroy_process_group()
    log(f"done in {time.time() - t0:.1f}s; checkpoints: {mgr.all_steps() if mgr else []}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
