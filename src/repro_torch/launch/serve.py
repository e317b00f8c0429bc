"""Serving launcher: build a model with seeded random weights, or restore
one a training run checkpointed, and run batched generation through the
continuous-batching engine.

Usage:
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --requests 8 --max-new 32 --slots 4 --max-len 4096      # on the GPU
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke --device cpu
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.serve \
      --arch phi4-mini-3.8b --smoke --device cpu --grid 2x2   # TP decode, 4 gloo ranks
  python -m repro_torch.launch.serve --arch musicgen-large --smoke --device cpu
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke --device cpu \
      --ckpt-dir /path/written/by/launch.train

Runs on the GPU unless given ``--device cpu``, and raises without one.
Prompts are the reference launcher's (``numpy`` seed 0), so both print the
same requests; an ``embeds``-input model (musicgen-large) takes them
through the engine's featurizer.  The VLM family is refused: the engine
builds no image batch, as the reference's does not.  ``--max-steps``
bounds the decode loop; requests still resident when the budget runs out
are reported as in-flight.

``--ckpt-dir`` restores the latest checkpoint that
``repro_torch.launch.train`` wrote there (``{"params", "opt"}``, the
logical arrays, whatever mesh wrote them) into a template built as the
trainer builds its own, and serves its parameters; the launcher prints the
restored step.  Under ``--grid`` every rank restores them and the engine
cuts its tensor-parallel shard from them.

``--grid DxM`` serves with tensor-parallel decode on a ``(data, model)``
mesh of D*M ranks, ``--microbatches`` per rank's rows (default 2): start
D*M processes with ``torchrun`` (gloo with ``--device cpu``, NCCL on the
GPU, one GPU per rank); without it the world is this one process, so only
``--grid 1x1`` fits.  Every rank serves the same requests; rank 0 prints.
The reference's ``--fake-devices`` has no counterpart: use ``torchrun``.
"""
import argparse
import sys
import time


def prompts(cfg, n: int) -> list[list[int]]:
    """The launcher's ``n`` seeded prompts (``numpy`` seed 0), the
    reference launcher's."""
    import numpy as np

    rng = np.random.default_rng(0)
    return [rng.integers(2, min(cfg.vocab, 1000), size=rng.integers(3, 10)).tolist()
            for _ in range(n)]


def restore_params(params, ckpt_dir: str):
    """``(params, step)``: the parameters of the latest checkpoint in
    ``ckpt_dir``, restored into the structure, devices and dtypes of
    ``params``.  Training checkpoints carry ``{"params", "opt"}``, so the
    template pairs ``params`` with the AdamW state the trainer starts from
    (``init_opt_state``), as the reference's launcher does."""
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.train.optimizer import OptConfig, init_opt_state

    mgr = CheckpointManager(ckpt_dir)
    step = mgr.latest_step()
    if step is None:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    restored, _ = mgr.restore({"params": params, "opt": init_opt_state(params, OptConfig())},
                              step)
    return restored["params"], step


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-len", type=int, default=256)
    ap.add_argument("--requests", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--max-steps", type=int, default=10_000)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--grid", default=None, metavar="DxM")
    ap.add_argument("--microbatches", type=int, default=2)
    ap.add_argument("--fake-devices", type=int, default=0)
    args = ap.parse_args(argv)

    if args.fake_devices:
        raise ValueError("--fake-devices has no counterpart in the port: start one process per "
                         "rank with torchrun (--nproc-per-node D*M) and pass --grid DxM")
    import torch

    from repro_torch import configs
    from repro_torch.core.dist import init_world, make_mesh, resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig, check_servable

    cfg = configs.get(args.arch, smoke=args.smoke)
    check_servable(cfg)
    device = resolve_device(args.device)
    mesh, rank = None, 0
    if args.grid:
        device = init_world(device)
        mesh = make_mesh([int(n) for n in args.grid.lower().split("x")], ("data", "model"),
                         device=device)
        rank = mesh.rank
    params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    if args.ckpt_dir:
        params, step = restore_params(params, args.ckpt_dir)
        if rank == 0:
            print(f"[serve] restored from {step}", flush=True)
    scfg = ServeConfig(max_len=args.max_len, batch_slots=args.slots,
                       temperature=args.temperature, eos_token=-1)
    engine = Engine(cfg, params, scfg, mesh=mesh,
                    microbatches=args.microbatches if mesh is not None else 0)
    del params  # the engine keeps its activation-dtype copy
    t0 = time.time()
    total_new = 0
    for rid, prompt in enumerate(prompts(cfg, args.requests)):
        engine.submit(rid, prompt, args.max_new)
        total_new += args.max_new
    done = engine.run(max_steps=args.max_steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    if rank != 0:
        return 0 if len(done) == args.requests else 1
    for rid in sorted(done):
        print(f"[serve] req {rid}: {done[rid]}")
    for rid, toks in sorted(engine.in_flight.items()):
        print(f"[serve] req {rid}: IN-FLIGHT after {args.max_steps} steps, "
              f"{len(toks)} tokens so far: {toks}")
    occ = engine.ledger.valid_fraction()
    print(f"[serve] {len(done)} done / {len(engine.in_flight)} in flight, "
          f"{total_new} tokens requested in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s, kv occupancy {occ:.2f}) on {device}"
          + (f", grid {args.grid} x {args.microbatches} microbatches" if mesh is not None else ""))
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
