"""Training launcher: model, data, checkpoints and fault tolerance, the port
of ``src/repro/launch/train.py`` with the same flags plus ``--device``.

Fault-tolerance model:
  * deterministic step-indexed data: a restart anywhere is exact;
  * asynchronous atomic checkpoints every ``--ckpt-every`` steps, keep-K
    rotation (:mod:`repro_torch.ckpt.manager`);
  * ``--watchdog`` wraps the trainer in a supervisor: if the trainer
    process dies or stops heartbeating, it is restarted
    (``python -m repro_torch.launch.train``) from the latest checkpoint.

One process runs ``make_train_step`` with no recipe.  Under ``torchrun``
with more than one process the world is a ``(data, model)`` mesh
(``model`` 2 when the world size is even, the reference's rule) and the
step runs under ``make_recipe(cfg, mesh, attn_mode=--attn-mode)``
(``auto``: ``tp`` where the heads divide ``model``, else ``sp``; or
``tp``, ``sp``, ``sp_ring``): every rank makes the step's global batch
(the reference's, bit for bit), cuts its blocks on the host
(``sharding.local_batch``) and moves only those to the device, and holds
and updates its shards of the parameters and the optimizer state;
checkpoints hold the logical arrays (gathered, rank 0 writes) and
restore under any world size.  Runs
on the GPU (NCCL under ``torchrun``) unless given ``--device cpu`` (gloo).
Every family trains under every mode; a one-process run takes no recipe
whatever ``--attn-mode`` says.

Usage:
  python -m repro_torch.launch.train --arch phi4-mini-3.8b --smoke --device cpu --steps 3
  python -m repro_torch.launch.train --arch phi4-mini-3.8b --smoke --device cpu \\
      --watchdog --crash-at-step 2 --steps 4
  torchrun --standalone --nproc-per-node 4 -m repro_torch.launch.train \\
      --arch phi4-mini-3.8b --smoke --device cpu --attn-mode tp
"""
import argparse
import os
import signal
import subprocess
import sys
import tempfile
import time

from repro_torch.data.pipeline import to_device


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true", help="reduced config (CPU-friendly)")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=8)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--compress", default="none", choices=["none", "int8"])
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(), "repro_torch_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=20)
    ap.add_argument("--log-every", type=int, default=5)
    ap.add_argument("--data", default="synthetic")
    ap.add_argument("--data-path", default=None)
    ap.add_argument("--attn-mode", default="auto", choices=["auto", "tp", "sp", "sp_ring"])
    ap.add_argument("--watchdog", action="store_true", help="supervise + auto-restart")
    ap.add_argument("--heartbeat-timeout", type=float, default=300.0)
    ap.add_argument("--max-restarts", type=int, default=3)
    ap.add_argument("--crash-at-step", type=int, default=None, help="fault injection (tests)")
    return ap.parse_args(argv)


# --------------------------------------------------------------- watchdog ----

def watchdog(args, argv) -> int:
    """Supervise the trainer; restart it from the latest checkpoint on a
    crash or a stale heartbeat."""
    restarts = 0
    child_args = [a for a in argv if a != "--watchdog"]
    hb_path = os.path.join(args.ckpt_dir, "HEARTBEAT")
    while True:
        proc = subprocess.Popen([sys.executable, "-m", "repro_torch.launch.train"] + child_args,
                                env=dict(os.environ))
        while True:
            try:
                proc.wait(timeout=10)
                break
            except subprocess.TimeoutExpired:
                if os.path.exists(hb_path):
                    age = time.time() - os.path.getmtime(hb_path)
                    if age > args.heartbeat_timeout:
                        print(f"[watchdog] heartbeat stale ({age:.0f}s): killing trainer")
                        proc.send_signal(signal.SIGKILL)
        if proc.returncode == 0:
            print("[watchdog] training completed")
            return 0
        restarts += 1
        if restarts > args.max_restarts:
            print(f"[watchdog] giving up after {restarts - 1} restarts")
            return 1
        print(f"[watchdog] trainer exited rc={proc.returncode}; restart {restarts} "
              "from latest checkpoint", flush=True)


# ------------------------------------------------------------------ train ----

def _multi_process() -> bool:
    """Whether ``torchrun`` started more than one process."""
    return int(os.environ.get("WORLD_SIZE", 1)) > 1 and "RANK" in os.environ


def setup(args):
    """``(cfg, device, mesh, rank)``: one process (no mesh), or the world of
    ``torchrun`` (more than one process) as a ``(data, model)`` mesh,
    ``model`` 2 when the world size is even."""
    from repro_torch import configs
    from repro_torch.core.dist import init_world, make_mesh, resolve_device

    cfg = configs.get(args.arch, smoke=args.smoke)
    device = resolve_device(args.device)
    if not _multi_process():
        return cfg, device, None, 0
    device = init_world(device)
    import torch.distributed as dist

    world = dist.get_world_size()
    model = 2 if world % 2 == 0 else 1
    mesh = make_mesh((world // model, model), ("data", "model"), device=device)
    return cfg, device, mesh, mesh.rank


def run(args, cfg=None) -> dict:
    """The training loop of ``args`` (``cfg`` replaces the architecture's
    config, e.g. cut in depth); returns this process's record: the step
    each run started from and every step's loss and seconds (host clock up
    to the loss read, which waits for the device)."""
    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.data.pipeline import DataConfig, ShapeCell, make_batch
    from repro_torch.models import lm
    from repro_torch.models.sharding import local_batch, make_recipe
    from repro_torch.models.weights import shard_params_by_recipe
    from repro_torch.train.optimizer import OptConfig, OptState, init_opt_state
    from repro_torch.train.trainer import make_train_step

    arch_cfg, device, mesh, rank = setup(args)
    cfg = cfg or arch_cfg
    recipe = None if mesh is None else make_recipe(cfg, mesh, attn_mode=args.attn_mode)
    cell = ShapeCell("train", seq_len=args.seq_len, global_batch=args.global_batch, kind="train")
    dcfg = DataConfig(source=args.data, path=args.data_path)
    ocfg = OptConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1), total_steps=args.steps,
                     compress=args.compress)
    log = print if rank == 0 else (lambda *a, **k: None)
    log(f"[train] arch={cfg.name} device={device} "
        f"mesh={dict(mesh.shape) if mesh else None} "
        f"attn_mode={recipe.attn_mode + (' (ring)' if recipe.sp_ring else '') if recipe else 'n/a'}")

    params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    specs = lm.build_specs(cfg)
    if recipe is not None:  # this rank's shards; the checkpoint holds the logical arrays
        params = shard_params_by_recipe(params, specs, recipe)
    opt = init_opt_state(params, ocfg)
    layout = {} if recipe is None else dict(recipe=recipe, specs={
        "params": specs, "opt": OptState(step=None, mu=specs, nu=specs,
                                         err=specs if opt.err else ())})
    mgr = CheckpointManager(args.ckpt_dir, keep=3)
    start_step = 0
    latest = mgr.latest_step()
    if latest is not None:
        restored, _ = mgr.restore({"params": params, "opt": opt}, **layout)
        params, opt = restored["params"], restored["opt"]
        start_step = latest
        log(f"[train] resumed from step {latest}")

    step_fn = make_train_step(cfg, recipe, ocfg, microbatches=args.microbatches)
    hb_path = os.path.join(args.ckpt_dir, "HEARTBEAT")
    record = {"start_step": start_step, "loss": [], "seconds": []}
    t_start = time.time()
    for step in range(start_step, args.steps):
        if args.crash_at_step is not None and step == args.crash_at_step and latest is None:
            print(f"[train] FAULT INJECTION: crashing at step {step}", flush=True)
            os._exit(42)
        t0 = time.perf_counter()
        batch = make_batch(cfg, cell, step, dcfg)
        if recipe is not None:  # this rank's blocks, cut on the host
            batch = local_batch(recipe, batch, microbatches=args.microbatches)
        params, opt, metrics = step_fn(params, opt, to_device(batch, device))
        record["loss"].append(float(metrics["loss"]))
        record["seconds"].append(time.perf_counter() - t0)
        if rank == 0:
            with open(hb_path, "w") as f:
                f.write(str(time.time()))
        if step % args.log_every == 0 or step == args.steps - 1:
            log(f"[train] step {step:5d} loss={record['loss'][-1]:.4f} "
                f"gnorm={float(metrics['grad_norm']):.3f} lr={float(metrics['lr']):.2e} "
                f"({time.time() - t_start:.1f}s)", flush=True)
        if (step + 1) % args.ckpt_every == 0 or step == args.steps - 1:
            mgr.save_async(step + 1, {"params": params, "opt": opt},
                           extra={"loss": record["loss"][-1]}, **layout)
    mgr.wait()
    if mesh is not None:
        import torch.distributed as dist

        dist.destroy_process_group()
    log(f"[train] done: {args.steps} steps, final ckpt at {mgr.latest_step()}")
    return record


def train(args) -> int:
    run(args)
    return 0


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    args = parse_args(argv)
    if args.watchdog:
        return watchdog(args, argv)
    return train(args)


if __name__ == "__main__":
    sys.exit(main())
