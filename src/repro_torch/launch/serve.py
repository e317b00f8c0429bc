"""Serving launcher: build a model with seeded random weights and run
batched generation through the continuous-batching engine.

Usage:
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b \
      --requests 8 --max-new 32 --slots 4 --max-len 4096      # on the GPU
  python -m repro_torch.launch.serve --arch phi4-mini-3.8b --smoke --device cpu

Runs on the GPU unless given ``--device cpu``, and raises without one.
Prompts are the reference launcher's (``numpy`` seed 0), so both print the
same requests.  ``--max-steps`` bounds the decode loop; requests still
resident when the budget runs out are reported as in-flight.
"""
import argparse
import sys
import time


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
    ap.add_argument("--fake-devices", type=int, default=0)
    args = ap.parse_args(argv)

    if args.grid or args.fake_devices:
        raise NotImplementedError("--grid/--fake-devices (explicit tensor-parallel decode) are "
                                  "not ported yet: ROADMAP.md queue 1, item 8")
    if args.ckpt_dir:
        raise NotImplementedError("--ckpt-dir (checkpoint restore) is not ported yet: "
                                  "ROADMAP.md queue 1, item 11")

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.dist import resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    device = resolve_device(args.device)
    cfg = configs.get(args.arch, smoke=args.smoke)
    params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    scfg = ServeConfig(max_len=args.max_len, batch_slots=args.slots,
                       temperature=args.temperature, eos_token=-1)
    engine = Engine(cfg, params, scfg)
    del params  # the engine keeps its activation-dtype copy
    rng = np.random.default_rng(0)
    t0 = time.time()
    total_new = 0
    for rid in range(args.requests):
        prompt = rng.integers(2, min(cfg.vocab, 1000), size=rng.integers(3, 10)).tolist()
        engine.submit(rid, prompt, args.max_new)
        total_new += args.max_new
    done = engine.run(max_steps=args.max_steps)
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.time() - t0
    for rid in sorted(done):
        print(f"[serve] req {rid}: {done[rid]}")
    for rid, toks in sorted(engine.in_flight.items()):
        print(f"[serve] req {rid}: IN-FLIGHT after {args.max_steps} steps, "
              f"{len(toks)} tokens so far: {toks}")
    occ = engine.ledger.valid_fraction()
    print(f"[serve] {len(done)} done / {len(engine.in_flight)} in flight, "
          f"{total_new} tokens requested in {dt:.2f}s "
          f"({total_new/dt:.1f} tok/s, kv occupancy {occ:.2f}) on {device}")
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    sys.exit(main())
