"""Batched serving example: continuous batching over a small dense LM; the
port of ``examples/serve_lm.py``.

Run:
  python -m repro_torch.examples.serve_lm --requests 6 --max-new 12     # on the GPU
  python -m repro_torch.examples.serve_lm --device cpu
"""
import argparse
import time


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--slots", type=int, default=3)
    ap.add_argument("--temperature", type=float, default=0.8)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core.dist import resolve_device
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = configs.get(args.arch, smoke=True)
    device = resolve_device(args.device)
    params = lm.init_model(cfg, torch.Generator(device=device).manual_seed(0), device=device)
    engine = Engine(cfg, params, ServeConfig(
        max_len=128, batch_slots=args.slots, temperature=args.temperature, eos_token=-1))

    rng = np.random.default_rng(1)
    t0 = time.time()
    for rid in range(args.requests):
        prompt = rng.integers(2, min(cfg.vocab, 500), size=int(rng.integers(3, 8))).tolist()
        engine.submit(rid, prompt, args.max_new)
        print(f"submitted req {rid}: prompt={prompt}")
    done = engine.run()
    dt = time.time() - t0
    for rid in sorted(done):
        print(f"req {rid} -> {done[rid]}")
    tok = sum(args.max_new for _ in done)
    print(f"{len(done)} requests ({args.slots} slots, continuous batching), "
          f"{tok} new tokens, {tok/dt:.1f} tok/s")
    return 0 if len(done) == args.requests else 1


if __name__ == "__main__":
    raise SystemExit(main())
