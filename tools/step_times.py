"""Host and device time of steps of the port, for the ``repro_torch``
package under ``--src``, on one CUDA card.

    python tools/step_times.py --src src --label change --out chiprun_out/steps.jsonl
    python tools/step_times.py --src src --label change --out chiprun_out/steps.jsonl \
        --only train_step

The steps (``--only`` picks some; all by default):

* ``tp_decode``: phi4-mini-3.8b at full width (32 layers, bf16 weights drawn
  from seed 0), ``Engine(mesh=..., microbatches=2)`` on a one-rank NCCL
  ``(data, model)`` mesh with ``chip_smoke.py``'s 4 slots, its first 4
  prompts and a 4096-token cache.  After one warm-up step, ``--windows``
  windows of ``--steps`` steady decode steps on the host clock (ms a
  step), then one window under the profiler (``chip_smoke.window``:
  device ms, kernels a step, idle share).
* ``zero_update``: ``make_zero_update`` (double-buffered) of the
  ``chip_smoke.py`` training model (phi4-mini at full width, 8 layers,
  float32 masters drawn from seed 0) on a one-rank NCCL ``data`` mesh and
  fixed gradients (seed 1), after one warm-up call: ``--windows`` calls on
  the host clock, then one under the profiler, each call's results let go
  (``gc.collect()``, outside the timed span) before the next.
* ``train_step``: ``make_train_step`` with no recipe on ``chip_smoke.py``'s
  training model and batch (phi4-mini at full width, 8 layers, float32
  masters drawn from seed 0; 2 x 4096 tokens in 2 microbatches): after one
  warm-up step, the peak memory is reset and ``--windows`` steps run on the
  host clock (s a step), with the peak GB over them and the GB held between
  steps; then one step under the profiler (device ms by kind:
  ``chip_smoke.train_by_kind``).

Each run appends one JSON line to ``--out``.  To compare two trees, run
both in one session on one card, interleaved (``git archive`` the other
tree's ``src`` into an ignored directory; run A, B, B, A, A, B), and
compare the medians of the windows.
"""
from __future__ import annotations

import argparse
import gc
import json
import os
import statistics
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]


def host_ms(fn, calls: int) -> float:
    """Host ms a call of ``fn`` over ``calls`` calls, the card drained
    before and after."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3 / calls


def tp_decode(cs, cfg, params, Engine, ServeConfig, mesh, windows: int, steps: int) -> dict:
    engine = Engine(cfg, params, ServeConfig(max_len=cs.MAX_LEN, batch_slots=cs.SLOTS,
                                             eos_token=-1),
                    mesh=mesh, microbatches=cs.TP_MICROBATCHES)
    for rid, prompt in enumerate(cs.serve_prompts(cfg)[:cs.SLOTS]):
        engine.submit(rid, prompt, (windows + 2) * steps + 8)
    engine._fill_slots()
    engine._decode_once()
    host = [host_ms(engine._decode_once, steps) for _ in range(windows)]
    prof = cs.window(engine._decode_once, steps)
    del engine
    torch.cuda.empty_cache()
    return summary(host, prof)


def zero_update(cs, configs, lm, trainer, optimizer, tree_map, mesh, windows: int) -> dict:
    cfg = cs.train_config(configs)
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    g = torch.Generator(device="cuda").manual_seed(1)
    grads = tree_map(lambda p: 1e-3 * torch.randn(p.shape, dtype=p.dtype, device=p.device,
                                                  generator=g), params)
    ocfg = optimizer.OptConfig(lr=cs.TRAIN_LR)
    buckets = trainer.zero_train_buckets(cfg, bucket_bytes=4 << 20, ranks=1)
    state = optimizer.init_zero_opt_state(params, buckets, ocfg)
    update = trainer.make_zero_update(cfg, mesh, ocfg)

    def once():
        update(params, state, grads)

    def settled(fn):
        # one call at a time, each call's results let go before the next:
        # a tree that keeps them alive in a reference cycle frees them here
        out = fn()
        gc.collect()
        return out

    settled(once)  # warm-up
    host = [settled(lambda: host_ms(once, 1)) for _ in range(windows)]
    prof = settled(lambda: cs.window(once, 1))
    del params, grads, state
    torch.cuda.empty_cache()
    return summary(host, prof)


def train_step(cs, configs, lm, trainer, optimizer, windows: int) -> dict:
    cfg = cs.train_config(configs)
    params = lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0), device="cuda")
    batch = cs.train_batch(cfg)
    ocfg = optimizer.OptConfig(lr=cs.TRAIN_LR)
    step = trainer.make_train_step(cfg, None, ocfg, microbatches=cs.TRAIN_MICROBATCHES)
    opt = optimizer.init_opt_state(params, ocfg)

    def once():
        step(params, opt, batch)

    once()  # warm-up: builds the kernels and maps the step's memory
    gc.collect()
    held = torch.cuda.memory_allocated() / 1e9
    torch.cuda.reset_peak_memory_stats()
    host = [host_ms(once, 1) for _ in range(windows)]
    peak = torch.cuda.max_memory_allocated() / 1e9
    prof = cs.window(once, 1, classify=cs.train_by_kind)
    del params, opt, batch
    torch.cuda.empty_cache()
    return dict(summary(host, prof), peak_gb=peak, held_gb=held,
                device_ms_by_kind=prof["device_ms_by_kind"])


STEPS = ("tp_decode", "zero_update", "train_step")


def summary(host: list[float], prof: dict) -> dict:
    return dict(median_host_ms=statistics.median(host), host_ms=host,
                **{k: prof[k] for k in ("wall_ms", "device_ms", "kernels_launched",
                                        "idle_share")})


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--src", required=True, help="the directory that holds repro_torch")
    ap.add_argument("--label", required=True)
    ap.add_argument("--out", required=True, help="JSON lines file to append to")
    ap.add_argument("--windows", type=int, default=7)
    ap.add_argument("--steps", type=int, default=8)
    ap.add_argument("--only", nargs="+", choices=STEPS, default=list(STEPS))
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("step_times: no CUDA device", file=sys.stderr)
        return 1
    os.environ.setdefault("PYTORCH_CUDA_ALLOC_CONF", "expandable_segments:True")
    sys.path.insert(0, str(Path(args.src).resolve()))
    sys.path.insert(1, str(ROOT))
    import torch.distributed as dist

    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.core import init_world, make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_map
    from repro_torch.models.weights import cast_params
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.train import optimizer, trainer

    t0 = time.perf_counter()
    out = dict(label=args.label, src=args.src, card=cs.nvidia_smi())
    device = init_world("cuda")
    try:
        if "tp_decode" in args.only:
            cfg = configs.get(cs.ARCH)
            params = cast_params(lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                                               device="cuda"), cfg.act_dtype)
            out["tp_decode"] = tp_decode(cs, cfg, params, Engine, ServeConfig,
                                         make_mesh((1, 1), ("data", "model"), device=device),
                                         args.windows, args.steps)
            del params
            torch.cuda.empty_cache()
        if "zero_update" in args.only:
            out["zero_update"] = zero_update(cs, configs, lm, trainer, optimizer, tree_map,
                                             make_mesh((1,), ("data",), device=device),
                                             args.windows)
        if "train_step" in args.only:
            out["train_step"] = train_step(cs, configs, lm, trainer, optimizer, args.windows)
    finally:
        dist.destroy_process_group()
    out["seconds"] = time.perf_counter() - t0
    with open(args.out, "a") as f:
        f.write(json.dumps(out) + "\n")
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
