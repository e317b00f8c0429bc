"""Times the tensor-parallel decode step's float32 partials in two forms, on one card.

    PYTHONPATH=src python -m repro_torch.serve.tp_ab

phi4-mini-3.8b at full width (seeded random weights, bf16 activations) on a
one-rank NCCL ``(data, model)`` mesh, ``microbatches=2``: the TP engine
admits 4 seeded prompts of 128-2048 tokens (``chip_smoke.py``'s serving
prompts) and then runs steady decode steps with the partial output
projections (``tp_decode._partial``) in the checkout's form (``this``:
cuBLAS's bf16 product with a float32 output) and as ``torch.matmul`` on
float32 upcasts (``upcast``, the CPU's form), in turns this, upcast,
upcast, this.  Per turn: host ms a step (8 steps between two
synchronizations), device ms a step (the profiler's kernel time over 8 more
steps), the device's idle share, the kernels a step launches and the four
kernels that take the most device time a step.  Prints one JSON line per
turn and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import json
import subprocess
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core import init_world, make_mesh
from repro_torch.models import lm
from repro_torch.models.weights import cast_params
from repro_torch.serve import tp_decode
from repro_torch.serve.engine import Engine, ServeConfig

STEPS = 8


def upcast_partial(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    return torch.matmul(x.float(), w.to(x.dtype).float())


def decode_window(engine) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(STEPS):
        engine._decode_once()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) * 1e3 / STEPS
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(STEPS):
            engine._decode_once()
        torch.cuda.synchronize()
    kernels = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    by_name: dict[str, float] = {}
    for e in kernels:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3 / STEPS
    device = sum(by_name.values())
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return dict(host_ms=wall, device_ms=device, idle_share=1 - device / wall,
                kernels_per_step=len(kernels) / STEPS,
                top_kernels_ms=[(name[:60], ms) for name, ms in top])


def main() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    cfg = configs.get("phi4-mini-3.8b")
    params = cast_params(lm.init_model(cfg, torch.Generator(device="cuda").manual_seed(0),
                                       device="cuda"), cfg.act_dtype)
    rng = np.random.default_rng(0)
    prompts = [rng.integers(2, cfg.vocab, size=int(rng.integers(128, 2049))).tolist()
               for _ in range(4)]
    device = init_world("cuda")
    try:
        mesh = make_mesh((1, 1), ("data", "model"), device=device)
        this = tp_decode._partial
        for label, fn in (("this", this), ("upcast", upcast_partial),
                          ("upcast", upcast_partial), ("this", this)):
            tp_decode._partial = fn
            engine = Engine(cfg, params, ServeConfig(max_len=4096, batch_slots=4, eos_token=-1),
                            mesh=mesh, microbatches=2)
            for rid, prompt in enumerate(prompts):
                engine.submit(rid, prompt, 64)
            engine._fill_slots()
            engine._decode_once()
            print(json.dumps({"partial": label, **decode_window(engine)}), flush=True)
            del engine
            torch.cuda.empty_cache()
        tp_decode._partial = this
    finally:
        dist.destroy_process_group()
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())


if __name__ == "__main__":
    main()
