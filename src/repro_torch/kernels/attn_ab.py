"""Times other builds of the attention kernels beside the checkout's, on one card.

    git show HEAD~1:src/repro_torch/kernels/csrc/flash_attention.cu > build/fa_parent.cu
    git show HEAD~1:src/repro_torch/kernels/csrc/flash_decode.cu > build/fd_parent.cu
    PYTHONPATH=src python -m repro_torch.kernels.attn_ab \
        parent=build/fa_parent.cu,build/fd_parent.cu

Each ``NAME=FA,FD`` names a ``flash_attention.cu`` and a ``flash_decode.cu``
(with ``csrc/`` on the include path for their headers), built with the
port's ``nvcc`` flags into ``build/torch_kernels/ab/``, all at once.  A
named ``flash_attention.cu`` must have the checkout's C entry points (a
``flash_attention_fwd`` that takes the v head dim ``Dv`` after ``D``): the
wrappers bind every build alike.  The checkout's build (``this``) and each
named one are timed with ``queued_ms`` through the port's own wrappers
(their ``lib`` argument) at the paths' bf16 shapes: the forward (q
1x24x4096x128, k/v 1x8x4096x128, causal), MLA's forward (q/k
1x40x4096x96, v 1x40x4096x64, causal: the (96, 64) instance), the
off-diagonal carry step of a 4-rank ring over the first forward's tokens
(rank 1, step 1: 1024 rows x 1024 keys), a decode step (4 slots, cache
4096, lengths 1, 700, 2049, 4096) and a prefill chunk (4 x 2048 queries,
lengths 2047, 1000, 300, 0, the last slot idle).  The builds take turns,
this, the others, the others again in reverse, this, so each time has a
twin taken at the other end of the run; both are printed.  Beside the
times, each build's max abs difference from the plain version.  Prints one
JSON line per build and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from . import build, ops
from . import flash_attention as fa
from . import flash_decode as fd
from .timing import queued_ms

SEQ, RING = 4096, 4
DECODE = dict(dims=(4, 24, 8, 1, 4096, 128), lens=(1, 700, 2049, 4096), start=None)
PREFILL = dict(dims=(4, 24, 8, 2048, 4096, 128), lens=(2047, 1000, 300, 0), start=(0, 0, 300, 0))


def _randn(shape, seed: int) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, device="cuda", generator=g).to(torch.bfloat16)


def _decode_case(dims, lens, start, seed: int):
    B, Hq, G, S, T, D = dims
    q, kc, vc = _randn((B, Hq, S, D), seed), _randn((B, G, T, D), seed + 1), \
        _randn((B, G, T, D), seed + 2)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pos = None
    if start is not None:
        pos = (torch.tensor(start, dtype=torch.int32, device="cuda")[:, None]
               + torch.arange(S, dtype=torch.int32, device="cuda")[None, :])
    return q, kc, vc, lens_t, pos


def cases() -> dict:
    """``{label: (run(libs) -> output, plain() -> output)}`` at the five
    shapes, on seeded inputs.  The carry step updates one state in place
    call after call (the same work each time); its first call starts from
    the plain version's state."""
    from ..models.attention import ring_step_offsets

    q, k, v = _randn((1, 24, SEQ, 128), 0), _randn((1, 8, SEQ, 128), 1), \
        _randn((1, 8, SEQ, 128), 2)
    cap = SEQ // RING
    q_off, k_off = ring_step_offsets(1, 1, RING, cap)
    qr, kb, vb = q[:, :, cap:2 * cap], k[:, :, k_off:k_off + cap], v[:, :, k_off:k_off + cap]
    state = (torch.zeros((1, 24, cap, 128), device="cuda"),
             torch.full((1, 24, cap), -1e30, device="cuda"),
             torch.zeros((1, 24, cap), device="cuda"))
    kw = dict(q_offset=q_off, k_offset=k_off, causal=True)
    carry = {}

    def run_carry(libs):
        if libs not in carry:
            carry[libs] = tuple(t.clone() for t in state)
        return fa.flash_attention_carry_cuda(qr, kb, vb, carry[libs], lib=libs[0], **kw)[0]

    dec, pre = _decode_case(**DECODE, seed=40), _decode_case(**PREFILL, seed=40)
    mq, mk, mv = _randn((1, 40, SEQ, 96), 3), _randn((1, 40, SEQ, 96), 4), \
        _randn((1, 40, SEQ, 64), 5)
    return {
        "forward": (lambda libs: fa.flash_attention_cuda(q, k, v, lib=libs[0]),
                    lambda: ops.flash_attention(q, k, v, impl="ref")),
        "mla_forward": (lambda libs: fa.flash_attention_cuda(mq, mk, mv, lib=libs[0]),
                        lambda: ops.flash_attention(mq, mk, mv, impl="ref")),
        "carry_off_diagonal": (
            run_carry, lambda: ops.flash_attention_carry(qr, kb, vb, state, impl="ref", **kw)[0]),
        "decode_step": (lambda libs: fd.flash_decode_cuda(*dec[:4], q_positions=dec[4],
                                                          lib=libs[1]),
                        lambda: ops.flash_decode(*dec[:4], q_positions=dec[4], impl="ref")),
        "prefill_chunk": (lambda libs: fd.flash_decode_cuda(*pre[:4], q_positions=pre[4],
                                                            lib=libs[1]),
                          lambda: ops.flash_decode(*pre[:4], q_positions=pre[4], impl="ref")),
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", metavar="NAME=FA,FD")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = {}
    for s in args.sources:
        name, pair = s.split("=", 1)
        fa_src, fd_src = pair.split(",")
        sources[name] = (Path(fa_src), Path(fd_src))
    libs = {"this": (fa.load_library(), fd.load_library())}
    built = build.build_variants({f"{kind}_{name}": src for name, pair in sources.items()
                                  for kind, src in zip(("fa", "fd"), pair)})
    libs.update({name: (fa.bind(ctypes.CDLL(str(built[f"fa_{name}"]))),
                        fd.bind(ctypes.CDLL(str(built[f"fd_{name}"])))) for name in sources})
    order = list(libs) + list(reversed(libs))
    rows = {name: {} for name in libs}
    for label, (run, plain) in cases().items():
        want = plain().float()
        for name in libs:
            rows[name][f"{label}_max_abs_diff_from_plain"] = \
                (run(libs[name]).float() - want).abs().max().item()
        del want
        for name in order:
            rows[name].setdefault(f"{label}_ms", []).append(queued_ms(lambda: run(libs[name])))
        torch.cuda.empty_cache()
    for name, row in rows.items():
        print(json.dumps({"source": name, **row}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
