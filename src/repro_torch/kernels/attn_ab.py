"""Times other builds of the attention kernels beside the checkout's, on one card.

    git show HEAD~1:src/repro_torch/kernels/csrc/flash_attention.cu > build/fa_parent.cu
    git show HEAD~1:src/repro_torch/kernels/csrc/flash_decode.cu > build/fd_parent.cu
    PYTHONPATH=src python -m repro_torch.kernels.attn_ab \
        parent=build/fa_parent.cu,build/fd_parent.cu [--decode-without-dv parent]

Each ``NAME=FA,FD`` names a ``flash_attention.cu`` and a ``flash_decode.cu``
(with ``csrc/`` on the include path for their headers), built with the
port's ``nvcc`` flags into ``build/torch_kernels/ab/``, all at once.  A
named ``flash_attention.cu`` must have the checkout's C entry points (a
``flash_attention_fwd`` that takes the v head dim ``Dv`` after ``D``): the
wrappers bind every build alike.  A ``flash_decode.cu`` from before its
``flash_decode_fwd`` and ``flash_decode_smem_bytes`` took the v head dim
is named with ``--decode-without-dv NAME``: it is called with the
checkout's arguments less Dv, which every case here sets to D.  The
checkout's build (``this``) and each named one are timed with
``queued_ms`` through the port's own wrappers (their ``lib`` argument) at
the paths' bf16 shapes: the forward (q 1x24x4096x128, k/v 1x8x4096x128,
causal), MLA's forward (q/k 1x40x4096x96, v 1x40x4096x64, causal: the
(96, 64) instance), the off-diagonal carry step of a 4-rank ring over the
first forward's tokens (rank 1, step 1: 1024 rows x 1024 keys), a decode
step (4 slots, cache 4096, lengths 1, 700, 2049, 4096) and a prefill chunk
(4 x 2048 queries, lengths 2047, 1000, 300, 0, the last slot idle); the
same two on float32 caches (the float32 body and its combine kernel); and
decode steps of the D = 112 (5 slots x 32 heads, MHA, lengths 1, 700,
2049, 4096, 4096) and D = 64 (4 slots x 32 heads, MHA) instances.  The
builds take turns, this, the others, the others again in reverse, this,
so each time has a twin taken at the other end of the run; both are
printed.  Beside the times, each build's max abs difference from the
plain version and whether its output equals this build's bitwise.  Prints
one JSON line per build and the card's ``nvidia-smi`` name and power limit.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path
from types import SimpleNamespace

import torch

from . import build, ops
from . import flash_attention as fa
from . import flash_decode as fd
from .timing import queued_ms

SEQ, RING = 4096, 4
DECODE = dict(dims=(4, 24, 8, 1, 4096, 128), lens=(1, 700, 2049, 4096), start=None)
PREFILL = dict(dims=(4, 24, 8, 2048, 4096, 128), lens=(2047, 1000, 300, 0), start=(0, 0, 300, 0))
DECODE_112 = dict(dims=(5, 32, 32, 1, 4096, 112), lens=(1, 700, 2049, 4096, 4096), start=None)
DECODE_64 = dict(dims=(4, 32, 32, 1, 4096, 64), lens=(1, 700, 2049, 4096), start=None)


def _randn(shape, seed: int, dtype=torch.bfloat16) -> torch.Tensor:
    g = torch.Generator(device="cuda").manual_seed(seed)
    return torch.randn(shape, device="cuda", generator=g).to(dtype)


def _decode_case(dims, lens, start, seed: int, dtype=torch.bfloat16):
    B, Hq, G, S, T, D = dims
    q, kc, vc = _randn((B, Hq, S, D), seed, dtype), _randn((B, G, T, D), seed + 1, dtype), \
        _randn((B, G, T, D), seed + 2, dtype)
    lens_t = torch.tensor(lens, dtype=torch.int32, device="cuda")
    pos = None
    if start is not None:
        pos = (torch.tensor(start, dtype=torch.int32, device="cuda")[:, None]
               + torch.arange(S, dtype=torch.int32, device="cuda")[None, :])
    return q, kc, vc, lens_t, pos


def cases() -> dict:
    """``{label: (run(libs) -> output, plain() -> output)}`` at the
    shapes above, on seeded inputs.  The carry step updates one state in
    place call after call (the same work each time); its first call starts
    from the plain version's state, as does the next after
    ``run.reset()``."""
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
        key = id(libs[0])
        if key not in carry:
            carry[key] = tuple(t.clone() for t in state)
        return fa.flash_attention_carry_cuda(qr, kb, vb, carry[key], lib=libs[0], **kw)[0]

    run_carry.reset = carry.clear  # the next call of each build starts from the plain state

    def decode(case):
        return (lambda libs: fd.flash_decode_cuda(*case[:4], q_positions=case[4], lib=libs[1]),
                lambda: ops.flash_decode(*case[:4], q_positions=case[4], impl="ref"))

    mq, mk, mv = _randn((1, 40, SEQ, 96), 3), _randn((1, 40, SEQ, 96), 4), \
        _randn((1, 40, SEQ, 64), 5)
    return {
        "forward": (lambda libs: fa.flash_attention_cuda(q, k, v, lib=libs[0]),
                    lambda: ops.flash_attention(q, k, v, impl="ref")),
        "mla_forward": (lambda libs: fa.flash_attention_cuda(mq, mk, mv, lib=libs[0]),
                        lambda: ops.flash_attention(mq, mk, mv, impl="ref")),
        "carry_off_diagonal": (
            run_carry, lambda: ops.flash_attention_carry(qr, kb, vb, state, impl="ref", **kw)[0]),
        "decode_step": decode(_decode_case(**DECODE, seed=40)),
        "prefill_chunk": decode(_decode_case(**PREFILL, seed=40)),
        "decode_step_f32": decode(_decode_case(**DECODE, seed=40, dtype=torch.float32)),
        "prefill_chunk_f32": decode(_decode_case(**PREFILL, seed=40, dtype=torch.float32)),
        "decode_step_112": decode(_decode_case(**DECODE_112, seed=40)),
        "decode_step_64": decode(_decode_case(**DECODE_64, seed=40)),
    }


def bind_decode_without_dv(lib: ctypes.CDLL) -> SimpleNamespace:
    """A build of ``flash_decode.cu`` whose entry points take no v head dim,
    behind the checkout's interface: the Dv argument is checked equal to D
    and dropped."""
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.flash_decode_fwd.argtypes = [p] * 9 + [i] * 11 + [ctypes.POINTER(ctypes.c_longlong),
                                                          ctypes.c_float, p, p]
    lib.flash_decode_fwd.restype = i
    lib.flash_decode_smem_bytes.argtypes = [i, i, i]
    lib.flash_decode_smem_bytes.restype = ctypes.c_longlong
    lib.flash_decode_error_string.argtypes = [i]
    lib.flash_decode_error_string.restype = ctypes.c_char_p

    def fwd(*args):  # 9 pointers, the dtype, B, Hq, G, S, T, D, Dv, ...
        if args[15] != args[16]:
            raise ValueError(f"this build takes one head dim, got D={args[15]}, Dv={args[16]}")
        return lib.flash_decode_fwd(*args[:16], *args[17:])

    def smem(D, tr, bk, Dv):
        if D != Dv:
            raise ValueError(f"this build takes one head dim, got D={D}, Dv={Dv}")
        return lib.flash_decode_smem_bytes(D, tr, bk)

    return SimpleNamespace(flash_decode_fwd=fwd, flash_decode_smem_bytes=smem,
                           flash_decode_error_string=lib.flash_decode_error_string)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", metavar="NAME=FA,FD")
    ap.add_argument("--decode-without-dv", action="append", default=[], metavar="NAME",
                    help="NAME's flash_decode.cu takes no v head dim")
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
                        (bind_decode_without_dv if name in args.decode_without_dv else fd.bind)(
                            ctypes.CDLL(str(built[f"fd_{name}"])))) for name in sources})
    order = list(libs) + list(reversed(libs))
    rows = {name: {} for name in libs}
    for label, (run, plain) in cases().items():
        reset = getattr(run, "reset", lambda: None)
        reset()
        want, this = plain().float(), run(libs["this"]).clone()
        reset()
        for name in libs:
            got = run(libs[name])
            rows[name][f"{label}_max_abs_diff_from_plain"] = \
                (got.float() - want).abs().max().item()
            rows[name][f"{label}_bitwise_to_this"] = torch.equal(got, this)
        del want, this, got
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
