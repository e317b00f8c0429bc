"""Times other builds of ``csrc/gemm.cu`` or ``csrc/gemm_bf16.cu`` beside the checkout's, on one card.

    PYTHONPATH=src python -m repro_torch.kernels.gemm_ab NAME=path/to/gemm.cu [NAME=...]

Each source is built with the port's ``nvcc`` flags (and ``csrc/`` on the
include path, for its headers) into ``build/torch_kernels/ab/`` (all at
once).  Then ``layout_gemm_f32`` and
``layout_gemm_panel_f32`` of the checkout's build (``this``) and of each
source are timed with ``queued_ms`` at the case study's shapes: EXTRALARGE
and the ragged SUMMA's dims+1, ``I/I/K``, the panel with one block, beside
``torch.matmul`` (TF32 off).  A source whose entry points take no loader
argument (the float32 FFMA kernel of the first port) is called without one;
the others, builds of this kernel, are timed through every loader legal at
the shape (TMA where ``loader_path`` chooses it, the strided TMA, and
``cp.async``).  Beside each time stands the build's
max abs error against a float64 product over ``torch.matmul``'s
(``err_ratio``; the port's check allows 10).  Prints one JSON line per
source and the card's ``nvidia-smi`` name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.gemm_ab --bf16 NAME=path/to/gemm_bf16.cu ...

does the same for builds of ``csrc/gemm_bf16.cu`` on bf16 operands:
``layout_gemm_bf16`` to a bf16 and to a float32 output and
``layout_gemm_panel_bf16`` on a float32 panel of one block, ``I/I/K``,
through every loader legal at the shape, the builds timed in turns (this,
the others, the others in reverse, this; both readings printed), beside
``torch.matmul`` and ``torch.mm(..., out_dtype=torch.float32)``.  The error
ratios are those of the port's check: the float32 output's and the bf16
output's max abs error against a float64 product over the plain version's
(the float32 product of the bf16 values, rounded as the output is), and
``bitwise_to_this`` says whether the float32 output equals the checkout's.
``--depths K,K,...`` adds EXTRALARGE's M and N at other depths K.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from . import build
from .gemm import BF16_LOADERS, LOADERS, bind_bf16, load_bf16_library, loader_path, \
    loader_path_bf16
from .timing import queued_ms

SHAPES = {"EXTRALARGE": (2048, 2560, 1408), "dims+1": (2049, 2561, 1409)}


def _entry_points(lib: ctypes.CDLL):
    """``(gemm, panel, takes_loader)``: the two entry points, bound."""
    p, i = ctypes.c_void_p, ctypes.c_int
    takes_loader = hasattr(lib, "layout_gemm_smem_bytes")
    extra = [i] if takes_loader else []
    lib.layout_gemm_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, *extra, p]
    lib.layout_gemm_panel_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p, i, *extra, p]
    return lib.layout_gemm_f32, lib.layout_gemm_panel_f32, takes_loader


def time_library(lib: ctypes.CDLL, data: dict) -> dict:
    gemm, panel, takes_loader = _entry_points(lib)
    stream = torch.cuda.current_stream().cuda_stream
    rows = {}
    for label, (m, n, k) in SHAPES.items():
        a, b, c, exact, matmul_err = data[label]
        aligned = loader_path(m, n, k, "I/I/K", a.data_ptr(), b.data_ptr()) == "tma"
        loaders = [path for path in LOADERS if path != "tma" or aligned]
        for loader in loaders if takes_loader else (None,):
            extra = [LOADERS[loader]] if takes_loader else []

            def run_gemm():
                code = gemm(a.data_ptr(), b.data_ptr(), None, c.data_ptr(), m, n, k, 0, 0, 0,
                            *extra, stream)
                if code:
                    raise RuntimeError(f"layout_gemm_f32 failed: cudaError {code}")

            def run_panel():
                code = panel(a.data_ptr(), b.data_ptr(), c.data_ptr(), m, n, k, 0, 0, 0, n, 1,
                             None, 0, *extra, stream)
                if code:
                    raise RuntimeError(f"layout_gemm_panel_f32 failed: cudaError {code}")

            run_gemm()
            err = (c.double() - exact).abs().max().item()
            key = label if loader is None else f"{label} {loader}"
            rows[key] = dict(gemm_ms=queued_ms(run_gemm), panel_ms=queued_ms(run_panel),
                             err_ratio=err / matmul_err)
    return rows


def bf16_rows(libs: dict, depths=()) -> dict:
    """``{build: {case: numbers}}`` of the bf16 builds, timed in turns, at
    :data:`SHAPES` and at EXTRALARGE's M and N with each K of ``depths``."""
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    order = list(libs) + list(reversed(libs))
    rows = {name: {} for name in libs}
    m0, n0, _ = SHAPES["EXTRALARGE"]
    shapes = {**SHAPES, **{f"K={k}": (m0, n0, k) for k in depths}}
    for label, (m, n, k) in shapes.items():
        a = torch.randn((m, k), device="cuda", generator=g).to(torch.bfloat16)
        b = torch.randn((k, n), device="cuda", generator=g).to(torch.bfloat16)
        exact = a.double() @ b.double()
        plain = a.float() @ b.float()
        plain_err = {torch.float32: (plain.double() - exact).abs().max().item(),
                     torch.bfloat16: (plain.to(torch.bfloat16).double() - exact).abs().max().item()}
        panel = torch.zeros((m, n), device="cuda")
        aligned = loader_path_bf16(m, n, k, "I/I/K", a.data_ptr(), b.data_ptr()) == "tma"
        for loader in [path for path in BF16_LOADERS if path != "tma" or aligned]:
            key = f"{label} {loader}"

            def run_gemm(lib, out):
                code = lib.layout_gemm_bf16(a.data_ptr(), b.data_ptr(), None, out.data_ptr(),
                                            m, n, k, 0, 0, 0, 0, out.dtype == torch.bfloat16,
                                            BF16_LOADERS[loader], stream)
                if code:
                    raise RuntimeError(f"layout_gemm_bf16 failed: cudaError {code}")
                return out

            def run_panel(lib):
                code = lib.layout_gemm_panel_bf16(a.data_ptr(), b.data_ptr(), panel.data_ptr(),
                                                  m, n, k, 0, 0, 0, n, 1, None, 0, 0,
                                                  BF16_LOADERS[loader], stream)
                if code:
                    raise RuntimeError(f"layout_gemm_panel_bf16 failed: cudaError {code}")

            first = {}
            for name, lib in libs.items():
                row = rows[name].setdefault(key, {})
                for dtype, field in ((torch.float32, "err_ratio"),
                                     (torch.bfloat16, "err_ratio_bf16_out")):
                    out = run_gemm(lib, torch.empty((m, n), dtype=dtype, device="cuda"))
                    row[field] = (out.double() - exact).abs().max().item() / plain_err[dtype]
                    if dtype == torch.float32:
                        first.setdefault("f32", out)
                        row["bitwise_to_this"] = torch.equal(out, first["f32"])
            out16 = torch.empty((m, n), dtype=torch.bfloat16, device="cuda")
            out32 = torch.empty((m, n), device="cuda")
            for name in order:
                lib, row = libs[name], rows[name][key]
                for field, fn in (("gemm_ms", lambda: run_gemm(lib, out16)),
                                  ("gemm_f32_out_ms", lambda: run_gemm(lib, out32)),
                                  ("panel_f32_ms", lambda: run_panel(lib))):
                    row.setdefault(field, []).append(queued_ms(fn))
        rows.setdefault("torch", {})[label] = dict(
            matmul_ms=queued_ms(lambda: torch.matmul(a, b)),
            mm_f32_out_ms=queued_ms(lambda: torch.mm(a, b, out_dtype=torch.float32)))
        del a, b, exact, plain, panel
        torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true", help="builds of csrc/gemm_bf16.cu")
    ap.add_argument("--depths", type=lambda v: [int(k) for k in v.split(",")], default=[],
                    metavar="K,K,...", help="with --bf16: also EXTRALARGE's M and N at these K")
    ap.add_argument("sources", nargs="*", metavar="NAME=PATH")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = dict(s.split("=", 1) for s in args.sources)
    if args.bf16:
        libs = {"this": load_bf16_library()}
        libs.update({name: bind_bf16(ctypes.CDLL(str(path))) for name, path in
                     build.build_variants({n: Path(p) for n, p in sources.items()}).items()})
        for name, row in bf16_rows(libs, args.depths).items():
            print(json.dumps({"source": name, **row}), flush=True)
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=60).stdout.strip())
        return 0
    libs = {"this": build.load("gemm")}
    libs.update({name: ctypes.CDLL(str(path)) for name, path in
                 build.build_variants({n: Path(p) for n, p in sources.items()}).items()})
    g = torch.Generator(device="cuda").manual_seed(0)
    data = {}
    for label, (m, n, k) in SHAPES.items():
        a = torch.randn((m, k), device="cuda", generator=g)
        b = torch.randn((k, n), device="cuda", generator=g)
        exact = a.double() @ b.double()
        data[label] = (a, b, torch.empty((m, n), device="cuda"), exact,
                       ((a @ b).double() - exact).abs().max().item())
    print(json.dumps({"source": "torch.matmul", **{
        label: dict(gemm_ms=queued_ms(lambda a=a, b=b: torch.matmul(a, b)), max_abs_err=err)
        for label, (a, b, _, _, err) in data.items()}}), flush=True)
    for name, lib in libs.items():
        print(json.dumps({"source": name, **time_library(lib, data)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
