"""Times other builds of ``csrc/gemm.cu`` beside the checkout's, on one card.

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
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from . import build
from .gemm import LOADERS, loader_path
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("sources", nargs="*", metavar="NAME=PATH")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = dict(s.split("=", 1) for s in args.sources)
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
