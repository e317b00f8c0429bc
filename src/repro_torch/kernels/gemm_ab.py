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
(``err_ratio``; the port's check allows 10), and whether its output equals
the checkout's (``bitwise_to_this``; a source compiled with its own copy
of a header beside it takes that copy).  Prints one JSON line per
source and the card's ``nvidia-smi`` name and power limit.

    PYTHONPATH=src python -m repro_torch.kernels.gemm_ab --bf16 NAME=path/to/gemm_bf16.cu ...

does the same for builds of ``csrc/gemm_bf16.cu`` on bf16 operands, the
builds timed in turns (this, the others, the others in reverse, this; both
readings printed): ``layout_gemm_bf16`` to a bf16 and to a float32 output
and ``layout_gemm_panel_bf16`` on a bf16 and on a float32 panel of one
block, in all 8 majors at EXTRALARGE through the TMA loader (and ``I/I/K``
through the plain loads too), ``I/I/K`` at dims+1, beside ``torch.mm``
(bf16 and ``out_dtype=torch.float32`` outputs, in each majors' own
orientation), ``addmm_`` and ``torch.addmm(out_dtype=torch.float32)``.
Each row names the store the wrapper would choose (``store_path_bf16``:
the TMA store or direct stores).  The error ratios are those of the port's
check: the float32 output's and the bf16 output's max abs error against a
float64 product over the plain version's (the float32 product of the bf16
values, rounded as the output is).  ``bitwise_to_this`` says whether every
output equals the checkout's: both outputs without acc, with a bf16 and
with a float32 acc, and both panels (``differ`` lists those that do not).
``--depths K,K,...`` adds EXTRALARGE's M and N at other depths K.
``--without-store NAME,...`` names builds whose entry points take no store
argument (a source from before the TMA store), ``this`` included.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
from pathlib import Path

import torch

from . import build
from .gemm import BF16_LOADERS, BF16_STORES, LOADERS, bind_bf16, loader_path, \
    loader_path_bf16, parse_majors, store_path_bf16
from .timing import queued_ms

SHAPES = {"EXTRALARGE": (2048, 2560, 1408), "dims+1": (2049, 2561, 1409)}
MAJORS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]


def _entry_points(lib: ctypes.CDLL):
    """``(gemm, panel, takes_loader)``: the two entry points, bound."""
    p, i = ctypes.c_void_p, ctypes.c_int
    takes_loader = hasattr(lib, "layout_gemm_smem_bytes")
    extra = [i] if takes_loader else []
    lib.layout_gemm_f32.argtypes = [p, p, p, p, i, i, i, i, i, i, *extra, p]
    lib.layout_gemm_panel_f32.argtypes = [p, p, p, i, i, i, i, i, i, i, i, p, i, *extra, p]
    return lib.layout_gemm_f32, lib.layout_gemm_panel_f32, takes_loader


def time_library(lib: ctypes.CDLL, data: dict, first: dict) -> dict:
    """Times and errors of one build of ``csrc/gemm.cu``; ``first`` keeps
    the first build's outputs by case, against which ``bitwise_to_this``
    holds each later build's."""
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
            out = c.clone()
            rows[key] = dict(gemm_ms=queued_ms(run_gemm), panel_ms=queued_ms(run_panel),
                             err_ratio=err / matmul_err,
                             bitwise_to_this=torch.equal(out, first.setdefault(key, out)))
    return rows


def _bf16_operands(majors: str, m: int, n: int, k: int, g):
    """Seeded bf16 A and B in the buffers' orientations of ``majors``, and
    their logical views ``(A (m, k), B (k, n))``."""
    _, a_major, b_major = majors.split("/")
    a = torch.randn((k, m) if a_major == "K" else (m, k), device="cuda", generator=g)
    b = torch.randn((n, k) if b_major == "J" else (k, n), device="cuda", generator=g)
    a, b = a.to(torch.bfloat16), b.to(torch.bfloat16)
    return a, b, (a.T if a_major == "K" else a), (b.T if b_major == "J" else b)


def bf16_rows(libs: dict, depths=(), no_store=()) -> dict:
    """``{build: {case: numbers}}`` of the bf16 builds, timed in turns, at
    :data:`SHAPES` and at EXTRALARGE's M and N with each K of ``depths``:
    every majors at EXTRALARGE, ``I/I/K`` elsewhere; the builds named in
    ``no_store`` are called without the store argument."""
    g = torch.Generator(device="cuda").manual_seed(0)
    stream = torch.cuda.current_stream().cuda_stream
    order = list(libs) + list(reversed(libs))
    rows = {name: {} for name in libs}
    m0, n0, _ = SHAPES["EXTRALARGE"]
    shapes = {**SHAPES, **{f"K={k}": (m0, n0, k) for k in depths}}
    for label, (m, n, k) in shapes.items():
        for majors in MAJORS if label == "EXTRALARGE" else ["I/I/K"]:
            a_trans, b_trans, c_trans = parse_majors(majors)
            a, b, al, bl = _bf16_operands(majors, m, n, k, g)
            orient = (lambda t: t.T.contiguous()) if c_trans else (lambda t: t)  # noqa: E731
            exact = orient(al.double() @ bl.double())
            plain = orient(al.float() @ bl.float())
            plain_err = {torch.float32: (plain.double() - exact).abs().max().item(),
                         torch.bfloat16: (plain.to(torch.bfloat16).double()
                                          - exact).abs().max().item()}
            shape = (n, m) if c_trans else (m, n)
            seeded = torch.randn(shape, device="cuda", generator=g)
            panels = {dtype: torch.zeros(shape, dtype=dtype, device="cuda")
                      for dtype in (torch.float32, torch.bfloat16)}
            aligned = loader_path_bf16(m, n, k, majors, a.data_ptr(), b.data_ptr()) == "tma"
            loaders = [path for path in BF16_LOADERS if path == "tma" and aligned
                       or path == "plain" and majors == "I/I/K"]
            for loader in loaders:
                key = f"{label} {majors} {loader}"

                def run_gemm(name, out, acc=None):
                    store = store_path_bf16(m, n, majors, out.data_ptr(), out.element_size(),
                                            None if acc is None else acc.data_ptr(),
                                            0 if acc is None else acc.element_size(),
                                            loader=loader)
                    extra = [] if name in no_store else [BF16_STORES[store]]
                    code = libs[name].layout_gemm_bf16(
                        a.data_ptr(), b.data_ptr(), None if acc is None else acc.data_ptr(),
                        out.data_ptr(), m, n, k, a_trans, b_trans, c_trans,
                        acc is not None and acc.dtype == torch.bfloat16,
                        out.dtype == torch.bfloat16, BF16_LOADERS[loader], *extra, stream)
                    if code:
                        raise RuntimeError(f"layout_gemm_bf16 failed: cudaError {code}")
                    return out

                def run_panel(name, panel):
                    store = store_path_bf16(m, n, majors, panel.data_ptr(),
                                            panel.element_size(), loader=loader)
                    extra = [] if name in no_store else [BF16_STORES[store]]
                    code = libs[name].layout_gemm_panel_bf16(
                        a.data_ptr(), b.data_ptr(), panel.data_ptr(), m, n, k, a_trans,
                        b_trans, c_trans, panel.shape[1], 1, None, 0,
                        panel.dtype == torch.bfloat16, BF16_LOADERS[loader], *extra, stream)
                    if code:
                        raise RuntimeError(f"layout_gemm_panel_bf16 failed: cudaError {code}")
                    return panel

                def outputs(name) -> dict:
                    """Every output the bitwise check compares: both output
                    dtypes without acc, a bf16 and a float32 acc, both panels."""
                    new = lambda dtype: torch.empty(shape, dtype=dtype, device="cuda")  # noqa: E731
                    return {
                        "out_f32": run_gemm(name, new(torch.float32)),
                        "out_bf16": run_gemm(name, new(torch.bfloat16)),
                        "acc_bf16": run_gemm(name, new(torch.bfloat16), seeded.bfloat16()),
                        "acc_f32": run_gemm(name, new(torch.float32), seeded.clone()),
                        "panel_bf16": run_panel(name, seeded.bfloat16()),
                        "panel_f32": run_panel(name, seeded.clone())}

                first = None
                for name in libs:
                    row = rows[name].setdefault(key, {})
                    got = outputs(name)
                    first = first or got
                    row["err_ratio"] = ((got["out_f32"].double() - exact).abs().max().item()
                                        / plain_err[torch.float32])
                    row["err_ratio_bf16_out"] = ((got["out_bf16"].double() - exact).abs().max()
                                                 .item() / plain_err[torch.bfloat16])
                    differ = [case for case in got if not torch.equal(got[case], first[case])]
                    row["bitwise_to_this"] = not differ
                    if differ:
                        row["differ"] = differ
                    row["store"] = "none (no store argument)" if name in no_store else \
                        store_path_bf16(m, n, majors, got["out_bf16"].data_ptr(), 2,
                                        loader=loader)
                    del got
                out16 = torch.empty(shape, dtype=torch.bfloat16, device="cuda")
                out32 = torch.empty(shape, device="cuda")
                for name in order:
                    row = rows[name][key]
                    for field, fn in (
                            ("gemm_ms", lambda: run_gemm(name, out16)),
                            ("gemm_f32_out_ms", lambda: run_gemm(name, out32)),
                            ("panel_bf16_ms", lambda: run_panel(name, panels[torch.bfloat16])),
                            ("panel_f32_ms", lambda: run_panel(name, panels[torch.float32]))):
                        row.setdefault(field, []).append(queued_ms(fn))
            mm = (lambda **kw: torch.mm(bl.T, al.T, **kw)) if c_trans else \
                (lambda **kw: torch.mm(al, bl, **kw))  # noqa: E731
            torch_row = dict(matmul_ms=queued_ms(mm),
                             mm_f32_out_ms=queued_ms(lambda: mm(out_dtype=torch.float32)))
            if majors == "I/I/K":
                torch_row["addmm_bf16_ms"] = queued_ms(
                    lambda: panels[torch.bfloat16].addmm_(a, b))
                torch_row["addmm_f32_out_ms"] = queued_ms(
                    lambda: torch.addmm(panels[torch.float32], a, b, out_dtype=torch.float32))
            rows.setdefault("torch", {})[f"{label} {majors}"] = torch_row
            del a, b, al, bl, exact, plain, seeded, panels
            torch.cuda.empty_cache()
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--bf16", action="store_true", help="builds of csrc/gemm_bf16.cu")
    ap.add_argument("--depths", type=lambda v: [int(k) for k in v.split(",")], default=[],
                    metavar="K,K,...", help="with --bf16: also EXTRALARGE's M and N at these K")
    ap.add_argument("--without-store", type=lambda v: v.split(","), default=[],
                    metavar="NAME,NAME,...",
                    help="with --bf16: builds (this included) whose entry points take no "
                         "store argument")
    ap.add_argument("sources", nargs="*", metavar="NAME=PATH")
    args = ap.parse_args(argv)
    torch.backends.cuda.matmul.allow_tf32 = False
    sources = dict(s.split("=", 1) for s in args.sources)
    if args.bf16:
        no_store = set(args.without_store)
        libs = {"this": bind_bf16(build.load("gemm_bf16"), takes_store="this" not in no_store)}
        libs.update({name: bind_bf16(ctypes.CDLL(str(path)), takes_store=name not in no_store)
                     for name, path in
                     build.build_variants({n: Path(p) for n, p in sources.items()}).items()})
        for name, row in bf16_rows(libs, args.depths, no_store).items():
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
    first = {}
    for name, lib in libs.items():
        print(json.dumps({"source": name, **time_library(lib, data, first)}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
