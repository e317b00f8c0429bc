"""Smoke run of the PyTorch port on one NVIDIA GPU (built for Hopper, sm_90a).

    python3 chip_smoke.py

Builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc``, holds
each against its plain PyTorch version, drives the distributed GEMM case
study (1-D GEMM, double-buffered and blocking SUMMA, ragged SUMMA) at the
paper's EXTRALARGE size on a world of one rank (NCCL, grid 1x1), proves
under ``torch.profiler`` that the main path ran the port's kernels and no
library GEMM, and times the kernels against ``torch.matmul``.

Phases print one line each (or one line per case); any failed phase raises,
so the exit code is non-zero and no result line is printed.  The line before
the last is the card's name and power limit from ``nvidia-smi``; the last
line is ``{"ok": true, "device": {...}}``.  Needs a CUDA device and the
checkout around this file.
"""
from __future__ import annotations

import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
EXTRALARGE = (2048, 2560, 1408)  # PolyBench GEMM (ni, nj, nk), the paper's size
MAJORS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]
RTOL, ATOL = 1e-4, 1e-3  # kernel vs plain version: float32 sums in another order
FP32_PEAK = 67e12  # H100 SXM float32 outside the tensor cores, FLOP/s (data sheet)
HBM_RATE = 3.35e12  # H100 SXM device memory, bytes/s (data sheet)
LIBRARY_GEMM = re.compile(r"cublas|cutlass|xmma|gemm|sm90_|sm80_|ampere_|magma", re.I)


def phase(name: str, **fields) -> None:
    print(json.dumps({"phase": name, **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def buffers(majors: str, m: int, n: int, k: int, *, nb: int = 1, seed: int = 0):
    """Random A, B and a C-orientation accumulator/panel on the card."""
    c_major, a_major, b_major = majors.split("/")
    g = torch.Generator(device="cuda").manual_seed(seed)
    a = torch.randn((k, m) if a_major == "K" else (m, k), device="cuda", generator=g)
    b = torch.randn((n, k) if b_major == "J" else (k, n), device="cuda", generator=g)
    c = torch.randn((nb * n, m) if c_major == "J" else (m, nb * n), device="cuda", generator=g)
    return a, b, c


def median_ms(fn, *, iters: int = 20, warmup: int = 3) -> float:
    """Median of per-launch CUDA-event times."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(iters):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


def bound(m: int, n: int, k: int, *, acc: bool) -> tuple[float, str]:
    """Least time for the work on the card: bytes (each input read once, the
    output written once) over the memory rate vs float32 operations over the
    float32 peak, whichever is larger."""
    nbytes = 4 * (m * k + k * n + (2 if acc else 1) * m * n)
    flops = 2 * m * n * k + (m * n if acc else 0)
    t_bytes, t_ops = nbytes / HBM_RATE, flops / FP32_PEAK
    return (max(t_bytes, t_ops) * 1e3, "bytes" if t_bytes > t_ops else "operations")


def check_kernels(ops) -> dict:
    """Phase 2: every kernel against its plain version."""
    worst = {"gemm": 0.0, "gemm_panel": 0.0}
    for shape in (EXTRALARGE, (2049, 2561, 1409), (67, 131, 45)):
        m, n, k = shape
        errs = {}
        for majors in MAJORS:
            a, b, acc = buffers(majors, m, n, k)
            for with_acc in (False, True):
                c = acc if with_acc else None
                got = ops.gemm(a, b, c, majors=majors)
                want = ops.gemm(a, b, c, majors=majors, impl="ref")
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
                errs[majors + ("+acc" if with_acc else "")] = (got - want).abs().max().item()
        if shape == EXTRALARGE:
            worst["gemm"] = max(errs.values())
        phase("kernel_check", kernel="gemm", shape=shape, max_abs_err=errs)
    m, n, k, nb = EXTRALARGE[0], EXTRALARGE[1] // 4, EXTRALARGE[2], 4
    errs = {}
    for majors in MAJORS:
        a, b, panel = buffers(majors, m, n, k, nb=nb)
        for jb in range(nb):
            for jb_arg in (jb, torch.tensor([jb], dtype=torch.int32, device="cuda")):
                got = ops.gemm_panel(a, b, panel.clone(), jb_arg, majors=majors)
                want = ops.gemm_panel(a, b, panel.clone(), jb, majors=majors, impl="ref")
                torch.cuda.synchronize()
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL)
                keep = torch.ones_like(panel, dtype=torch.bool)
                blk = slice(jb * n, (jb + 1) * n)
                if majors.startswith("J"):
                    keep[blk, :] = False
                else:
                    keep[:, blk] = False
                if not torch.equal(got[keep], panel[keep]):
                    raise AssertionError(f"gemm_panel {majors} jb={jb} touched other blocks")
                where = "device" if isinstance(jb_arg, torch.Tensor) else "host"
                errs[f"{majors} jb={jb} {where}"] = (got - want).abs().max().item()
    worst["gemm_panel"] = max(errs.values())
    phase("kernel_check", kernel="gemm_panel", shape=(m, n, k, nb), untouched_blocks="bitwise",
          max_abs_err=errs)
    return worst


def drive_main_path(g, mesh1, mesh11) -> dict:
    """Phase 3: the case study's three entry points in all 8 majors."""
    ni, nj, nk = EXTRALARGE
    calls = {"panel1d": 0, "summa": 0, "ragged": 0}
    for majors in MAJORS:
        C, ref = g.run_distributed_gemm(ni=ni, nj=nj, nk=nk, majors=majors, mesh=mesh1)
        np.testing.assert_allclose(C, ref, rtol=1e-3, atol=1e-3)
        phase("main_path", entry="run_distributed_gemm", majors=majors,
              max_abs_err=float(np.abs(C - ref).max()))
        calls["panel1d"] += 1
        for name, run, dims in (("summa", g.run_summa_gemm, (ni, nj, nk)),
                                ("ragged", g.run_ragged_summa_gemm, (ni + 1, nj + 1, nk + 1))):
            out = {}
            for db in (True, False):
                out[db], ref = run(ni=dims[0], nj=dims[1], nk=dims[2], grid=(1, 1),
                                   majors=majors, mesh=mesh11, double_buffer=db)
                np.testing.assert_allclose(out[db], ref, rtol=1e-3, atol=1e-3)
                calls[name] += 1
            if not np.array_equal(out[True], out[False]):
                raise AssertionError(f"{name} {majors}: double-buffered != blocking")
            phase("main_path", entry=run.__name__, majors=majors, dims=dims,
                  max_abs_err=float(np.abs(out[True] - ref).max()), db_equals_blocking=True)
    return calls


def profile_main_path(g, mesh1, mesh11) -> None:
    """Phase 4: the main path's device kernels, by name."""
    from torch.profiler import ProfilerActivity, profile

    ni, nj, nk = EXTRALARGE
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        g.run_distributed_gemm(ni=ni, nj=nj, nk=nk, majors="J/K/J", mesh=mesh1)
        g.run_summa_gemm(ni=ni, nj=nj, nk=nk, grid=(1, 1), majors="I/K/J", mesh=mesh11)
        g.run_ragged_summa_gemm(ni=ni + 1, nj=nj + 1, nk=nk + 1, grid=(1, 1), majors="J/I/K",
                                mesh=mesh11)
        torch.cuda.synchronize()
    names = sorted({e.name for e in prof.events()
                    if e.device_type == torch.autograd.DeviceType.CUDA})
    if not names:
        raise AssertionError("the profiler recorded no device kernels")
    ours = [n for n in names if "layout_gemm" in n]
    library = [n for n in names if LIBRARY_GEMM.search(n) and "layout_gemm" not in n]
    if not any("layout_gemm_kernel" in n for n in ours):
        raise AssertionError(f"layout_gemm_kernel did not run; device kernels: {names}")
    if not any("layout_gemm_panel_kernel" in n for n in ours):
        raise AssertionError(f"layout_gemm_panel_kernel did not run; device kernels: {names}")
    if library:
        raise AssertionError(f"library GEMM kernels ran inside the main path: {library}")
    phase("kernel_proof", device_kernels=len(names), port_kernels=ours, library_gemms=library)


def time_kernels(ops, card: str) -> dict:
    """Phase 5: median times at the main path's shapes and at 8192^3."""
    rows = {}
    for label, (m, n, k) in (("EXTRALARGE", EXTRALARGE), ("8192^3", (8192, 8192, 8192))):
        a, b, _ = buffers("I/I/K", m, n, k)
        t_kernel = median_ms(lambda: ops.gemm(a, b, majors="I/I/K"))
        t_plain = median_ms(lambda: ops.gemm(a, b, majors="I/I/K", impl="ref"))
        t_lib = median_ms(lambda: torch.matmul(a, b))
        b_ms, b_by = bound(m, n, k, acc=False)
        rows[("gemm", label)] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                                     bound_ms=b_ms, bound_by=b_by)
        phase("time", kernel="gemm", majors="I/I/K", shape=(m, n, k), card=card, ms=t_kernel,
              tflops=2 * m * n * k / t_kernel / 1e9, plain_ms=t_plain, matmul_ms=t_lib,
              matmul_tflops=2 * m * n * k / t_lib / 1e9, bound_ms=b_ms, bound_by=b_by)
        del a, b
    # the SUMMA step at the main path's shape: grid 1x1, so one block of width nj
    m, n, k = EXTRALARGE
    a, b, panel = buffers("I/I/K", m, n, k, nb=1)
    t_kernel = median_ms(lambda: ops.gemm_panel(a, b, panel, 0, majors="I/I/K"))
    t_plain = median_ms(lambda: ops.gemm_panel(a, b, panel, 0, majors="I/I/K", impl="ref"))
    t_lib = median_ms(lambda: panel[:, 0:n].addmm_(a, b))
    b_ms, b_by = bound(m, n, k, acc=True)
    rows[("gemm_panel", "EXTRALARGE")] = dict(ms=t_kernel, plain_ms=t_plain, library_ms=t_lib,
                                              bound_ms=b_ms, bound_by=b_by)
    phase("time", kernel="gemm_panel", majors="I/I/K", shape=(m, n, k), nb=1, card=card,
          ms=t_kernel, tflops=2 * m * n * k / t_kernel / 1e9, plain_ms=t_plain,
          addmm_ms=t_lib, bound_ms=b_ms, bound_by=b_by)
    return rows


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this smoke run needs a GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import torch.distributed as dist

    from repro_torch.core import init_world, make_mesh
    from repro_torch.examples import distributed_gemm as g
    from repro_torch.kernels import gemm as kernels
    from repro_torch.kernels import ops

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    # phase 1: the card and the build
    card = nvidia_smi()
    t0 = time.perf_counter()
    kernels.load_library()
    build_s = time.perf_counter() - t0
    regs = [int(r) for r in re.findall(r"Used (\d+) registers", kernels.build_log())]
    spills = sum(int(s) for s in re.findall(r"(\d+) bytes spill stores", kernels.build_log()))
    phase("card", nvidia_smi=card, device=torch.cuda.get_device_name(0),
          torch=torch.__version__, cuda=torch.version.cuda, build_s=build_s,
          registers=[min(regs), max(regs)] if regs else None, spill_store_bytes=spills)

    # phase 2: kernels against their plain versions
    worst = check_kernels(ops)
    phase("kernels_vs_plain", max_abs_err=worst, rtol=RTOL, atol=ATOL)

    # phase 3: the main path on a world of one rank (NCCL)
    device = init_world("cuda")
    try:
        mesh1 = make_mesh((1,), ("r",), device=device)
        mesh11 = make_mesh((1, 1), ("rows", "cols"), device=device)
        kernels.gemm_cuda.launches = 0
        kernels.gemm_panel_cuda.launches = 0
        t0 = time.perf_counter()
        calls = drive_main_path(g, mesh1, mesh11)
        main_s = time.perf_counter() - t0
        launches = {"gemm": kernels.gemm_cuda.launches,
                    "gemm_panel": kernels.gemm_panel_cuda.launches}
        # 1-D: one gemm per rank per call; SUMMA and ragged SUMMA: R = 1 panel step per call
        expected = {"gemm": calls["panel1d"], "gemm_panel": calls["summa"] + calls["ragged"]}
        if launches != expected:
            raise AssertionError(f"main-path launches {launches} != expected {expected}")
        phase("main_path_launches", backend=str(dist.get_backend()), calls=calls,
              launches=launches, seconds=main_s)

        # phase 4: kernel proof under the profiler
        profile_main_path(g, mesh1, mesh11)
    finally:
        dist.destroy_process_group()

    # phase 5: times
    rows = time_kernels(ops, card)

    gemm_src = "src/repro_torch/kernels/csrc/gemm.cu"
    report = []
    for name, replaces in (("gemm", "src/repro/kernels/gemm.py:80"),
                           ("gemm_panel", "src/repro/kernels/gemm.py:181")):
        row = rows[(name, "EXTRALARGE")]
        report.append({"name": name, "route": "cuda", "source": gemm_src, "replaces": replaces,
                       "launches": launches[name], "max_abs_err": worst[name], **row})
    print(json.dumps({"kernels": report}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
