"""Builds and loads the port's CUDA kernels.

Every ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its own
shared library with a plain C interface, ``build/torch_kernels/lib<name>_<hash>.so``
in the checkout, at first use.  The hash covers the source, every header in
``csrc/`` and the flags, so an edit rebuilds and an unchanged tree reuses
the library.  :func:`build_all` starts one ``nvcc`` per source at once and
waits for all of them.  A build failure raises; nothing falls back.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["SOURCES", "build_all", "build_log", "build_variants", "load", "library_path"]

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "torch_kernels"
NVCC_FLAGS = ["-gencode=arch=compute_90a,code=sm_90a", "-std=c++17", "-O3", "-shared",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v"]
SOURCES = tuple(sorted(p.stem for p in CSRC.glob("*.cu")))


def _find_nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    candidates = [os.path.join(home, "bin", "nvcc")] if home else []
    candidates += [shutil.which("nvcc") or "", "/usr/local/cuda/bin/nvcc"]
    for c in candidates:
        if c and os.path.isfile(c):
            return c
    raise RuntimeError("nvcc not found (set CUDA_HOME); the port's kernels are built from source")


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` is (or will be) built."""
    if name not in SOURCES:
        raise ValueError(f"no kernel source csrc/{name}.cu (have {SOURCES})")
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{name}_{h.hexdigest()[:16]}.so"


def build_all(names=SOURCES) -> dict[str, Path]:
    """Build every library that is missing, one ``nvcc`` per source, all
    started together; returns ``{name: path}``.  Raises with nvcc's errors
    if any build fails."""
    paths = {n: library_path(n) for n in names}
    todo = {n: p for n, p in paths.items() if not p.exists()}
    if not todo:
        return paths
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    procs = {}
    for n, p in todo.items():
        tmp = p.with_name(f"{p.name}.{os.getpid()}.tmp")
        cmd = [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{n}.cu")]
        procs[n] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                     text=True), tmp, cmd)
    failed = []
    for n, (proc, tmp, cmd) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            failed.append(f"nvcc failed for {n} (rc={proc.returncode}):\n{' '.join(cmd)}\n{out}")
        else:
            todo[n].with_suffix(".log").write_text(out)
            os.replace(tmp, todo[n])  # atomic: concurrent builders never load a partial file
    if failed:
        raise RuntimeError("\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """nvcc's output (ptxas registers, shared memory, spills) from the build
    of ``name``'s library, kept beside it; empty before it is built."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""


def build_variants(sources: dict[str, Path]) -> dict[str, Path]:
    """Build ``{name: source}``, other versions of kernel sources (for timing
    them beside the checkout's), with the same flags and ``csrc/`` on the
    include path, into ``build/torch_kernels/ab/lib<name>.so`` (nvcc's output
    beside it, ``.log``), one ``nvcc`` each, all at once; returns ``{name:
    library}``.  Raises if any fails."""
    out = BUILD_DIR / "ab"
    out.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    libs = {name: out / f"lib{name}.so" for name in sources}
    procs = {name: subprocess.Popen([nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(libs[name]),
                                     str(src)], stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True)
             for name, src in sources.items()}
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{log[-4000:]}")
        libs[name].with_suffix(".log").write_text(log)
    return libs


@functools.lru_cache(maxsize=None)
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load the library of ``csrc/<name>.cu``."""
    return ctypes.CDLL(str(build_all((name,))[name]))
