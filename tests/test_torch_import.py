"""Import guard and device rules of the port.

``repro_torch`` and ``chip_smoke.py`` must never import ``jax`` or the
reference package ``repro``, and the port's entry points run on the GPU
unless the caller asks for the CPU.  Each check runs in a fresh interpreter,
so nothing the test process imported can hide a leak.
"""
import ast
import os
import subprocess
import sys

import pytest

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def _python(code: str, *args: str, cwd: str = ROOT, timeout: int = 240) -> subprocess.CompletedProcess:
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC
    env["CUDA_VISIBLE_DEVICES"] = ""  # the same answer on a GPU host: no card
    cmd = [sys.executable] + (["-c", code] if code else []) + list(args)
    return subprocess.run(cmd, capture_output=True, text=True, timeout=timeout, env=env, cwd=cwd)


def _forbidden(name: str) -> bool:
    return name.split(".")[0] in ("jax", "jaxlib", "repro")


def test_every_port_module_imports_without_jax_or_reference():
    code = """
import importlib, pkgutil, sys
import repro_torch
names = [m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro"))
assert not bad, bad
print("IMPORTED", len(names))
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert int(proc.stdout.split("IMPORTED")[1]) >= 15


LM_MODULES = [
    "repro_torch.configs.base", "repro_torch.configs.phi4_mini_3_8b",
    "repro_torch.configs.qwen2_5_32b", "repro_torch.kernels.build",
    "repro_torch.kernels.flash_attention", "repro_torch.kernels.flash_decode",
    "repro_torch.models.module", "repro_torch.models.attention", "repro_torch.models.ffn",
    "repro_torch.models.blocks", "repro_torch.models.lm", "repro_torch.models.weights",
    "repro_torch.serve.kv", "repro_torch.serve.engine", "repro_torch.launch.serve",
    "repro_torch.models.sharding", "repro_torch.kernels.relayout",
    "repro_torch.serve.tp_decode", "repro_torch.configs.phi3_5_moe_42b",
    "repro_torch.configs.arctic_480b", "repro_torch.train.optimizer",
    "repro_torch.train.buckets", "repro_torch.train.trainer", "repro_torch.data.pipeline",
    "repro_torch.ckpt.manager", "repro_torch.launch.train", "repro_torch.examples.train_lm",
    "repro_torch.examples.quickstart", "repro_torch.examples.serve_lm",
]


def test_lm_stack_modules_import_without_jax_or_reference():
    code = f"""
import importlib, sys
for name in {LM_MODULES!r}:
    importlib.import_module(name)
    bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro"))
    assert not bad, (name, bad)
print("OK")
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout


def test_chip_smoke_imports_nothing_of_jax_or_reference():
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        tree = ast.parse(f.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.append(node.module)
    assert names and not [n for n in names if _forbidden(n)]


def test_chip_smoke_fails_without_a_gpu():
    proc = _python("", "chip_smoke.py")
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_chip_smoke_fails_outside_the_checkout(tmp_path):
    """Alone in a directory, the script cannot find the port and must fail."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as f:
        (tmp_path / "chip_smoke.py").write_text(f.read())
    proc = subprocess.run([sys.executable, "chip_smoke.py"], capture_output=True, text=True,
                          timeout=240, cwd=tmp_path, env={**os.environ, "PYTHONPATH": ""})
    assert proc.returncode != 0
    assert '"ok": true' not in proc.stdout


def test_entry_points_need_a_gpu_unless_asked_for_the_cpu():
    code = """
import numpy as np
from repro_torch.examples import distributed_gemm as g
for run in (g.run_distributed_gemm, g.run_summa_gemm, g.run_ragged_summa_gemm):
    try:
        run(ni=9, nj=8, nk=7, grid=(1, 1)) if run is not g.run_distributed_gemm else run(ni=9, nj=8, nk=7)
    except RuntimeError as e:
        assert "device='cpu'" in str(e), e
    else:
        raise AssertionError("ran without a GPU")
C, ref = g.run_distributed_gemm(ni=8, nj=8, nk=8, majors="J/K/J", device="cpu")
np.testing.assert_allclose(C, ref, rtol=1e-5, atol=1e-5)
C, ref = g.run_summa_gemm(ni=8, nj=8, nk=8, grid=(1, 1), majors="I/K/J", device="cpu")
np.testing.assert_allclose(C, ref, rtol=1e-5, atol=1e-5)
C, ref = g.run_ragged_summa_gemm(ni=9, nj=8, nk=7, grid=(1, 1), majors="J/I/K", device="cpu")
np.testing.assert_allclose(C, ref, rtol=1e-5, atol=1e-5)
print("OK")
"""
    proc = _python(code)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "OK" in proc.stdout


@pytest.mark.parametrize("flags", [["--majors", "J/K/J"], ["--summa", "--grid", "1x1"],
                                   ["--summa", "--grid", "1x1", "--uneven", "--blocking"]])
def test_cli_validates_on_the_cpu(flags):
    proc = _python("", "-m", "repro_torch.examples.distributed_gemm", "--device", "cpu", *flags)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "all configurations validated" in proc.stdout


def test_serve_cli_needs_a_gpu_unless_asked_for_the_cpu():
    proc = _python("", "-m", "repro_torch.launch.serve", "--arch", "phi4-mini-3.8b", "--smoke")
    assert proc.returncode != 0
    assert "device='cpu'" in proc.stderr


def test_serve_cli_serves_on_the_cpu():
    proc = _python("", "-m", "repro_torch.launch.serve", "--arch", "phi4-mini-3.8b", "--smoke",
                   "--device", "cpu", "--requests", "5", "--slots", "2", "--max-new", "4")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[serve] 5 done / 0 in flight, 20 tokens requested" in proc.stdout
    assert proc.stdout.count("[serve] req ") == 5


def test_serve_cli_raises_for_what_is_not_ported():
    proc = _python("", "-m", "repro_torch.launch.serve", "--arch", "phi4-mini-3.8b", "--smoke",
                   "--device", "cpu", "--fake-devices", "8")
    assert proc.returncode != 0 and "torchrun" in proc.stderr, proc.stderr[-2000:]
    # the VLM: the engine builds no image batch, as the reference's does not
    proc = _python("", "-m", "repro_torch.launch.serve", "--arch", "llama-3.2-vision-11b",
                   "--smoke", "--device", "cpu")
    assert proc.returncode != 0 and "NotImplementedError" in proc.stderr
    assert "image_embeds" in proc.stderr


def test_serve_cli_serves_tensor_parallel_on_gloo_ranks():
    """``--grid 2x2`` under ``torchrun``: 4 gloo ranks serve the same
    requests with TP decode; rank 0 alone prints them."""
    proc = _python("", "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "4",
                   "-m", "repro_torch.launch.serve", "--arch", "phi4-mini-3.8b", "--smoke",
                   "--device", "cpu", "--grid", "2x2", "--requests", "5", "--slots", "4",
                   "--max-new", "4")
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[serve] 5 done / 0 in flight, 20 tokens requested" in proc.stdout
    assert "grid 2x2 x 2 microbatches" in proc.stdout
    assert proc.stdout.count("[serve] req ") == 5
