"""Serving from a training checkpoint, and the port's two walk-through
examples, on the CPU.

``repro_torch.launch.train`` (2 steps of the phi4-mini SMOKE config) writes
a checkpoint of ``{"params", "opt"}``; ``repro_torch.launch.serve
--ckpt-dir`` restores it, prints the restored step and serves the
launcher's seeded requests from its parameters:

* one process: the restored parameters equal the checkpoint's leaves
  bitwise (and are not the seeded initialisation they replace), and the
  launcher's greedy tokens equal an engine's on those parameters;
* the same at ``--grid 1x2`` on 2 gloo ranks (the world ``torchrun`` would
  make; the ranks meet through a ``file://`` rendezvous): every rank
  restores the checkpoint bitwise, and rank 0 prints the greedy tokens of
  a tensor-parallel engine on those parameters.

``repro_torch.examples.quickstart`` (its scatter over a world of one rank)
and ``repro_torch.examples.serve_lm`` run to their end.
"""
import ast
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from _torch_dist import run_gloo
from repro_torch import configs
from repro_torch.ckpt.manager import flatten
from repro_torch.launch import serve
from repro_torch.models import lm
from repro_torch.serve.engine import Engine, ServeConfig

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
ARCH = "phi4-mini-3.8b"
REQUESTS, MAX_NEW = 3, 4
SERVE = ["--arch", ARCH, "--smoke", "--device", "cpu", "--requests", str(REQUESTS),
         "--max-new", str(MAX_NEW)]


def _run(*args, timeout=240):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def _tokens(stdout: str) -> dict:
    """The launcher's ``[serve] req <id>: [...]`` lines as ``{id: tokens}``."""
    out = {}
    for line in stdout.splitlines():
        if line.startswith("[serve] req ") and "IN-FLIGHT" not in line:
            rid, toks = line[len("[serve] req "):].split(": ", 1)
            out[int(rid)] = ast.literal_eval(toks)
    return out


def _saved_params(directory, step: int, n: int) -> list:
    """The last ``n`` leaves of checkpoint ``step``, read from its files:
    the parameters (``{"opt", "params"}`` flatten in sorted key order)."""
    path = os.path.join(directory, f"step_{step:08d}")
    total = len([f for f in os.listdir(path) if f.startswith("leaf_")])
    return [np.load(os.path.join(path, f"leaf_{i}.npy")) for i in range(total - n, total)]


@pytest.fixture(scope="module")
def ckpt(tmp_path_factory):
    directory = tmp_path_factory.mktemp("serve_ckpt")
    proc = _run("-m", "repro_torch.launch.train", "--arch", ARCH, "--smoke", "--device", "cpu",
                "--steps", "2", "--seq-len", "16", "--global-batch", "2", "--ckpt-dir",
                str(directory))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "final ckpt at 2" in proc.stdout
    return str(directory)


def _init():
    cfg = configs.get(ARCH, smoke=True)
    return cfg, lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_serve_restores_what_train_wrote(ckpt):
    proc = _run("-m", "repro_torch.launch.serve", *SERVE, "--ckpt-dir", ckpt)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[serve] restored from 2" in proc.stdout
    cfg, init = _init()
    restored, step = serve.restore_params(init, ckpt)
    assert step == 2
    got = flatten(restored)
    saved = _saved_params(ckpt, 2, len(got))
    for a, b in zip(got, saved, strict=True):
        assert a.dtype == torch.float32 and np.array_equal(a.numpy(), b)
    assert any(not torch.equal(a, b) for a, b in zip(got, flatten(init)))
    engine = Engine(cfg, restored, ServeConfig(max_len=256, batch_slots=4, eos_token=-1))
    for rid, prompt in enumerate(serve.prompts(cfg, REQUESTS)):
        engine.submit(rid, prompt, MAX_NEW)
    want = engine.run()
    assert sorted(want) == list(range(REQUESTS))
    assert _tokens(proc.stdout) == want


def test_serve_restores_under_a_grid(ckpt, tmp_path):
    ranks = run_gloo("_torch_recipe:serve_launcher", 2, tmp_path / "gloo",
                     argv=SERVE + ["--ckpt-dir", ckpt, "--grid", "1x2"], arch=ARCH,
                     ckpt_dir=ckpt, grid=(1, 2), requests=REQUESTS, max_new=MAX_NEW)
    cfg, init = _init()
    saved = _saved_params(ckpt, 2, len(flatten(init)))
    for rank, got in enumerate(ranks):
        assert got["rc"] == 0 and got["step"] == 2, rank
        for a, b in zip(got["restored"], saved, strict=True):
            assert np.array_equal(a, b), rank
    out = ranks[0]["stdout"]
    assert "[serve] restored from 2" in out and "grid 1x2 x 2 microbatches" in out
    assert sorted(ranks[0]["tokens"]) == list(range(REQUESTS))
    assert _tokens(out) == ranks[0]["tokens"]
    assert ranks[1]["stdout"] == ""  # rank 0 alone prints


@pytest.mark.parametrize("example", [["quickstart"], ["serve_lm", "--device", "cpu"]],
                         ids=lambda e: e[0])
def test_example_runs_to_its_end(example):
    proc = _run("-m", f"repro_torch.examples.{example[0]}", *example[1:])
    assert proc.returncode == 0, proc.stderr[-3000:]
    last = {"quickstart": "exactly like MPI datatypes", "serve_lm": "continuous batching"}
    assert last[example[0]] in proc.stdout.splitlines()[-1]
