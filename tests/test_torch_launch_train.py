"""The training launcher and example on the CPU: three steps; a crash at
step 2 under the watchdog, restarted from the latest checkpoint, ends with
the same parameters and optimizer state as an uninterrupted run, bitwise;
the GPU is the default; a recipe mode that does not exist is refused."""
import os
import subprocess
import sys

import torch

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.models import lm
from repro_torch import configs
from repro_torch.train.optimizer import OptConfig, init_opt_state

ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))
SRC = os.path.join(ROOT, "src")


def _run(*args, env_extra=None, timeout=240):
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="1")
    env.update(env_extra or {})
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


TRAIN = ["-m", "repro_torch.launch.train", "--arch", "phi4-mini-3.8b", "--smoke",
         "--device", "cpu", "--seq-len", "16", "--global-batch", "4", "--log-every", "1"]


def test_train_cli_runs_three_steps_on_the_cpu(tmp_path):
    proc = _run(*TRAIN, "--steps", "3", "--ckpt-dir", str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.count("[train] step ") == 3
    assert "final ckpt at 3" in proc.stdout


def _final(path):
    cfg = configs.get("phi4-mini-3.8b", smoke=True)
    params = lm.init_model(cfg, torch.Generator().manual_seed(1), device="cpu")
    template = {"params": params, "opt": init_opt_state(params, OptConfig())}
    return CheckpointManager(path).restore(template, 4)[0]


def test_crash_and_restart_ends_bitwise_equal(tmp_path):
    steady = _run(*TRAIN, "--steps", "4", "--ckpt-every", "1", "--ckpt-dir",
                  str(tmp_path / "steady"))
    assert steady.returncode == 0, steady.stderr[-3000:]
    crash = _run(*TRAIN, "--steps", "4", "--ckpt-every", "1", "--crash-at-step", "2",
                 "--watchdog", "--ckpt-dir", str(tmp_path / "crash"))
    assert crash.returncode == 0, crash.stderr[-3000:]
    assert "FAULT INJECTION: crashing at step 2" in crash.stdout
    assert "[watchdog] trainer exited rc=42" in crash.stdout and "resumed from step" in crash.stdout
    a, b = _final(str(tmp_path / "steady")), _final(str(tmp_path / "crash"))
    for x, y in zip([a["params"], a["opt"]], [b["params"], b["opt"]]):
        from repro_torch.ckpt.manager import flatten
        for s, t in zip(flatten(x), flatten(y)):
            assert torch.equal(s, t)


def test_train_cli_needs_a_gpu_unless_asked_for_the_cpu():
    proc = _run("-m", "repro_torch.launch.train", "--arch", "phi4-mini-3.8b", "--smoke",
                "--steps", "1")
    assert proc.returncode != 0 and "device='cpu'" in proc.stderr


def test_train_cli_refuses_recipe_modes_not_ported(tmp_path):
    """Every recipe mode is ported (auto, tp, sp, sp_ring); any other is refused
    before the process joins a world."""
    env = {"RANK": "0", "WORLD_SIZE": "2", "MASTER_ADDR": "localhost", "MASTER_PORT": "1"}
    proc = _run(*TRAIN, "--steps", "1", "--ckpt-dir", str(tmp_path), "--attn-mode", "ring",
                env_extra=env)
    assert proc.returncode != 0 and "invalid choice: 'ring'" in proc.stderr


def test_train_cli_trains_under_sp_ring_on_gloo_ranks(tmp_path):
    """Under ``torchrun`` the world is a (1, 2) mesh and the step runs under
    the sp_ring recipe: its loss is the single process's at every step."""
    ring = _run("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                *TRAIN[:2], *TRAIN[2:], "--steps", "2", "--attn-mode", "sp_ring",
                "--ckpt-dir", str(tmp_path / "ring"))
    assert ring.returncode == 0, ring.stderr[-3000:]
    assert "mesh={'data': 1, 'model': 2} attn_mode=sp (ring)" in ring.stdout
    one = _run(*TRAIN, "--steps", "2", "--ckpt-dir", str(tmp_path / "one"))
    losses = lambda out: [float(line.split("loss=")[1].split()[0])
                          for line in out.splitlines() if "loss=" in line]
    assert len(losses(ring.stdout)) == 2
    assert max(abs(a - b) for a, b in zip(losses(ring.stdout), losses(one.stdout))) < 1e-3
