"""Training under a sharding recipe on gloo CPU ranks: ``make_train_step``
under ``tp`` and plain ``sp`` on shards, the launcher's ``--attn-mode
auto`` across processes, and a checkpoint saved under one mesh restored
under another world size.

* ``make_train_step`` on the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` meshes
  (FSDP over ``data``, the batch of 8 split there; heads, KV groups, FFN
  columns and vocab over ``model``; 2 KV groups left whole on ``(1, 4)``),
  every rank updating its shards, against the reference's single-device
  step (phi4-mini SMOKE, float32, 8 x 64 tokens, ``lr=1e-3`` with no
  warmup), to the reference's own tolerances for its sharded step
  (``tests/test_sharding.py:136-178``): loss ``1e-4``, every parameter
  ``rtol=atol=2e-4``; and the gradients (gathered) to ``rtol=1e-4,
  atol=1e-6``, the gradient norm to ``rtol=1e-5``; int8 compression of a
  cut gradient leaf (its scale from the largest magnitude over the shards)
  equals the whole leaf's compression, cut, bitwise.
* ``torchrun --nproc-per-node 2 -m repro_torch.launch.train --attn-mode
  auto``: a ``(1, 2)`` mesh under ``tp`` (4 heads divide 2), whose losses
  are the single process's.
* The reference's elastic reshard (``tests/test_checkpoint.py:76``, marked
  ``slow`` there): parameters saved from their shards on 4 ranks of a
  ``(2, 2)`` mesh, restored on 2 ranks of a ``(1, 2)`` mesh, equal the
  whole parameters bitwise, and each rank's restored shard is its cut.
"""
import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from _torch_recipe import RECIPE_MESHES, RECIPE_MODES
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtr

OCFG = dict(lr=1e-3, warmup_steps=0)
ROOT = os.path.abspath(os.path.join(os.path.dirname(__file__), ".."))


@pytest.fixture(scope="module")
def reference():
    cfg = dataclasses.replace(jconfigs.get("phi4-mini-3.8b", smoke=True), act_dtype=jnp.float32)
    params = jlm.init_model(cfg, jax.random.PRNGKey(0))
    ocfg = jopt.OptConfig(**OCFG)
    toks = np.random.default_rng(4).integers(0, cfg.vocab, (8, 65)).astype(np.int32)
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, _), grads = jax.value_and_grad(jlm.loss_fn, has_aux=True)(params, jb, cfg)
    new_p, _, m = jax.jit(jtr.make_train_step(cfg, None, ocfg))(
        params, jopt.init_opt_state(params, ocfg), jb)
    return dict(params=jax.tree.map(np.asarray, params), batch=batch, loss=float(loss),
                grads=[np.asarray(g) for g in jax.tree.leaves(grads)],
                new_params=[np.asarray(p) for p in jax.tree.leaves(new_p)],
                metrics={k: float(v) for k, v in m.items()})


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:train_family", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_train"), shape=shape,
                                    params=reference["params"], batch=reference["batch"],
                                    ocfg=OCFG, modes=RECIPE_MODES)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", RECIPE_MODES)
def test_train_step_under_recipe_matches_single_device_reference(reference, port, shape, mode):
    ranks = port(shape)
    for rank, got in enumerate(ranks):
        assert abs(got[(mode, "loss")] - reference["loss"]) < 1e-4
        assert abs(got[(mode, "metrics")]["loss"] - reference["metrics"]["loss"]) < 1e-4
        np.testing.assert_allclose(got[(mode, "metrics")]["grad_norm"],
                                   reference["metrics"]["grad_norm"], rtol=1e-5)
        assert got[(mode, "int8_cut")]
        for i, (g, w) in enumerate(zip(got[(mode, "grads")], reference["grads"])):
            np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6,
                                       err_msg=f"{shape} {mode} rank {rank} grad leaf {i}")
        for i, (p, w) in enumerate(zip(got[(mode, "params")], reference["new_params"])):
            np.testing.assert_allclose(p, w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{shape} {mode} rank {rank} param leaf {i}")
            np.testing.assert_array_equal(p, ranks[0][(mode, "params")][i])


def _run(*args, timeout=300):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"), CUDA_VISIBLE_DEVICES="",
               OMP_NUM_THREADS="1")
    return subprocess.run([sys.executable, *args], capture_output=True, text=True,
                          timeout=timeout, env=env, cwd=ROOT)


def test_train_cli_auto_mode_on_two_gloo_ranks(tmp_path):
    train = ["-m", "repro_torch.launch.train", "--arch", "phi4-mini-3.8b", "--smoke",
             "--device", "cpu", "--seq-len", "16", "--global-batch", "4", "--log-every", "1",
             "--steps", "2"]
    ranks = _run("-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
                 *train, "--attn-mode", "auto", "--ckpt-dir", str(tmp_path / "tp"))
    assert ranks.returncode == 0, ranks.stderr[-3000:]
    assert "mesh={'data': 1, 'model': 2} attn_mode=tp" in ranks.stdout
    assert "final ckpt at 2" in ranks.stdout
    one = _run(*train, "--ckpt-dir", str(tmp_path / "one"))
    losses = lambda out: [float(line.split("loss=")[1].split()[0])
                          for line in out.splitlines() if "loss=" in line]
    assert len(losses(ranks.stdout)) == 2
    assert max(abs(a - b) for a, b in zip(losses(ranks.stdout), losses(one.stdout))) < 1e-3


def test_checkpoint_saved_on_four_ranks_restores_on_two_bitwise(reference, tmp_path):
    directory = str(tmp_path / "ckpt")
    saved = run_gloo("_torch_recipe:ckpt_family", 4, tmp_path / "save", shape=(2, 2),
                     params=reference["params"], directory=directory, save=True)
    assert all(r["cut"] for r in saved)
    restored = run_gloo("_torch_recipe:ckpt_family", 2, tmp_path / "restore", shape=(1, 2),
                        params=reference["params"], directory=directory, save=False)
    want = jax.tree.leaves(reference["params"])
    for r in restored:
        assert r["extra"] == {"note": "elastic"}
        assert r["shards_equal"]
        assert len(r["whole"]) == len(want)
        for a, b in zip(r["whole"], want):
            np.testing.assert_array_equal(a, b)
