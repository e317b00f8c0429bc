"""The explicit ZeRO-2 step takes the VLM's and the audio family's
batches: ``make_zero_train_step`` on a one-axis ``data`` mesh of 2 gloo
ranks, one step from the reference's SMOKE parameters (float32; constant
leaves perturbed and the VLM's gates opened, ``tests/_torch_families.py``)
on a pipeline batch of 4 x 24 (``tokens+image``: tokens, labels and a
float32 image; ``embeds``: float32 frames and labels), each rank taking its
rows, against the reference's single-device step on the global batch (its
sharded step cannot run on this jax).  AdamW at ``lr=1e-3``, no warmup.
Tolerances: the loss ``rtol=1e-5`` and the gradient norm ``1e-4`` (the
ranks' partial gradients are summed in another order than one device's);
the stepped parameters ``rtol=atol=2e-4``, the same on both ranks.
"""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import run_gloo
from _torch_families import models as family_models
from repro.configs.base import ShapeCell
from repro.data import pipeline as jpipe
from repro.models import lm as jlm
from repro.train import optimizer as jopt
from repro.train import trainer as jtr

ARCHS = ["llama-3.2-vision-11b", "musicgen-large"]
OCFG = dict(lr=1e-3, warmup_steps=0)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    trees, batches, want = {}, {}, {}
    for arch in ARCHS:
        jcfg, jp, _, _ = family_models(arch, attn_impl=None)
        batch = jpipe.make_batch(jcfg, ShapeCell("t", 24, 4, "train"), 1)
        ocfg = jopt.OptConfig(**OCFG)
        new_p, _, m = jax.jit(jtr.make_train_step(jcfg, None, ocfg))(
            jp, jopt.init_opt_state(jp, ocfg), {k: jnp.asarray(v) for k, v in batch.items()})
        trees[arch], batches[arch] = jax.tree.map(np.asarray, jp), batch
        want[arch] = dict(loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                          params=[np.asarray(t) for t in jax.tree.leaves(new_p)])
    got = run_gloo("zero_step_families", 2, tmp_path_factory.mktemp("gloo_family_zero"),
                   models=trees, batches=batches, ocfg=OCFG)
    return want, got


@pytest.mark.parametrize("arch", ARCHS)
def test_zero_step_matches_reference_single_device_step(runs, arch):
    want, ranks = runs
    for rank, got in enumerate(ranks):
        np.testing.assert_allclose(got[arch]["loss"], want[arch]["loss"], rtol=1e-5)
        np.testing.assert_allclose(got[arch]["grad_norm"], want[arch]["grad_norm"], rtol=1e-4)
        for i, (p, w) in enumerate(zip(got[arch]["params"], want[arch]["params"], strict=True)):
            np.testing.assert_allclose(p, w, rtol=2e-4, atol=2e-4,
                                       err_msg=f"{arch} rank {rank} leaf {i}")
            np.testing.assert_array_equal(p, ranks[0][arch]["params"][i])
