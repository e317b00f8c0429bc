"""Remat under a sharding recipe repeats the forward's ops, its gathers
included: on 4 gloo CPU ranks of a ``(2, 2)`` ``(data, model)`` mesh, the
loss and every gradient of the training step (``trainer._accum_loss_grads``
on each rank's shards) with ``cfg.remat == "block"`` equal the same program
with ``remat == "none"``, bitwise.

Each block gathers its layer's weights inside its checkpoint, so the
backward's recompute gathers them again; the hybrid's Mamba2 blocks and the
VLM's self blocks gather inside their own checkpoints, nested in their
group's, and the hybrid's shared block is gathered inside each group
(under ``sp_ring`` each gathered whole).  The cases: phi4-mini (3 layers),
zamba2 (13 layers: 2 groups of 5 Mamba2 blocks and the shared block, then
a tail block) and llama-3.2-vision (10 layers: 2 groups of 4 self blocks
and a cross block), each under ``tp``, ``sp`` and ``sp_ring``; float32 SMOKE configs, seeded weights with their
constant leaves spread and the VLM's gates opened, 4 rows of 30 tokens
(ragged chunks over ``model``; zamba2 32, two of its scan chunks), one
job.  The same program either way: every leaf, the hybrid's shared block
and the embedding included, is held bitwise, and every gradient leaf is
nonzero.
"""
import numpy as np
import pytest

from _torch_dist import run_gloo

CASES = [(arch, mode, layers)
         for arch, layers in (("phi4-mini-3.8b", 3), ("zamba2-7b", 13),
                              ("llama-3.2-vision-11b", 10))
         for mode in ("tp", "sp", "sp_ring")]
SEQ = {"phi4-mini-3.8b": 30, "zamba2-7b": 32, "llama-3.2-vision-11b": 30}


def _batches():
    rng = np.random.default_rng(31)
    out = {}
    for arch, seq in SEQ.items():
        toks = rng.integers(0, 512, (4, seq + 1)).astype(np.int32)
        out[arch] = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    # the VLM's images: the SMOKE config's 16 positions of 64 features a row
    out["llama-3.2-vision-11b"]["image_embeds"] = rng.standard_normal(
        (4, 16, 64)).astype(np.float32)
    return out


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    return run_gloo("_torch_recipe:remat_against_none", 4,
                    tmp_path_factory.mktemp("gloo_recipe_remat"), timeout=400, shape=(2, 2),
                    cases=CASES, batches=_batches())


@pytest.mark.parametrize("arch,mode,layers", CASES, ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_loss_with_remat_equals_without_bitwise(ranks, arch, mode, layers):
    for rank, got in enumerate(ranks):
        res = got[(arch, mode)]
        assert res["loss_equal"], (rank, res["losses"])


@pytest.mark.parametrize("arch,mode,layers", CASES, ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_gradients_with_remat_equal_without_bitwise(ranks, arch, mode, layers):
    for rank, got in enumerate(ranks):
        res = got[(arch, mode)]
        assert not res["unequal"], (rank, res["unequal"])
        assert res["nonzero"] == res["leaves"], (rank, res["nonzero"], res["leaves"])
