"""The audio family's tensor-parallel serving on gloo CPU ranks: musicgen
SMOKE (MHA, the GELU MLP, ``embeds`` input) through ``Engine(mesh=...,
microbatches=2)`` on a (2, 2) and a (1, 2) ``(data, model)`` gloo mesh at
float32, against the reference's single-host engine (its own TP step is a
``shard_map`` program that cannot run on this jax), its attention kernels
in interpret mode.

The weights are the reference's seeded ones with every constant leaf
perturbed (``tests/_torch_families.py``), so that the GELU's biases are
not zero: ``b_in`` rides the rank's ``d_ff`` columns, and ``b_out`` is
added once, after the float32 sum is reduced and rounded (added on every
rank before it, the sum would count it M times).  The requests are token
ids the engine featurizes; each decode step embeds the rank's rows as
``frames + sinusoidal(positions)`` in the activation dtype.  Greedy tokens
must equal the reference's, request for request, also with every other
rank's cache block overwritten before each decode step; one TP step
blocking equals the double-buffered one bitwise; the weight cut gathered
back is the whole tree; the spec trees are the reference's.
"""
import dataclasses

import numpy as np
import pytest

import jax
import jax.numpy as jnp

from _torch_dist import TP_MAX_LEN, TP_REQUESTS, TP_SLOTS, run_gloo
from _torch_families import perturb
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.tp_decode import tp_decode_specs as jtp_decode_specs
from repro_torch import configs as tconfigs
from repro_torch.serve.tp_decode import tp_decode_specs

ARCH = "musicgen-large"
MESHES = [(2, 2), (1, 2)]


@pytest.fixture(scope="module")
def model():
    cfg = dataclasses.replace(jconfigs.get(ARCH, smoke=True), act_dtype=jnp.float32,
                              attn_impl="interpret")
    return cfg, perturb(jlm.init_model(cfg, jax.random.PRNGKey(0)))


@pytest.fixture(scope="module")
def reference(model):
    cfg, params = model
    engine = JEngine(cfg, params, JServeConfig(max_len=TP_MAX_LEN, batch_slots=TP_SLOTS,
                                               eos_token=-1))
    for rid, prompt, n in TP_REQUESTS[ARCH]:
        engine.submit(rid, prompt, max_new_tokens=n)
    return engine.run()


@pytest.fixture(scope="module")
def port(model, tmp_path_factory):
    tree = {ARCH: jax.tree.map(np.asarray, model[1])}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("tp_decode_family", shape[0] * shape[1],
                                    tmp_path_factory.mktemp(f"audio_tp_{shape[0]}x{shape[1]}"),
                                    shape=shape, models=tree)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_engine_matches_reference_single_host_engine(reference, port, shape):
    assert sorted(reference) == list(range(len(TP_REQUESTS[ARCH])))
    for rank, result in enumerate(port(shape)):
        got = result[(ARCH, "tokens")]
        assert sorted(got) == sorted(reference), rank
        for rid in reference:
            assert got[rid] == reference[rid], (rank, rid, got[rid], reference[rid])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_engine_never_reads_other_ranks_cache_blocks(reference, port, shape):
    for rank, result in enumerate(port(shape)):
        assert result[(ARCH, "tokens_poisoned")] == reference, rank


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_tp_step_blocking_equals_double_buffered(port, shape):
    for rank, result in enumerate(port(shape)):
        assert result[(ARCH, "db_vs_blocking")] == [], rank
        assert result[(ARCH, "shard_differs")] == [], rank


def test_tp_decode_specs_match_reference():
    """No ``embed`` spec (frames come in), ``w_in``/``b_in`` cut by
    ``model``, ``b_out`` whole; entry for entry the reference's."""
    tcfg, jcfg = tconfigs.get(ARCH, smoke=True), jconfigs.get(ARCH, smoke=True)
    jp, jkv, jlen = jtp_decode_specs(jcfg)
    tp, tkv, tlen = tp_decode_specs(tcfg)
    as_tuples = jax.tree.map(tuple, jp, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert tp == as_tuples and "embed" not in tp
    assert tp["blocks"]["ffn"]["b_out"] == (None, None)
    assert (tkv, tlen) == (tuple(jkv), tuple(jlen))
