"""The port's tensor-parallel serving against the reference, on gloo CPU ranks.

The scenarios of the reference's own distributed-engine tests
(``tests/test_engine.py``: 10 requests on phi4-mini SMOKE, 6 on qwen2.5
SMOKE with random QKV biases; 8 slots, max_len 64, ``microbatches=2``) run
through the port's ``Engine(mesh=..., microbatches=2)`` on a (2, 2) and a
(1, 2) ``(data, model)`` gloo mesh at float32.  Their sharded program cannot
run on this jax, so the oracle is the reference's single-host engine, run
here with its attention kernels in interpret mode: greedy tokens must be
equal, request for request.  On the same meshes one TP step blocking
equals the double-buffered step bitwise (logits and caches), every
rank's weight cut, gathered back over the mesh, equals the whole tree
bitwise, and the outputs stay the reference's when every cache block other
than the rank's own is overwritten with garbage at each decode step.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import TP_MAX_LEN, TP_REQUESTS, TP_SLOTS, run_gloo
from repro import configs as jconfigs
from repro.models import lm as jlm
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro.serve.tp_decode import tp_decode_specs as jtp_decode_specs
from repro_torch import configs as tconfigs
from repro_torch.core.dist import Mesh
from repro_torch.models import lm
from repro_torch.models.weights import shard_params
from repro_torch.serve.tp_decode import _check, tp_decode_specs

ARCHS = ["phi4-mini-3.8b", "qwen2.5-32b"]
MESHES = [(2, 2), (1, 2)]


def _jax_params(arch):
    cfg = dataclasses.replace(jconfigs.get(arch, smoke=True), act_dtype=jnp.float32,
                              attn_impl="interpret")
    params = jlm.init_model(cfg, jax.random.PRNGKey(0))
    if cfg.qkv_bias:  # zero biases would make their threading vacuous
        rng = np.random.default_rng(1)
        for name in ("bq", "bk", "bv"):
            shape = params["blocks"]["attn"][name].shape
            params["blocks"]["attn"][name] = jnp.asarray(
                0.5 * rng.standard_normal(shape).astype(np.float32))
    return cfg, params


@pytest.fixture(scope="module")
def models():
    return {arch: _jax_params(arch) for arch in ARCHS}


@pytest.fixture(scope="module")
def reference(models):
    """The reference's single-host engine's greedy outputs."""
    out = {}
    for arch, (cfg, params) in models.items():
        engine = JEngine(cfg, params, JServeConfig(max_len=TP_MAX_LEN, batch_slots=TP_SLOTS,
                                                   eos_token=-1))
        for rid, prompt, n in TP_REQUESTS[arch]:
            engine.submit(rid, prompt, max_new_tokens=n)
        out[arch] = engine.run()
    return out


@pytest.fixture(scope="module")
def port(models, tmp_path_factory):
    """Per mesh, every rank's results (one spawn of D*M gloo ranks each)."""
    trees = {arch: jax.tree.map(np.asarray, params) for arch, (_, params) in models.items()}
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("tp_decode_family", shape[0] * shape[1],
                                    tmp_path_factory.mktemp(f"tp_{shape[0]}x{shape[1]}"),
                                    shape=shape, models=trees)
        return cache[shape]

    return get


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_matches_reference_single_host_engine(reference, port, arch, shape):
    want = reference[arch]
    assert sorted(want) == list(range(len(TP_REQUESTS[arch])))
    for rank, result in enumerate(port(shape)):
        got = result[(arch, "tokens")]
        assert sorted(got) == sorted(want), rank
        for rid in want:
            assert got[rid] == want[rid], (rank, rid, got[rid], want[rid])


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_engine_never_reads_other_ranks_cache_blocks(reference, port, arch, shape):
    """Every rank holds the whole cache allocation but a TP step touches
    only its own (rows, KV groups) block: with every other block
    overwritten with a large value before each decode step, the greedy
    outputs are still the reference's (the admission prefill, on the whole
    weights, reads only what it writes; phi4-mini's 10 requests on 8 slots
    admit two of them after such steps)."""
    for rank, result in enumerate(port(shape)):
        assert result[(arch, "tokens_poisoned")] == reference[arch], rank


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_tp_step_blocking_equals_double_buffered(port, arch, shape):
    for rank, result in enumerate(port(shape)):
        assert result[(arch, "db_vs_blocking")] == [], rank


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("arch", ARCHS)
def test_weight_shard_gathers_back_to_whole_tree(port, arch, shape):
    for rank, result in enumerate(port(shape)):
        assert result[(arch, "shard_differs")] == [], rank


@pytest.mark.parametrize("arch", ARCHS)
def test_tp_decode_specs_match_reference(arch):
    """The spec trees, entry for entry, against the reference's
    ``PartitionSpec`` trees (params, cache k/v, cache length)."""
    tcfg, jcfg = tconfigs.get(arch, smoke=True), jconfigs.get(arch, smoke=True)
    jp, jkv, jlen = jtp_decode_specs(jcfg)
    tp, tkv, tlen = tp_decode_specs(tcfg)
    as_tuples = jax.tree.map(tuple, jp, is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))
    assert tp == as_tuples
    assert (tkv, tlen) == (tuple(jkv), tuple(jlen))


def test_check_refuses_a_model_axis_that_does_not_divide_n_kv():
    cfg = tconfigs.get("phi4-mini-3.8b", smoke=True)  # 4 heads, 2 KV groups
    with pytest.raises(ValueError, match="n_kv=2 must divide model axis 4"):
        _check(cfg, Mesh({"data": 1, "model": 4}, 0, torch.device("cpu")), 8, 2)
    with pytest.raises(ValueError, match="slots must split"):
        _check(cfg, Mesh({"data": 2, "model": 2}, 0, torch.device("cpu")), 6, 2)
    _check(cfg, Mesh({"data": 2, "model": 2}, 0, torch.device("cpu")), 8, 2)


def test_shard_is_a_view_when_the_model_axis_has_one_rank():
    """On one card (a (1, 1) mesh) the rank's shard shares the whole
    tree's storage: no weight is copied."""
    cfg = tconfigs.get("qwen2.5-32b", smoke=True)
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    shard = shard_params(params, tp_decode_specs(cfg)[0],
                         Mesh({"data": 1, "model": 1}, 0, torch.device("cpu")))

    def same(w, s):
        if isinstance(w, dict):
            return all(same(w[k], s[k]) for k in w)
        return s.data_ptr() == w.data_ptr() and s.shape == w.shape

    assert same(params, shard)
