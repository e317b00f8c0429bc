"""The port's MoE family against the reference's, on the CPU.

* ``moe_ffn`` in its dense, grouped and decode (dropless) modes, with drops
  (capacity factor 0.5) and with arctic's dense residual, against the
  reference's ``moe_ffn`` on the same numpy weights: float32 sums in other
  orders, ``rtol=atol=2e-5``;
* the expert-parallel host plan (``moe_ep_schedule``, ``moe_ep_counts``,
  ``moe_comm_model``) equal to the reference's, tables included;
* ``moe_expert_parallel`` on 4 gloo ranks of a (2, 2) mesh against the
  reference's dense oracle at dropless counts (the reference test's
  ``2e-5``), with experts that divide the model axis and with 5 that do not;
  with skewed counts tables (zero-count experts, a zero split extent)
  against the reference's own expert-parallel run on 4 fake devices, so
  both drop the same tokens (``2e-5``); the blocking run bitwise equal to
  the double-buffered one; bf16 rows on the wire (the layouts' bf16
  stand-in) within two bf16 ulps of the single-process dispatch in bf16;
* ``moe_ffn(dispatch="ep")`` on a rank's block: by EP where the grid
  divides, else with the fallback warning through the whole grid's
  dispatch, equal to the single-process result;
* the fallback warning without a recipe;
* the phi3.5-moe and arctic SMOKE ``lm.forward`` (single process, and under
  an ``sp_ring`` recipe on 4 gloo ranks, by EP and by the gathered
  dispatch) against the reference's single-device forward (``1e-4``, as
  the dense LM's tests), ``count_params``, one prefill chunk and decode
  step, and the engine's greedy tokens against the reference's engine.
"""
import dataclasses
import os
import pickle
import subprocess
import sys
import warnings

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from _torch_dist import TESTS, run_gloo
from repro import configs as jconfigs
from repro.models import ffn as jffn
from repro.models import lm as jlm
from repro.models.module import init_params as jinit
from repro.serve.engine import Engine as JEngine
from repro.serve.engine import ServeConfig as JServeConfig
from repro_torch import configs as tconfigs
from repro_torch.models import ffn as tffn
from repro_torch.models import lm as tlm
from repro_torch.models.weights import cast_params, params_from_jax
from repro_torch.serve.engine import Engine, ServeConfig

FFN_TOL = 2e-5
BF16_TOL = 2e-2  # two bf16 ulps at the outputs' unit scale
LM_TOL = 1e-4
M, F_, K = 64, 128, 2  # the SMOKE configs' d_model and d_ff; top-2
MOE_ARCHS = ["phi3.5-moe-42b-a6.6b", "arctic-480b"]


def _moe_params(E, *, residual=False, seed=0):
    return jax.tree.map(np.asarray, jinit(jffn.moe_specs(M, F_, E, dense_residual=residual),
                                          jax.random.PRNGKey(seed)))


def _x(shape, seed=1):
    return np.random.default_rng(seed).standard_normal(shape + (M,)).astype(np.float32)


FFN_CASES = {
    "dense": ((2, 16), {}),
    "grouped": ((4, 8), {"groups": 4}),
    "grouped_not_dividing": ((4, 8), {"groups": 3}),
    "decode": ((6, 1), {"groups": 2}),  # S == 1: dropless, groups ignored
    "drops": ((2, 16), {"capacity_factor": 0.5}),
    "grouped_drops": ((4, 8), {"groups": 2, "capacity_factor": 0.5}),
}


@pytest.mark.parametrize("residual", [False, True], ids=["phi", "arctic_residual"])
@pytest.mark.parametrize("case", list(FFN_CASES))
def test_moe_ffn_matches_reference(case, residual):
    shape, kw = FFN_CASES[case]
    np_p = _moe_params(4, residual=residual)
    x = _x(shape)
    want, want_aux = jffn.moe_ffn(jax.tree.map(jnp.asarray, np_p), jnp.asarray(x), n_experts=4,
                                  top_k=K, **kw)
    got, aux = tffn.moe_ffn(params_from_jax(np_p, device="cpu"), torch.from_numpy(x),
                            n_experts=4, top_k=K, **kw)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=FFN_TOL, atol=FFN_TOL)
    assert abs(float(aux) - float(want_aux)) < 1e-6


def test_topk_breaks_ties_to_the_lowest_index():
    probs = torch.tensor([[0.25, 0.25, 0.25, 0.25], [0.1, 0.4, 0.1, 0.4]])
    vals, idx = tffn._topk(probs, 2)
    assert idx.tolist() == [[0, 1], [1, 3]]
    jv, ji = jax.lax.top_k(jnp.asarray(probs.numpy()), 2)
    assert idx.tolist() == np.asarray(ji).tolist()
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jv))


SCHEDULES = [(4, 2, (5, 5, 5, 5), 2), (5, 2, (4, 0, 3, 2, 1), 2), (8, 4, (3,) * 8, 2),
             (7, 4, (0, 2, 0, 1, 6, 0, 3), 3), (3, 4, (2, 2, 2), 1), (4, 2, (0, 0, 0, 0), 2)]


@pytest.mark.parametrize("E,R,counts,n_groups", SCHEDULES)
def test_moe_ep_schedule_matches_reference(E, R, counts, n_groups):
    want = jffn.moe_ep_schedule(E, R, counts, n_groups)
    got = tffn.moe_ep_schedule(E, R, counts, n_groups)
    for field in ("E", "R", "cap_e", "e_exts", "counts", "Q"):
        assert getattr(got, field) == getattr(want, field), field
    np.testing.assert_array_equal(got.comb_base, want.comb_base)
    assert len(got.groups) == len(want.groups)
    for g, w in zip(got.groups, want.groups):
        for field in ("lo", "hi", "gsz", "gbase", "Sg", "se", "cap_s", "c_max"):
            assert getattr(g, field) == getattr(w, field), field
        np.testing.assert_array_equal(g.fwd, w.fwd)
        np.testing.assert_array_equal(g.inv, w.inv)
    assert tffn.moe_comm_model(got, d_model=M, itemsize=2, dense_capacity=9) == \
        jffn.moe_comm_model(want, d_model=M, itemsize=2, dense_capacity=9)
    assert tffn.moe_ep_counts(E, 8, 2, 1.25) == jffn.moe_ep_counts(E, 8, 2, 1.25)


def test_ep_fallback_warns_without_a_recipe():
    np_p = _moe_params(4)
    p, x = params_from_jax(np_p, device="cpu"), torch.from_numpy(_x((2, 8)))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        got, aux = tffn.moe_ffn(p, x, n_experts=4, top_k=K, dispatch="ep")
    assert any("falling back" in str(w.message) for w in caught)
    want, want_aux = tffn.moe_ffn(p, x, n_experts=4, top_k=K)
    assert torch.equal(got, want) and torch.equal(aux, want_aux)
    with pytest.raises(ValueError, match="unknown dispatch"):
        tffn.moe_ffn(p, x, n_experts=4, dispatch="ring")
    with pytest.raises(ValueError, match="no active sharding recipe"):
        tffn.moe_expert_parallel(p, x, n_experts=4)


# ------------------------------------------------ expert parallel (gloo) ----
EP_B, EP_S = 4, 8
TL = (EP_B // 2) * (EP_S // 2)  # tokens per shard of the (2, 2) mesh
EP_CASES = {
    "dropless": ("phi", (TL,) * 4),
    "skew": ("phi", (TL, 1, 0, 2)),
    "residual_dropless": ("arctic", (TL,) * 8),
    "ragged_experts": ("e5", (TL,) * 5),
    "ragged_skew": ("e5", (0, TL, 3, 0, 1)),  # group 2's split extents are (3, 0)
}
DROPLESS = ("dropless", "residual_dropless", "ragged_experts")

_REFERENCE_EP = """
import pickle, sys
import numpy as np, jax, jax.numpy as jnp
sys.path.insert(0, {tests!r})
from repro import configs
from repro.core.compat import make_mesh
from repro.models import ffn
from repro.models.sharding import make_recipe, use_recipe
with open({inp!r}, "rb") as f:
    params, x, cases = pickle.load(f)
cfg = configs.get("phi3.5-moe-42b-a6.6b", smoke=True)
recipe = make_recipe(cfg, make_mesh((2, 2), ("data", "model")))
out = {{}}
for name, (key, counts) in cases.items():
    p = jax.tree.map(jnp.asarray, params[key])
    E = p["router"].shape[-1]
    def run(xv):
        with use_recipe(recipe):
            return ffn.moe_expert_parallel(p, xv, n_experts=E, top_k=2, counts=counts,
                                           n_groups=2)
    y, aux = jax.jit(run)(jnp.asarray(x))
    out[name] = (np.asarray(y), float(aux))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


@pytest.fixture(scope="module")
def ep_inputs():
    params = {"phi": _moe_params(4), "arctic": _moe_params(8, residual=True, seed=2),
              "e5": _moe_params(5, seed=3)}
    return params, _x((EP_B, EP_S), seed=4)


@pytest.fixture(scope="module")
def ep_reference(distributed, tmp_path_factory, ep_inputs):
    d = tmp_path_factory.mktemp("jax_moe_ep")
    cases = {name: EP_CASES[name] for name in ("skew", "ragged_skew")}
    cases["ffn_ep"] = ("phi", None)  # moe_ffn's default counts
    with open(d / "inputs.pkl", "wb") as f:
        pickle.dump((*ep_inputs, cases), f)
    code = _REFERENCE_EP.format(tests=TESTS, inp=str(d / "inputs.pkl"), path=str(d / "out.pkl"))
    assert "OK" in distributed(code, devices=4)
    with open(d / "out.pkl", "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


@pytest.fixture(scope="module")
def ep_port(tmp_path_factory, ep_inputs):
    params, x = ep_inputs
    return run_gloo("moe_ep_family", 4, tmp_path_factory.mktemp("gloo_moe_ep"), params=params,
                    x=x, cases=EP_CASES, bf16_cases=("dropless",))


def _block(y, rank, S=EP_S):
    d, r = divmod(rank, 2)
    bd, sr = EP_B // 2, S // 2
    return y[d * bd:(d + 1) * bd, r * sr:(r + 1) * sr]


@pytest.mark.parametrize("case", DROPLESS)
def test_expert_parallel_matches_dense_oracle_dropless(ep_inputs, ep_port, case):
    params, x = ep_inputs
    p = jax.tree.map(jnp.asarray, params[EP_CASES[case][0]])
    E = p["router"].shape[-1]
    want, want_aux = jffn.moe_ffn(p, jnp.asarray(x), n_experts=E, top_k=K,
                                  capacity_factor=E / K)
    for rank in range(4):
        y, aux = ep_port[rank][case]
        np.testing.assert_allclose(y, _block(np.asarray(want), rank), rtol=FFN_TOL, atol=FFN_TOL)
        assert abs(float(aux) - float(want_aux)) < 1e-6


@pytest.mark.parametrize("case", ["skew", "ragged_skew", "ffn_ep"])
def test_expert_parallel_matches_reference_expert_parallel(ep_reference, ep_port, case):
    want, want_aux = ep_reference[case]
    for rank in range(4):
        y, aux = ep_port[rank][case]
        np.testing.assert_allclose(y, _block(want, rank), rtol=FFN_TOL, atol=FFN_TOL)
        assert abs(float(aux) - want_aux) < 1e-6
    assert all(ep_port[rank][("ffn_ep", "warnings")] == 0 for rank in range(4))


def test_expert_parallel_bf16_matches_single_process(ep_inputs, ep_port):
    """bf16 weights and rows, dropless: the all-to-alls move bf16 and the
    experts run in bf16, against the port's own single-process dispatch in
    bf16."""
    params, x = ep_inputs
    p = cast_params(params_from_jax(params["phi"], device="cpu"), torch.bfloat16)
    want, _ = tffn.moe_ffn(p, torch.from_numpy(x).bfloat16(), n_experts=4, top_k=K,
                           capacity_factor=4 / K)
    for rank in range(4):
        np.testing.assert_allclose(ep_port[rank][("dropless", "bf16")],
                                   _block(want.float().numpy(), rank),
                                   rtol=BF16_TOL, atol=BF16_TOL)


@pytest.mark.parametrize("case", list(EP_CASES))
def test_expert_parallel_blocking_is_bitwise_double_buffered(ep_port, case):
    assert all(ep_port[rank][(case, "blocking_equal")] for rank in range(4))


def test_ineligible_grid_falls_back_to_the_whole_grid(ep_inputs, ep_port):
    """S = 7 does not divide the model axis: every rank warns, gathers the
    grid and computes the single process's dispatch (drops included)."""
    params, x = ep_inputs
    p = jax.tree.map(jnp.asarray, params["phi"])
    want, want_aux = jffn.moe_ffn(p, jnp.asarray(x[:, :7]), n_experts=4, top_k=K)
    want = np.pad(np.asarray(want), ((0, 0), (0, 1), (0, 0)))  # the ring pads 7 to 2 x 4
    for rank in range(4):
        y, aux = ep_port[rank]["ffn_ragged"]
        assert ep_port[rank][("ffn_ragged", "warnings")] == 1
        np.testing.assert_allclose(y, _block(want, rank), rtol=FFN_TOL, atol=FFN_TOL)
        assert abs(float(aux) - float(want_aux)) < 1e-6


# ------------------------------------------------------------ the LM ----
def _lm_models(arch, **overrides):
    jcfg = dataclasses.replace(jconfigs.get(arch, smoke=True), act_dtype=jnp.float32,
                               attn_impl="interpret", **overrides)
    tcfg = dataclasses.replace(tconfigs.get(arch, smoke=True), act_dtype=torch.float32,
                               **overrides)
    jp = jlm.init_model(jcfg, jax.random.PRNGKey(0))
    return jcfg, jp, tcfg, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(cfg, shape, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, size=shape).astype(np.int32)


def test_configs_resolve():
    for arch in MOE_ARCHS:
        for smoke in (False, True):
            t, j = tconfigs.get(arch, smoke=smoke), jconfigs.get(arch, smoke=smoke)
            for field in dataclasses.fields(t):
                if field.name not in ("param_dtype", "act_dtype"):
                    assert getattr(t, field.name) == getattr(j, field.name), (arch, field.name)


def test_count_params_matches_reference():
    for arch in MOE_ARCHS:
        for smoke in (True, False):
            for active in (False, True):
                assert tlm.count_params(tconfigs.get(arch, smoke=smoke), active_only=active) \
                    == jlm.count_params(jconfigs.get(arch, smoke=smoke), active_only=active)


def test_params_from_jax_carries_the_moe_trees():
    jcfg, jp, tcfg, tp = _lm_models("arctic-480b")
    ffn = tp["blocks"]["ffn"]
    assert sorted(ffn) == ["residual", "router", "w_down", "w_gate", "w_up"]
    for name in ("router", "w_gate", "w_up", "w_down"):
        np.testing.assert_array_equal(ffn[name].numpy(), np.asarray(jp["blocks"]["ffn"][name]))
    assert ffn["w_gate"].shape == (2, 8, 64, 128)
    cast = cast_params(tp, torch.bfloat16)
    assert cast["blocks"]["ffn"]["residual"]["w_up"].dtype == torch.bfloat16
    assert torch.equal(cast["blocks"]["ffn"]["w_down"], ffn["w_down"].to(torch.bfloat16))


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_forward_logits_match_reference(arch):
    jcfg, jp, tcfg, tp = _lm_models(arch)
    toks = _tokens(jcfg, (2, 24))
    want, want_aux = jlm.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
    got, aux = tlm.forward(tp, {"tokens": torch.from_numpy(toks).long()}, tcfg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=LM_TOL, atol=LM_TOL)
    assert abs(float(aux) - float(want_aux)) < 1e-6 and float(aux) > 0


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_decode_step_matches_reference(arch):
    """A whole-prompt chunk (capacity dispatch over every row, the idle
    middle row too) and one decode step (dropless)."""
    jcfg, jp, tcfg, tp = _lm_models(arch)
    B, T = 3, 32
    jstate = jlm.DecodeState(jlm.init_cache(jcfg, B, T), jnp.zeros((B,), jnp.int32))
    tstate = tlm.DecodeState(tlm.init_cache(tcfg, B, T, device="cpu"),
                             torch.zeros((B,), dtype=torch.int32))
    for toks, counts, prefill in [(_tokens(jcfg, (B, 8), 1), np.array([5, 0, 8], np.int32), True),
                                  (_tokens(jcfg, (B, 1), 2), np.array([1, 1, 0], np.int32), False)]:
        jlogits, jstate = jlm.decode_step(jp, jstate, {"tokens": jnp.asarray(toks)}, jcfg,
                                          new_counts=jnp.asarray(counts), prefill=prefill)
        tlogits, tstate = tlm.decode_step(tp, tstate, {"tokens": torch.from_numpy(toks).long()},
                                          tcfg, new_counts=torch.from_numpy(counts),
                                          prefill=prefill)
        np.testing.assert_allclose(tlogits.numpy(), np.asarray(jlogits), rtol=LM_TOL, atol=LM_TOL)
        np.testing.assert_array_equal(tstate.positions.numpy(), np.asarray(jstate.positions))


RING_MODELS = {  # name: (arch, config overrides); "ep" ones are dropless (capacity E/k)
    "phi_ep": ("phi3.5-moe-42b-a6.6b", {"moe_dispatch": "ep", "moe_capacity_factor": 2.0}),
    "phi_auto": ("phi3.5-moe-42b-a6.6b", {}),
    "arctic_ep": ("arctic-480b", {"moe_dispatch": "ep", "moe_capacity_factor": 4.0}),
}
RING_S = (8, 10)  # 10 does not divide a model axis of 4: the EP configs fall back there


@pytest.fixture(scope="module")
def ring_models():
    return {name: _lm_models(arch, **ov) for name, (arch, ov) in RING_MODELS.items()}


@pytest.fixture(scope="module")
def ring_tokens():
    return {S: _tokens(jconfigs.get("phi3.5-moe-42b-a6.6b", smoke=True), (2, S), seed=S)
            for S in RING_S}


@pytest.fixture(scope="module")
def ring_runs(tmp_path_factory, ring_models, ring_tokens):
    models = {name: (RING_MODELS[name][0], RING_MODELS[name][1],
                     jax.tree.map(np.asarray, m[1])) for name, m in ring_models.items()}
    return run_gloo("moe_sp_ring_family", 4, tmp_path_factory.mktemp("gloo_moe_ring"),
                    models=models, tokens=ring_tokens)


@pytest.mark.parametrize("S", RING_S)
@pytest.mark.parametrize("shape", [(2, 2), (1, 4)], ids=["2x2", "1x4"])
@pytest.mark.parametrize("name", list(RING_MODELS))
def test_sp_ring_forward_matches_single_device_reference(ring_models, ring_tokens, ring_runs,
                                                         name, shape, S):
    jcfg, jp, _, _ = ring_models[name]
    want, want_aux = jlm.forward(jp, {"tokens": jnp.asarray(ring_tokens[S])}, jcfg)
    fallback = jcfg.moe_dispatch == "ep" and S % shape[1] != 0
    for rank in range(4):
        logits, aux, warned = ring_runs[rank][(name, shape, S)]
        np.testing.assert_allclose(logits, np.asarray(want), rtol=LM_TOL, atol=LM_TOL)
        assert abs(float(aux) - float(want_aux)) < 1e-6
        assert warned == (jcfg.n_layers if fallback else 0)


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_greedy_tokens_match_reference_engine(arch):
    """More requests than slots; the MoE family prefills token by token."""
    jcfg, jp, tcfg, tp = _lm_models(arch)
    jeng = JEngine(jcfg, jp, JServeConfig(max_len=64, batch_slots=2, eos_token=-1))
    teng = Engine(tcfg, tp, ServeConfig(max_len=64, batch_slots=2, eos_token=-1))
    rng = np.random.default_rng(0)
    for rid in range(4):
        prompt = rng.integers(2, 500, size=int(rng.integers(1, 12))).tolist()
        max_new = int(rng.integers(3, 8))
        jeng.submit(rid, prompt, max_new)
        teng.submit(rid, prompt, max_new)
    want = jeng.run()
    got = teng.run()
    assert sorted(got) == list(range(4)) and got == want
    # one prefill step per token of the longest admitted feed
    assert teng.steps["prefill"] >= 10
    assert teng.ledger.lengths == [0, 0]


def test_engine_refuses_tensor_parallel_moe():
    cfg = tconfigs.get("phi3.5-moe-42b-a6.6b", smoke=True)
    params = tlm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(ValueError, match="MoE"):
        Engine(cfg, params, ServeConfig(), mesh=object(), microbatches=2)


def test_serve_cli_serves_moe_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=os.path.join(TESTS, "..", "src"), CUDA_VISIBLE_DEVICES="")
    proc = subprocess.run([sys.executable, "-m", "repro_torch.launch.serve", "--arch",
                           "phi3.5-moe-42b-a6.6b", "--smoke", "--device", "cpu", "--requests", "3",
                           "--slots", "2", "--max-new", "4"],
                          capture_output=True, text=True, timeout=240, env=env)
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert "[serve] 3 done / 0 in flight, 12 tokens requested" in proc.stdout
