"""Training the MoE family (phi3.5-moe) under a sharding recipe on gloo CPU
ranks: ``make_train_step`` under ``tp``, plain ``sp`` and ``sp_ring`` on
the ``(2, 2)``, ``(1, 4)`` and ``(4, 1)`` ``(data, model)`` meshes, every
rank updating its shards, against the reference's single-device step
(float32 SMOKE config, perturbed seeded weights, 4 x 32 tokens, AdamW at
``lr=1e-3``), with the tolerances of
``tests/test_torch_recipe_mla_train.py``.

* ``moe``: the capacity dispatch over all tokens, drops included: the rows
  gathered over the batch axes, the experts cut over ``model`` with a
  float32 partial of the combine summed there.  The aux loss comes from
  each rank's own tokens' statistics summed over the token ranks, so each
  rank's gradient of it is its share.
* ``grouped``: 2 groups, a rank's rows used as they are where they are a
  whole group.
* ``ep``: ``moe_dispatch="ep"`` at a capacity factor that drops nothing
  (E / k), so the reference's single-device dense step is its oracle: the
  expert-parallel exchange's legs differentiate through each other (the
  dispatch's backward is the combine leg, and the combine's the dispatch),
  on ``(2, 2)`` and ``(1, 4)`` under every mode; ``(4, 1)`` falls back.
"""
import pytest

from _torch_dist import run_gloo
from _torch_recipe import LATENT_MOE_MODES, RECIPE_MESHES
from test_torch_recipe_mla_train import OCFG, check_step, reference_steps

MODELS = {
    "moe": ({}, {}),
    "grouped": (dict(moe_groups=2), {}),
    "ep": (dict(moe_dispatch="ep", moe_capacity_factor=2.0), dict(moe_dispatch="auto")),
}


@pytest.fixture(scope="module")
def reference():
    return reference_steps("phi3.5-moe-42b-a6.6b", MODELS, 110)


@pytest.fixture(scope="module")
def port(reference, tmp_path_factory):
    cache = {}

    def get(shape):
        if shape not in cache:
            cache[shape] = run_gloo("_torch_recipe:train_named", 4,
                                    tmp_path_factory.mktemp("gloo_recipe_moe_train"),
                                    timeout=400, shape=shape, models=reference["trees"],
                                    batch=reference["batch"], ocfg=OCFG)
        return cache[shape]

    return get


@pytest.mark.parametrize("name", list(MODELS))
@pytest.mark.parametrize("shape", RECIPE_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("mode", LATENT_MOE_MODES)
def test_train_step_under_recipe_matches_single_device_reference(reference, port, name, shape,
                                                                 mode):
    check_step(reference[name], port(shape), name, shape, mode)


def test_expert_parallel_gradients_match_dense_oracle_and_blocking(tmp_path):
    """``moe_expert_parallel``'s gradients on a ``(2, 2)`` mesh (4 experts,
    2 per rank, 2 plan steps, a capacity that drops nothing) against
    ``jax.vjp`` of the reference's dense ``moe_ffn``: each rank's token
    shard's gradient, and the parameters' gradients summed over the ranks
    (a rank's expert weights see only its own experts' rows), within
    ``1e-5``; the double-buffered plan's gradients bitwise the blocking
    form's."""
    import jax
    import jax.numpy as jnp
    import numpy as np

    from _torch_families import perturb
    from repro.models import ffn as jffn

    rng = np.random.default_rng(120)
    params = jax.tree.map(np.asarray, perturb(_moe_tree(4)))
    x = rng.standard_normal((4, 8, 64)).astype(np.float32)
    cot = rng.standard_normal((4, 8, 64)).astype(np.float32)

    def f(p, xv):
        y, aux = jffn.moe_ffn(p, xv, n_experts=4, top_k=2, capacity_factor=2.0)
        return jnp.sum(y * cot) + aux

    gp, gx = jax.grad(f, argnums=(0, 1))(jax.tree.map(jnp.asarray, params), jnp.asarray(x))
    ranks = run_gloo("_torch_recipe:ep_grads", 4, tmp_path, shape=(2, 2), params=params, x=x,
                     cot=cot)
    for rank, got in enumerate(ranks):
        assert got["blocking_equal"], rank
        d, r = divmod(rank, 2)
        want = np.asarray(gx)[2 * d:2 * d + 2, 4 * r:4 * r + 4]
        np.testing.assert_allclose(got["grads"][0], want, rtol=1e-5, atol=1e-5,
                                   err_msg=f"x rank {rank}")
    for i, w in enumerate(jax.tree.leaves(gp)):
        total = sum(got["grads"][1 + i] for got in ranks)
        np.testing.assert_allclose(total, np.asarray(w), rtol=1e-5, atol=1e-5, err_msg=f"leaf {i}")


def _moe_tree(E: int):
    import jax

    from repro.models import ffn as jffn
    from repro.models.module import init_params

    return init_params(jffn.moe_specs(64, 128, E), jax.random.PRNGKey(7))
