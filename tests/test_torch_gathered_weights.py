"""No layer's gathered weights outlive its block in a training step under a
sharding recipe, and no layer's backward writes its whole stack's gradient.

Rank 0 of a ``(4, 4)`` mesh on a fake world of 16, fake tensors (the dry
run's walk, :class:`repro_torch.launch.op_walk.OpWalk`), float32 SMOKE
configs with ``d_model`` 512 and ``d_ff`` 2,048 so that one layer's weights
(about 13 MB whole, 3.3 MB cut over ``model``) dwarf an activation of the
rank's rows (one row of 16 tokens, 32 KiB): the loss and gradients of a
batch of 4 x 16 tokens, as the training step takes them before its update
(``trainer._accum_loss_grads`` under the recipe).

The bound, from the config: the gradients of the rank's shards (one
shard-sized tree, ``shards``), the ``L`` remat inputs (the rank's rows of
the residual stream a block: ``L * B/D * S' * d_model * 4`` bytes, ``S'``
the chunk ``S/M`` under ``sp_ring``, else ``S``) and two of the largest
layer's float32 weights whole: the block under recompute holds its layer
gathered (over ``data``, and over ``model`` where its mixer needs more
than the rank's block), and its backward makes that layer's weight
gradients before they are reduce-scattered.  A program that keeps every
layer's gathered weights until the backward (the checkpoints' inputs) holds
``L`` layers of them, with their receive buffers, and exceeds it: 2x and
more here, 14x under ``sp_ring``, which gathered every layer whole at the
start of the forward.

The update that follows (AdamW on the whole stacked shards, its
temporaries about 5.5x the shards here) is not this bound's: its working
set is the optimizer's, the same with or without the fault.
"""
import dataclasses
import math

import pytest
import torch
import torch.distributed as dist

from repro_torch import configs
from repro_torch.core.dist import init_fake_world, make_mesh
from repro_torch.launch import op_walk
from repro_torch.models import lm
from repro_torch.models.module import tree_leaves
from repro_torch.models.sharding import RankBatch, local_batch_shapes, make_recipe, use_recipe
from repro_torch.train import trainer

B, S, D, M = 4, 16, 4, 4
WIDE = {"d_model": 512, "d_ff": 2048}
# (arch, mode, layers): L large enough that L layers' gathered weights
# pass two whole layers
CASES = [("phi4-mini-3.8b", "tp", 16), ("phi4-mini-3.8b", "sp", 16),
         ("phi4-mini-3.8b", "sp_ring", 16), ("zamba2-7b", "tp", 25),
         ("llama-3.2-vision-11b", "tp", 20)]
# the stacked trees and how many stack dims each leaf has
STACKS = {"blocks": 1, "mamba_blocks": 2, "tail_blocks": 1, "shared_block": 0,
          "shared_lora": 1, "self_blocks": 2, "cross_blocks": 1}


@pytest.fixture
def world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _cfg(arch, layers):
    return dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32,
                               n_layers=layers, **WIDE)


def _batch(cfg, recipe):
    """The step's batch: whole without a recipe, else this rank's blocks."""
    shapes = {"tokens": (B, S), "labels": (B, S)}
    if cfg.family == "vlm":
        shapes["image_embeds"] = (B, cfg.enc_len, cfg.enc_dim)
    local = shapes if recipe is None else local_batch_shapes(recipe, shapes)
    batch = {k: torch.empty(local[k], dtype=torch.float32 if k == "image_embeds" else torch.int32)
             for k in shapes}
    return batch if recipe is None else RankBatch(batch, shapes)


def _layer_bytes(spec, depth: int) -> int:
    """One layer's float32 bytes, whole, of a ``depth``-times stacked tree."""
    if isinstance(spec, dict):
        return sum(_layer_bytes(v, depth) for v in spec.values())
    return math.prod(spec.shape[depth:]) * 4


def _walk_grads(cfg, params, recipe, walk):
    with walk:
        with use_recipe(recipe):
            out = trainer._accum_loss_grads(params, _batch(cfg, recipe), cfg, 1)
        del out
    return walk.stats()


@pytest.mark.parametrize("arch,mode,layers", CASES, ids=[f"{a}-{m}" for a, m, _ in CASES])
def test_training_peak_holds_two_layers_gathered(world, arch, mode, layers):
    cfg = _cfg(arch, layers)
    init_fake_world(D * M, 0, "cpu")
    recipe = make_recipe(cfg, make_mesh((D, M), ("data", "model"), device="cpu"),
                         attn_mode=mode)
    specs = lm.build_specs(cfg)
    whole_layer = max(_layer_bytes(specs[k], depth) for k, depth in STACKS.items()
                      if k in specs)
    seq = S // M if mode == "sp_ring" else S
    remat = cfg.n_layers * (B // D) * seq * cfg.d_model * 4
    with torch._subclasses.fake_tensor.FakeTensorMode():
        params = lm.abstract_model(cfg, recipe=recipe, device="cpu")
        shards = sum(t.numel() * 4 for t in tree_leaves(params))
        st = _walk_grads(cfg, params, recipe, op_walk.OpWalk())
    bound = shards + remat + 2 * whole_layer
    assert st.peak_live_bytes < bound, (st.peak_live_bytes, shards, remat, whole_layer)


class _MadeBy(op_walk.OpWalk):
    """An :class:`OpWalk` that lists the op and shape of every storage made
    during the walk."""

    def __init__(self):
        super().__init__()
        self.made: list = []
        self._op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func.overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _storage(self, t, fresh):
        if fresh and t.untyped_storage()._cdata not in self._sid:
            self.made.append((self._op, tuple(t.shape)))
        return super()._storage(t, fresh)


def test_no_layer_backward_writes_its_whole_stack(world):
    """The dense family's loss and gradients with no recipe (the path is the
    same under one): no storage the walk makes with ``select_backward`` has
    a stacked leaf's shape, which a layer taken as ``t[i]`` makes in its
    backward, zero-filled, for every layer."""
    cfg = _cfg("phi4-mini-3.8b", 8)
    stacked = {tuple(t.shape) for t in tree_leaves(lm.build_specs(cfg)["blocks"])}
    with torch._subclasses.fake_tensor.FakeTensorMode():
        params = lm.abstract_model(cfg, device="cpu")
        walk = _MadeBy()
        _walk_grads(cfg, params, None, walk)
    assert any(shape in stacked for _, shape in walk.made)  # the stacks' gradients are seen
    whole = [(op, shape) for op, shape in walk.made
             if op == "select_backward" and shape in stacked]
    assert not whole, whole[:4]
