"""Gloo workers of the sharding-recipe tests (``tests/test_torch_recipe*.py``):
every family's per-rank program under ``tp``, ``sp`` and ``sp_ring``
recipes on a ``(data, model)`` mesh of 4 (or 2) CPU ranks.  Each runs
inside a rank of :func:`_torch_dist.run_gloo` (named
``"_torch_recipe:<worker>"``) and returns numpy results."""
from __future__ import annotations

RECIPE_MESHES = [(2, 2), (1, 4), (4, 1)]
RECIPE_MODES = ("tp", "sp")
RECIPE_ARCHS = {"phi4-mini-3.8b": 32, "qwen2.5-32b": 30}  # arch -> forward sequence length
RECIPE_BATCH = 4
PREFILL_COUNTS = (7, 5, 0, 3)  # a whole-prompt chunk of 7: ragged rows, one idle
RECURRENT_ARCHS = ("rwkv6-3b", "zamba2-7b")  # the SSM and hybrid families, SMOKE configs
RECURRENT_MODES = ("tp", "sp", "sp_ring")
RECURRENT_SEQ = 32  # two of the SMOKE configs' 16-token scan chunks


def _model(arch, tree):
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models.weights import params_from_jax

    cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32)
    return cfg, params_from_jax(tree, device="cpu")


def _shards(cfg, params, recipe):
    from repro_torch.models import lm
    from repro_torch.models.weights import shard_params_by_recipe

    return shard_params_by_recipe(params, lm.build_specs(cfg), recipe)


def forward_family(*, shape, models, tokens) -> dict:
    """``lm.forward`` under each recipe mode on this rank of a ``shape``
    mesh: the whole logits (this rank's block gathered,
    ``lm.gather_logits``), and whether the shards gathered back are the
    whole tree bitwise."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import gather_params

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out: dict = {}
    for arch, tree in models.items():
        cfg, params = _model(arch, tree)
        for mode in RECIPE_MODES:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, params, recipe)
            batch = local_batch(recipe, {"tokens": torch.from_numpy(tokens[arch]).long()})
            with use_recipe(recipe), torch.no_grad():
                logits, _ = lm.forward(shards, batch, cfg)
            out[(arch, mode)] = lm.gather_logits(logits, recipe, len(tokens[arch])).numpy()
            whole = gather_params(shards, lm.build_specs(cfg), recipe)
            out[(arch, mode, "gathered")] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(whole), tree_leaves(params)))
            out[(arch, mode, "cut")] = any(
                a.shape != b.shape for a, b in zip(tree_leaves(shards), tree_leaves(params)))
    return out


def serve_family(*, shape, models, requests, slots, max_len, prefill_tokens) -> dict:
    """``Engine(recipe=...)`` under ``tp``, ``sp`` and ``sp_ring`` on this
    rank: its greedy outputs; and one whole-prompt prefill chunk of
    ``lm.decode_step(prefill=True)`` under each mode (ragged rows, one idle
    row): its logits and the caches gathered back to their whole shape."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.attention import KVCache
    from repro_torch.models.sharding import (all_gather, decode_state_shardings, local_batch,
                                             make_recipe, use_recipe)
    from repro_torch.serve.engine import Engine, ServeConfig

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    scfg = ServeConfig(max_len=max_len, batch_slots=slots, eos_token=-1)
    out: dict = {}
    for arch, tree in models.items():
        cfg, params = _model(arch, tree)
        for mode in RECIPE_MODES + ("sp_ring",):
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, params, recipe)
            engine = Engine(cfg, shards, scfg, recipe=recipe)
            for rid, prompt, n in requests[arch]:
                engine.submit(rid, prompt, n)
            out[(arch, mode, "tokens")] = engine.run()
            # one prefill chunk from empty caches
            B, S = prefill_tokens.shape
            with use_recipe(recipe), torch.no_grad():
                state = lm.DecodeState(caches=lm.init_cache(cfg, B, 16, device="cpu"),
                                       positions=torch.zeros((B,), dtype=torch.int32))
                logits, new = lm.decode_step(
                    shards, state, local_batch(recipe, {"tokens": torch.from_numpy(
                        prefill_tokens).long()}, decode=True), cfg,
                    new_counts=torch.tensor(PREFILL_COUNTS, dtype=torch.int32), prefill=True)
            whole = torch.empty((cfg.n_layers, B, cfg.n_kv, 16, cfg.head_dim), device="meta")
            spec = decode_state_shardings(recipe, KVCache(whole, whole, whole)).k
            caches = []
            for t in (new.caches.k, new.caches.v):
                for dim, axis in enumerate(spec):
                    if axis is not None:
                        t = all_gather(t, mesh, axis, dim, split=False)
                caches.append(t.numpy())
            out[(arch, mode, "prefill")] = (lm.gather_logits(logits, recipe, B).numpy(), *caches,
                                            new.caches.length.numpy(),
                                            new.positions.numpy())
    return out


def serve_recipe_tp(*, shape, models, requests, slots, max_len, microbatches) -> dict:
    """``Engine(recipe=..., mesh=..., microbatches=...)`` under ``tp``, ``sp``
    and ``sp_ring`` on this rank: prefill under the recipe, decode through
    the explicit TP step, one cache allocation.  Its greedy outputs of
    ``requests[arch]``, this rank's K/V blocks and the lengths after the
    run, and the names of the ``tp_params`` leaves that differ from
    ``shard_params`` of the whole cast tree (bitwise)."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import make_recipe
    from repro_torch.models.weights import cast_params, shard_params
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.tp_decode import tp_decode_specs

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    scfg = ServeConfig(max_len=max_len, batch_slots=slots, eos_token=-1)
    out: dict = {"coords": mesh.coords()}
    for arch, tree in models.items():
        cfg, params = _model(arch, tree)
        want = tree_leaves(shard_params(cast_params(params, cfg.act_dtype),
                                        tp_decode_specs(cfg)[0], mesh))
        for mode in RECIPE_MODES + ("sp_ring",):
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            engine = Engine(cfg, _shards(cfg, params, recipe), scfg, recipe=recipe, mesh=mesh,
                            microbatches=microbatches)
            for rid, prompt, n in requests[arch]:
                engine.submit(rid, prompt, n)
            out[(arch, mode, "tokens")] = engine.run()
            caches = engine.state.caches
            out[(arch, mode, "caches")] = (caches.k.numpy(), caches.v.numpy(),
                                           caches.length.numpy())
            out[(arch, mode, "tp_params_differ")] = [
                i for i, (a, b) in enumerate(zip(tree_leaves(engine.tp_params), want, strict=True))
                if not torch.equal(a, b)]
            out[(arch, mode, "steps")] = dict(engine.steps)
    return out


def train_family(*, shape, params, batch, ocfg, modes) -> dict:
    """``make_train_step`` under each recipe mode of ``modes`` on this rank:
    the loss, the gradient norm, the gradients (``_accum_loss_grads``) and
    the stepped parameters, each gathered back to the whole tree; and
    whether the int8 compression of the cut gradient leaves equals the
    whole leaves' compression, cut."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import local_batch, make_recipe, recipe_pspecs, use_recipe
    from repro_torch.models.weights import gather_params, shard_params
    from repro_torch.train import optimizer, trainer

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    cfg, whole = _model("phi4-mini-3.8b", params)
    oc = optimizer.OptConfig(**ocfg)
    b = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    specs = lm.build_specs(cfg)
    out: dict = {}
    for mode in modes:
        recipe = make_recipe(cfg, mesh, attn_mode=mode)
        shards = _shards(cfg, whole, recipe)
        mine = local_batch(recipe, b)
        with use_recipe(recipe):
            loss, _, grads = trainer._accum_loss_grads(shards, mine, cfg, 1)
        out[(mode, "loss")] = float(loss)
        whole_g = gather_params(grads, specs, recipe)
        out[(mode, "grads")] = [g.numpy() for g in tree_leaves(whole_g)]
        # int8 compression of a cut leaf: each shard quantized against the
        # whole leaf's largest magnitude is the whole leaf's quantization, cut
        cut = trainer._shard_cut(shards, cfg, recipe)
        amaxes = tree_leaves(cut[1]) if cut else [None] * len(tree_leaves(grads))
        out[(mode, "int8_cut")] = cut is not None and all(
            torch.equal(optimizer.compress_leaf(g, torch.zeros_like(g), amax)[0],
                        shard_params(optimizer.compress_leaf(w, torch.zeros_like(w))[0], ps, mesh))
            for g, w, amax, ps in zip(tree_leaves(grads), tree_leaves(whole_g), amaxes,
                                      tree_leaves(recipe_pspecs(recipe, specs))))
        new_p, _, m = trainer.make_train_step(cfg, recipe, oc)(
            shards, optimizer.init_opt_state(shards, oc), mine)
        out[(mode, "metrics")] = {k: float(v) for k, v in m.items()}
        out[(mode, "params")] = [p.numpy() for p in tree_leaves(gather_params(new_p, specs,
                                                                               recipe))]
    return out


def logits_cut(*, shape, models, batch, modes, upcast_chunk=None) -> dict:
    """The logits as each rank holds them under a recipe, and the
    vocab-parallel loss: for every ``models[name] = (config overrides, the
    reference's parameters as numpy)`` of phi4-mini SMOKE (float32) and
    each mode of ``modes[name]`` on this rank of a ``shape`` mesh,
    ``lm.forward``'s logits as returned (this rank's block), and
    ``loss_fn``'s loss, metrics and gradients (``_accum_loss_grads`` on
    ``batch``, with its ``loss_mask``), the gradients gathered back to the
    whole tree.  ``upcast_chunk``: ``blocks.UPCAST_CHUNK`` for the run (the
    float32 elements the loss and RMSNorm's backward upcast at a time),
    else the module's."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models import blocks, lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import gather_params, params_from_jax
    from repro_torch.train import trainer

    if upcast_chunk is not None:
        blocks.UPCAST_CHUNK = upcast_chunk
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    b = {k: torch.from_numpy(v) if v.dtype.kind == "f" else torch.from_numpy(v).long()
         for k, v in batch.items()}
    out: dict = {"coords": mesh.coords()}
    for name, (overrides, tree) in models.items():
        cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True),
                                  act_dtype=torch.float32, **overrides)
        whole = params_from_jax(tree, device="cpu")
        for mode in modes[name]:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, whole, recipe)
            mine = local_batch(recipe, b)
            with use_recipe(recipe), torch.no_grad():
                logits, _ = lm.forward(shards, local_batch(recipe, {"tokens": b["tokens"]}), cfg)
            out[(name, mode, "logits")] = logits.numpy()
            with use_recipe(recipe):
                loss, metrics, grads = trainer._accum_loss_grads(shards, mine, cfg, 1)
            out[(name, mode, "loss")] = float(loss)
            out[(name, mode, "metrics")] = {k: float(v) for k, v in metrics.items()}
            out[(name, mode, "grads")] = [g.numpy() for g in tree_leaves(
                gather_params(grads, lm.build_specs(cfg), recipe))]
    return out


def loss_terms(*, shape, logits, labels, mask, upcast_chunk) -> dict:
    """The loss's ``(logz, gold)`` on this rank of a ``shape`` mesh, its
    rows (over ``data``) of the whole float32 ``logits (B, S, V)`` and its
    block of the vocab (over ``model``): through ``lm._loss_terms`` with
    ``blocks.UPCAST_CHUNK = upcast_chunk`` (``"chunks"``) and through the plain
    ``lm._loss_terms_plain`` (``"plain"``), each with the cotangent of the
    block under the masked mean of ``logz - gold``."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import blocks, lm

    blocks.UPCAST_CHUNK = upcast_chunk
    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    D, M = shape
    d, r = mesh.coords()["data"], mesh.coords()["model"]
    B, V = logits.shape[0], logits.shape[-1]
    rows, cols = slice(d * (B // D), (d + 1) * (B // D)), slice(r * (V // M), (r + 1) * (V // M))
    lab = torch.from_numpy(labels[rows]).long()
    msk = torch.from_numpy(mask[rows])
    out: dict = {"coords": mesh.coords()}
    for name, fn in (("chunks", lm._loss_terms), ("plain", lm._loss_terms_plain)):
        block = torch.from_numpy(logits[rows, :, cols].copy()).requires_grad_()
        logz, gold = fn(block, lab, mesh)
        (((logz - gold) * msk).sum() / msk.sum()).backward()
        out[name] = (logz.detach().numpy(), gold.detach().numpy(), block.grad.numpy())
    return out


def ckpt_family(*, shape, params, directory, save) -> dict:
    """Save this rank's shards under a ``shape`` recipe (``save``), or
    restore the latest checkpoint under it: the restored shards gathered
    back, and whether each equals this rank's cut of the whole tree."""
    import torch

    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import make_recipe
    from repro_torch.models.weights import gather_params

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    cfg, whole = _model("phi4-mini-3.8b", params)
    recipe = make_recipe(cfg, mesh)
    specs = lm.build_specs(cfg)
    mine = _shards(cfg, whole, recipe)
    mgr = CheckpointManager(directory)
    if save:
        mgr.save(3, {"params": mine}, extra={"note": "elastic"}, recipe=recipe,
                 specs={"params": specs})
        return {"cut": any(a.shape != b.shape for a, b in zip(tree_leaves(mine),
                                                              tree_leaves(whole)))}
    template = {"params": mine}
    restored, extra = mgr.restore(template, recipe=recipe, specs={"params": specs})
    got = restored["params"]
    return {"extra": extra,
            "shards_equal": all(torch.equal(a, b) for a, b in zip(tree_leaves(got),
                                                                    tree_leaves(mine))),
            "whole": [t.numpy() for t in tree_leaves(gather_params(got, specs, recipe))]}


def _recurrent(arch, tree):
    """The port's float32 SMOKE config of ``arch`` and its parameters from
    the reference's numpy tree."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models.weights import params_from_jax

    cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32)
    return cfg, params_from_jax(tree, device="cpu")


def forward_recurrent(*, shape, models, tokens) -> dict:
    """``lm.forward`` of the SSM and hybrid families under each mode of
    RECURRENT_MODES on this rank of a ``shape`` mesh: the whole logits,
    whether the shards gathered back are the whole tree bitwise, and
    whether any leaf is cut."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import gather_params

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out: dict = {}
    for arch, tree in models.items():
        cfg, params = _recurrent(arch, tree)
        for mode in RECURRENT_MODES:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, params, recipe)
            batch = local_batch(recipe, {"tokens": torch.from_numpy(tokens[arch]).long()})
            with use_recipe(recipe), torch.no_grad():
                logits, _ = lm.forward(shards, batch, cfg)
            out[(arch, mode)] = lm.gather_logits(logits, recipe, len(tokens[arch])).numpy()
            whole = gather_params(shards, lm.build_specs(cfg), recipe)
            out[(arch, mode, "gathered")] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(whole), tree_leaves(params)))
            out[(arch, mode, "cut")] = any(
                a.shape != b.shape for a, b in zip(tree_leaves(shards), tree_leaves(params)))
    return out


def serve_recurrent(*, shape, models, requests, slots, max_len) -> dict:
    """``Engine(recipe=...)`` of the SSM and hybrid families under each mode
    of RECURRENT_MODES on this rank: its greedy outputs, and whether every
    leaf of its decode state has the local shape ``decode_state_shardings``
    gives it."""
    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import decode_state_shardings, local_shape, make_recipe
    from repro_torch.serve.engine import Engine, ServeConfig

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    scfg = ServeConfig(max_len=max_len, batch_slots=slots, eos_token=-1)
    out: dict = {}
    for arch, tree in models.items():
        cfg, params = _recurrent(arch, tree)
        for mode in RECURRENT_MODES:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            engine = Engine(cfg, _shards(cfg, params, recipe), scfg, recipe=recipe)
            for rid, prompt, n in requests[arch]:
                engine.submit(rid, prompt, n)
            out[(arch, mode, "tokens")] = engine.run()
            whole = lm.init_cache(cfg, slots, max_len, device="cpu")
            specs = decode_state_shardings(recipe, whole)
            mine = _state_leaves(engine.state.caches)
            out[(arch, mode, "local")] = [tuple(t.shape) for t in mine] == [
                local_shape(t.shape, s, mesh) for t, s in zip(_state_leaves(whole),
                                                              _state_leaves(specs))]
    return out


def _state_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in _state_leaves(tree[k])]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [x for t in tree for x in _state_leaves(t)]
    return [tree]


def train_recurrent(*, shape, models, batch, ocfg) -> dict:
    """``make_train_step`` of the SSM and hybrid families under each mode of
    RECURRENT_MODES on this rank: the gradients (``_accum_loss_grads``),
    the step's metrics and the stepped parameters, each gathered back to
    the whole tree."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import gather_params
    from repro_torch.train import optimizer, trainer

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    oc = optimizer.OptConfig(**ocfg)
    out: dict = {}
    for arch, tree in models.items():
        cfg, whole = _recurrent(arch, tree)
        specs = lm.build_specs(cfg)
        b = {k: torch.from_numpy(v).long() for k, v in batch[arch].items()}
        for mode in RECURRENT_MODES:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, whole, recipe)
            mine = local_batch(recipe, b)
            with use_recipe(recipe):
                _, _, grads = trainer._accum_loss_grads(shards, mine, cfg, 1)
            out[(arch, mode, "grads")] = [g.numpy() for g in tree_leaves(
                gather_params(grads, specs, recipe))]
            new_p, _, m = trainer.make_train_step(cfg, recipe, oc)(
                shards, optimizer.init_opt_state(shards, oc), mine)
            out[(arch, mode, "metrics")] = {k: float(v) for k, v in m.items()}
            out[(arch, mode, "params")] = [
                p.numpy() for p in tree_leaves(gather_params(new_p, specs, recipe))]
    return out


def recurrent_whole_mixers(*, shape, models, overrides, tokens, steps) -> dict:
    """The SSM and hybrid families under ``tp`` on this rank of a ``shape``
    mesh with configs whose mixer heads do not divide ``model``
    (``overrides``): the forward's logits, and ``steps`` one-token decode
    steps from empty states (their logits, and each state leaf's local
    shape against ``decode_state_shardings``)."""
    import dataclasses

    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import (decode_state_shardings, local_batch, local_shape,
                                             make_recipe, use_recipe)

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out: dict = {}
    for arch, tree in models.items():
        cfg, params = _recurrent(arch, tree)
        cfg = dataclasses.replace(cfg, **overrides[arch])
        recipe = make_recipe(cfg, mesh, attn_mode="tp")
        shards = _shards(cfg, params, recipe)
        toks = torch.from_numpy(tokens[arch]).long()
        B = toks.shape[0]
        with use_recipe(recipe), torch.no_grad():
            out[(arch, "forward")] = lm.gather_logits(
                lm.forward(shards, local_batch(recipe, {"tokens": toks}), cfg)[0], recipe,
                B).numpy()
            state = lm.DecodeState(lm.init_cache(cfg, B, 16, device="cpu"),
                                   torch.zeros((B,), dtype=torch.int32))
            logits = []
            for t in range(steps):
                step, state = lm.decode_step(
                    shards, state, local_batch(recipe, {"tokens": toks[:, t:t + 1]}, decode=True),
                    cfg)
                logits.append(lm.gather_logits(step, recipe, B).numpy())
        out[(arch, "decode")] = logits
        whole = lm.init_cache(cfg, B, 16, device="cpu")
        specs = decode_state_shardings(recipe, whole)
        out[(arch, "local")] = [tuple(t.shape) for t in _state_leaves(state.caches)] == [
            local_shape(t.shape, s, mesh) for t, s in zip(_state_leaves(whole),
                                                          _state_leaves(specs))]
        out[(arch, "state_cut")] = [tuple(s) for s in _state_leaves(specs)]
    return out


# ------------------------------------------------- the MLA and MoE families
LATENT_MOE_MODES = ("tp", "sp", "sp_ring")


def _as_batch(x) -> dict:
    """A worker's numpy inputs as the port's batch: an array of token ids,
    or a dict of arrays (the integer leaves int64, the frames and images as
    they are)."""
    import torch

    if not isinstance(x, dict):
        x = {"tokens": x}
    return {k: torch.from_numpy(v).long() if v.dtype.kind in "iu" else torch.from_numpy(v)
            for k, v in x.items()}


def _rows(x) -> int:
    """The batch size of a worker's numpy inputs (:func:`_as_batch`)."""
    return (next(iter(x.values())) if isinstance(x, dict) else x).shape[0]


def greedy_feed(logits, counts, prev, vocab: int):
    """Each row's next token after a decode step: the argmax over the
    ``vocab`` real ids of its last valid position's ``logits`` (B, S, V),
    or ``prev[r]`` for a row idle in the step (``counts[r] == 0``)."""
    import numpy as np

    nxt = np.array(prev, dtype=np.int32)
    for r, n in enumerate(counts):
        if n:
            nxt[r] = int(np.argmax(logits[r, n - 1, :vocab]))
    return nxt


def _named(name, entry):
    """The port's float32 SMOKE config and parameters of ``entry = (arch,
    config overrides, the reference's parameters as numpy)``."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.models.weights import params_from_jax

    arch, overrides, tree = entry
    cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32,
                              **overrides)
    return cfg, params_from_jax(tree, device="cpu")


def forward_named(*, shape, models, tokens, modes=LATENT_MOE_MODES, others=None) -> dict:
    """``lm.forward`` of every ``models[name] = (arch, overrides, tree)``
    on ``tokens[name]`` (token ids, or a batch dict of any input kind)
    under each mode on this rank of a ``shape`` mesh: the whole logits, the
    aux loss, how many fallback warnings it raised, whether the shards
    gathered back are the whole tree bitwise and whether any leaf is cut;
    and the logits of ``others[name]`` (another batch), where given."""
    import warnings

    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import gather_params

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out: dict = {}
    for name, entry in models.items():
        cfg, params = _named(name, entry)
        for mode in modes:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, params, recipe)
            with use_recipe(recipe), torch.no_grad(), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                logits, aux = lm.forward(shards, local_batch(recipe, _as_batch(tokens[name])),
                                         cfg)
                if others and name in others:
                    out[(name, mode, "other")] = lm.gather_logits(
                        lm.forward(shards, local_batch(recipe, _as_batch(others[name])), cfg)[0],
                        recipe, _rows(others[name])).numpy()
            out[(name, mode)] = lm.gather_logits(logits, recipe, _rows(tokens[name])).numpy()
            out[(name, mode, "aux")] = float(aux)
            out[(name, mode, "warnings")] = sum("falling back" in str(w.message) for w in caught)
            whole = gather_params(shards, lm.build_specs(cfg), recipe)
            out[(name, mode, "gathered")] = all(
                torch.equal(a, b) for a, b in zip(tree_leaves(whole), tree_leaves(params)))
            out[(name, mode, "cut")] = any(
                a.shape != b.shape for a, b in zip(tree_leaves(shards), tree_leaves(params)))
    return out


def serve_named(*, shape, models, requests, slots, max_len, steps,
                modes=LATENT_MOE_MODES) -> dict:
    """Under each mode on this rank: ``Engine(recipe=...)``'s greedy outputs
    of ``requests[name]``, whether every leaf of its decode state has its
    local shape, and ``lm.decode_step`` from empty caches over ``steps[name]``
    (a list of ``(inputs, counts (B,))``, the inputs token ids (B, S) or a
    batch dict, the first a whole-prompt chunk, passed as ``prefill=True``
    for the families that prefill in chunks): each step's logits and the
    caches gathered back whole."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import (decode_state_shardings, local_batch, local_shape,
                                             make_recipe, use_recipe)
    from repro_torch.serve.engine import _CHUNK_FAMILIES, Engine, ServeConfig

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    scfg = ServeConfig(max_len=max_len, batch_slots=slots, eos_token=-1)
    out: dict = {}
    for name, entry in models.items():
        cfg, params = _named(name, entry)
        for mode in modes:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, params, recipe)
            engine = Engine(cfg, shards, scfg, recipe=recipe)
            for rid, prompt, n in requests[name]:
                engine.submit(rid, prompt, n)
            out[(name, mode, "tokens")] = engine.run()
            whole = lm._init_cache_whole(cfg, slots, max_len, torch.device("meta"))
            specs = decode_state_shardings(recipe, whole)
            out[(name, mode, "local")] = [tuple(t.shape) for t in _state_leaves(
                engine.state.caches)] == [local_shape(t.shape, s, mesh) for t, s in
                                          zip(_state_leaves(whole), _state_leaves(specs))]
            B = _rows(steps[name][0][0])
            logits = []
            with use_recipe(recipe), torch.no_grad():
                state = lm.DecodeState(caches=lm.init_cache(cfg, B, 16, device="cpu"),
                                       positions=torch.zeros((B,), dtype=torch.int32))
                for i, (toks, counts) in enumerate(steps[name]):
                    step, state = lm.decode_step(
                        shards, state, local_batch(recipe, _as_batch(toks), decode=True), cfg,
                        new_counts=torch.from_numpy(counts),
                        prefill=i == 0 and cfg.family in _CHUNK_FAMILIES)
                    logits.append(lm.gather_logits(step, recipe, B).numpy())
            out[(name, mode, "steps")] = logits
            out[(name, mode, "caches")] = _whole_state(cfg, B, state.caches, recipe)
            out[(name, mode, "positions")] = state.positions.numpy()
    return out


def _whole_state(cfg, B: int, caches, recipe) -> list:
    """The leaves of this rank's blocks of a 16-position decode state of
    ``B`` rows gathered back whole, as numpy (:func:`_state_leaves` order)."""
    import torch

    from repro_torch.models import lm
    from repro_torch.models.sharding import all_gather, decode_state_shardings

    specs = decode_state_shardings(recipe, lm._init_cache_whole(cfg, B, 16, torch.device("meta")))
    out = []
    for t, spec in zip(_state_leaves(caches), _state_leaves(specs)):
        for dim, axis in enumerate(spec):
            if axis is not None:
                for a in reversed((axis,) if isinstance(axis, str) else axis):
                    t = all_gather(t, recipe.mesh, a, dim, split=False)
        out.append(t.numpy())
    return out


def decode_greedy(*, shape, models, prompts, counts, image, other_image,
                  modes=LATENT_MOE_MODES) -> dict:
    """The VLM family's serving through ``lm.decode_step`` under each mode
    on this rank of a ``shape`` mesh, on its shards and its blocks of a
    16-position cache: a whole-prompt chunk of ``prompts[name]`` (B, S)
    with ``counts[0]`` (``prefill=True``; ragged rows, one idle), then
    ``len(counts) - 1`` one-token steps, each row fed its greedy token
    (:func:`greedy_feed`) with ``counts[t]`` (idle rows present), every
    row over its own ``image``.  Returns each step's logits and fed tokens,
    the caches gathered back whole, the positions, and the chunk's logits
    over ``other_image``."""
    import numpy as np
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out: dict = {}
    for name, entry in models.items():
        cfg, params = _named(name, entry)
        toks = prompts[name]
        B = toks.shape[0]
        img, other = torch.from_numpy(image), torch.from_numpy(other_image)
        for mode in modes:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, params, recipe)
            logits, fed = [], []
            with use_recipe(recipe), torch.no_grad():
                state = lm.DecodeState(caches=lm.init_cache(cfg, B, 16, device="cpu"),
                                       positions=torch.zeros((B,), dtype=torch.int32))
                first = local_batch(recipe, {"tokens": torch.from_numpy(toks).long(),
                                             "image_embeds": other}, decode=True)
                out[(name, mode, "other")] = lm.gather_logits(lm.decode_step(
                    shards, lm.DecodeState(lm.init_cache(cfg, B, 16, device="cpu"),
                                           state.positions.clone()),
                    first, cfg, new_counts=torch.from_numpy(counts[0]), prefill=True)[0], recipe,
                    B).numpy()
                feed = toks
                prev = toks[:, 0]
                for t, c in enumerate(counts):
                    step, state = lm.decode_step(
                        shards, state, local_batch(recipe, {"tokens": torch.from_numpy(feed).long(),
                                                            "image_embeds": img}, decode=True),
                        cfg, new_counts=torch.from_numpy(c), prefill=t == 0)
                    logits.append(lm.gather_logits(step, recipe, B).numpy())
                    prev = greedy_feed(logits[-1], c, prev, cfg.vocab)
                    fed.append(prev)
                    feed = prev[:, None]
            out[(name, mode, "steps")] = logits
            out[(name, mode, "tokens")] = np.stack(fed)
            out[(name, mode, "caches")] = _whole_state(cfg, B, state.caches, recipe)
            out[(name, mode, "positions")] = state.positions.numpy()
    return out


def train_named(*, shape, models, batch, ocfg, modes=LATENT_MOE_MODES, microbatches=1,
                contiguous=False) -> dict:
    """``make_train_step`` of every named model under each mode on this
    rank, ``microbatches`` of them, the rank handed its blocks of the
    batch laid out for them (``sharding.local_batch``; ``contiguous``: the
    rank's contiguous block of the global rows instead, the wrong layout,
    for a test to show that it fails): the gradients
    (``_accum_loss_grads``), the step's metrics and the stepped
    parameters, each gathered back to the whole tree."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import gather_params
    from repro_torch.train import optimizer, trainer

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    oc = optimizer.OptConfig(**ocfg)
    out: dict = {}
    for name, entry in models.items():
        cfg, whole = _named(name, entry)
        specs = lm.build_specs(cfg)
        b = _as_batch(batch[name])
        for mode in modes:
            recipe = make_recipe(cfg, mesh, attn_mode=mode)
            shards = _shards(cfg, whole, recipe)
            mine = local_batch(recipe, b, microbatches=microbatches)
            if contiguous:
                mine = _contiguous(recipe, b, mine)
            with use_recipe(recipe):
                _, _, grads = trainer._accum_loss_grads(shards, mine, cfg, microbatches)
            out[(name, mode, "grads")] = [g.numpy() for g in tree_leaves(
                gather_params(grads, specs, recipe))]
            new_p, _, m = trainer.make_train_step(cfg, recipe, oc, microbatches=microbatches)(
                shards, optimizer.init_opt_state(shards, oc), mine)
            out[(name, mode, "metrics")] = {k: float(v) for k, v in m.items()}
            out[(name, mode, "params")] = [
                p.numpy() for p in tree_leaves(gather_params(new_p, specs, recipe))]
    return out


def _contiguous(recipe, batch, mine):
    """``mine`` (this rank's blocks, laid out for its microbatches) with
    every leaf's rows replaced by the rank's contiguous block of the
    global rows, ``[r*n, (r+1)*n)``: the layout that gives the wrong
    microbatches."""
    from repro_torch.models.sharding import RankBatch, batch_rows

    B = next(iter(mine.shapes.values()))[0]
    _, row0, n = batch_rows(recipe, B)
    return RankBatch({k: batch[k][row0:row0 + n].reshape(v.shape) for k, v in mine.items()},
                     mine.shapes, mine.microbatches)


def ep_grads(*, shape, params, x, cot) -> dict:
    """The gradients of ``sum(moe_expert_parallel(p, x_r) * cot_r) + aux``
    on this rank of a ``shape`` mesh (``x_r``, ``cot_r`` this rank's token
    shard of the whole ``x``, ``cot``), with the double-buffered plan and
    with its blocking form: ``x_r``'s and every parameter's (whole weights,
    this rank's partial of their gradient), and whether the two forms'
    gradients are bitwise equal."""
    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models import ffn
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import make_recipe, use_recipe
    from repro_torch.models.weights import params_from_jax

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    recipe = make_recipe(configs.get("phi3.5-moe-42b-a6.6b", smoke=True), mesh)
    D, R = shape
    d, r = mesh.coords()["data"], mesh.coords()["model"]
    B, S, _ = x.shape
    rows, pos = slice(d * (B // D), (d + 1) * (B // D)), slice(r * (S // R), (r + 1) * (S // R))
    runs = []
    for db in (True, False):
        p = {k: t.requires_grad_() for k, t in params_from_jax(params, device="cpu").items()}
        xr = torch.from_numpy(x[rows, pos].copy()).requires_grad_()
        with use_recipe(recipe):
            y, aux = ffn.moe_expert_parallel(p, xr, n_experts=p["router"].shape[-1], top_k=2,
                                             capacity_factor=2.0, n_groups=2, double_buffer=db)
        ((y * torch.from_numpy(cot[rows, pos].copy())).sum() + aux).backward()
        runs.append([xr.grad] + [t.grad for t in tree_leaves(p)])
    return {"grads": [g.numpy() for g in runs[0]],
            "blocking_equal": all(torch.equal(a, b) for a, b in zip(*runs))}


# ----------------------------------------------- the VLM and audio families
# the reference's own GSPMD forward under tp and sp on 4 fake devices, every
# leaf of a batch dict (tokens, the audio family's frames, the VLM's image)
# placed by its batch_shardings
_FAMILY_REFERENCE = """
import dataclasses, pickle, sys
import numpy as np, jax, jax.numpy as jnp
import repro.core.compat as compat
sys.path.insert(0, {tests!r})
from repro import configs
from repro.models import lm
from repro.models.sharding import make_recipe, use_recipe, batch_shardings
from _torch_recipe import RECIPE_MESHES

with open({inputs!r}, "rb") as f:
    models, batches = pickle.load(f)
out = {{}}
for name, (arch, overrides, tree) in models.items():
    cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=jnp.float32,
                              attn_impl="interpret", **overrides)
    params = jax.tree.map(jnp.asarray, tree)
    specs = lm.build_specs(cfg)
    b = {{k: jnp.asarray(v) for k, v in batches[name].items()}}
    for shape in RECIPE_MESHES:
        mesh = compat.make_mesh(shape, ("data", "model"))
        for mode in ("tp", "sp"):
            r = make_recipe(cfg, mesh, attn_mode=mode)
            pd = jax.tree.map(lambda x, s: jax.device_put(x, s), params, r.param_shardings(specs))
            bs = batch_shardings(r, b)
            bd = {{k: jax.device_put(v, bs[k]) for k, v in b.items()}}

            def f(p, b, r=r):
                with use_recipe(r):
                    return lm.forward(p, b, cfg)

            with mesh:
                logits, aux = jax.jit(f)(pd, bd)
            out[(name, shape, mode)] = (np.asarray(logits), float(aux))
with open({path!r}, "wb") as f:
    pickle.dump(out, f)
print("OK")
"""


def family_reference(distributed, models, batches, directory) -> dict:
    """The reference's GSPMD forward of every ``models[name] = (arch,
    overrides, tree)`` on ``batches[name]`` (a dict of numpy arrays) under
    ``tp`` and ``sp`` on every mesh of ``RECIPE_MESHES``, in a 4-fake-device
    subprocess (``distributed``, the tests' fixture): ``{(name, shape,
    mode): (logits, aux)}``."""
    import pickle

    from _torch_dist import TESTS

    with open(directory / "inputs.pkl", "wb") as f:
        pickle.dump((models, batches), f)
    path = str(directory / "reference.pkl")
    assert "OK" in distributed(_FAMILY_REFERENCE.format(
        tests=TESTS, inputs=str(directory / "inputs.pkl"), path=path), devices=4)
    with open(path, "rb") as f:  # written by the reference subprocess above
        return pickle.load(f)


def family_twin(*, shape, models, batch, train_batch, ocfg, steps=None, requests=None,
                prompts=None, counts=None, image=None, other_image=None, slots=4,
                max_len=64) -> dict:
    """Every program a family runs under a recipe, each mode on this rank
    of a ``shape`` mesh, in one job: ``lm.forward`` of ``batch``
    (:func:`forward_named`), one ``make_train_step`` step of
    ``train_batch`` (:func:`train_named`), and either the engine and
    ``lm.decode_step`` over ``steps`` (:func:`serve_named`, with
    ``requests``) or the VLM's greedy decode loop (:func:`decode_greedy`,
    with ``prompts``)."""
    out = {"forward": forward_named(shape=shape, models=models, tokens=batch),
           "train": train_named(shape=shape, models=models, batch=train_batch, ocfg=ocfg)}
    if requests is not None:
        out["serve"] = serve_named(shape=shape, models=models, requests=requests, slots=slots,
                                   max_len=max_len, steps=steps)
    if prompts is not None:
        out["decode"] = decode_greedy(shape=shape, models=models, prompts=prompts, counts=counts,
                                      image=image, other_image=other_image)
    return out


def train_launcher(*, argv) -> dict:
    """``repro_torch.launch.train``'s run of ``argv`` on this gloo rank, the
    world the launcher's ``torchrun`` would have made (its record: every
    step's loss)."""
    import os

    import torch.distributed as dist

    from repro_torch.launch import train

    os.environ.update(RANK=str(dist.get_rank()), WORLD_SIZE=str(dist.get_world_size()))
    return train.run(train.parse_args(argv))


def serve_launcher(*, argv, arch, ckpt_dir, grid, requests, max_new) -> dict:
    """``repro_torch.launch.serve``'s run of ``argv`` (``--grid`` on this
    gloo world, the one ``torchrun`` would make) on this rank: its exit code
    and printed lines; and, on the same rank before it, the parameters its
    ``restore_params`` gives from ``ckpt_dir`` and an engine's greedy tokens
    on them (the launcher's ``requests`` prompts, its slots and length, its
    tensor-parallel decode on the ``grid`` mesh)."""
    import contextlib
    import io

    import torch

    from repro_torch import configs
    from repro_torch.ckpt.manager import flatten
    from repro_torch.core import make_mesh
    from repro_torch.launch import serve
    from repro_torch.models import lm
    from repro_torch.serve.engine import Engine, ServeConfig

    cfg = configs.get(arch, smoke=True)
    mesh = make_mesh(grid, ("data", "model"), device="cpu")
    params = lm.init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    restored, step = serve.restore_params(params, ckpt_dir)
    engine = Engine(cfg, restored, ServeConfig(max_len=256, batch_slots=4, eos_token=-1),
                    mesh=mesh, microbatches=2)
    for rid, prompt in enumerate(serve.prompts(cfg, requests)):
        engine.submit(rid, prompt, max_new)
    out = {"step": step, "tokens": engine.run(),
           "restored": [t.numpy() for t in flatten(restored)]}
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out["rc"] = serve.main(argv)
    out["stdout"] = buf.getvalue()
    return out


# --------------------------------------------- remat against no remat ----
def _named_leaves(tree, prefix="") -> list:
    """``(dotted name, leaf)`` of a parameter tree, in ``tree_leaves``'
    order."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in _named_leaves(tree[k], f"{prefix}.{k}" if prefix else k)]
    return [(prefix, tree)]


def remat_against_none(*, shape, cases, batches) -> dict:
    """The loss and gradients of each ``cases`` entry ``(arch, mode,
    layers)`` on this rank of a ``shape`` mesh, with ``cfg.remat`` at
    ``"block"`` and at ``"none"``: float32 SMOKE configs cut to ``layers``,
    seeded weights (the same on every rank) whose constant leaves get seeded
    noise and whose VLM gates are drawn from U[0.5, 1], under the recipe
    mode.  Returns per case whether the losses are bitwise equal, the two
    losses, and each gradient leaf that is not bitwise equal, with its name
    and largest difference."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.module import tree_leaves, tree_map
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.train import trainer

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    out: dict = {}
    for arch, mode, layers in cases:
        cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32,
                                  n_layers=layers)
        gen = torch.Generator().manual_seed(31)
        whole = lm.init_model(cfg, gen, device="cpu")

        def spread(t):
            if t.numel() > 1 and bool((t == t.flatten()[0]).all()):
                return t + 0.1 * torch.randn(t.shape, generator=gen)
            return t

        whole = tree_map(spread, whole)
        if "cross_blocks" in whole:
            for g in ("gate_attn", "gate_ffn"):
                leaf = whole["cross_blocks"][g]
                whole["cross_blocks"][g] = 0.5 + 0.5 * torch.rand(leaf.shape, generator=gen)
        recipe = make_recipe(cfg, mesh, attn_mode=mode)
        shards = _shards(cfg, whole, recipe)
        b = local_batch(recipe, _as_batch(batches[arch]))
        got = {}
        for remat in ("block", "none"):
            with use_recipe(recipe):
                got[remat] = trainer._accum_loss_grads(
                    shards, b, dataclasses.replace(cfg, remat=remat), 1)
        (l_on, _, g_on), (l_off, _, g_off) = got["block"], got["none"]
        unequal = [(name, float((a - b).abs().max()))
                   for (name, a), b in zip(_named_leaves(g_on), tree_leaves(g_off))
                   if not torch.equal(a, b)]
        out[(arch, mode)] = {"loss_equal": torch.equal(l_on, l_off),
                             "losses": (float(l_on), float(l_off)), "unequal": unequal,
                             "leaves": len(tree_leaves(g_on)),
                             "nonzero": sum(bool(g.abs().sum() > 0) for g in tree_leaves(g_on))}
    return out


def sp_residual(*, shape, models, batches) -> dict:
    """Every ``models[name] = (arch, overrides, tree)`` under a forced
    plain ``sp`` recipe on this rank of a ``shape`` mesh, on
    ``batches[name]`` (its input and ``labels``): ``lm.forward``'s whole
    logits and aux loss, the shape of the residual stream entering each
    block (``blocks.attn_block``'s ``x``, and apart the VLM's
    ``blocks.cross_block``'s) in that forward, this rank's ``(n_rows, cap,
    d_model)`` chunk of the rows' sequence, how many fallback warnings the
    forward raised, and ``loss_fn``'s loss, metrics and gradients gathered
    back whole."""
    import warnings

    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models import blocks, lm
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import (batch_rows, local_batch, make_recipe,
                                             ragged_seq_extents, use_recipe)
    from repro_torch.models.weights import gather_params
    from repro_torch.train import trainer

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    real = {k: getattr(blocks, k) for k in ("attn_block", "cross_block")}
    out: dict = {"coords": mesh.coords()}
    for name, entry in models.items():
        cfg, params = _named(name, entry)
        recipe = make_recipe(cfg, mesh, attn_mode="sp")
        shards = _shards(cfg, params, recipe)
        b = _as_batch(batches[name])
        B, S = b["labels"].shape
        seen = {k: [] for k in real}

        def spy(kind):
            def fn(p, x, *args, **kw):
                seen[kind].append(tuple(x.shape))
                return real[kind](p, x, *args, **kw)
            return fn

        for kind in real:
            setattr(blocks, kind, spy(kind))
        try:
            with use_recipe(recipe), torch.no_grad(), \
                    warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                logits, aux = lm.forward(shards, local_batch(
                    recipe, {k: v for k, v in b.items() if k != "labels"}), cfg)
        finally:
            for kind, fn in real.items():
                setattr(blocks, kind, fn)
        out[(name, "warnings")] = sum("falling back" in str(w.message) for w in caught)
        out[(name, "logits")] = lm.gather_logits(logits, recipe, B).numpy()
        out[(name, "aux")] = float(aux)
        out[(name, "residual")] = seen["attn_block"]
        out[(name, "cross_residual")] = seen["cross_block"]
        out[(name, "chunk")] = (batch_rows(recipe, B)[2],
                                ragged_seq_extents(S, shape[1])[0], cfg.d_model)
        with use_recipe(recipe):
            loss, metrics, grads = trainer._accum_loss_grads(shards, local_batch(recipe, b),
                                                             cfg, 1)
        out[(name, "loss")] = float(loss)
        out[(name, "metrics")] = {k: float(v) for k, v in metrics.items()}
        out[(name, "grads")] = [g.numpy() for g in tree_leaves(
            gather_params(grads, lm.build_specs(cfg), recipe))]
    return out


def checkpoint_inputs(arch, shape="train_4k", *, layers=2, attn_mode="auto"):
    """The tensors each checkpoint is handed (the blocks', and the hybrid's
    and the VLM's groups') in the port's dry run of rank 0 of a fake 16 x
    16 world, ``arch`` cut to ``layers`` layers under ``attn_mode``, as
    ``(shape, dtype)``."""
    import torch

    from repro_torch.launch import dryrun
    from repro_torch.models import lm

    seen = []
    real = lm.checkpoint

    def spy(fn, *args, **kw):
        seen.append([(tuple(a.shape), a.dtype) for a in args if isinstance(a, torch.Tensor)])
        return real(fn, *args, **kw)

    lm.checkpoint = spy
    try:
        dryrun.lower_cell(arch, shape, sets=[f"n_layers={layers}"], attn_mode=attn_mode,
                          verbose=False)
    finally:
        lm.checkpoint = real
    return seen
