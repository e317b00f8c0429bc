"""Continuous-batching engine on the port's dense, MoE, MLA, audio, SSM
and hybrid models, single-host, or with tensor-parallel decode for the
dense and audio families.

A fixed pool of batch *slots* shares one cache allocation (K/V, or MLA's
latent and rope-key caches) tracked by a
:class:`repro_torch.serve.kv.KVLedger` (per-request lengths over uniform
capacity tiles).  Finished sequences free their slot and the next queued
request is prefilled into it.  The audio family (``embeds`` input) takes
a request as frame embeddings, token ids or both: ids alone are featurized
(:func:`_np_sinusoidal`, or the engine's ``featurizer``), and every sampled
token is featurized to feed the next step.

  * **admission-time prefill** runs the newly admitted prompts (all but
    their last token) as one masked chunk through
    ``lm.decode_step(prefill=True)``, padded to a power of two; the MoE
    family prefills token by token, as the reference does, because a chunk
    would go through the capacity dispatch and could drop tokens that the
    dropless decode step keeps, and so do the SSM and hybrid families,
    whose recurrent state would take a chunk's padding;
  * **decode** feeds each resident slot's last token through
    ``lm.decode_step``, or, given a ``(data, model)`` mesh and
    ``microbatches``, through the explicit tensor-parallel step of
    :mod:`repro_torch.serve.tp_decode` (per-layer ``Iallreduce`` of the
    partial projections staggered behind the next microbatch's compute, one
    ``Iallgather`` of the vocab-sharded logits), and samples the next one.

Under a mesh every rank runs this same engine loop on the same requests:
prefill is the single-host program on the whole weights on every rank, as
in the reference, and every rank gets every slot's logits, so all ranks
sample the same tokens.  On a card both paths go through the split-KV
decode kernel (the MLA family's absorbed decode and the SSM family run no
kernel, as in the reference; the hybrid's shared attention block runs it
once an application).  A released slot's recurrent state is zeroed before
its next request (:func:`_reset_slot_rows`).  The engine keeps an activation-dtype copy of the weights,
made once (``weights.cast_params``), and cuts the rank's TP shard from it
(``weights.shard_params``; a view when the ``model`` axis has one rank).

Under a sharding ``recipe`` (every family the engine serves) every
rank hands the engine its shards of the weights
(``weights.shard_params_by_recipe``) and runs prefill and decode as
``lm.decode_step`` under the recipe, as the reference's ``gspmd_step``
does: the caches and recurrent states are the rank's blocks
(``lm.init_cache`` under the recipe; a released slot's rows are zeroed on
the rank that holds them), each step returns the rank's block of the
logits, and only the sampled position is gathered whole
(``lm.last_logits``), so all ranks sample the same tokens; each step's
inputs (token ids, or the audio family's frames) are cut to the rank's
rows on the host (``sharding.local_batch(..., decode=True)``) and only
those reach the device.  A whole-prompt prefill
chunk under ``sp_ring`` runs the ring.  A ``recipe`` with a ``mesh`` (the
recipe's own) and ``microbatches`` is the reference's mix: prefill under
the recipe, decode through the explicit TP step, both on the recipe's
cache blocks, one allocation.  The pair is taken where the two blocks are
one: the recipe cuts the rows over ``data`` and the KV groups over
``model`` exactly as the TP step does (:func:`tp_decode.tp_block`),
which holds for the dense and audio families wherever the TP step accepts
the mesh; the TP step's weights are cut once, at construction, from the
recipe's shards gathered back (a transient whole copy across ranks; views
on a mesh of one rank).  The VLM family is refused: the reference's engine
builds no ``image_embeds`` batch, so its VLM ``decode_step`` cannot be
served there (ROADMAP.md §3); the VLM is served through ``lm.init_cache``
and ``lm.decode_step`` directly, under a recipe too.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.dims import mixed_radix_join
from repro_torch.data.pipeline import to_device
from repro_torch.models import lm
from repro_torch.models.attention import KVCache
from repro_torch.models.module import tree_leaves
from repro_torch.models.sharding import (decode_state_shardings, local_batch, placement,
                                        use_recipe)
from repro_torch.models.weights import cast_params, gather_params, shard_params
from repro_torch.serve.kv import KVLedger
from repro_torch.serve.tp_decode import make_tp_decode_step, tp_block, tp_decode_specs

__all__ = ["ServeConfig", "Engine", "check_servable"]

# families whose decode step takes multi-token chunks exactly; the MoE's
# capacity dispatch could drop a chunk's tokens, and recurrent state (ssm,
# hybrid) would take a chunk's padding, so they prefill per token
_CHUNK_FAMILIES = ("dense", "audio", "mla")


@dataclasses.dataclass
class ServeConfig:
    max_len: int = 512
    batch_slots: int = 4
    temperature: float = 0.0  # 0 = greedy
    eos_token: int = 1
    seed: int = 0


@dataclasses.dataclass
class _Slot:
    request_id: int | None = None
    tokens: list = dataclasses.field(default_factory=list)
    remaining: int = 0
    next_embed: np.ndarray | None = None  # (m,) float32: an embeds model's next feed


def _np_sinusoidal(ids, d: int) -> np.ndarray:
    """The engine's token-id featurizer for ``embeds``-input models, the
    stand-in for a codec front end (the reference's, in numpy as there):
    ``[sin, cos]`` of the ids times ``d // 2`` frequencies, float32, so
    distinct ids map to distinct embeddings and generation depends on the
    prompt."""
    ids = np.asarray(ids, np.float32)
    half = d // 2
    freq = np.exp(-np.log(10000.0) * np.arange(half, dtype=np.float32) / half)
    ang = ids[..., None] * freq
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _kv_bytes_per_pos(cfg) -> int:
    """Cache bytes one sequence position costs across all layers (0 for
    families whose state does not grow with length)."""
    item = torch.empty((), dtype=cfg.act_dtype).element_size()
    if cfg.family in ("dense", "moe", "audio", "vlm"):
        return 2 * cfg.n_layers * cfg.n_kv * cfg.head_dim * item
    if cfg.family == "mla":
        return cfg.n_layers * (cfg.mla_kv_rank + cfg.mla_d_rope) * item
    return 0


# a state leaf's batch axis, counted from its trailing end, so that it holds
# under any stacking of layers and super-blocks; the length-masked payloads
# (k, v, c, kr) are left as they are
_BATCH_AXIS_FROM_END = {"length": 1, "wkv": 4, "ssm": 4, "shift": 2, "cm_shift": 2, "conv": 3}
_MASKED_PAYLOADS = ("k", "v", "c", "kr")


def _reset_slot_rows(caches, i: int, rows: tuple[int, int, int] | None = None) -> None:
    """Release slot ``i`` for a new request, in place: zero its rows of
    every leaf that no cache length masks (the recurrent, shift and conv
    states, which carry forward, so a released slot's state must not leak
    into its successor) and of the lengths.  The K/V (or latent) payload
    stays; the attention mask never reads past the length.

    ``rows`` ``(B, row0, n_rows)``: a sharding recipe's batch axes cut the
    B slots, and a leaf that holds ``n_rows < B`` rows holds this rank's
    slots ``[row0, row0 + n_rows)``: slot ``i`` is zeroed there at its
    local row, or nowhere when it lives on another rank; a leaf of B rows
    (the lengths) is whole."""
    if isinstance(caches, dict):
        for c in caches.values():
            _reset_slot_rows(c, i, rows)
        return
    for name, x in zip(caches._fields, caches):
        if isinstance(x, tuple):
            _reset_slot_rows(x, i, rows)
        elif name in _BATCH_AXIS_FROM_END:
            axis = x.ndim - _BATCH_AXIS_FROM_END[name]
            j = i
            if rows is not None and x.shape[axis] != rows[0]:
                j = i - rows[1]
                if not 0 <= j < rows[2]:
                    continue
            x.select(axis, j).zero_()
        elif name not in _MASKED_PAYLOADS:
            raise ValueError(f"unknown cache leaf {name!r}")


def _check_pair_blocks(cfg, recipe, mesh, B: int, max_len: int) -> None:
    """Refuse a ``recipe`` with the explicit TP decode on ``mesh`` unless the
    recipe's block of the K/V (its rows, :func:`placement`, and the cut of
    ``lm.init_cache``'s K/V) is the TP step's block (:func:`tp_block`): the
    same rows and KV groups, in the same order, every other axis whole."""
    rows, groups = tp_block(cfg, mesh, B)
    place = placement(recipe, B)
    whole = torch.empty((cfg.n_layers, B, cfg.n_kv, max_len, cfg.head_dim), device="meta")
    spec = decode_state_shardings(recipe, KVCache(whole, whole, whole)).k
    coords, got = mesh.coords(), []
    for n, entry in zip(whole.shape, spec):
        axes = () if entry is None else (entry,) if isinstance(entry, str) else tuple(entry)
        size = n // math.prod(mesh.shape[a] for a in axes)
        i = mixed_radix_join([coords[a] for a in axes], [mesh.shape[a] for a in axes])
        got.append((i * size, (i + 1) * size))
    want = [(0, cfg.n_layers), (rows.start, rows.stop), (groups.start, groups.stop),
            (0, max_len), (0, cfg.head_dim)]
    if (place.row0, place.row0 + place.n_rows) != want[1] or got != want:
        raise ValueError(
            f"Engine: the recipe's K/V block (spec {spec}, rows {place.row0}:"
            f"{place.row0 + place.n_rows}) is not the tensor-parallel decode's (rows "
            f"{rows.start}:{rows.stop}, KV groups {groups.start}:{groups.stop})")


def check_servable(cfg) -> None:
    """Raises ``NotImplementedError`` for the VLM family, which the engine
    does not serve."""
    if cfg.family == "vlm":
        raise NotImplementedError(
            "the engine serves no VLM: the reference's engine builds no image_embeds batch "
            "(ROADMAP.md §3); serve it through lm.init_cache and lm.decode_step")


class Engine:
    """Slot-based continuous batching over the shared decode path.

    ``params`` is the model's whole parameter tree on the device the engine
    runs on, or under ``recipe`` (a
    :class:`repro_torch.models.sharding.Recipe`) this rank's shards of it;
    every rank of the recipe's mesh runs the engine on the same requests.
    ``mesh`` (a :class:`repro_torch.core.dist.Mesh` with ``data`` and
    ``model`` axes, on the same device) and ``microbatches`` switch decode
    to the explicit tensor-parallel step; every rank of the mesh runs the
    engine on the same requests.  With a ``recipe`` too, ``mesh`` must be
    ``recipe.mesh``: prefill stays under the recipe, decode takes the TP
    step, and ``tp_params`` is the TP step's cut of the gathered shards.
    Temperature sampling draws from
    a ``torch.Generator`` seeded from ``ServeConfig.seed`` (its numbers are
    not JAX's; greedy decoding is what is held against the reference).
    ``featurizer`` maps a list of token ids to (n, d_model) float32 frame
    embeddings for an ``embeds``-input model (default
    :func:`_np_sinusoidal`).

    Counters: ``steps`` counts the prefill chunks and decode steps run.
    """

    def __init__(self, cfg, params, scfg: ServeConfig, recipe=None, *, mesh=None,
                 microbatches: int = 0, featurizer=None):
        check_servable(cfg)
        if (mesh is None) != (not microbatches):
            raise ValueError("tensor-parallel decode needs both a (data, model) mesh and "
                             f"microbatches >= 1 (got mesh={mesh!r}, microbatches={microbatches})")
        if mesh is not None and cfg.n_experts:
            raise ValueError("tensor-parallel decode: MoE blocks not supported")
        if recipe is not None and mesh is not None and recipe.mesh is not mesh:
            raise ValueError("Engine: a recipe with the tensor-parallel decode must be cut on "
                             "its mesh (recipe.mesh is not mesh)")
        self.cfg = cfg
        self.scfg = scfg
        self.recipe = recipe
        self.device = tree_leaves(params)[0].device
        self.params = cast_params(params, cfg.act_dtype)
        B = scfg.batch_slots
        self._tp = None
        if mesh is not None:
            self._tp = make_tp_decode_step(cfg, mesh, slots=B, microbatches=microbatches,
                                           attn_impl=cfg.attn_impl)
            whole = self.params
            if recipe is not None:
                _check_pair_blocks(cfg, recipe, mesh, B, scfg.max_len)
                whole = gather_params(self.params, lm.build_specs(cfg), recipe)
            self.tp_params = shard_params(whole, tp_decode_specs(cfg)[0], mesh)
        with use_recipe(recipe):
            caches = lm.init_cache(cfg, B, scfg.max_len, device=self.device)
        self._rows = None
        if recipe is not None:  # the slots this rank's blocks of the states hold
            place = placement(recipe, B)
            self._rows = (B, place.row0, place.n_rows)
        self.state = lm.DecodeState(
            caches=caches, positions=torch.zeros((B,), dtype=torch.int32, device=self.device))
        self.slots = [_Slot() for _ in range(B)]
        self.queue: list[tuple[int, list[int], np.ndarray | None, int]] = []
        self.finished: dict[int, list[int]] = {}
        self.ledger = KVLedger(slots=B, max_len=scfg.max_len, bytes_per_pos=_kv_bytes_per_pos(cfg))
        self._gen = torch.Generator(device=self.device).manual_seed(scfg.seed)
        self.steps = {"prefill": 0, "decode": 0}
        self._embeds_in = cfg.input_kind == "embeds"
        self._featurize = featurizer or (lambda ids: _np_sinusoidal(ids, cfg.d_model))

    # ------------------------------------------------------------ public ----
    def submit(self, request_id: int, prompt: list[int] | None = None,
               max_new_tokens: int = 16, prompt_embeds=None) -> None:
        """Queue a request: a token-id ``prompt`` and how many tokens to add.
        An ``embeds``-input model may take ``prompt_embeds`` (P, d_model)
        instead of the ids, or beside them (they are then the request's
        leading tokens); ids alone are featurized."""
        if prompt is None and prompt_embeds is None:
            raise ValueError("submit needs a prompt and/or prompt_embeds")
        prompt = list(prompt) if prompt is not None else []
        if prompt_embeds is not None:
            prompt_embeds = np.asarray(prompt_embeds, np.float32)
            if prompt_embeds.ndim != 2 or prompt_embeds.shape[1] != self.cfg.d_model:
                raise ValueError(f"prompt_embeds must be (P, {self.cfg.d_model})")
        elif self._embeds_in:
            prompt_embeds = self._featurize(prompt)
        plen = len(prompt_embeds) if prompt_embeds is not None else len(prompt)
        if not plen:
            raise ValueError("submit needs a non-empty prompt")
        if plen + max_new_tokens > self.scfg.max_len:
            raise ValueError(
                f"request {request_id}: prompt {plen} + {max_new_tokens} new "
                f"exceeds max_len {self.scfg.max_len}"
            )
        self.queue.append((request_id, prompt, prompt_embeds, max_new_tokens))

    @property
    def in_flight(self) -> dict[int, list[int]]:
        """Partial outputs of requests still resident in slots."""
        return {s.request_id: list(s.tokens) for s in self.slots if s.request_id is not None}

    def run(self, max_steps: int = 10_000) -> dict[int, list[int]]:
        """Drive admission + decode until the queue drains or ``max_steps``
        decode steps have run.  Returns the finished map; anything still
        resident is reported via :attr:`in_flight`."""
        steps = 0
        while (self.queue or self.in_flight) and steps < max_steps:
            self._fill_slots()
            self._decode_once()
            steps += 1
        return self.finished

    # ---------------------------------------------------------- internals ----
    def _step(self, inputs: np.ndarray, counts: np.ndarray, *, prefill: bool,
              whole_prompt: bool = False):
        """One step of ``lm.decode_step`` on ``inputs``, token ids (B, S) or
        an ``embeds`` model's frames (B, S, m); ``prefill`` counts it as a
        prefill step, and only a ``whole_prompt`` chunk (every active row
        from position 0) is passed on as ``prefill=True``, which under an
        ``sp_ring`` recipe rings the chunk's fresh Q/K/V alone: a per-token
        prefill step attends over its row's cache like a decode step."""
        batch = {"embeds" if self._embeds_in else "tokens": inputs}
        counts = torch.from_numpy(counts).to(self.device)
        tp = self._tp is not None and not prefill
        if self.recipe is not None and not tp:  # the rank's rows, cut on the host
            batch = local_batch(self.recipe, batch, decode=True)
        batch = to_device(batch, self.device)
        if tp:
            logits, self.state = self._tp(self.tp_params, self.state, batch, counts > 0)
        else:
            with use_recipe(self.recipe):
                logits, self.state = lm.decode_step(self.params, self.state, batch, self.cfg,
                                                    new_counts=counts, prefill=whole_prompt)
        self.steps["prefill" if prefill else "decode"] += 1
        return logits

    def last_logits(self, logits, counts: np.ndarray, *, prefill: bool):
        """``(B, vocab_padded)``: each slot's logits at its last valid
        position from a step's ``logits`` and its ``counts``.  The TP decode
        step's are whole; ``lm.decode_step``'s under a recipe are the rank's
        block, whose sampled positions alone are gathered
        (``lm.last_logits``)."""
        if self._tp is not None and not prefill:
            return logits[:, -1]
        return lm.last_logits(logits, torch.from_numpy(counts), self.recipe)

    def _fill_slots(self) -> None:
        newly: list[tuple[int, list[int], np.ndarray | None]] = []
        for i, slot in enumerate(self.slots):
            if slot.request_id is None and self.queue:
                rid, prompt, embeds, max_new = self.queue.pop(0)
                self.ledger.admit(i, len(embeds) if embeds is not None else len(prompt),
                                  max_new)
                slot.request_id = rid
                slot.tokens = list(prompt)
                slot.remaining = max_new
                slot.next_embed = embeds[-1] if embeds is not None else None
                _reset_slot_rows(self.state.caches, i, self._rows)
                self.state.positions[i] = 0
                newly.append((i, prompt, embeds))
        if newly:
            self._prefill(newly)

    def _buffer(self, S: int) -> np.ndarray:
        """Zeros for a step's inputs: token ids (B, S), or frames (B, S, m)."""
        B = self.scfg.batch_slots
        if self._embeds_in:
            return np.zeros((B, S, self.cfg.d_model), np.float32)
        return np.zeros((B, S), np.int64)

    def _prefill(self, newly) -> None:
        """Admission-time batched prefill of all newly filled slots (each
        prompt's ids or frames but the last), as one chunk padded to a power
        of two, or for the MoE and recurrent families one input of every
        feed a step; only the target slots write their cache rows
        (``new_counts``)."""
        B = self.scfg.batch_slots
        feeds = [(i, embeds[:-1] if embeds is not None else prompt[:-1])
                 for i, prompt, embeds in newly]
        feeds = [(i, f) for i, f in feeds if len(f)]
        if not feeds:
            return
        S = max(len(f) for _, f in feeds)
        if self.cfg.family in _CHUNK_FAMILIES:
            S = min(self.scfg.max_len, 1 << (S - 1).bit_length())  # bucket, like the reference
            buf = self._buffer(S)
            counts = np.zeros((B,), np.int32)
            for i, feed in feeds:
                buf[i, : len(feed)] = feed
                counts[i] = len(feed)
            self._step(buf, counts, prefill=True, whole_prompt=True)
            for i, feed in feeds:
                self.ledger.advance(i, len(feed))
            return
        for t in range(S):
            buf = self._buffer(1)
            counts = np.zeros((B,), np.int32)
            for i, feed in feeds:
                if t < len(feed):
                    buf[i, 0] = feed[t]
                    counts[i] = 1
                    self.ledger.advance(i, 1)
            self._step(buf, counts, prefill=True)

    def _decode_once(self) -> None:
        B = self.scfg.batch_slots
        counts = np.zeros((B,), np.int32)
        buf = self._buffer(1)
        for i, slot in enumerate(self.slots):
            if slot.request_id is not None:
                counts[i] = 1
                if self._embeds_in:
                    buf[i, 0] = (slot.next_embed if slot.next_embed is not None
                                 else self._featurize([slot.tokens[-1]])[0])
                else:
                    buf[i, 0] = slot.tokens[-1]
        logits = self.last_logits(self._step(buf, counts, prefill=False), counts,
                                  prefill=False)[:, : self.cfg.vocab]  # strip pad
        if self.scfg.temperature > 0:
            probs = torch.softmax(logits.float() / self.scfg.temperature, dim=-1)
            nxt = torch.multinomial(probs, 1, generator=self._gen)[:, 0].tolist()
        else:
            nxt = torch.argmax(logits, dim=-1).tolist()
        for i, slot in enumerate(self.slots):
            if slot.request_id is None:
                continue
            self.ledger.advance(i, 1)
            slot.tokens.append(nxt[i])
            if self._embeds_in:
                slot.next_embed = self._featurize([nxt[i]])[0]
            slot.remaining -= 1
            if nxt[i] == self.scfg.eos_token or slot.remaining <= 0:
                self.finished[slot.request_id] = slot.tokens
                self.ledger.release(i)
                self.slots[i] = _Slot()
