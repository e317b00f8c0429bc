"""The training step's float32 transients: RMSNorm keeps no float32 copy of
its input, the placed MoE builds only its own experts' dispatch rows and
combines without a ``(T, k, m)`` float32 product, and the loss upcasts its
logits block in row chunks; each against what it replaces.

* RMSNorm (``blocks.rmsnorm``, a Function saving ``x`` in its own dtype and
  the float32 ``(..., 1)`` reciprocal root, its backward by row chunks):
  its output and the gradients of its input and weight have the
  composite's bits, at float32 and bf16 activations and float32 and bf16
  weights, in one chunk and in chunks of 7 rows.
* The placed MoE (``ffn.moe_placed``) on 4 gloo ranks of ``(2, 2)`` and
  ``(1, 4)`` meshes, phi3.5-moe SMOKE's widths (4 experts, top-2, capacity
  factor 1 so that choices overflow), the experts cut over ``model``
  (``e``) or their hidden columns (``f``), the dense dispatch and the
  grouped one, float32 and bf16 activations: its output, aux loss and the
  gradients of its input and of every weight equal (``torch.equal``) those
  of the composite it replaces, kept here as the oracle
  (:func:`_moe_placed_composite`: the dispatch buffer of every expert, of
  which the rank runs its own rows, and the combine's float32 partial as
  one ``(T, k, m)`` product summed over ``k``).
* The plain attention (``kernels.ref.flash_attention_ref``, which the
  card's attention backward recomputes through): its graph keeps one
  float32 score-sized storage a KV block (the probabilities), not the
  masked scores too; the running max is detached.
* The dry run's walk of one rank of a ``(4, 4)`` mesh on a fake world of
  16, a training step of bf16 SMOKE configs: no float32 storage with as
  many elements as the rank's logits block is made (phi4-mini with its
  vocab widened to 16,384 so that the block, 2 x 256 x 4,096, dominates;
  ``blocks.UPCAST_CHUNK`` an eighth of it, as the 256 MiB chunk is a small share
  of a train_4k block); and phi3.5-moe's placed MoE makes its dispatch
  buffer with 1/M of the whole buffer's rows, never the whole buffer, and
  no ``(T, k, m)`` float32.
"""
import dataclasses

import numpy as np
import pytest
import torch
import torch.distributed as dist
import torch.nn.functional as F
from torch.profiler import record_function

from _torch_dist import run_gloo
from repro_torch import configs
from repro_torch.core.dims import prod
from repro_torch.core.dist import init_fake_world, make_mesh
from repro_torch.kernels import ref as kref
from repro_torch.launch import op_walk
from repro_torch.models import blocks, ffn, lm
from repro_torch.models.sharding import all_reduce, local_batch, make_recipe
from repro_torch.train.optimizer import OptConfig, init_opt_state
from repro_torch.train.trainer import make_train_step

MOE_ARCH = "phi3.5-moe-42b-a6.6b"
MOE_MESHES = [(2, 2), (1, 4)]
MOE_CASES = [(cut, groups, dtype) for cut in ("e", "f") for groups in (0, 2)
             for dtype in ("float32", "bfloat16")]
MOE_B, MOE_S, MOE_CF = 4, 16, 1.0


# ------------------------------------------------------------- RMSNorm ----

def _rmsnorm_composite(w, x, eps: float = 1e-5):
    xf = x.float()
    v = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(v + eps)).to(x.dtype) * w.to(x.dtype)


def _bits(t):
    return t.contiguous().view(torch.int16 if t.dtype == torch.bfloat16 else torch.int32)


@pytest.mark.parametrize("rows", [None, 7], ids=["one-chunk", "7-row-chunks"])
@pytest.mark.parametrize("xdt,wdt", [(torch.float32, torch.float32),
                                     (torch.bfloat16, torch.float32),
                                     (torch.bfloat16, torch.bfloat16),
                                     (torch.float32, torch.bfloat16)],
                         ids=["f32-f32", "bf16-f32", "bf16-bf16", "f32-bf16"])
def test_rmsnorm_is_the_composite_bitwise(monkeypatch, xdt, wdt, rows):
    if rows is not None:  # 87 rows: 12 chunks of 7 and a ragged 3
        monkeypatch.setattr(blocks, "UPCAST_CHUNK", rows * 96)
    rng = np.random.default_rng(0)
    x0 = torch.from_numpy(rng.standard_normal((3, 29, 96)).astype(np.float32) * 3)
    x0[0, 0] = 0.0  # a zero row: the root of eps alone
    w0 = torch.from_numpy(rng.random(96).astype(np.float32) + 0.5)
    g0 = torch.from_numpy(rng.standard_normal((3, 29, 96)).astype(np.float32))
    runs = []
    for fn in (blocks.rmsnorm, _rmsnorm_composite):
        x, w = x0.to(xdt).requires_grad_(), w0.to(wdt).requires_grad_()
        y = fn(w, x)
        runs.append((y, *torch.autograd.grad(y, (x, w), g0.to(y.dtype))))
    for got, want, name in zip(*runs, ("y", "dx", "dw")):
        assert got.dtype == want.dtype, name
        assert torch.equal(_bits(got), _bits(want)), name


def test_rmsnorm_saves_its_input_and_no_float32_copy():
    x = torch.ones((2, 8, 16), dtype=torch.bfloat16, requires_grad=True)
    w = torch.ones(16, requires_grad=True)
    y = blocks.rmsnorm(w, x)
    saved = y.grad_fn.saved_tensors
    assert saved[0] is x or saved[0].data_ptr() == x.data_ptr()
    assert all(t.numel() < x.numel() or t.dtype != torch.float32 for t in saved)


# --------------------------------------------------- the plain attention ----

def test_plain_attention_keeps_one_score_block_a_kv_block():
    rng = np.random.default_rng(1)
    B, G, rep, S, D, bk = 2, 2, 3, 48, 8, 16
    q = torch.from_numpy(rng.standard_normal((B, G * rep, S, D)).astype(np.float32))
    k, v = (torch.from_numpy(rng.standard_normal((B, G, S, D)).astype(np.float32))
            for _ in range(2))
    saved = {}

    def pack(t):
        if t.dtype == torch.float32 and t.numel() == B * G * rep * S * bk:
            saved[t.untyped_storage().data_ptr()] = t
        return t

    with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
        out = kref.flash_attention_ref(*(t.requires_grad_() for t in (q, k, v)), block=bk)
    assert len(saved) == S // bk  # the probabilities of each block
    assert out.grad_fn is not None


# -------------------------------------------------------- the placed MoE ----

def _moe_placed_composite(p, x, *, place, n_experts: int, d_ff: int, top_k: int,
                          capacity_factor: float, groups: int, aux_loss_weight: float = 0.01):
    """``ffn.moe_placed``'s capacity dispatch with ``model`` cut, as a
    composite: every expert's dispatch rows built, this rank's experts'
    rows taken from them, and the float32 partial of the combine one
    ``(T, k, m)`` product summed over ``k``."""
    mesh = place.mesh
    Bl, S, m = x.shape
    D = prod(mesh.shape[a] for a in place.batch_axes)
    B, E = Bl * D, n_experts
    El = p["w_gate"].shape[0]
    split = place.M > 1 and (El != E or p["w_gate"].shape[2] != d_ff)
    assert split
    grouped = bool(groups) and groups > 1 and S > 1 and B % groups == 0
    gather = S > 1 and D > 1 and (not grouped or Bl % (B // groups))
    xr = place.gather_rows(x) if gather else x
    Br = xr.shape[0]
    G = (groups * Br) // B if grouped else 1
    Tg = Br * S // G
    C = int(max(top_k, round(top_k * (B * S // (groups if grouped else 1)) / E
                             * capacity_factor)))
    router = place.block(p["router"], 1, 0, E, E, split=False)
    xg = xr.reshape(G, Tg, m)
    with record_function("moe.route"):
        probs, gate_vals, gate_idx = ffn._route(xg, router, top_k)
        own = slice(place.row0 * S, (place.row0 + Bl) * S) if gather else slice(None)
        sums = torch.cat([probs.reshape(-1, E)[own].sum(0),
                          ffn._top1_load(gate_idx.reshape(-1, top_k)[own], E)])
        for a in place.batch_axes:
            sums = all_reduce(sums, mesh, a)
        aux = ffn._aux(sums, B * S, E, aux_loss_weight)
        pos = ffn._positions(gate_idx, E)
        w = (pos < C).to(x.dtype)
        group0 = torch.arange(G, device=x.device)[:, None, None] * (E * C)
        slot = group0 + gate_idx * C + pos.clamp_max(C - 1)
        xe = place.enter_model(xg)
        buf = x.new_zeros((G * E * C, m)).index_add_(
            0, slot.reshape(-1), (xe[:, :, None, :] * w[..., None]).reshape(-1, m))
    e0 = place.mr * El if El != E else 0
    with record_function("moe.experts"):
        be = buf.view(G, E, C, m)[:, e0:e0 + El].transpose(0, 1).reshape(El, G * C, m)
        if El == E:
            h = F.silu(torch.bmm(be, p["w_gate"].to(x.dtype))) * \
                torch.bmm(be, p["w_up"].to(x.dtype))
            ye = torch.bmm(h.float(), p["w_down"].float())
        else:
            ye = ffn._experts(be, p["w_gate"], p["w_up"], p["w_down"])
        ye = ye.view(El, G, C, m).transpose(0, 1).reshape(G * El * C, m)
    with record_function("moe.combine"):
        mine = (gate_idx >= e0) & (gate_idx < e0 + El)
        local = (torch.arange(G, device=x.device)[:, None, None] * (El * C)
                 + (gate_idx - e0).clamp(0, El - 1) * C + pos.clamp_max(C - 1))
        gv = place.enter_model(gate_vals)
        wk = (gv.to(x.dtype) * (w * mine.to(x.dtype))).reshape(-1, top_k)
        yt = ye[local.reshape(-1)].reshape(-1, top_k, m)
        y = (yt.float() * wk.float()[..., None]).sum(dim=1).reshape(Br, S, m)
    if gather:
        y = place.local_rows(y)
    return place.sum_model(y).to(x.dtype), aux


def _cut(name, t, cut, mr, M):
    """This ``model`` rank's block of a whole MoE weight: the experts
    (``e``, the router's columns too) or the hidden columns (``f``)."""
    if cut == "e":
        dim = 1 if name == "router" else 0
    else:
        dim = {"w_gate": 2, "w_up": 2, "w_down": 1}.get(name)
    if dim is None:
        return t
    n = t.shape[dim] // M
    return t.narrow(dim, mr * n, n)


def moe_worker(*, shape, weights, x, cot, cases) -> dict:
    """On this rank of a ``shape`` mesh: ``ffn.moe_placed`` and the
    composite on the rank's rows of ``x`` and its cut of ``weights`` (float32
    leaves), with the gradients of ``sum(y * cot) + aux``; for each case
    ``(cut, groups, dtype)``, whether each result (``y``, aux, the input's
    gradient, each weight's) is equal."""
    from repro_torch.models.sharding import placement

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    cfg = configs.get(MOE_ARCH, smoke=True)
    place = placement(make_recipe(cfg, mesh), x.shape[0])
    rows = place.local_rows(torch.from_numpy(x))
    cot_rows = place.local_rows(torch.from_numpy(cot))
    out = {}
    for cut, groups, dtype in cases:
        runs = []
        for fn in (ffn.moe_placed, _moe_placed_composite):
            p = {k: _cut(k, torch.from_numpy(v), cut, place.mr, place.M).clone()
                 .requires_grad_() for k, v in weights.items()}
            xr = rows.to(getattr(torch, dtype)).clone().requires_grad_()
            y, aux = fn(p, xr, place=place, n_experts=cfg.n_experts, d_ff=cfg.d_ff, top_k=2,
                        capacity_factor=MOE_CF, groups=groups)
            ((y.float() * cot_rows).sum() + aux).backward()
            runs.append([y.detach(), aux.detach(), xr.grad] + [p[k].grad for k in sorted(p)])
        out[(cut, groups, dtype)] = [bool(torch.equal(a, b)) for a, b in zip(*runs)]
    return out


@pytest.fixture(scope="module")
def moe_runs(tmp_path_factory):
    cfg = configs.get(MOE_ARCH, smoke=True)
    m, f, E = cfg.d_model, cfg.d_ff, cfg.n_experts
    rng = np.random.default_rng(32)
    mk = lambda *s, scale=1.0: (rng.standard_normal(s) * scale).astype(np.float32)
    weights = {"router": mk(m, E, scale=0.5), "w_gate": mk(E, m, f, scale=m ** -0.5),
               "w_up": mk(E, m, f, scale=m ** -0.5), "w_down": mk(E, f, m, scale=f ** -0.5)}
    x, cot = mk(MOE_B, MOE_S, m), mk(MOE_B, MOE_S, m)
    return {shape: run_gloo("test_torch_train_transients:moe_worker", 4,
                            tmp_path_factory.mktemp("gloo_moe_placed"), shape=shape,
                            weights=weights, x=x, cot=cot, cases=MOE_CASES)
            for shape in MOE_MESHES}


@pytest.mark.parametrize("shape", MOE_MESHES, ids=[f"{d}x{m}" for d, m in MOE_MESHES])
@pytest.mark.parametrize("case", MOE_CASES, ids=[f"{c}-g{g}-{d}" for c, g, d in MOE_CASES])
def test_moe_placed_is_the_composite_bitwise(moe_runs, shape, case):
    names = ["y", "aux", "dx", "d_router", "d_w_down", "d_w_gate", "d_w_up"]
    for rank, got in enumerate(moe_runs[shape]):
        assert got[case] == [True] * len(names), (rank, list(zip(names, got[case])))


# ------------------------------------------------------------ the dry run ----

class _Made(op_walk.OpWalk):
    """An :class:`OpWalk` that lists the op, shape and dtype of every
    storage made during the walk."""

    def __init__(self):
        super().__init__()
        self.made: list = []
        self._op = None

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        self._op = func.overloadpacket.__name__
        return super().__torch_dispatch__(func, types, args, kwargs)

    def _storage(self, t, fresh):
        if fresh and t.untyped_storage()._cdata not in self._sid:
            self.made.append((self._op, tuple(t.shape), t.dtype))
        return super()._storage(t, fresh)


@pytest.fixture
def world():
    yield
    if dist.is_initialized():
        dist.destroy_process_group()


def _walk_train_step(cfg, B, S):
    init_fake_world(16, 0, "cpu")
    recipe = make_recipe(cfg, make_mesh((4, 4), ("data", "model"), device="cpu"),
                         attn_mode="tp")
    with torch._subclasses.fake_tensor.FakeTensorMode():
        params = lm.abstract_model(cfg, recipe=recipe, device="cpu")
        batch = local_batch(recipe, {k: torch.empty((B, S), dtype=torch.int32)
                                     for k in ("tokens", "labels")})
        ocfg = OptConfig()
        opt = init_opt_state(params, ocfg)
        with _Made() as walk:
            make_train_step(cfg, recipe, ocfg)(params, opt, batch)
    return walk


def test_dry_run_loss_makes_no_float32_logits_block(world, monkeypatch):
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True), vocab=16384,
                              act_dtype=torch.bfloat16)
    B, S = 8, 256
    block = (B // 4) * S * (cfg.vocab_padded // 4)
    monkeypatch.setattr(blocks, "UPCAST_CHUNK", block // 8)
    walk = _walk_train_step(cfg, B, S)
    assert any(dt == torch.bfloat16 and prod(shape) == block for _, shape, dt in walk.made)
    big = [m for m in walk.made if m[2] == torch.float32 and prod(m[1]) >= block]
    assert not big, big[:4]


def test_dry_run_moe_dispatch_buffer_is_the_ranks_experts(world):
    cfg = dataclasses.replace(configs.get(MOE_ARCH, smoke=True), act_dtype=torch.bfloat16)
    B, S, M, k = 8, 64, 4, cfg.moe_top_k
    T = B * S  # the dense dispatch routes the rows gathered over data
    C = round(k * T / cfg.n_experts * cfg.moe_capacity_factor)
    whole = (cfg.n_experts * C, cfg.d_model)
    walk = _walk_train_step(cfg, B, S)
    buffers = [shape for op, shape, _ in walk.made if op == "new_zeros"]
    assert (whole[0] // M, whole[1]) in buffers, buffers
    assert whole not in buffers
    assert not [m for m in walk.made if m[2] == torch.float32 and m[1] == (T, k, cfg.d_model)]
