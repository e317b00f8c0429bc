"""Helpers for the port's multi-process tests: run a worker function of this
module on N gloo ranks, each a fresh CPU-only Python process.

The ranks meet through a ``file://`` rendezvous in a per-test directory (no
fixed port, so tests can run side by side), compute with one thread each,
and pickle their results back to the same directory.
"""
from __future__ import annotations

import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

TESTS = os.path.dirname(os.path.abspath(__file__))
SRC = os.path.abspath(os.path.join(TESTS, "..", "src"))

LAYOUT_CONFIGS = ["I/I/K", "I/I/J", "I/K/K", "I/K/J", "J/I/K", "J/I/J", "J/K/K", "J/K/J"]


def run_gloo(worker: str, world: int, workdir, *, timeout: float = 300, **kwargs) -> list:
    """Run ``worker(**kwargs)`` on ``world`` gloo ranks; returns the list of
    per-rank results.  Any failing rank fails the call (the others are
    stopped), with every rank's stderr tail in the message."""
    workdir = Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    with open(workdir / "args.pkl", "wb") as f:
        pickle.dump(kwargs, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join([SRC, TESTS] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    procs, logs = [], []
    try:
        for rank in range(world):
            log = open(workdir / f"rank{rank}.log", "w")
            logs.append(log)
            code = f"import _torch_dist; _torch_dist._main({rank}, {world}, {str(workdir)!r}, {worker!r})"
            procs.append(subprocess.Popen([sys.executable, "-c", code], env=env,
                                          stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + timeout
        while any(p.poll() is None for p in procs):
            if any(p.returncode not in (None, 0) for p in procs) or time.monotonic() > deadline:
                break
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        for log in logs:
            log.close()
    if any(p.returncode != 0 for p in procs):
        tails = []
        for rank, p in enumerate(procs):
            text = (workdir / f"rank{rank}.log").read_text()
            tails.append(f"--- rank {rank} (rc={p.returncode}) ---\n{text[-3000:]}")
        raise AssertionError(f"gloo worker {worker!r} failed:\n" + "\n".join(tails))
    out = []
    for rank in range(world):
        with open(workdir / f"rank{rank}.pkl", "rb") as f:  # written by our own workers
            out.append(pickle.load(f))
    return out


def _main(rank: int, world: int, workdir: str, worker: str) -> None:
    import datetime

    import torch
    import torch.distributed as dist

    torch.set_num_threads(1)
    with open(os.path.join(workdir, "args.pkl"), "rb") as f:
        kwargs = pickle.load(f)
    dist.init_process_group("gloo", init_method=f"file://{workdir}/rendezvous", rank=rank,
                            world_size=world, timeout=datetime.timedelta(seconds=120))
    try:
        if ":" in worker:  # "module:function", a worker of another helper module
            import importlib

            mod, name = worker.split(":")
            result = getattr(importlib.import_module(mod), name)(**kwargs)
        else:
            result = globals()[worker](**kwargs)
    finally:
        if dist.is_initialized():  # a launcher run inside the worker may have ended it
            dist.destroy_process_group()
    with open(os.path.join(workdir, f"rank{rank}.pkl"), "wb") as f:
        pickle.dump(result, f)


# -----------------------------------------------------------------------------
# workers (run inside the gloo ranks)
# -----------------------------------------------------------------------------
def gemm_family(*, dims_1d, dims_summa, dims_ragged, grid) -> dict:
    """The distributed GEMM slice on this rank: 1-D GEMM over the world,
    SUMMA and ragged SUMMA on ``grid`` (double-buffered and blocking), in
    every majors configuration, plus this rank's scattered input tiles."""
    import numpy as np
    import torch

    from repro_torch.core import (LayoutError, bag, bag_from_numpy, make_mesh, mpi_traverser,
                                  scatter, scatterv_bag, traverser)
    from repro_torch.core.layout import into_blocks
    from repro_torch.examples import distributed_gemm as g

    world = torch.distributed.get_world_size()
    mesh1 = make_mesh((world,), ("r",), device="cpu")
    mesh2 = make_mesh(grid, ("rows", "cols"), device="cpu")
    out: dict = {"coords": tuple(mesh2.coords().values())}
    for majors in LAYOUT_CONFIGS:
        c_major, a_major, b_major = majors.split("/")
        ni, nj, nk = dims_1d
        out[("panel1d", majors)] = g.run_distributed_gemm(
            ni=ni, nj=nj, nk=nk, majors=majors, mesh=mesh1)[0]
        # this rank's 1-D A tile, scattered as the GEMM scatters it
        rng = np.random.default_rng(7)
        A_np = rng.standard_normal((ni, nk)).astype(np.float32)
        A_layout = g._mat_layout("i", "k", ni, nk, "i" if a_major == "I" else "k")
        A_glob = bag_from_numpy(A_layout, A_np if a_major == "I" else A_np.T, "cpu")
        A_root = bag(A_layout ^ into_blocks("i", "R", num_blocks=world), A_glob.data)
        dt = mpi_traverser("R", traverser(A_root), mesh1)
        A_tile = g._mat_layout("i", "k", ni // world, nk, "i" if a_major == "I" else "k")
        out[("tile_a", "panel1d", majors)] = scatter(A_root, A_tile, dt).data.numpy()

        ni, nj, nk = dims_summa
        for db in (True, False):
            out[("summa", majors, db)] = g.run_summa_gemm(
                ni=ni, nj=nj, nk=nk, grid=grid, majors=majors, mesh=mesh2, double_buffer=db)[0]
        _, meta = g.summa_ring_program(ni=ni, nj=nj, nk=nk, grid=grid, majors=majors, mesh=mesh2)
        A_np, B_np = g._inputs(11, ni, nj, nk, None, None)
        A_glob, B_glob = g._global_bags(meta["A_layout"], meta["B_layout"], A_np, B_np, "cpu")
        out[("tile_a", "summa", majors)] = scatter(
            bag(meta["A_root_l"], A_glob.data), meta["A_tile"], meta["dtA"]).data.numpy()
        out[("tile_b", "summa", majors)] = scatter(
            bag(meta["B_root_l"], B_glob.data), meta["B_tile"], meta["dtB"]).data.numpy()

        ni, nj, nk = dims_ragged
        for db in (True, False):
            out[("ragged", majors, db)] = g.run_ragged_summa_gemm(
                ni=ni, nj=nj, nk=nk, grid=grid, majors=majors, mesh=mesh2, double_buffer=db)[0]
        _, meta = g.ragged_summa_program(ni=ni, nj=nj, nk=nk, grid=grid, majors=majors, mesh=mesh2)
        A_np, B_np = g._inputs(13, ni, nj, nk, None, None)
        A_glob, B_glob = g._global_bags(meta["A_layout"], meta["B_layout"], A_np, B_np, "cpu")
        a_dist = scatterv_bag(A_glob, meta["A_tile"], meta["dtA"], meta["A_ragged"])
        out[("tile_a", "ragged", majors)] = a_dist.data.numpy()
        # the valid view of this rank's own tile; any other rank's is refused
        out[("valid_a", "ragged", majors)] = a_dist.tile(a_dist.coords).data.numpy()
        other = tuple((c + 1) % s for c, s in zip(a_dist.coords, a_dist.grid_shape))
        try:
            a_dist.tile(other)
        except LayoutError:
            pass
        else:
            raise AssertionError("DistBag.tile read another rank's tile")
        out[("tile_b", "ragged", majors)] = scatterv_bag(
            B_glob, meta["B_tile"], meta["dtB"], meta["B_ragged"]).data.numpy()
    return out


def _collective_inputs(np, L, mesh1, mesh2, C):
    """The seeded bags both packages feed the collective checks; ``L`` is the
    layout module and ``C`` the core package of either one."""
    f32 = np.float32
    rng = np.random.default_rng(5)

    def rows(items):  # row-major layout over (dim, extent) pairs, outer first
        layout = L.scalar(f32)
        for d, n in reversed(items):
            layout = layout ^ L.vector(d, n)
        return layout

    grid_root = rows([("Ri", 2), ("Ck", 2), ("i", 4), ("j", 12)])
    dt2 = C.mpi_cart_traverser([("Ri", "rows"), ("Ck", "cols")],
                               C.traverser(rows([("Ri", 2), ("Ck", 2)])), mesh2)
    x = rng.standard_normal((2, 2, 4, 12)).astype(f32)
    panel_root = rows([("Ri", 2), ("Ck", 2), ("i", 4), ("j", 10)])
    p = rng.standard_normal((2, 2, 4, 10)).astype(f32)
    ragged_root = rows([("i", 10), ("j", 5)])
    dt1 = C.mpi_traverser("R", C.traverser(rows([("R", 4), ("i", 3), ("j", 5)])), mesh1)
    y = rng.standard_normal((10, 5)).astype(f32)
    bc = rng.standard_normal((3, 4)).astype(f32)
    # integer values: a sum over four ranks is exact in any order
    z = rng.integers(-8, 9, (4, 4, 5)).astype(f32)
    dtz = C.mpi_traverser("R", C.traverser(rows([("R", 4), ("i", 4), ("j", 5)])), mesh1)
    return dict(rows=rows, dt1=dt1, dt2=dt2, grid_root=grid_root, x=x, panel_root=panel_root,
                p=p, ragged_root=ragged_root, y=y, bc=bc, z=z, dtz=dtz)


def collective_cases(np, L, C, mesh1, mesh2, to_numpy, tile_of):
    """Run the comm layer's collectives beyond the GEMM's use of them, in
    either package, and return ``{case: this rank's tile as numpy, or the
    extents table}``.  ``tile_of(dist_bag)`` reads the rank's padded tile."""
    k = _collective_inputs(np, L, mesh1, mesh2, C)
    rows = k["rows"]
    out = {}
    X = C.scatter(C.bag(k["grid_root"], k["x"]), rows([("i", 4), ("j", 12)]), k["dt2"])
    for op in ("add", "mean", "max", "min"):
        r = C.reduce_scatter_bag(X, rows([("j", 6), ("i", 4)]), scatter_dim="j", op=op,
                                 rank_dim="Ck")
        out[("reduce_scatter", op)] = tile_of(r)
    P = C.scatter(C.bag(k["panel_root"], k["p"]), rows([("i", 4), ("j", 10)]), k["dt2"])
    for op in ("add", "max", "min"):
        r = C.reduce_scatterv_bag(P, rows([("j", 5), ("i", 4)]), scatter_dim="j",
                                  in_blocks=(5, (5, 4)), out_extents=(5, 4), op=op, rank_dim="Ck")
        out[("reduce_scatterv", op)] = tile_of(r)
        out[("reduce_scatterv_extents", op)] = r.extents
    Y = C.scatterv_bag(C.bag(k["ragged_root"], k["y"]), rows([("i", 3), ("j", 5)]), k["dt1"],
                       {"R": ("i", (3, 3, 2, 2))})
    moved = C.permute(Y, [(0, 2), (2, 0), (1, 1)], dst_tile_layout=rows([("j", 5), ("i", 3)]))
    out["permute"], out["permute_extents"] = tile_of(moved), moved.extents
    shifted = C.ring_shift(Y, 1)
    out["ring_shift"], out["ring_shift_extents"] = tile_of(shifted), shifted.extents
    out["gatherv"] = to_numpy(C.gatherv_bag(Y, rows([("j", 5), ("i", 10)])).data)
    b = C.broadcast(C.bag(rows([("i", 3), ("j", 4)]), k["bc"]), k["dt1"],
                    dst_layout=rows([("j", 4), ("i", 3)]))
    out["broadcast"] = to_numpy(b.data)
    # all-gather into a receive layout that differs from the sender's, per
    # rank too; along one dim of the grid
    Z = C.scatter(C.bag(rows([("R", 4), ("i", 4), ("j", 5)]), k["z"]),
                  rows([("j", 5), ("i", 4)]), k["dtz"])
    out["all_gather_bag"] = to_numpy(C.all_gather_bag(Z, rows([("j", 5), ("R", 4), ("i", 4)])).data)
    la, lb = rows([("R", 4), ("i", 4), ("j", 5)]), rows([("i", 4), ("R", 4), ("j", 5)])
    out[("all_gather_dist", "per_rank")] = tile_of(C.all_gather_dist(Z, [la, lb, la, lb]))
    out[("all_gather_dist", "Ri")] = tile_of(
        C.all_gather_dist(X, rows([("j", 12), ("Ri", 2), ("i", 4)]), rank_dim="Ri"))
    # all-reduce into another tile layout: over the grid's two-rank column
    # communicator (random values), and over four ranks (integer values)
    for op in ("add", "max", "mean"):
        out[("all_reduce", "Ck", op)] = tile_of(
            C.all_reduce_bag(X, op, rank_dim="Ck", out_tile_layout=rows([("j", 12), ("i", 4)])))
    out[("all_reduce", "R", "add")] = tile_of(
        C.all_reduce_bag(Z, "add", out_tile_layout=rows([("i", 4), ("j", 5)])))
    return out


SHARD_REDUCE_AXES = {"tuple_cols": ("grid", "cols"), "r": ("line", "r"), "one": ("line", "one")}


def shard_reduce_inputs(np) -> dict:
    """Per-rank values (leading dim: the 4 ranks) of the shard-level
    all-reduce checks: a tuple of random values over the grid's two-rank
    ``cols`` axis, integer values over a four-rank axis (an exact sum in any
    order), and a tuple over an axis of one rank."""
    rng = np.random.default_rng(9)
    a = rng.standard_normal((4, 3, 5)).astype(np.float32)
    b = rng.standard_normal((4, 6)).astype(np.float32)
    c = rng.integers(-8, 9, (4, 2, 7)).astype(np.float32)
    return {"tuple_cols": (a, b), "r": c, "one": (a, c)}


def collectives_family() -> dict:
    """:func:`collective_cases` on this gloo rank (4 ranks: a 1-D mesh and a
    2x2 grid)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.core import layout as L

    import torch

    mesh1 = C.make_mesh((4,), ("r",), device="cpu")
    mesh2 = C.make_mesh((2, 2), ("rows", "cols"), device="cpu")
    out = collective_cases(np, L, C, mesh1, mesh2, lambda t: t.numpy(),
                           lambda d: d.data.numpy())
    meshes = {"grid": mesh2, "line": C.make_mesh((4, 1), ("r", "one"), device="cpu")}
    rank = torch.distributed.get_rank()
    for case, arrays in shard_reduce_inputs(np).items():
        mesh, axis = SHARD_REDUCE_AXES[case]
        x = (tuple(torch.from_numpy(a[rank]) for a in arrays) if isinstance(arrays, tuple)
             else torch.from_numpy(arrays[rank]))
        got = C.shard_all_reduce_start(x, axis, mesh=meshes[mesh]).wait()
        if isinstance(got, tuple) != isinstance(x, tuple):
            raise AssertionError(f"shard_all_reduce_start {case}: structure not kept")
        for i, t in enumerate(got if isinstance(got, tuple) else (got,)):
            out[("shard_all_reduce", case, i)] = t.numpy()
    return out


RING_MESHES = [(1, 4), (2, 2)]  # (data, model) meshes of the 4-rank ring checks


def ring_family(*, cases) -> dict:
    """``ring_attention_seq`` on this gloo rank for every mesh of
    :data:`RING_MESHES` and every ``(S, causal)`` case: this rank's output
    chunk, double-buffered and blocking, and whether mismatched q/kv
    lengths raise.  ``cases`` maps ``(S, causal)`` to numpy (q, k, v)."""
    import torch

    from repro_torch.core import make_mesh
    from repro_torch.models.attention import ring_attention_seq

    out: dict = {}
    for shape in RING_MESHES:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        for key, arrays in cases.items():
            q, k, v = (torch.from_numpy(a) for a in arrays)
            for db in (True, False):
                o = ring_attention_seq(q, k, v, mesh=mesh, causal=key[1], double_buffer=db)
                out[(shape, key, db)] = o.numpy()
        try:
            ring_attention_seq(q, k[:, :, 1:], v[:, :, 1:], mesh=mesh)
        except ValueError:
            out[(shape, "mismatch_raises")] = True
        else:
            out[(shape, "mismatch_raises")] = False
    return out


def sp_ring_forward_family(*, models, tokens) -> dict:
    """``lm.forward`` under ``make_recipe(cfg, mesh, attn_mode="sp_ring")`` on
    this gloo rank, for every mesh of :data:`RING_MESHES`, every
    ``models[arch]`` (the reference's float32 parameters as numpy) and every
    ``tokens[S]``: the logits, each rank's block gathered whole
    (``lm.gather_logits``)."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import params_from_jax

    out: dict = {}
    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu") for shape in RING_MESHES}
    for arch, tree in models.items():
        cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32)
        params = params_from_jax(tree, device="cpu")
        for shape, mesh in meshes.items():
            recipe = make_recipe(cfg, mesh, attn_mode="sp_ring")
            for S, toks in tokens.items():
                batch = local_batch(recipe, {"tokens": torch.from_numpy(toks).long()})
                with use_recipe(recipe):
                    logits, _ = lm.forward(params, batch, cfg)
                out[(arch, shape, S)] = lm.gather_logits(logits, recipe, len(toks)).numpy()
    return out


TP_REQUESTS = {  # the reference's distributed-engine request lists (tests/test_engine.py)
    "phi4-mini-3.8b": [(0, [5, 9, 13], 8), (1, [3, 3], 6), (2, [17, 2, 4, 8, 1], 5),
                       (3, [6], 7), (4, [2, 9, 9, 4], 6), (5, [11, 12], 4),
                       (6, [8, 8, 8], 5), (7, [400, 2], 6), (8, [30, 40, 50], 4),
                       (9, [19], 9)],
    "qwen2.5-32b": [(0, [5, 9, 13], 8), (1, [3, 3], 6), (2, [17, 2, 4, 8, 1], 5),
                    (3, [6], 7), (4, [2, 9, 9, 4], 6), (5, [11, 12], 4)],
    # the audio family's ids go through the engine's featurizer
    "musicgen-large": [(0, [5, 9, 13], 8), (1, [3, 3], 6), (2, [17, 2, 4, 8, 1], 5),
                       (3, [6], 7), (4, [2, 9, 9, 4], 6), (5, [11, 12], 4), (6, [8, 8, 8], 5),
                       (7, [100, 2], 6), (8, [30, 40, 50], 4), (9, [19], 9)],
}
TP_SLOTS, TP_MAX_LEN, TP_MICROBATCHES = 8, 64, 2
# what the other ranks' cache blocks are overwritten with: a key or value this
# large would swamp any attention that saw it, and, being finite, it leaves
# masked positions at 0 (a NaN there would enter p @ v as 0 * NaN)
TP_POISON = 1.0e4


def tp_decode_family(*, shape, models) -> dict:
    """Tensor-parallel serving on this gloo rank of a ``shape`` (data, model)
    mesh, for every ``models[arch]`` (the reference's parameters as numpy;
    an ``embeds`` model's requests through the engine's featurizer):
    the engine's greedy outputs on :data:`TP_REQUESTS`, plainly and with
    every cache block of the other ranks' (rows, KV groups) overwritten with
    :data:`TP_POISON` before each decode step; one TP step from the same state
    double-buffered and blocking (logits, caches, lengths and positions
    bitwise equal, or the names that differ); and whether this rank's
    weight shard, gathered back over the mesh, equals the whole tree bit
    for bit."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh, shard_all_gather_start
    from repro_torch.models.weights import params_from_jax, shard_params
    from repro_torch.serve.engine import Engine, ServeConfig
    from repro_torch.serve.tp_decode import make_tp_decode_step, tp_decode_specs

    mesh = make_mesh(shape, ("data", "model"), device="cpu")
    scfg = ServeConfig(max_len=TP_MAX_LEN, batch_slots=TP_SLOTS, eos_token=-1)
    out: dict = {}
    for arch, tree in models.items():
        cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32)
        params = params_from_jax(tree, device="cpu")
        for poison in (False, True):
            engine = Engine(cfg, params, scfg, mesh=mesh, microbatches=TP_MICROBATCHES)
            if poison:  # the blocks this rank's step must never read
                others = torch.ones((TP_SLOTS, cfg.n_kv), dtype=torch.bool)
                bl, gl = TP_SLOTS // shape[0], cfg.n_kv // shape[1]
                d, m = mesh.coords()["data"], mesh.coords()["model"]
                others[d * bl:(d + 1) * bl, m * gl:(m + 1) * gl] = False

                def poisoned(p, state, batch, active, step=engine._tp, others=others):
                    state.caches.k[:, others] = TP_POISON
                    state.caches.v[:, others] = TP_POISON
                    return step(p, state, batch, active)

                engine._tp = poisoned
            for rid, prompt, n in TP_REQUESTS[arch]:
                engine.submit(rid, prompt, n)
            out[(arch, "tokens_poisoned" if poison else "tokens")] = engine.run()

        # one step from the same state, both interpretations of the plans;
        # six requests on eight slots leave two slots idle
        engine = Engine(cfg, params, scfg, mesh=mesh, microbatches=TP_MICROBATCHES)
        for rid, prompt, n in TP_REQUESTS["qwen2.5-32b"]:
            engine.submit(rid, prompt, n)
        engine._fill_slots()
        active = torch.tensor([s.request_id is not None for s in engine.slots])
        if cfg.input_kind == "embeds":
            batch = {"embeds": torch.from_numpy(np.stack([
                s.next_embed if s.request_id is not None else np.zeros(cfg.d_model, np.float32)
                for s in engine.slots])[:, None])}
        else:
            batch = {"tokens": torch.tensor([[s.tokens[-1] if s.request_id is not None else 0]
                                             for s in engine.slots])}
        results = {}
        for db in (True, False):
            st = engine.state
            state = type(st)(caches=type(st.caches)(*(t.clone() for t in st.caches)),
                             positions=st.positions.clone())
            step = make_tp_decode_step(cfg, mesh, slots=TP_SLOTS, microbatches=TP_MICROBATCHES,
                                       double_buffer=db)
            logits, new = step(engine.tp_params, state, batch, active)
            results[db] = {"logits": logits, "k": new.caches.k, "v": new.caches.v,
                           "length": new.caches.length, "positions": new.positions}
        out[(arch, "db_vs_blocking")] = sorted(
            name for name in results[True] if not torch.equal(results[True][name],
                                                              results[False][name]))

        # the weight cut, gathered back along every cut dim, is the whole tree
        whole = engine.params
        specs = tp_decode_specs(cfg)[0]
        shard = shard_params(whole, specs, mesh)
        differ = []

        def walk(w, s, sp, name):
            if isinstance(w, dict):
                for k in w:
                    walk(w[k], s[k], sp[k], f"{name}/{k}")
                return
            for dim, axis in enumerate(sp):
                if axis is not None:
                    s = shard_all_gather_start(s, axis, mesh=mesh, axis=dim).wait()
            if not torch.equal(s, w):
                differ.append(name)

        walk(whole, shard, specs, "")
        out[(arch, "shard_differs")] = differ
    return out


def vcollective_cases(np, L, C, mesh1, mesh2, to_numpy, tile_of):
    """Run the all-to-all, ragged all-gather and ragged all-to-all in either
    package (4 ranks: a 1-D mesh ``r`` and a 2x2 grid) and return ``{case:
    this rank's tile as numpy, the replicated root, or an extents table}``.
    The cases are the reference's own tests of them at 4 ranks, with zero
    split extents added."""
    f32 = np.float32
    out = {}

    def rows(items):  # row-major layout over (dim, extent) pairs, outer first
        layout = L.scalar(f32)
        for d, n in reversed(items):
            layout = layout ^ L.vector(d, n)
        return layout

    line = C.mpi_traverser("R", C.traverser(rows([("R", 4)])), mesh1)
    grid = C.mpi_cart_traverser([("Ri", "rows"), ("Ck", "cols")],
                                C.traverser(rows([("Ri", 2), ("Ck", 2)])), mesh2)

    # MPI_Alltoall: tiles split along i, received blocks concatenated along j
    N, M = 8, 16
    root = C.bag(rows([("j", M), ("i", N)]) ^ L.into_blocks("j", "R", num_blocks=4),
                 np.arange(N * M, dtype=f32).reshape(M, N))
    db = C.scatter(root, rows([("j", M // 4), ("i", N)]),
                   C.mpi_traverser("R", C.traverser(root), mesh1))
    aa = C.all_to_all_bag(db, rows([("i", N // 4), ("j", M)]), split_dim="i", concat_dim="j")
    out["all_to_all"] = tile_of(aa)
    out[("all_to_all", "start")] = tile_of(C.all_to_all_start(
        db, rows([("j", M), ("i", N // 4)]), split_dim="i", concat_dim="j").wait())

    # MPI_Allgatherv on the line: into two root layouts, bag and per-rank buffers
    N, M = 4, 11
    col = rows([("j", M), ("i", N)])
    cap, exts = C.ragged_split(M, 4)
    db = C.scatterv_bag(C.bag(col, np.arange(N * M, dtype=f32) * 0.5),
                        rows([("i", N), ("j", cap)]), line, {"R": ("j", exts)})
    for name, dest in (("col", col), ("row", rows([("i", N), ("j", M)]))):
        out[("all_gatherv_bag", name)] = to_numpy(C.all_gatherv_bag(db, dest).data)
        got = C.all_gatherv_start(db, dest).wait()
        out[("all_gatherv_dist", name)] = tile_of(got)
        out[("all_gatherv_dist_extents", name)] = got.extents

    # MPI_Alltoallv on the line: j-ragged -> i-ragged, balanced and with
    # zero split extents, and the round trip back
    NI, NJ = 11, 13
    A = np.arange(NI * NJ, dtype=f32).reshape(NI, NJ)
    cap_j, ej = C.ragged_split(NJ, 4)
    in_tile = rows([("i", NI), ("j", cap_j)])
    db = C.scatterv_bag(C.bag(rows([("i", NI), ("j", NJ)]), A), in_tile, line, {"R": ("j", ej)})
    for name, ei in (("balanced", C.ragged_split(NI, 4)[1]), ("zeros", (5, 0, 6, 0))):
        res = C.all_to_allv_bag(db, rows([("i", max(ei)), ("j", NJ)]), split_dim="i",
                                concat_dim="j", split_extents=ei)
        out[("all_to_allv", name)], out[("all_to_allv_extents", name)] = tile_of(res), res.extents
        back = C.all_to_allv_start(res, in_tile, split_dim="j", concat_dim="i",
                                   split_extents=ej).wait()
        out[("all_to_allv_back", name)] = tile_of(back)
        out[("all_to_allv_back_extents", name)] = back.extents

    # MPI_Allgatherv over the grid: full, and partial along Ck
    NI, NK = 7, 10
    lay = rows([("i", NI), ("k", NK)])
    cap_i, ei = C.ragged_split(NI, 2)
    cap_k, ek = C.ragged_split(NK, 2)
    db = C.scatterv_bag(C.bag(lay, np.arange(NI * NK, dtype=f32).reshape(NI, NK)),
                        rows([("i", cap_i), ("k", cap_k)]), grid,
                        {"Ri": ("i", ei), "Ck": ("k", ek)})
    for name, dest in (("ik", lay), ("ki", rows([("k", NK), ("i", NI)]))):
        out[("all_gatherv_grid", name)] = to_numpy(C.all_gatherv_bag(db, dest).data)
    part = C.all_gatherv_dist(db, rows([("i", cap_i), ("k", NK)]), rank_dim="Ck")
    out["all_gatherv_grid_partial"] = tile_of(part)
    out["all_gatherv_grid_partial_extents"] = part.extents

    # MPI_Alltoallv along one grid dim (k <-> m inside every row
    # sub-communicator, i riding through), and back; m balanced and with
    # an empty block
    NI, NK, NM = 7, 10, 9
    A = np.arange(NI * NK * NM, dtype=f32).reshape(NI, NK, NM)
    cap_m, em = C.ragged_split(NM, 2)
    in_tile = rows([("i", cap_i), ("k", cap_k), ("m", NM)])
    db = C.scatterv_bag(C.bag(rows([("i", NI), ("k", NK), ("m", NM)]), A), in_tile, grid,
                        {"Ri": ("i", ei), "Ck": ("k", ek)})
    for name, em_ in (("balanced", em), ("zeros", (NM, 0))):
        res = C.all_to_allv_bag(db, rows([("i", cap_i), ("k", NK), ("m", max(em_))]),
                                split_dim="m", concat_dim="k", split_extents=em_, rank_dim="Ck")
        out[("all_to_allv_grid", name)] = tile_of(res)
        out[("all_to_allv_grid_extents", name)] = res.extents
        back = C.all_to_allv_bag(res, in_tile, split_dim="k", concat_dim="m",
                                 split_extents=ek, rank_dim="Ck")
        out[("all_to_allv_grid_back", name)] = tile_of(back)
        out[("all_to_allv_grid_back_extents", name)] = back.extents
    return out


def vcollectives_family() -> dict:
    """:func:`vcollective_cases` on this gloo rank, plus the checks that
    refuse ill-typed calls before any data moves."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.core import layout as L

    mesh1 = C.make_mesh((4,), ("r",), device="cpu")
    mesh2 = C.make_mesh((2, 2), ("rows", "cols"), device="cpu")
    out = vcollective_cases(np, L, C, mesh1, mesh2, lambda t: t.numpy(),
                            lambda d: d.data.numpy())
    vec = L.scalar(np.float32) ^ L.vector("i", 8) ^ L.vector("j", 4)
    dt = C.mpi_traverser("R", C.traverser(L.scalar(np.float32) ^ L.vector("R", 4)), mesh1)
    db = C.DistBag(C.dist_full(dt, vec).data, vec, dt, ("R",))
    refused = []
    for call in (lambda: C.all_to_all_bag(db, vec, split_dim="i", concat_dim="i"),
                 lambda: C.all_gatherv_dist(db, vec),
                 lambda: C.all_to_allv_bag(db, vec, split_dim="i", concat_dim="j",
                                           split_extents=(2, 2, 2, 2))):
        try:
            call()
        except C.LayoutError:
            refused.append(True)
        else:
            refused.append(False)
    out["refused"] = refused
    return out


MOE_EP_MESH = (2, 2)  # (data, model) mesh of the expert-parallel checks


def moe_ep_family(*, params, x, cases, bf16_cases) -> dict:
    """``moe_expert_parallel`` on this gloo rank of a :data:`MOE_EP_MESH`
    mesh: for every ``cases[name] = (params key, counts or None)``, this
    rank's ``(y, aux)`` double-buffered and whether the blocking run is
    bitwise the same, and for the cases named in ``bf16_cases`` its ``y``
    with bf16 weights and activations; and ``moe_ffn`` on this rank's block under the
    recipe, by EP and by the gathered fallback, with the fallback's
    warnings counted."""
    import warnings

    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models import ffn
    from repro_torch.models.sharding import make_recipe, token_shard, use_recipe
    from repro_torch.models.weights import cast_params, params_from_jax

    mesh = make_mesh(MOE_EP_MESH, ("data", "model"), device="cpu")
    cfg = configs.get("phi3.5-moe-42b-a6.6b", smoke=True)
    recipe = make_recipe(cfg, mesh)
    trees = {name: params_from_jax(tree, device="cpu") for name, tree in params.items()}
    xs = torch.from_numpy(x)
    B, S, _ = xs.shape
    D, R = MOE_EP_MESH
    d, r = mesh.coords()["data"], mesh.coords()["model"]
    local = xs[d * (B // D):(d + 1) * (B // D), r * (S // R):(r + 1) * (S // R)]
    out: dict = {}
    with use_recipe(recipe):
        for name, (key, counts) in cases.items():
            p = trees[key]
            E = p["router"].shape[-1]
            runs = [ffn.moe_expert_parallel(p, local, n_experts=E, top_k=2, counts=counts,
                                            n_groups=2, double_buffer=db)
                    for db in (True, False)]
            out[name] = tuple(t.numpy() for t in runs[0])
            out[(name, "blocking_equal")] = all(torch.equal(a, b)
                                                for a, b in zip(runs[0], runs[1]))
        for name in bf16_cases:
            key, counts = cases[name]
            p = cast_params(trees[key], torch.bfloat16)
            y, _ = ffn.moe_expert_parallel(p, local.to(torch.bfloat16),
                                           n_experts=p["router"].shape[-1], top_k=2,
                                           counts=counts, n_groups=2)
            out[(name, "bf16")] = y.float().numpy()
        p = trees["phi"]
        for name, Sx in (("ffn_ep", S), ("ffn_ragged", S - 1)):
            shard = token_shard(recipe, B, Sx)
            with warnings.catch_warnings(record=True) as caught:
                warnings.simplefilter("always")
                y, aux = ffn.moe_ffn(p, shard.local(xs[:, :Sx]), n_experts=4, top_k=2,
                                     dispatch="ep", shard=shard)
            out[name] = (y.numpy(), aux.numpy())
            out[(name, "warnings")] = sum("falling back" in str(w.message) for w in caught)
    return out


MOE_RING_MESHES = [(2, 2), (1, 4)]


def moe_sp_ring_family(*, models, tokens) -> dict:
    """``lm.forward`` under ``make_recipe(cfg, mesh, attn_mode="sp_ring")`` on
    this gloo rank for every mesh of :data:`MOE_RING_MESHES`, every
    ``models[name] = (arch, config overrides, the reference's parameters
    as numpy)`` and every ``tokens[S]``: the logits, the aux loss, and how
    many fallback warnings the forward raised."""
    import dataclasses
    import warnings

    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models import lm
    from repro_torch.models.sharding import local_batch, make_recipe, use_recipe
    from repro_torch.models.weights import params_from_jax

    out: dict = {}
    meshes = {shape: make_mesh(shape, ("data", "model"), device="cpu")
              for shape in MOE_RING_MESHES}
    for name, (arch, overrides, tree) in models.items():
        cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32,
                                  **overrides)
        params = params_from_jax(tree, device="cpu")
        for shape, mesh in meshes.items():
            recipe = make_recipe(cfg, mesh, attn_mode="sp_ring")
            for S, toks in tokens.items():
                with use_recipe(recipe), warnings.catch_warnings(record=True) as caught:
                    warnings.simplefilter("always")
                    logits, aux = lm.forward(
                        params, local_batch(recipe, {"tokens": torch.from_numpy(toks).long()}),
                        cfg)
                out[(name, shape, S)] = (lm.gather_logits(logits, recipe, len(toks)).numpy(),
                                         aux.numpy(),
                                         sum("falling back" in str(w.message) for w in caught))
    return out


# ----------------------------------------------------------------- training

def train_collective_inputs(np, world: int) -> dict:
    """Every rank's inputs (leading dim: the ranks) of the training
    collectives' checks, integer-valued floats (exact sums in any order):
    flat ``(R * cap,)`` buffers with ragged and zero extents, zero past each
    rank's extent as a packed bucket is, for the reduce-scatterv; ``(cap,)``
    shards for the all-gatherv; a tensor to reduce-scatter along each axis."""
    rng = np.random.default_rng(31 + world)
    cap = 5
    extents = {2: (5, 2), 4: (5, 5, 3, 0)}[world]
    flat = rng.integers(-9, 10, (world, world * cap)).astype(np.float32)
    size = sum(extents)
    flat[:, size:] = 0.0  # the capacity-pad tail of a packed bucket
    flat2 = rng.integers(-9, 10, (world, world * cap)).astype(np.float32)
    flat2[:, size:] = 0.0
    shards = rng.integers(-9, 10, (world, cap)).astype(np.float32)
    dense = rng.integers(-9, 10, (world, 3, world * 2, 4)).astype(np.float32)
    return {"extents": extents, "flat": flat, "flat2": flat2, "shards": shards, "dense": dense}


def train_collectives_family() -> dict:
    """``shard_reduce_scatterv_start`` (a tensor and a tuple), ``shard_all_gatherv_start``
    and ``shard_reduce_scatter_start`` (along axes 0 and 1) on this gloo rank
    of a one-axis ``data`` mesh, and whether ill-fitting tables raise."""
    import numpy as np
    import torch

    import repro_torch.core as C

    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    mesh = C.make_mesh((world,), ("data",), device="cpu")
    ins = train_collective_inputs(np, world)
    ext = ins["extents"]
    t = lambda a: torch.from_numpy(a[rank].copy())
    out: dict = {}
    x = t(ins["flat"])
    out["rsv"] = C.shard_reduce_scatterv_start(x, "data", extents=ext, mesh=mesh).wait().numpy()
    out["rsv_input_kept"] = bool(torch.equal(x, t(ins["flat"])))
    pair = C.shard_reduce_scatterv_start((x, t(ins["flat2"])), "data", extents=ext,
                                         mesh=mesh).wait()
    out["rsv_tuple"] = tuple(p.numpy() for p in pair)
    out["agv"] = C.shard_all_gatherv_start(t(ins["shards"]), "data", extents=ext,
                                           mesh=mesh).wait().numpy()
    for axis in (0, 1):
        dense = t(ins["dense"])
        if axis == 0:
            dense = dense.transpose(0, 1).contiguous()  # (world * 2, 3, 4)
        out[("rs", axis)] = C.shard_reduce_scatter_start(dense, "data", mesh=mesh,
                                                         axis=axis).wait().numpy()
    refused = []
    for call in (lambda: C.shard_reduce_scatterv_start(x[:-1], "data", extents=ext, mesh=mesh),
                 lambda: C.shard_reduce_scatterv_start(x, "data", extents=(99,) * world,
                                                       mesh=mesh),
                 lambda: C.shard_all_gatherv_start(t(ins["shards"]), "data",
                                                   extents=ext[:-1], mesh=mesh),
                 lambda: C.shard_reduce_scatter_start(torch.zeros(3, world + 1), "data",
                                                      mesh=mesh, axis=1)):
        try:
            call()
        except C.LayoutError:
            refused.append(True)
        else:
            refused.append(False)
    out["refused"] = refused
    return out


def _opt_config(torch_mod, kw):
    return torch_mod.OptConfig(**kw)


def zero_train_family(*, params, batch, cfg_overrides, ocfg, bucket_bytes, steps,
                      microbatches, grads=None) -> dict:
    """``make_zero_train_step`` on this gloo rank of a one-axis ``data``
    mesh over the world: ``steps`` steps from the reference's parameters
    (numpy) on this rank's block of the global ``batch``
    (``trainer.zero_local_batch``), double-buffered and blocking: the
    parameters, this rank's moment shards, the metrics of every step, the
    bucket extents, and the order in which the first step issued and waited
    its reduce-scatters.  With ``grads`` (one list of gradient leaves a
    step, numpy), also the update alone (``make_zero_update``) fed those
    gradients: rank 0 hands in R times them and the other ranks zeros, so
    the reduced mean is exactly the given gradient."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.models.module import tree_leaves, tree_unflatten
    from repro_torch.models.weights import params_from_jax
    from repro_torch.train import optimizer, trainer

    world = torch.distributed.get_world_size()
    mesh = make_mesh((world,), ("data",), device="cpu")
    rank = mesh.coords()["data"]
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True),
                              act_dtype=torch.float32, **cfg_overrides)
    oc = optimizer.OptConfig(**ocfg)
    buckets = trainer.zero_train_buckets(cfg, bucket_bytes=bucket_bytes, ranks=world)
    tb = {k: torch.from_numpy(v).long() for k, v in trainer.zero_local_batch(mesh, batch).items()}
    log: list = []
    issue = trainer.shard_reduce_scatterv_start

    def logged(*a, **kw):  # record the issue and the wait of every reduce-scatter
        pend = issue(*a, **kw)
        n = sum(1 for e in log if e[0] == "issue")
        log.append(("issue", n))
        wait = pend.wait

        def logged_wait():
            log.append(("wait", n))
            return wait()

        pend.wait = logged_wait
        return pend

    def state(p, o):
        return {"params": [t.numpy() for t in tree_leaves(p)],
                "mu": [t.numpy() for t in o.mu], "nu": [t.numpy() for t in o.nu],
                "err": [t.numpy() for t in o.err], "step": int(o.step)}

    out: dict = {"extents": [b.extents for b in buckets]}
    for db in (True, False):
        p = params_from_jax(params, device="cpu")
        o = optimizer.init_zero_opt_state(p, buckets, oc)
        step = trainer.make_zero_train_step(cfg, mesh, oc, microbatches=microbatches,
                                            bucket_bytes=bucket_bytes, double_buffer=db)
        metrics = []
        for s in range(steps):
            if db and s == 0:
                trainer.shard_reduce_scatterv_start = logged
            try:
                p, o, m = step(p, o, tb)
            finally:
                trainer.shard_reduce_scatterv_start = issue
            metrics.append({k: v.numpy() for k, v in m.items()})
        out[db] = {**state(p, o), "metrics": metrics}
    out["log"] = log
    if grads is not None:
        p = params_from_jax(params, device="cpu")
        o = optimizer.init_zero_opt_state(p, buckets, oc)
        update = trainer.make_zero_update(cfg, mesh, oc, bucket_bytes=bucket_bytes)
        norms = []
        for g in grads:
            mine = [torch.from_numpy(a) * world if rank == 0 else torch.zeros(a.shape)
                    for a in g]
            p, o, gnorm = update(p, o, tree_unflatten(p, mine))
            norms.append(float(gnorm))
        out["update"] = {**state(p, o), "grad_norm": norms}
    return out


ZERO_BUCKET_BYTES = 4096  # several buckets at the SMOKE widths, some ragged


def zero_step_families(*, models, batches, ocfg) -> dict:
    """One ``make_zero_train_step`` step on this gloo rank of a one-axis
    ``data`` mesh over the world, for every ``models[arch]`` (the
    reference's parameters as numpy, SMOKE config at float32) on this
    rank's block of the global pipeline batch ``batches[arch]`` (numpy, cut
    by ``trainer.zero_local_batch`` and moved as ``launch/train.py`` moves
    it): the loss, the gradient norm and the stepped parameters."""
    import dataclasses

    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.data.pipeline import to_device
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.weights import params_from_jax
    from repro_torch.train import optimizer, trainer

    mesh = make_mesh((torch.distributed.get_world_size(),), ("data",), device="cpu")
    oc = optimizer.OptConfig(**ocfg)
    out: dict = {}
    for arch, tree in models.items():
        cfg = dataclasses.replace(configs.get(arch, smoke=True), act_dtype=torch.float32)
        p = params_from_jax(tree, device="cpu")
        buckets = trainer.zero_train_buckets(cfg, bucket_bytes=ZERO_BUCKET_BYTES,
                                             ranks=mesh.shape["data"])
        o = optimizer.init_zero_opt_state(p, buckets, oc)
        step = trainer.make_zero_train_step(cfg, mesh, oc, bucket_bytes=ZERO_BUCKET_BYTES)
        p, o, m = step(p, o, to_device(trainer.zero_local_batch(mesh, batches[arch]), "cpu"))
        out[arch] = {"loss": float(m["loss"]), "grad_norm": float(m["grad_norm"]),
                     "params": [t.numpy() for t in tree_leaves(p)]}
    return out


SP_RING_TRAIN_MESHES = {2: [(1, 2)], 4: [(1, 4), (2, 2)]}


def sp_ring_train_family(*, params, batches, ocfg) -> dict:
    """Training under ``make_recipe(cfg, mesh, attn_mode="sp_ring")`` on this
    gloo rank, for every mesh of :data:`SP_RING_TRAIN_MESHES` of the world
    and every ``batches[S]`` (numpy tokens and labels): the loss and
    gradients (``_accum_loss_grads``) and one ``make_train_step`` step
    (its metrics, and whether its parameters are bitwise AdamW's on the
    gradients above); and the differentiable ring shift's and
    gather's backward on their own."""
    import dataclasses

    import numpy as np
    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh, shard_ring_shift_start
    from repro_torch.models.module import tree_leaves
    from repro_torch.models.sharding import local_batch, make_recipe, token_shard, use_recipe
    from repro_torch.models.weights import params_from_jax
    from repro_torch.train import optimizer, trainer

    world = torch.distributed.get_world_size()
    rank = torch.distributed.get_rank()
    cfg = dataclasses.replace(configs.get("phi4-mini-3.8b", smoke=True), act_dtype=torch.float32)
    oc = optimizer.OptConfig(**ocfg)
    p0 = params_from_jax(params, device="cpu")
    out: dict = {}
    for shape in SP_RING_TRAIN_MESHES[world]:
        mesh = make_mesh(shape, ("data", "model"), device="cpu")
        recipe = make_recipe(cfg, mesh, attn_mode="sp_ring")
        for S, (toks, labels) in batches.items():
            b = local_batch(recipe, {"tokens": torch.from_numpy(toks).long(),
                                     "labels": torch.from_numpy(labels).long()})
            with use_recipe(recipe):
                loss, _, grads = trainer._accum_loss_grads(p0, b, cfg, 1)
            out[(shape, S, "loss")] = float(loss)
            out[(shape, S, "grads")] = [g.numpy() for g in tree_leaves(grads)]
            new_p, _, m = trainer.make_train_step(cfg, recipe, oc)(
                p0, optimizer.init_opt_state(p0, oc), b)
            fed, _, _ = optimizer.apply_updates(p0, grads, optimizer.init_opt_state(p0, oc), oc)
            out[(shape, S, "step")] = ({k: float(v) for k, v in m.items()}, all(
                torch.equal(a, c) for a, c in zip(tree_leaves(new_p), tree_leaves(fed))))
        # the shift's backward: rank r's x reaches rank r + 1, whose weight
        # is its cotangent
        R, r = shape[1], mesh.coords()["model"]
        x = torch.full((2, 3), float(rank + 1), requires_grad=True)
        y = shard_ring_shift_start((x, 2 * x), "model", 1, mesh=mesh).wait()
        (y[0] * (10 * r + 1) + y[1] * (100 * r + 7)).sum().backward()
        out[(shape, "shift_grad")] = x.grad.numpy()
        # the gather's backward: this rank's block of the (same on every
        # rank) cotangent
        B, S = 2, 7
        shard = token_shard(recipe, B, S)
        W = torch.from_numpy(np.random.default_rng(5).standard_normal((B, S, 3)).astype(np.float32))
        xl = torch.zeros((shard.n_rows, shard.cap, 3), requires_grad=True)
        (shard.gather(xl) * W).sum().backward()
        out[(shape, "gather_grad")] = (xl.grad.numpy(), shard.local(W).numpy())
        out[(shape, "coords")] = (mesh.coords()["data"], r, R)
    return out


# -----------------------------------------------------------------------------
# point-to-point: send_recv and the ring laws
# -----------------------------------------------------------------------------
P2P_KINDS = ("col", "row", "blocked")


def p2p_property_cases() -> list:
    """Seeded ``(shift, ni, jt, src_kind, mid_kind)`` cases of the ring
    laws of ``tests/test_p2p_properties.py`` on a 4-rank communicator."""
    import numpy as np

    rng = np.random.default_rng(21)
    return [(int(rng.integers(-8, 9)), int(rng.choice([2, 4])), int(rng.choice([1, 2])),
             P2P_KINDS[int(rng.integers(3))], P2P_KINDS[int(rng.integers(3))])
            for _ in range(12)]


def p2p_cases(np, L, C, mesh1, mesh2, views, is_me) -> dict:
    """Run ``send_recv`` and the ring laws in either package on 4 ranks and
    return ``{case: views(result)}``: ``views(dist_bag)`` maps each rank this
    process can read (every rank in the reference, its own in the port) to
    ``(tile data as numpy, tile layout's axes and shape)``; and the extents
    tables.  Refusals record ``True`` when ``LayoutError`` was raised;
    ``is_me(r)`` says whether this process is rank ``r`` of ``mesh1``."""
    f32 = np.float32

    def sig(layout):
        return tuple((a.name, a.size) for a in layout.axes), tuple(layout.dim_map)

    def tile_layout(kind, ni, jt):
        if kind == "col":
            return L.scalar(f32) ^ L.vector("i", ni) ^ L.vector("j", jt)
        if kind == "row":
            return L.scalar(f32) ^ L.vector("j", jt) ^ L.vector("i", ni)
        return (L.scalar(f32) ^ L.vector("i", ni) ^ L.vector("j", jt)
                ^ L.blocked("i", "I2", num_blocks=2))

    def line_bag(ni, jt, kind, R=4):
        nj = R * jt
        col = L.scalar(f32) ^ L.vector("i", ni) ^ L.vector("j", nj)
        root = C.bag(col ^ L.into_blocks("j", "R", num_blocks=R),
                     np.arange(ni * nj, dtype=f32).reshape(nj, ni) + 1.0)
        dt = C.mpi_traverser("R", C.traverser(root), mesh1)
        return C.scatter(root, tile_layout(kind, ni, jt), dt)

    def refused(fn) -> bool:
        try:
            fn()
        except C.LayoutError:
            return True
        return False

    out: dict = {}
    N = 8
    db = line_bag(N, 2, "col")
    dst_tile = tile_layout("row", N, 2)
    # differing endpoint layouts (test_p2p.py:5) and untouched bystanders (:46)
    for src, dst in ((2, 1), (1, 3), (2, 2), (0, 3)):
        got = C.send_recv(db, src=src, dst=dst, dst_tile_layout=dst_tile)
        out[("send_recv", src, dst)] = views(got)
        out[("send_recv", src, dst, "table")] = (
            None if got.tile_layouts is None else tuple(sig(t) for t in got.tile_layouts))
        out[("send_recv", src, dst, "kept")] = got.tile_layout is db.tile_layout
    same = C.send_recv(db, src=3, dst=0)  # no declared layout: a homogeneous bag
    out[("send_recv", "same")] = views(same)
    out[("send_recv", "same", "table")] = same.tile_layouts
    # along one dim of a 2x2 grid (the row sub-communicators)
    g = L.scalar(f32) ^ L.vector("i", 4) ^ L.vector("j", 8)
    groot = C.bag(g ^ L.into_blocks("i", "Ri", num_blocks=2) ^ L.into_blocks("j", "Cj", num_blocks=2),
                  np.arange(32, dtype=f32).reshape(8, 4) * 0.5)
    dt2 = C.mpi_cart_traverser([("Ri", "rows"), ("Cj", "cols")], C.traverser(groot), mesh2)
    gdb = C.scatter(groot, L.scalar(f32) ^ L.vector("i", 2) ^ L.vector("j", 4), dt2)
    ggot = C.send_recv(gdb, src=0, dst=1, rank_dim="Cj",
                       dst_tile_layout=L.scalar(f32) ^ L.vector("j", 4) ^ L.vector("i", 2))
    out[("send_recv", "grid")] = views(ggot)
    out[("send_recv", "grid", "table")] = tuple(sig(t) for t in ggot.tile_layouts)
    # a ragged bag: the receiver adopts the sender's extents
    rows = lambda items: _rows(L, f32, items)
    dt1 = C.mpi_traverser("R", C.traverser(rows([("R", 4), ("i", 3), ("j", 5)])), mesh1)
    y = np.random.default_rng(5).standard_normal((10, 5)).astype(f32)
    Y = C.scatterv_bag(C.bag(rows([("i", 10), ("j", 5)]), y), rows([("i", 3), ("j", 5)]), dt1,
                       {"R": ("i", (3, 3, 2, 2))})
    rgot = C.send_recv(Y, src=0, dst=3, dst_tile_layout=rows([("j", 5), ("i", 3)]))
    out[("send_recv", "ragged")] = views(rgot)
    out[("send_recv", "ragged", "extents")] = rgot.extents
    rgot2 = C.send_recv(Y, src=3, dst=1)
    out[("send_recv", "ragged_back")] = views(rgot2)
    out[("send_recv", "ragged_back", "extents")] = rgot2.extents
    # refusals (test_p2p.py:219, :231) and a bag that already has tile_layouts
    hetero = C.send_recv(db, src=2, dst=1, dst_tile_layout=dst_tile)
    out[("refuse", "index_space")] = refused(lambda: C.send_recv(
        db, src=0, dst=1, dst_tile_layout=L.scalar(f32) ^ L.vector("i", N) ^ L.vector("j", 4)))
    out[("refuse", "duplicate_dst")] = refused(lambda: C.permute(db, [(0, 1), (2, 1)]))
    out[("refuse", "out_of_range")] = refused(lambda: C.send_recv(db, src=0, dst=4))
    out[("refuse", "hetero_send_recv")] = refused(lambda: C.send_recv(hetero, src=0, dst=1))
    # the ring laws (test_p2p_properties.py) over fixed seeded cases
    for case in p2p_property_cases():
        shift, ni, jt, src_kind, mid_kind = case
        b = line_bag(ni, jt, src_kind)
        mid = tile_layout(mid_kind, ni, jt)
        fwd = C.ring_shift(b, shift, dst_tile_layout=mid)
        back = C.ring_shift(fwd, -shift, dst_tile_layout=b.tile_layout)
        back2 = C.ring_shift(C.ring_shift_start(b, shift, dst_tile_layout=mid).wait(), -shift,
                             dst_tile_layout=b.tile_layout)
        plain = C.ring_shift(b, shift)
        pairs = [(i, (i + 1) % 4) for i in range(3)]
        fused_p, plain_p = C.permute(b, pairs, dst_tile_layout=mid), C.permute(b, pairs)
        out[("ring_law", case)] = views(fwd)
        out[("ring_law", case, "permute")] = views(fused_p)
        out[("ring_law", case, "holds")] = (
            back.tile_layout is b.tile_layout
            and all(np.array_equal(v[0], w[0]) for v, w in zip(views(back).values(),
                                                               views(b).values()))
            and all(np.array_equal(v[0], w[0]) for v, w in zip(views(back2).values(),
                                                               views(b).values()))
            and all(np.array_equal(v[0], np.asarray(plain.tile(r).to_layout(mid).data))
                    for r, v in views(fwd).items())
            and all(np.array_equal(v[0], np.asarray(plain_p.tile(r).to_layout(mid).data))
                    for r, v in views(fused_p).items()))
    out["me"] = [r for r in range(4) if is_me(r)]
    return out


def p2p_twin_cases() -> dict:
    """Seeded cases of ``tests/test_p2p.py``'s ring and permute tests on 4
    ranks: ``start`` shifts (``ring_shift_start`` against the blocking
    shift, with a relayout), ``relayout`` shifts (a ring shift flipping
    every tile's major), ``partial`` pair lists (a permute that leaves some
    ranks unsent: they receive zeros), ``grid`` ``(shift, rank_dim)`` on the
    2x2 grid (fixed)."""
    import numpy as np

    rng = np.random.default_rng(23)
    shift = lambda: int(rng.integers(-8, 9))  # noqa: E731
    partial = []
    for n in (1, 2, 1, 3):  # n disjoint pairs: their sources and destinations draw apart
        src = [int(r) for r in rng.permutation(4)[:n]]
        dst = [int(r) for r in rng.permutation(4)[:n]]
        partial.append(tuple(zip(src, dst)))
    return {"start": [3] + [shift() for _ in range(3)],
            "relayout": [3] + [shift() for _ in range(3)],
            "partial": [((0, 1), (1, 0))] + partial,
            # a size-2 dim: odd shifts swap, even ones keep
            "grid": [(1, "Cj"), (-1, "Ri"), (2, "Cj"), (-3, "Ri")]}


def p2p_twins(np, L, C, mesh1, mesh2, views, is_me, cases) -> dict:
    """Run ``tests/test_p2p.py``'s ring and permute tests in either package
    over ``cases`` (:func:`p2p_twin_cases`) and return ``{case: views(result)}``
    and ``{(case, "law"): bool}`` for each law this process can check on
    its own ranks (``is_me(r)``: this process holds rank ``r`` of
    ``mesh1``):

    * ``ring_shift_start(...).wait()`` is bitwise the blocking shift, with a
      relayout, and ``wait`` completes two requests (a ring shift and a
      partial permute) to their blocking results (``:86``);
    * a ring shift with a relayout delivers the relaid source tile of rank
      ``r - shift`` (each rank records its source relaid, ``"src"``) (``:121``);
    * a permute's unsent ranks receive zeros, its sent ranks their
      source's tile (``:148``);
    * a ring shift along one dim of the 2x2 grid moves tiles inside each
      row (or column) sub-communicator alone; ``dt.sub`` keeps the dim
      (``:173``)."""
    f32 = np.float32
    out: dict = {}

    def own(d, fn):  # fn(r, tile) of every rank this process holds
        return {r: fn(r, d.tile(r)) for r in range(4) if is_me(r)}

    col = L.scalar(f32) ^ L.vector("i", 4) ^ L.vector("j", 16)
    root = C.bag(col ^ L.into_blocks("j", "R", num_blocks=4), np.arange(64, dtype=f32))
    db = C.scatter(root, L.scalar(f32) ^ L.vector("i", 4) ^ L.vector("j", 4),
                   C.mpi_traverser("R", C.traverser(root), mesh1))
    dst = L.scalar(f32) ^ L.vector("j", 4) ^ L.vector("i", 4)

    def same(a, b) -> bool:
        return all(np.array_equal(v[0], w[0]) and v[1] == w[1]
                   for v, w in zip(views(a).values(), views(b).values(), strict=True))

    for shift in cases["start"]:
        got = C.ring_shift_start(db, shift, dst_tile_layout=dst).wait()
        want = C.ring_shift(db, shift, dst_tile_layout=dst)
        pairs = [(0, 3), (3, 0)]
        d1, d2 = C.wait(C.ring_shift_start(db, shift), C.permute_start(db, pairs))
        out[("start", shift)] = views(got)
        out[("start", shift, "law")] = (got.tile_layout is dst and same(got, want)
                                        and same(d1, C.ring_shift(db, shift))
                                        and same(d2, C.permute(db, pairs)))
    for shift in cases["relayout"]:
        out[("relayout", shift)] = views(C.ring_shift(db, shift, dst_tile_layout=dst))
    out[("relayout", "src")] = own(db, lambda r, t: np.asarray(t.to_layout(dst).data))
    small = L.scalar(f32) ^ L.vector("i", 2) ^ L.vector("j", 4)
    proot = C.bag(small ^ L.into_blocks("j", "R", num_blocks=4), np.arange(8, dtype=f32) + 1.0)
    pdb = C.scatter(proot, L.scalar(f32) ^ L.vector("i", 2) ^ L.vector("j", 1),
                    C.mpi_traverser("R", C.traverser(proot), mesh1))
    out[("partial", "src")] = views(pdb)
    for pairs in cases["partial"]:
        out[("partial", pairs)] = views(C.permute(pdb, list(pairs)))
    g = L.scalar(f32) ^ L.vector("i", 4) ^ L.vector("j", 8)
    groot = C.bag(g ^ L.into_blocks("i", "Ri", num_blocks=2) ^ L.into_blocks("j", "Cj",
                                                                             num_blocks=2),
                  np.arange(32, dtype=f32))
    gdt = C.mpi_cart_traverser([("Ri", "rows"), ("Cj", "cols")], C.traverser(groot), mesh2)
    gdb = C.scatter(groot, L.scalar(f32) ^ L.vector("i", 2) ^ L.vector("j", 4), gdt)
    out[("grid", "src")] = views(gdb)
    for shift, dim in cases["grid"]:
        out[("grid", shift, dim)] = views(C.ring_shift(gdb, shift, rank_dim=dim))
    sub = gdt.sub("Cj")
    out[("grid", "sub")] = (sub.rank_dims, sub.comm_size())
    return out


def _rows(L, f32, items):
    layout = L.scalar(f32)
    for d, n in reversed(items):
        layout = layout ^ L.vector(d, n)
    return layout


def p2p_family() -> dict:
    """:func:`p2p_cases` on this gloo rank, then a collective on a
    heterogeneous bag in every form: each must raise on every rank before
    any transfer is issued (a rank left in the transfer would hang)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.core import layout as L

    mesh1 = C.make_mesh((4,), ("r",), device="cpu")
    mesh2 = C.make_mesh((2, 2), ("rows", "cols"), device="cpu")
    me = mesh1.coords()["r"]

    def views(d):
        t = d.tile(d.coords if len(d.coords) > 1 else d.coords[0])
        r = d.flat_rank(d.coords)
        return {r: (t.data.numpy(), (tuple((a.name, a.size) for a in t.layout.axes),
                                     tuple(t.layout.dim_map)))}

    out = p2p_cases(np, L, C, mesh1, mesh2, views, lambda r: r == me)
    out.update(p2p_twins(np, L, C, mesh1, mesh2, views, lambda r: r == me, p2p_twin_cases()))
    f32 = np.float32
    col = L.scalar(f32) ^ L.vector("i", 8) ^ L.vector("j", 8)
    root = C.bag(col ^ L.into_blocks("j", "R", num_blocks=4), np.arange(64, dtype=f32))
    dt = C.mpi_traverser("R", C.traverser(root), mesh1)
    db = C.scatter(root, L.scalar(f32) ^ L.vector("i", 8) ^ L.vector("j", 2), dt)
    hetero = C.send_recv(db, src=2, dst=1,
                         dst_tile_layout=L.scalar(f32) ^ L.vector("j", 2) ^ L.vector("i", 8))
    row_root = L.scalar(f32) ^ L.vector("R", 4) ^ L.vector("i", 8) ^ L.vector("j", 2)
    attempts = {
        "gather": lambda: C.gather(hetero, col),
        "all_gather": lambda: C.all_gather_dist(hetero, row_root),
        "all_reduce": lambda: C.all_reduce_bag(hetero, "add"),
        "reduce_scatter": lambda: C.reduce_scatter_bag(
            hetero, L.scalar(f32) ^ L.vector("i", 2) ^ L.vector("j", 2), scatter_dim="i"),
        "all_to_all": lambda: C.all_to_all_bag(hetero, hetero.tile_layout, split_dim="i",
                                               concat_dim="j"),
        "permute": lambda: C.permute(hetero, [(0, 1), (1, 0)]),
        "ring_shift": lambda: C.ring_shift_start(hetero, 1),
        "send_recv": lambda: C.send_recv(hetero, src=1, dst=2),
    }
    for name, fn in attempts.items():
        try:
            fn()
        except C.LayoutError:
            out[("hetero_refused", name)] = True
        else:
            out[("hetero_refused", name)] = False
    # the per-rank all-gather records its table as the reference's does
    Z = C.scatter(C.bag(_rows(L, f32, [("R", 4), ("i", 4), ("j", 5)]),
                        np.arange(80, dtype=f32)), _rows(L, f32, [("j", 5), ("i", 4)]),
                  C.mpi_traverser("R", C.traverser(_rows(L, f32, [("R", 4), ("i", 4), ("j", 5)])),
                                  mesh1))
    la, lb = (_rows(L, f32, [("R", 4), ("i", 4), ("j", 5)]),
              _rows(L, f32, [("i", 4), ("R", 4), ("j", 5)]))
    g = C.all_gather_dist(Z, [la, lb, la, lb])
    out["all_gather_table"] = (g.tile_layout is la, g.tile_layouts == (la, lb, la, lb),
                               g.own_layout == (la, lb)[me % 2])
    return out


def collective_property_cases() -> dict:
    """Seeded cases of the laws of ``tests/test_collective_properties.py`` on
    a 4-rank communicator: ``start_wait`` ``(op, ni, jt, src_kind,
    out_kind)`` (all-reduce, all-gather), ``rs_a2a`` ``(op, jt, src_kind,
    out_kind)`` (reduce-scatter, all-to-all), ``wait_all`` ``(src_kind,
    order)``."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(31)
    ops = ("add", "mean", "max", "min")
    pick = lambda seq: seq[int(rng.integers(len(seq)))]  # noqa: E731

    def distinct(draw, n):  # n different cases, every op among the first four
        out = []
        while len(out) < n:
            case = draw(ops[len(out) % 4])
            if case not in out:
                out.append(case)
        return out

    return {
        "start_wait": distinct(lambda op: (op, pick((2, 4)), pick((1, 2)), pick(P2P_KINDS),
                                           pick(P2P_KINDS)), 8),
        "rs_a2a": distinct(lambda op: (op, pick((1, 2)), pick(P2P_KINDS), pick(("col", "row"))),
                           8),
        "wait_all": [(P2P_KINDS[i % 3], order)
                     for i, order in enumerate(itertools.permutations((0, 1, 2)))],
    }


def collective_properties(np, L, C, mesh, views, cases) -> dict:
    """Run the non-blocking collective laws in either package on ``mesh``
    (4 ranks) over ``cases`` (:func:`collective_property_cases`) and return
    ``{case: views(result)}`` for each blocking result, and ``{(case,
    "law"): bool}`` for each law: ``*_start(...).wait()`` equals the
    blocking form bitwise (all-reduce, all-gather, reduce-scatter,
    all-to-all), the all-gather equals the root gather, and completing
    three requests of different kinds in any order (or through
    ``wait_all``) gives the canonical order's buffers.  ``views(dist_bag)``
    maps each rank this process can read to (tile as numpy, layout
    signature)."""
    f32 = np.float32
    R = 4

    def tile_layout(kind, ni, jt):
        if kind == "col":
            return L.scalar(f32) ^ L.vector("i", ni) ^ L.vector("j", jt)
        if kind == "row":
            return L.scalar(f32) ^ L.vector("j", jt) ^ L.vector("i", ni)
        return (L.scalar(f32) ^ L.vector("i", ni) ^ L.vector("j", jt)
                ^ L.blocked("i", "I2", num_blocks=2))

    def make_db(ni, jt, src_kind):
        nj = R * jt
        col = L.scalar(f32) ^ L.vector("i", ni) ^ L.vector("j", nj)
        # integer values: a sum over the ranks is exact in any order
        root = C.bag(col ^ L.into_blocks("j", "R", num_blocks=R),
                     np.arange(ni * nj, dtype=f32) + 1.0)
        return C.scatter(root, tile_layout(src_kind, ni, jt),
                         C.mpi_traverser("R", C.traverser(root), mesh))

    def same(a, b) -> bool:
        va, vb = views(a), views(b)
        return va.keys() == vb.keys() and all(
            np.array_equal(va[r][0], vb[r][0]) and va[r][1] == vb[r][1] for r in va)

    out: dict = {}
    for case in cases["start_wait"]:
        op, ni, jt, src_kind, out_kind = case
        db = make_db(ni, jt, src_kind)
        out_l = tile_layout(out_kind, ni, jt)
        blocking = C.all_reduce_bag(db, op, out_tile_layout=out_l)
        started = C.all_reduce_start(db, op, out_tile_layout=out_l).wait()
        root_l = (L.scalar(f32) ^ L.vector("i", ni) ^ L.vector("j", R * jt)
                  ^ L.into_blocks("j", "R", num_blocks=R))
        gathered = C.all_gather_dist(db, root_l)
        out[("all_reduce", case)] = views(blocking)
        out[("all_gather", case)] = views(gathered)
        out[("start_wait", case, "law")] = (
            same(blocking, started) and same(gathered, C.all_gather_start(db, root_l).wait())
            and np.array_equal(np.asarray(C.all_gather_bag(db, root_l).data),
                               np.asarray(C.gather(db, root_l).data)))
    for case in cases["rs_a2a"]:
        op, jt, src_kind, out_kind = case
        ni = 2 * R  # the scattered i extent, ni / R = 2, stays layoutable
        db = make_db(ni, jt, src_kind)
        rs_out = tile_layout(out_kind, ni // R, jt)
        rs = C.reduce_scatter_bag(db, rs_out, scatter_dim="i", op=op)
        aa_out = tile_layout(out_kind, ni // R, jt * R)
        aa = C.all_to_all_bag(db, aa_out, split_dim="i", concat_dim="j")
        out[("reduce_scatter", case)] = views(rs)
        out[("all_to_all", case)] = views(aa)
        out[("rs_a2a", case, "law")] = (
            same(rs, C.reduce_scatter_start(db, rs_out, scatter_dim="i", op=op).wait())
            and same(aa, C.all_to_all_start(db, aa_out, split_dim="i", concat_dim="j").wait()))
    for case in cases["wait_all"]:
        src_kind, order = case
        ni, jt = 2 * R, 2
        db = make_db(ni, jt, src_kind)
        rs_out = tile_layout("col", ni // R, jt)

        def issue():
            return (C.all_reduce_start(db, "add"),
                    C.reduce_scatter_start(db, rs_out, scatter_dim="i"),
                    C.ring_shift_start(db, 1))

        canonical = [p.wait() for p in issue()]
        pending = list(issue())
        got = [None, None, None]
        for idx in order:  # a permuted completion order
            got[idx] = pending[idx].wait()
        out[("wait_all", case)] = [views(d) for d in canonical]
        out[("wait_all", case, "law")] = (
            all(same(a, b) for a, b in zip(canonical, got))
            and all(same(a, b) for a, b in zip(canonical, C.wait_all(*issue()))))
    return out


def collective_properties_family(*, cases) -> dict:
    """:func:`collective_properties` on this gloo rank (a 1-D mesh of 4)."""
    import numpy as np

    import repro_torch.core as C
    from repro_torch.core import layout as L

    def views(d):
        t = d.tile(d.coords[0])
        return {d.flat_rank(d.coords): (t.data.numpy(),
                                        (tuple((a.name, a.size) for a in t.layout.axes),
                                         tuple(t.layout.dim_map)))}

    return collective_properties(np, L, C, C.make_mesh((4,), ("r",), device="cpu"), views,
                                 cases)


# -----------------------------------------------------------------------------
# the ragged v-collective laws (tests/test_vcollective_properties.py)
# -----------------------------------------------------------------------------
VPROP_KINDS = ("col", "row")


def vcollective_property_cases() -> dict:
    """Seeded cases of the laws of ``tests/test_vcollective_properties.py`` on
    a 4-rank communicator: ``pad_mask`` ``(nj, ni, root_kind, tile_kind,
    back_kind, seed)``, ``a2av`` ``(ni, nj, kind)``, ``rs_max_min`` ``(nj,
    ni, op, seed)``, ``imbalance`` ``(profile, kind)`` (every profile with
    every kind), ``wait_all`` ``(kind, order)``."""
    import itertools

    import numpy as np

    rng = np.random.default_rng(41)
    pick = lambda seq: seq[int(rng.integers(len(seq)))]  # noqa: E731
    seed = lambda: int(rng.integers(0, 10**9))  # noqa: E731
    orders = list(itertools.permutations(range(4)))
    return {
        "pad_mask": [(int(rng.integers(9, 21)), pick((1, 3)), VPROP_KINDS[i % 2],
                      pick(VPROP_KINDS), pick(VPROP_KINDS), seed()) for i in range(6)],
        "a2av": [(int(rng.integers(8, 17)), int(rng.integers(8, 17)), VPROP_KINDS[i % 2])
                 for i in range(5)],
        "rs_max_min": [(int(rng.integers(5, 13)), pick((1, 3)), ("max", "min")[i % 2], seed())
                       for i in range(5)],
        "imbalance": [(p, k) for p in ("one_dest", "zero_holes", "exact_cap")
                      for k in VPROP_KINDS],
        "wait_all": [(VPROP_KINDS[i % 2], orders[int(rng.integers(len(orders)))])
                     for i in range(5)],
    }


def vcollective_properties(np, L, C, dt, views, raw, root_data, make_dist, cases) -> dict:
    """Run the ragged v-collective laws in either package on the 4-rank
    communicator ``dt`` over ``cases`` (:func:`vcollective_property_cases`)
    and return ``{case: views(result)}`` for each result, ``{case: root as
    numpy}`` for each replicated root, the extents tables, and ``{(case,
    "law"): bool}`` for each law.  ``views(dist_bag)`` maps each rank this
    process can read to (valid tile as numpy, layout signature), ``raw`` to
    its padded buffer as numpy; ``root_data(bag)`` is a bag's data as
    numpy; ``make_dist(buf, layout)`` the bag whose rank ``r`` holds
    ``buf[r]``.  The laws are the reference file's:

    * scatterv -> gatherv is a bitwise round trip for any counts table, the
      padding of every slot exactly zero, and all_gatherv equals gatherv,
      its start form bitwise the blocking one (``:68``);
    * all_to_allv j-ragged -> i-ragged -> j-ragged is the identity, tiles
      and extents, and its start form the blocking one (``:121``);
    * the ragged max/min reduce-scatter equals the numpy oracle with its
      output padding re-zeroed; the identity table; the dense max/min
      reduce-scatter (``:161``);
    * all_to_allv under adversarial counts (all rows to one destination,
      zero-count holes, exact capacity) keeps its padding out of the tiles
      and round-trips (``:247``);
    * a mix of dense and ragged requests completes to the same buffers in
      any order and through ``wait_all`` (``:315``)."""
    import random

    f32 = np.float32
    R = 4
    out: dict = {}

    def root_layout(kind, ni, nj):
        if kind == "col":
            return L.scalar(f32) ^ L.vector("i", ni) ^ L.vector("j", nj)
        return L.scalar(f32) ^ L.vector("j", nj) ^ L.vector("i", ni)

    tile_layout = root_layout  # the same forms over (ni, j capacity)

    def rand_extents(seed, total):
        rng = random.Random(seed)
        exts = list(C.ragged_split(total, R)[1])
        for _ in range(rng.randrange(2 * R)):
            a, b = rng.randrange(R), rng.randrange(R)
            if exts[a] > 1:
                exts[a] -= 1
                exts[b] += 1
        return tuple(exts)

    def same(a, b) -> bool:
        ra, rb = raw(a), raw(b)
        return ra.keys() == rb.keys() and all(np.array_equal(ra[r], rb[r]) for r in ra)

    def padding_stays_out(d) -> bool:  # every nonzero element lies in the valid region
        return all(np.count_nonzero(raw(d)[r]) == np.count_nonzero(v[0])
                   for r, v in views(d).items())

    for case in cases.get("pad_mask", ()):
        nj, ni, root_kind, tile_kind, back_kind, seed = case
        exts = rand_extents(seed, nj)
        rl = root_layout(root_kind, ni, nj)
        root = C.bag(rl, np.random.default_rng(seed % 2**31).standard_normal(rl.shape)
                     .astype(f32))
        db = C.scatterv_bag(root, tile_layout(tile_kind, ni, max(exts)), dt, {"R": ("j", exts)})
        bl = root_layout(back_kind, ni, nj)
        back = C.gatherv_bag(db, bl)
        got = C.all_gatherv_bag(db, bl)
        out[("pad_mask", case)] = views(db)
        out[("pad_mask", case, "extents")] = db.extents
        out[("pad_mask", case, "root")] = root_data(back)
        out[("pad_mask", case, "law")] = (
            padding_stays_out(db)
            and all(v[0].size == ni * exts[r] for r, v in views(db).items())
            and np.array_equal(root_data(back), root_data(root.to_layout(bl)))
            and np.array_equal(root_data(got), root_data(back))
            and same(C.all_gatherv_start(db, bl).wait(), C.all_gatherv_dist(db, bl)))
    for case in cases.get("a2av", ()):
        ni, nj, kind = case
        cap_i, ei = C.ragged_split(ni, R)
        cap_j, ej = C.ragged_split(nj, R)
        rl = root_layout("row", ni, nj)
        in_tile = tile_layout(kind, ni, cap_j)
        db = C.scatterv_bag(C.bag(rl, np.arange(ni * nj, dtype=f32).reshape(rl.shape)),
                            in_tile, dt, {"R": ("j", ej)})
        out_tile = (L.scalar(f32) ^ L.vector("j", nj) ^ L.vector("i", cap_i) if kind == "row"
                    else L.scalar(f32) ^ L.vector("i", cap_i) ^ L.vector("j", nj))
        res = C.all_to_allv_bag(db, out_tile, split_dim="i", concat_dim="j", split_extents=ei)
        back = C.all_to_allv_bag(res, in_tile, split_dim="j", concat_dim="i", split_extents=ej)
        out[("a2av", case)] = views(res)
        out[("a2av", case, "extents")] = res.extents
        out[("a2av", case, "law")] = (
            back.extents == db.extents and same(back, db)
            and same(res, C.all_to_allv_start(db, out_tile, split_dim="i", concat_dim="j",
                                              split_extents=ei).wait()))
    for case in cases.get("rs_max_min", ()):
        nj, ni, op, seed = case
        cap_b, eb = C.ragged_split(nj, R)
        eo = rand_extents(seed, nj)
        panel_l = L.scalar(f32) ^ L.vector("j", R * cap_b) ^ L.vector("i", ni)
        out_l = L.scalar(f32) ^ L.vector("j", max(eo)) ^ L.vector("i", ni)
        dense = np.random.default_rng(seed % 2**31).standard_normal((R, ni, nj)).astype(f32)
        buf = np.zeros((R, ni, R * cap_b), f32)
        for r in range(R):
            off = 0
            for b in range(R):
                buf[r, :, b * cap_b:b * cap_b + eb[b]] = dense[r, :, off:off + eb[b]]
                off += eb[b]
        db = make_dist(buf, panel_l)
        total = (np.max if op == "max" else np.min)(dense, axis=0)
        res = C.reduce_scatterv_bag(db, out_l, scatter_dim="j", in_blocks=(cap_b, eb),
                                    out_extents=eo, op=op)
        starts = np.cumsum((0,) + eo)
        out[("rs_max_min", case)] = views(res)
        out[("rs_max_min", case, "law")] = (
            all(np.array_equal(v[0], total[:, starts[r]:starts[r] + eo[r]])
                for r, v in views(res).items())
            and all(np.all(raw(res)[r][:, eo[r]:] == 0.0) for r in raw(res))
            and same(res, C.reduce_scatterv_start(db, out_l, scatter_dim="j",
                                                  in_blocks=(cap_b, eb), out_extents=eo,
                                                  op=op).wait()))
    if "rs_max_min" in cases:  # the identity table and the dense route ride with it
        out["reduce_identity"] = [C.reduce_identity(op, np.dtype(t)) for op, t in (
            ("add", np.float32), ("mean", np.int32), ("max", np.float32), ("min", np.float32),
            ("max", np.int32), ("min", np.int32))]
        try:
            C.reduce_identity("max", np.dtype(np.bool_))
            out["reduce_identity_bool_refused"] = False
        except C.LayoutError:
            out["reduce_identity_bool_refused"] = True
        ni, cap = 3, 2  # the dense max/min reduce-scatter against the numpy oracle
        tl = L.scalar(f32) ^ L.vector("j", R * cap) ^ L.vector("i", ni)
        ol = L.scalar(f32) ^ L.vector("j", cap) ^ L.vector("i", ni)
        buf = np.random.default_rng(7).standard_normal((R, ni, R * cap)).astype(f32)
        db = make_dist(buf, tl)
        for op in ("max", "min"):
            res = C.reduce_scatter_bag(db, ol, scatter_dim="j", op=op)
            red = np.max if op == "max" else np.min
            out[("rs_dense", op)] = views(res)
            out[("rs_dense", op, "law")] = (
                all(np.array_equal(v[0], red(buf[:, :, r * cap:(r + 1) * cap], axis=0))
                    for r, v in views(res).items())
                and same(res, C.reduce_scatter_start(db, ol, scatter_dim="j", op=op).wait()))
    for case in cases.get("imbalance", ()):
        profile, kind = case
        nj = R + 3
        cap_j, ej = C.ragged_split(nj, R)
        if profile == "one_dest":
            ni, ei = 2 * R + 1, (2 * R + 1,) + (0,) * (R - 1)
        elif profile == "zero_holes":
            ni, ei = ((R + 1) // 2) * 3, tuple(3 if r % 2 == 0 else 0 for r in range(R))
        else:  # exact capacity: every count the block capacity, no padding
            ni, ei = 3 * R, (3,) * R
        rl = root_layout("row", ni, nj)
        in_tile = tile_layout(kind, ni, cap_j)
        # 1-based values: a zero in a valid tile could only be leaked padding
        db = C.scatterv_bag(C.bag(rl, np.arange(1, ni * nj + 1, dtype=f32).reshape(rl.shape)),
                            in_tile, dt, {"R": ("j", ej)})
        out_tile = (L.scalar(f32) ^ L.vector("j", nj) ^ L.vector("i", max(ei)) if kind == "row"
                    else L.scalar(f32) ^ L.vector("i", max(ei)) ^ L.vector("j", nj))
        res = C.all_to_allv_bag(db, out_tile, split_dim="i", concat_dim="j", split_extents=ei)
        back = C.all_to_allv_bag(res, in_tile, split_dim="j", concat_dim="i", split_extents=ej)
        out[("imbalance", case)] = views(res)
        out[("imbalance", case, "extents")] = res.extents
        out[("imbalance", case, "law")] = (
            padding_stays_out(res)
            and all(v[0].size == nj * ei[r] for r, v in views(res).items())
            and (profile != "exact_cap" or all(raw(res)[r].size == v[0].size
                                               for r, v in views(res).items()))
            and back.extents == db.extents and same(back, db)
            and same(res, C.all_to_allv_start(db, out_tile, split_dim="i", concat_dim="j",
                                              split_extents=ei).wait()))
    for case in cases.get("wait_all", ()):
        kind, order = case
        ni, nj = R + 1, R + 5
        cap_j, ej = C.ragged_split(nj, R)
        cap_i, ei = C.ragged_split(ni, R)
        rl = root_layout("row", ni, nj)
        db = C.scatterv_bag(C.bag(rl, np.arange(ni * nj, dtype=f32).reshape(rl.shape)),
                            tile_layout(kind, ni, cap_j), dt, {"R": ("j", ej)})
        dense = C.dist_full(dt, tile_layout(kind, ni, 2), fill=1.5)
        out_tile = L.scalar(f32) ^ L.vector("j", nj) ^ L.vector("i", cap_i)

        def issue():
            return (C.all_gatherv_start(db, rl),
                    C.all_to_allv_start(db, out_tile, split_dim="i", concat_dim="j",
                                        split_extents=ei),
                    C.ring_shift_start(db, 1),
                    C.all_reduce_start(dense, "add"))

        canonical = [p.wait() for p in issue()]
        pending = list(issue())
        got = [None] * 4
        for idx in order:  # a permuted completion order
            got[idx] = pending[idx].wait()
        out[("wait_all", case)] = [views(d) for d in canonical]
        out[("wait_all", case, "law")] = (
            all(same(a, b) for a, b in zip(canonical, got))
            and all(same(a, b) for a, b in zip(canonical, C.wait_all(*issue()))))
    return out


def vcollective_properties_family(*, cases) -> dict:
    """:func:`vcollective_properties` on this gloo rank (a 1-D mesh of 4)."""
    import numpy as np
    import torch

    import repro_torch.core as C
    from repro_torch.core import layout as L

    mesh = C.make_mesh((4,), ("r",), device="cpu")
    dt = C.mpi_traverser("R", C.traverser(L.scalar(np.float32) ^ L.vector("R", 4)), mesh)
    me = mesh.coords()["r"]

    def views(d):
        t = d.tile(d.coords[0])
        return {d.flat_rank(d.coords): (t.data.numpy(),
                                        (tuple((a.name, a.size) for a in t.layout.axes),
                                         tuple(t.layout.dim_map)))}

    def raw(d):
        return {d.flat_rank(d.coords): d.data.numpy()}

    return vcollective_properties(
        np, L, C, dt, views, raw, lambda b: b.data.numpy(),
        lambda buf, layout: C.DistBag(torch.from_numpy(buf[me].copy()), layout, dt, ("R",)),
        cases)


def walk_train_step(*, grid, seq, batch) -> dict:
    """One training step of phi4-mini's smoke config under the auto recipe
    on a ``(data, model)`` mesh of this gloo world, real weights (this
    rank's shards), walked op by op (``repro_torch.launch.op_walk``): the
    op names in issue order, the collectives and the operation and byte
    counts, for the dry run's fake trace to be held against."""
    import torch

    from repro_torch import configs
    from repro_torch.core import make_mesh
    from repro_torch.data.pipeline import ShapeCell, make_batch
    from repro_torch.launch.op_walk import OpWalk
    from repro_torch.models import lm
    from repro_torch.models.sharding import local_batch, make_recipe
    from repro_torch.models.weights import shard_params_by_recipe
    from repro_torch.train.optimizer import OptConfig, init_opt_state
    from repro_torch.train.trainer import make_train_step

    cfg = configs.get("phi4-mini-3.8b", smoke=True)
    mesh = make_mesh(grid, ("data", "model"), device="cpu")
    recipe = make_recipe(cfg, mesh)
    params = shard_params_by_recipe(lm.init_model(cfg, torch.Generator().manual_seed(0),
                                                  device="cpu"), lm.build_specs(cfg), recipe)
    data = local_batch(recipe, make_batch(cfg, ShapeCell("t", seq, batch, "train"), 0)).map(
        torch.from_numpy)
    ocfg = OptConfig()
    step = make_train_step(cfg, recipe, ocfg)
    opt = init_opt_state(params, ocfg)
    with OpWalk() as walk:
        step(params, opt, data)
    st = walk.stats()
    return {"names": [op.name for op in walk.stream.ops], "flops": st.flops, "bytes": st.bytes,
            "collectives": [(c.kind, c.bytes, c.ranks) for c in st.collectives],
            "peak_live_bytes": st.peak_live_bytes}
