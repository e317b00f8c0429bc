"""Quickstart: the layout algebra in five minutes, on the port's API; the
port of ``examples/quickstart.py``.

Walks through the paper's core ideas on small matrices:
  1. layouts and bags (logical indices, physical freedom)
  2. traversers (iteration order as a first-class object)
  3. relayout = the MPI-datatype engine (auto transform between layouts)
  4. distribution: scatter tiles with *different* layouts per side, over
     the world the script is started in (one rank under plain ``python``,
     N under ``torchrun``; gloo on the CPU)
  5. the same algebra deriving LM parameter shardings, for a (4, 2) mesh
     described without a process group

Run:
  python -m repro_torch.examples.quickstart
  torchrun --standalone --nproc-per-node 4 -m repro_torch.examples.quickstart
"""
import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (Mesh, bag, fix, gather, hoist_trav, idx, init_world, make_mesh,
                              mpi_traverser, rank_map, relayout_plan, scatter, transfer_kind,
                              traverser)
from repro_torch.core.layout import blocked, into_blocks, scalar, vector


def main() -> int:
    init_world("cpu")  # one rank under plain python, N under torchrun
    say = print if dist.get_rank() == 0 else (lambda *a, **k: None)
    say("== 1. layouts and bags ==")
    N, M = 6, 4
    col_major = scalar(np.float32) ^ vector("i", N) ^ vector("j", M)  # j outermost
    row_major = scalar(np.float32) ^ vector("j", M) ^ vector("i", N)
    A = bag(col_major, torch.arange(N * M, dtype=torch.float32))
    say(f"col-major layout: {col_major}")
    say(f"A[i=2, j=3] = {A[idx(i=2, j=3)]} (same logical element in any layout)")

    say("\n== 2. traversers ==")
    acc = []
    traverser(A) ^ hoist_trav("i") ^ fix(j=1) | (lambda s: acc.append(float(A[s])))
    say(f"column j=1 via hoisted traverser: {acc}")

    say("\n== 3. relayout: the MPI-datatype engine ==")
    B = A.to_layout(row_major)
    say(f"transfer col->row is kind={transfer_kind(col_major, row_major)!r}")
    say(f"plan: {relayout_plan(col_major, row_major).describe()}")
    tiled = col_major ^ blocked("i", "I", 3)
    say(f"col->tiled is kind={transfer_kind(col_major, tiled)!r} (the same bytes, in order)")
    assert A[idx(i=4, j=2)] == B[idx(i=4, j=2)] == A.to_layout(tiled)[idx(i=4, j=2)]

    world = dist.get_world_size()
    say(f"\n== 4. layout-agnostic scatter over {world} rank(s) ==")
    mesh = make_mesh((world,), ("r",))
    big = scalar(np.float32) ^ vector("i", 8) ^ vector("j", 16 * world)
    root_layout = big ^ into_blocks("j", "R", num_blocks=world)
    root = bag(root_layout, torch.arange(128 * world, dtype=torch.float32))
    dt = mpi_traverser("R", traverser(root), mesh)
    tile_layout = scalar(np.float32) ^ vector("j", 16) ^ vector("i", 8)  # tiles row-major!
    tiles = scatter(root, tile_layout, dt)  # the transform rides the transfer
    doubled = rank_map(lambda rank, t: t.with_data(t.data * 2), dt, tiles)
    out = gather(doubled, root_layout)
    ok = bool(torch.equal(out.data, root.data * 2))
    say(f"scatter->compute->gather ok: {ok}")
    dist.destroy_process_group()
    if not ok:
        return 1

    say("\n== 5. the same algebra shards a transformer ==")
    from repro_torch import configs
    from repro_torch.models import lm
    from repro_torch.models.sharding import make_recipe

    cfg = configs.get("phi4-mini-3.8b", smoke=True)
    # a mesh description: make_recipe reads its shape, no process group is needed
    mesh2 = Mesh({"data": 4, "model": 2}, 0, torch.device("cpu"))
    recipe = make_recipe(cfg, mesh2)
    pspecs = recipe.param_pspecs(lm.build_specs(cfg))
    say(f"bindings: {recipe.bindings}  (attn mode: {recipe.attn_mode})")
    say(f"embed:      {pspecs['embed']}")
    say(f"attn wq:    {pspecs['blocks']['attn']['wq']}")
    say(f"ffn w_gate: {pspecs['blocks']['ffn']['w_gate']}")
    say("\nno partition spec was written by hand: they are derived from the layout bindings,"
        "\nexactly like MPI datatypes derived from Noarr structures.")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
