"""The paper's case study (§5): a layout-agnostic distributed GEMM, on PyTorch.

Two algorithms, both layout-agnostic end to end, run as real SPMD programs
over ``torch.distributed`` (one process per rank, each holding its own
tiles):

1-D (``run_distributed_gemm``): each rank computes one row-panel of
C = A @ B — A is split along i, B broadcast, C gathered.

2-D SUMMA (``run_summa_gemm``): a ``(rows, cols)`` communicator grid (the
paper's ``MPI_Cart_create``).  Rank (r, c) owns A[i-block r, k-block c]; B's
k-panels live k-block-per-grid-column with their j-blocks spread down the
rows.  Each of R ring steps multiplies the local A tile against the current
B panel and the panels rotate along the *rows* sub-communicator with the
layout-agnostic p2p ring shift; the epilogue is a ``reduce_scatter_bag``
along the *cols* sub-communicator that sums the partial C panels over k and
scatters j — with the final C tile layout chosen freely.

The SUMMA ring is *double-buffered* by default: step ``s`` issues the panel
rotation with the non-blocking ``ring_shift_start`` (MPI_Isend/Irecv
analogue) *before* the local multiply and completes it after, so the
transfer overlaps the step's GEMM.  ``double_buffer=False`` keeps the
blocking formulation (compute, then shift) — bit-identical.  The local
multiply accumulates into a rotating j-block of the partial panel through the
panel kernel (``repro_torch.kernels.ops.gemm_panel``).

The ragged SUMMA (``run_ragged_summa_gemm``) runs the same ring when no dim
divides the grid: tiles are padded capacity buffers with per-rank valid
extents (the MPI v-collectives).

In all three, the *global* matrices and the *per-rank tiles* choose their
physical layouts independently (row-major or column-major per the C/A/B
"majors" configuration, Fig. 3), and every transfer transforms the layouts
automatically.  The per-rank compute is the layout-parametric GEMM kernel
(CUDA on the GPU, its plain PyTorch version on the CPU).

Run:  python -m repro_torch.examples.distributed_gemm --dataset EXTRALARGE --summa --grid 1x1
      torchrun --standalone --nproc-per-node 4 -m repro_torch.examples.distributed_gemm \\
          --device cpu --summa --grid 2x2
Under ``torchrun`` the env rendezvous is used; otherwise a world of size 1
starts (NCCL on ``cuda``, gloo on ``cpu``).
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import (
    DistBag,
    bag,
    bag_from_numpy,
    broadcast,
    dist_full,
    gather,
    gatherv_bag,
    grid_extents,
    init_world,
    intent_of,
    make_mesh,
    mpi_cart_traverser,
    mpi_traverser,
    ragged_split,
    rank_map,
    reduce_scatter_bag,
    reduce_scatterv_bag,
    ring,
    ring_shift_start,
    scatter,
    scatterv_bag,
    traverser,
)
from repro_torch.core.layout import into_blocks, scalar, vector
from repro_torch.kernels import ops


def _mat_layout(rows: str, cols: str, nr: int, nc: int, major: str):
    """Layout with the given major (outer) dimension — paper Fig. 3 labels."""
    if major == rows:
        return scalar(np.float32) ^ vector(cols, nc) ^ vector(rows, nr)  # rows outer
    return scalar(np.float32) ^ vector(rows, nr) ^ vector(cols, nc)  # cols outer


def _inputs(seed: int, ni: int, nj: int, nk: int, A_np, B_np):
    """The run's input matrices: the caller's, or drawn from ``seed`` exactly
    as the reference package draws them."""
    if (A_np is None) != (B_np is None):
        raise ValueError("pass both A_np and B_np, or neither")
    if A_np is None:
        rng = np.random.default_rng(seed)
        A_np = rng.standard_normal((ni, nk)).astype(np.float32)
        B_np = rng.standard_normal((nk, nj)).astype(np.float32)
    if A_np.shape != (ni, nk) or B_np.shape != (nk, nj):
        raise ValueError(f"inputs {A_np.shape} @ {B_np.shape} do not match dims ({ni},{nj},{nk})")
    return A_np, B_np


def _global_bags(A_layout, B_layout, A_np, B_np, device):
    A_glob = bag_from_numpy(A_layout, A_np if A_layout.axis_names == ("i", "k") else A_np.T, device)
    B_glob = bag_from_numpy(B_layout, B_np if B_layout.axis_names == ("k", "j") else B_np.T, device)
    return A_glob, B_glob


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run_distributed_gemm(*, ni: int, nj: int, nk: int, majors: str = "I/I/K",
                         ranks: int | None = None, mesh=None, verbose: bool = False,
                         device: str | torch.device = "cuda", A_np=None, B_np=None):
    """Returns (C_result, C_oracle) as (ni, nj) numpy arrays, on every rank.

    Without a ``mesh`` it joins (or starts) the world for ``device`` and
    lays a 1-D mesh over it; with one, tensors live on ``mesh.device``.
    """
    c_major, a_major, b_major = majors.upper().split("/")
    if mesh is None:
        dev = init_world(device)
        ranks = ranks or dist.get_world_size()
        mesh = make_mesh((ranks,), ("r",), device=dev)
    dev = mesh.device
    ranks = ranks or mesh.shape["r"]
    if ni % ranks:
        raise ValueError(f"ni={ni} must divide over {ranks} ranks")
    A_np, B_np = _inputs(7, ni, nj, nk, A_np, B_np)

    # --- global bags, laid out per the config --------------------------------
    A_layout = _mat_layout("i", "k", ni, nk, "i" if a_major == "I" else "k")
    B_layout = _mat_layout("k", "j", nk, nj, "k" if b_major == "K" else "j")
    C_layout = _mat_layout("i", "j", ni, nj, "i" if c_major == "I" else "j")
    A_glob, B_glob = _global_bags(A_layout, B_layout, A_np, B_np, dev)

    # --- distribution: rank dim R = row-blocks of i (paper §4.1) -------------
    A_root_layout = A_layout ^ into_blocks("i", "R", num_blocks=ranks)
    A_root = bag(A_root_layout, A_glob.data)
    dt = mpi_traverser("R", traverser(A_root), mesh)

    # --- per-rank tile layouts, chosen independently of the global ones ------
    A_tile = _mat_layout("i", "k", ni // ranks, nk, "i" if a_major == "I" else "k")
    B_tile = B_layout
    C_tile = _mat_layout("i", "j", ni // ranks, nj, "i" if c_major == "I" else "j")

    t0 = time.perf_counter()
    A_dist = scatter(A_root, A_tile, dt)  # layout transform rides the scatter
    B_all = broadcast(B_glob, dt, dst_layout=B_tile)

    def compute(rank, a_tile):
        # per-rank layout-parametric GEMM (the paper's kernel)
        out = ops.gemm(a_tile.data, B_all.data, majors=majors)
        return bag(C_tile, out)

    C_dist = rank_map(compute, dt, A_dist, out_tile_layout=C_tile)
    C_root_layout = C_layout ^ into_blocks("i", "R", num_blocks=ranks)
    C_root = gather(C_dist, C_root_layout)
    _sync(dev)
    elapsed = time.perf_counter() - t0

    # back to a plain (ni, nj) row-major array for checking
    flat = C_root.to_layout(
        scalar(np.float32) ^ vector("j", nj) ^ vector("i", ni // ranks) ^ vector("R", ranks)
    )
    C_result = flat.data.cpu().numpy().reshape(ni, nj)
    C_oracle = A_np @ B_np
    if verbose and mesh.rank == 0:
        err = np.abs(C_result - C_oracle).max()
        print(f"majors={majors} ranks={ranks} ni,nj,nk=({ni},{nj},{nk}) "
              f"time={elapsed*1e3:.2f}ms max_err={err:.2e}")
    return C_result, C_oracle


def comm_volume_model(algo: str, *, ni: int, nj: int, nk: int,
                      grid: tuple[int, int] | None = None, ranks: int | None = None,
                      dtype_bytes: int = 4, ragged: bool = False) -> dict:
    """Analytic per-rank communication volume (bytes) of the two algorithms.

    The 1-D row-panel algorithm replicates B to every rank — O(n^2) per rank
    regardless of P — while the 2-D SUMMA ring moves only the (nk/Cc, nj/R)
    panel per step, O(n^2/sqrt(P)) on a square grid.  ``ring_bytes`` is the
    exact payload of the ring's transfers; the reduce-scatter/broadcast terms
    count result bytes once.
    """
    if algo == "summa2d":
        if grid is None:
            raise ValueError("summa2d model needs grid=(rows, cols)")
        R, Cc = grid
        if ragged:
            # ragged (v-collective) SUMMA: tiles move at padded *capacity* on
            # the wire, but the modeled payload is the mean per-rank VALID
            # bytes.  Rank (r, c) at step s ships B block (k-block c,
            # j-block (r+s)%R) = ek[c] * ej[(r+s)%R] elements; averaging over
            # the grid, sum_s ej telescopes to (R-1) * nj / R and mean ek is
            # nk / Cc — the exact-division formula with real divisions.
            cap_i, _ = ragged_split(ni, R)
            cap_k, _ = ragged_split(nk, Cc)
            cap_jr, _ = ragged_split(nj, R)
            cap_jc, _ = ragged_split(nj, Cc)
            ring_b = (R - 1) * (nk / Cc) * (nj / R) * dtype_bytes
            ring_padded = (R - 1) * cap_k * cap_jr * dtype_bytes
            rs = (ni / R) * (nj / Cc) * dtype_bytes
            rs_padded = cap_i * cap_jc * dtype_bytes
            return {
                "algo": algo, "ragged": True,
                "ring_bytes": ring_b, "ring_padded_bytes": ring_padded,
                "reduce_scatter_bytes": rs, "reduce_scatter_padded_bytes": rs_padded,
                "total_bytes": ring_b + rs, "total_padded_bytes": ring_padded + rs_padded,
                # static valid/padded ratios per collective kind
                "valid_fractions": {
                    "collective-permute": ring_b / ring_padded if ring_padded else 1.0,
                    "reduce-scatter": rs / rs_padded if rs_padded else 1.0,
                },
            }
        ring_b = (R - 1) * (nk // Cc) * (nj // R) * dtype_bytes
        reduce_scatter = (ni // R) * (nj // Cc) * dtype_bytes
        return {"algo": algo, "ring_bytes": ring_b,
                "reduce_scatter_bytes": reduce_scatter,
                "total_bytes": ring_b + reduce_scatter}
    if algo == "panel1d":
        if ranks is None:
            raise ValueError("panel1d model needs ranks")
        bcast_b = nk * nj * dtype_bytes  # B replicated to every rank: O(n^2)
        scatter_b = (ni // ranks) * nk * dtype_bytes
        gather_b = (ni // ranks) * nj * dtype_bytes
        return {"algo": algo, "broadcast_bytes": bcast_b, "scatter_bytes": scatter_b,
                "gather_bytes": gather_b, "total_bytes": bcast_b + scatter_b + gather_b}
    raise ValueError(f"unknown algo {algo!r}")


def _grid_mesh(grid: tuple[int, int], mesh, device):
    if mesh is None:
        mesh = make_mesh(grid, ("rows", "cols"), device=init_world(device))
    return mesh


def summa_ring_program(*, ni: int, nj: int, nk: int, grid: tuple[int, int] = (2, 4),
                       majors: str = "I/I/K", mesh=None, double_buffer: bool = True,
                       device: str | torch.device = "cuda"):
    """Build the SUMMA ring phase + reduce-scatter epilogue as one program on
    this rank's tiles.

    Returns ``(fn, meta)``: ``fn(a_tile, b_tile)`` takes this rank's A tile
    and B panel (``DistBag.data``) and returns its C tile; ``meta`` carries
    the mesh, traversers, tile layouts and the analytic comm model.

    The schedule is a declared comm plan (:func:`repro_torch.core.ring`):
    the planner issues each step's panel rotation with the non-blocking
    ``ring_shift_start`` *before* the local GEMM and waits after it.  With
    ``double_buffer=False`` the planner starts and waits back-to-back (the
    blocking interpretation) — bit-identical by construction.  With one grid
    row the ring has one step and issues no transfer.
    """
    c_major, a_major, b_major = majors.upper().split("/")
    R, Cc = grid
    mesh = _grid_mesh(grid, mesh, device)
    if ni % R or nk % Cc or nj % R or nj % Cc:
        raise ValueError(f"dims ({ni},{nj},{nk}) must divide grid {grid}; use the ragged SUMMA")
    mi, kc, jr, jc = ni // R, nk // Cc, nj // R, nj // Cc

    # --- global layouts + communicator grid (paper's MPI_Cart_create) --------
    A_layout = _mat_layout("i", "k", ni, nk, "i" if a_major == "I" else "k")
    B_layout = _mat_layout("k", "j", nk, nj, "k" if b_major == "K" else "j")
    A_root_l = A_layout ^ into_blocks("i", "Ri", num_blocks=R) ^ into_blocks("k", "Ck", num_blocks=Cc)
    B_root_l = B_layout ^ into_blocks("k", "Ck", num_blocks=Cc) ^ into_blocks("j", "Rj", num_blocks=R)
    dtA = mpi_cart_traverser([("Ri", "rows"), ("Ck", "cols")], traverser(A_root_l), mesh)
    dtB = mpi_cart_traverser([("Rj", "rows"), ("Ck", "cols")], traverser(B_root_l), mesh)

    # --- per-rank tile layouts, chosen independently of the global ones ------
    A_tile = _mat_layout("i", "k", mi, kc, "i" if a_major == "I" else "k")
    B_tile = _mat_layout("k", "j", kc, jr, "k" if b_major == "K" else "j")
    C_tile = _mat_layout("i", "j", mi, jc, "i" if c_major == "I" else "j")
    P_l = _mat_layout("i", "j", mi, nj, "i")  # partial panel, i-major internal

    local_majors = f"I/{a_major}/{b_major}"

    def ring_phase(a_data, b_data):
        A_dist = DistBag(a_data, A_tile, dtA, ("Ri", "Ck"))
        B_cur = DistBag(b_data, B_tile, dtB, ("Rj", "Ck"))
        P = dist_full(dtA, P_l)

        def compute(p, b_cur, s):
            def step(state, p_, a, b_panel):
                # per-rank layout-parametric GEMM accumulating into the
                # rotating j-block of the panel, in place
                jb = (state["Ri"] + s) % R
                return p_.with_data(ops.gemm_panel(a.data, b_panel.data, p_.data, jb,
                                                   majors=local_majors))

            return rank_map(step, dtA, p, A_dist, b_cur, out_tile_layout=P_l)

        # the schedule is declared once: the planner issues each step's
        # rotation (MPI_Start analogue) before the local GEMM and waits after
        # it, and the epilogue sums partials over k (grid cols) and scatters
        # j, landing each rank's C tile directly in its chosen layout
        plan = ring(
            R,
            transfer=lambda b_cur, s: ring_shift_start(b_cur, -1, rank_dim="Rj"),
            compute=compute,
            epilogue=lambda p, b_cur: reduce_scatter_bag(
                p, C_tile, scatter_dim="j", rank_dim="Ck"
            ).data,
        )
        return plan.run(B_cur, P, double_buffer=double_buffer)

    meta = dict(
        mesh=mesh, dtA=dtA, dtB=dtB, grid=grid, steps=R,
        A_layout=A_layout, B_layout=B_layout,
        A_root_l=A_root_l, B_root_l=B_root_l,
        A_tile=A_tile, B_tile=B_tile, C_tile=C_tile, panel_layout=P_l,
        plan_intent=intent_of("ring"),
        comm_model=comm_volume_model("summa2d", ni=ni, nj=nj, nk=nk, grid=grid),
    )
    return ring_phase, meta


def run_summa_gemm(*, ni: int, nj: int, nk: int, grid: tuple[int, int] = (2, 4),
                   majors: str = "I/I/K", mesh=None, verbose: bool = False,
                   double_buffer: bool = True, device: str | torch.device = "cuda",
                   A_np=None, B_np=None):
    """2-D-grid SUMMA C = A @ B; returns (C_result, C_oracle) as (ni, nj), on
    every rank.

    Placement on the (rows=R, cols=Cc) grid:
      * A[i-block r, k-block c] on rank (r, c)        (stationary)
      * B[k-block c, j-block r] on rank (r, c)        (rotates along rows)
      * C[i-block r, j-chunk c] on rank (r, c)        (reduce_scatter output)

    Ring phase: at step s rank (r, c) holds B[k-block c, j-block (r+s) % R]
    and fills j-block (r+s) % R of its partial panel P = A[r,c] @ B[k c, :];
    the B panels ring-shift one hop along the *rows* sub-communicator —
    non-blocking and overlapped with the multiply when ``double_buffer``
    (the default), blocking otherwise.  See :func:`summa_ring_program`.
    """
    R, Cc = grid
    fn, meta = summa_ring_program(ni=ni, nj=nj, nk=nk, grid=grid, majors=majors,
                                  mesh=mesh, double_buffer=double_buffer, device=device)
    mesh = meta["mesh"]
    dtA, dtB = meta["dtA"], meta["dtB"]
    A_tile, B_tile, C_tile = meta["A_tile"], meta["B_tile"], meta["C_tile"]
    mi, jc = ni // R, nj // Cc
    A_np, B_np = _inputs(11, ni, nj, nk, A_np, B_np)

    # --- global bags, laid out per the config (layouts from the program) -----
    A_glob, B_glob = _global_bags(meta["A_layout"], meta["B_layout"], A_np, B_np, mesh.device)
    A_root = bag(meta["A_root_l"], A_glob.data)
    B_root = bag(meta["B_root_l"], B_glob.data)

    t0 = time.perf_counter()
    A_dist = scatter(A_root, A_tile, dtA)  # layout transform rides the scatter
    B_cur = scatter(B_root, B_tile, dtB)
    C_data = fn(A_dist.data, B_cur.data)  # the whole ring + epilogue
    C_grid = DistBag(C_data, C_tile, dtA, ("Ri", "Ck"))
    _sync(mesh.device)
    elapsed = time.perf_counter() - t0

    # gather back to a plain (ni, nj) row-major array for checking: axes
    # (Ri, i, Ck, j) are exactly the row-major matrix
    C_root_l = (scalar(np.float32) ^ vector("j", jc) ^ vector("Ck", Cc)
                ^ vector("i", mi) ^ vector("Ri", R))
    C_result = gather(C_grid, C_root_l).data.cpu().numpy().reshape(ni, nj)
    C_oracle = A_np @ B_np
    if verbose and mesh.rank == 0:
        err = np.abs(C_result - C_oracle).max()
        variant = "double-buffered" if double_buffer else "blocking"
        print(f"SUMMA[{variant}] majors={majors} grid={grid} ni,nj,nk=({ni},{nj},{nk}) "
              f"time={elapsed*1e3:.2f}ms max_err={err:.2e}")
    return C_result, C_oracle


def ragged_summa_program(*, ni: int, nj: int, nk: int, grid: tuple[int, int] = (2, 4),
                         majors: str = "I/I/K", mesh=None, double_buffer: bool = True,
                         device: str | torch.device = "cuda"):
    """The *ragged* SUMMA ring: ``ni``/``nj``/``nk`` need NOT divide the grid.

    Every matrix dim is split with :func:`repro_torch.core.ragged_split` into
    balanced ragged blocks carried as per-rank extents (the MPI v-collective
    counts) over padded capacity tiles.  The structure is identical to
    :func:`summa_ring_program` except that:

      * A tiles and B panels are ragged DistBags (zero padding behind the
        valid leading block, so the padded GEMM contributions vanish);
      * ``ring_shift_start`` rotates the B extents table together with the
        panels (the receiver adopts the sender's counts);
      * the epilogue is :func:`repro_torch.core.reduce_scatterv_bag`: the
        block-ragged partial panels are compacted/re-padded with static
        slices and reduced+scattered so rank (r, c) lands its
        ``(ei[r], ejc[c])`` valid C block in a capacity tile.

    The capacity tiles reach the GEMM kernels at their padded sizes, which
    divide no block size: the kernels bounds-check their edge tiles.
    """
    c_major, a_major, b_major = majors.upper().split("/")
    R, Cc = grid
    mesh = _grid_mesh(grid, mesh, device)
    cap_i, ei = ragged_split(ni, R)
    cap_k, ek = ragged_split(nk, Cc)
    cap_jr, ejr = ragged_split(nj, R)
    cap_jc, ejc = ragged_split(nj, Cc)

    # --- global layouts + communicator grid (no into_blocks: nothing divides)
    A_layout = _mat_layout("i", "k", ni, nk, "i" if a_major == "I" else "k")
    B_layout = _mat_layout("k", "j", nk, nj, "k" if b_major == "K" else "j")
    dtA = mpi_cart_traverser(
        [("Ri", "rows"), ("Ck", "cols")],
        traverser(scalar(np.float32) ^ vector("Ck", Cc) ^ vector("Ri", R)), mesh)
    dtB = mpi_cart_traverser(
        [("Rj", "rows"), ("Ck", "cols")],
        traverser(scalar(np.float32) ^ vector("Ck", Cc) ^ vector("Rj", R)), mesh)

    # --- per-rank padded capacity tile layouts (valid = leading extents) -----
    A_tile = _mat_layout("i", "k", cap_i, cap_k, "i" if a_major == "I" else "k")
    B_tile = _mat_layout("k", "j", cap_k, cap_jr, "k" if b_major == "K" else "j")
    C_tile = _mat_layout("i", "j", cap_i, cap_jc, "i" if c_major == "I" else "j")
    P_l = _mat_layout("i", "j", cap_i, R * cap_jr, "i")  # partial panel, i-major

    extA = grid_extents(dtA, ("Ri", "Ck"), {"Ri": ("i", ei), "Ck": ("k", ek)})
    extB = grid_extents(dtB, ("Rj", "Ck"), {"Rj": ("j", ejr), "Ck": ("k", ek)})
    extP = grid_extents(dtA, ("Ri", "Ck"), {"Ri": ("i", ei)})

    local_majors = f"I/{a_major}/{b_major}"

    def ring_phase(a_data, b_data):
        A_dist = DistBag(a_data, A_tile, dtA, ("Ri", "Ck"), extents=extA)
        B_cur = DistBag(b_data, B_tile, dtB, ("Rj", "Ck"), extents=extB)
        P = dist_full(dtA, P_l)

        def compute(p, b_cur, s):
            def step(state, p_, a, b_panel):
                # padded capacity GEMM: zero padding in A's i/k and the
                # panel's k/j contributes zeros, so the accumulation into the
                # rotating j-block stays exact without masks
                jb = (state["Ri"] + s) % R
                return p_.with_data(ops.gemm_panel(a.data, b_panel.data, p_.data, jb,
                                                   majors=local_majors))

            return rank_map(step, dtA, p, A_dist, b_cur, out_tile_layout=P_l,
                            out_extents=extP)

        # same declared schedule as the dense SUMMA — the extents table
        # rotates with the panels inside the planner's transfers, and the
        # ragged epilogue compacts the R block-ragged j slabs, re-pads into
        # Cc ragged output blocks, reduces over k (grid cols) and scatters j
        plan = ring(
            R,
            transfer=lambda b_cur, s: ring_shift_start(b_cur, -1, rank_dim="Rj"),
            compute=compute,
            epilogue=lambda p, b_cur: reduce_scatterv_bag(
                p, C_tile, scatter_dim="j", in_blocks=(cap_jr, ejr),
                out_extents=ejc, rank_dim="Ck"
            ).data,
        )
        return plan.run(B_cur, P, double_buffer=double_buffer)

    meta = dict(
        mesh=mesh, dtA=dtA, dtB=dtB, grid=grid, steps=R,
        A_layout=A_layout, B_layout=B_layout,
        A_tile=A_tile, B_tile=B_tile, C_tile=C_tile, panel_layout=P_l,
        caps=dict(i=cap_i, k=cap_k, jr=cap_jr, jc=cap_jc),
        extents=dict(i=ei, k=ek, jr=ejr, jc=ejc),
        A_ragged={"Ri": ("i", ei), "Ck": ("k", ek)},
        B_ragged={"Rj": ("j", ejr), "Ck": ("k", ek)},
        C_extents=grid_extents(dtA, ("Ri", "Ck"), {"Ri": ("i", ei), "Ck": ("j", ejc)}),
        plan_intent=intent_of("ring"),
        comm_model=comm_volume_model("summa2d", ni=ni, nj=nj, nk=nk, grid=grid,
                                     ragged=True),
    )
    return ring_phase, meta


def run_ragged_summa_gemm(*, ni: int, nj: int, nk: int, grid: tuple[int, int] = (2, 4),
                          majors: str = "I/I/K", mesh=None, verbose: bool = False,
                          double_buffer: bool = True, device: str | torch.device = "cuda",
                          A_np=None, B_np=None):
    """Ragged SUMMA C = A @ B for dims that do NOT divide the grid; returns
    (C_result, C_oracle) as (ni, nj) numpy arrays, on every rank.

    A and B enter through :func:`repro_torch.core.scatterv_bag`
    (MPI_Scatterv with balanced counts), :func:`ragged_summa_program` runs
    the double-buffered ring + v reduce-scatter, and the C tiles come back
    through :func:`repro_torch.core.gatherv_bag` — padding never appears in
    any logical result.
    """
    fn, meta = ragged_summa_program(ni=ni, nj=nj, nk=nk, grid=grid, majors=majors,
                                    mesh=mesh, double_buffer=double_buffer, device=device)
    mesh = meta["mesh"]
    dtA, dtB = meta["dtA"], meta["dtB"]
    A_tile, B_tile, C_tile = meta["A_tile"], meta["B_tile"], meta["C_tile"]
    A_np, B_np = _inputs(13, ni, nj, nk, A_np, B_np)
    A_glob, B_glob = _global_bags(meta["A_layout"], meta["B_layout"], A_np, B_np, mesh.device)

    t0 = time.perf_counter()
    A_dist = scatterv_bag(A_glob, A_tile, dtA, meta["A_ragged"])
    B_dist = scatterv_bag(B_glob, B_tile, dtB, meta["B_ragged"])
    C_data = fn(A_dist.data, B_dist.data)  # the whole ring + epilogue
    C_grid = DistBag(C_data, C_tile, dtA, ("Ri", "Ck"), extents=meta["C_extents"])
    _sync(mesh.device)
    elapsed = time.perf_counter() - t0

    # gatherv back to a plain (ni, nj) row-major root for checking
    C_root_l = _mat_layout("i", "j", ni, nj, "i")  # axes (i, j) row-major
    C_result = gatherv_bag(C_grid, C_root_l).data.cpu().numpy().reshape(ni, nj)
    C_oracle = A_np @ B_np
    if verbose and mesh.rank == 0:
        err = np.abs(C_result - C_oracle).max()
        variant = "double-buffered" if double_buffer else "blocking"
        print(f"ragged SUMMA[{variant}] majors={majors} grid={grid} "
              f"ni,nj,nk=({ni},{nj},{nk}) caps={meta['caps']} "
              f"time={elapsed*1e3:.2f}ms max_err={err:.2e}")
    return C_result, C_oracle


def main():
    from repro_torch.configs.gemm_case_study import DATASETS, LAYOUT_CONFIGS

    ap = argparse.ArgumentParser()
    ap.add_argument("--dataset", default="MINI", choices=list(DATASETS))
    ap.add_argument("--majors", default=None, help="e.g. J/K/J; default: all 8")
    ap.add_argument("--ranks", type=int, default=None)
    ap.add_argument("--summa", action="store_true", help="2-D-grid SUMMA instead of 1-D")
    ap.add_argument("--grid", default="2x4", help="SUMMA grid rows x cols")
    ap.add_argument("--blocking", action="store_true",
                    help="SUMMA: blocking ring shifts instead of the double-buffered default")
    ap.add_argument("--uneven", action="store_true",
                    help="SUMMA: bump every dim by +1 so nothing divides the "
                         "grid and the ragged (v-collective) path runs")
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                    help="cuda: NCCL, one GPU per rank; cpu: gloo")
    args = ap.parse_args()

    ni, nj, nk = DATASETS[args.dataset]
    configs = [args.majors] if args.majors else LAYOUT_CONFIGS
    device = init_world(args.device)
    try:
        if args.summa:
            grid = tuple(int(x) for x in args.grid.split("x"))
            mesh = make_mesh(grid, ("rows", "cols"), device=device)
        else:
            mesh = make_mesh((dist.get_world_size(),), ("r",), device=device)
        for majors in configs:
            if args.summa and args.uneven:
                C, ref = run_ragged_summa_gemm(ni=ni + 1, nj=nj + 1, nk=nk + 1,
                                               majors=majors, grid=grid, mesh=mesh,
                                               double_buffer=not args.blocking, verbose=True)
            elif args.summa:
                C, ref = run_summa_gemm(ni=ni, nj=nj, nk=nk, majors=majors, grid=grid, mesh=mesh,
                                        double_buffer=not args.blocking, verbose=True)
            else:
                C, ref = run_distributed_gemm(ni=ni, nj=nj, nk=nk, majors=majors,
                                              ranks=args.ranks, mesh=mesh, verbose=True)
            np.testing.assert_allclose(C, ref, rtol=1e-3, atol=1e-3)
        if mesh.rank == 0:
            print("all configurations validated")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    main()
